"""llama3-405b — dense decoder, GQA, 128k vocab.

126L d_model=16384 128H (kv=8) d_ff=53248 vocab=128256. [arXiv:2407.21783; unverified]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="llama3-405b",
        family="dense",
        num_layers=126,
        d_model=16384,
        num_heads=128,
        num_kv_heads=8,
        d_ff=53248,
        vocab_size=128256,
        rope_theta=500_000.0,
        activation="swiglu",
        source="arXiv:2407.21783",
    )
)
