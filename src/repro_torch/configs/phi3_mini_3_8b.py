"""phi3-mini-3.8b — dense decoder, RoPE SwiGLU GQA.

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064. [arXiv:2404.14219; unverified]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="phi3-mini-3.8b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        activation="swiglu",
        source="arXiv:2404.14219",
    )
)
