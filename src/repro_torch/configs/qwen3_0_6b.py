"""qwen3-0.6b — dense decoder with qk_norm and GQA.

28L d_model=1024 16H (kv=8) d_ff=3072 vocab=151936, head_dim=128.
[hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen3-0.6b",
        family="dense",
        num_layers=28,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,  # qwen3 uses explicit head_dim != d_model/heads
        d_ff=3072,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        activation="swiglu",
        source="hf:Qwen/Qwen3-8B",
    )
)
