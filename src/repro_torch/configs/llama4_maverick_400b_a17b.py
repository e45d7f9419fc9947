"""llama4-maverick-400b-a17b — MoE decoder, 128 experts top-1.

48L d_model=5120 40H (kv=8) d_ff=8192 vocab=202048.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        num_experts=128,
        experts_per_token=1,
        rope_theta=500_000.0,
        activation="swiglu",
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
)
