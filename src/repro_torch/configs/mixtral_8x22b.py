"""mixtral-8x22b — MoE decoder, 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (kv=8) d_ff=16384 vocab=32768. [arXiv:2401.04088; hf]
SWA (per assignment) => windowed KV cache => long_500k decode is runnable.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="mixtral-8x22b",
        family="moe",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=32768,
        num_experts=8,
        experts_per_token=2,
        sliding_window=4096,
        activation="swiglu",
        source="arXiv:2401.04088",
    )
)
