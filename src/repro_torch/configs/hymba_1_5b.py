"""hymba-1.5b — hybrid decoder: parallel attention + mamba heads per block.

32L d_model=1600 25H (kv=5) d_ff=5504 vocab=32001 ssm_state=16.
[arXiv:2411.13676; hf]
Sliding-window attention on the attention branch + O(1) SSM state.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        sliding_window=1024,
        activation="swiglu",
        source="arXiv:2411.13676",
    )
)
