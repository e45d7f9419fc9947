"""falcon-mamba-7b — pure Mamba-1 SSM LM (attention-free).

64L d_model=4096 d_ff=0 vocab=65024 ssm_state=16. [arXiv:2410.05355; unverified]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="falcon-mamba-7b",
        family="ssm",
        num_layers=64,
        d_model=4096,
        d_ff=0,
        vocab_size=65024,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        tie_embeddings=False,
        source="arXiv:2410.05355",
    )
)
