"""internvl2-26b — VLM: InternViT frontend (STUB) + InternLM2-20B backbone.

48L d_model=6144 48H (kv=8) d_ff=16384 vocab=92553. [arXiv:2404.16821; hf]
The vision frontend is a stub: input_specs() provides precomputed patch
embeddings (a prefix of ``frontend_tokens`` dense vectors) per the assignment.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="internvl2-26b",
        family="vlm",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=92553,
        modality="vision",
        frontend_tokens=256,  # one 448x448 tile -> 256 patch embeddings
        activation="swiglu",
        source="arXiv:2404.16821",
    )
)
