"""smollm-135m — llama-arch small dense decoder.

30L d_model=576 9H (kv=3) d_ff=1536 vocab=49152. [hf:HuggingFaceTB/SmolLM-135M; hf]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="smollm-135m",
        family="dense",
        num_layers=30,
        d_model=576,
        num_heads=9,
        num_kv_heads=3,
        d_ff=1536,
        vocab_size=49152,
        tie_embeddings=True,
        activation="swiglu",
        source="hf:HuggingFaceTB/SmolLM-135M",
    )
)
