"""hubert-xlarge — encoder-only audio transformer (wav2vec2-style backbone).

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (masked-unit prediction
targets). [arXiv:2106.07447; unverified]
The conv waveform frontend is a stub: input_specs() provides precomputed
frame embeddings. Encoder-only => no decode shapes.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="hubert-xlarge",
        family="audio",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        is_encoder=True,
        modality="audio",
        activation="gelu",
        source="arXiv:2106.07447",
    )
)
