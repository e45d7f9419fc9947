from repro_torch.models.model import (
    Model,
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)

__all__ = ["Model", "decode_step", "forward", "init_cache", "init_params", "prefill"]
