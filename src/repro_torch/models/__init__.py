from repro_torch.models.model import (
    Model,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    param_dict,
    param_specs,
    prefill,
)

__all__ = [
    "Model", "decode_step", "forward", "init_cache", "init_params", "loss_fn", "param_dict", "param_specs",
    "prefill",
]
