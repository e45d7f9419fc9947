"""Hand the reference package's parameters and fault contexts to the port.

``jax.random`` streams cannot be replayed in PyTorch, so parity tests make
parameters with the reference, turn their leaves into numpy arrays
(``jax.tree.map(np.asarray, params)``) and build the port's model from them
here. This module takes numpy only; it imports nothing of JAX.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core.masking import FaultContext, healthy
from repro_torch.device import resolve_device
from repro_torch.models.model import Model

__all__ = ["params_from_jax", "context_from_ok"]

# the reference's FaultContext mode names -> the port's
_MODES = {"none": "none", "fap": "fap", "pallas": "kernel"}


@torch.no_grad()
def params_from_jax(cfg, tree: Mapping, *, device=None) -> Model:
    """The port's model holding the reference's parameters.

    ``tree`` is the reference's param dict with numpy leaves; its layers are
    stacked on axis 0 (``tree["layers"][...][i]`` is layer i), and are
    unstacked into the port's ``ModuleList``. Every weight keeps its
    ``(d_in, d_out)`` layout."""
    model = Model(cfg, device=device)
    for name, p in model.named_parameters():
        parts = name.split(".")
        node = tree
        if parts[0] == "layers":
            for key in ["layers", *parts[2:]]:
                node = node[key]
            arr = np.asarray(node)[int(parts[1])]
        else:
            for key in parts:
                node = node[key]
            arr = np.asarray(node)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: reference shape {arr.shape} vs port {tuple(p.shape)}")
        p.copy_(torch.tensor(arr))
    return model


def context_from_ok(ok: Optional[np.ndarray], mode: str, *, device=None) -> FaultContext:
    """The port's FaultContext for the reference's ``(ok, mode)``; the
    reference's ``pallas`` mode is the port's ``kernel`` mode."""
    if mode not in _MODES:
        raise ValueError(f"unknown reference fault mode {mode!r}")
    if ok is None or mode == "none":
        return healthy()
    ok_t = torch.as_tensor(np.asarray(ok, np.float32), device=resolve_device(device))
    return FaultContext(ok=ok_t, mode=_MODES[mode])
