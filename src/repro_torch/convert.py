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
from repro_torch.models.model import Model, param_dict

__all__ = [
    "params_from_jax",
    "param_dict_from_jax",
    "opt_state_from_jax",
    "checkpoint_from_jax",
    "classifier_params_from_jax",
    "context_from_ok",
]

# the reference's FaultContext mode names -> the port's
_MODES = {"none": "none", "fap": "fap", "pallas": "kernel"}


@torch.no_grad()
def params_from_jax(cfg, tree: Mapping, *, device=None) -> Model:
    """The port's model holding the reference's parameters.

    ``tree`` is the reference's param dict with numpy leaves; its layers are
    stacked on axis 0 (``tree["layers"][...][i]`` is layer i), and are
    unstacked into the port's ``ModuleList``. The port's parameter names
    are the reference's keys (``layers.i.ssm.a_log`` is
    ``tree["layers"]["ssm"]["a_log"][i]``, an untied ``lm_head`` is
    ``tree["lm_head"]``), so every family walks the same way. Every weight
    keeps its ``(d_in, d_out)`` layout."""
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


def param_dict_from_jax(cfg, tree: Mapping, *, device=None) -> dict:
    """The reference's param tree as the port's flat dict of tensors
    (``repro_torch.models.model.param_dict`` of :func:`params_from_jax`)."""
    return param_dict(params_from_jax(cfg, tree, device=device))


def opt_state_from_jax(cfg, state: Mapping, *, device=None) -> dict:
    """The reference's AdamW state (``m`` and ``v`` shaped as the param
    tree, an int32 ``count``) as the port's: flat dicts of tensors."""
    return dict(
        m=param_dict_from_jax(cfg, state["m"], device=device),
        v=param_dict_from_jax(cfg, state["v"], device=device),
        count=torch.tensor(np.asarray(state["count"]), dtype=torch.int32, device=resolve_device(device)),
    )


def _unflatten(flat: Mapping, sep: str = "/") -> dict:
    tree: dict = {}
    for key, arr in flat.items():
        *path, leaf = key.split(sep)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return tree


def checkpoint_from_jax(cfg, flat: Mapping) -> dict:
    """A checkpoint the reference's loop wrote (``{"params": ..., "opt":
    ...}`` flattened by ``load_checkpoint``, layers stacked) as the flat
    arrays the port's ``restore_sharded`` reads for its own template (one
    entry per layer and leaf)."""
    tree = _unflatten(flat)
    params = param_dict_from_jax(cfg, tree["params"], device="cpu")
    opt = opt_state_from_jax(cfg, tree["opt"], device="cpu")
    out = {f"params/{k}": t.numpy() for k, t in params.items()}
    for part in ("m", "v"):
        out.update({f"opt/{part}/{k}": t.numpy() for k, t in opt[part].items()})
    out["opt/count"] = opt["count"].numpy()
    return out


def classifier_params_from_jax(tree: Mapping, *, device=None) -> dict:
    """The reference classifier's params (``{"w0", "b0", ...}`` with numpy
    leaves) as the port's dict of tensors, name for name."""
    dev = resolve_device(device)
    return {name: torch.tensor(np.asarray(arr)).to(dev) for name, arr in tree.items()}


def context_from_ok(ok: Optional[np.ndarray], mode: str, *, device=None) -> FaultContext:
    """The port's FaultContext for the reference's ``(ok, mode)``; the
    reference's ``pallas`` mode is the port's ``kernel`` mode."""
    if mode not in _MODES:
        raise ValueError(f"unknown reference fault mode {mode!r}")
    if ok is None or mode == "none":
        return healthy()
    ok_t = torch.as_tensor(np.asarray(ok, np.float32), device=resolve_device(device))
    return FaultContext(ok=ok_t, mode=_MODES[mode])
