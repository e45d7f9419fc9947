"""Meta-device stand-ins for every model input (no allocation), plus the
logical-axes trees the dry run resolves layouts over, per cell.

The port's copy of the reference's ``launch/specs.py``: tensors on
``torch.device("meta")`` take the place of ``jax.ShapeDtypeStruct``. They
have shapes and dtypes and no storage, and the model's functions run on
them (the dry run counts their FLOPs). The parameters are the port's
unrolled flat dict (``layers.3.attn.wq``), built as a ``Model`` on the meta
device without drawing from a generator (a meta tensor takes none).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import FRONTEND_DIMS, ArchConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.train.optimizer import AdamWConfig, adamw_init

__all__ = ["META", "input_specs", "param_struct", "opt_struct", "cache_struct"]

META = torch.device("meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> tuple[dict, dict]:
    """Returns (batch meta tensors, batch logical-axes tree).

    train/prefill: full-sequence inputs; decode: one new token per sequence
    (the KV cache is a separate argument: see cache_struct)."""
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    # token ids are int64, the dtype torch's indexing takes (the
    # reference's are int32); no per-device figure counts the batch
    i64, f32 = torch.int64, torch.float32
    structs: dict[str, Any] = {}
    axes: dict[str, Any] = {}

    if cfg.modality == "audio":
        structs["embeds"] = torch.empty((b, s, FRONTEND_DIMS["audio"]), dtype=f32, device=META)
        axes["embeds"] = ("batch", "seq", None)
        if shape.kind == "train":
            structs["labels"] = torch.empty((b, s), dtype=i64, device=META)
            axes["labels"] = ("batch", "seq")
        return structs, axes

    s_text = s
    if cfg.modality == "vision" and shape.kind != "decode":
        p = min(cfg.frontend_tokens, max(1, s // 2))
        structs["embeds"] = torch.empty((b, p, FRONTEND_DIMS["vision"]), dtype=f32, device=META)
        axes["embeds"] = ("batch", "seq", None)
        s_text = s - p
    structs["tokens"] = torch.empty((b, s_text), dtype=i64, device=META)
    axes["tokens"] = ("batch", "seq")
    if shape.kind == "train":
        structs["labels"] = torch.empty((b, s_text), dtype=i64, device=META)
        axes["labels"] = ("batch", "seq")
    return structs, axes


def param_struct(cfg: ArchConfig) -> tuple[dict, dict]:
    """(params as a flat dict of meta tensors, their logical axes)."""
    model = M.Model(cfg, device=META)
    return M.param_dict(model), M.param_specs(cfg)


def opt_struct(cfg: ArchConfig, params_s: dict, moment_dtype: str = "float32") -> dict:
    """``adamw_init``'s state for ``params_s``, on the meta device."""
    return adamw_init(params_s, AdamWConfig(moment_dtype=moment_dtype))


def cache_struct(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """``init_cache``'s buffers on the meta device. The ``index``, a host
    int in the port's cache, stands here as the int32 scalar the
    reference's cache holds, so the per-device bytes are the reference's."""
    cache = M.init_cache(cfg, batch, seq_len, device=META)
    cache["index"] = torch.zeros((), dtype=torch.int32, device=META)
    return cache
