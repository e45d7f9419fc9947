"""Fault-context plumbing: how a chip's fault map reaches every matmul.

Model layers never materialize full-weight masks up front; they call
``fault_linear(x, w, ctx)`` which applies the periodic systolic mask per use.

Modes
-----
none    : healthy chip — plain matmul, zero overhead.
fap     : Fault-Aware Pruning semantics in plain PyTorch — weights on faulty
          PEs are zeroed in the forward pass.
kernel  : same semantics through the hand-written masked-GEMM kernel
          (``kernels/masked_matmul``), which applies the mask on chip and
          never writes a masked weight copy. The reference calls this mode
          ``pallas``. On a CPU tensor the kernel's plain version runs.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.core.faults import FaultMap
from repro_torch.core.mapping import masked_weight
from repro_torch.device import resolve_device

__all__ = [
    "FaultContext",
    "fault_linear",
    "healthy",
    "from_fault_map",
    "context_leak_reason",
    "mask_params",
    "mask_selected_params",
    "MASKABLE_KEYS",
]

MODES = ("none", "fap", "kernel")


@dataclass
class FaultContext:
    """Carries the chip's healthy mask (1=healthy PE, 0=faulty) + mode."""

    ok: Optional[torch.Tensor]  # (R, C) float mask, or None
    mode: str = "none"  # none | fap | kernel

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}; expected one of {MODES}")

    @property
    def active(self) -> bool:
        return self.mode != "none" and self.ok is not None

    @property
    def population(self) -> Optional[int]:
        """Number of stacked members, or None for a per-chip context."""
        if self.ok is None or self.ok.ndim == 2:
            return None
        return int(self.ok.shape[0])


def healthy() -> FaultContext:
    return FaultContext(ok=None, mode="none")


def from_fault_map(
    fm: Optional[FaultMap], mode: str = "fap", dtype=torch.float32, device=None
) -> FaultContext:
    if fm is None:
        return healthy()
    ok = torch.as_tensor(fm.ok_mask, dtype=dtype, device=resolve_device(device))
    return FaultContext(ok=ok, mode=mode)


def context_leak_reason(ctx: Optional[FaultContext]) -> Optional[str]:
    """The reason a context would be rejected by the masked-GEMM entry
    points, or None when it is safe."""
    if ctx is None or not ctx.active:
        return None
    if ctx.population is not None:
        return (
            f"batched FaultContext (population={ctx.population}) reached a "
            "masked GEMM; each member must see an (R, C) mask"
        )
    if ctx.ok.ndim != 2:
        return f"FaultContext.ok must be (R, C) or (N, R, C), got ndim={ctx.ok.ndim}"
    return None


def _require_per_chip(ctx: FaultContext) -> None:
    reason = context_leak_reason(ctx)
    if reason is not None:
        raise ValueError(reason)


def fault_linear(
    x: torch.Tensor, w: torch.Tensor, ctx: Optional[FaultContext] = None
) -> torch.Tensor:
    """y = x @ mask(w). ``w`` is (d_in, d_out); contraction over -1 of x.

    Weights are cast to the activation dtype (bf16 compute, fp32 master),
    as the reference does. The plain modes (``none``, ``fap``) cast first,
    so in bf16 every call reads the fp32 weight and writes a bf16 copy
    before the GEMM reads it. ``kernel`` mode hands the fp32 master to the
    masked-GEMM kernel, which rounds each weight to bf16 as it loads it: the
    same values, with no copy written. It casts only a w the kernels do not
    take (one neither in x's dtype nor fp32 beside bf16 x, e.g. a bf16
    ``param_dtype`` with a float32 ``dtype``).
    """
    if ctx is None or not ctx.active:
        return torch.matmul(x, w.to(x.dtype))
    _require_per_chip(ctx)
    if ctx.mode == "kernel":
        # imported here: the kernel module imports core.mapping
        from repro_torch.kernels.masked_matmul.ops import masked_matmul

        if not (w.dtype == x.dtype or (x.dtype == torch.bfloat16 and w.dtype == torch.float32)):
            w = w.to(x.dtype)
        return masked_matmul(x, w, ctx.ok)
    return torch.matmul(x, masked_weight(w.to(x.dtype), ctx.ok))


# Parameter names that flow through fault_linear (execute as GEMMs on the
# systolic array). Embedding lookups and 1-D scales are not array-mapped.
MASKABLE_KEYS = frozenset(
    {
        "wq", "wk", "wv", "wo",  # attention projections
        "wg", "wu", "wd", "wi",  # MLP / expert FFNs
        "router",
        "in_proj", "x_proj", "dt_w", "out_proj",  # SSM GEMMs
        "frontend", "lm_head",
    }
)


def _mask_module(
    params: nn.Module, ctx: FaultContext, pred: Callable[[str, torch.Tensor], bool]
) -> nn.Module:
    if not ctx.active:
        return params
    _require_per_chip(ctx)
    out = copy.deepcopy(params)
    with torch.no_grad():
        for name, p in out.named_parameters():
            if pred(name, p):
                p.copy_(masked_weight(p, ctx.ok.to(p.device, p.dtype)))
    return out


def mask_selected_params(params: nn.Module, ctx: FaultContext) -> nn.Module:
    """A copy of ``params`` with the FAP mask applied ONCE to every
    array-mapped weight (names in ``MASKABLE_KEYS``). Tied embeddings are
    excluded: the lookup must see unmasked rows; the tied unembed GEMM keeps
    its use-site mask."""
    return _mask_module(
        params, ctx, lambda name, p: bool(set(name.split(".")) & MASKABLE_KEYS) and p.ndim >= 2
    )


def mask_params(params: nn.Module, ctx: FaultContext, is_mapped=None) -> nn.Module:
    """A copy of ``params`` with FAP masks on every array-mapped parameter.
    ``is_mapped(name, param) -> bool`` decides which; default: every float
    parameter with ndim >= 2."""
    return _mask_module(
        params, ctx, is_mapped or (lambda name, p: p.ndim >= 2 and p.is_floating_point())
    )
