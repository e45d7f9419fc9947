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

A weight may also come split over model positions
(``repro_torch.fleet.tensor_parallel.SplitTensor``, the sharded population
engine's ``compute="sharded"``): any weight that is not a tensor is one.
``fault_linear`` and ``fault_einsum`` then run one GEMM per piece at the
piece's shape, each piece masked through its own rolled map
(``core/mapping.py::rolled_map``; an expert stack split over its experts
keeps the whole map), and combine the pieces' outputs into the whole
activation.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, TypeVar

import torch
from torch import nn

from repro_torch.core.faults import FaultMap
from repro_torch.core.mapping import masked_weight, rolled_map
from repro_torch.device import resolve_device

__all__ = [
    "FaultContext",
    "fault_linear",
    "fault_einsum",
    "healthy",
    "from_fault_map",
    "stack_contexts",
    "context_leak_reason",
    "mask_params",
    "mask_selected_params",
    "MASKABLE_KEYS",
]

MODES = ("none", "fap", "kernel")


@dataclass
class FaultContext:
    """Carries the chip's healthy mask (1=healthy PE, 0=faulty) + mode.

    ``ok`` is normally the single chip's (R, C) mask. A *batched* context
    (built with :func:`stack_contexts`) carries an (N, R, C) stack of N
    chips' masks behind one mode; the population engines hand its members
    to ``torch.func.vmap``, under which each member sees an ordinary (R, C)
    mask. A stack that reaches a masked GEMM outside vmap raises.
    """

    ok: Optional[torch.Tensor]  # (R, C) float mask, (N, R, C) stack, or None
    mode: str = "none"  # none | fap | kernel
    # ``ok`` rolled to split weights' piece origins, keyed by the origin mod
    # (R, C), built once per population chunk by the sharded engine; a
    # piece whose origin is missing here rolls ``ok`` itself
    rolled: Optional[dict] = None

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


def stack_contexts(ctxs: Sequence[FaultContext]) -> FaultContext:
    """Stack N per-chip contexts into one batched context.

    The result carries a leading population axis on ``ok`` and the members'
    shared mode. Healthy members are upcast to an all-ones mask (FAP with no
    faulty PE is exactly the healthy matmul), so a population can mix
    healthy and faulty chips; an all-healthy stack collapses to
    ``healthy()``.
    """
    if len(ctxs) == 0:
        raise ValueError(
            "stack_contexts: empty population — need at least one FaultContext "
            "(a single-member sequence is fine and stacks to population=1)"
        )
    active = [c for c in ctxs if c.active]
    if not active:
        return healthy()
    modes = {c.mode for c in active}
    if len(modes) != 1:
        raise ValueError(f"cannot stack contexts with mixed modes {sorted(modes)}")
    if any(c.ok.ndim != 2 for c in active):
        raise ValueError("stack_contexts takes per-chip (R, C) contexts, not batched ones")
    shapes = {tuple(c.ok.shape) for c in active}
    if len(shapes) != 1:
        raise ValueError(f"cannot stack contexts with mixed mask shapes {sorted(shapes)}")
    ok0 = active[0].ok
    oks = [c.ok if c.active else torch.ones_like(ok0) for c in ctxs]
    return FaultContext(ok=torch.stack(oks), mode=modes.pop())


def context_leak_reason(ctx: Optional[FaultContext]) -> Optional[str]:
    """The reason a context would be rejected by the masked-GEMM entry
    points, or None when it is safe."""
    if ctx is None or not ctx.active:
        return None
    if ctx.population is not None:
        return (
            f"batched FaultContext (population={ctx.population}) reached a "
            "masked GEMM; consume it under torch.func.vmap so each member sees "
            "an (R, C) mask (e.g. via PopulationFATEngine)"
        )
    if ctx.ok.ndim != 2:
        return f"FaultContext.ok must be (R, C) or (N, R, C), got ndim={ctx.ok.ndim}"
    return None


def _require_per_chip(ctx: FaultContext) -> None:
    reason = context_leak_reason(ctx)
    if reason is not None:
        raise ValueError(reason)


def _kernel_weight(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """w as the masked-GEMM kernels take it: in x's dtype, or the fp32
    master beside bf16 x (rounded on load); anything else is cast."""
    if w.dtype == x.dtype or (x.dtype == torch.bfloat16 and w.dtype == torch.float32):
        return w
    return w.to(x.dtype)


def _kernel_gemm(x: torch.Tensor, w: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """``kernel`` mode's masked GEMM: the kernel's wrapper, or on the meta
    device (the dry run, which counts its FLOPs) the custom op, whose fake
    impl gives the shape and whose FLOP formula is 2 * M * K * N."""
    # imported here: the kernel module imports core.mapping
    from repro_torch.kernels.masked_matmul.ops import masked_matmul

    if x.device.type == "meta":
        return torch.ops.repro_torch.masked_matmul(x, w, ok, "auto")
    return masked_matmul(x, w, ok)


def fault_linear(
    x: torch.Tensor, w: torch.Tensor, ctx: Optional[FaultContext] = None, bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y = x @ mask(w) (+ bias). ``w`` is (d_in, d_out); contraction over -1 of x.

    Weights are cast to the activation dtype (bf16 compute, fp32 master),
    as the reference does. The plain modes (``none``, ``fap``) cast first,
    so in bf16 every call reads the fp32 weight and writes a bf16 copy
    before the GEMM reads it. ``kernel`` mode hands the fp32 master to the
    masked-GEMM kernel, which rounds each weight to bf16 as it loads it: the
    same values, with no copy written. It casts only a w the kernels do not
    take (one neither in x's dtype nor fp32 beside bf16 x, e.g. a bf16
    ``param_dtype`` with a float32 ``dtype``).

    A split ``w`` (``SplitTensor``) runs :func:`_split_gemm`; its
    ``bias``, split alike, is added per piece.
    """
    if not isinstance(w, torch.Tensor):
        return _split_gemm(x, w, ctx, bias, fault_linear)
    if ctx is None or not ctx.active:
        y = torch.matmul(x, w.to(x.dtype))
    else:
        _require_per_chip(ctx)
        if ctx.mode == "kernel":
            y = _kernel_gemm(x, _kernel_weight(x, w), ctx.ok)
        else:
            y = torch.matmul(x, masked_weight(w.to(x.dtype), ctx.ok))
    return y if bias is None else y + bias


def _piece_ctx(ctx: Optional[FaultContext], r0: int, c0: int, device) -> Optional[FaultContext]:
    """The context of a weight piece at origin ``(r0, c0)`` of the whole
    weight's ``(d_in, d_out)`` view: ``ok`` rolled to that origin (the
    chunk's prebuilt map where ``ctx.rolled`` has it), on the piece's
    device."""
    if ctx is None or not ctx.active:
        return ctx
    _require_per_chip(ctx)
    rows, cols = ctx.ok.shape[-2:]
    key = (r0 % rows, c0 % cols)
    if key == (0, 0):  # the map itself: an expert piece, or a piece at a multiple of the array
        return FaultContext(ok=ctx.ok.to(device), mode=ctx.mode)
    ok = ctx.rolled.get(key) if ctx.rolled is not None else None
    if ok is None:
        ok = rolled_map(ctx.ok, *key)
    return FaultContext(ok=ok.to(device), mode=ctx.mode)


def _split_gemm(x: torch.Tensor, w, ctx: Optional[FaultContext], bias, gemm) -> torch.Tensor:
    """A masked GEMM ``gemm(x, piece, piece_ctx)`` on a weight split over
    model positions, at each piece's shape and on its device, under its own
    rolled map; nothing is gathered to the whole weight's shape.

    * column split (``w.axis == -1``, d_out): each piece's GEMM on the
      whole ``x``, plus the bias's piece, concatenated on the last dim;
    * row split (``w.axis == -2``, d_in): ``x`` cut along K at the pieces'
      offsets, the partial products summed in float32 (or x's wider dtype)
      on x's device, then the bias;
    * a transposed split leaf (``SplitTensor.T``, the tied unembed of a
      vocab-split embedding) is a column split whose origins are the
      vocab offsets;
    * expert split (``w.axis == -3``, an expert stack ``(E, K, N)``): each
      piece's experts on their slice of ``x`` ``(E, M, K)``, under the
      chip's whole map (each expert's ``(K, N)`` view is whole, its origin
      0), concatenated on the experts.

    The outputs return to ``x``'s device: the one combination across
    positions each GEMM makes (a local copy where the device repeats, a
    peer copy where it does not)."""
    # imported here: the fleet package imports this module
    from repro_torch.fleet.tensor_parallel import cut, join

    if w.axis == -1:
        if bias is not None and (isinstance(bias, torch.Tensor) or bias.offsets != w.offsets):
            raise ValueError("a column-split weight takes a bias split as it is")
        ys = []
        for j, (piece, c0) in enumerate(zip(w.pieces, w.offsets)):
            y = gemm(x.to(piece.device), piece, _piece_ctx(ctx, 0, c0, piece.device))
            ys.append(y if bias is None else y + bias.pieces[j])
        return join(ys, -1, x.device)
    if w.axis == -2:
        if bias is not None and not isinstance(bias, torch.Tensor):
            raise ValueError("a row-split weight takes a whole bias")
        acc = torch.promote_types(x.dtype, torch.float32)
        y = None
        for xk, piece, r0 in zip(cut(x, w, -1), w.pieces, w.offsets):
            part = gemm(xk, piece, _piece_ctx(ctx, r0, 0, piece.device)).to(x.device, acc)
            y = part if y is None else y + part
        y = y.to(x.dtype)
        return y if bias is None else y + bias
    if w.axis == -3 and bias is None:
        ys = [gemm(xe, piece, _piece_ctx(ctx, 0, 0, piece.device)) for xe, piece in zip(cut(x, w, -3), w.pieces)]
        return join(ys, -3, x.device)
    raise ValueError(f"a split weight's GEMM view is its last two dims, or its experts (dim -3) with no bias; "
                     f"got a split on dim {w.axis}")


# the einsum specs that are a batched GEMM x (E, M, K) @ w (E, K, N): the MoE
# expert FFNs' (models/moe.py)
EXPERT_SPECS = ("ecd,edf->ecf", "ecf,efd->ecd")


def fault_einsum(
    spec: str, x: torch.Tensor, w: torch.Tensor, ctx: Optional[FaultContext] = None
) -> torch.Tensor:
    """Masked einsum for weights whose GEMM view is the last two dims of
    ``w`` (the MoE experts' ``(e, d, f)``): every expert GEMM runs on the
    same chip, hence under the same periodic mask.

    ``none`` and ``fap`` run ``torch.einsum`` on the weight cast to x's
    dtype (and masked), as the reference does. ``kernel`` mode takes the
    expert specs (``EXPERT_SPECS``), each ``x (E, M, K) @ w (E, K, N)``, to
    the masked-GEMM kernel with the experts as its batch axis and the one
    ``(R, C)`` mask shared by all of them: one launch for every expert, the
    mask applied on chip, no masked copy written. Any other spec raises in
    ``kernel`` mode.

    A split expert stack (``SplitTensor``, the sharded engine's
    ``compute="sharded"``) runs :func:`_split_gemm` on the expert specs:
    split over its experts, each piece's experts take their slice of x
    under the chip's whole map (one expert-batched launch a piece in
    ``kernel`` mode); split inside its experts (the rules' fallback where
    the experts do not divide the model extent), each piece is masked
    through the map rolled to its origin, as a 2-D weight's piece is."""
    if not isinstance(w, torch.Tensor):
        if spec not in EXPERT_SPECS:
            raise ValueError(f"a split weight runs the expert specs {EXPERT_SPECS}, not {spec!r}")
        return _split_gemm(x, w, ctx, None, lambda xp, wp, cp: fault_einsum(spec, xp, wp, cp))
    if ctx is None or not ctx.active:
        return torch.einsum(spec, x, w.to(x.dtype))
    _require_per_chip(ctx)
    if ctx.mode == "kernel":
        if spec not in EXPERT_SPECS:
            raise ValueError(f"kernel mode runs the expert specs {EXPERT_SPECS}, not {spec!r}")
        return _kernel_gemm(x, _kernel_weight(x, w), ctx.ok)
    return torch.einsum(spec, x, masked_weight(w.to(x.dtype), ctx.ok))


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


Params = TypeVar("Params", nn.Module, dict)


def _mask_module(
    params: Params, ctx: FaultContext, pred: Callable[[str, torch.Tensor], bool]
) -> Params:
    if not ctx.active:
        return params
    _require_per_chip(ctx)
    if isinstance(params, dict):  # a dict of tensors, as the classifier's
        return {
            name: masked_weight(p, ctx.ok.to(p.device, p.dtype)) if pred(name, p) else p
            for name, p in params.items()
        }
    out = copy.deepcopy(params)
    with torch.no_grad():
        for name, p in out.named_parameters():
            if pred(name, p):
                p.copy_(masked_weight(p, ctx.ok.to(p.device, p.dtype)))
    return out


def mask_selected_params(params: Params, ctx: FaultContext) -> Params:
    """A copy of ``params`` with the FAP mask applied ONCE to every
    array-mapped weight (names in ``MASKABLE_KEYS``). Tied embeddings are
    excluded: the lookup must see unmasked rows; the tied unembed GEMM keeps
    its use-site mask."""
    return _mask_module(
        params, ctx, lambda name, p: bool(set(name.split(".")) & MASKABLE_KEYS) and p.ndim >= 2
    )


def mask_params(params: Params, ctx: FaultContext, is_mapped=None) -> Params:
    """A copy of ``params`` (a module, or a dict of tensors) with FAP masks
    on every array-mapped parameter.
    ``is_mapped(name, param) -> bool`` decides which; default: every float
    parameter with ndim >= 2."""
    return _mask_module(
        params, ctx, is_mapped or (lambda name, p: p.ndim >= 2 and p.is_floating_point())
    )
