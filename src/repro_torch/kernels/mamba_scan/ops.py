"""Mamba-1 selective scan: the CUDA kernel's wrapper, its plain PyTorch
version, its launch plan, the one-step decode update and the launch count.

Kernel: ``kernels/csrc/selective_scan.cu``. It replaces the TPU kernel
``repro/kernels/mamba_scan/mamba_scan.py::selective_scan_pallas``.

Bound on an H100: the one exponential per (batch, step, channel, state) on
the special-function units, which takes longer than the bytes at every
shape the serving paths give it. The kernel splits each channel's N states
over ``lanes`` lanes of a warp (``states`` a lane, in registers), reduces y
over them with a fixed shuffle tree, copies the next chunk of time steps
into a shared-memory ring by ``cp.async`` while this one runs, and writes no
intermediate to device memory. ``scan_plan`` picks the lanes from host
shapes and the card's SM count alone, so that the grid puts about
``TARGET_WARPS_PER_SM`` warps on each SM; the chunk of time steps a ring
stage holds, and so the shared memory, is the C source's.

The lanes come from the caller, else the tuning cache
(``kernels.common.tuned_block``, kernel ``mamba_scan``, the reference's key
``(b, l, d, n)``; it has no chip field, so a chip-batched launch keeps the
plan), else ``scan_plan``: ``resolve_plan``. Lanes that ``_plan`` refuses
(not a power of two up to a warp, or more than ``MAX_STATES_PER_LANE``
states a lane) raise before any launch.

``selective_scan`` launches the kernel for a CUDA tensor and counts the
launch in ``selective_scan.launches`` (a chip-batched one also in
``selective_scan.fleet_launches``); for a CPU tensor it runs
``selective_scan_ref``, the plain version. There is no fallback between the
two. The TPU wrapper pads L and D to block multiples for its BlockSpecs; the
kernel masks its own ragged edge, so nothing is padded here.

A chip axis: with a of shape (chips, D, N) and d (chips, D), the B rows
of u, dt, b and c are chips x B / chips, and row r reads chip r // (B /
chips)'s a and d through a chip stride (0: one a or d for every chip), so a
fleet's prefill scans every chip in one launch (``selective_scan.
fleet_launches`` counts them). Under ``torch.func.vmap`` the wrapper reaches
that launch through the custom op ``repro_torch::selective_scan`` and its
vmap rule, which folds the vmapped axis into the rows: the counterpart of
the TPU kernel under ``jax.vmap``, whose batching rule adds the axis to the
grid.

Decode runs ``selective_step``, plain PyTorch, on every device: the
reference runs its plain step at decode on the TPU too, with no kernel.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.common import check_launch, load_kernel, sm_count, tuned_block, under_vmap

__all__ = [
    "selective_scan",
    "selective_scan_ref",
    "selective_step",
    "scan_plan",
    "resolve_plan",
    "lane_choices",
    "ScanPlan",
    "MAX_STATE",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8
    + [ctypes.c_int] + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
)
# the CUDA source's geometry: THREADS per block; a channel takes 1-32 lanes (a power of two),
# each holding 1, 2, 4 or 8 states in registers, so at most 32 x 8 states a channel
THREADS, WARP = 128, 32
MAX_STATES_PER_LANE = 8
MAX_STATE = WARP * MAX_STATES_PER_LANE
TARGET_WARPS_PER_SM = 12  # the plan's aim with 4 or more states a lane; an SM holds at most 64
FLOOR_WARPS_PER_SM = 4  # below this the plan takes lanes down to one state a lane


class ScanPlan(NamedTuple):
    lanes: int  # lanes of a warp per channel
    states: int  # states per lane; lanes * states >= N
    channels: int  # channels per block: THREADS // lanes
    blocks: int  # the grid: B (every chip's rows) x ceil(D / channels)


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _check_states(n: int) -> int:
    n = int(n)
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"the CUDA scan takes 1 to {MAX_STATE} states, got {n}")
    return n


LANES = (1, 2, 4, 8, 16, 32)  # the lanes a channel may take: the C source's instances


def lane_choices(n: int) -> tuple:
    """The lanes ``_plan`` takes for N states: those that hold N in at most
    ``MAX_STATES_PER_LANE`` states a lane."""
    return tuple(l for l in LANES if _pow2_at_least(-(-int(n) // l)) <= MAX_STATES_PER_LANE)


def _plan(b: int, d: int, n: int, lanes: int) -> ScanPlan:
    """The launch at ``lanes`` lanes a channel: the fewest states a lane
    (a power of two) that hold N, and the grid."""
    if lanes not in LANES or _pow2_at_least(-(-n // lanes)) > MAX_STATES_PER_LANE:
        raise ValueError(f"no scan kernel for {n} states at {lanes} lanes a channel")
    states = _pow2_at_least(-(-n // lanes))
    channels = THREADS // lanes
    return ScanPlan(lanes, states, channels, int(b) * -(-int(d) // channels))


def scan_plan(b: int, d: int, n: int, sm_count: int) -> ScanPlan:
    """The launch plan of the scan kernel, from host-known shapes and the
    card's SM count alone (the length L does not move it).

    The lanes per channel start at the fewest that hold N in at most
    ``MAX_STATES_PER_LANE`` states a lane and double, while lanes stay under
    N and under a warp, as long as the grid's threads (B x D x lanes) put
    under ``FLOOR_WARPS_PER_SM`` warps on each SM, or under
    ``TARGET_WARPS_PER_SM`` with more than 4 states a lane: more lanes fill
    the card, more states a lane give each warp more independent chains and
    cost less per state (on the H100, 2 lanes of 8 states beat 4 of 4 at
    falcon-mamba's 4 x 8192 channels, and 4 of 4 beat 8 of 2 at hymba's 4 x
    3200). Raises ``ValueError`` outside 1 <= N <= ``MAX_STATE``."""
    n = _check_states(n)
    lanes = _pow2_at_least(-(-n // MAX_STATES_PER_LANE))

    def warps(lanes):
        return int(b) * int(d) * lanes / WARP / int(sm_count)

    while lanes < WARP and lanes < n and (
            warps(lanes) < FLOOR_WARPS_PER_SM
            or (warps(lanes) < TARGET_WARPS_PER_SM and -(-n // lanes) > 4)):
        lanes *= 2
    return _plan(b, d, n, lanes)


def resolve_plan(b: int, length: int, d: int, n: int, dtype: torch.dtype, device, sms: int,
                 lanes: Optional[int] = None) -> ScanPlan:
    """The plan the wrapper launches: the caller's lanes, else the tuning
    cache's, else ``scan_plan``'s; ``_plan`` raises on lanes it refuses."""
    got = tuned_block(
        "mamba_scan", dict(b=b, l=length, d=d, n=n), dtype, device=device,
        defaults=lambda: dict(lanes=scan_plan(b, d, n, sms).lanes), overrides=dict(lanes=lanes),
    )["lanes"]
    return _plan(b, d, n, got)


def _per_row(t: torch.Tensor, rows: int) -> torch.Tensor:
    """A chip-stacked a or d, one entry per batch row: chip c's for its
    ``rows`` rows, each with a length-1 time axis."""
    return t.repeat_interleave(rows, dim=0)[:, None]


def selective_scan_ref(u, dt, a, b, c, d):
    """Plain version, in fp32. u, dt: (B, L, D); a: (D, N); b, c: (B, L, N);
    d: (D,). Returns (y (B, L, D) in u's dtype, h_last (B, D, N) fp32).
    With a chip axis, a is (chips, D, N), d (chips, D) and the B rows are
    chips x B / chips: row r meets chip r // (B / chips)'s a and d."""
    bsz, length, dim = u.shape
    u32, dt32, a32 = u.float(), dt.float(), a.float()
    if a.dim() == 3:
        rows = bsz // a.shape[0]
        a32, d = _per_row(a32, rows), _per_row(d, rows)
    da = torch.exp(dt32[..., None] * a32)  # (B, L, D, N)
    dbu = (dt32 * u32)[..., None] * b.float()[:, :, None, :]
    n = a.shape[-1]
    hs = torch.empty((length, bsz, dim, n), dtype=torch.float32, device=u.device)
    h = torch.zeros((bsz, dim, n), dtype=torch.float32, device=u.device)
    for t in range(length):
        h = hs[t] = da[:, t] * h + dbu[:, t]
    y = torch.einsum("lbdn,bln->bld", hs, c.float()) + u32 * d.float()
    return y.to(u.dtype), h


def selective_step(h, u_t, dt_t, a, b_t, c_t, d):
    """One decode step. h: (B, D, N) fp32; u_t, dt_t: (B, D); b_t, c_t: (B, N).
    Returns (y_t (B, D) in u_t's dtype, the new h)."""
    da = torch.exp(dt_t.float()[..., None] * a.float())
    h = da * h + (dt_t * u_t).float()[..., None] * b_t.float()[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, c_t.float()) + u_t * d
    return y.to(u_t.dtype), h


def selective_scan(u, dt, a, b, c, d, *, lanes: Optional[int] = None):
    """(y, h_last) of the selective scan; shapes as ``selective_scan_ref``:
    one chip's a (D, N) and d (D,), or a chip axis, a (chips, D, N) and d
    (chips, D), whose B rows are chips x B / chips, in one launch.

    On CUDA: u, b and c share a dtype (float32 or bfloat16); dt, a and d
    are float32 (the model's dt is fp32: a bf16 GEMM output plus the fp32
    bias). u, dt, b and c have a unit stride on their last axis and are
    read through their other strides, so b and c may be slices of one
    tensor; a's and d's last axes are contiguous, and their chip stride is
    whole or 0 (one a or d for every chip); 1 <= N <= ``MAX_STATE``.
    ``lanes`` forces the lanes a channel takes (the rest of the plan
    follows), else the tuning cache's, else ``scan_plan``'s
    (``resolve_plan``). Under ``torch.func.vmap`` (a fleet's prefill) the
    call goes through the custom op ``repro_torch::selective_scan``, whose
    vmap rule makes the vmapped axis the chip axis: one launch for every
    chip, counted also in ``selective_scan.fleet_launches``. On the meta
    device (the dry run, ``launch/dryrun_lib.py``) the call goes through the
    custom op too, whose fake impl gives the shapes at once where the plain
    version would loop over every step."""
    if under_vmap(u, dt, a, b, c, d) or u.device.type == "meta":
        return torch.ops.repro_torch.selective_scan(u, dt, a, b, c, d, lanes)
    if u.device.type == "cpu":
        return selective_scan_ref(u, dt, a, b, c, d)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cpu or cuda, got {u.device}")
    chips = a.shape[0] if a.dim() == 3 else 1
    if u.dim() != 3 or a.dim() not in (2, 3) or d.dim() != a.dim() - 1 or u.shape[0] % chips:
        raise ValueError(f"bad shapes u{tuple(u.shape)} a{tuple(a.shape)} d{tuple(d.shape)}")
    bsz, length, dim = u.shape
    n = a.shape[-1]
    lead = (chips,) if a.dim() == 3 else ()
    if (tuple(dt.shape) != (bsz, length, dim) or tuple(a.shape) != (*lead, dim, n)
            or tuple(b.shape) != (bsz, length, n) or tuple(c.shape) != (bsz, length, n)
            or tuple(d.shape) != (*lead, dim)):
        raise ValueError(
            f"bad shapes u{tuple(u.shape)} dt{tuple(dt.shape)} a{tuple(a.shape)} "
            f"b{tuple(b.shape)} c{tuple(c.shape)} d{tuple(d.shape)}"
        )
    if u.dtype not in _DTYPES or b.dtype != u.dtype or c.dtype != u.dtype:
        raise TypeError(f"u, b and c must share float32 or bfloat16, got {u.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError(f"dt, a and d must be float32, got {dt.dtype}, {a.dtype}, {d.dtype}")
    if any(t.device != u.device for t in (dt, a, b, c, d)) or u.device.index != torch.cuda.current_device():
        raise ValueError("u, dt, a, b, c and d must lie on the current CUDA device")
    if any(t.stride(-1) != 1 for t in (u, dt, b, c)) or not (a[(0,) * len(lead)].is_contiguous()
                                                           and d[(0,) * len(lead)].is_contiguous()):
        raise ValueError("u, dt, b and c need a unit last stride; a and d must be contiguous")
    sa, sd = (a.stride(0), d.stride(0)) if lead else (0, 0)
    if lead and (sa not in (0, dim * n) or sd not in (0, dim)):
        raise ValueError(f"a and d take a whole or zero chip stride, got {a.stride()} and {d.stride()}")
    n = _check_states(n)
    sms = sm_count(u.device)
    # the tuning cache's key has no chip field: a chip-batched launch keeps the plan
    plan = (_plan(bsz, dim, n, lanes if lanes is not None else scan_plan(bsz, dim, n, sms).lanes) if lead
            else resolve_plan(bsz, length, dim, n, u.dtype, u.device, sms, lanes))
    y = torch.empty((bsz, length, dim), dtype=u.dtype, device=u.device)
    h_last = torch.empty((bsz, dim, n), dtype=torch.float32, device=u.device)
    if bsz and dim:
        fn = load_kernel("selective_scan", _ARGTYPES)
        err = fn(
            _DTYPES[u.dtype], u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), d.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            bsz, length, dim, n, plan.lanes, plan.states, u.stride(0), u.stride(1), dt.stride(0), dt.stride(1),
            b.stride(0), b.stride(1), c.stride(0), c.stride(1), bsz // chips, sa, sd,
            torch.cuda.current_stream().cuda_stream,
        )
        check_launch("selective_scan", err)
        selective_scan.launches += 1
        if lead:
            selective_scan.fleet_launches += 1
        selective_scan.last_plan = plan
    return y, h_last


selective_scan.launches = 0
selective_scan.fleet_launches = 0
selective_scan.last_plan = None


@torch.library.custom_op("repro_torch::selective_scan", mutates_args=())
def _selective_scan_op(
    u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    d: torch.Tensor, lanes: Optional[int],
) -> tuple[torch.Tensor, torch.Tensor]:
    return selective_scan(u, dt, a, b, c, d, lanes=lanes)


@_selective_scan_op.register_fake
def _(u, dt, a, b, c, d, lanes):
    return u.new_empty(u.shape), u.new_empty((u.shape[0], u.shape[2], a.shape[-1]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.selective_scan)
def _selective_scan_flops(u, dt, a, b, c, d, lanes, *args, out_shape=None, **kwargs) -> int:
    """The products of the plain version: y = C . h contracts the N states
    of every (row, step, channel), 2 * B * L * D * N. The recurrence, the
    exponentials and the skip term are elementwise, which
    ``FlopCounterMode`` does not count."""
    bsz, length, dim = u
    return 2 * bsz * length * dim * a[-1]


def _selective_scan_setup(ctx, inputs, output):
    u, dt, a, b, c, d, _ = inputs
    ctx.save_for_backward(u, c)
    ctx.like = [(t.shape, t.dtype) for t in (u, dt, a, b, c, d)]


def _selective_scan_backward(ctx, gy, gh):
    """The backward on the meta device alone, for the dry run's count: the
    plain version's two products, d(h) = dy x C and d(C) = h . dy (each the
    forward's count), as autograd runs them on ``selective_scan_ref``; every
    other gradient is shape only. Off the meta device the scan has no
    backward: training runs the plain version under autograd."""
    u, c = ctx.saved_tensors
    if u.device.type != "meta":
        raise NotImplementedError("the selective scan kernel has no backward; train through selective_scan_ref")
    bsz, length, dim = u.shape
    rows, n = bsz * length, c.shape[-1]
    torch.bmm(gy.float().reshape(rows, dim, 1), c.float().reshape(rows, 1, n))  # d(h): (rows, D, N)
    hs = u.new_empty((rows, n, dim), dtype=torch.float32)
    dc = torch.bmm(hs, gy.float().reshape(rows, dim, 1)).reshape(bsz, length, n)
    grads = [u.new_empty(shape, dtype=dtype) for shape, dtype in ctx.like]
    grads[4] = dc.to(c.dtype)
    return (*grads, None)


torch.library.register_autograd(
    "repro_torch::selective_scan", _selective_scan_backward, setup_context=_selective_scan_setup
)


def _chip_stack(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads a chip stack of a or d: each chip's entry
    contiguous, chips a whole entry or 0 apart; copied only otherwise."""
    whole = t[0].is_contiguous() and t.stride(0) in (0, t[0].numel())
    return t if whole else t.contiguous()


def _selective_scan_vmap(info, in_dims, u, dt, a, b, c, d, lanes):
    """The chip-batched launch under ``torch.func.vmap``: the vmapped axis
    becomes the kernel's chip axis. The chips' batch rows fold into the
    grid's rows (chip-major), each chip's a and d are read at its own
    offset, and an a or d shared by every chip is read with chip stride 0,
    never copied."""
    n = info.batch_size

    def chip_major(t, dim):  # the vmapped axis first, present on every chip
        return t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)

    rows = [chip_major(t, dim) for t, dim in zip((u, dt, b, c), in_dims[:2] + in_dims[3:5])]
    bsz = rows[0].shape[1]
    u, dt, b, c = (t.reshape(n * bsz, *t.shape[2:]) for t in rows)
    a, d = (_chip_stack(chip_major(t, dim)) for t, dim in ((a, in_dims[2]), (d, in_dims[5])))
    y, h = selective_scan(u, dt, a, b, c, d, lanes=lanes)
    return (y.view(n, bsz, *y.shape[1:]), h.view(n, bsz, *h.shape[1:])), (0, 0)


torch.library.register_vmap("repro_torch::selective_scan", _selective_scan_vmap)
