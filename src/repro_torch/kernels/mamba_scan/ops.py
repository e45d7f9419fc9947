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
``(b, l, d, n)``), else ``scan_plan``: ``resolve_plan``. Lanes that ``_plan``
refuses (not a power of two up to a warp, or more than
``MAX_STATES_PER_LANE`` states a lane) raise before any launch.

``selective_scan`` launches the kernel for a CUDA tensor and counts the
launch in ``selective_scan.launches``; for a CPU tensor it runs
``selective_scan_ref``, the plain version. There is no fallback between the
two. The TPU wrapper pads L and D to block multiples for its BlockSpecs; the
kernel masks its own ragged edge, so nothing is padded here.

Decode runs ``selective_step``, plain PyTorch, on every device: the
reference runs its plain step at decode on the TPU too, with no kernel.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.common import check_launch, load_kernel, sm_count, tuned_block

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
    + [ctypes.c_void_p]
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
    blocks: int  # the grid: B x ceil(D / channels)


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


def selective_scan_ref(u, dt, a, b, c, d):
    """Plain version, in fp32. u, dt: (B, L, D); a: (D, N); b, c: (B, L, N);
    d: (D,). Returns (y (B, L, D) in u's dtype, h_last (B, D, N) fp32)."""
    bsz, length, dim = u.shape
    u32, dt32, a32 = u.float(), dt.float(), a.float()
    da = torch.exp(dt32[..., None] * a32)  # (B, L, D, N)
    dbu = (dt32 * u32)[..., None] * b.float()[:, :, None, :]
    hs = torch.empty((length, bsz, dim, a.shape[1]), dtype=torch.float32, device=u.device)
    h = torch.zeros((bsz, dim, a.shape[1]), dtype=torch.float32, device=u.device)
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
    """(y, h_last) of the selective scan; shapes as ``selective_scan_ref``.

    On CUDA: u, b and c share a dtype (float32 or bfloat16); dt, a and d
    are float32 (the model's dt is fp32: a bf16 GEMM output plus the fp32
    bias). u, dt, b and c have a unit stride on their last axis and are
    read through their other strides, so b and c may be slices of one
    tensor; a and d are contiguous; 1 <= N <= ``MAX_STATE``. ``lanes``
    forces the lanes a channel takes (the rest of the plan follows), else
    the tuning cache's, else ``scan_plan``'s (``resolve_plan``)."""
    if u.device.type == "cpu":
        return selective_scan_ref(u, dt, a, b, c, d)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cpu or cuda, got {u.device}")
    if u.dim() != 3 or a.dim() != 2 or d.dim() != 1:
        raise ValueError(f"bad shapes u{tuple(u.shape)} a{tuple(a.shape)} d{tuple(d.shape)}")
    bsz, length, dim = u.shape
    n = a.shape[1]
    if (tuple(dt.shape) != (bsz, length, dim) or tuple(a.shape) != (dim, n)
            or tuple(b.shape) != (bsz, length, n) or tuple(c.shape) != (bsz, length, n)
            or tuple(d.shape) != (dim,)):
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
    if any(t.stride(-1) != 1 for t in (u, dt, b, c)) or not (a.is_contiguous() and d.is_contiguous()):
        raise ValueError("u, dt, b and c need a unit last stride; a and d must be contiguous")
    n = _check_states(n)
    plan = resolve_plan(bsz, length, dim, n, u.dtype, u.device, sm_count(u.device), lanes)
    y = torch.empty((bsz, length, dim), dtype=u.dtype, device=u.device)
    h_last = torch.empty((bsz, dim, n), dtype=torch.float32, device=u.device)
    if bsz and dim:
        fn = load_kernel("selective_scan", _ARGTYPES)
        err = fn(
            _DTYPES[u.dtype], u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), d.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            bsz, length, dim, n, plan.lanes, plan.states, u.stride(0), u.stride(1), dt.stride(0), dt.stride(1),
            b.stride(0), b.stride(1), c.stride(0), c.stride(1),
            torch.cuda.current_stream().cuda_stream,
        )
        check_launch("selective_scan", err)
        selective_scan.launches += 1
        selective_scan.last_plan = plan
    return y, h_last


selective_scan.launches = 0
selective_scan.last_plan = None
