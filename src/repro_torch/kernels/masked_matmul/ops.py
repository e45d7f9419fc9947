"""Fault-masked GEMM: the CUDA kernels' wrapper, its plain PyTorch version
and its launch counts.

Kernels: ``kernels/csrc/masked_matmul.cu``. They replace the TPU kernel
``repro/kernels/masked_matmul/masked_matmul.py::masked_matmul_pallas``.

The dtype and M pick the kernel; each is hand-written and each is bound
differently on an H100:

- ``decode`` (bf16 x, M <= 16): the weight bytes bound it. It streams w
  with 16-byte loads, applies the mask on chip and never writes a masked
  copy; K is split across blocks so a narrow GEMM still spreads its reads
  over the whole card;
- ``mma`` (bf16 x, M > 16): operations bound it; 128 x 128 tiles on the
  tensor cores;
- ``v1`` (float32 x and w): the float32 kernels, in fp32 on the SIMT cores,
  since tensor cores would round fp32 to tf32. At M <= 16 the ``decode``
  kernels' template streams the fp32 weights (bound by their bytes); above
  it a register-tiled kernel (bound by operations) multiplies 128 x 128
  tiles staged k-major in shared memory. ``variant="v1"`` also forces them
  for bf16 x and w, to time them beside the bf16 kernels; the serving paths
  never ask for it.

The bf16 kernels take w in bf16 or float32. A float32 w (the fp32 master,
as ``fault_linear`` passes it in ``kernel`` mode) is rounded to bf16 inside
the kernel, bit for bit as ``w.to(torch.bfloat16)`` would round it, so the
two launches give the same bits and no bf16 copy of w is ever written. w is
taken through its strides, so the tied unembedding's ``embed.T`` is read in
place. Every kernel reads the mask as bits, packed once per mask tensor
(``packed_mask``), and split launches share one zeroed counter buffer per
stream (``kernels.common.split_counters``).

A chip axis: with w of shape (chips, K, N), x (chips, ..., K) and ok
(chips, R, C), one launch computes every chip's product with its own weights
and mask: the counterpart of the TPU kernel under ``jax.vmap``, whose
batching rule adds the chip axis to the kernel's grid. Under
``torch.func.vmap`` (the fleet engines vmap a decode step over the chips)
the wrapper reaches that launch through the custom op
``repro_torch::masked_matmul`` and its vmap rule, since a batched tensor has
no data pointer to hand the kernel. Each chip packs its own mask bits, and a
change to one chip of a stacked mask repacks that chip alone.

``masked_matmul`` launches a kernel for a CUDA tensor and counts the launch
in ``masked_matmul.launches`` and ``masked_matmul.launches_by_variant`` (a
chip-batched launch also in ``masked_matmul.fleet_launches_by_variant``);
for a CPU tensor it runs ``masked_matmul_ref``, the plain version. There is
no fallback between the two.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core.mapping import periodic_mask
from repro_torch.kernels.common import check_launch, load_kernel, sm_count, split_counters

__all__ = [
    "masked_matmul",
    "masked_matmul_checksummed",
    "masked_matmul_ref",
    "packed_mask",
    "pick_variant",
    "VARIANTS",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4
    + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
)
# the C entry point's variant codes
VARIANTS = {"v1": 1, "decode": 2, "mma": 3}
_SMALL_M = 16
_PLAN_ARGTYPES = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
# v1's split rules, as csrc/masked_matmul.cu's plan() states them for the
# bf16 kernels: at M <= 16 the decode kernels' (K in 64-row granules, at most
# 32 slices), above it the tiled kernel's (each slice at least 8 k tiles)
_DEC_KQ, _DEC_MAX_SPLITS, _TL_MIN_TILES = 64, 32, 8
_SLICE_COST = 0.01  # a K slice's own cost in the tiled plan, in tile-waves


def _v1_tiles(m: int, n: int, k_contiguous: bool = False) -> tuple[int, int, int]:
    """v1's (BM, BN, BK) as csrc/masked_matmul.cu picks them: at M <= 16 the
    decode kernels' (one block of columns covers every row; 256 columns of
    row-major w, 32 of embed.T; K granule 64); above it the tiled kernel's
    (``tiled_shape``: 64 rows where M <= 64, else 128; 96 columns where N is
    a multiple of 96 and not of 128, else 64 where 128-wide tiles would
    leave a quarter or more of their columns empty, else 128)."""
    if m <= _SMALL_M:
        return m, 32 if k_contiguous else 256, _DEC_KQ
    n128 = -(-n // 128) * 128
    bn = 96 if n % 96 == 0 and n % 128 else 64 if 4 * (n128 - n) >= n128 else 128
    return 64 if m <= 64 else 128, bn, 8


def _split_count(tiles_k: int, want: int) -> int:
    """At most ``want`` slices of ``tiles_k`` k tiles, none of them empty."""
    want = min(want, tiles_k)
    if want <= 1:
        return 1
    return -(-tiles_k // -(-tiles_k // want))


class V1Plan(NamedTuple):
    splits: int  # K slices of a split tile
    scratch_bytes: int  # the fp32 partials of every split tile of every chip
    tiles: int  # output tiles of all chips: the split-K counters a launch needs
    split_tiles: int  # each chip's tiles cut into K slices (its last, in raster order)


def _waves(pieces: int, slots: int, splits: int) -> float:
    """Waves of two blocks per SM that ``pieces`` slices of 1 / ``splits`` of
    a tile take, counted in whole tiles: a wave that is partly filled takes
    as long as a full one (an SM that holds two blocks sets its length)."""
    return -(-pieces // slots) / splits


@functools.lru_cache(maxsize=None)
def _split_plan(
    m: int, n: int, k: int, sms: int, chips: int = 1, k_contiguous: bool = False
) -> V1Plan:
    """v1's launch plan for ``chips`` stacks in one launch, aimed at waves of
    two blocks per SM (2 x ``sms`` slots). At M <= 16 (the decode kernels)
    every tile is cut into K slices until the slices fill one wave (at most
    32 slices of 64-row granules). Above it (the tiled kernel) the tiles of
    a last, partly filled wave (each chip's last ones in raster order; all of
    them below one wave) are cut into the number of slices, at least 8 k
    tiles each, that ends the launch soonest (``_waves``, with
    ``_SLICE_COST`` for each slice), and the rest run whole. The scratch holds every split tile's fp32 partials (all of M
    x N per slice at M <= 16, a BM x BN tile per slice above); the counters,
    one per output tile of every chip, are the shared buffer's
    (``split_counters``). The C side checks both."""
    bm, bn, bk = _v1_tiles(m, n, k_contiguous)
    per_chip = math.ceil(m / bm) * math.ceil(n / bn)
    tiles, slots = chips * per_chip, 2 * sms
    tiles_k = max(1, math.ceil(k / bk))
    if m <= _SMALL_M:
        splits = _split_count(tiles_k, min(_DEC_MAX_SPLITS, max(1, slots // tiles)))
        return V1Plan(splits, 0 if splits == 1 else 4 * chips * splits * m * n, tiles, per_chip)
    split_tiles = -(-(tiles % slots) // chips)
    splits = 1
    if split_tiles:  # each slice also costs its own prologue and a partial tile's round trip
        cut = chips * split_tiles
        best = _waves(cut, slots, 1) + _SLICE_COST
        for want in range(2, tiles_k // _TL_MIN_TILES + 1):
            s = _split_count(tiles_k, want)
            if _waves(cut * s, slots, s) + _SLICE_COST * s < best:
                splits, best = s, _waves(cut * s, slots, s) + _SLICE_COST * s
    if splits == 1:
        return V1Plan(1, 0, tiles, 0)
    return V1Plan(splits, 4 * chips * split_tiles * splits * bm * bn, tiles, split_tiles)


@functools.lru_cache(maxsize=None)
def _plan(
    kind: str, m: int, n: int, k: int, k_contiguous: bool, sms: int, chips: int = 1
) -> tuple[int, int, int]:
    """A bf16 kernel's (K slices, scratch bytes, output tiles of all chips),
    from ``masked_matmul_plan`` in csrc/masked_matmul.cu, which holds the
    kernels' tiles and split rules; cached per shape, so a decode step asks
    once."""
    out = (ctypes.c_longlong * 3)()
    fn = load_kernel("masked_matmul_plan", _PLAN_ARGTYPES, source="masked_matmul")
    check_launch(
        "masked_matmul_plan", fn(VARIANTS[kind], chips, m, n, k, int(k_contiguous), sms, out)
    )
    return out[0], out[1], out[2]


def pick_variant(x_dtype: torch.dtype, m: int, variant: str = "auto") -> str:
    """The kernel a launch runs: ``v1`` for float32, ``decode`` for bf16 at
    M <= 16, ``mma`` for bf16 above; ``variant="v1"`` forces v1."""
    if variant not in ("auto", "v1"):
        raise ValueError(f"variant is 'auto' or 'v1', got {variant!r}")
    if variant == "v1" or x_dtype == torch.float32:
        return "v1"
    return "decode" if m <= _SMALL_M else "mma"


def _pack_bits(ok: torch.Tensor) -> torch.Tensor:
    """(..., R, C) 0/1 mask -> (..., R, ceil(C / 8)) uint8, entry c in bit
    c % 8 of byte c // 8."""
    *lead, r, c = ok.shape
    cb = -(-c // 8)
    b = torch.zeros(*lead, r, cb * 8, dtype=torch.uint8, device=ok.device)
    b[..., :c] = ok != 0
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8, device=ok.device)
    return (b.view(*lead, r, cb, 8) * weights).sum(-1, dtype=torch.uint8).contiguous()


def _pack_pair(ok: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if not bool(((ok == 0) | (ok == 1)).all()):
        raise ValueError("the masked-GEMM kernels take a 0/1 mask")
    packed_mask.chips_packed += 1 if ok.dim() == 2 else ok.shape[0]
    return _pack_bits(ok), _pack_bits(ok.transpose(-1, -2))


_PACKED = WeakIdKeyDictionary()


def packed_mask(ok: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The mask as the kernels read it: bits along C, and bits of
    ``ok.T`` along R (for k-contiguous w); for a chip stack (chips, R, C),
    each chip's. Packed once per mask tensor and kept while it lives. An
    in-place change of ``ok`` packs it again: a single mask whole, a stack
    only in the chips whose mask changed (``set_silicon`` on one chip of a
    fleet). The mask must hold only 0 and 1: the bits cannot carry other
    factors. ``packed_mask.chips_packed`` counts the chips packed."""
    hit = _PACKED.get(ok)
    if hit is not None and hit[0] == ok._version:
        return hit[1], hit[2]
    if hit is not None and ok.dim() == 3:
        _, bits, bits_t, seen = hit
        changed = (seen != ok).flatten(1).any(1).nonzero()[:, 0]
        bits, bits_t, seen = bits.clone(), bits_t.clone(), seen.clone()
        if changed.numel():
            bits[changed], bits_t[changed] = _pack_pair(ok[changed])
            seen[changed] = ok[changed]
    else:
        bits, bits_t = _pack_pair(ok)
        seen = ok.clone() if ok.dim() == 3 else None
    _PACKED[ok] = (ok._version, bits, bits_t, seen)
    return bits, bits_t


packed_mask.chips_packed = 0


def _check_dtypes(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype == w.dtype or (x.dtype == torch.bfloat16 and w.dtype == torch.float32):
        return
    raise TypeError(
        f"masked_matmul takes w in x's dtype, or a float32 w with a bfloat16 x; got x {x.dtype}, w {w.dtype}"
    )


def masked_matmul_ref(x: torch.Tensor, w: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Plain version: y = x @ (w.to(x.dtype) * periodic_mask(ok)) with fp32
    accumulation. x: (..., K); w: (K, N) in x's dtype, or float32 with a
    bfloat16 x; ok: (R, C) 1/0 healthy mask. With a chip axis, w is
    (chips, K, N), ok (chips, R, C) and x (chips, ..., K): chip c's rows
    meet chip c's weights under chip c's mask."""
    _check_dtypes(x, w)
    mask = periodic_mask(w.shape, ok, dtype=torch.float32)
    wm = (w.to(x.dtype).float() * mask).to(x.dtype)
    if w.dim() == 3:
        x3 = x.reshape(w.shape[0], -1, w.shape[1])
        y = torch.bmm(x3.float(), wm.float()).to(x.dtype)
        return y.reshape(*x.shape[:-1], w.shape[2])
    return torch.matmul(x.float(), wm.float()).to(x.dtype)


def _under_vmap(*ts: torch.Tensor) -> bool:
    """True where one of the tensors is a ``torch.func.vmap`` batched
    tensor (it has no data pointer, and the custom op's vmap rule takes
    it) and none is differentiated by ``torch.func.grad``: the kernel is
    forward only, so a vmapped gradient (the population FAT engines) runs
    the plain version, which exists on the CPU alone."""
    ft = torch._C._functorch
    return any(ft.is_batchedtensor(t) for t in ts) and not any(ft.is_gradtrackingtensor(t) for t in ts)


def masked_matmul(
    x: torch.Tensor, w: torch.Tensor, ok: torch.Tensor, *, variant: str = "auto"
) -> torch.Tensor:
    """y = x @ (w.to(x.dtype) * periodic_mask(ok)); x: (..., K), w: (K, N),
    ok: (R, C); or, for a fleet of chips in one launch, x: (chips, ..., K),
    w: (chips, K, N), ok: (chips, R, C).

    On CUDA: x is float32 or bfloat16; w is in x's dtype, or float32 with a
    bfloat16 x; w has a unit stride along one of its last two axes (any
    stride along the chips, 0 included); ok is a contiguous float32 tensor
    of 0s and 1s. ``variant="v1"`` forces the float32 kernels (x and w of
    one dtype), for timing them beside the others. Under ``torch.func.vmap`` the call
    goes through the custom op, whose vmap rule makes one chip-batched
    launch."""
    if _under_vmap(x, w, ok):
        return torch.ops.repro_torch.masked_matmul(x, w, ok, variant)
    if x.device.type == "cpu":
        return masked_matmul_ref(x, w, ok)
    if x.device.type != "cuda":
        raise ValueError(f"masked_matmul runs on cpu or cuda, got {x.device}")
    fleet = w.dim() == 3
    if (
        w.dim() not in (2, 3) or ok.dim() != w.dim() or x.shape[-1] != w.shape[-2]
        or (fleet and (x.dim() < 2 or x.shape[0] != w.shape[0] or ok.shape[0] != w.shape[0]))
    ):
        raise ValueError(f"bad shapes x{tuple(x.shape)} w{tuple(w.shape)} ok{tuple(ok.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"masked_matmul takes float32 or bfloat16 x, got {x.dtype}")
    _check_dtypes(x, w)
    if ok.dtype != torch.float32 or not ok.is_contiguous():
        raise TypeError("ok must be a contiguous float32 (R, C) or (chips, R, C) mask")
    if w.device != x.device or ok.device != x.device or x.device.index != torch.cuda.current_device():
        raise ValueError("x, w and ok must lie on the current CUDA device")
    if w.stride(-1) != 1 and w.stride(-2) != 1:
        raise ValueError(f"w needs a unit stride along one GEMM axis, got strides {w.stride()}")
    chips = w.shape[0] if fleet else 1
    kdim, n = w.shape[-2:]
    lead = x.shape[:-1]
    x3 = x.reshape(chips, -1, kdim).contiguous()
    m = x3.shape[1]
    kind = pick_variant(x.dtype, m, variant)
    if kind == "v1" and w.dtype != x.dtype:
        raise TypeError("the v1 kernel takes x and w of one dtype")
    y = torch.empty((chips, m, n), dtype=x.dtype, device=x.device)
    if chips and m and n:
        sms = sm_count(x.device)
        stream = torch.cuda.current_stream().cuda_stream
        bits, bits_t = packed_mask(ok)
        k_contiguous = w.stride(-1) != 1
        if kind == "v1":
            splits, scratch_bytes, tiles, split_tiles = _split_plan(m, n, kdim, sms, chips, k_contiguous)
        else:
            splits, scratch_bytes, tiles = _plan(kind, m, n, kdim, k_contiguous, sms, chips)
            split_tiles = 0
        counters = split_counters(x.device, stream, tiles)
        # partials only where K is split; the caching allocator hands the bytes back
        scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=x.device) if scratch_bytes else None
        fn = load_kernel("masked_matmul", _ARGTYPES)
        err = fn(
            VARIANTS[kind], _DTYPES[x.dtype], _DTYPES[w.dtype], chips, x3.data_ptr(), w.data_ptr(),
            bits.data_ptr(), bits_t.data_ptr(), y.data_ptr(),
            m, n, kdim, w.stride(-2), w.stride(-1), w.stride(0) if fleet else 0,
            ok.shape[-2], ok.shape[-1], splits, split_tiles,
            scratch.data_ptr() if scratch is not None else None,
            scratch_bytes, counters.data_ptr(), counters.numel(), stream,
        )
        check_launch("masked_matmul", err)
        masked_matmul.launches += 1
        masked_matmul.launches_by_variant[kind] += 1
        if fleet:
            masked_matmul.fleet_launches_by_variant[kind] += 1
    return y.reshape(*lead, n)


masked_matmul.launches = 0
masked_matmul.launches_by_variant = dict.fromkeys(VARIANTS, 0)
masked_matmul.fleet_launches_by_variant = dict.fromkeys(VARIANTS, 0)


@torch.library.custom_op("repro_torch::masked_matmul", mutates_args=())
def _masked_matmul_op(x: torch.Tensor, w: torch.Tensor, ok: torch.Tensor, variant: str) -> torch.Tensor:
    return masked_matmul(x, w, ok, variant=variant)


@_masked_matmul_op.register_fake
def _(x, w, ok, variant):
    return x.new_empty((*x.shape[:-1], w.shape[-1]))


def _masked_matmul_vmap(info, in_dims, x, w, ok, variant):
    """The chip-batched launch under ``torch.func.vmap``: the vmapped axis
    becomes the kernel's chip axis. A weight and mask shared by every
    member (no vmapped axis on either) fold the members into M instead."""
    xd, wd, okd, _ = in_dims
    if xd is not None and xd != 0:
        x = x.movedim(xd, 0)
    if wd is None and okd is None:
        return masked_matmul(x, w, ok, variant=variant), 0
    n = info.batch_size
    x = x if xd is not None else x.expand(n, *x.shape)
    # a weight shared by every chip is read with chip stride 0, never copied
    w = w if wd == 0 else w.movedim(wd, 0) if wd is not None else w.expand(n, *w.shape)
    ok = ok if okd == 0 else ok.movedim(okd, 0) if okd is not None else ok.expand(n, *ok.shape)
    return masked_matmul(x, w, ok.contiguous(), variant=variant), 0


torch.library.register_vmap("repro_torch::masked_matmul", _masked_matmul_vmap)


def masked_matmul_checksummed(
    x: torch.Tensor, w: torch.Tensor, ok: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """ABFT-augmented masked GEMM (Zhang et al., arxiv 1802.04657): append
    the column-checksum row ``1^T x`` to the input and push the augmented
    batch through the SAME :func:`masked_matmul` (one kernel launch on the
    card, the plain version on the host), so the checksum row meets the same
    silicon (mask) as the payload rows. Returns ``(y, check_row)``, where on
    consistent hardware ``check_row[b] == sum_m y[m, b]`` up to float
    reassociation; a permanent fault in PE column ``b % C`` perturbs both
    through the identical mask, which is what lets ``obs/abft.py`` fold the
    check-row syndrome back onto PE columns."""
    lead = x.shape[:-1]
    kdim = x.shape[-1]
    x2 = x.reshape(-1, kdim)
    xa = torch.cat([x2, x2.sum(dim=0, keepdim=True).to(x2.dtype)], dim=0)
    ya = masked_matmul(xa, w, ok)
    return ya[:-1].reshape(*lead, w.shape[1]), ya[-1]
