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
- ``mma`` (bf16 x, M > 16): the tensor cores through ``wgmma``, the masked
  weight as the register operand and x from shared memory, both fed by a
  TMA ring; a persistent block an SM walks tiles of 128 or 256 tokens
  (``_mma_tokens``) by 128 weight columns. Its tiles' traffic into shared
  memory, more than its tensor work, sets its time;
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

An expert axis: with w of shape (E, K, N), x (E, ..., K) and ONE mask ok
(R, C), one launch computes every expert's product under that mask (an MoE
layer's expert GEMMs all run on the same chip: ``core/masking.py::
fault_einsum``). The axis is the chip axis with a mask batch stride of 0,
so the mask is packed once, as a single chip's (``packed_mask.chips_packed``
grows by 1, not E), and no (E, R, C) copy of it is ever made.

Both axes: with w of shape (chips, E, K, N), x (chips, E, ..., K) and ok
(chips, R, C), one launch computes every chip's experts, each chip's E
experts under that chip's mask (an MoE layer's expert GEMMs under a fleet's
chip map). The grid's batch axis is every (chip, expert), w read as chips x
E stacks one expert stride apart (a view of the stacked fp32 master, never
a copy), and batch entry i reads mask i / E: the C entry point's mask group.
Each chip's mask is packed once, not E times, and never repeated on the
host.

The K split: ``gemm_plan`` is every launch's plan (tiles, K slices, the
scratch and the grid), the one rule the wrapper launches and
``analysis/kernelgeom.py::masked_matmul_launch`` lints. Its heuristic is
``_plan`` for the bf16 kernels (the rule of ``masked_matmul_plan`` in the C
source, which a card test holds it to) and ``_split_plan`` for v1. A
caller's ``splits``, or the tuning cache's (``kernels.common.tuned_block``,
kernel ``masked_matmul``, the reference's shape key ``(m, k, n, r, c)``),
replaces the plan's count, within ``max_splits``, the plan's own cap, so
the scratch stays within what a plan could have chosen. The key has no
field for a chip axis or for w's strides, so the cache is read only for a
single chip's launch with row-major w: chip-batched, expert-batched and
chips x experts launches and k-contiguous w (the tied unembedding's
``embed.T``) keep the plan, as does ``variant="v1"`` on bf16. ``masked_matmul.last_splits`` is
the count the last launch ran.

The mma kernel loads each operand by TMA where TMA takes it (a 16-byte
aligned base and row strides of a multiple of 16 bytes: ``_mma_loads``);
otherwise its producer warpgroup copies that operand itself, in the same
kernel and into the same layout (hymba-1.5b's ``dt_proj`` at K = 100, a
bf16 w whose rows are not a multiple of 16 bytes, a view that starts off
alignment). ``masked_matmul.last_loads`` is the last mma launch's route
(``("tma" | "copy", "tma" | "copy")`` for x and w, None after another
kernel) and ``masked_matmul.copy_launches`` counts the mma launches that
copied an operand.

``masked_matmul`` launches a kernel for a CUDA tensor and counts the launch
in ``masked_matmul.launches`` and ``masked_matmul.launches_by_variant`` (a
chip-batched launch also in ``masked_matmul.fleet_launches_by_variant``, an
expert-batched one in ``masked_matmul.expert_launches_by_variant``, a chips
x experts one in ``masked_matmul.fleet_expert_launches_by_variant``);
for a CPU tensor it runs ``masked_matmul_ref``, the plain version. There is
no fallback between the two.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
from torch.utils.flop_counter import register_flop_formula
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core.mapping import periodic_mask
from repro_torch.kernels.common import (
    check_launch, load_kernel, sm_count, split_counters, tuned_block, under_vmap,
)

__all__ = [
    "masked_matmul",
    "masked_matmul_checksummed",
    "masked_matmul_ref",
    "packed_mask",
    "pick_variant",
    "gemm_plan",
    "max_splits",
    "resolve_plan",
    "GemmPlan",
    "VARIANTS",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 8
    + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
)
# the C entry point's variant codes
VARIANTS = {"v1": 1, "decode": 2, "mma": 3}
_SMALL_M = 16
_PLAN_ARGTYPES = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
# csrc/masked_matmul.cu's tiles and split rules: the decode kernels' columns a block (row-major
# w, embed.T), K granule and most slices; the mma kernel's weight columns a block, k depth of a
# stage, fewest k tiles a slice and the share of the SMs an entry's tiles fill at most where K is
# cut; the tiled v1 kernel's fewest k tiles a slice
_DEC_BN_ROWS, _DEC_BN_COLS, _DEC_KQ, _DEC_MAX_SPLITS = 256, 32, 64, 32
_MMA_BN, _MMA_BK, _MMA_MIN_TILES, _MMA_SPLIT_SHARE = 128, 64, 2, 8
_TL_MIN_TILES = 8
# the mma kernel's ring (MmaShape): stages of an x tile (tokens x 64 bf16) and the raw w tile
# (64 x 128 of w's dtype), as many as fit 200 KB, at most 6, plus 1 KB that aligns the ring
_MMA_RING_BYTES, _MMA_MAX_STAGES = 200 * 1024, 6


def _mma_smem(tokens: int, w_size: int = 4) -> int:
    """The mma kernel's dynamic shared memory for a token tile and w's
    element size (``MmaShape<WT, TOK>::SMEM``); the decode and tiled
    kernels use static shared memory only."""
    stage = tokens * _MMA_BK * 2 + _MMA_BK * _MMA_BN * w_size
    return min(_MMA_MAX_STAGES, _MMA_RING_BYTES // stage) * stage + 1024


def _mma_tokens(m: int, n: int, sms: int, chips: int = 1) -> int:
    """The mma kernel's token tile (``mma_tokens`` in the C source): 128 rows
    at M <= 128, 256 above, the tile that moves the fewest bytes into shared
    memory a product; but 128 where the chips' 256-row tiles would leave
    more than half the SMs idle."""
    if m <= 256:
        return 128 if m <= 128 else 256
    return 128 if 2 * chips * -(-m // 256) * -(-n // _MMA_BN) < sms else 256


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


def _plan(
    kind: str, m: int, n: int, k: int, k_contiguous: bool, sms: int, chips: int = 1
) -> tuple[int, int, int, int]:
    """A bf16 kernel's (K slices, scratch bytes, output tiles of all chips,
    a tile's rows): the rule of ``plan`` in csrc/masked_matmul.cu
    (``_c_plan`` asks the C source, and a card test holds the two equal).
    decode keeps its grid of chips x tiles x slices within one wave of two
    blocks per SM and cuts K into whole 64-row granules, at most 32 slices
    (a tile's rows: M). mma runs one persistent block an SM over tiles of
    ``_mma_tokens`` tokens x 128 weight columns and cuts K only where one
    entry's tiles alone fill at most an eighth of the SMs (a cut's partials
    cost more than idle SMs above that), each slice at least 2 k tiles of
    64: every chip count cuts K alike, so a chip's (or an expert's) rows of
    a batched launch have the bits of its own launch."""
    if kind not in ("decode", "mma") or min(chips, m, n, k, sms) < 1 or (kind == "decode" and m > _SMALL_M):
        raise ValueError(f"no bf16 masked-GEMM plan for {kind} at chips {chips}, M {m}, N {n}, K {k}")
    if kind == "decode":
        tokens = m
        tiles_out = -(-n // (_DEC_BN_COLS if k_contiguous else _DEC_BN_ROWS))
        want = min(_DEC_MAX_SPLITS, max(1, 2 * sms // (chips * tiles_out)))
        splits = _split_count(max(1, -(-k // _DEC_KQ)), want)
    else:
        tokens = _mma_tokens(m, n, sms, chips)
        tiles_out = -(-m // tokens) * -(-n // _MMA_BN)
        tiles_k = max(1, -(-k // _MMA_BK))
        tiles1 = -(-m // _mma_tokens(m, n, sms)) * -(-n // _MMA_BN)  # one entry's tiles alone
        splits = 1 if _MMA_SPLIT_SHARE * tiles1 > sms else _split_count(
            tiles_k, min(tiles_k // _MMA_MIN_TILES, sms // tiles1))
    return splits, 0 if splits == 1 else 4 * chips * splits * m * n, chips * tiles_out, tokens


def _c_plan(
    kind: str, m: int, n: int, k: int, k_contiguous: bool, sms: int, chips: int = 1
) -> tuple[int, int, int, int]:
    """``_plan`` as ``masked_matmul_plan`` in csrc/masked_matmul.cu computes
    it (on the card only; a card test holds the two equal)."""
    out = (ctypes.c_longlong * 4)()
    fn = load_kernel("masked_matmul_plan", _PLAN_ARGTYPES, source="masked_matmul")
    check_launch(
        "masked_matmul_plan", fn(VARIANTS[kind], chips, m, n, k, int(k_contiguous), sms, out)
    )
    return out[0], out[1], out[2], out[3]


def _tiles_k(kind: str, k: int) -> int:
    """k tiles (granules) a launch of ``kind`` cuts K into."""
    bk = _MMA_BK if kind == "mma" else _DEC_KQ if kind == "decode" else 8
    return max(1, -(-k // bk))


def max_splits(kind: str, m: int, k: int) -> int:
    """The most K slices a launch of ``kind`` may take: the plan's own cap.
    The decode kernels (bf16 ``decode`` and v1 at M <= 16): 32 slices of
    64-row granules; ``mma``: 2 k tiles of 64 a slice; the tiled v1 kernel:
    8 k tiles a slice."""
    if kind == "decode" or (kind == "v1" and m <= _SMALL_M):
        return min(_DEC_MAX_SPLITS, _tiles_k("decode", k))
    if kind == "mma":
        return max(1, _tiles_k("mma", k) // _MMA_MIN_TILES)
    return max(1, _tiles_k("v1", k) // _TL_MIN_TILES)


class GemmPlan(NamedTuple):
    kind: str  # the kernel: decode, mma or v1
    tile: tuple  # (BM, BN, BK) of one output tile and k step (mma: tokens, weight columns, k)
    splits: int  # K slices of a split tile
    split_tiles: int  # v1: each chip's tiles cut into K slices (above M = 16 a partial last wave's); bf16: 0
    scratch_bytes: int  # the fp32 partials of the split tiles
    tiles: int  # output tiles of all chips: the split-K counters a launch needs
    grid: tuple  # the CUDA grid (mma: persistent, at most one block an SM over every chip's tiles and slices)
    max_splits: int  # the cap a forced count must keep


@functools.lru_cache(maxsize=None)
def gemm_plan(
    kind: str, m: int, n: int, k: int, sms: int, chips: int = 1, k_contiguous: bool = False,
    splits: Optional[int] = None,
) -> GemmPlan:
    """The launch of one masked-GEMM call: the plan's, or, with ``splits``,
    that many K slices in place of the plan's count (empty slices dropped,
    as the plan drops them; the tiled v1 kernel cuts only the tiles of a
    partly filled last wave, so where there is none it runs whole). Raises
    ``ValueError`` for a count outside ``[1, max_splits]``."""
    cap = max_splits(kind, m, k)
    if splits is not None and not 1 <= splits <= cap:
        raise ValueError(f"{kind} at M {m}, K {k} takes 1 to {cap} K slices, got {splits}")
    tiles_k = _tiles_k(kind, k)
    if kind == "v1":
        bm, bn, bk = tile = _v1_tiles(m, n, k_contiguous)
        heur = _split_plan(m, n, k, sms, chips, k_contiguous)
        tiles = heur.tiles
        if splits is None:
            s, split_tiles = heur.splits, heur.split_tiles
        else:
            s = _split_count(tiles_k, splits)
            split_tiles = tiles // chips if m <= _SMALL_M else -(-(tiles % (2 * sms)) // chips)
            if split_tiles == 0:
                s = 1
            if s == 1 and m > _SMALL_M:
                split_tiles = 0
        per_chip = tiles // chips
        if m <= _SMALL_M:
            scratch = 0 if s == 1 else 4 * chips * s * m * n
            grid = (per_chip, chips, s)
        else:
            scratch = 0 if s == 1 else 4 * chips * split_tiles * s * bm * bn
            grid = (per_chip + split_tiles * (s - 1), chips)
        return GemmPlan(kind, tile, s, split_tiles, scratch, tiles, grid, cap)
    s, scratch, tiles, rows = _plan(kind, m, n, k, k_contiguous, sms, chips)
    if splits is not None:
        s = _split_count(tiles_k, splits)
        scratch = 0 if s == 1 else 4 * chips * s * m * n
    if kind == "decode":
        tile = (m, _DEC_BN_COLS if k_contiguous else _DEC_BN_ROWS, _DEC_KQ)
        return GemmPlan(kind, tile, s, 0, scratch, tiles, (tiles // chips, chips, s), cap)
    return GemmPlan(kind, (rows, _MMA_BN, _MMA_BK), s, 0, scratch, tiles, (min(tiles * s, sms), 1), cap)


def resolve_plan(
    x_dtype: torch.dtype, m: int, k: int, n: int, mask_shape: tuple, device, sms: int, *,
    splits: Optional[int] = None, chips: int = 1, k_contiguous: bool = False, variant: str = "auto",
) -> GemmPlan:
    """The launch the wrapper makes for this call: an explicit ``splits``,
    else the tuning cache's (a single chip's launch with row-major w and the
    variant the dtype picks; see the module docstring), else the plan's."""
    kind = pick_variant(x_dtype, m, variant)
    if chips == 1 and not k_contiguous and variant == "auto":
        r, c = mask_shape
        splits = tuned_block("masked_matmul", dict(m=m, k=k, n=n, r=r, c=c), x_dtype, device=device,
                             defaults=_PLAN_DEFAULT, overrides=dict(splits=splits))["splits"]
    return gemm_plan(kind, m, n, k, sms, chips, k_contiguous, splits)


_PLAN_DEFAULT = dict(splits=None)  # the seam's heuristic: the plan's count


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


def _tma_stride(nbytes: int) -> bool:
    return 0 < nbytes < 1 << 40 and nbytes % 16 == 0


def _mma_loads(x_ptr: int, k: int, w: torch.Tensor, w_stride: int) -> tuple[str, str]:
    """How the mma kernel loads x (chips, M, K contiguous at ``x_ptr``) and
    w (entry stride ``w_stride``, 0 for one w): ``"tma"`` where TMA takes
    the operand (a 16-byte aligned base, row strides of a multiple of 16
    bytes, a stacked w's entries at least an entry's extent apart), else
    ``"copy"``, the kernel's producer warp copying it itself. ``launch_mma``
    in the C source checks the same rule."""
    size = w.element_size()
    kcontig = w.stride(-1) != 1
    stride = w.stride(-1) if kcontig else w.stride(-2)
    extent = (w.shape[-1] if kcontig else w.shape[-2]) * stride * size
    entry = w_stride * size
    x_tma = x_ptr % 16 == 0 and _tma_stride(2 * k)
    w_tma = (w.data_ptr() % 16 == 0 and _tma_stride(stride * size)
             and (entry == 0 or (_tma_stride(entry) and entry >= extent)))
    return "tma" if x_tma else "copy", "tma" if w_tma else "copy"


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
    meet chip c's weights under chip c's mask. With an expert axis, w is
    (E, K, N), ok one (R, C) mask and x (E, ..., K): every expert's weights
    under the same mask. With both, w is (chips, E, K, N), x (chips, E, ...,
    K) and ok (chips, R, C): chip c's experts under chip c's mask."""
    _check_dtypes(x, w)
    if w.dim() == 4 and ok.dim() == 3:
        ok = ok[:, None]  # one mask for each chip's experts
    mask = periodic_mask(w.shape, ok, dtype=torch.float32)
    wm = (w.to(x.dtype).float() * mask).to(x.dtype)
    if w.dim() >= 3:
        wm = wm.reshape(-1, *w.shape[-2:])
        x3 = x.reshape(wm.shape[0], -1, w.shape[-2])
        y = torch.bmm(x3.float(), wm.float()).to(x.dtype)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), wm.float()).to(x.dtype)


def masked_matmul(
    x: torch.Tensor, w: torch.Tensor, ok: torch.Tensor, *, variant: str = "auto",
    splits: Optional[int] = None,
) -> torch.Tensor:
    """y = x @ (w.to(x.dtype) * periodic_mask(ok)); x: (..., K), w: (K, N),
    ok: (R, C); or, for a fleet of chips in one launch, x: (chips, ..., K),
    w: (chips, K, N), ok: (chips, R, C); or, for an MoE layer's experts in
    one launch, x: (E, ..., K), w: (E, K, N) and one mask ok: (R, C); or,
    for a fleet's experts in one launch, x: (chips, E, ..., K), w: (chips,
    E, K, N) with its chips one expert stride apart, ok: (chips, R, C).

    On CUDA: x is float32 or bfloat16; w is in x's dtype, or float32 with a
    bfloat16 x; w has a unit stride along one of its last two axes (any
    stride along the chips, 0 included); ok is a contiguous float32 tensor
    of 0s and 1s. ``variant="v1"`` forces the float32 kernels (x and w of
    one dtype), for timing them beside the others. ``splits`` forces the K
    slices (``resolve_plan``: else the tuning cache's, else the plan's).
    Under ``torch.func.vmap`` the call goes through the custom op, whose
    vmap rule makes one chip-batched launch with the plan's slices."""
    if under_vmap(x, w, ok):
        return torch.ops.repro_torch.masked_matmul(x, w, ok, variant)
    if x.device.type == "cpu":
        return masked_matmul_ref(x, w, ok)
    if x.device.type != "cuda":
        raise ValueError(f"masked_matmul runs on cpu or cuda, got {x.device}")
    batched = w.dim() >= 3
    lead_w = w.shape[:-2]  # (), (chips,), (E,) or (chips, E)
    experts = w.dim() == 3 and ok.dim() == 2  # one mask shared by the batch axis
    if (
        w.dim() not in (2, 3, 4) or ok.dim() not in (2, 3) or (w.dim() == 2 and ok.dim() != 2)
        or (w.dim() == 4 and ok.dim() != 3)
        or x.shape[-1] != w.shape[-2] or tuple(x.shape[: len(lead_w)]) != tuple(lead_w)
        or (w.dim() == 4 and x.dim() < 4) or (w.dim() == 3 and x.dim() < 2)
        or (ok.dim() == 3 and ok.shape[0] != w.shape[0])
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
    # the mask group: 0 for one mask shared by every batch entry, else each
    # run of `group` entries reads its own mask; chips x experts: the grid's
    # batch axis is every (chip, expert), chip c's E experts one group under
    # chip c's mask, w one expert stride apart
    group = (w.shape[1] if w.dim() == 4 else 1) if ok.dim() == 3 else 0
    if w.dim() == 4 and w.shape[0] > 1 and w.stride(0) != group * w.stride(1):
        raise ValueError(f"w (chips, E, K, N) needs its chips one expert stride apart, got strides {w.stride()}")
    kdim, n = w.shape[-2:]
    chips = math.prod(lead_w)
    w_stride = w.stride(-3) if batched else 0
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
        plan = resolve_plan(x.dtype, m, kdim, n, ok.shape[-2:], x.device, sms, splits=splits, chips=chips,
                            k_contiguous=w.stride(-1) != 1, variant=variant)
        scratch_bytes, tiles = plan.scratch_bytes, plan.tiles
        counters = split_counters(x.device, stream, tiles)
        # partials only where K is split; the caching allocator hands the bytes back
        scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=x.device) if scratch_bytes else None
        loads = _mma_loads(x3.data_ptr(), kdim, w, w_stride) if kind == "mma" else None
        fn = load_kernel("masked_matmul", _ARGTYPES)
        err = fn(
            VARIANTS[kind], _DTYPES[x.dtype], _DTYPES[w.dtype], chips, x3.data_ptr(), w.data_ptr(),
            bits.data_ptr(), bits_t.data_ptr(), y.data_ptr(),
            m, n, kdim, w.stride(-2), w.stride(-1), w_stride,
            ok.shape[-2], ok.shape[-1], group, plan.splits, plan.split_tiles,
            plan.tile[0] if kind == "mma" else 0, plan.grid[0] if kind == "mma" else 0,
            0 if loads is None else (loads[0] == "copy") | (loads[1] == "copy") << 1,
            scratch.data_ptr() if scratch is not None else None,
            scratch_bytes, counters.data_ptr(), counters.numel(), stream,
        )
        check_launch("masked_matmul", err)
        masked_matmul.launches += 1
        masked_matmul.launches_by_variant[kind] += 1
        masked_matmul.last_splits = plan.splits
        masked_matmul.last_loads = loads
        if loads is not None and "copy" in loads:
            masked_matmul.copy_launches += 1
        if w.dim() == 4:
            masked_matmul.fleet_expert_launches_by_variant[kind] += 1
        elif experts:
            masked_matmul.expert_launches_by_variant[kind] += 1
        elif batched:
            masked_matmul.fleet_launches_by_variant[kind] += 1
    return y.reshape(*lead, n)


masked_matmul.launches = 0
masked_matmul.last_splits = None
masked_matmul.last_loads = None
masked_matmul.copy_launches = 0
masked_matmul.launches_by_variant = dict.fromkeys(VARIANTS, 0)
masked_matmul.fleet_launches_by_variant = dict.fromkeys(VARIANTS, 0)
masked_matmul.expert_launches_by_variant = dict.fromkeys(VARIANTS, 0)
masked_matmul.fleet_expert_launches_by_variant = dict.fromkeys(VARIANTS, 0)


@torch.library.custom_op("repro_torch::masked_matmul", mutates_args=())
def _masked_matmul_op(x: torch.Tensor, w: torch.Tensor, ok: torch.Tensor, variant: str) -> torch.Tensor:
    return masked_matmul(x, w, ok, variant=variant)


@_masked_matmul_op.register_fake
def _(x, w, ok, variant):
    return x.new_empty((*x.shape[:-1], w.shape[-1]))


@register_flop_formula(torch.ops.repro_torch.masked_matmul)
def _masked_matmul_flops(x, w, ok, variant, *args, out_shape=None, **kwargs) -> int:
    """2 * M * K * N: M the rows of x (its leading axes, chips and experts
    included), K and N w's last two axes. Applying the mask is elementwise,
    which ``FlopCounterMode`` does not count."""
    m = 1
    for s in x[:-1]:
        m *= s
    return 2 * m * w[-2] * w[-1]


def _masked_matmul_vmap(info, in_dims, x, w, ok, variant):
    """The chip-batched launch under ``torch.func.vmap``: the vmapped axis
    becomes the kernel's chip axis. A weight and mask shared by every
    member (no vmapped axis on either) fold the members into M instead.
    An MoE layer's experts under the chip map (w (E, K, N) and one mask a
    chip) become ONE chips x experts launch: w (chips, E, K, N), a view of
    the stacked master, and each chip's mask read by its E experts."""
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
    silicon (mask) as the payload rows, summed over K in the payload launch's
    own slices (so y has the bits of ``masked_matmul(x, w, ok)``). Returns
    ``(y, check_row)``, where on
    consistent hardware ``check_row[b] == sum_m y[m, b]`` up to float
    reassociation; a permanent fault in PE column ``b % C`` perturbs both
    through the identical mask, which is what lets ``obs/abft.py`` fold the
    check-row syndrome back onto PE columns."""
    lead = x.shape[:-1]
    kdim = x.shape[-1]
    x2 = x.reshape(-1, kdim)
    xa = torch.cat([x2, x2.sum(dim=0, keepdim=True).to(x2.dtype)], dim=0)
    splits = None
    m = x2.shape[0]
    if x.device.type == "cuda" and pick_variant(x.dtype, m) == "mma":
        # the payload's own K slices (the mma plan's rows change the token tile, which changes no
        # bit, and may change the slices): the checksum row rides along without changing its bits
        splits = resolve_plan(x.dtype, m, kdim, w.shape[1], ok.shape[-2:], x.device, sm_count(x.device),
                              k_contiguous=w.stride(-1) != 1).splits
    ya = masked_matmul(xa, w, ok, splits=splits)
    return ya[:-1].reshape(*lead, w.shape[1]), ya[-1]
