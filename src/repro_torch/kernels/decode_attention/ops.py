"""Decode attention over an int8 KV cache, dense and paged: the CUDA kernels'
wrappers, their plain PyTorch versions, the quantizer and the launch counts.

Kernels: ``kernels/csrc/decode_attention.cu``. They replace the TPU kernels
``repro/kernels/decode_attention/decode_attention.py::decode_attention_pallas``
(dense) and ``::paged_decode_attention_pallas`` (paged).

Bound on an H100: bytes. One query token per head reads the whole valid
cache once: int8 K and V and their f32 scales, a few MB at the serving
shapes, so what sets the time is how many SMs read at once. The kernels split
the keys over blocks (flash-decoding): the grid is (sequence, KV head, chunk
of at most 8 query heads) x ``splits``, where ``split_plan`` picks the split
count from host-known shapes alone (about two blocks per SM, whole tiles of
``bkv`` keys each). Each block streams its share of the keys through
per-warp cp.async rings, keeps scores, softmax statistics and the
accumulator on chip, and serves a KV head's whole query group, so each key
is read once per group, not once per query head. With more than one split,
each block writes its partial (max, sum, accumulator) to an fp32 workspace of
``B * Hq * splits * (D + 2)`` floats from PyTorch's caching allocator, and
the last block of each (sequence, KV head, head chunk) merges them in split
order, counted by a zeroed counter buffer per (device, stream) that every
launch leaves zeroed. A call is one launch.

``decode_attention`` and ``paged_decode_attention`` launch their kernel for
a CUDA tensor and count the launch in ``.launches``; for a CPU tensor they
run ``decode_attention_ref`` / ``paged_decode_attention_ref``, the plain
versions. There is no fallback between the two. They take the ops-level
layouts, unpadded: q (B, Hq, 1, D); dense K/V int8 (B, Hkv, S, D) with f32
scales (B, Hkv, S); a paged pool int8 (Hkv, P, page, D) with f32 scales
(Hkv, P, page), block tables int32 (B, maxp) and lengths int32 (B,). Query
heads ``[h*g, (h+1)*g)`` share KV head ``h``.

A sequence of length 0 returns 0, as the TPU kernels do (the reference's
oracles return the mean of v there instead).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from repro_torch.kernels.common import (
    SMEM_LIMIT_BYTES,
    check_launch,
    load_kernel,
    sm_count,
    split_counters,
    tuned_block,
)

__all__ = [
    "quantize_kv",
    "dequantize_kv",
    "gather_pages",
    "decode_attention_ref",
    "paged_decode_attention_ref",
    "decode_attention",
    "paged_decode_attention",
    "HEAD_DIMS",
    "DEFAULT_BKV",
    "smem_bytes",
    "launch_bkv",
    "paged_tile",
    "resolve_bkv",
    "ring_slots",
    "head_chunks",
    "split_plan",
    "sm_count",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 96, 128)  # the head dims the kernels are built for
DEFAULT_BKV = 128  # the heuristic tile of the dense kernel (the reference's)
# the CUDA source's block geometry: NW warps of 32 lanes, KC keys per warp chunk, at most GMAX
# query heads per block
NW, KC, GMAX = 4, 32, 8
H100_SMS = 132
BLOCKS_PER_SM = 2  # the split plan's target
# the split count, the workspace pointer and bytes, the counters and their number, the stream
_SPLIT_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p]
_DENSE_ARGTYPES = (
    [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong] + _SPLIT_ARGTYPES
)
_PAGED_ARGTYPES = (
    [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
       ctypes.c_longlong] + _SPLIT_ARGTYPES
)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def quantize_kv(k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization per (..., position) row of the last axis:
    (int8 values, f32 scales). Rounds half to even and clips to +-127; the
    scale is at least 1e-8 / 127."""
    k32 = k.float()
    scale = k32.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(k32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Each sequence's page chain as dense KV: pages (Hkv, P, page, D) and
    block tables (B, maxp) give (B, Hkv, maxp * page, D), garbage past each
    sequence's length."""
    hkv, _, page, d = pages.shape
    b, maxp = block_tables.shape
    g = pages[:, block_tables.long()]  # (Hkv, B, maxp, page, D)
    return g.movedim(0, 1).reshape(b, hkv, maxp * page, d)


def _attend(q, k, v, keep, scale):
    """Grouped one-token attention in fp32 over the kept keys. q (B, Hq, 1,
    D); k, v (B, Hkv, S, D) fp32; keep (B, S) bool. A row that keeps no key
    returns 0."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k) * (scale if scale is not None else 1.0 / math.sqrt(d))
    s = s.masked_fill(~keep[:, None, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v) / torch.where(denom == 0, 1.0, denom)
    return o.reshape(b, hq, sq, d).to(q.dtype)


def decode_attention_ref(q, k_i8, k_scale, v_i8, v_scale, *, kv_valid_len=None, scale=None):
    """Plain version: q (B, Hq, 1, D) against an int8 KV cache, over the
    valid prefix ``kv_valid_len`` (an int or a tensor; None: all of it)."""
    k = dequantize_kv(k_i8, k_scale)
    v = dequantize_kv(v_i8, v_scale)
    b, skv = k.shape[0], k.shape[2]
    valid = skv if kv_valid_len is None else kv_valid_len
    if isinstance(valid, torch.Tensor):
        valid = valid.to(q.device).reshape(())
    keep = (torch.arange(skv, device=q.device) < valid)[None].expand(b, skv)
    return _attend(q, k, v, keep, scale)


def paged_decode_attention_ref(
    q, k_pages_i8, k_scale, v_pages_i8, v_scale, block_tables, seq_lens, *, scale=None
):
    """Plain version of the paged kernel: gather each page chain, dequantize,
    attend over each sequence's own length."""
    page = k_pages_i8.shape[2]
    maxp = block_tables.shape[1]
    k = gather_pages(dequantize_kv(k_pages_i8, k_scale), block_tables)
    v = gather_pages(dequantize_kv(v_pages_i8, v_scale), block_tables)
    keep = torch.arange(maxp * page, device=q.device)[None] < seq_lens.to(q.device)[:, None]
    return _attend(q, k, v, keep, scale)


# ---------------------------------------------------------------------------
# Launch geometry, shared with the lint (analysis/kernelgeom.py)
# ---------------------------------------------------------------------------


def ring_slots(bkv: int) -> int:
    """Chunks of KC keys each warp's cp.async ring holds: a block keeps
    about ``bkv`` keys in flight, and every warp at least two chunks."""
    return max(2, -(-int(bkv) // (NW * KC)))


def smem_bytes(bkv: int, d: int, group: int) -> int:
    """Dynamic shared memory one block of either kernel requests: q for up
    to GMAX query heads (fp32), each warp's p for a chunk (KC x GMAX fp32),
    the last-block flag, and the warps' cp.async rings (``ring_slots(bkv)`` slots each of KC int8 K rows
    padded to D + 16 bytes, KC int8 V rows and 2 x KC fp32 scales), every
    region 16-byte aligned. The C entry points compute the same sum and
    refuse a launch that disagrees."""
    def a16(n):
        return -(-int(n) // 16) * 16

    g, d = min(int(group), GMAX), int(d)
    return (a16(4 * g * d) + a16(4 * NW * KC * GMAX) + a16(4)
            + NW * ring_slots(bkv) * KC * (2 * d + 24))


def head_chunks(group: int) -> int:
    """Blocks per (sequence, KV head, split): one per GMAX query heads."""
    return -(-int(group) // GMAX)


def split_plan(b: int, hkv: int, skv: int, bkv: int, sm_count: int) -> int:
    """The number of key splits of a launch, from host-known shapes alone
    (``skv`` is S, or ``maxp * page`` for the paged kernel; a length held on
    the device is never read). Each split is at least one whole tile of
    ``bkv`` keys, there are never more splits than tiles, and the grid aims
    at BLOCKS_PER_SM blocks per SM; the split count is then the fewest that
    keeps each split's share of tiles, so no split starts past S."""
    tiles = -(-int(skv) // max(int(bkv), 1))
    if tiles <= 1:
        return 1
    want = max(1, -(-BLOCKS_PER_SM * int(sm_count) // max(int(b) * int(hkv), 1)))
    per = -(-tiles // min(tiles, want))
    return -(-tiles // per)


def launch_bkv(bkv: int, skv: int) -> int:
    """The dense kernel's tile as launched: the requested ``bkv``, never
    longer than the cache. The kernel masks the ragged last tile itself."""
    return min(int(bkv), int(skv))


def paged_tile(page: int) -> int:
    """The paged kernel's tile: whole pages, about 128 tokens."""
    return int(page) * max(1, 128 // int(page))


def resolve_bkv(b, hq, hkv, skv, d, dtype, device, bkv: Optional[int] = None) -> int:
    """The tile the dense wrapper launches for this shape: an explicit
    ``bkv``, else the tuning cache's winner, else ``DEFAULT_BKV``."""
    got = tuned_block(
        "decode_attention", dict(b=b, hq=hq, hkv=hkv, skv=skv, d=d), dtype,
        device=device, defaults=dict(bkv=DEFAULT_BKV), overrides=dict(bkv=bkv),
    )["bkv"]
    return launch_bkv(got, skv)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_common(q, hkv, d, kv, scales):
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernels are built for head_dim in {HEAD_DIMS}, got {d}")
    if hkv <= 0 or q.shape[1] % hkv:
        raise ValueError(f"query heads {q.shape[1]} are not a multiple of kv heads {hkv}")
    if q.shape[2] != 1:
        raise ValueError(f"decode attention takes one query token, got sq={q.shape[2]}")
    for t in kv:
        if t.dtype != torch.int8 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"K and V must be contiguous int8 on 16-byte boundaries, got {t.dtype}")
    for t in scales:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"K and V scales must be contiguous float32, got {t.dtype}")
    if any(t.device != q.device for t in (*kv, *scales)) or q.device.index != torch.cuda.current_device():
        raise ValueError("every input must lie on the current CUDA device")


def _splits(splits, b, hkv, keys, tile, device) -> int:
    """An explicit split count, checked, else the plan's."""
    tiles = -(-keys // tile)
    if splits is None:
        return split_plan(b, hkv, keys, tile, sm_count(device))
    if not 1 <= int(splits) <= tiles:
        raise ValueError(f"splits must be in [1, {tiles}] (whole {tile}-key tiles), got {splits}")
    return int(splits)


def _merge_scratch(q, hkv, group, splits):
    """(workspace, its bytes, counters, their number) for a launch of
    ``splits`` splits: nothing with one split, else B * Hq * splits * (D + 2)
    fp32 from the caching allocator and the stream's zeroed counters, one
    per (sequence, KV head, head chunk)."""
    if splits == 1:
        return None, 0, None, 0
    b, hq, _, d = q.shape
    ws = torch.empty(b * hq * splits * (d + 2), dtype=torch.float32, device=q.device)
    groups = b * hkv * head_chunks(group)
    cnt = split_counters(q.device, torch.cuda.current_stream().cuda_stream, groups)
    return ws, ws.numel() * 4, cnt, cnt.numel()


def decode_attention(
    q: torch.Tensor,  # (B, Hq, 1, D)
    k_i8: torch.Tensor,  # (B, Hkv, S, D) int8
    k_scale: torch.Tensor,  # (B, Hkv, S) f32
    v_i8: torch.Tensor,
    v_scale: torch.Tensor,
    kv_valid_len: Union[int, torch.Tensor],
    *,
    scale: Optional[float] = None,
    bkv: Optional[int] = None,
    splits: Optional[int] = None,
) -> torch.Tensor:
    """One-token attention over the first ``kv_valid_len`` positions of an
    int8 KV cache, shared by the batch. ``kv_valid_len`` is an int or a
    one-element integer tensor on q's device; it is never read on the host.
    ``bkv`` (the tile: the split granularity, and about the keys a block
    keeps in flight) defaults to the tuning cache's winner for this launch,
    else 128; ``splits`` defaults to ``split_plan``'s."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_i8, k_scale, v_i8, v_scale, kv_valid_len=kv_valid_len, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, got {q.device}")
    b, hq, _, d = q.shape
    if k_i8.dim() != 4 or k_i8.shape != v_i8.shape or k_i8.shape[0] != b or k_i8.shape[3] != d:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k_i8.shape)} v{tuple(v_i8.shape)}")
    hkv, skv = k_i8.shape[1], k_i8.shape[2]
    if k_scale.shape != k_i8.shape[:3] or v_scale.shape != k_i8.shape[:3]:
        raise ValueError(f"scales must be {tuple(k_i8.shape[:3])}")
    _check_common(q, hkv, d, (k_i8, v_i8), (k_scale, v_scale))
    if isinstance(kv_valid_len, torch.Tensor):
        if kv_valid_len.numel() != 1 or kv_valid_len.device != q.device:
            raise ValueError("a kv_valid_len tensor holds one length on q's device")
        len_t, len_v = kv_valid_len.reshape(1).to(torch.int32), 0
    else:
        len_t, len_v = None, int(kv_valid_len)
    group = hq // hkv
    tile = resolve_bkv(b, hq, hkv, skv, d, q.dtype, q.device, bkv)
    if tile <= 0 and skv:
        raise ValueError(f"bkv must be positive, got {bkv}")
    smem = smem_bytes(tile, d, group)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"bkv={tile} needs {smem} bytes of shared memory (limit {SMEM_LIMIT_BYTES})")
    q = q.contiguous()
    o = torch.empty_like(q)
    if b and hq:
        if not skv:
            return o.zero_()
        nsplit = _splits(splits, b, hkv, skv, tile, q.device)
        ws, ws_bytes, cnt, n_cnt = _merge_scratch(q, hkv, group, nsplit)
        fn = load_kernel("decode_attention", _DENSE_ARGTYPES)
        err = fn(
            _DTYPES[q.dtype], d, q.data_ptr(), k_i8.data_ptr(), k_scale.data_ptr(),
            v_i8.data_ptr(), v_scale.data_ptr(), o.data_ptr(),
            b, hkv, group, skv, tile,
            len_t.data_ptr() if len_t is not None else None, len_v,
            scale if scale is not None else 1.0 / math.sqrt(d), smem,
            nsplit, ws.data_ptr() if ws is not None else None, ws_bytes,
            cnt.data_ptr() if cnt is not None else None, n_cnt,
            torch.cuda.current_stream().cuda_stream,
        )
        check_launch("decode_attention", err)
        decode_attention.launches += 1
        decode_attention.last_bkv = tile
        decode_attention.last_splits = nsplit
    return o


decode_attention.launches = 0
decode_attention.last_bkv = None
decode_attention.last_splits = None


def paged_decode_attention(
    q: torch.Tensor,  # (B, Hq, 1, D)
    k_pages_i8: torch.Tensor,  # (Hkv, P, page, D) int8
    k_scale: torch.Tensor,  # (Hkv, P, page) f32
    v_pages_i8: torch.Tensor,
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # (B, maxp) int32
    seq_lens: torch.Tensor,  # (B,) int32
    *,
    scale: Optional[float] = None,
    splits: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention straight off a paged int8 pool: each sequence reads
    its own page chain at its own length. Pages of a chain at or past
    ``ceil(seq_len / page)`` are never read, so table entries there may be
    stale. A sequence is read at most ``maxp * page`` tokens long. The keys
    are split on whole tiles of pages; ``splits`` defaults to
    ``split_plan``'s over ``maxp * page``."""
    b, hq, sq, d = q.shape
    if sq != 1:
        raise ValueError(f"paged decode attention takes one query token, got sq={sq}")
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, k_pages_i8, k_scale, v_pages_i8, v_scale, block_tables, seq_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cpu or cuda, got {q.device}")
    if k_pages_i8.dim() != 4 or k_pages_i8.shape != v_pages_i8.shape or k_pages_i8.shape[3] != d:
        raise ValueError(f"bad pool shapes {tuple(k_pages_i8.shape)} {tuple(v_pages_i8.shape)}")
    hkv, pages, page, _ = k_pages_i8.shape
    if k_scale.shape != k_pages_i8.shape[:3] or v_scale.shape != k_pages_i8.shape[:3]:
        raise ValueError(f"pool scales must be {tuple(k_pages_i8.shape[:3])}")
    _check_common(q, hkv, d, (k_pages_i8, v_pages_i8), (k_scale, v_scale))
    if block_tables.dim() != 2 or block_tables.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError(f"block tables must be (B, maxp) and lengths (B,), got "
                         f"{tuple(block_tables.shape)} and {tuple(seq_lens.shape)}")
    if block_tables.device != q.device or seq_lens.device != q.device:
        raise ValueError("block tables and lengths must lie on q's device")
    tables = block_tables.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    group = hq // hkv
    tile = paged_tile(page)
    smem = smem_bytes(tile, d, group)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"a {tile}-token tile needs {smem} bytes of shared memory")
    q = q.contiguous()
    o = torch.empty_like(q)
    maxp = tables.shape[1]
    if b and hq:
        if not maxp:
            return o.zero_()
        nsplit = _splits(splits, b, hkv, maxp * page, tile, q.device)
        ws, ws_bytes, cnt, n_cnt = _merge_scratch(q, hkv, group, nsplit)
        fn = load_kernel("paged_decode_attention", _PAGED_ARGTYPES, source="decode_attention")
        err = fn(
            _DTYPES[q.dtype], d, q.data_ptr(), k_pages_i8.data_ptr(), k_scale.data_ptr(),
            v_pages_i8.data_ptr(), v_scale.data_ptr(), o.data_ptr(),
            b, hkv, group, pages, page,
            tables.data_ptr(), maxp, lens.data_ptr(), tile,
            scale if scale is not None else 1.0 / math.sqrt(d), smem,
            nsplit, ws.data_ptr() if ws is not None else None, ws_bytes,
            cnt.data_ptr() if cnt is not None else None, n_cnt,
            torch.cuda.current_stream().cuda_stream,
        )
        check_launch("paged_decode_attention", err)
        paged_decode_attention.launches += 1
        paged_decode_attention.last_splits = nsplit
    return o


paged_decode_attention.launches = 0
paged_decode_attention.last_splits = None
