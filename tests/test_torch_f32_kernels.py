"""The float32 kernels' schedules, emulated on the CPU and held to the reference.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``). What
they compute in which order is emulated here in numpy float32, step for step
as ``csrc/masked_matmul.cu`` and ``csrc/flash_attention.cu`` lay it out, and
held to the reference package's Pallas kernels in interpret mode and to its
plain references, on the same seeded numpy inputs:

- the masked GEMM's ``v1``: K cut into the slices of ``ops._split_plan`` (1,
  2 and the most the plan gives, and from one wave of tiles on only the
  tiles of a partly filled last wave), each slice's fp32 partial summed in
  slice order; at M <= 16 the decode kernels' order (row-major w: each warp's rows
  U at a time, the 8 warps summed 7 down to 0; embed.T: 8 lanes a column,
  8-element chunks, a shuffle butterfly), above it the tiled kernel's (k in
  order); the weights masked by the packed bits the kernels read, at ragged
  M, N and K, R != C, both w layouts and a chip axis (one w per chip, or one
  shared with chip stride 0);
- flash attention's ``v1``: 64 x 64 tiles over the kv range the kernel walks
  for each 64-row q block (causal, window and ``q_offset`` bounds), the
  per-tile max, rescale and sum (each thread's share of a row's sum over its
  keys tx + 16 j, summed by a butterfly at the end), and the zero-mass rule,
  at head dims 64, 80, 96 and 128.

Tolerance: ``dtype_tol(float32)`` (rtol 2e-5, atol 2e-4) everywhere: the
emulations round each product before adding it where the kernels fuse
multiply and add, and sum in the kernels' order, which is not the
reference's.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.faults import random_fault_map as jax_random_fault_map
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.masked_matmul.ops import masked_matmul as jax_masked_matmul
from repro.kernels.masked_matmul.ref import masked_matmul_ref as jax_masked_matmul_ref
from repro_torch.kernels.common import assert_close
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.masked_matmul.ops import _split_plan, _v1_tiles, masked_matmul, packed_mask

F32 = torch.float32
R, C = 16, 12  # a mask period with R != C
SMS = 132

# ---------------------------------------------------------------------------
# masked GEMM v1
# ---------------------------------------------------------------------------


def _masked(w, ok_t, k_contiguous):
    """w (K, N) as the kernels multiply it: each weight times its mask bit,
    read from the packed bits the wrapper hands the kernel (bits along C for
    row-major w, bits of ok.T along R for embed.T)."""
    bits, bits_t = (b.numpy() for b in packed_mask(ok_t))
    kdim, n = w.shape
    kk, nn = np.arange(kdim)[:, None] % R, np.arange(n)[None, :] % C
    if k_contiguous:
        bit = (bits_t[nn, kk >> 3] >> (kk & 7)) & 1
    else:
        bit = (bits[kk, nn >> 3] >> (nn & 7)) & 1
    return (w * bit.astype(np.float32)).astype(np.float32)


def _slices(kdim, splits, granule):
    """The kernels' K slices: ceil(tiles / splits) whole k tiles each."""
    tiles = -(-kdim // granule)
    per = -(-tiles // splits)
    return [(z * per * granule, min(kdim, (z + 1) * per * granule)) for z in range(splits)]


def _rows_slice(x, wm, k0, k1, u=4):
    """decode_rows_kernel, fp32 x: warp w sums rows w*U + 8U s .. + U - 1 of
    its slice in order; the warps' sums are added 7 down to 0."""
    m, n = x.shape[0], wm.shape[1]
    red = np.zeros((m, n), np.float32)
    for warp in range(7, -1, -1):
        acc = np.zeros((m, n), np.float32)
        for base in range(k0 + warp * u, k1, 8 * u):
            for k in range(base, min(base + u, k1)):
                acc = acc + np.outer(x[:, k], wm[k]).astype(np.float32)
        red = red + acc
    return red


def _cols_slice(x, wm, k0, k1):
    """decode_cols_kernel: lane `sub` of a column's 8 sums the 8-element
    chunks at (k - k0) % 64 in [8 sub, 8 sub + 8), in order; the 8 lanes meet
    by a shuffle butterfly (xor 1, 2, 4)."""
    m, n = x.shape[0], wm.shape[1]
    lanes = np.zeros((8, m, n), np.float32)
    for k in range(k0, k1):
        sub = ((k - k0) % 64) // 8
        lanes[sub] = lanes[sub] + np.outer(x[:, k], wm[k]).astype(np.float32)
    while lanes.shape[0] > 1:
        lanes = lanes[0::2] + lanes[1::2]
    return lanes[0]


def _tiled_slice(x, wm, k0, k1):
    """tiled_kernel: every output's k run of its slice, in order."""
    acc = np.zeros((x.shape[0], wm.shape[1]), np.float32)
    for k in range(k0, k1):
        acc = acc + np.outer(x[:, k], wm[k]).astype(np.float32)
    return acc


def _raster(m_tiles, n_tiles, group=8):
    """The tiled kernel's tiles in launch order: (row tile, column tile) of
    tile t, groups of 8 row tiles walked across the column tiles."""
    order = []
    for t in range(m_tiles * n_tiles):
        first = t // (group * n_tiles) * group
        rows = min(m_tiles - first, group)
        order.append((first + t % (group * n_tiles) % rows, t % (group * n_tiles) // rows))
    return order


def _emulate_v1(x, wm, splits, k_contiguous, split_tiles=None):
    """One chip's v1 launch: each slice's fp32 partial, summed in slice
    order. At M > 16 only the chip's last ``split_tiles`` tiles in raster
    order are cut (all of them by default); the others sum their whole K."""
    m, kdim = x.shape
    bm, bn, granule = _v1_tiles(m, wm.shape[1], k_contiguous)

    def sliced(run, xs, ws, n_slices):
        parts = [run(xs, ws, k0, k1) for k0, k1 in _slices(kdim, n_slices, granule)]
        if len(parts) == 1:
            return parts[0]
        y = np.zeros_like(parts[0])
        for p in parts:
            y = y + p
        return y

    if m <= 16:
        return sliced(_cols_slice if k_contiguous else _rows_slice, x, wm, splits)
    order = _raster(-(-m // bm), -(-wm.shape[1] // bn))
    cut = set(order[len(order) - (len(order) if split_tiles is None else split_tiles):])
    y = np.zeros((m, wm.shape[1]), np.float32)
    for ti, tj in order:
        rows, cols = slice(ti * bm, (ti + 1) * bm), slice(tj * bn, (tj + 1) * bn)
        y[rows, cols] = sliced(_tiled_slice, x[rows], wm[:, cols], splits if (ti, tj) in cut else 1)
    return y


GEMM_CASES = [  # (M, K, N, embed.T, chips, w shared by the chips)
    (5, 300, 70, False, 1, False),  # decode rows
    (5, 300, 70, True, 1, False),  # decode cols (embed.T)
    (37, 300, 70, False, 1, False),  # tiled, 64-row tiles
    (130, 300, 97, True, 1, False),  # tiled, 128-row tiles, embed.T, ragged N
    (130, 300, 192, False, 1, False),  # tiled, 128 x 96 tiles (8 x 6 a thread)
    (5, 300, 70, False, 3, False),  # a chip axis, one w per chip
    (37, 300, 70, True, 3, True),  # a chip axis, one w for every chip (stride 0)
]


def _gemm_inputs(m, k, n, transposed, chips, shared, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((chips, m, k), np.float32)
    w = rng.standard_normal((1 if shared else chips, n, k), np.float32).transpose(0, 2, 1)
    w = w if transposed else np.ascontiguousarray(w)
    ok = np.stack([jax_random_fault_map(seed + c, R, C, 0.3).ok_mask for c in range(chips)]).astype(np.float32)
    return x, w, ok


def _hold_to_reference(x, w, ok, shared, got):
    """The emulated launch against the reference's Pallas kernel (interpret
    mode, under jax.vmap over the chips) and its oracle, and the port's plain
    version on the same stack."""
    chips, m, k = x.shape
    n = w.shape[2]
    jw = jnp.asarray(np.ascontiguousarray(w))
    axes = (0, None if shared else 0, 0)
    kern = jax.vmap(lambda a, b, o: jax_masked_matmul(a, b, o, interpret=True), in_axes=axes)(
        jnp.asarray(x), jw[0] if shared else jw, jnp.asarray(ok))
    ref = jax.vmap(jax_masked_matmul_ref, in_axes=axes)(jnp.asarray(x), jw[0] if shared else jw, jnp.asarray(ok))
    assert_close(got, np.asarray(kern), F32)
    assert_close(got, np.asarray(ref), F32)
    wt = torch.from_numpy(w[0]).expand(chips, k, n) if shared else torch.from_numpy(w)
    plain = masked_matmul(torch.from_numpy(x), wt if chips > 1 else wt[0], torch.from_numpy(ok if chips > 1 else ok[0]))
    assert_close(plain.reshape(chips, m, n), got, F32)


@pytest.mark.parametrize("which", ["one", "two", "most"])
@pytest.mark.parametrize("m,k,n,transposed,chips,shared", GEMM_CASES)
def test_emulated_v1_gemm_schedule_matches_reference_and_pallas(m, k, n, transposed, chips, shared, which):
    x, w, ok = _gemm_inputs(m, k, n, transposed, chips, shared, seed=m + n + chips)
    plan = _split_plan(m, n, k, SMS, chips, transposed)
    most = _split_plan(m, n, k, 10**6, chips, transposed)  # a card with SMs to spare
    splits = {"one": 1, "two": 2, "most": most.splits}[which]
    assert 1 <= plan.splits <= most.splits and most.splits >= 3  # K is cut, into more than two slices
    assert most.split_tiles == most.tiles // chips  # below one wave every tile is cut
    granule = _v1_tiles(m, n, transposed)[2]
    assert all(k1 > k0 for k0, k1 in _slices(k, splits, granule))  # no empty slice
    got = np.stack([
        _emulate_v1(x[c], _masked(w[0 if shared else c], torch.from_numpy(ok[c]), transposed), splits, transposed)
        for c in range(chips)
    ])
    _hold_to_reference(x, w, ok, shared, got)


@pytest.mark.parametrize("transposed,chips,shared,sms", [(False, 1, False, 2), (True, 2, False, 5), (False, 3, True, 4)])
def test_emulated_v1_gemm_last_wave_split_matches_reference_and_pallas(transposed, chips, shared, sms):
    """From one wave of tiles on, only each chip's last tiles in raster order
    are cut: 200 x 300 is 2 x 3 tiles of 128 x 128; on a card of 2 SMs (4
    slots) one chip's 6 tiles leave 2 for a second wave, which are cut in 2;
    of 2 chips on 5 SMs (12 tiles, 10 slots) each chip's last tile is cut in
    4 (a slice holds at least 8 of K's 38 k tiles), of 3 chips on 4 SMs (18
    tiles, 8 slots) in 2: as many slices as fill the last wave."""
    m, k, n = 200, 300, 300
    x, w, ok = _gemm_inputs(m, k, n, transposed, chips, shared, seed=chips)
    plan = _split_plan(m, n, k, sms, chips, transposed)
    assert plan.tiles == 6 * chips and 0 < plan.split_tiles < 6 and plan.splits > 1
    assert plan.split_tiles == -(-(6 * chips % (2 * sms)) // chips)
    fill = chips * plan.split_tiles
    # the slices fit the last wave, and fill it, unless a slice would hold under 8 k tiles
    assert fill * plan.splits <= 2 * sms and (fill * (plan.splits + 1) > 2 * sms or plan.splits == -(-k // 8) // 8)
    assert plan.scratch_bytes == 4 * chips * plan.split_tiles * plan.splits * 128 * 128
    got = np.stack([
        _emulate_v1(x[c], _masked(w[0 if shared else c], torch.from_numpy(ok[c]), transposed), plan.splits,
                    transposed, plan.split_tiles)
        for c in range(chips)
    ])
    _hold_to_reference(x, w, ok, shared, got)


@pytest.mark.parametrize("m,n,want", [(17, 576, (64, 96)), (64, 192, (64, 96)), (65, 1536, (128, 128)),
                                      (8192, 576, (128, 96)), (8192, 192, (128, 96)), (1024, 49152, (128, 128)),
                                      (100, 130, (128, 64)), (100, 300, (128, 128))])
def test_v1_tiles_follow_m_and_n(m, n, want):
    """64-row tiles up to M = 64; 96-column tiles where N is a multiple of 96
    and not of 128 (SmolLM's 576 and 192), else 64-column tiles where
    128-wide ones would leave a quarter or more of their columns empty (N =
    130: 256 - 130), else 128."""
    assert _v1_tiles(m, n)[:2] == want and _v1_tiles(m, n)[2] == 8
    assert _v1_tiles(4, n) == (4, 256, 64) and _v1_tiles(4, n, True) == (4, 32, 64)


# ---------------------------------------------------------------------------
# flash attention v1
# ---------------------------------------------------------------------------

BQ = BKV = 64


def _walk(sq, skv, causal, window, q_offset, q0):
    """The kv tiles the kernel walks for the q block at q0: (first, count)."""
    lo, hi = q_offset + q0, q_offset + min(q0 + BQ, sq) - 1
    kv_end = min(skv, hi + 1) if causal else skv
    kv_begin = max(0, lo - window + 1) if window else 0
    first = kv_begin // BKV
    return first, ((kv_end - 1) // BKV - first + 1) if kv_end > kv_begin else 0


def _keep(rows, cols, skv, causal, window):
    keep = cols[None, :] < skv
    if causal:
        keep = keep & (cols[None, :] <= rows[:, None])
    if window:
        keep = keep & (cols[None, :] > rows[:, None] - window)
    return keep


def _emulate_flash_v1(q, k, v, causal, window, q_offset):
    """flash_attention_kernel's tile walk in numpy float32."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = np.float32(1.0 / math.sqrt(d))
    o = np.zeros_like(q)
    for bi in range(b):
        for h in range(hq):
            hk = h // (hq // hkv)
            for q0 in range(0, sq, BQ):
                rows = np.arange(q0, min(q0 + BQ, sq))
                pos = rows + q_offset
                m_run = np.full(len(rows), -np.inf, np.float32)
                l_thr = np.zeros((len(rows), 16), np.float32)  # each thread's share, key tx + 16 j
                acc = np.zeros((len(rows), d), np.float32)
                first, count = _walk(sq, skv, causal, window, q_offset, q0)
                for t in range(first, first + count):
                    cols = np.arange(t * BKV, (t + 1) * BKV)
                    kt = np.zeros((BKV, d), np.float32)
                    vt = np.zeros((BKV, d), np.float32)
                    n_in = max(0, min(BKV, skv - t * BKV))
                    kt[:n_in], vt[:n_in] = k[bi, hk, t * BKV:t * BKV + n_in], v[bi, hk, t * BKV:t * BKV + n_in]
                    s = (q[bi, h, rows] @ kt.T).astype(np.float32) * scale
                    s = np.where(_keep(pos, cols, skv, causal, window), s, -np.inf).astype(np.float32)
                    m_new = np.maximum(m_run, s.max(1))
                    m_use = np.where(m_new == -np.inf, 0, m_new).astype(np.float32)
                    alpha = np.exp(m_run - m_use).astype(np.float32)
                    p = np.exp(s - m_use[:, None]).astype(np.float32)
                    share = np.zeros_like(l_thr)
                    for j in range(4):  # thread tx adds keys tx + 16 j in order
                        share = share + p[:, 16 * j:16 * j + 16]
                    l_thr = l_thr * alpha[:, None] + share
                    acc = acc * alpha[:, None] + (p @ vt).astype(np.float32)
                    m_run = m_new
                while l_thr.shape[1] > 1:  # the butterfly over the row's 16 threads
                    l_thr = l_thr[:, 0::2] + l_thr[:, 1::2]
                l = l_thr[:, 0]
                inv = np.where(l > 0, 1 / np.where(l > 0, l, 1), 0).astype(np.float32)
                o[bi, h, rows] = acc * inv[:, None]
    return o


FLASH_CASES = [  # (Hq, Hkv, Sq, Skv, causal, window, q_offset)
    (4, 2, 130, 130, True, None, 0),  # three q blocks, ragged; causal skips the last tiles
    (4, 2, 70, 200, True, 37, 130),  # window and q_offset: the walk starts past tile 0
    (4, 2, 8, 150, True, None, 142),  # decode-like: queries at the end of the kv
    (4, 4, 65, 65, False, None, 0),  # not causal
]


def _qkv(hq, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, hq, sq, d), np.float32), rng.standard_normal((1, hkv, skv, d), np.float32),
            rng.standard_normal((1, hkv, skv, d), np.float32))


@pytest.mark.parametrize("d", [64, 80, 96, 128])
@pytest.mark.parametrize("hq,hkv,sq,skv,causal,window,q_offset", FLASH_CASES)
def test_emulated_v1_flash_walk_matches_reference_and_pallas(hq, hkv, sq, skv, causal, window, q_offset, d):
    q, k, v = _qkv(hq, hkv, sq, skv, d, seed=sq + skv + d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = _emulate_flash_v1(q, k, v, **kw)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    assert_close(got, np.asarray(jax_flash_attention(jq, jk, jv, interpret=True, **kw)), F32)
    assert_close(got, np.asarray(jax_attention_ref(jq, jk, jv, **kw)), F32)
    assert_close(flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw), got, F32)


@pytest.mark.parametrize("d", [64, 128])
def test_emulated_v1_flash_zero_mass_rows_return_zero(d):
    """Rows that keep no key return 0 (the port's rule, ``attention_ref``):
    a window of 4 behind q_offset 100 over 40 keys keeps nothing, as the
    reference kernel also gives (its oracle divides 0 by 0 there); with
    causal and window 8 at q_offset 30 only the first 17 rows keep keys,
    which are held to the reference kernel and oracle."""
    q, k, v = _qkv(4, 2, 70, 40, d, seed=d)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    tq, tk, tv = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    kw = dict(causal=False, window=4, q_offset=100)
    got = _emulate_flash_v1(q, k, v, **kw)
    assert not np.abs(got).any()
    assert_close(got, np.asarray(jax_flash_attention(jq, jk, jv, interpret=True, **kw)), F32)
    kw = dict(causal=True, window=8, q_offset=30)
    got = _emulate_flash_v1(q, k, v, **kw)
    live = 17  # rows at positions 30..46 keep keys 23..39
    assert not np.abs(got[:, :, live:]).any() and np.abs(got[:, :, :live]).all(-1).all()
    assert_close(got, flash_attention(tq, tk, tv, **kw), F32)
    assert_close(got[:, :, :live], np.asarray(jax_flash_attention(jq, jk, jv, interpret=True, **kw))[:, :, :live], F32)
    assert_close(got[:, :, :live], np.asarray(jax_attention_ref(jq, jk, jv, **kw))[:, :, :live], F32)


@pytest.mark.parametrize("causal,window,q_offset", [(True, None, 0), (True, 37, 130), (False, 4, 100),
                                                    (True, 1024, 900), (False, None, 0), (True, 64, 0)])
def test_flash_v1_walk_skips_only_tiles_no_row_keeps(causal, window, q_offset):
    """Every kept (row, key) pair of a q block lies in the tiles its walk
    visits, and the walk visits no tile outside the block's key range."""
    sq, skv = 200, 1100
    for q0 in range(0, sq, BQ):
        rows = np.arange(q0, min(q0 + BQ, sq)) + q_offset
        keep = _keep(rows, np.arange(skv), skv, causal, window)
        first, count = _walk(sq, skv, causal, window, q_offset, q0)
        kept_tiles = set(np.nonzero(keep.any(0))[0] // BKV)
        walked = set(range(first, first + count))
        assert kept_tiles <= walked
        assert all(t * BKV < skv for t in walked)
        if kept_tiles:
            assert min(walked) == min(kept_tiles) and max(walked) == max(kept_tiles)
