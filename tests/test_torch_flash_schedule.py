"""Flash attention's bf16 ``mma`` kernel, its walk emulated on the CPU and held
to the reference.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``). What it
computes in which order is emulated here in numpy float32, step for step as
``csrc/flash_attention.cu::flash_mma_kernel`` lays it out, and held to the
reference package's Pallas kernel in interpret mode and to its
``attention_ref``, on the same seeded numpy inputs:

- the grid: one block per (q tile, b * Hq + h), the heaviest causal q tile
  first in each row of blocks; every (b, h, q tile) is visited exactly once
  and every output row written exactly once;
- the producer's walk: Q as TMA boxes of 64 columns (zero past D and past
  Sq), then the kv tiles ``kv_begin`` to ``kv_end`` any row of the block
  keeps, each K and V tile zero past D and past Skv;
- each consumer warpgroup's 64 rows: the tiles that keep none of its rows'
  keys are skipped (they lead or trail the ones it computes); S = Q K^T over
  the first D columns only, in log2 units, masked on edge tiles (the zero
  rows past Skv included); the ``exp2`` online softmax in log2 units (the
  row max of the raw scores times ``scale * log2(e)``, one FFMA a score)
  with ``m_use = 0`` for a row that has no key yet; O rescaled, then
  O += P V with P rounded to bf16; rows that keep no key return 0.

Shapes: head dims 64, 80, 96 and 128 (80 and 96 leave part of their second
box zero); GQA groups 1, 2, 3 and 5; causal, not causal, a window and a
q_offset; Sq of 1, 37 and 129; every tile ``TILES["mma"]`` builds. The
per-variant tile sets and shared memory are held to the C source.

Tolerance: chip_smoke.py's bf16 flash gate (rtol 2e-2, atol 1e-2): the inputs
are bf16, P is rounded to bf16 before PV (the reference keeps it in fp32),
and the sums run in other orders.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.common import CSRC_DIR, SMEM_LIMIT_BYTES
from repro_torch.kernels.flash_attention import ops as fa

RTOL, ATOL = 2e-2, 1e-2  # chip_smoke.py's FLASH_BF16_TOL
LOG2E = 1.4426950408889634
WG_ROWS, BOX = 64, 64  # a consumer warpgroup's rows (wgmma's M); a TMA box's columns (128 bytes of bf16)


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (round to nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _box(x: np.ndarray, r0: int, rows: int, width: int) -> np.ndarray:
    """A tile as TMA writes it: ``rows`` rows from r0 of x (S, D), ``width``
    columns (whole 64-column boxes), zero past S and past D."""
    out = np.zeros((rows, width), np.float32)
    n = max(0, min(rows, x.shape[0] - r0))
    out[:n, : x.shape[1]] = x[r0:r0 + n]
    return out


def _kv_range(q0, bq, sq, skv, causal, window, q_offset, bkv):
    """The block's first kv tile and tile count (``t_first``, ``n_tiles``)."""
    lo = q_offset + q0
    hi = q_offset + min(q0 + bq, sq) - 1
    kv_end = min(skv, hi + 1) if causal else skv
    kv_begin = max(0, lo - window + 1) if window else 0
    t_first = kv_begin // bkv
    return t_first, ((kv_end - 1) // bkv - t_first + 1) if kv_end > kv_begin else 0


def emulate(q, k, v, *, causal, window, q_offset, tile, walk=None):
    """The kernel's output for bf16-valued float32 (B, H, S, D) inputs at
    ``tile``; ``walk`` (a list), where given, gets each block's (b, h, q0,
    t_first, n_tiles) and each warpgroup's computed tile range."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    bq, bkv = tile
    width = BOX * -(-d // BOX)
    kd = 16 * (d // 16)  # the k steps of S: up to D, never into the zero columns
    scale_log2 = np.float32(LOG2E / np.sqrt(d))
    out = np.full(q.shape, np.nan, np.float32)
    blocks_x = -(-sq // bq)
    seen = set()
    for y in range(b * hq):  # blockIdx.y
        bb, h = divmod(y, hq)
        hk = h // (hq // hkv)
        for x in range(blocks_x):  # blockIdx.x, launched first: the longest causal rows
            q0 = (blocks_x - 1 - x) * bq
            assert (bb, h, q0) not in seen
            seen.add((bb, h, q0))
            t_first, n_tiles = _kv_range(q0, bq, sq, skv, causal, window, q_offset, bkv)
            qt = _box(q[bb, h], q0, bq, width)
            ks = [_box(k[bb, hk], (t_first + i) * bkv, bkv, width) for i in range(n_tiles)]
            vs = [_box(v[bb, hk], (t_first + i) * bkv, bkv, width) for i in range(n_tiles)]
            if walk is not None:
                walk.append(("block", bb, h, q0, t_first, n_tiles))
            for wg in range(bq // WG_ROWS):
                row0 = q0 + WG_ROWS * wg
                live = row0 < sq
                w_lo, w_hi = q_offset + row0, q_offset + min(row0 + WG_ROWS, sq) - 1
                rows = (w_lo + np.arange(WG_ROWS))[:, None]
                qw = qt[WG_ROWS * wg: WG_ROWS * (wg + 1), :kd]
                o = np.zeros((WG_ROWS, d), np.float32)
                m = np.full((WG_ROWS, 1), -np.inf, np.float32)
                l_run = np.zeros((WG_ROWS, 1), np.float32)
                done = []
                for it in range(n_tiles):
                    t0 = (t_first + it) * bkv
                    if not live or (causal and t0 > w_hi) or (window and t0 + bkv - 1 <= w_lo - window):
                        continue
                    done.append(it)
                    s = (qw @ ks[it][:, :kd].T).astype(np.float32)
                    edge = t0 + bkv > skv or (causal and t0 + bkv - 1 > w_lo) or (window and t0 <= w_hi - window)
                    if edge:
                        cols = t0 + np.arange(bkv)[None, :]
                        keep = cols < skv
                        if causal:
                            keep = keep & (cols <= rows)
                        if window:
                            keep = keep & (cols > rows - window)
                        s = np.where(keep, s, -np.inf).astype(np.float32)
                    m_new = np.maximum(m, s.max(axis=1, keepdims=True) * scale_log2)
                    m_use = np.where(m_new == -np.inf, np.float32(0), m_new)
                    alpha = np.exp2(m - m_use)
                    p = np.exp2(s * scale_log2 - m_use).astype(np.float32)
                    l_run = l_run * alpha + p.sum(axis=1, keepdims=True)
                    m = m_new
                    o = o * alpha + (_bf16(p) @ vs[it][:, :d]).astype(np.float32)
                # the warpgroup's tiles are one run: the ones it skips lead or trail them
                assert done == list(range(done[0], done[-1] + 1)) if done else True
                if walk is not None:
                    walk.append(("wg", bb, h, q0, wg, (done[0], done[-1]) if done else None))
                inv = np.where(l_run > 0, 1.0 / np.where(l_run > 0, l_run, 1), 0).astype(np.float32)
                n = max(0, min(WG_ROWS, sq - row0))
                out[bb, h, row0:row0 + n] = _bf16(o * inv)[:n]
    assert len(seen) == b * hq * blocks_x
    assert not np.isnan(out).any()  # every row written once
    return out


def _inputs(b, hq, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    q = _bf16(rng.standard_normal((b, hq, sq, d), np.float32))
    k = _bf16(rng.standard_normal((b, hkv, skv, d), np.float32))
    # V: every column its own offset, so a column read from the wrong place shows
    v = _bf16(rng.standard_normal((b, hkv, skv, d), np.float32) + np.arange(d, dtype=np.float32) / 8)
    return q, k, v


# (name, causal, window, q_offset, Sq, Skv)
CASES = [
    ("causal", True, None, 0, 129, 129),
    ("encoder", False, None, 0, 37, 130),
    ("window", True, 48, 0, 128, 128),
    ("q_offset", True, None, 91, 37, 128),
    ("one_row_window", True, 20, 100, 1, 101),
    ("zero_mass", False, 4, 100, 37, 48),  # rows at 100..136 over 48 keys, a window of 4: none kept
    ("partly_zero_mass", True, 8, 30, 37, 48),  # rows from position 56 on keep none
]
# (D, GQA group): every head dim and every group the zoo's configs use
WIDTHS = [(64, 3), (80, 1), (96, 5), (128, 2)]


@pytest.mark.parametrize("d,group", WIDTHS, ids=[f"d{d}-g{g}" for d, g in WIDTHS])
@pytest.mark.parametrize("name,causal,window,q_offset,sq,skv", CASES, ids=[c[0] for c in CASES])
def test_the_emulated_walk_matches_the_reference_and_its_pallas_kernel(d, group, name, causal, window, q_offset,
                                                                       sq, skv):
    b = 2 if d == 64 and group == 3 else 1
    q, k, v = _inputs(b, group, 1, sq, skv, d, seed=d + 7 * group + sq)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    # the reference's Pallas kernel pads a ragged Skv with keys that a q_offset or a missing causal mask
    # can reach: there it takes the keys as one block
    pallas = np.asarray(jax_flash_attention(jq, jk, jv, bq=16, bkv=16 if skv % 16 == 0 else skv, interpret=True,
                                            **kw))
    oracle = np.asarray(jax_attention_ref(jq, jk, jv, **kw))
    empty = np.isnan(oracle).all(axis=-1)  # rows that keep no key: the oracle divides 0 by 0
    assert name.endswith("zero_mass") == bool(empty.any())
    if empty.all():
        assert not np.abs(pallas).any()  # the Pallas kernel's zero-mass rule
    for tile in fa.TILES["mma"]:
        got = emulate(q, k, v, tile=tile, **kw)
        # where a Pallas q block holds rows with keys and rows without, it leaves the latter nonzero:
        # those rows are held to 0 alone
        np.testing.assert_allclose(got[~empty], pallas[~empty], rtol=RTOL, atol=ATOL, err_msg=f"tile {tile}")
        np.testing.assert_allclose(got[~empty], oracle[~empty], rtol=RTOL, atol=ATOL, err_msg=f"tile {tile}")
        assert not np.abs(got[empty]).any()  # a row that keeps no key returns 0


@pytest.mark.parametrize("tile", fa.TILES["mma"], ids=[f"{t[0]}x{t[1]}" for t in fa.TILES["mma"]])
def test_the_walk_visits_each_block_once_heaviest_first_and_skips_at_the_ends(tile):
    """The launch order (blockIdx.x fastest), the producer's kv range and
    each warpgroup's tiles at a causal window: a 128-row block's first
    warpgroup skips the trailing tile its second computes, and a window
    drops leading tiles."""
    bq, bkv = tile
    walk = []
    q, k, v = _inputs(1, 2, 1, 300, 300, 64, seed=1)
    emulate(q, k, v, causal=True, window=100, q_offset=0, tile=tile, walk=walk)
    blocks = [w for w in walk if w[0] == "block"]
    q0s = [w[3] for w in blocks if w[2] == 0]
    assert q0s == sorted(q0s, reverse=True) == list(range(bq * (-(-300 // bq) - 1), -1, -bq))
    for _, bb, h, q0, t_first, n_tiles in blocks:
        lo, hi = q0, min(q0 + bq, 300) - 1
        assert t_first == max(0, lo - 99) // bkv and (t_first + n_tiles - 1) * bkv <= hi < (t_first + n_tiles) * bkv
    for _, bb, h, q0, wg, run in (w for w in walk if w[0] == "wg"):
        row0 = q0 + 64 * wg
        if row0 >= 300:
            assert run is None  # a warpgroup past Sq computes nothing
            continue
        w_lo, w_hi = row0, min(row0 + 64, 300) - 1
        t_first = _kv_range(q0, bq, 300, 300, True, 100, 0, bkv)[0]
        first, last = ((t_first + i) * bkv for i in run)
        assert first <= w_hi and first + bkv - 1 > w_lo - 100  # its first tile keeps one of its keys
        assert last <= w_hi < last + bkv or last + bkv <= w_hi  # and its last does too
        assert last == (t_first + run[1]) * bkv and (last + bkv > w_hi or last + bkv > 299)


def _const(src: str, name: str) -> str:
    found = re.search(rf"static constexpr \w+ {name} = ([^;]+);", src)
    assert found, name
    return found.group(1).strip()


def test_the_tiles_and_shared_memory_are_the_c_sources():
    """``TILES``, ``tiles_built``, ``smem_bytes`` and ``threads`` per
    variant against the constants and instances of
    ``csrc/flash_attention.cu``."""
    src = (CSRC_DIR / "flash_attention.cu").read_text()
    mma_tiles = tuple((int(a), int(b)) for a, b in re.findall(r"^\s*MMA_TILE\((\d+), (\d+)\)$", src, re.M))
    v1_tiles = tuple((int(a), int(b)) for a, b in re.findall(r"^\s*V1_TILE\((\d+), (\d+)\)$", src, re.M))
    assert mma_tiles == fa.TILES["mma"] and set(v1_tiles) == set(fa.TILES["v1"])
    assert fa.DEFAULT_TILE == {"mma": fa.TILES["mma"][0], "v1": (64, 64)}
    # the mma block: the C source's FlashShape, evaluated for each instance
    assert _const(src, "THREADS") == "128 * (CONSUMERS + 1)" and _const(src, "CONSUMERS") == "BQ / 64"
    assert _const(src, "BOXES") == "(D + 63) / 64"
    assert _const(src, "STAGES") == "2"
    assert _const(src, "SMEM") == "1024 + Q_BYTES + 2 * STAGES * KV_BYTES"
    for d in fa.HEAD_DIMS:
        boxes = (d + 63) // 64
        for bq, bkv in fa.TILES["mma"]:
            q_bytes, kv_bytes = bq * 128 * boxes, bkv * 128 * boxes
            assert fa.smem_bytes("mma", bq, bkv, d) == 1024 + q_bytes + 4 * kv_bytes <= SMEM_LIMIT_BYTES
            assert fa.threads("mma", bq) == 128 * (bq // 64 + 1)
        assert fa.tiles_built("mma", torch.bfloat16, d) == fa.TILES["mma"]
        assert fa.tiles_built("v1", torch.bfloat16, d) == (fa.DEFAULT_TILE["v1"],)
        assert fa.threads("v1", 64) == 256
    # every head dim each variant is built for
    assert tuple(int(x) for x in re.findall(r"launch_mma<(\d+)>\(", src)) == fa.HEAD_DIMS
    assert Path(CSRC_DIR / "hopper.cuh").exists() and '#include "hopper.cuh"' in src
