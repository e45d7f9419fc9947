"""The port's int8 decode attention, dense and paged, against the reference.

The same numpy inputs go through the reference's quantizer, oracles and
Pallas kernels in interpret mode, and through the port's wrappers on CPU
tensors (their plain PyTorch versions). The CUDA kernels are held to the
plain versions on the card by ``tests/test_torch_cuda.py``.
"""
import functools
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode_attention
from repro.kernels.decode_attention.ops import dequantize_kv as jax_dequantize_kv
from repro.kernels.decode_attention.ops import paged_decode_attention as jax_paged_decode_attention
from repro.kernels.decode_attention.ops import quantize_kv as jax_quantize_kv
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_attention_ref
from repro.kernels.decode_attention.ref import gather_pages_ref as jax_gather_pages
from repro.kernels.decode_attention.ref import (
    paged_decode_attention_ref as jax_paged_decode_attention_ref,
)
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.serve.kvcache import PageAllocator as JaxPageAllocator
from repro.serve.kvcache import chain_layout as jax_chain_layout
from repro_torch.analysis.kernelgeom import decode_attention_launch, lint_launch
from repro_torch.kernels.common import SMEM_LIMIT_BYTES, dtype_tol
from repro_torch.kernels.decode_attention.ops import (
    GMAX,
    H100_SMS,
    decode_attention,
    decode_attention_ref,
    dequantize_kv,
    gather_pages,
    head_chunks,
    paged_decode_attention,
    paged_decode_attention_ref,
    quantize_kv,
    ring_slots,
    smem_bytes,
    split_plan,
)
from repro_torch.serve.kvcache import PageAllocator, chain_layout

F32_TOL = dict(rtol=2e-5, atol=2e-5)  # the reference's own kernel test


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bitwise_the_reference(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 40, 32)).astype(np.float32) * rng.uniform(0.01, 10, (2, 3, 40, 1))
    x[0, 0, 0] = 0.0  # an all-zero row: the scale floor
    jx = jnp.asarray(x, dtype)
    tx = _t(jx.astype(jnp.float32)).to(getattr(torch, dtype))
    jq, js = jax_quantize_kv(jx)
    tq, ts = quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_kv_rounds_half_to_even_as_the_reference():
    # each row's max is 127, so the scale is exactly 1 and x / scale = x
    row = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5], np.float32)
    x = np.tile(row, (1, 1, 3, 1))
    jq, js = jax_quantize_kv(jnp.asarray(x))
    tq, ts = quantize_kv(torch.from_numpy(x))
    assert float(ts[0, 0, 0]) == 1.0
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq[0, 0, 0].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantize_kv_matches_the_reference(dtype):
    rng = np.random.default_rng(4)
    q = rng.integers(-127, 128, (2, 2, 16, 32)).astype(np.int8)
    s = rng.uniform(1e-3, 1.0, (2, 2, 16)).astype(np.float32)
    ref = jax_dequantize_kv(jnp.asarray(q), jnp.asarray(s), jnp.dtype(str(dtype)[6:]))
    got = dequantize_kv(_t(q), _t(s), dtype)
    assert got.dtype == dtype
    np.testing.assert_array_equal(_np(got), np.asarray(ref.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

DENSE_CASES = [  # (b, hq, hkv, skv, d, valid, q dtype)
    (2, 4, 2, 256, 32, 256, "float32"),  # the reference kernel test's four cases
    (1, 8, 2, 256, 64, 200, "float32"),
    (2, 2, 2, 128, 32, 1, "float32"),
    (1, 4, 4, 192, 32, 100, "float32"),
    (2, 9, 3, 320, 64, 150, "float32"),  # SmolLM's grouping, a length off the 64-key tile
    (2, 4, 2, 256, 32, 177, "bfloat16"),
]


def _dense_inputs(b, hq, hkv, skv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    jq = jnp.asarray(q, dtype)
    tq = _t(jq.astype(jnp.float32)).to(getattr(torch, dtype))
    return q, k, v, jq, tq


@pytest.mark.parametrize("b,hq,hkv,skv,d,valid,dtype", DENSE_CASES)
def test_decode_attention_plain_matches_pallas_kernel_and_oracle(b, hq, hkv, skv, d, valid, dtype):
    q, k, v, jq, tq = _dense_inputs(b, hq, hkv, skv, d, dtype, seed=skv + valid)
    ki, ks = jax_quantize_kv(jnp.asarray(k))
    vi, vs = jax_quantize_kv(jnp.asarray(v))
    cache = tuple(_t(a) for a in (ki, ks, vi, vs))
    got = decode_attention(tq, *cache, valid)
    assert got.dtype == tq.dtype and got.shape == (b, hq, 1, d)
    before = decode_attention.launches
    kern = jax_decode_attention(jq, ki, ks, vi, vs, valid, bkv=64, interpret=True)
    oracle = jax_decode_attention_ref(jq, ki, ks, vi, vs, kv_valid_len=valid)
    tol = F32_TOL if dtype == "float32" else dict(zip(("rtol", "atol"), dtype_tol(torch.bfloat16)))
    np.testing.assert_allclose(_np(got), np.asarray(kern.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(_np(got), np.asarray(oracle.astype(jnp.float32)), **tol)
    assert decode_attention.launches == before  # a CPU tensor runs the plain version
    # the quantization error against float attention over the valid prefix stays small
    fp = jax_attention_ref(jnp.asarray(q), jnp.asarray(k[:, :, :valid]), jnp.asarray(v[:, :, :valid]),
                           causal=False, window=None)
    assert float(np.max(np.abs(_np(got) - np.asarray(fp)))) < 5e-2


def test_decode_attention_takes_a_tensor_length():
    _, k, v, _, tq = _dense_inputs(1, 4, 2, 96, 32, "float32", seed=5)
    cache = (*quantize_kv(torch.from_numpy(k)), *quantize_kv(torch.from_numpy(v)))
    a = decode_attention(tq, *cache, 70)
    b = decode_attention(tq, *cache, torch.tensor(70, dtype=torch.int64))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_zero_length_returns_zero_as_the_pallas_kernel_not_the_oracle():
    """The TPU kernel returns 0 for a sequence of length 0; the reference's
    oracle returns the mean of v there. The port follows the kernel."""
    q, k, v, jq, tq = _dense_inputs(2, 4, 2, 128, 32, "float32", seed=6)
    ki, ks = jax_quantize_kv(jnp.asarray(k))
    vi, vs = jax_quantize_kv(jnp.asarray(v))
    got = decode_attention(tq, *(_t(a) for a in (ki, ks, vi, vs)), 0)
    kern = jax_decode_attention(jq, ki, ks, vi, vs, 0, bkv=64, interpret=True)
    oracle = jax_decode_attention_ref(jq, ki, ks, vi, vs, kv_valid_len=0)
    assert not got.abs().any()
    np.testing.assert_array_equal(np.asarray(kern), 0.0)
    assert float(jnp.max(jnp.abs(oracle))) > 0.05


# ---------------------------------------------------------------------------
# paged
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def paged_pool():
    """A pool built as the reference's continuous-serving fixture builds it,
    with SmolLM's grouping: ragged lengths (one ending mid-page, one of a
    single token, one whole chain), shuffled page ids, and a slot whose
    table holds page ids of other chains past its length."""
    rng = np.random.default_rng(0)
    B, Hq, Hkv, D, page, maxp, P = 4, 6, 2, 32, 8, 5, 24
    lens = np.asarray([5, 17, 40, 1], np.int32)
    k = rng.standard_normal((B, Hkv, maxp * page, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, maxp * page, D)).astype(np.float32)
    q = rng.standard_normal((B, Hq, 1, D)).astype(np.float32)
    tbl = rng.permutation(np.arange(1, P))[: B * maxp].reshape(B, maxp).astype(np.int32)
    tbl[3, 1:] = tbl[2, 1:]  # stale ids past slot 3's one page: pages slot 2 owns
    ki8, ks = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(k)))
    vi8, vs = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(v)))
    pool_k = np.zeros((Hkv, P, page, D), np.int8)
    pool_ks = np.zeros((Hkv, P, page), np.float32)
    pool_v, pool_vs = pool_k.copy(), pool_ks.copy()
    for b in range(B):
        for i in range(-(-int(lens[b]) // page)):
            pid, sl = int(tbl[b, i]), slice(i * page, (i + 1) * page)
            pool_k[:, pid], pool_ks[:, pid] = ki8[b, :, sl], ks[b, :, sl]
            pool_v[:, pid], pool_vs[:, pid] = vi8[b, :, sl], vs[b, :, sl]
    return q, (ki8, ks, vi8, vs), (pool_k, pool_ks, pool_v, pool_vs), tbl, lens


def test_paged_plain_matches_pallas_kernel_and_oracle(paged_pool):
    q, _, pool, tbl, lens = paged_pool
    args = (q, *pool, tbl, lens)
    got = paged_decode_attention(*(_t(a) for a in args))
    before = paged_decode_attention.launches
    kern = jax_paged_decode_attention(*(jnp.asarray(a) for a in args), interpret=True)
    oracle = jax_paged_decode_attention_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(_np(got), np.asarray(kern), **F32_TOL)
    np.testing.assert_allclose(_np(got), np.asarray(oracle), **F32_TOL)
    assert paged_decode_attention.launches == before


def test_paged_equals_dense_for_each_sequence(paged_pool):
    q, dense, pool, tbl, lens = paged_pool
    got = paged_decode_attention(*(_t(a) for a in (q, *pool, tbl, lens)))
    for b in range(q.shape[0]):
        one = decode_attention(_t(q[b:b + 1]), *(_t(a[b:b + 1]) for a in dense), int(lens[b]))
        np.testing.assert_allclose(_np(got[b:b + 1]), _np(one), **F32_TOL)


def test_paged_zero_length_returns_zero_as_the_pallas_kernel(paged_pool):
    q, _, pool, tbl, lens = paged_pool
    lens = lens.copy()
    lens[1] = 0
    args = (q, *pool, tbl, lens)
    got = paged_decode_attention(*(_t(a) for a in args))
    kern = jax_paged_decode_attention(*(jnp.asarray(a) for a in args), interpret=True)
    oracle = jax_paged_decode_attention_ref(*(jnp.asarray(a) for a in args))
    assert not got[1].abs().any()
    np.testing.assert_array_equal(np.asarray(kern[1]), 0.0)
    assert float(jnp.max(jnp.abs(oracle[1]))) > 0.05  # the oracle's mean of v
    np.testing.assert_allclose(_np(got[0]), np.asarray(kern[0]), **F32_TOL)


def test_paged_refuses_more_than_one_query_token(paged_pool):
    q, _, pool, tbl, lens = paged_pool
    with pytest.raises(ValueError, match="one query token"):
        paged_decode_attention(_t(np.concatenate([q, q], axis=2)), *(_t(a) for a in (*pool, tbl, lens)))


def test_gather_pages_matches_the_reference(paged_pool):
    _, _, pool, tbl, _ = paged_pool
    np.testing.assert_array_equal(gather_pages(_t(pool[0]), _t(tbl)).numpy(),
                                  np.asarray(jax_gather_pages(jnp.asarray(pool[0]), jnp.asarray(tbl))))


# ---------------------------------------------------------------------------
# the page allocator and the chain layout
# ---------------------------------------------------------------------------


def test_page_allocator_hands_out_the_reference_ids():
    ours, ref = PageAllocator(12, 8), JaxPageAllocator(12, 8)
    script = [("alloc", 3), ("alloc", 4), ("free", [2, 1]), ("alloc", 2), ("free", [5, 6, 7]),
              ("alloc", 5), ("alloc", 1)]
    for op, arg in script:
        if op == "alloc":
            assert ours.alloc(arg) == ref.alloc(arg)
        else:
            ours.free(arg)
            ref.free(arg)
        assert (ours.free_pages, ours.pages_in_use, ours.high_water) == \
            (ref.free_pages, ref.pages_in_use, ref.high_water)
    assert not ours.can_alloc(2) and not ref.can_alloc(2)
    assert ours.alloc_failures == ref.alloc_failures == 1
    with pytest.raises(MemoryError):
        ours.alloc(5)
    with pytest.raises(ValueError, match="double free"):
        ours.free([8]) or ours.free([8])
    with pytest.raises(ValueError, match="never handed out"):
        ours.free([0])
    with pytest.raises(ValueError):
        PageAllocator(1, 8)


@pytest.mark.parametrize("plen,chain", [(13, 2), (16, 2), (1, 3)])
def test_chain_layout_matches_the_reference(plen, chain):
    x = np.random.default_rng(plen).standard_normal((2, 1, 3, plen, 4)).astype(np.float32)
    ref = jax_chain_layout(jnp.asarray(x), 8, chain)
    np.testing.assert_array_equal(chain_layout(_t(x), 8, chain).numpy(), np.asarray(ref))
    i8 = np.clip(np.round(x * 40), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(chain_layout(_t(i8), 8, chain).numpy(),
                                  np.asarray(jax_chain_layout(jnp.asarray(i8), 8, chain)))


# ---------------------------------------------------------------------------
# the shared-memory footprint the lint checks is the one the wrapper launches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,group", [(32, 1), (64, 3), (64, 5), (128, 4)])
def test_lint_rejects_exactly_the_tiles_over_the_smem_limit(d, group):
    for bkv in (8, 64, 128, 512, 1000, 1024, 2048, 4096):
        launch = decode_attention_launch(2, 2 * group, 2, 4096, d, bkv=bkv)
        assert launch.smem_bytes == smem_bytes(bkv, d, group)
        codes = [f.code for f in lint_launch(launch)]
        assert codes == (["KRN002"] if smem_bytes(bkv, d, group) > SMEM_LIMIT_BYTES else [])
    # a tile never runs past the cache, and an empty axis is degenerate
    assert decode_attention_launch(1, group, 1, 100, d, bkv=512).blocks[1] == 100
    assert [f.code for f in lint_launch(decode_attention_launch(0, group, 1, 100, d))] == ["KRN003"]
    paged = decode_attention_launch(4, 2 * group, 2, 2048, d, paged=True, page_size=8)
    assert paged.kernel == "paged_decode_attention" and paged.blocks[1] == 128
    assert not lint_launch(paged)


# ---------------------------------------------------------------------------
# the split-KV plan and merge the CUDA kernels run
# ---------------------------------------------------------------------------


def _split_merge(q, k, v, valid, bkv, splits):
    """A plain emulation of the kernels' split-KV schedule, in fp32: the
    keys are cut into ``splits`` ranges of whole ``bkv`` tiles; each range
    past ``valid`` is empty (max -inf, sum 0); each other range keeps its
    max, sum and unnormalized accumulator; the merge rescales every
    non-empty partial by exp(m_i - M) in split order, and gives 0 where
    every range is empty. q (B, Hq, 1, D); k, v dequantized (B, Hkv, S, D)."""
    b, hq, _, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, d) / math.sqrt(d)
    tiles = -(-skv // bkv)
    per = -(-tiles // splits) * bkv
    m = torch.full((splits, b, hkv, hq // hkv), float("-inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros((splits, b, hkv, hq // hkv, d))
    for i in range(splits):
        lo, hi = i * per, min(i * per + per, valid)
        if hi <= lo:
            continue
        sc = torch.einsum("bhgd,bhkd->bhgk", qg, k[:, :, lo:hi])
        m[i] = sc.amax(-1)
        p = torch.exp(sc - m[i][..., None])
        l[i] = p.sum(-1)
        acc[i] = torch.einsum("bhgk,bhkd->bhgd", p, v[:, :, lo:hi])
    big = m.amax(0)
    out = torch.zeros((b, hkv, hq // hkv, d))
    total = torch.zeros((b, hkv, hq // hkv))
    for i in range(splits):  # split order; an empty split is skipped, never exp(-inf - -inf)
        keep = torch.isfinite(m[i])
        w = torch.where(keep, torch.exp(torch.where(keep, m[i] - big, 0.0)), 0.0)
        total = total + w * l[i]
        out = out + w[..., None] * acc[i]
    out = torch.where(torch.isfinite(big)[..., None], out / torch.where(total > 0, total, 1.0)[..., None], 0.0)
    return out.reshape(b, hq, 1, d)


SPLIT_SHAPES = {  # (b, hq, hkv, skv, d, bkv)
    "smollm": (2, 9, 3, 320, 64, 64),
    "tune-suite": (1, 2, 2, 256, 32, 32),
}


@functools.lru_cache(maxsize=None)
def _split_case(shape, valid):
    b, hq, hkv, skv, d, _ = SPLIT_SHAPES[shape]
    q, k, v, jq, tq = _dense_inputs(b, hq, hkv, skv, d, "float32", seed=skv + valid + hq)
    ki, ks = jax_quantize_kv(jnp.asarray(k))
    vi, vs = jax_quantize_kv(jnp.asarray(v))
    kern = np.asarray(jax_decode_attention(jq, ki, ks, vi, vs, valid, bkv=64, interpret=True))
    cache = tuple(_t(a) for a in (ki, ks, vi, vs))
    return tq, cache, kern


@pytest.mark.parametrize("splits", ["one", "two", "max"])
@pytest.mark.parametrize("where", ["empty", "one key", "split edge", "ragged"])
@pytest.mark.parametrize("shape", sorted(SPLIT_SHAPES))
def test_split_merge_emulation_matches_plain_and_pallas_kernel(shape, where, splits):
    b, hq, hkv, skv, d, bkv = SPLIT_SHAPES[shape]
    tiles = -(-skv // bkv)
    n = {"one": 1, "two": 2, "max": tiles}[splits]
    per = -(-tiles // n) * bkv
    valid = {"empty": 0, "one key": 1, "split edge": per if n > 1 else skv, "ragged": per + 13}[where]
    tq, cache, kern = _split_case(shape, valid)
    k, v = dequantize_kv(*cache[:2]), dequantize_kv(*cache[2:])
    got = _split_merge(tq, k, v, valid, bkv, n)
    rtol, atol = dtype_tol(torch.float32)
    np.testing.assert_allclose(_np(got), _np(decode_attention_ref(tq, *cache, kv_valid_len=valid)),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(_np(got), kern, rtol=rtol, atol=atol)
    if valid == 0:  # every split empty: exact zeros
        assert not got.abs().any()


@pytest.mark.parametrize("b,hkv,skv,bkv", [
    (1, 2, 512, 128), (1, 2, 512, 8), (4, 3, 2048, 128), (4, 3, 2048, 8), (32, 3, 2048, 128),
    (4, 5, 1024, 128), (4, 5, 1024, 1024), (32, 3, 2048, 1), (264, 1, 4096, 64), (1, 1, 100, 7),
    (3, 4, 96, 32), (1, 1, 1, 128),
])
def test_split_plan_takes_whole_tiles_and_fills_the_card(b, hkv, skv, bkv):
    tiles = -(-skv // bkv)
    n = split_plan(b, hkv, skv, bkv, H100_SMS)
    per = -(-tiles // n)  # tiles per split, as the C launch cuts them
    assert 1 <= n <= tiles and per >= 1
    assert (n - 1) * per < tiles  # at full length no split is empty
    if tiles > 1 and b * hkv < 2 * H100_SMS:  # a small batch gets more blocks than (sequence, KV head)s
        assert b * hkv * n > b * hkv
    assert b * hkv * n <= max(b * hkv, 2 * H100_SMS + b * hkv)
    assert split_plan(b, hkv, skv, bkv, H100_SMS) == n  # a pure function of host shapes


def test_split_plan_reads_only_host_shapes(monkeypatch):
    """The wrappers plan from S (dense) or maxp * page (paged) and the card's
    SM count: a length is not an argument of the plan, so a length held on
    the device is never read on the host. An explicit split count is taken
    as it is, within [1, tiles]."""
    from repro_torch.kernels.decode_attention import ops

    assert list(inspect.signature(split_plan).parameters) == ["b", "hkv", "skv", "bkv", "sm_count"]
    monkeypatch.setattr(ops, "sm_count", lambda device: H100_SMS)
    assert ops._splits(None, 4, 3, 2048, 128, "cuda") == split_plan(4, 3, 2048, 128, H100_SMS) == 16
    assert ops._splits(None, 32, 3, 256 * 8, 128, "cuda") == 3  # the paged pool of 32 slots
    assert ops._splits(1, 4, 3, 2048, 128, "cuda") == 1
    assert ops._splits(16, 4, 3, 2048, 128, "cuda") == 16
    for bad in (0, 17):
        with pytest.raises(ValueError, match="splits must be in"):
            ops._splits(bad, 4, 3, 2048, 128, "cuda")


@pytest.mark.parametrize("b,hq,hkv,skv,d,bkv", [
    (4, 9, 3, 2048, 64, 128), (32, 9, 3, 2048, 64, 1024), (4, 25, 5, 1024, 64, 64),
    (1, 2, 2, 512, 32, 8), (2, 32, 2, 700, 128, 256),
])
def test_kernelgeom_mirrors_the_split_grid_and_shared_memory(b, hq, hkv, skv, d, bkv):
    launch = decode_attention_launch(b, hq, hkv, skv, d, bkv=bkv)
    group = hq // hkv
    tile = min(bkv, skv)
    assert launch.grid == (b * hkv * head_chunks(group), split_plan(b, hkv, skv, tile, H100_SMS))
    assert launch.blocks == (1, tile, min(group, GMAX))
    assert launch.smem_bytes == smem_bytes(tile, d, group)
    assert head_chunks(group) == -(-group // GMAX)
    paged = decode_attention_launch(b, hq, hkv, 256 * 8, d, paged=True, page_size=8)
    assert paged.grid == (b * hkv * head_chunks(group), split_plan(b, hkv, 2048, 128, H100_SMS))
    # the shared memory grows with the ring (about bkv keys a block, two chunks a warp at least)
    assert ring_slots(8) == ring_slots(256) == 2 and ring_slots(1024) == 8
    assert smem_bytes(8, d, group) == smem_bytes(256, d, group) < smem_bytes(512, d, group)
    assert smem_bytes(128, d, 8) == smem_bytes(128, d, 40)  # a large group takes head chunks
    assert decode_attention_launch(0, hq, hkv, skv, d).grid[1] == 0  # nothing to launch


def test_cpu_wrappers_take_a_split_count_and_run_the_plain_version(paged_pool):
    q, k, v, _, tq = _dense_inputs(2, 9, 3, 96, 64, "float32", seed=9)
    cache = (*quantize_kv(torch.from_numpy(k)), *quantize_kv(torch.from_numpy(v)))
    before = decode_attention.launches
    a = decode_attention(tq, *cache, 50, splits=3)
    torch.testing.assert_close(a, decode_attention_ref(tq, *cache, kv_valid_len=50), rtol=0, atol=0)
    q, _, pool, tbl, lens = paged_pool
    got = paged_decode_attention(*(_t(x) for x in (q, *pool, tbl, lens)), splits=2)
    torch.testing.assert_close(got, paged_decode_attention_ref(*(_t(x) for x in (q, *pool, tbl, lens))),
                               rtol=0, atol=0)
    assert decode_attention.launches == before
