"""The port's continuous-batching slice against the reference package: the
bucketing arrays, page sizing, the packed / chunked / paged model
functions, the ``active`` mask of the masked decode step, and
``ContinuousBatchingEngine`` on skewed traffic.

Inputs are made by numpy from a seed and handed to both packages; the
reference's parameters reach the port through ``repro_torch.convert``. Both
sides run the reduced SmolLM (two layers, float32) on the CPU.

Tolerances: the host-side arrays and every count are compared for
equality; logits, hidden states, KV and logprobs at ``dtype_tol(float32)``
(rtol 2e-5, atol 2e-4), since the two packages differ only in summation
order; greedy tokens for equality.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_config as jax_reduce_config
from repro.core.masking import FaultContext as JaxFaultContext
from repro.models import model as JM
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import bucketing as jax_bucketing
from repro.serve import kvcache as jax_kvcache
from repro.serve.engine import make_sample_decode as jax_make_sample_decode
from repro_torch.configs import get_arch, reduce_config
from repro_torch.convert import context_from_ok, params_from_jax
from repro_torch.core import random_fault_map
from repro_torch.kernels.common import assert_close
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as M
from repro_torch.serve import ContinuousBatchingEngine, Request, ServeEngine, make_sample_decode
from repro_torch.serve import bucketing, kvcache

F32 = torch.float32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast, and
    keeps parallel test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(window=None):
    jcfg = jax_reduce_config(jax_get_arch("smollm-135m"))
    cfg = reduce_config(get_arch("smollm-135m"))
    if window:
        jcfg = dataclasses.replace(jcfg, sliding_window=window)
        cfg = dataclasses.replace(cfg, sliding_window=window)
    jparams, _ = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg, jparams, params = _pair()
    ok = random_fault_map(0, cfg.array_rows, cfg.array_cols, 0.2).ok_mask
    return jcfg, cfg, jparams, params, ok


@pytest.fixture(scope="module")
def swa_setup():
    return _pair(window=16)


def _ctxs(ok, mode):
    jctx = JaxFaultContext(ok=None if mode == "none" else jnp.asarray(ok), mode=mode)
    return jctx, context_from_ok(ok, mode, device="cpu")


def _t(a, dtype=torch.int64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _prompt(rng, cfg, n):
    return rng.integers(0, cfg.vocab_size, n).astype(np.int32)


# ---------------------------------------------------------------------------
# Bucketing and sizing: the same host arrays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("buckets", [None, (8, 16), (32, 64, 128, 256)])
@pytest.mark.parametrize("chunk", [8, 16, 256])
def test_plan_prefill_matches_reference(buckets, chunk):
    for plen in [1, 2, 7, 8, 9, 15, 16, 17, 31, 33, 40, 255, 256, 257, 300, 513, 700]:
        ref = jax_bucketing.plan_prefill(plen, buckets=buckets, chunk_size=chunk)
        got = bucketing.plan_prefill(plen, buckets=buckets, chunk_size=chunk)
        assert [dataclasses.astuple(s) for s in got] == [dataclasses.astuple(s) for s in ref]
    with pytest.raises(ValueError):
        bucketing.plan_prefill(0, buckets=buckets, chunk_size=chunk)


@pytest.mark.parametrize("lens,bucket,max_pack,page", [
    ((3,), 8, 1, 4),
    ((3, 5), 8, 2, 4),
    ((6, 1, 4, 2), 16, 4, 4),
    ((7, 9), 16, 4, 8),
    ((30, 60, 20, 100), 256, 4, 8),
    ((128,), 128, 4, 8),
])
def test_build_pack_matches_reference(lens, bucket, max_pack, page):
    rng = np.random.default_rng(sum(lens))
    maxp, slots, pages, next_page = 20, 6, [], 1
    for n in lens:
        chain = -(-(n + 5) // page)
        pages.append(tuple(range(next_page, next_page + chain)))
        next_page += chain
    tokens = [rng.integers(0, 97, n).astype(np.int32) for n in lens]
    kw = dict(bucket=bucket, max_pack=max_pack, page_size=page, max_pages_per_seq=maxp,
              num_slots=slots, pad_id=3)
    ref = jax_bucketing.build_pack(
        [jax_bucketing.PackItem(t, 5 - i, p, 5 + i, rid=i) for i, (t, p) in enumerate(zip(tokens, pages))], **kw
    )
    got = bucketing.build_pack(
        [bucketing.PackItem(t, 5 - i, p, 5 + i, rid=i) for i, (t, p) in enumerate(zip(tokens, pages))], **kw
    )
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype == np.int32, key
        assert np.array_equal(got[key], ref[key]), key


def test_build_pack_refuses_what_the_reference_refuses():
    item = bucketing.PackItem(np.zeros(9, np.int32), 0, (1, 2), 1)
    kw = dict(page_size=8, max_pages_per_seq=4, num_slots=2)
    with pytest.raises(ValueError, match="exceed bucket"):
        bucketing.build_pack([item], bucket=8, max_pack=2, **kw)
    with pytest.raises(ValueError, match="pack holds"):
        bucketing.build_pack([item, item], bucket=32, max_pack=1, **kw)


@pytest.mark.parametrize("page", [4, 8])
@pytest.mark.parametrize("plen,chunk", [(40, 8), (513, 256), (300, 256), (17, 16)])
def test_chunk_step_maps_match_reference(plen, chunk, page):
    chain = tuple(range(7, 7 + -(-(plen + 3) // page)))[::-1]
    for ref_step, got_step in zip(
        jax_bucketing.plan_prefill(plen, buckets=(chunk,), chunk_size=chunk),
        bucketing.plan_prefill(plen, buckets=(chunk,), chunk_size=chunk),
    ):
        ref = jax_bucketing.chunk_step_maps(ref_step, chain, page_size=page)
        got = bucketing.chunk_step_maps(got_step, chain, page_size=page)
        for key in ref:
            assert got[key].dtype == np.int32 and np.array_equal(got[key], ref[key]), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page", [1, 4, 8, 16])
@pytest.mark.parametrize("name", ["smollm-135m", "hymba-1.5b"])
def test_page_bytes_match_reference(name, page, dtype):
    from repro.configs import get_arch as jget

    cfg = dataclasses.replace(get_arch(name), dtype=dtype)
    jcfg = dataclasses.replace(jget(name), dtype=dtype)
    assert kvcache.page_bytes(cfg, page) == jax_kvcache.page_bytes(jcfg, page)
    assert kvcache.dense_kv_bytes(cfg, 3, 100) == jax_kvcache.dense_kv_bytes(jcfg, 3, 100)
    if name == "smollm-135m" and page == 8:  # one 8-token page of SmolLM-135M
        assert kvcache.page_bytes(cfg, page) == {"bfloat16": 184_320, "float32": 368_640}[dtype]


# ---------------------------------------------------------------------------
# Model functions: packed prefill, chunked prefill, paged decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["none", "fap", "pallas"])
@pytest.mark.parametrize("case", ["packed", "padded", "hidden"])
def test_prefill_options_match_reference(setup, mode, case):
    """``full_kv``, ``return_hidden`` and ``segments``: the hidden states and
    KV of real tokens (pad rows are not compared: no caller reads them)."""
    jcfg, cfg, jparams, params, ok = setup
    jctx, ctx = _ctxs(ok, mode)
    rng = np.random.default_rng(3)
    if case == "packed":
        items = [(_prompt(rng, cfg, n), (1 + 2 * i, 2 + 2 * i)) for i, n in enumerate((5, 1, 7))]
        arrays = jax_bucketing.build_pack(
            [jax_bucketing.PackItem(t, i, p, 4) for i, (t, p) in enumerate(items)],
            bucket=16, max_pack=4, page_size=8, max_pages_per_seq=4, num_slots=4,
        )
        batch = {k: arrays[k] for k in ("tokens", "positions")}
        kw = dict(full_kv=True, return_hidden=True, attn_impl="dense")
        jkw, pkw = dict(kw, segments=jnp.asarray(arrays["segments"])), dict(kw, segments=_t(arrays["segments"]))
        real = arrays["segments"][0] > 0
    else:
        batch = {"tokens": np.concatenate([_prompt(rng, cfg, 11), np.zeros(5, np.int32)])[None]}
        kw = dict(full_kv=True, valid_len=11) if case == "padded" else dict(return_hidden=True)
        jkw, pkw = kw, kw
        real = np.arange(16) < (11 if case == "padded" else 16)
    ref, jc = JM.prefill(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, jctx, **jkw)
    got, pc = M.prefill(params, {k: _t(v) for k, v in batch.items()}, cfg, ctx, **pkw)
    if case == "padded":
        assert_close(got, np.asarray(ref), F32)
        assert pc["index"] == int(jc["index"]) == 11
    else:
        assert got.shape == ref.shape
        assert_close(got[:, real], np.asarray(ref)[:, real], F32)
    if "full_kv" in kw:
        for key in ("k", "v"):
            assert pc[key].shape == jc[key].shape
            assert_close(pc[key][..., real, :], np.asarray(jc[key])[..., real, :], F32)


@pytest.mark.parametrize("mode", ["none", "fap"])
@pytest.mark.parametrize("window", [None, 16])
def test_prefill_chunk_matches_reference(setup, swa_setup, mode, window):
    """A 40-token prompt streamed in chunks of 8 into a page chain: each
    chunk's logits and KV against the reference's; with a 16-token window
    the later chunks cross it, and the first chunk's keys are outside it."""
    jcfg, cfg, jparams, params = swa_setup if window else setup[:4]
    ok = setup[4]
    jctx, ctx = _ctxs(ok, mode)
    page, chunk, plen, maxp, pool_pages = 4, 8, 40, 12, 16
    L, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(4)
    prompt = _prompt(rng, cfg, plen)
    chain = list(rng.permutation(np.arange(1, pool_pages))[:11])
    row = np.zeros(maxp, np.int32)
    row[: len(chain)] = chain
    # garbage in every page the chain does not reach yet: only valid keys may count
    pool0 = rng.standard_normal((2, L, pool_pages, hkv, page, hd)).astype(np.float32)
    jk, jv = jnp.asarray(pool0[0]), jnp.asarray(pool0[1])
    pk, pv = torch.tensor(pool0[0]), torch.tensor(pool0[1])
    for step in bucketing.plan_prefill(plen, buckets=(chunk,), chunk_size=chunk):
        toks = np.zeros(chunk, np.int32)
        toks[: step.valid] = prompt[step.start : step.start + step.valid]
        ref = JM.prefill_chunk(
            jparams, jnp.asarray(toks[None]), jcfg, jctx, k_pages=jk, v_pages=jv,
            row=jnp.asarray(row), prefix_len=step.start, valid_len=step.valid,
        )
        got = M.prefill_chunk(
            params, _t(toks[None]), cfg, ctx, k_pages=pk, v_pages=pv, row=_t(row),
            prefix_len=step.start, valid_len=step.valid,
        )
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            assert_close(g, np.asarray(r), F32)
        maps = bucketing.chunk_step_maps(step, chain, page_size=page)
        ix, off = maps["page_ix"], maps["page_off"]
        jk = jk.at[:, ix, :, off].set(jnp.transpose(ref[1][:, 0], (2, 0, 1, 3)))
        jv = jv.at[:, ix, :, off].set(jnp.transpose(ref[2][:, 0], (2, 0, 1, 3)))
        pk[:, _t(ix), :, _t(off)] = got[1][:, 0].permute(2, 0, 1, 3)
        pv[:, _t(ix), :, _t(off)] = got[2][:, 0].permute(2, 0, 1, 3)


def _paged_cache(cfg, rng, lens, tables, pages=24, page=4):
    L, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    pool = rng.standard_normal((2, L, pages, hkv, page, hd)).astype(np.float32)
    return dict(k_pages=pool[0], v_pages=pool[1], block_tables=np.asarray(tables, np.int32),
                seq_lens=np.asarray(lens, np.int32))


@pytest.mark.parametrize("mode", ["none", "fap", "pallas"])
@pytest.mark.parametrize("active", [None, (True, False, True, False)])
def test_decode_step_paged_matches_reference(setup, mode, active):
    """``_decode_step_paged`` through ``decode_step``: the logits, the pool
    (but page 0, the scratch page, whose duplicate writes the reference
    leaves undefined) and the lengths after three steps."""
    jcfg, cfg, jparams, params, ok = setup
    jctx, ctx = _ctxs(ok, mode)
    rng = np.random.default_rng(5)
    # ragged lengths: mid-page, at a page edge, one token, and an empty slot
    tables = [[3, 7, 9, 0, 0], [4, 0, 0, 0, 0], [11, 2, 5, 6, 0], [8, 10, 0, 0, 0]]
    host = _paged_cache(cfg, rng, [6, 1, 12, 0], tables)
    jcache = {k: jnp.asarray(v) for k, v in host.items()}
    pcache = {k: torch.tensor(v) for k, v in host.items()}
    jact = None if active is None else jnp.asarray(active)
    pact = None if active is None else torch.tensor(active)
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)
        ref, jcache = JM.decode_step(jparams, jnp.asarray(toks), jcache, jcfg, jctx, active=jact)
        got, pcache = M.decode_step(params, _t(toks), pcache, cfg, ctx, active=pact)
        assert_close(got, np.asarray(ref), F32)
    assert np.array_equal(pcache["seq_lens"].numpy(), np.asarray(jcache["seq_lens"]))
    assert np.array_equal(pcache["block_tables"].numpy(), np.asarray(jcache["block_tables"]))
    for key in ("k_pages", "v_pages"):
        assert_close(pcache[key][:, 1:], np.asarray(jcache[key])[:, 1:], F32)


@pytest.mark.parametrize("mode", ["fap", "pallas"])
def test_retired_slot_writes_scratch_not_a_readmitted_chain(setup, mode):
    """The masked decode step forwards the new active mask: a retired slot,
    whose block table still names pages the allocator has re-admitted to
    another slot, writes its token to scratch page 0 and does not advance,
    so the new owner's tokens and page contents are the reference's.
    Without the mask the retired slot's tokens land on slot 0's prompt."""
    jcfg, cfg, jparams, params, ok = setup
    jctx, ctx = _ctxs(ok, mode)
    rng = np.random.default_rng(6)
    page, prompt = 4, _prompt(rng, cfg, 3)
    # slot 1 retired holding one token on page 5; slot 0 was then admitted
    # into pages 5 and 6 with a 3-token prompt. Slot 1's next writes would
    # be page 5, offsets 1 and 2: slot 0's prompt, which every step reads
    logits, dense = JM.prefill(jparams, {"tokens": jnp.asarray(prompt[None])}, jcfg, jctx, full_kv=True)
    host = _paged_cache(cfg, rng, [3, 1], [[5, 6, 0], [5, 6, 0]], pages=8, page=page)
    host["k_pages"][:, 5, :, :3] = np.asarray(dense["k"])[:, 0]
    host["v_pages"][:, 5, :, :3] = np.asarray(dense["v"])[:, 0]
    cur = np.stack([np.asarray(logits[0]), rng.standard_normal(cfg.vocab_size).astype(np.float32)])
    jstep, step = jax_make_sample_decode(jcfg), make_sample_decode(cfg)
    jc = {k: jnp.asarray(v) for k, v in host.items()}
    pc = {k: torch.tensor(v) for k, v in host.items()}
    jl, pl = jnp.asarray(cur), torch.tensor(cur)
    jact, act = jnp.asarray([True, False]), torch.tensor([True, False])
    jrem, rem = jnp.asarray([6, 0], jnp.int32), torch.tensor([6, 0], dtype=torch.int32)
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    for _ in range(5):
        jt, jlp, jl, jc, key, jact, jrem = jstep(
            jparams, jl, jc, key, jctx, jnp.float32(0.0), jact, jnp.int32(-1), jrem
        )
        t, lp, pl, pc, act, rem = step(params, pl, pc, gen, ctx, 0.0, act, None, rem)
        assert np.array_equal(t.numpy(), np.asarray(jt))
        assert_close(lp, np.asarray(jlp), F32)
    assert np.array_equal(pc["seq_lens"].numpy(), np.asarray(jc["seq_lens"])) and pc["seq_lens"][1] == 1
    for key in ("k_pages", "v_pages"):
        assert_close(pc[key][:, 5:7], np.asarray(jc[key])[:, 5:7], F32)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _trace(cfg, seed=0):
    """Skewed traffic: a packable burst at 0, two prompts past the top
    bucket (chunked), mid-flight arrivals that refill retired slots."""
    rng = np.random.default_rng(seed)
    spec = [  # (prompt length, budget, arrival)
        (6, 5, 0), (13, 4, 0), (40, 6, 0), (3, 5, 2), (5, 4, 0), (21, 7, 3), (9, 3, 5),
        (2, 9, 5), (17, 2, 9), (7, 6, 14),
    ]
    return [(i, _prompt(rng, cfg, n), b, a) for i, (n, b, a) in enumerate(spec)]


ENGINES = {
    # (engine options, fault mode, warmup)
    "packed-chunked": (dict(num_slots=2, page_size=4, num_pages=64, prefill_buckets=(8, 16),
                            chunk_size=8, max_pack=2), "fap", False),
    "wide-pack-warm": (dict(num_slots=3, page_size=4, num_pages=64, prefill_buckets=(8, 16, 32),
                            chunk_size=16, max_pack=4), "pallas", True),
    "unbucketed": (dict(num_slots=2, page_size=8, num_pages=32, prefill_buckets=None), "none", False),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_matches_reference(setup, name):
    jcfg, cfg, jparams, params, ok = setup
    kw, mode, warm = ENGINES[name]
    jctx, ctx = _ctxs(ok, mode)
    trace = _trace(cfg)
    jeng, eng = JaxEngine(jcfg, jparams, jctx, **kw), ContinuousBatchingEngine(cfg, params, ctx, **kw)
    if warm:
        assert eng.warmup() == jeng.warmup() == len(kw["prefill_buckets"]) + 2
    ref, rstats = jeng.serve([JaxRequest(*r) for r in trace])
    got, stats = eng.serve([Request(*r) for r in trace])
    assert sorted(got) == sorted(ref) == list(range(len(trace)))
    for rid in ref:
        g, r = got[rid], ref[rid]
        assert np.array_equal(g.tokens, r.tokens), rid
        assert_close(g.logprobs, r.logprobs, F32)
        assert (g.admitted_step, g.finished_step, g.finish_reason, g.queue_wait_steps) == (
            r.admitted_step, r.finished_step, r.finish_reason, r.queue_wait_steps)
        assert np.isfinite(g.ttft_wall_s)
    assert stats.as_dict() == rstats.as_dict()
    assert stats.chunk_dispatches > 0 or kw["prefill_buckets"] is None
    assert eng.used_programs == jeng.used_programs
    assert eng.compile_counts() == jeng.compile_counts()
    if warm:
        assert eng.compile_counts()["jit_fallback"] == 0


def test_engine_pinned_to_static_engine(setup):
    """Every request, the packed, chunked and mid-flight ones too, gives the
    tokens of a per-request ``ServeEngine`` run with the same budget."""
    _, cfg, _, params, ok = setup
    ctx = context_from_ok(ok, "fap", device="cpu")
    kw, _, _ = ENGINES["packed-chunked"]
    trace = _trace(cfg, seed=1)
    outs, stats = ContinuousBatchingEngine(cfg, params, ctx, **kw).serve([Request(*r) for r in trace])
    static = ServeEngine(cfg, params, ctx, max_len=None, page_size=4)
    for rid, prompt, budget, _ in trace:
        res = static.generate(_t(prompt[None]), max_new_tokens=budget)
        assert np.array_equal(outs[rid].tokens, res.tokens[0, len(prompt):].numpy()), rid
        assert_close(outs[rid].logprobs, res.logprobs[0], F32)
    assert stats.admitted == len(trace) and stats.decode_dispatches < sum(r[2] for r in trace)


def test_sliding_window_prompt_spanning_chunks_matches_both(setup, swa_setup):
    """A 40-token prompt over a 16-token window, streamed in chunks of 8: the
    reference engine's tokens and the port's static engine's."""
    jcfg, cfg, jparams, params = swa_setup
    kw = dict(num_slots=2, page_size=8, num_pages=32, prefill_buckets=(8, 16), chunk_size=8)
    rng = np.random.default_rng(7)
    trace = [(0, _prompt(rng, cfg, 40), 6, 0), (1, _prompt(rng, cfg, 12), 8, 0)]
    got, stats = ContinuousBatchingEngine(cfg, params, **kw).serve([Request(*r) for r in trace])
    ref, _ = JaxEngine(jcfg, jparams, **kw).serve([JaxRequest(*r) for r in trace])
    assert stats.chunk_dispatches == 5
    static = ServeEngine(cfg, params, max_len=None, page_size=8)
    for rid, prompt, budget, _ in trace:
        assert np.array_equal(got[rid].tokens, ref[rid].tokens), rid
        res = static.generate(_t(prompt[None]), max_new_tokens=budget)
        assert np.array_equal(got[rid].tokens, res.tokens[0, len(prompt):].numpy()), rid


def test_engine_eos_and_temperature(setup):
    _, cfg, _, params, _ = setup
    kw, _, _ = ENGINES["packed-chunked"]
    trace = [Request(*r) for r in _trace(cfg, seed=2)]
    eng = ContinuousBatchingEngine(cfg, params, **kw)
    greedy, _ = eng.serve(trace)
    eos = int(greedy[2].tokens[1])  # request 2 then stops at its second token
    outs, _ = eng.serve(trace, eos_id=eos)
    assert outs[2].finish_reason == "eos" and outs[2].tokens[-1] == eos
    assert all(o.finish_reason == "eos" or len(o.tokens) == r.max_new_tokens
               for o, r in zip((outs[r.rid] for r in trace), trace))
    a, _ = eng.serve(trace, temperature=1.0, seed=1)
    b, _ = eng.serve(trace, temperature=1.0, seed=1)
    c, _ = eng.serve(trace, temperature=1.0, seed=2)
    assert all(np.array_equal(a[i].tokens, b[i].tokens) for i in a)
    assert not all(np.array_equal(a[i].tokens, c[i].tokens) for i in a)
    assert all(np.isfinite(a[i].logprobs).all() and (a[i].logprobs <= 0).all() for i in a)


def test_engine_validates(setup):
    _, cfg, _, params, _ = setup
    with pytest.raises(ValueError, match="attention"):
        ContinuousBatchingEngine(reduce_config(get_arch("falcon-mamba-7b")), params)
    with pytest.raises(ValueError, match="multiple of page_size"):
        ContinuousBatchingEngine(cfg, params, page_size=8, chunk_size=12)
    eng = ContinuousBatchingEngine(cfg, params, num_slots=1, page_size=4, num_pages=4)
    rng = np.random.default_rng(8)
    with pytest.raises(ValueError, match="pages"):
        eng.serve([Request(0, _prompt(rng, cfg, 30), max_new_tokens=30)])
    with pytest.raises(ValueError, match="duplicate"):
        eng.serve([Request(0, _prompt(rng, cfg, 4), 2), Request(0, _prompt(rng, cfg, 4), 2)])
    outs, st = eng.serve([])
    assert outs == {} and st.decode_dispatches == 0
    with pytest.raises(ValueError, match="bucketed"):
        ContinuousBatchingEngine(cfg, params, prefill_buckets=None).warmup()


def test_serve_cli_continuous_with_probes_on_cpu(tmp_path, capsys):
    import json

    health, trace = tmp_path / "health.json", tmp_path / "trace.json"
    serve_cli.main([
        "--arch", "smollm-135m", "--reduced", "--device", "cpu", "--fault-rate", "0.1",
        "--fault-mode", "kernel", "--batch", "3", "--prompt-len", "8", "--new-tokens", "8",
        "--continuous", "--warmup", "--probe-every", "2", "--health-out", str(health),
        "--trace-out", str(trace),
    ])
    out = capsys.readouterr().out
    assert "warmup: 6 programs" in out and "first run in traffic=0" in out
    assert "health=healthy" in out
    summary = json.loads(health.read_text())
    # the detection rules stay quiet; the TTFT SLO rule reads wall time
    assert summary["health"]["detections"] == 0
    assert not [a for a in summary["alerts"]["fired"] if a.startswith(("health.", "detect."))]
    from repro.obs import validate_chrome_trace

    assert validate_chrome_trace(str(trace)) == []
