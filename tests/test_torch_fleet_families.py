"""Fleet serving of every family the reference's fleet engines serve: the SSM
(falcon-mamba), the hybrid (hymba), the MoE (mixtral) and the vision prefix
model (internvl2, text prompts), against the reference package on the CPU.

The reference's ``FleetServeEngine`` refuses no decoding family, and its
``ShardedFleetServeEngine`` refuses SSM and encoder configs; the port's
engines accept the same. Each config at its reduced size, float32; three
chips at fault rates 0, 0.25 and 0.4, each with its own parameters from the
reference's ``init_params`` handed to the port through ``repro_torch.convert``;
prompts made by numpy from a seed and given to both packages.

Tolerances: greedy tokens for equality; logprobs at ``dtype_tol(float32,
atol_scale=50)`` (rtol 2e-5, atol 1e-3) against the reference, as phase 14's
stage (a) holds the fleet on the card, since an SSM's scan and an MoE's
combine sum in another order than the reference's; the port's fleet against
its own per-chip engines at ``dtype_tol(float32)``.

The custom ops' vmap rules are held to a Python loop over the chips: the
masked GEMM's chips x experts form (w (E, K, N) and one mask a chip under
the chip map become one (chips, E, K, N) launch) and the selective scan's
chip axis (the vmapped axis folds into the rows, each chip's a and d read at
its own offset).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_config as jax_reduce_config
from repro.core import from_fault_map as jax_from_fault_map
from repro.core import healthy as jax_healthy
from repro.fleet import FleetServeEngine as JaxFleetServeEngine
from repro.fleet import ShardedFleetServeEngine as JaxShardedFleetServeEngine
from repro.models import model as JM
from repro.serve import ContinuousBatchingEngine as JaxContinuousBatchingEngine
from repro.serve import Request as JaxRequest
from repro_torch.analysis import fleet_kernel_launches, lint_kernels
from repro_torch.configs import get_arch, list_archs, reduce_config
from repro_torch.convert import context_from_ok, params_from_jax
from repro_torch.core import FaultContext, fault_einsum, healthy, random_fault_map
from repro_torch.fleet import FleetServeEngine, ShardedFleetServeEngine
from repro_torch.kernels.common import assert_close
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.masked_matmul import ops as mm_ops
from repro_torch.models import model as M
from repro_torch.serve import ContinuousBatchingEngine, Request, ServeEngine

F32 = torch.float32
RATES = (0.0, 0.25, 0.4)
FAMILIES = ["falcon-mamba-7b", "hymba-1.5b", "mixtral-8x22b", "internvl2-26b"]
PAGED = ["mixtral-8x22b", "internvl2-26b"]  # the sharded engine's: no SSM state
KW = dict(num_slots=2, page_size=4, num_pages=32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast, and
    keeps parallel test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_FLEETS = {}


def _fleet(name):
    """(reference cfg, port cfg, per chip: the reference's params, the
    port's, the fault map or None for the healthy chip 0)."""
    if name not in _FLEETS:
        jcfg, cfg = jax_reduce_config(jax_get_arch(name)), reduce_config(get_arch(name))
        chips = []
        for i, rate in enumerate(RATES):
            jparams, _ = JM.init_params(jcfg, jax.random.PRNGKey(i))
            params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
            fm = None if rate == 0.0 else random_fault_map(i, cfg.array_rows, cfg.array_cols, rate)
            chips.append(dict(jparams=jparams, params=params, fm=fm))
        _FLEETS[name] = jcfg, cfg, chips
    return _FLEETS[name]


def _jctx(fm, mode):
    return jax_healthy() if fm is None else jax_from_fault_map(fm, mode=mode)


def _ctx(fm, mode):
    return healthy() if fm is None else context_from_ok(fm.ok_mask, mode, device="cpu")


def _prompts(cfg, seed=0, shape=(2, 8)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _streams(cfg, n):
    """Per chip: prompts of 5 + c, 7 and 4 tokens with budgets 3 + c, 9 - c
    and 5, the last arriving at dispatch 2 + c (numpy prompts)."""
    rng = np.random.default_rng(7)
    p = lambda n_: rng.integers(0, cfg.vocab_size, n_).astype(np.int32)
    return [[(0, p(5 + c), 3 + c, 0), (1, p(7), 9 - c, 0), (2, p(4), 5, 2 + c)] for c in range(n)]


def _no_vmap_fallback():
    """A vmap fallback (a loop over the chips) warns; the tests make the
    warning an error."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    ctx = warnings.catch_warnings()
    ctx.__enter__()
    warnings.simplefilter("error")
    return ctx


def _restore(ctx):
    ctx.__exit__(None, None, None)
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)


# ---------------------------------------------------------------------------
# FleetServeEngine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jmode", ["fap", "pallas"])  # the port's fap and kernel modes
@pytest.mark.parametrize("name", FAMILIES)
def test_fleet_engine_serves_the_family_as_the_reference(name, jmode):
    jcfg, cfg, chips = _fleet(name)
    prompts = _prompts(cfg)
    ref = JaxFleetServeEngine(
        jcfg, [c["jparams"] for c in chips], [_jctx(c["fm"], jmode) for c in chips], max_len=48
    ).generate(jnp.asarray(prompts), max_new_tokens=6)
    guard = _no_vmap_fallback()
    try:
        got = FleetServeEngine(
            cfg, [c["params"] for c in chips], [_ctx(c["fm"], jmode) for c in chips], max_len=48
        ).generate(prompts, max_new_tokens=6)
    finally:
        _restore(guard)
    assert got.tokens.shape == (len(chips), 2, 8 + 6) and got.logprobs.shape == (len(chips), 2, 6)
    assert np.array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    assert_close(got.logprobs, np.asarray(ref.logprobs), F32, atol_scale=50.0)


@pytest.mark.parametrize("name", FAMILIES)
def test_fleet_chips_match_their_own_serve_engines(name):
    """Each chip of a kernel-mode fleet against its own ``ServeEngine``; the
    faulty chips' tokens differ from the healthy chip's on shared weights."""
    _, cfg, chips = _fleet(name)
    prompts = torch.as_tensor(_prompts(cfg, seed=1))
    ctxs = [_ctx(c["fm"], "pallas") for c in chips]
    out = FleetServeEngine(cfg, [c["params"] for c in chips], ctxs, max_len=48).generate(prompts, max_new_tokens=6)
    for i, c in enumerate(chips):
        ref = ServeEngine(cfg, c["params"], ctxs[i], max_len=48, prefill_buckets=None).generate(
            prompts, max_new_tokens=6)
        toks, lps = out.chip(i)
        assert torch.equal(toks, ref.tokens), f"chip {i}"
        assert_close(lps, ref.logprobs, F32)
    shared = FleetServeEngine(cfg, [chips[0]["params"]] * len(chips), ctxs, max_len=48)
    gen = shared.generate(prompts, max_new_tokens=6).tokens[:, :, 8:]
    assert not torch.equal(gen[0], gen[1]) and not torch.equal(gen[0], gen[2])


@pytest.mark.parametrize("name", ["hymba-1.5b", "mixtral-8x22b"])
def test_fleet_runs_each_kernel_as_one_chip_batched_call(name, monkeypatch):
    """Under the chip map every masked GEMM reaches the plain version once
    with the chip axis (an MoE layer's three expert GEMMs with w (chips, E,
    K, N) and one mask a chip), and each SSM layer's prefill scan once with
    a (chips, D, N): the custom ops' vmap rules, never a loop over chips."""
    _, cfg, chips = _fleet(name)
    gemms, scans = [], []
    mm_ref, scan_ref = mm_ops.masked_matmul_ref, scan_ops.selective_scan_ref

    def mm_spy(x, w, ok):
        gemms.append((w.dim(), ok.dim(), w.shape[0]))
        return mm_ref(x, w, ok)

    def scan_spy(u, dt, a, b, c, d):
        scans.append((tuple(a.shape), tuple(d.shape), u.shape[0]))
        return scan_ref(u, dt, a, b, c, d)

    monkeypatch.setattr(mm_ops, "masked_matmul_ref", mm_spy)
    monkeypatch.setattr(scan_ops, "selective_scan_ref", scan_spy)
    n = len(chips)
    eng = FleetServeEngine(cfg, [c["params"] for c in chips], [_ctx(c["fm"], "pallas") for c in chips], max_len=48)
    guard = _no_vmap_fallback()
    try:
        eng.generate(_prompts(cfg), max_new_tokens=4)
    finally:
        _restore(guard)
    per_step = sum(u for _, _, u in cfg.gemm_shapes())
    experts = 3 * cfg.num_layers if cfg.has_moe else 0
    assert len(gemms) == per_step * (1 + 4)
    assert sum(g == (4, 3, n) for g in gemms) == experts * (1 + 4)
    assert sum(g == (3, 3, n) for g in gemms) == (per_step - experts) * (1 + 4)
    want = [((n, cfg.d_inner, cfg.ssm_state), (n, cfg.d_inner), n * 2)] * cfg.num_layers if cfg.has_ssm else []
    assert scans == want  # the prefill's; decode runs the plain one-step update


def test_fleet_engines_refuse_what_the_reference_refuses():
    enc = reduce_config(get_arch("hubert-xlarge"))
    params = [M.init_params(enc, 0, device="cpu")]
    with pytest.raises(ValueError, match="encoder"):
        FleetServeEngine(enc, params)
    with pytest.raises(ValueError, match="encoder"):
        ShardedFleetServeEngine(enc, params, devices=["cpu"])
    for name in ("falcon-mamba-7b", "hymba-1.5b"):
        ssm = reduce_config(get_arch(name))
        with pytest.raises(ValueError, match="SSM state"):
            ShardedFleetServeEngine(ssm, [M.init_params(ssm, 0, device="cpu")], devices=["cpu"])
        jssm = jax_reduce_config(jax_get_arch(name))
        with pytest.raises(ValueError, match="SSM state"):
            JaxShardedFleetServeEngine(jssm, [JM.init_params(jssm, jax.random.PRNGKey(0))[0]])


# ---------------------------------------------------------------------------
# ShardedFleetServeEngine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PAGED)
def test_sharded_fleet_serves_the_family_as_the_reference(name):
    jcfg, cfg, chips = _fleet(name)
    streams = _streams(cfg, len(chips))
    ref, ref_stats = JaxShardedFleetServeEngine(
        jcfg, [c["jparams"] for c in chips], [_jctx(c["fm"], "fap") for c in chips], **KW
    ).serve([[JaxRequest(*r) for r in s] for s in streams])
    guard = _no_vmap_fallback()
    try:
        got, stats = ShardedFleetServeEngine(
            cfg, [c["params"] for c in chips], [_ctx(c["fm"], "fap") for c in chips], devices=["cpu"], **KW
        ).serve([[Request(*r) for r in s] for s in streams])
    finally:
        _restore(guard)
    assert stats.as_dict() == ref_stats.as_dict()
    for c in range(len(chips)):
        assert set(got[c]) == set(ref[c])
        for rid, r in ref[c].items():
            assert np.array_equal(got[c][rid].tokens, r.tokens), (c, rid)
            assert_close(torch.as_tensor(got[c][rid].logprobs), r.logprobs, F32, atol_scale=50.0)


@pytest.mark.parametrize("mode", ["fap", "pallas"])
@pytest.mark.parametrize("name", PAGED)
def test_sharded_fleet_chips_match_their_own_continuous_engines(name, mode):
    _, cfg, chips = _fleet(name)
    streams = [[Request(*r) for r in s] for s in _streams(cfg, len(chips))]
    ctxs = [_ctx(c["fm"], mode) for c in chips]
    outs, stats = ShardedFleetServeEngine(
        cfg, [c["params"] for c in chips], ctxs, devices=["cpu"], **KW).serve(streams)
    for c, chip in enumerate(chips):
        ref, _ = ContinuousBatchingEngine(cfg, chip["params"], ctxs[c], **KW).serve(streams[c])
        assert set(outs[c]) == set(ref)
        for rid in ref:
            assert np.array_equal(outs[c][rid].tokens, ref[rid].tokens), (c, rid)
            assert_close(torch.as_tensor(outs[c][rid].logprobs), ref[rid].logprobs, F32)
    assert stats.decode_dispatches < sum(len(r.tokens) for s in streams for r in s)


@pytest.mark.parametrize("chip", [0, 1])
def test_mixtral_continuous_engine_past_the_window_matches_reference(chip):
    """The reference's sliding-window case (tests/test_serve_continuous.py):
    a reduced mixtral prompt longer than the window and one shorter, its
    prompts drawn as that test draws them, through the port's
    ``ContinuousBatchingEngine`` against the reference's: the healthy chip 0
    on the reference test's own parameters (``PRNGKey(0)``), where the test
    also pins the static engine, and the faulty chip 1 in kernel mode."""
    jcfg, cfg, chips = _fleet("mixtral-8x22b")
    assert cfg.sliding_window and cfg.sliding_window < 40
    key = jax.random.PRNGKey(0)
    prompt = lambda seed, n: np.array(jax.random.randint(jax.random.fold_in(key, seed), (n,), 0, cfg.vocab_size))
    reqs = [(0, prompt(80, 40), 6, 0), (1, prompt(81, 12), 8, 0)]
    kw = dict(num_slots=2, page_size=8, num_pages=32)
    fm = chips[chip]["fm"]
    ref, ref_stats = JaxContinuousBatchingEngine(jcfg, chips[chip]["jparams"], _jctx(fm, "pallas"), **kw).serve(
        [JaxRequest(*r) for r in reqs])
    ctx = _ctx(fm, "pallas")
    got, stats = ContinuousBatchingEngine(cfg, chips[chip]["params"], ctx, **kw).serve([Request(*r) for r in reqs])
    assert stats.as_dict() == ref_stats.as_dict()
    for rid, prompt_, budget, _ in reqs:
        assert np.array_equal(got[rid].tokens, ref[rid].tokens), rid
        assert_close(torch.as_tensor(got[rid].logprobs), ref[rid].logprobs, F32)
    if chip == 0:
        static = ServeEngine(cfg, chips[chip]["params"], ctx, max_len=None, page_size=8)
        for rid, prompt_, budget, _ in reqs:
            want = static.generate(torch.as_tensor(prompt_)[None], max_new_tokens=budget).tokens[0, len(prompt_):]
            assert np.array_equal(got[rid].tokens, want.numpy()), rid


# ---------------------------------------------------------------------------
# the custom ops' vmap rules, against a loop over the chips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shared_ok", [False, True])
@pytest.mark.parametrize("spec", ["ecd,edf->ecf", "ecf,efd->ecd"])
def test_chips_x_experts_vmap_rule_is_the_loop_over_chips(spec, shared_ok, monkeypatch):
    """``fault_einsum``'s expert specs in kernel mode under ``vmap`` over 3
    chips (each its own experts, a mask a chip or one for all): ONE call of
    the masked GEMM with w (chips, E, K, N), equal to a loop of each chip's
    expert call."""
    g = np.random.default_rng(3)
    chips, e, c, k, n = 3, 4, 5, 24, 40
    x = torch.as_tensor(g.standard_normal((chips, e, c, k)), dtype=F32)
    w = torch.as_tensor(g.standard_normal((chips, e, k, n)), dtype=F32)
    ok = torch.stack([torch.as_tensor(random_fault_map(i, 16, 16, 0.3).ok_mask, dtype=F32) for i in range(chips)])
    calls = []
    ref = mm_ops.masked_matmul_ref

    def spy(x_, w_, ok_):
        calls.append((tuple(w_.shape), tuple(ok_.shape)))
        return ref(x_, w_, ok_)

    monkeypatch.setattr(mm_ops, "masked_matmul_ref", spy)
    if shared_ok:
        got = torch.func.vmap(lambda x_, w_: fault_einsum(spec, x_, w_, FaultContext(ok[1], "kernel")))(x, w)
    else:
        got = torch.func.vmap(lambda x_, w_, o_: fault_einsum(spec, x_, w_, FaultContext(o_, "kernel")))(x, w, ok)
    assert calls == [((chips, e, k, n), (chips, 16, 16))]
    calls.clear()
    for i in range(chips):
        mask = ok[1] if shared_ok else ok[i]
        assert torch.equal(got[i], fault_einsum(spec, x[i], w[i], FaultContext(mask, "kernel")))
    assert calls == [((e, k, n), (16, 16))] * chips


def test_masked_matmul_ref_takes_chips_x_experts():
    """The plain version's (chips, E, K, N) form: chip c's experts under chip
    c's mask."""
    g = np.random.default_rng(5)
    x = torch.as_tensor(g.standard_normal((2, 3, 4, 24)), dtype=F32)
    w = torch.as_tensor(g.standard_normal((2, 3, 24, 40)), dtype=F32)
    ok = torch.stack([torch.as_tensor(random_fault_map(i, 16, 16, 0.3).ok_mask, dtype=F32) for i in range(2)])
    got = mm_ops.masked_matmul_ref(x, w, ok)
    for c in range(2):
        for e in range(3):
            assert torch.equal(got[c, e], mm_ops.masked_matmul_ref(x[c, e], w[c, e], ok[c]))


def _scan_args(chips, b, l, d, n, seed=0):
    g = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(g.standard_normal(s), dtype=F32)
    u, b_, c_ = t(chips, b, l, d), t(chips, b, l, n), t(chips, b, l, n)
    dt = torch.nn.functional.softplus(t(chips, b, l, d) - 3.0)
    a, dsk = -torch.exp(t(chips, d, n)), t(chips, d)
    return u, dt, a, b_, c_, dsk


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("chips", [1, 2, 4])
def test_chip_batched_scan_vmap_rule_is_the_loop_over_chips(chips, shared, monkeypatch):
    """``selective_scan`` under ``vmap`` over the chips: ONE call of the plain
    version over chips x B rows with a (chips, D, N) and d (chips, D) (a
    shared a and d read with chip stride 0), equal to a loop of each chip's
    own scan."""
    u, dt, a, b, c, d = _scan_args(chips, 2, 9, 6, 4, seed=chips)
    calls = []
    ref = scan_ops.selective_scan_ref

    def spy(*args):
        calls.append((args[0].shape[0], tuple(args[2].shape), args[2].stride(0) if chips > 1 else None))
        return ref(*args)

    monkeypatch.setattr(scan_ops, "selective_scan_ref", spy)
    if shared:
        y, h = torch.func.vmap(lambda u_, dt_, b_, c_: scan_ops.selective_scan(u_, dt_, a[0], b_, c_, d[0]))(
            u, dt, b, c)
        a, d = a[0].expand(chips, 6, 4), d[0].expand(chips, 6)
    else:
        y, h = torch.func.vmap(scan_ops.selective_scan)(u, dt, a, b, c, d)
    assert calls == [(chips * 2, (chips, 6, 4), None if chips == 1 else 0 if shared else 24)]
    assert y.shape == (chips, 2, 9, 6) and h.shape == (chips, 2, 6, 4)
    for i in range(chips):
        y_i, h_i = ref(u[i], dt[i], a[i], b[i], c[i], d[i])
        assert_close(y[i], y_i, F32)
        assert_close(h[i], h_i, F32)


def test_chip_batched_scan_ref_is_each_chips_scan():
    u, dt, a, b, c, d = _scan_args(3, 2, 7, 5, 3, seed=9)
    y, h = scan_ops.selective_scan_ref(u.flatten(0, 1), dt.flatten(0, 1), a, b.flatten(0, 1), c.flatten(0, 1), d)
    for i in range(3):
        y_i, h_i = scan_ops.selective_scan_ref(u[i], dt[i], a[i], b[i], c[i], d[i])
        assert torch.equal(y[2 * i:2 * i + 2], y_i) and torch.equal(h[2 * i:2 * i + 2], h_i)


def test_chip_batched_scan_keeps_the_plan_and_counts_nothing_on_the_host():
    """A chip-batched launch keeps ``scan_plan``'s lanes over every chip's
    rows, whatever the tuning cache holds for that key (the key has no chip
    field): ``tests/test_torch_cuda.py::test_the_cache_steers_each_wrapper_
    on_the_card`` holds that on the card. Here: the host runs the plain
    version and counts no launch."""
    launches, fleet = scan_ops.selective_scan.launches, scan_ops.selective_scan.fleet_launches
    scan_ops.selective_scan(*(t.flatten(0, 1) if t.dim() == 4 else t for t in _scan_args(2, 2, 5, 4, 3)))
    assert (scan_ops.selective_scan.launches, scan_ops.selective_scan.fleet_launches) == (launches, fleet)


# ---------------------------------------------------------------------------
# the lint over a fleet's launches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_fleet_launches_lint_clean_at_the_heuristics(arch):
    """Every config's chip-batched launches (the decode GEMM, an MoE's chips x
    experts GEMMs, an SSM's chip-batched scan) at 4 and 8 chips: no finding."""
    cfg = get_arch(arch)
    for chips in (4, 8):
        launches = fleet_kernel_launches(cfg, chips)
        findings, _ = lint_kernels(launches)
        assert findings == []
        kinds = [launch.kernel for launch in launches]
        if cfg.is_encoder:
            assert kinds == []
            continue
        want = ["masked_matmul"] * (1 + 2 * cfg.has_moe) + ["mamba_scan"] * cfg.has_ssm
        assert kinds == want
        if cfg.has_moe:
            assert launches[1].grid[1] == chips * cfg.num_experts
        if cfg.has_ssm:
            assert launches[-1].grid == (scan_ops.scan_plan(chips * 4, cfg.d_inner, cfg.ssm_state, 132).blocks,)



def test_the_lint_covers_the_chips_x_experts_gemm_and_the_chip_batched_scan():
    """The builders' chip axes are the wrappers' plans over chips x experts
    and chips x rows; what the wrappers refuse there is KRN001."""
    from repro_torch.analysis import lint_launch, mamba_scan_launch, masked_matmul_launch

    both = masked_matmul_launch(8, 6144, 16384, (256, 256), dtype="bfloat16", chips=2, experts=8)
    assert both.grid == mm_ops.gemm_plan("decode", 8, 16384, 6144, 132, 16).grid and lint_launch(both) == []
    cap = mm_ops.max_splits("decode", 8, 6144)
    refused = masked_matmul_launch(8, 6144, 16384, (256, 256), dtype="bfloat16", chips=2, experts=8, splits=cap + 1)
    assert [f.code for f in lint_launch(refused)] == ["KRN001"]
    scan = mamba_scan_launch(4, 128, 3200, 16, chips=4)
    assert scan.grid == (scan_ops.scan_plan(16, 3200, 16, 132).blocks,) and lint_launch(scan) == []
    assert [f.code for f in lint_launch(mamba_scan_launch(4, 128, 3200, 16, chips=4, lanes=1))] == ["KRN001"]
