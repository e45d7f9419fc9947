"""The port's fleet serving against the reference package: ``FleetServeEngine``
(one shared prompt batch, the whole fleet a token per dispatch) and
``ShardedFleetServeEngine`` (one ragged request stream, slot table and paged
KV cache per chip), with per-chip probes, ``set_silicon`` and the injection
isolation of the reference's detection tests.

The reduced SmolLM (two layers, float32) on the CPU; three chips at fault
rates 0, 0.25 and 0.4 (four for the sharded engine, as the reference's
tests), each with its own parameters from the reference's ``init_params``,
handed to the port through ``repro_torch.convert``. Prompts are made by
numpy from a seed and given to both packages.

Tolerances: greedy tokens for equality; logprobs at ``dtype_tol(float32)``
(rtol 2e-5, atol 2e-4) against the reference, whose summation order
differs; the port's fleet against its own per-chip engines at the same
tolerance. Temperature sampling is held to seeded reproducibility and to
independence across chips: a torch generator cannot replay threefry.
"""
import warnings

import jax
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
from repro.serve import Request as JaxRequest
from repro_torch.configs import get_arch, reduce_config
from repro_torch.convert import context_from_ok, params_from_jax
from repro_torch.core import FaultMap, from_fault_map, healthy, random_fault_map
from repro_torch.fleet import FleetServeEngine, ShardedFleetServeEngine
from repro_torch.fleet.serve import chip_generators
from repro_torch.kernels.common import assert_close
from repro_torch.kernels.masked_matmul import ops as mm_ops
from repro_torch.models import model as M
from repro_torch.obs import HEALTHY, Recorder, detection_rules
from repro_torch.serve import ContinuousBatchingEngine, Request, ServeEngine

F32 = torch.float32
RATES = (0.0, 0.25, 0.4)
STREAM_RATES = (0.0, 0.25, 0.4, 0.1)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast, and
    keeps parallel test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fleet():
    """Per chip: the reference's params and context, the port's params, the
    fault map (None for the healthy chip 0)."""
    jcfg = jax_reduce_config(jax_get_arch("smollm-135m"))
    cfg = reduce_config(get_arch("smollm-135m"))
    chips = []
    for i, rate in enumerate(STREAM_RATES):
        jparams, _ = JM.init_params(jcfg, jax.random.PRNGKey(i))
        params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
        fm = None if rate == 0.0 else random_fault_map(i, cfg.array_rows, cfg.array_cols, rate)
        chips.append(dict(jparams=jparams, params=params, fm=fm))
    return jcfg, cfg, chips


def _jctx(fm, mode="fap"):
    return jax_healthy() if fm is None else jax_from_fault_map(fm, mode=mode)


def _ctx(fm, mode="fap"):
    return healthy() if fm is None else context_from_ok(fm.ok_mask, mode, device="cpu")


def _prompts(cfg, seed=0, shape=(2, 8)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _streams(cfg, n):
    """The reference's ragged streams of tests/test_serve_continuous.py: per
    chip, prompts of 5 + c, 7 and 4 tokens with budgets 3 + c, 9 - c and 5,
    the last arriving at dispatch 2 + c (numpy prompts)."""
    rng = np.random.default_rng(7)
    p = lambda n_: rng.integers(0, cfg.vocab_size, n_).astype(np.int32)
    return [[(0, p(5 + c), 3 + c, 0), (1, p(7), 9 - c, 0), (2, p(4), 5, 2 + c)] for c in range(n)]


def _port_streams(streams):
    return [[Request(*r) for r in s] for s in streams]


def _jax_streams(streams):
    return [[JaxRequest(*r) for r in s] for s in streams]


# ---------------------------------------------------------------------------
# FleetServeEngine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jmode", ["fap", "pallas"])  # the port's fap and kernel modes
def test_fleet_engine_matches_reference(fleet, jmode):
    jcfg, cfg, chips = fleet
    chips = chips[: len(RATES)]
    prompts = _prompts(cfg)
    ref = JaxFleetServeEngine(
        jcfg, [c["jparams"] for c in chips], [_jctx(c["fm"], jmode) for c in chips], max_len=48
    ).generate(jax.numpy.asarray(prompts), max_new_tokens=6)
    got = FleetServeEngine(
        cfg, [c["params"] for c in chips], [_ctx(c["fm"], jmode) for c in chips], max_len=48
    ).generate(prompts, max_new_tokens=6)
    assert got.tokens.shape == (len(chips), 2, 8 + 6) and got.logprobs.shape == (len(chips), 2, 6)
    assert np.array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    assert_close(got.logprobs, np.asarray(ref.logprobs), F32)


def test_fleet_engine_chips_match_their_own_serve_engines(fleet):
    _, cfg, chips = fleet
    chips = chips[: len(RATES)]
    prompts = torch.as_tensor(_prompts(cfg, seed=1))
    ctxs = [_ctx(c["fm"], "pallas") for c in chips]
    out = FleetServeEngine(cfg, [c["params"] for c in chips], ctxs, max_len=48).generate(prompts, max_new_tokens=6)
    for i, c in enumerate(chips):
        ref = ServeEngine(cfg, c["params"], ctxs[i], max_len=48, prefill_buckets=None).generate(
            prompts, max_new_tokens=6
        )
        toks, lps = out.chip(i)
        assert torch.equal(toks, ref.tokens), f"chip {i}"
        assert_close(lps, ref.logprobs, F32)


def test_fleet_engine_faulty_chips_diverge(fleet):
    """Chips share prompts and weights but not masks: generations must
    differ, so each lane runs its own mask."""
    _, cfg, chips = fleet
    ctxs = [_ctx(c["fm"], "pallas") for c in chips[: len(RATES)]]
    eng = FleetServeEngine(cfg, [chips[0]["params"]] * len(RATES), ctxs, max_len=48)
    gen = eng.generate(_prompts(cfg), max_new_tokens=6).tokens[:, :, 8:].numpy()
    assert not np.array_equal(gen[0], gen[1]) and not np.array_equal(gen[0], gen[2])


def test_fleet_engine_temperature_streams_are_seeded_and_independent(fleet):
    _, cfg, chips = fleet
    eng = FleetServeEngine(cfg, [chips[0]["params"]] * 2, None, max_len=48)
    prompts = _prompts(cfg)
    a = eng.generate(prompts, max_new_tokens=6, temperature=1.0, seed=3).tokens
    b = eng.generate(prompts, max_new_tokens=6, temperature=1.0, seed=3).tokens
    c = eng.generate(prompts, max_new_tokens=6, temperature=1.0, seed=4).tokens
    assert torch.equal(a, b)
    # same params, healthy, same prompts: only the per-chip streams differ
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a, c)


def test_chip_generators_are_distinct_and_replayable():
    g1, g2 = chip_generators(5, 3, "cpu"), chip_generators(5, 3, "cpu")
    draws = [torch.rand(4, generator=g) for g in g1]
    assert all(torch.equal(d, torch.rand(4, generator=g)) for d, g in zip(draws, g2))
    assert not torch.equal(draws[0], draws[1]) and not torch.equal(draws[1], draws[2])


def test_fleet_engine_validates_inputs(fleet):
    _, cfg, chips = fleet
    with pytest.raises(ValueError, match="at least one"):
        FleetServeEngine(cfg, [], [])
    with pytest.raises(ValueError, match="fault contexts"):
        FleetServeEngine(cfg, [chips[0]["params"]], [healthy(), healthy()])
    ssm = reduce_config(get_arch("falcon-mamba-7b"))
    with pytest.raises(ValueError, match="attention"):
        FleetServeEngine(ssm, [M.init_params(ssm, 0, device="cpu")])


def test_fleet_engine_runs_each_gemm_as_one_chip_batched_call(fleet, monkeypatch):
    """Under the chip vmap every masked GEMM reaches the plain version once,
    with the chip axis on w and ok: the custom op's vmap rule, never a loop
    over chips. Per dispatch: 2 layers x 7 and the tied unembed."""
    _, cfg, chips = fleet
    chips = chips[: len(RATES)]
    calls = []
    ref = mm_ops.masked_matmul_ref

    def spy(x, w, ok):
        calls.append((w.dim(), ok.dim(), x.shape[0]))
        return ref(x, w, ok)

    monkeypatch.setattr(mm_ops, "masked_matmul_ref", spy)
    eng = FleetServeEngine(cfg, [c["params"] for c in chips], [_ctx(c["fm"], "pallas") for c in chips], max_len=48)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # a vmap fallback (a loop over chips) would warn
            eng.generate(_prompts(cfg), max_new_tokens=4)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    per_step = sum(u for _, _, u in cfg.gemm_shapes())
    assert len(calls) == per_step * (1 + 4)
    assert all(c == (3, 3, len(chips)) for c in calls)


# ---------------------------------------------------------------------------
# ShardedFleetServeEngine
# ---------------------------------------------------------------------------

KW = dict(num_slots=2, page_size=4, num_pages=32)


def test_sharded_fleet_matches_reference(fleet):
    jcfg, cfg, chips = fleet
    streams = _streams(cfg, len(chips))
    ref, ref_stats = JaxShardedFleetServeEngine(
        jcfg, [c["jparams"] for c in chips], [_jctx(c["fm"]) for c in chips], **KW
    ).serve(_jax_streams(streams))
    got, stats = ShardedFleetServeEngine(
        cfg, [c["params"] for c in chips], [_ctx(c["fm"]) for c in chips], devices=["cpu"], **KW
    ).serve(_port_streams(streams))
    assert stats.as_dict() == ref_stats.as_dict()
    for c in range(len(chips)):
        assert set(got[c]) == set(ref[c])
        for rid, r in ref[c].items():
            assert np.array_equal(got[c][rid].tokens, r.tokens), (c, rid)
            assert_close(torch.as_tensor(got[c][rid].logprobs), r.logprobs, F32)
            assert (got[c][rid].admitted_step, got[c][rid].finished_step) == (r.admitted_step, r.finished_step)


@pytest.mark.parametrize("mode", ["fap", "pallas"])
def test_sharded_fleet_chips_match_their_own_continuous_engines(fleet, mode):
    _, cfg, chips = fleet
    streams = _streams(cfg, len(chips))
    ctxs = [_ctx(c["fm"], mode) for c in chips]
    outs, stats = ShardedFleetServeEngine(
        cfg, [c["params"] for c in chips], ctxs, devices=["cpu"], **KW
    ).serve(_port_streams(streams))
    for c, chip in enumerate(chips):
        ref, _ = ContinuousBatchingEngine(cfg, chip["params"], ctxs[c], **KW).serve(_port_streams(streams)[c])
        assert set(outs[c]) == set(ref)
        for rid in ref:
            assert np.array_equal(outs[c][rid].tokens, ref[rid].tokens), (c, rid)
            assert_close(torch.as_tensor(outs[c][rid].logprobs), ref[rid].logprobs, F32)
    # ragged streams: the fused dispatch count is the busiest chip's, not the sum
    assert stats.decode_dispatches < sum(r[2] for s in streams for r in s)


def test_sharded_fleet_over_two_devices_matches_one(fleet):
    """Two device groups of two chips (both on the host here) serve what one
    group of four serves."""
    _, cfg, chips = fleet
    streams = _port_streams(_streams(cfg, len(chips)))
    ctxs = [_ctx(c["fm"], "pallas") for c in chips]
    params = [c["params"] for c in chips]
    one, _ = ShardedFleetServeEngine(cfg, params, ctxs, devices=["cpu"], **KW).serve(streams)
    eng = ShardedFleetServeEngine(cfg, params, ctxs, devices=["cpu", "cpu"], **KW)
    assert [list(g.chips) for g in eng.groups] == [[0, 1], [2, 3]]
    two, _ = eng.serve(streams)
    for c in range(len(chips)):
        for rid in one[c]:
            assert np.array_equal(one[c][rid].tokens, two[c][rid].tokens)
            assert np.array_equal(one[c][rid].logprobs, two[c][rid].logprobs)
    with pytest.raises(ValueError, match="tile"):
        ShardedFleetServeEngine(cfg, params[:3], ctxs[:3], devices=["cpu", "cpu"], **KW)


def test_sharded_fleet_temperature_is_seeded_and_independent(fleet):
    _, cfg, chips = fleet
    rng = np.random.default_rng(3)
    stream = [Request(0, rng.integers(0, cfg.vocab_size, 6), 8), Request(1, rng.integers(0, cfg.vocab_size, 6), 8)]
    eng = ShardedFleetServeEngine(cfg, [chips[0]["params"]] * 2, None, devices=["cpu"], **KW)
    o1, _ = eng.serve([stream, stream], temperature=1.0, seed=11)
    o2, _ = eng.serve([stream, stream], temperature=1.0, seed=11)
    o3, _ = eng.serve([stream, stream], temperature=1.0, seed=12)
    for c in range(2):
        for rid in o1[c]:
            assert np.array_equal(o1[c][rid].tokens, o2[c][rid].tokens)
    assert any(not np.array_equal(o1[0][r].tokens, o1[1][r].tokens) for r in o1[0])
    assert any(not np.array_equal(o1[0][r].tokens, o3[0][r].tokens) for r in o1[0])


def test_sharded_fleet_validates(fleet):
    _, cfg, chips = fleet
    with pytest.raises(ValueError, match="at least one"):
        ShardedFleetServeEngine(cfg, [], devices=["cpu"])
    with pytest.raises(ValueError, match="fault contexts"):
        ShardedFleetServeEngine(cfg, [chips[0]["params"]], [healthy(), healthy()], devices=["cpu"])
    eng = ShardedFleetServeEngine(cfg, [c["params"] for c in chips[:2]], num_slots=1, devices=["cpu"])
    with pytest.raises(ValueError, match="streams"):
        eng.serve([[Request(0, np.arange(3), 2)]])
    ssm = reduce_config(get_arch("falcon-mamba-7b"))
    with pytest.raises(ValueError, match="attention"):
        ShardedFleetServeEngine(ssm, [M.init_params(ssm, 0, device="cpu")], devices=["cpu"])
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedFleetServeEngine(cfg, [chips[0]["params"]])


def _zero_map(r, c):
    return FaultMap(np.zeros((r, c), bool))


@pytest.mark.parametrize("mode", ["fap", "pallas"])
def test_fleet_injection_isolated_to_victim_chip(fleet, mode):
    """The reference's fleet injection test through the port (and the
    reference beside it): one chip's silicon changes mid-serve; only its
    probes see it, localized within the true new faults, and the other
    chip's tokens are those of the control run."""
    jcfg, cfg, chips = fleet
    R, C = cfg.array_rows, cfg.array_cols
    base = [_zero_map(R, C), random_fault_map(1, R, C, 0.04)]
    victim = 1
    new_map = base[victim].merge(random_fault_map(99, R, C, 0.06))
    true_delta = new_map.faulty & ~base[victim].faulty
    assert true_delta.any()
    rng = np.random.default_rng(50)
    streams = [[(0, rng.integers(0, cfg.vocab_size, 6), 24, 0), (1, rng.integers(0, cfg.vocab_size, 5), 12, 1)]
               for _ in range(2)]
    kw = dict(num_slots=2, page_size=4, num_pages=64, prefill_buckets=(8, 16), probe_every=3)

    def build(rules, rec=None):
        return ShardedFleetServeEngine(
            cfg, [chips[0]["params"]] * 2, [context_from_ok(m.ok_mask, mode, device="cpu") for m in base],
            devices=["cpu"], alert_rules=rules, recorder=rec, **kw,
        )

    ctl = build(None)
    ctl_outs, _ = ctl.serve(_port_streams(streams))
    assert ctl.health.detections == 0
    eng = build(detection_rules(), rec=Recorder())
    state = dict(injected=False)

    def on_step(clock):
        if clock >= 4 and not state["injected"]:
            state["injected"] = True
            eng.set_silicon(victim, context_from_ok(new_map.ok_mask, mode, device="cpu"))

    outs, _ = eng.serve(_port_streams(streams), on_step=on_step)
    assert eng.health.state(victim) != HEALTHY
    delta = eng.health.last_delta(victim)
    assert delta is not None and delta.any() and not (delta & ~true_delta).any()
    assert eng.health.state(0) == HEALTHY and eng.health.detections == 1
    assert eng.health.last_delta(0) is None
    for rid in ctl_outs[0]:
        assert np.array_equal(outs[0][rid].tokens, ctl_outs[0][rid].tokens)
    assert "detect.new_faults" in eng.alerts.summary()["fired"]
    assert any(e.name == "fault.detected" for e in eng.obs.event_list())

    # the reference on the same traffic reaches the same verdicts
    from repro.obs import detection_rules as jax_detection_rules

    jeng = JaxShardedFleetServeEngine(
        jcfg, [chips[0]["jparams"]] * 2, [jax_from_fault_map(m) for m in base],
        alert_rules=jax_detection_rules(), **kw,
    )
    jstate = dict(injected=False)

    def jon_step(clock):
        if clock >= 4 and not jstate["injected"]:
            jstate["injected"] = True
            jeng.set_silicon(victim, jax_from_fault_map(new_map))

    jeng.serve(_jax_streams(streams), on_step=jon_step)
    assert [jeng.health.state(c) for c in range(2)] == [eng.health.state(c) for c in range(2)]
    assert jeng.health.detected_at(victim) == eng.health.detected_at(victim)
    assert np.array_equal(jeng.health.last_delta(victim), delta)


def test_set_silicon_validates(fleet):
    _, cfg, chips = fleet
    R, C = cfg.array_rows, cfg.array_cols
    active = from_fault_map(_zero_map(R, C), mode="kernel", device="cpu")
    params = [chips[0]["params"]] * 2
    lazy = ShardedFleetServeEngine(cfg, params, None, devices=["cpu"], **KW)
    with pytest.raises(ValueError, match="FaultMap context"):
        lazy.set_silicon(0, active)
    eng = ShardedFleetServeEngine(cfg, params, [active, active], devices=["cpu"], **KW)
    with pytest.raises(ValueError, match="chip"):
        eng.set_silicon(5, active)
    with pytest.raises(ValueError, match="shape"):
        eng.set_silicon(0, from_fault_map(_zero_map(R * 2, C), mode="kernel", device="cpu"))
    with pytest.raises(ValueError, match="ACTIVE"):
        eng.set_silicon(0, healthy())
    with pytest.raises(ValueError, match="mode"):
        eng.set_silicon(0, from_fault_map(_zero_map(R, C), mode="fap", device="cpu"))
    with pytest.raises(ValueError):
        ShardedFleetServeEngine(cfg, params, [active, active], devices=["cpu"], probe_every=0, **KW)
    # a change lands in the stacked mask in place, on that chip alone
    stacked = eng.groups[0].ctx.ok
    version = stacked._version
    new = random_fault_map(3, R, C, 0.3)
    eng.set_silicon(1, from_fault_map(new, mode="kernel", device="cpu"))
    assert eng.groups[0].ctx.ok is stacked and stacked._version > version
    assert torch.equal(stacked[1], torch.as_tensor(new.ok_mask, dtype=F32))
    assert torch.equal(stacked[0], torch.ones(R, C))


EXAMPLE_ARGS = ["--device", "cpu", "--reduced", "--chips", "3", "--pretrain-steps", "3", "--fat-steps", "2",
                "--probe-every", "4"]


def test_fleet_example_matches_its_per_chip_engines(capsys):
    """The example's own check on the host: every chip's tokens, chip 0's
    zero-fault map included, equal its own ``ContinuousBatchingEngine``'s."""
    from repro_torch.examples import fleet_serve as example

    assert example.main(EXAMPLE_ARGS) == 0
    out = capsys.readouterr().out
    assert "fleet output matches token for token;" in out
    assert "chip 0: fault_rate=0.00" in out and "detections=0" in out


def test_fleet_example_refuses_a_parting_that_is_no_near_tie(monkeypatch):
    """A token that parts from the chip's own engine where the two tokens'
    logits are far apart ends the example: only a near-tie may part."""
    from repro_torch.examples import fleet_serve as example

    serve = ContinuousBatchingEngine.serve

    def flipped(self, requests, **kw):
        outs, stats = serve(self, requests, **kw)
        o = outs[0]
        o.tokens = o.tokens.copy()
        o.tokens[-1] = (o.tokens[-1] + 1) % self.cfg.vocab_size
        return outs, stats

    monkeypatch.setattr(ContinuousBatchingEngine, "serve", flipped)
    with pytest.raises(SystemExit, match="their logits are .* apart"):
        example.main(EXAMPLE_ARGS)
