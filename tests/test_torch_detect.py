"""The port's online fault detection against the reference package: the
checksummed masked GEMM, the ABFT syndrome math and probe-weight choice,
``ChipProber``, the health state machine, the alert engine, the recorder
and its exporters, and the whole stack inside ``ContinuousBatchingEngine``
with a silicon change injected mid-serve.

Inputs are made by numpy from a seed and handed to both packages. The
reference's checksummed GEMM runs its Pallas kernel in interpret mode, as
its own tests run it. Tolerances: GEMM outputs at ``dtype_tol(float32)``
(rtol 2e-5, atol 2e-4); syndromes, deltas, states, transitions, counts and
alert histories for equality; health scores, which fold in logprobs that
differ by summation order, within 1e-6.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_config as jax_reduce_config
from repro.core.masking import FaultContext as JaxFaultContext
from repro.kernels.masked_matmul.ops import masked_matmul_checksummed as jax_checksummed
from repro.models import model as JM
from repro.obs import abft as jabft
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch import obs
from repro_torch.configs import get_arch, reduce_config
from repro_torch.convert import context_from_ok, params_from_jax
from repro_torch.core import random_fault_map
from repro_torch.kernels.common import assert_close
from repro_torch.kernels.masked_matmul.ops import masked_matmul, masked_matmul_checksummed
from repro_torch.models import model as M
from repro_torch.obs import abft
from repro_torch.serve import ContinuousBatchingEngine, PageAllocator, Request

F32 = torch.float32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast, and
    keeps parallel test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduce_config(jax_get_arch("smollm-135m"))
    cfg = reduce_config(get_arch("smollm-135m"))
    jparams, _ = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


# ---------------------------------------------------------------------------
# The checksummed GEMM and the syndrome math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("interpret", [None, True])
@pytest.mark.parametrize("m,k,n,rc", [(6, 16, 12, 4), (5, 64, 40, 16), (17, 48, 33, 8)])
def test_checksummed_gemm_matches_reference(m, k, n, rc, interpret):
    rng = np.random.default_rng(m * k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    ok = random_fault_map(m, rc, rc, 0.2).ok_mask
    ry, rchk = jax_checksummed(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ok), interpret=interpret)
    y, chk = masked_matmul_checksummed(torch.tensor(x), torch.tensor(w), torch.tensor(ok))
    assert y.shape == ry.shape and chk.shape == rchk.shape
    assert_close(y, np.asarray(ry), F32)
    assert_close(chk, np.asarray(rchk), F32)
    # the payload goes through the same masked path: the same bits
    assert torch.equal(y, masked_matmul(torch.tensor(x), torch.tensor(w), torch.tensor(ok)))
    np.testing.assert_allclose(chk.numpy(), y.numpy().sum(axis=0), rtol=1e-4, atol=1e-4)


def test_abft_helpers_match_reference():
    rng = np.random.default_rng(1)
    fm = random_fault_map(3, 8, 8, 0.2)
    assert np.array_equal(abft.periodic_mask_np((20, 19), fm.ok_mask),
                          jabft.periodic_mask_np((20, 19), fm.ok_mask))
    for seed in (0, 5):
        assert np.array_equal(abft.make_canary(4, 33, seed), jabft.make_canary(4, 33, seed))
        assert np.array_equal(abft.make_structured_probe(33, 8, seed),
                              jabft.make_structured_probe(33, 8, seed))
    for shape, cols in [((10,), 4), ((3, 24), 8), ((2, 17), 8)]:
        s = rng.standard_normal(shape)
        assert np.array_equal(abft.fold_syndrome(s, cols), jabft.fold_syndrome(s, cols))
    w = rng.standard_normal((32, 24)).astype(np.float32)
    probe = abft.make_structured_probe(32, 8)
    truth = fm.merge(random_fault_map(4, 8, 8, 0.1))
    gold = probe @ (w * abft.periodic_mask_np(w.shape, ~fm.faulty))
    live = probe @ (w * abft.periodic_mask_np(w.shape, ~truth.faulty))
    delta = abft.reconstruct_delta(gold, live, 8, tol=1e-5)
    assert np.array_equal(delta, jabft.reconstruct_delta(gold, live, 8, tol=1e-5))
    assert np.array_equal(delta, truth.faulty & ~fm.faulty)


def _meta_pair(name):
    """Full-width parameter shapes without their bytes: the port's model on
    the meta device, the reference's leaves as broadcast numpy views."""
    jcfg = jax_get_arch(name)
    shapes = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0))[0])
    tree = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    return tree, M.Model(get_arch(name), device="meta")


@pytest.mark.parametrize("name", ["reduced", "smollm-135m", "hymba-1.5b"])
def test_select_probe_weight_matches_reference(setup, name):
    """The same leaf and path string: SmolLM's ``wd`` (1536 x 576) ties
    ``wg`` and ``wu`` in size, and the reference's sorted-key order picks it."""
    if name == "reduced":
        _, _, jparams, params = setup
    else:
        jparams, params = _meta_pair(name)
    rname, rw = jabft.select_probe_weight(jparams)
    pname, pw = abft.select_probe_weight(params)
    assert pname == rname and tuple(pw.shape) == tuple(rw.shape)
    if name == "reduced":
        assert np.array_equal(pw.numpy(), np.asarray(rw))
    if name == "smollm-135m":
        assert pname == "['layers']['mlp']['wd']" and tuple(pw.shape) == (1536, 576)
    with pytest.raises(ValueError, match="maskable"):
        abft.select_probe_weight({"scale": torch.ones(3), "embed": torch.ones(4, 4)})


def _silicon(w, ok):
    """A numpy silicon model of the checksummed dispatch, reading the LIVE
    ``ok`` (mutated in place to inject faults)."""
    def dispatch(x):
        m = abft.periodic_mask_np(w.shape, ok)
        y = (np.asarray(x, np.float64) @ (w * m)).astype(np.float32)
        chk = (np.asarray(x, np.float64).sum(axis=0) @ (w * m)).astype(np.float32)
        return y, chk
    return dispatch


def test_prober_matches_reference_on_a_silicon_model():
    rng = np.random.default_rng(9)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    believed = random_fault_map(10, 8, 8, 0.06)
    ok_ref, ok_port = ~believed.faulty, ~believed.faulty
    ref = jabft.ChipProber(_silicon(w, ok_ref), array_shape=(8, 8), k_dim=32, chip=3)
    got = abft.ChipProber(_silicon(w, ok_port), array_shape=(8, 8), k_dim=32, chip=3)
    truth = believed.merge(random_fault_map(11, 8, 8, 0.1))
    for clock in range(6):
        if clock == 3:  # the silicon degrades under both probers
            ok_ref &= ~truth.faulty
            ok_port &= ~truth.faulty
        r, g = ref.probe(clock=clock), got.probe(clock=clock)
        assert g.as_dict() == r.as_dict()
        assert np.array_equal(g.syndrome_cols, r.syndrome_cols)
        assert (g.delta is None) == (r.delta is None)
        if g.delta is not None:
            assert np.array_equal(g.delta, r.delta)
            assert np.array_equal(g.delta, truth.faulty & ~believed.faulty)
    got.rebase()
    assert not got.probe(clock=6).detected
    with pytest.raises(ValueError, match="shape"):
        abft.ChipProber(lambda x: (x, x[0]), array_shape=(0, 4), k_dim=8)


# ---------------------------------------------------------------------------
# Health, alerts, the recorder and its exporters
# ---------------------------------------------------------------------------


def _results(pkg, chips):
    """A scripted probe stream: chip 1 goes bad for six ticks, then clean."""
    out = []
    rng = np.random.default_rng(2)
    for clock in range(14):
        for chip in range(chips):
            bad = chip == 1 and 2 <= clock < 8
            delta = (rng.random((4, 4)) < 0.2) if bad else None
            out.append((chip, clock, pkg.ProbeResult(
                canary_mismatches=3 if bad else 0,
                syndrome_cols=np.where(np.arange(4) == 2, float(bad), 0.0),
                detected=bad, dispatches=2 if bad else 1, delta=delta, clock=clock, chip=chip,
            )))
    return out


def _strip_times(events):
    return [(e.kind, e.name, e.proc, e.track, e.value, json.dumps(e.args, sort_keys=True, default=str))
            for e in events]


@pytest.mark.parametrize("chips,config", [
    (1, {}),
    (2, dict(suspect_after=1, degraded_after=3, recover_after=2)),
    (2, dict(drift_z=2.0, drift_after=2)),
])
def test_health_and_alerts_take_the_same_transitions(chips, config):
    runs = {}
    for label, pkg in (("ref", jobs), ("port", obs)):
        rec = pkg.Recorder()
        tracker = pkg.HealthTracker(chips, rec, config=pkg.HealthConfig(**config))
        alerts = pkg.AlertEngine(rec, pkg.default_slo_rules())
        moves, fired = [], []
        for chip, clock, res in _results(pkg, chips):
            lp = -1.0 if clock < 6 else -40.0  # a level shift the drift detector sees
            moves.append(tracker.observe_decode(chip, clock=clock, mean_logprob=lp, alloc_failures=clock // 5))
            moves.append(tracker.observe_probe(chip, res, clock=clock))
            fired.append(alerts.evaluate(clock=clock))
        tracker.finalize()
        runs[label] = (tracker, alerts, rec, moves, fired)
    (rt, ra, rrec, rmoves, rfired), (pt, pa, prec, pmoves, pfired) = runs["ref"], runs["port"]
    assert pmoves == rmoves and pfired == rfired
    assert pt.summary() == rt.summary()
    assert pa.summary() == ra.summary()
    assert _strip_times(prec.event_list()) == _strip_times(rrec.event_list())
    assert prec.metrics.as_dict() == rrec.metrics.as_dict()


def test_recorder_and_exports_match_reference(tmp_path):
    """The same calls give the same summary, JSONL log and Chrome trace (up
    to the clock); each package reads the other's log, and the reference's
    validator accepts the port's trace."""
    recs = {}
    for label, pkg in (("ref", jobs), ("port", obs)):
        rec = pkg.Recorder(capacity=16)
        for i in range(20):
            rec.instant(f"e{i}", track=f"slot{i % 3}", args=dict(i=i))
        rec.span("decode_step", t0=0.0, t1=0.5, args=dict(n_active=2))
        rec.sample("kv.free_pages", 7)
        rec.count("serve.tokens_emitted", 5)
        rec.gauge_set("alerts.firing", 1)
        for v in (0.001, 0.02, 0.3, 3.0, float("nan")):
            rec.observe("serve.ttft_wall_s", v, pkg.TTFT_BUCKETS_S)
        mon = pkg.PoolMonitor(rec, PageAllocator(8, 4))
        mon.sample()
        mon.sample()
        mon.flush()
        recs[label] = rec
    ref, got = recs["ref"], recs["port"]
    rs, gs = ref.summary(), got.summary()
    rs.pop("self_time_s"), gs.pop("self_time_s")
    assert gs == rs and gs["events_dropped"] == 14 and gs["warnings"]
    assert _strip_times(got.event_list()) == _strip_times(ref.event_list())
    with pytest.warns(UserWarning, match="overwrote 14"):
        assert jobs.validate_chrome_trace(obs.chrome_trace(got)) == []
    trace = obs.chrome_trace(got)
    rtrace = jobs.chrome_trace(ref)
    strip = lambda t: [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in t["traceEvents"]]
    assert strip(trace) == strip(rtrace) and trace["otherData"] == rtrace["otherData"]
    for writer, reader, name in ((obs.write_jsonl, jobs.read_jsonl, "port.jsonl"),
                                 (jobs.write_jsonl, obs.read_jsonl, "ref.jsonl")):
        path = tmp_path / name
        writer(str(path), got if writer is obs.write_jsonl else ref)
        back = reader(str(path))
        assert back["dropped"] == 14 and len(back["events"]) == 16
        assert [m["name"] for m in back["metrics"]] == sorted(got.metrics.names())
    out = tmp_path / "port.trace.json"
    with pytest.warns(UserWarning, match="overwrote 14"):
        obs.jsonl_to_chrome(str(tmp_path / "port.jsonl"), str(out))
        assert jobs.validate_chrome_trace(str(out)) == []


# ---------------------------------------------------------------------------
# The detection stack inside the continuous engine
# ---------------------------------------------------------------------------


def _reqs(pkg, cfg, budget=16):
    rng = np.random.default_rng(0)
    return [
        pkg(0, rng.integers(0, cfg.vocab_size, 6), max_new_tokens=budget),
        pkg(1, rng.integers(0, cfg.vocab_size, 7), max_new_tokens=budget - 4),
        pkg(2, rng.integers(0, cfg.vocab_size, 5), max_new_tokens=budget // 2, arrival=2),
    ]


KW = dict(num_slots=2, page_size=4, num_pages=64, prefill_buckets=(8, 16))


@pytest.mark.parametrize("mode", ["fap", "pallas"])
def test_injection_detected_as_the_reference_detects_it(setup, mode):
    """The reference's injection scenario: pristine silicon, a probe every 3
    dispatches, a 5% fault map added at dispatch 4. Both packages detect it
    at the same dispatch, reconstruct the same delta (a subset of the true
    new faults), fire the same alerts and serve the same tokens."""
    jcfg, cfg, jparams, params = setup
    R, C = cfg.array_rows, cfg.array_cols
    pristine = np.ones((R, C), np.float32)
    new_map = random_fault_map(42, R, C, 0.05)
    true_delta = new_map.faulty
    probe_every, inject_at = 3, 4
    runs = {}
    for label in ("ref", "port"):
        if label == "ref":
            ctx0 = JaxFaultContext(ok=jnp.asarray(pristine), mode=mode)
            ctx1 = JaxFaultContext(ok=jnp.asarray(new_map.ok_mask), mode=mode)
            rec = jobs.Recorder()
            eng = JaxEngine(jcfg, jparams, ctx0, recorder=rec, probe_every=probe_every,
                            alert_rules=jobs.detection_rules(), **KW)
            reqs = _reqs(JaxRequest, cfg, budget=28)
        else:
            ctx0 = context_from_ok(pristine, mode, device="cpu")
            ctx1 = context_from_ok(new_map.ok_mask, mode, device="cpu")
            rec = obs.Recorder()
            eng = ContinuousBatchingEngine(cfg, params, ctx0, recorder=rec, probe_every=probe_every,
                                           alert_rules=obs.detection_rules(), **KW)
            reqs = _reqs(Request, cfg, budget=28)
        state = dict(injected=False)

        def on_step(clock, eng=eng, ctx1=ctx1, state=state):
            if clock >= inject_at and not state["injected"]:
                state["injected"] = True
                eng.set_silicon(ctx1)

        outs, stats = eng.serve(reqs, on_step=on_step)
        runs[label] = (eng, rec, outs, stats)
    (reng, rrec, routs, rstats), (eng, rec, outs, stats) = runs["ref"], runs["port"]
    assert eng._probe_weight == reng._probe_weight == "['layers']['mlp']['wd']"
    hc = obs.HealthConfig()
    got_at = eng.health.detected_at(0)
    assert got_at == reng.health.detected_at(0) is not None
    assert got_at <= inject_at + probe_every * (hc.suspect_after + 1)
    delta = eng.health.last_delta(0)
    assert delta is not None and delta.any() and not (delta & ~true_delta).any()
    assert np.array_equal(delta, reng.health.last_delta(0))
    assert eng.alerts.summary() == reng.alerts.summary()
    assert "detect.new_faults" in eng.alerts.summary()["fired"]
    gs, rs = eng.health.summary(), reng.health.summary()
    assert gs["chips"][0].pop("score") == pytest.approx(rs["chips"][0].pop("score"), abs=1e-6)
    assert gs == rs
    assert stats.as_dict() == rstats.as_dict() and stats.probe_dispatches > 0
    for rid in routs:
        assert np.array_equal(outs[rid].tokens, routs[rid].tokens), rid
    names = lambda r: sorted(e.name for e in r.event_list())
    assert names(rec) == names(rrec)
    assert any(e.name == "fault.detected" for e in rec.event_list())
    assert jobs.validate_chrome_trace(obs.chrome_trace(rec)) == []


def test_probes_change_no_token_and_stay_out_of_the_census(setup):
    """Probes, health and the detection alerts on unchanged silicon: the
    same tokens and logprobs bit for bit, no detection, no alert, and the
    programs of the probe-free run. (The detection rules, as the
    reference's test attaches: the SLO set's TTFT limit is wall time, which
    a loaded host can pass.)"""
    _, cfg, _, params = setup
    ctx = context_from_ok(np.ones((cfg.array_rows, cfg.array_cols), np.float32), "fap", device="cpu")
    reqs = _reqs(Request, cfg)
    plain = ContinuousBatchingEngine(cfg, params, ctx, **KW)
    off, _ = plain.serve(reqs)
    rec = obs.Recorder()
    eng = ContinuousBatchingEngine(cfg, params, ctx, recorder=rec, probe_every=2,
                                   alert_rules=obs.detection_rules(), **KW)
    on, stats = eng.serve(reqs)
    for rid in off:
        assert np.array_equal(off[rid].tokens, on[rid].tokens), rid
        np.testing.assert_array_equal(off[rid].logprobs, on[rid].logprobs)
    assert stats.probe_dispatches > 0
    assert eng.health.detections == 0 and eng.health.state(0) == obs.HEALTHY
    assert eng.alerts.fired_total == 0
    spans = [e for e in rec.event_list() if e.name == "probe"]
    assert spans and all(e.track == "health" and not e.args["detected"] for e in spans)
    assert eng.used_programs == plain.used_programs
    assert eng.compile_counts() == plain.compile_counts()


def test_set_silicon_validates(setup):
    _, cfg, _, params = setup
    R, C = cfg.array_rows, cfg.array_cols
    active = context_from_ok(np.ones((R, C), np.float32), "fap", device="cpu")
    lazy = ContinuousBatchingEngine(cfg, params, **KW)
    with pytest.raises(ValueError, match="ACTIVE"):
        lazy.set_silicon(active)
    eng = ContinuousBatchingEngine(cfg, params, active, **KW)
    with pytest.raises(ValueError, match="ACTIVE"):
        eng.set_silicon(context_from_ok(None, "none"))
    with pytest.raises(ValueError, match="shape"):
        eng.set_silicon(context_from_ok(np.ones((2 * R, C), np.float32), "fap", device="cpu"))
    with pytest.raises(ValueError, match="mode"):
        eng.set_silicon(context_from_ok(np.ones((R, C), np.float32), "pallas", device="cpu"))
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(cfg, params, active, probe_every=0, **KW)
