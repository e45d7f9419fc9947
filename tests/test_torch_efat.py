"""eFAT Steps 1-4 in the port against the reference, on the CPU: the FAT
engines, the resilience tables, the retraining plans, and the whole
pipeline.

The engines are held to the reference's own pin (tests/test_population.py):
the reference pretrains the classifier and its parameters are converted,
and the same batches reach both packages (the reference's ``ClusterData``
stream, handed over as numpy). Trained params agree within
``dtype_tol(float32, atol_scale=100)`` (rtol 2e-5, atol 2e-3), metrics
within 2e-3, and steps-to-constraint exactly. The tables, plans and fleet
helpers are numpy in both packages and must be equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import EFAT as JaxEFAT
from repro.core import EFATConfig as JaxEFATConfig
from repro.core import from_fault_map as jax_from_fault_map
from repro.core import grouping as JG
from repro.core import resilience as JR
from repro.models.classifier import init_classifier as jax_init_classifier
from repro.train.fat_trainer import ClassifierFATTrainer as JaxClassifierFATTrainer
from repro_torch.configs import get_arch
from repro_torch.convert import classifier_params_from_jax
from repro_torch.core import (
    EFAT,
    EFATConfig,
    FaultMap,
    correlated_family,
    fixed_policy_plan,
    from_fault_map,
    group_and_fuse,
    individual_plan,
    random_fault_map,
    random_pair_merge_plan,
)
from repro_torch.core import resilience as R
from repro_torch.kernels.common import dtype_tol
from repro_torch.launch.mesh import make_fleet_mesh, make_pop_mesh
from repro_torch.models.classifier import classifier_loss, classifier_param_axes
from repro_torch.train import fat_trainer as T
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.population import PopulationFATEngine, SerialFATEngine, make_fat_engine

CFG, JCFG = get_arch("paper-mlp"), jax_get_arch("paper-mlp")
RATES = [0.02, 0.08, 0.12, 0.18, 0.22]
BUDGETS = [25, 40, 10]
METRIC_TOL = 2e-3


def _batch(jbatch) -> dict:
    return {
        "x": torch.from_numpy(np.array(jbatch["x"])),
        "labels": torch.from_numpy(np.asarray(jbatch["labels"]).astype(np.int64)),
    }


class _Handover:
    """A reference batch fn as the port's: each step's batch converted once."""

    def __init__(self, fn):
        self.fn, self.cache = fn, {}

    def __call__(self, step: int) -> dict:
        if step not in self.cache:
            self.cache[step] = _batch(self.fn(step))
        return self.cache[step]


def _assert_params_close(got: dict, want, atol_scale=100.0):
    rtol, atol = dtype_tol(torch.float32, atol_scale=atol_scale)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def fleet():
    rng = np.random.default_rng(0)
    return [random_fault_map(rng, 32, 32, r) for r in RATES]


@pytest.fixture(scope="module")
def ref(fleet):
    """The reference trainer (pretrained 300 steps) and its results on the
    5-rate fleet: steps to baseline - 0.05 within 200 steps, and the params
    and metrics of ``fit_batch`` at BUDGETS."""
    tr = JaxClassifierFATTrainer(JCFG, pretrain_steps=300, eval_batches=2)
    constraint = tr.baseline_accuracy - 0.05
    jctxs = [jax_from_fault_map(fm) for fm in fleet]
    steps = tr.engine.steps_to_constraint_batch(tr.base_params, jctxs, constraint, 200, tr._probe_batch_fn)
    fitted = tr.engine.fit_batch(tr.base_params, jctxs[:3], BUDGETS, tr._train_batch_fn)
    metrics = tr.engine.evaluate_batch(fitted, jctxs[:3])
    return tr, constraint, steps, fitted, metrics


@pytest.fixture(scope="module")
def port(ref):
    """The port's inputs: the reference's pretrained params, eval batches and
    batch streams, converted."""
    tr = ref[0]
    params0 = classifier_params_from_jax(jax.tree.map(np.asarray, tr.base_params), device="cpu")
    kw = dict(
        loss_fn=lambda p, b, ctx: classifier_loss(p, b, CFG, ctx),
        opt_cfg=AdamWConfig(learning_rate=3e-3, weight_decay=0.0, grad_clip_norm=1.0),
        eval_batches=[_batch(b) for b in tr._evals],
        eval_every=tr.eval_every,
    )
    return params0, kw, _Handover(tr._probe_batch_fn), _Handover(tr._train_batch_fn)


def _ctxs(fleet, mode="fap"):
    return [from_fault_map(fm, mode, device="cpu") for fm in fleet]


# the sharded engine's meshes over the CPU repeated: a pop axis of 4, and 2
# pop slices of 2 model positions (member state stored split two ways;
# gathered for the math, or computed on split, "sharded-tp")
SHARDED = {
    "sharded-pop4": lambda: dict(mesh=make_pop_mesh(devices=["cpu"] * 4)),
    "sharded-2x2": lambda: dict(mesh=make_fleet_mesh(2, 2, devices=["cpu"] * 4), cfg=CFG,
                                param_axes=classifier_param_axes(CFG)),
    # the same mesh, computing on the split pieces (tensor-parallel math)
    "sharded-tp-2x2": lambda: dict(mesh=make_fleet_mesh(2, 2, devices=["cpu"] * 4), cfg=CFG,
                                   param_axes=classifier_param_axes(CFG), compute="sharded"),
}


def _engine(kind, kw, **extra):
    if kind in SHARDED:
        return make_fat_engine("sharded", **kw, **SHARDED[kind](), **extra)
    return make_fat_engine(kind, **kw, **extra)


# ---------------------------------------------------------------------------
# the engines, port against reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["population", "serial", *SHARDED])
def test_fit_batch_matches_reference(ref, port, fleet, kind):
    _, _, _, want, want_metrics = ref
    params0, kw, _, train_fn = port
    engine = _engine(kind, kw)
    got = engine.fit_batch(params0, _ctxs(fleet[:3]), BUDGETS, train_fn)
    for g, w in zip(got, want):
        _assert_params_close(g, w)
    metrics = engine.evaluate_batch(got, _ctxs(fleet[:3]))
    assert metrics == pytest.approx(want_metrics, abs=METRIC_TOL)
    if kind in ("sharded-2x2", "sharded-tp-2x2"):
        # member params stored split over the 2 model positions: every
        # classifier leaf's output dim halves (tests/test_fleet.py's bound)
        stats = engine.last_fit_stats
        assert stats["pop_extent"] == 2 and stats["model_extent"] == 2 and stats["members_kept"] == 3
        assert stats["per_member_resident_bytes"] <= stats["per_member_total_bytes"] / 2 * 1.05 + 1024


@pytest.mark.parametrize("kind", ["population", "serial", *SHARDED])
def test_steps_to_constraint_matches_reference(ref, port, fleet, kind):
    _, constraint, want, _, _ = ref
    params0, kw, probe_fn, _ = port
    engine = _engine(kind, kw)
    got = engine.steps_to_constraint_batch(params0, _ctxs(fleet), constraint, 200, probe_fn)
    assert got == want
    assert got[0] == 0 and any(s not in (0, None) for s in got)


@pytest.mark.parametrize("kind", list(SHARDED))
def test_sharded_padding_never_leaks(ref, port, fleet, kind):
    """5 members in chunks of 4 (the second holds one member and three
    padding lanes) and in one chunk (of 8 on a pop axis of 4, 6 on one of
    2) split over the pop slices: each member's params,
    probe steps and metric are the vmap engine's, and no padding lane comes
    back."""
    constraint = ref[1]
    params0, kw, probe_fn, train_fn = port
    pop = PopulationFATEngine(**kw)
    budgets = [7, 2, 9, 4, 5]
    want = pop.fit_batch(params0, _ctxs(fleet), budgets, train_fn)
    want_steps = pop.steps_to_constraint_batch(params0, _ctxs(fleet), constraint, 60, probe_fn)
    for size in (4, 8):
        engine = _engine(kind, kw, population_size=size)
        chunks = [c[1:] for c in engine._chunks(5)]
        assert chunks == ([(4, 4), (1, 4)] if size == 4 else [(5, 8 if engine.num_shards == 4 else 6)])
        got = engine.fit_batch(params0, _ctxs(fleet), budgets, train_fn)
        assert len(got) == 5
        for g, w in zip(got, want):
            _assert_params_close(g, w)
        assert engine.steps_to_constraint_batch(params0, _ctxs(fleet), constraint, 60, probe_fn) == want_steps
        assert engine.evaluate_batch(got, _ctxs(fleet, "kernel")) == pytest.approx(
            pop.evaluate_batch(want, _ctxs(fleet)), abs=METRIC_TOL)


@pytest.mark.parametrize("mode", ["fap", "kernel"])
def test_population_matches_serial_in_the_port(ref, port, fleet, mode):
    """On the CPU a ``kernel``-mode population runs the masked GEMM's plain
    version under vmap and grad, as the reference's ``pallas`` mode runs
    ``fap`` math off the TPU."""
    constraint = ref[1]
    params0, kw, probe_fn, train_fn = port
    pop, ser = PopulationFATEngine(**kw), SerialFATEngine(**kw)
    ctxs = _ctxs(fleet, mode)
    assert pop.steps_to_constraint_batch(params0, ctxs, constraint, 60, probe_fn) == (
        ser.steps_to_constraint_batch(params0, ctxs, constraint, 60, probe_fn)
    )
    a = pop.fit_batch(params0, ctxs[:3], [12, 3, 7], train_fn)
    b = ser.fit_batch(params0, ctxs[:3], [12, 3, 7], train_fn)
    for x, y in zip(a, b):
        _assert_params_close(x, y)
    assert pop.evaluate_batch(a, ctxs[:3]) == pytest.approx(ser.evaluate_batch(b, ctxs[:3]), abs=1e-6)


def test_population_chunking_is_invariant(ref, port, fleet):
    """Chunk size changes how work is submitted, never per-member results;
    the padding members never leak into them."""
    constraint = ref[1]
    params0, kw, probe_fn, train_fn = port
    narrow = PopulationFATEngine(**kw, population_size=2)
    wide = PopulationFATEngine(**kw, population_size=16)
    ctxs = _ctxs(fleet)
    assert narrow.steps_to_constraint_batch(params0, ctxs, constraint, 100, probe_fn) == (
        wide.steps_to_constraint_batch(params0, ctxs, constraint, 100, probe_fn)
    )
    a = narrow.fit_batch(params0, ctxs, [8] * 5, train_fn)
    b = wide.fit_batch(params0, ctxs, [8] * 5, train_fn)
    assert len(a) == len(b) == 5
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_allclose(x[k].numpy(), y[k].numpy(), rtol=1e-6, atol=1e-6)


def test_recorder_sees_the_reference_spans_and_counts(port, fleet):
    from repro_torch.obs.recorder import Recorder

    params0, kw, probe_fn, train_fn = port
    rec = Recorder()
    engine = PopulationFATEngine(**kw, population_size=4, recorder=rec)
    engine.fit_batch(params0, _ctxs(fleet), [3, 1, 2, 0, 5], train_fn)
    engine.steps_to_constraint_batch(params0, _ctxs(fleet[:2]), 0.0, 10, probe_fn)
    names = [e.name for e in rec.event_list()]
    assert names.count("fit_chunk") == 2 and names.count("probe_chunk") == 1
    assert names.count("constraint_crossed") == 2  # constraint 0 is met before any step
    assert rec.metrics.counter("train.members_trained").value == 5
    # 2 chunks of width 4 run to their largest budgets, 5 and 3
    assert rec.metrics.counter("train.lane_steps").value == 4 * 5 + 4 * 3
    assert rec.metrics.counter("train.budget_steps").value == 11


def test_engine_factory_and_devices(monkeypatch):
    from repro_torch.fleet import ShardedPopulationEngine

    engine = make_fat_engine("sharded", loss_fn=None, opt_cfg=None, eval_batches=[],
                             mesh=make_pop_mesh(devices=["cpu"] * 2))
    assert isinstance(engine, ShardedPopulationEngine) and engine.num_shards == 2
    with pytest.raises(ValueError):
        make_fat_engine("bogus", loss_fn=None, opt_cfg=None, eval_batches=[])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.ClassifierFATTrainer(CFG, pretrain_steps=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # its default mesh is every card
        make_fat_engine("sharded", loss_fn=None, opt_cfg=None, eval_batches=[])


# ---------------------------------------------------------------------------
# Step 1-3: tables and plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rates,max_fr,max_interval,step", [
    ([0.1, 0.2], 0.5, 0.05, 0.5), ([0.0], 0.3, 0.05, 0.6), ([0.09, 0.11, 0.1], 0.35, 0.05, 0.6),
    ([0.3], 0.1, 0.02, 0.25),
])
def test_fault_rate_list_is_equal(rates, max_fr, max_interval, step):
    assert R.fault_rate_list(rates, max_fr, max_interval, step) == JR.fault_rate_list(
        rates, max_fr, max_interval, step
    )
    with pytest.raises(ValueError):
        R.fault_rate_list([])


def _table(mod, seed=0):
    rng = np.random.default_rng(seed)
    rates = np.sort(rng.uniform(0.02, 0.4, 6))
    y = np.sort(rng.integers(0, 300, 6)).astype(float)
    return mod.ResilienceTable(rates, y * 0.5, y * 0.8, y, cap=300, constraint=0.81, meta={"repeats": 3})


def test_resilience_table_json_crosses_packages():
    for src, dst in ((R, JR), (JR, R)):
        t = _table(src)
        back = dst.ResilienceTable.from_json(t.to_json())
        assert back.to_json() == t.to_json()
        for fr in (0.0, 0.1, 0.25, 0.5):
            for stat in ("min", "mean", "max"):
                assert back.required_steps(fr, stat) == t.required_steps(fr, stat)
            assert back.reachable(fr) == t.reachable(fr)
    a = R.ResilienceTable2D([0.0, 0.1, 0.2], [0.0, 0.05], [[0, 10], [20, 40], [60, 90]], cap=100, constraint=0.9)
    b = JR.ResilienceTable2D([0.0, 0.1, 0.2], [0.0, 0.05], [[0, 10], [20, 40], [60, 90]], cap=100, constraint=0.9)
    for ra, rb in ((0.05, 0.02), (0.15, 0.04), (0.3, -1.0)):
        assert a.required_steps(ra, rb) == b.required_steps(ra, rb)
    with pytest.raises(ValueError):
        R.ResilienceTable([0.2, 0.1], [0, 0], [0, 0], [0, 0], cap=1, constraint=0.0)


class _Stub:
    """A pure-Python trainer of (rate, map): steps grow with the rate, a
    job's params are its (fused) map and steps, and a chip's metric falls
    with the faults its job did not train for. Counts its probes."""

    def __init__(self):
        self.calls = 0

    def steps_to_constraint(self, fm, constraint, max_steps):
        self.calls += 1
        steps = 5 * int(np.ceil(60 * fm.fault_rate + 10 * float(fm.faulty[0].mean())))
        return None if steps > max_steps else steps

    def train(self, fm, steps):
        return (fm.faulty.copy(), int(steps))

    def evaluate(self, params, fm):
        faulty, steps = params
        untrained = float((fm.faulty & ~faulty).mean())
        return 0.95 - 0.1 * fm.fault_rate + 1e-4 * steps - untrained


class _BatchStub(_Stub):
    def steps_to_constraint_batch(self, fms, constraint, max_steps):
        return [self.steps_to_constraint(fm, constraint, max_steps) for fm in fms]

    def train_batch(self, fms, steps):
        return [self.train(fm, s) for fm, s in zip(fms, steps)]

    def evaluate_batch(self, params_list, fms):
        return [self.evaluate(p, fm) for p, fm in zip(params_list, fms)]


def test_measure_resilience_on_a_stub_is_equal():
    kw = dict(array_shape=(32, 32), repeats=3, max_steps=40, seed=5)
    rates = [0.05, 0.1, 0.2, 0.3]
    for trainer, engine in ((_BatchStub(), None), (_Stub(), "serial")):
        a = R.measure_resilience(trainer, rates, 0.8, engine=engine, **kw)
        b = JR.measure_resilience(trainer, rates, 0.8, engine=engine, **kw)
        assert a.to_json() == b.to_json()
    with pytest.raises(ValueError):
        R.measure_resilience(_Stub(), rates, 0.8, engine="population", **kw)


def _same_plan(a, b):
    assert a.method == b.method and a.links == b.links and a.steps == b.steps
    assert [m.chip_id for m in a.fault_maps] == [m.chip_id for m in b.fault_maps]
    assert all(np.array_equal(x.faulty, y.faulty) for x, y in zip(a.fault_maps, b.fault_maps))
    assert a.summary() == b.summary()


@pytest.mark.parametrize("seed", [0, 3])
def test_plans_are_equal(seed):
    fleet = correlated_family(seed, 24, 32, 32, base_rate=0.07, idio_rate=0.025)
    jfleet = [JR.FaultMap(fm.faulty, chip_id=fm.chip_id) for fm in fleet]
    rates = R.fault_rate_list([fm.fault_rate for fm in fleet], 0.35, 0.05, 0.6)
    fn = lambda r: 10.0 * int(40 * r)  # noqa: E731 — a stepped curve, as measured tables are
    t, jt = R.ResilienceTable.from_function(rates, fn, cap=200), JR.ResilienceTable.from_function(rates, fn, cap=200)
    efat = group_and_fuse(fleet, t, m_comparisons=8, k_iterations=2, seed=seed)
    _same_plan(efat, JG.group_and_fuse(jfleet, jt, m_comparisons=8, k_iterations=2, seed=seed))
    assert efat.num_jobs < len(fleet)  # correlated maps fuse
    _same_plan(individual_plan(fleet, t), JG.individual_plan(jfleet, jt))
    _same_plan(fixed_policy_plan(fleet, 80), JG.fixed_policy_plan(jfleet, 80))
    _same_plan(random_pair_merge_plan(fleet, t, seed=seed), JG.random_pair_merge_plan(jfleet, jt, seed=seed))
    _same_plan(random_pair_merge_plan(fleet[:7], steps_per_job=50, seed=seed),
               JG.random_pair_merge_plan(jfleet[:7], steps_per_job=50, seed=seed))
    assert efat.total_steps <= individual_plan(fleet, t).total_steps


CACHE_CFG = dict(constraint=0.8, max_fr=0.3, repeats=2, max_steps=60, m_comparisons=4)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_resilience_cache_is_read_by_either_package(tmp_path, writer):
    fleet = [random_fault_map(i, 16, 16, 0.1) for i in range(3)]
    port = lambda tr, **kw: EFAT(tr, EFATConfig(**{**CACHE_CFG, **kw}))  # noqa: E731
    ref = lambda tr, **kw: JaxEFAT(tr, JaxEFATConfig(**{**CACHE_CFG, **kw}))  # noqa: E731
    make_writer, make_reader = (port, ref) if writer == "port" else (ref, port)
    cache = str(tmp_path / "table.json")
    written = make_writer(_Stub()).build_resilience_table(fleet, cache_path=cache)
    stub = _Stub()
    read = make_reader(stub).build_resilience_table(fleet, cache_path=cache)
    assert stub.calls == 0, "the other package's cache was not accepted"
    assert read.to_json() == written.to_json()
    # a different config re-measures
    make_reader(stub, repeats=3).build_resilience_table(fleet, cache_path=cache)
    assert stub.calls > 0


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def _summary(result):
    s = result.summary()
    s.pop("wall_seconds")
    return s


@pytest.mark.parametrize("stub", [_Stub, _BatchStub])
def test_efat_run_and_baselines_on_a_stub_are_equal(stub):
    fleet = correlated_family(2, 16, 32, 32, base_rate=0.07, idio_rate=0.025)
    jfleet = [JR.FaultMap(fm.faulty, chip_id=fm.chip_id) for fm in fleet]
    cfg = dict(constraint=0.9, max_fr=0.35, max_interval=0.05, step_ratio=0.6, repeats=3,
               max_steps=120, m_comparisons=8, k_iterations=2, stat="max")
    port, jax_ = EFAT(stub(), EFATConfig(**cfg)), JaxEFAT(stub(), JaxEFATConfig(**cfg))
    runs = [("run", {}), ("individual", {}), ("fixed", dict(steps_per_chip=80)), ("random-merge", {})]
    for method, kw in runs:
        a = port.run(fleet) if method == "run" else port.run_baseline(fleet, method, **kw)
        b = jax_.run(jfleet) if method == "run" else jax_.run_baseline(jfleet, method, **kw)
        _same_plan(a.plan, b.plan)
        assert a.chip_metrics == b.chip_metrics
        assert _summary(a) == _summary(b)
        assert len(a.job_params) == a.plan.num_jobs
    assert port.table.to_json() == jax_.table.to_json()
    with pytest.raises(ValueError):
        port.run_baseline(fleet, "bogus")


class _RefData:
    """The reference's ClusterData behind the port's interface; each batch
    is drawn once."""

    def __init__(self, jdata):
        self.jdata, self.dim, self.cache = jdata, jdata.dim, {}

    def batch_at(self, step, batch_size=256, split="train"):
        key = (step, batch_size, split)
        if key not in self.cache:
            self.cache[key] = _batch(self.jdata.batch_at(step, batch_size, split))
        return self.cache[key]

    def eval_batches(self, n=4, batch_size=512):
        return [_batch(b) for b in self.jdata.eval_batches(n, batch_size)]


def _efat_against_reference(monkeypatch, chips, fleet_seed, pretrain_steps, eval_batches, baselines,
                            trainer_kw=None, **kw):
    """``EFAT.run`` (and with ``baselines`` the three baselines) in both
    packages on one correlated fleet, the port's data and initial params
    the reference's: equal tables and plans, chip metrics within
    METRIC_TOL, every shipped weight FAP. Returns the port's results."""
    jtr = JaxClassifierFATTrainer(JCFG, pretrain_steps=pretrain_steps, eval_batches=eval_batches)
    monkeypatch.setattr(T, "make_classification_task", lambda cfg, seed=0, device=None: _RefData(jtr.data))
    monkeypatch.setattr(T, "init_classifier", lambda cfg, seed, in_dim, device=None: classifier_params_from_jax(
        jax.tree.map(np.asarray, jax_init_classifier(JCFG, jax.random.PRNGKey(seed), in_dim)), device=device))
    tr = T.ClassifierFATTrainer(CFG, pretrain_steps=pretrain_steps, eval_batches=eval_batches, device="cpu",
                                **(trainer_kw or {}))
    assert tr.baseline_accuracy == pytest.approx(jtr.baseline_accuracy, abs=METRIC_TOL)
    kw["constraint"] = jtr.baseline_accuracy - 0.03
    fleet = correlated_family(fleet_seed, chips, 32, 32, base_rate=0.07, idio_rate=0.025, chip_prefix="chip")
    jfleet = [JR.FaultMap(fm.faulty, chip_id=fm.chip_id) for fm in fleet]
    port, ref = EFAT(tr, EFATConfig(**kw)), JaxEFAT(jtr, JaxEFATConfig(**kw))
    runs = [("run", {})]
    if baselines:
        runs += [("individual", {}), ("fixed", dict(steps_per_chip=80)), ("random-merge", {})]
    results = {}
    for method, mkw in runs:
        a = port.run(fleet) if method == "run" else port.run_baseline(fleet, method, **mkw)
        b = ref.run(jfleet) if method == "run" else ref.run_baseline(jfleet, method, **mkw)
        assert port.table.to_json() == ref.table.to_json()
        _same_plan(a.plan, b.plan)
        assert sorted(a.chip_metrics) == sorted(b.chip_metrics) == list(range(chips))
        for chip in a.chip_metrics:
            assert a.chip_metrics[chip] == pytest.approx(b.chip_metrics[chip], abs=METRIC_TOL)
        # the shipped weights are FAP: zero on every faulty PE of their job's map
        for params, fm in zip(a.job_params, a.plan.fault_maps):
            for k in ("w0", "w1", "w2", "w3"):
                w = params[k].numpy()
                faulty = fm.faulty[np.arange(w.shape[0])[:, None] % 32, np.arange(w.shape[1])[None] % 32]
                assert (w[faulty] == 0).all()
        assert isinstance(a.plan.fault_maps[0], FaultMap)
        results[method] = a
    return results


TRAINERS = {"population": {}, "sharded-2x2": dict(engine="sharded", engine_kwargs=dict(
    mesh=make_fleet_mesh(2, 2, devices=["cpu"] * 4))), "sharded-tp-2x2": dict(engine="sharded", engine_kwargs=dict(
    mesh=make_fleet_mesh(2, 2, devices=["cpu"] * 4), compute="sharded"))}


@pytest.mark.parametrize("trainer", list(TRAINERS))
def test_reduced_efat_run_matches_reference(monkeypatch, trainer):
    """8 chips, repeats 2, max_steps 60, pretraining 60 steps; the port's
    trainer on the vmap engine and on the sharded one (2 x 2 mesh, the
    trainer's param axes and config threaded in), the reference's on its
    vmap engine."""
    _efat_against_reference(monkeypatch, chips=8, fleet_seed=1, pretrain_steps=60, eval_batches=2,
                            baselines=False, trainer_kw=TRAINERS[trainer], repeats=2, max_steps=60,
                            max_fr=0.3, m_comparisons=4)


def test_sharded_trainer_resilience_table_matches_reference(monkeypatch, ref):
    """``measure_resilience`` at tests/test_fleet.py's rates, repeats and
    step limit: the sharded trainer's table (pop mesh of 4) equals the
    reference's vmap trainer's, and its scheduler tiles the mesh."""
    jtr = ref[0]
    monkeypatch.setattr(T, "make_classification_task", lambda cfg, seed=0, device=None: _RefData(jtr.data))
    tr = T.ClassifierFATTrainer(CFG, pretrain_steps=0, eval_batches=2, device="cpu", engine="sharded",
                                engine_kwargs=dict(mesh=make_pop_mesh(devices=["cpu"] * 4)))
    assert tr.scheduler.width_multiple == tr.engine.num_shards == 4
    tr.base_params = classifier_params_from_jax(jax.tree.map(np.asarray, jtr.base_params), device="cpu")
    kw = dict(array_shape=(32, 32), repeats=2, max_steps=100, seed=5)
    got = R.measure_resilience(tr, [0.06, 0.14, 0.2], ref[1], **kw)
    want = JR.measure_resilience(jtr, [0.06, 0.14, 0.2], ref[1], **kw)
    assert got.to_json() == want.to_json()


def test_fleet_retraining_example_matches_reference(monkeypatch):
    """The whole sequence of ``examples/fleet_retraining.py`` at its
    defaults: 100 correlated chips, pretraining 600 steps, eFAT and the
    three baselines. eFAT needs fewer steps than ``individual``."""
    res = _efat_against_reference(
        monkeypatch, chips=100, fleet_seed=0, pretrain_steps=600, eval_batches=4, baselines=True,
        max_fr=0.35, max_interval=0.05, step_ratio=0.6, repeats=5, max_steps=400, m_comparisons=8,
        k_iterations=2, stat="max")
    assert res["run"].plan.total_steps <= res["individual"].plan.total_steps


# ---------------------------------------------------------------------------
# the sharded trainer on a 4 x 2 mesh, both compute modes, against the
# reference's vmap trainer in tests/test_fleet.py's setting
# ---------------------------------------------------------------------------

FLEET_BUDGETS = [12, 30, 5, 21, 9]
FLEET_TABLE = dict(array_shape=(32, 32), repeats=2, max_steps=100, seed=11)
FLEET_RATES = [0.05, 0.12, 0.2]


@pytest.fixture(scope="module")
def fleet_ref():
    """The reference's vmap trainer (pretrained 250 steps, population 8)
    and its results on 5 maps ``random_fault_map(i, 32, 32, 0.1 + 0.02 i)``:
    steps to baseline - 0.05 within 100, the resilience table, and
    ``train_batch`` at FLEET_BUDGETS with its metrics."""
    jtr = JaxClassifierFATTrainer(JCFG, pretrain_steps=250, eval_batches=2, population_size=8)
    constraint = jtr.baseline_accuracy - 0.05
    fleet = [random_fault_map(i, 32, 32, 0.1 + 0.02 * i) for i in range(5)]
    jfleet = [JR.FaultMap(fm.faulty) for fm in fleet]
    steps = jtr.steps_to_constraint_batch(jfleet, constraint, 100)
    table = JR.measure_resilience(jtr, FLEET_RATES, constraint, **FLEET_TABLE)
    params = jtr.train_batch(jfleet, FLEET_BUDGETS)
    metrics = jtr.evaluate_batch(params, jfleet)
    return jtr, constraint, fleet, steps, table, params, metrics


@pytest.mark.parametrize("compute", ["gathered", "sharded"])
def test_sharded_4x2_trainer_matches_reference_vmap_trainer(monkeypatch, fleet_ref, compute):
    """``ClassifierFATTrainer(engine="sharded")`` on a 4 x 2 mesh over the
    CPU repeated, fed the reference's data and pretrained params: equal
    steps-to-constraint and resilience table, ``train_batch`` params within
    the reference's own tensor-parallel rule (rtol 1e-4, atol 1e-5),
    metrics within METRIC_TOL, and the fit's resident bytes at mesh
    position 0 the rules' two-way split of every leaf."""
    jtr, constraint, fleet, steps, table, params, metrics = fleet_ref
    monkeypatch.setattr(T, "make_classification_task", lambda cfg, seed=0, device=None: _RefData(jtr.data))
    tr = T.ClassifierFATTrainer(CFG, pretrain_steps=0, eval_batches=2, device="cpu", engine="sharded",
                                population_size=8, engine_kwargs=dict(
                                    mesh=make_fleet_mesh(4, 2, devices=["cpu"] * 8), compute=compute))
    assert (tr.engine.num_shards, tr.engine.model_size, tr.engine.compute) == (4, 2, compute)
    tr.base_params = classifier_params_from_jax(jax.tree.map(np.asarray, jtr.base_params), device="cpu")
    assert tr.steps_to_constraint_batch(fleet, constraint, 100) == steps
    got_table = R.measure_resilience(tr, FLEET_RATES, constraint, **FLEET_TABLE)
    assert got_table.to_json() == table.to_json()
    got = tr.train_batch(fleet, FLEET_BUDGETS)
    for g, w in zip(got, params):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=1e-4, atol=1e-5)
    assert tr.evaluate_batch(got, fleet) == pytest.approx(metrics, abs=METRIC_TOL)
    assert tr.evaluate_batch(got, fleet, mode="kernel") == pytest.approx(metrics, abs=METRIC_TOL)
    stats = tr.engine.last_fit_stats
    # every w{i} and b{i} splits on its output dim (48 and 16 divide by 2)
    split = sum(t.numel() * t.element_size() / 2 for t in got[0].values())
    assert stats["model_extent"] == 2 and stats["per_member_resident_bytes"] == split
