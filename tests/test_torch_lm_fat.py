"""``LMFATTrainer``, the FAM baseline and the dual-fault module in the port
against the reference, on the CPU.

The trainer is held as ``tests/test_torch_efat.py`` holds the classifier's:
its data and initial params are monkeypatched to the reference's (the
reference's ``TokenStream`` batches, handed over as numpy, and its
``init_params`` converted), so both packages pretrain and fine-tune the
same reduced SmolLM on the same batches. Steps-to-constraint and the
resilience tables must be equal, ``train_batch`` params within
``dtype_tol(float32, atol_scale=100)`` (atol 2e-3) and metrics within 2e-3,
on both engines. FAM and the dual-fault weights are numpy or exact
elementwise arithmetic in both packages and must be bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_config as jax_reduce_config
from repro.core import dual as JD
from repro.core import mapping as JMap
from repro.core import resilience as JR
from repro.core.faults import FaultMap as JaxFaultMap
from repro.core.masking import from_fault_map as jax_from_fault_map
from repro.models import model as JM
from repro.models.classifier import init_classifier as jax_init_classifier
from repro.train.fat_trainer import ClassifierFATTrainer as JaxClassifierFATTrainer
from repro.train.fat_trainer import LMFATTrainer as JaxLMFATTrainer
from repro_torch.configs import get_arch, reduce_config
from repro_torch.convert import classifier_params_from_jax, param_dict_from_jax, params_from_jax
from repro_torch.core import (
    apply_fam,
    dual_fault_weight,
    expected_weight_loss,
    fam_permutation,
    from_fault_map,
    mask_selected_params,
    masked_weight,
    measure_resilience_2d,
    project_params,
    random_fault_map,
)
from repro_torch.core import resilience as R
from repro_torch.kernels.common import dtype_tol
from repro_torch.launch.mesh import make_fleet_mesh
from repro_torch.train import fat_trainer as T
from repro_torch.train.population import evaluate_metric

JCFG = jax_reduce_config(jax_get_arch("smollm-135m"))
CFG = reduce_config(get_arch("smollm-135m"))
RATES = [0.05, 0.15, 0.25, 0.35]
BUDGETS = [5, 8, 3]
METRIC_TOL = 2e-3
TRAINER_KW = dict(pretrain_steps=30, batch_size=4, seq_len=16, eval_batches=2, population_size=4)
MAX_STEPS = 40


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast, and
    keeps parallel test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_batch(jbatch) -> dict:
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in jbatch.items()}


class _RefStream:
    """The reference's TokenStream behind the port's interface; each batch
    is converted once."""

    def __init__(self, vocab_size, seq_len, batch_size, seed=0, device=None):
        from repro.data.synthetic import TokenStream

        self.jstream, self.cache = TokenStream(vocab_size, seq_len, batch_size, seed=seed), {}

    def batch_at(self, step):
        if step not in self.cache:
            self.cache[step] = _torch_batch(self.jstream.batch_at(step))
        return self.cache[step]


def _ref_init(cfg, seed, device=None):
    jparams, _ = JM.init_params(JCFG, jax.random.PRNGKey(seed))
    return params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device=device)


@pytest.fixture(scope="module")
def fleet():
    rng = np.random.default_rng(0)
    return [random_fault_map(rng, CFG.array_rows, CFG.array_cols, r) for r in RATES]


@pytest.fixture(scope="module")
def ref(fleet):
    """The reference trainer and its results: steps to baseline - 0.05
    within MAX_STEPS, the resilience table over two rates, and the params
    its engine fits at BUDGETS with their metrics."""
    tr = JaxLMFATTrainer(JCFG, **TRAINER_KW)
    jfleet = [JaxFaultMap(fm.faulty) for fm in fleet]
    constraint = tr.baseline_metric - 0.05
    steps = tr.steps_to_constraint_batch(jfleet, constraint, MAX_STEPS)
    table = JR.measure_resilience(tr, RATES[:2], constraint, array_shape=(16, 16), repeats=2, max_steps=MAX_STEPS)
    jctxs = [jax_from_fault_map(fm) for fm in jfleet[:3]]
    fitted = tr.engine.fit_batch(tr.base_params, jctxs, BUDGETS, tr._train_batch_fn)
    metrics = tr.engine.evaluate_batch(fitted, jctxs)
    return tr, constraint, steps, table, fitted, metrics


# the sharded engine on a 2 x 2 mesh over the CPU repeated: 2 pop slices,
# each member's state stored split over 2 model positions by param_specs(cfg);
# "sharded-tp" computes on the split pieces (compute="sharded")
ENGINES = {"population": {}, "serial": {},
           "sharded": dict(engine_kwargs=dict(mesh=make_fleet_mesh(2, 2, devices=["cpu"] * 4))),
           "sharded-tp": dict(engine="sharded", engine_kwargs=dict(
               mesh=make_fleet_mesh(2, 2, devices=["cpu"] * 4), compute="sharded"))}


@pytest.fixture(scope="module", params=list(ENGINES))
def port(request):
    mp = pytest.MonkeyPatch()
    mp.setattr(T, "TokenStream", _RefStream)
    mp.setattr(T, "init_params", _ref_init)
    kw = {"engine": request.param, **ENGINES[request.param]}
    tr = T.LMFATTrainer(CFG, device="cpu", **TRAINER_KW, **kw)
    mp.undo()
    return tr


def test_pretrained_trainer_matches_reference(ref, port):
    jtr = ref[0]
    assert port.baseline_metric == pytest.approx(jtr.baseline_metric, abs=METRIC_TOL)
    assert port.base_params["embed"].device.type == "cpu"
    assert port.eval_every == jtr.eval_every == 10 and len(port._evals) == len(jtr._evals) == 2


def test_steps_to_constraint_and_table_match_reference(ref, port, fleet):
    _, constraint, want, want_table, _, _ = ref
    got = port.steps_to_constraint_batch(fleet, constraint, MAX_STEPS)
    assert got == want
    assert any(s not in (0, None) for s in got), got  # the probe trains before it crosses
    table = R.measure_resilience(port, RATES[:2], constraint, array_shape=(16, 16), repeats=2,
                                 max_steps=MAX_STEPS)
    assert table.to_json() == want_table.to_json()


def test_train_and_evaluate_batch_match_reference(ref, port, fleet):
    """The shipped params are the reference engine's fitted params with FAP
    on the array-mapped GEMM weights (``mask_selected_params``); the
    reference's ``train_batch`` ships ``mask_params`` of its stacked tree,
    which also zeroes embedding entries and norm scales, a model it never
    trained (ROADMAP.md §3). Under ``fap`` the shipped model evaluates as
    the fitted one did."""
    _, _, _, _, fitted, want_metrics = ref
    got = port.train_batch(fleet[:3], BUDGETS)
    rtol, atol = dtype_tol(torch.float32, atol_scale=100)
    for g, w, fm in zip(got, fitted, fleet):
        w = mask_selected_params(param_dict_from_jax(CFG, jax.tree.map(np.asarray, w), device="cpu"),
                                 from_fault_map(fm, device="cpu"))
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), w[k].numpy(), rtol=rtol, atol=atol)
        ok = torch.from_numpy(fm.ok_mask)
        for k in ("layers.0.attn.wq", "layers.1.mlp.wd"):
            assert torch.equal(g[k], masked_weight(g[k], ok))  # FAP-exact
    metrics = port.evaluate_batch(got, fleet[:3])
    assert metrics == pytest.approx(want_metrics, abs=METRIC_TOL)
    # the deployment check: the chips through the masked GEMM (its plain
    # version on the host, under the engine's vmap) give the fap metrics,
    # and so does one chip at a time
    assert port.evaluate_batch(got, fleet[:3], mode="kernel") == pytest.approx(metrics, abs=1e-6)
    kctxs = [from_fault_map(fm, "kernel", device="cpu") for fm in fleet[:3]]
    assert [evaluate_metric(port.engine, p, c) for p, c in zip(got, kctxs)] == pytest.approx(metrics, abs=1e-6)
    if port.engine.kind == "sharded":
        # embed, the MLP and every leaf the rules split are stored two ways
        stats = port.engine.last_fit_stats
        assert stats["pop_extent"] == 2 and stats["model_extent"] == 2
        assert stats["per_member_resident_bytes"] < stats["per_member_total_bytes"]


def test_kernel_mode_fit_off_the_cpu_raises(port, fleet):
    """A ``kernel`` context off the host reaches the card kernel, which has
    no backward: the engines refuse it before any step. (The card test runs
    it on a CUDA device; here the mask lies on the meta device.)"""
    kctxs = [from_fault_map(fm, "kernel", device="meta") for fm in fleet[:3]]
    with pytest.raises(NotImplementedError, match="no masked-GEMM backward"):
        port.engine.fit_batch(port.base_params, kctxs, BUDGETS, port._train_batch_fn)
    with pytest.raises(NotImplementedError, match="no masked-GEMM backward"):
        port.engine.steps_to_constraint_batch(port.base_params, kctxs, 0.5, 10, port._probe_batch_fn)


# ---------------------------------------------------------------------------
# FAM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,rows_cols,rate", [
    ((64, 40), (16, 16), 0.2),  # Hungarian
    ((3, 48, 33), (16, 8), 0.3),  # leading dims replicate the mask
    ((8, 2100), (16, 16), 0.15),  # wider than the cutoff: the greedy pairing
])
def test_fam_is_equal_to_reference(shape, rows_cols, rate):
    fm = random_fault_map(3, *rows_cols, rate)
    jfm = JaxFaultMap(fm.faulty)
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    perm = fam_permutation(torch.from_numpy(w), fm)
    assert np.array_equal(perm, JMap.fam_permutation(w, jfm))
    assert np.array_equal(np.sort(perm), np.arange(shape[-1]))
    got = apply_fam(torch.from_numpy(w), torch.from_numpy(fm.ok_mask), perm)
    want = JMap.apply_fam(jnp.asarray(w), jnp.asarray(fm.ok_mask), perm)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert expected_weight_loss(shape[-2:], fm) == JMap.expected_weight_loss(shape[-2:], jfm)
    # never more saliency mass bypassed than plain FAP
    fap = np.abs(w * (1 - JMap.periodic_mask(shape, fm.ok_mask))).sum()
    assert np.abs(w - got.numpy()).sum() <= fap + 1e-3


# ---------------------------------------------------------------------------
# dual faults
# ---------------------------------------------------------------------------


def test_dual_fault_weight_and_projection_are_equal_to_reference():
    pe, sa1 = random_fault_map(0, 32, 32, 0.1), random_fault_map(1, 32, 32, 0.05)
    jpe, jsa1 = JaxFaultMap(pe.faulty), JaxFaultMap(sa1.faulty)
    rng = np.random.default_rng(2)
    w = rng.standard_normal((48, 40)).astype(np.float32)
    w[::7, ::5] = 0.0  # a stuck cell over a zero reads back +magnitude
    for fpe, fsa, jfpe, jfsa in ((pe, sa1, jpe, jsa1), (None, sa1, None, jsa1), (pe, None, jpe, None)):
        for magnitude in (1.0, 0.25):
            got = dual_fault_weight(torch.from_numpy(w), fpe, fsa, magnitude)
            want = JD.dual_fault_weight(jnp.asarray(w), jfpe, jfsa, magnitude)
            assert np.array_equal(got.numpy(), np.asarray(want))
    params = {"w0": w, "b0": rng.standard_normal(40).astype(np.float32), "w1": w[:40, :16].copy()}
    got = project_params({k: torch.from_numpy(v) for k, v in params.items()}, pe, sa1, magnitude=0.5)
    want = JD.project_params({k: jnp.asarray(v) for k, v in params.items()}, jpe, jsa1, magnitude=0.5)
    assert set(got) == set(want)
    for k in got:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


class _RefClusterData:
    """The reference's ClusterData behind the port's interface."""

    def __init__(self, jdata):
        self.jdata, self.dim, self.cache = jdata, jdata.dim, {}

    def batch_at(self, step, batch_size=256, split="train"):
        key = (step, batch_size, split)
        if key not in self.cache:
            b = self.jdata.batch_at(step, batch_size, split)
            self.cache[key] = {"x": torch.from_numpy(np.array(b["x"])),
                               "labels": torch.from_numpy(np.asarray(b["labels"]).astype(np.int64))}
        return self.cache[key]

    def eval_batches(self, n=4, batch_size=512):
        return [self.batch_at(i, batch_size, split="eval") for i in range(n)]


def test_measure_resilience_2d_matches_reference(monkeypatch):
    jcfg, cfg = jax_get_arch("paper-mlp"), get_arch("paper-mlp")
    jtr = JaxClassifierFATTrainer(jcfg, pretrain_steps=150, eval_batches=2)
    monkeypatch.setattr(T, "make_classification_task", lambda cfg, seed=0, device=None: _RefClusterData(jtr.data))
    monkeypatch.setattr(T, "init_classifier", lambda cfg, seed, in_dim, device=None: classifier_params_from_jax(
        jax.tree.map(np.asarray, jax_init_classifier(jcfg, jax.random.PRNGKey(seed), in_dim)), device=device))
    tr = T.ClassifierFATTrainer(cfg, pretrain_steps=150, eval_batches=2, device="cpu")
    constraint = jtr.baseline_accuracy - 0.05
    kw = dict(array_shape=(32, 32), max_steps=60, repeats=1, seed=0)
    got = measure_resilience_2d(tr, [0.05, 0.25], [0.0, 0.03], constraint, **kw)
    want = JD.measure_resilience_2d(jtr, [0.05, 0.25], [0.0, 0.03], constraint, **kw)
    assert np.array_equal(got.steps, want.steps), (got.steps, want.steps)
    assert got.required_steps(0.1, 0.01) == want.required_steps(0.1, 0.01)
