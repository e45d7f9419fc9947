"""Fault-aware training of the MoE family (reduced mixtral-8x22b and
llama4-maverick-400b-a17b) in the port against the reference's
``LMFATTrainer``, on the CPU, through every engine.

The trainer is held as ``tests/test_torch_lm_fat.py`` holds SmolLM's: its
data and initial params are monkeypatched to the reference's (the
reference's ``TokenStream`` batches, handed over as numpy, and its
``init_params`` converted by ``params_from_jax``), so both packages
pretrain and fine-tune the same reduced model on the same batches.
Steps-to-constraint and a two-rate resilience table must be equal,
``fit_batch`` params within ``dtype_tol(float32, atol_scale=100)`` and
metrics within 2e-3, for the ``population``, ``serial``, ``sharded`` (2 x 2
over the CPU repeated) and ``sharded-tp`` (``compute="sharded"``) engines.
The router runs under ``vmap`` of ``grad_and_value`` in the population
engines.

Every fault map is 24 x 40, so that the split pieces' origins (32, 64,
128 on the reduced widths) fall off the map's grid and each piece's map is
a true roll. ``sharded-tp`` runs mixtral on 2 x 2, where its 4 experts
split two ways over the model axis, and llama4-maverick on 2 x 8, where
they do not divide the extent and the rules split inside the experts (the
FFN's 128 columns, 16 a piece).

``tests/test_torch_ssm_fat.py`` runs this file's harness on the SSM and
hybrid families.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_config as jax_reduce_config
from repro.core import resilience as JR
from repro.core.faults import FaultMap as JaxFaultMap
from repro.core.masking import from_fault_map as jax_from_fault_map
from repro.models import model as JM
from repro.train.fat_trainer import LMFATTrainer as JaxLMFATTrainer
from repro_torch.configs import get_arch, reduce_config
from repro_torch.convert import param_dict_from_jax, params_from_jax
from repro_torch.core import from_fault_map, mask_selected_params, masked_weight, random_fault_map
from repro_torch.core import resilience as R
from repro_torch.core.masking import MASKABLE_KEYS
from repro_torch.fleet.tensor_parallel import SplitTensor
from repro_torch.kernels.common import dtype_tol
from repro_torch.launch.mesh import make_fleet_mesh
from repro_torch.train import fat_trainer as T
from repro_torch.train.population import evaluate_metric

RATES = [0.05, 0.15, 0.25, 0.35]
MAP = (24, 40)
BUDGETS = [4, 6, 2, 5]
METRIC_TOL = 2e-3
TRAINER_KW = dict(pretrain_steps=10, batch_size=4, seq_len=16, eval_batches=2, population_size=4)
MAX_STEPS = 10
ARCHS = ["mixtral-8x22b", "llama4-maverick-400b-a17b"]
# the model extent of each arch's compute="sharded" mesh, and the axis some
# of its layer-0 leaves are split on there
TP_MODEL = {"mixtral-8x22b": 2, "llama4-maverick-400b-a17b": 8, "falcon-mamba-7b": 2, "hymba-1.5b": 4}
TP_SPLITS = {
    "mixtral-8x22b": {"layers.0.moe.wg": -3, "layers.0.moe.wd": -3, "layers.0.attn.wq": -1},
    "llama4-maverick-400b-a17b": {"layers.0.moe.wg": -1, "layers.0.moe.wu": -1, "layers.0.moe.wd": -2},
    "falcon-mamba-7b": {"layers.0.ssm.in_proj": -1, "layers.0.ssm.conv_b": -1, "layers.0.ssm.a_log": -2,
                        "layers.0.ssm.x_proj": -2, "layers.0.ssm.out_proj": -2},
    "hymba-1.5b": {"layers.0.ssm.in_proj": -1, "layers.0.ssm.d_skip": -1, "layers.0.ssm.dt_w": -1,
                   "layers.0.mlp.wd": -2},
}
ENGINES = ["population", "serial", "sharded", "sharded-tp"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast, and
    keeps parallel test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _RefStream:
    """The reference's TokenStream behind the port's interface; each batch
    is converted once."""

    def __init__(self, vocab_size, seq_len, batch_size, seed=0, device=None):
        from repro.data.synthetic import TokenStream

        self.jstream, self.cache = TokenStream(vocab_size, seq_len, batch_size, seed=seed), {}

    def batch_at(self, step):
        if step not in self.cache:
            self.cache[step] = {k: torch.from_numpy(np.asarray(v).astype(np.int64))
                                for k, v in self.jstream.batch_at(step).items()}
        return self.cache[step]


def _configs(arch):
    return jax_reduce_config(jax_get_arch(arch)), reduce_config(get_arch(arch))


def _fleet():
    rng = np.random.default_rng(0)
    return [random_fault_map(rng, *MAP, r) for r in RATES]


@functools.lru_cache(maxsize=None)
def reference_results(arch):
    """The reference trainer's results on the reduced ``arch``: steps to
    baseline - 0.05 within MAX_STEPS, the resilience table over two rates,
    and the params its engine fits at BUDGETS with their metrics. Computed
    once an arch: pytest may set a module fixture up again when it orders
    the parametrized tests."""
    jcfg, _ = _configs(arch)
    tr = JaxLMFATTrainer(jcfg, **TRAINER_KW)
    jfleet = [JaxFaultMap(fm.faulty) for fm in _fleet()]
    constraint = tr.baseline_metric - 0.05
    steps = tr.steps_to_constraint_batch(jfleet, constraint, MAX_STEPS)
    table = JR.measure_resilience(tr, RATES[:2], constraint, array_shape=MAP, repeats=2, max_steps=MAX_STEPS)
    jctxs = [jax_from_fault_map(fm) for fm in jfleet[:4]]
    fitted = tr.engine.fit_batch(tr.base_params, jctxs, BUDGETS, tr._train_batch_fn)
    metrics = tr.engine.evaluate_batch(fitted, jctxs)
    return dict(trainer=tr, constraint=constraint, steps=steps, table=table, fitted=fitted, metrics=metrics)


def port_trainer(arch, engine):
    """The port's trainer on ``engine``, fed the reference's batches and
    initial params."""
    jcfg, cfg = _configs(arch)

    def ref_init(cfg, seed, device=None):
        jparams, _ = JM.init_params(jcfg, jax.random.PRNGKey(seed))
        return params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device=device)

    kw = dict(engine=engine.split("-")[0])
    if engine == "sharded":
        kw["engine_kwargs"] = dict(mesh=make_fleet_mesh(2, 2, devices=["cpu"] * 4))
    elif engine == "sharded-tp":
        model = TP_MODEL[arch]
        kw["engine_kwargs"] = dict(mesh=make_fleet_mesh(2, model, devices=["cpu"] * 2 * model), compute="sharded")
    mp = pytest.MonkeyPatch()
    mp.setattr(T, "TokenStream", _RefStream)
    mp.setattr(T, "init_params", ref_init)
    try:
        return T.LMFATTrainer(cfg, device="cpu", **kw, **TRAINER_KW)
    finally:
        mp.undo()


def check_steps_and_table(arch, ref, port):
    got = port.steps_to_constraint_batch(_fleet(), ref["constraint"], MAX_STEPS)
    assert got == ref["steps"]
    assert any(s not in (0, None) for s in got), got  # the probe trains before it crosses
    table = R.measure_resilience(port, RATES[:2], ref["constraint"], array_shape=MAP, repeats=2,
                                 max_steps=MAX_STEPS)
    assert table.to_json() == ref["table"].to_json()


def check_train_and_evaluate(arch, ref, port):
    """The shipped params are the reference engine's fitted params with FAP
    on the array-mapped GEMM weights (``mask_selected_params``, as
    ``tests/test_torch_lm_fat.py`` explains); ``fap`` and ``kernel``
    metrics, and one chip at a time, as the reference's."""
    _, cfg = _configs(arch)
    fleet = _fleet()
    got = port.train_batch(fleet, BUDGETS)
    rtol, atol = dtype_tol(torch.float32, atol_scale=100)
    for g, w, fm in zip(got, ref["fitted"], fleet):
        w = mask_selected_params(param_dict_from_jax(cfg, jax.tree.map(np.asarray, w), device="cpu"),
                                 from_fault_map(fm, device="cpu"))
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), w[k].numpy(), rtol=rtol, atol=atol, err_msg=k)
        ok = torch.from_numpy(fm.ok_mask)
        for k in TP_SPLITS[arch]:
            if k.rsplit(".", 1)[-1] in MASKABLE_KEYS:
                assert torch.equal(g[k], masked_weight(g[k], ok))  # FAP-exact
    metrics = port.evaluate_batch(got, fleet)
    assert metrics == pytest.approx(ref["metrics"], abs=METRIC_TOL)
    assert port.evaluate_batch(got, fleet, mode="kernel") == pytest.approx(metrics, abs=1e-6)
    kctxs = [from_fault_map(fm, "kernel", device="cpu") for fm in fleet]
    assert [evaluate_metric(port.engine, p, c) for p, c in zip(got, kctxs)] == pytest.approx(metrics, abs=1e-6)
    if port.engine.kind == "sharded":
        stats = port.engine.last_fit_stats
        assert stats["per_member_resident_bytes"] < stats["per_member_total_bytes"]
    if getattr(port.engine, "compute", None) == "sharded":
        # the leaves the rules split are split as expected in the compute layout
        view = port.engine._slice(0)
        split = view._gather_member_params({k: v[None] for k, v in port.base_params.items()})
        for k, axis in TP_SPLITS[arch].items():
            assert isinstance(split[k], SplitTensor) and split[k].axis == axis, k


# ---------------------------------------------------------------------------
# this file's families
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return request.param, reference_results(request.param)


@pytest.fixture(scope="module", params=ENGINES)
def port(request, ref):
    return port_trainer(ref[0], request.param)


def test_pretrained_trainer_matches_reference(ref, port):
    jtr = ref[1]["trainer"]
    assert port.baseline_metric == pytest.approx(jtr.baseline_metric, abs=METRIC_TOL)


def test_steps_to_constraint_and_table_match_reference(ref, port):
    check_steps_and_table(ref[0], ref[1], port)


def test_train_and_evaluate_batch_match_reference(ref, port):
    check_train_and_evaluate(ref[0], ref[1], port)
