"""The training slice's building blocks against the reference, on the CPU:
the paper-mlp classifier, the hand-written AdamW, the cluster data, the
batched fault context, the fleet helpers of ``core/faults.py`` and the
fleet scheduler.

Inputs are made from a numpy seed and handed to both packages as numpy; the
tolerance is ``dtype_tol(float32)`` (rtol 2e-5, atol 2e-4) unless a check is
exact. The JAX side runs as its own tests run it, on the CPU; its ``pallas``
mode is the port's ``kernel`` mode, whose CPU path is the masked GEMM's
plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_arch as jax_get_arch
from repro.core import faults as JF
from repro.core.masking import FaultContext as JaxFaultContext
from repro.core.masking import from_fault_map as jax_from_fault_map
from repro.core.masking import healthy as jax_healthy
from repro.core.masking import stack_contexts as jax_stack_contexts
from repro.data.synthetic import ClusterData as JaxClusterData
from repro.fleet.scheduler import FleetScheduler as JaxFleetScheduler
from repro.models import classifier as JC
from repro.train import optimizer as JO
from repro_torch.configs import get_arch
from repro_torch.convert import classifier_params_from_jax, context_from_ok
from repro_torch.core import (
    FaultContext,
    FaultMap,
    correlated_family,
    fault_linear,
    from_fault_map,
    gaussian_chip_rates,
    healthy,
    mask_params,
    random_fault_map,
    stack_contexts,
)
from repro_torch.core import faults as PF
from repro_torch.data.synthetic import ClusterData, make_classification_task
from repro_torch.fleet.scheduler import FleetScheduler
from repro_torch.kernels.common import assert_close, dtype_tol
from repro_torch.kernels.masked_matmul import ops as mm_ops
from repro_torch.models.classifier import classifier_forward, classifier_loss, init_classifier
from repro_torch.models.model import Model
from repro_torch.train import optimizer as O

F32 = torch.float32
CFG, JCFG = get_arch("paper-mlp"), jax_get_arch("paper-mlp")


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# config and classifier
# ---------------------------------------------------------------------------


def test_paper_mlp_config_matches_reference_and_model_refuses_it():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)
    with pytest.raises(NotImplementedError):
        Model(CFG, device="cpu")  # the classifier has its own module


@pytest.fixture(scope="module")
def classifier_setup():
    jparams = JC.init_classifier(JCFG, jax.random.PRNGKey(0), in_dim=32)
    params = classifier_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 32)).astype(np.float32)
    labels = rng.integers(0, 16, size=64).astype(np.int32)
    ok = random_fault_map(3, 32, 32, 0.2).ok_mask
    return jparams, params, x, labels, ok


@pytest.mark.parametrize("mode", ["none", "fap", "pallas"])
def test_classifier_matches_reference(classifier_setup, mode):
    jparams, params, x, labels, ok = classifier_setup
    jctx = JaxFaultContext(ok=None if mode == "none" else jnp.asarray(ok), mode=mode)
    ctx = context_from_ok(ok, mode, device="cpu")
    assert set(params) == set(jparams)
    want = JC.classifier_forward(jparams, jnp.asarray(x), JCFG, jctx)
    got = classifier_forward(params, torch.from_numpy(x), CFG, ctx)
    assert_close(got, np.asarray(want), F32)
    jloss, jm = JC.classifier_loss(jparams, {"x": jnp.asarray(x), "labels": jnp.asarray(labels)}, JCFG, jctx)
    loss, m = classifier_loss(params, {"x": torch.from_numpy(x), "labels": torch.from_numpy(labels).long()}, CFG, ctx)
    assert_close(loss, np.asarray(jloss), F32)
    assert float(m["accuracy"]) == float(jm["accuracy"])
    assert float(m["loss"]) == float(loss)


def test_classifier_gelu_is_the_tanh_approximation():
    """``jax.nn.gelu`` defaults to the tanh form; the erf form is farther from
    it than the tolerance, so the classifier parity above would catch a port
    that used ``F.gelu``'s default."""
    x = np.linspace(-4, 4, 401, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    assert_close(F.gelu(torch.from_numpy(x), approximate="tanh"), want, F32)
    rtol, atol = dtype_tol(F32)
    exact = F.gelu(torch.from_numpy(x)).numpy()
    assert not np.allclose(exact, want, rtol=rtol, atol=atol)


def test_init_classifier_shapes_seed_and_device():
    p = init_classifier(CFG, 0, in_dim=32, device="cpu")
    assert [tuple(p[f"w{i}"].shape) for i in range(4)] == [(32, 48), (48, 48), (48, 48), (48, 16)]
    assert all(float(p[f"b{i}"].abs().sum()) == 0 for i in range(4))
    q = init_classifier(CFG, 0, in_dim=32, device="cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)
    assert not torch.equal(p["w0"], init_classifier(CFG, 1, in_dim=32, device="cpu")["w0"])
    # N(0, 1/a): the first layer's std is near 1/sqrt(32)
    assert abs(float(p["w0"].std()) * 32**0.5 - 1) < 0.1


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_over_five_steps(moment_dtype):
    rng = np.random.default_rng(0)
    shapes = {"w0": (8, 6), "b0": (6,), "w1": (6, 3), "b1": (3,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (3 * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()} for _ in range(5)]
    kw = dict(weight_decay=0.01, grad_clip_norm=1.0, moment_dtype=moment_dtype)
    jcfg = JO.AdamWConfig(learning_rate=JO.cosine_schedule(1e-2, 2, 5), **kw)
    cfg = O.AdamWConfig(learning_rate=O.cosine_schedule(1e-2, 2, 5), **kw)
    jp, js = {k: jnp.asarray(v) for k, v in p0.items()}, None
    js = JO.adamw_init(jp, jcfg)
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    ts = O.adamw_init(tp, cfg)
    for g in grads:
        jp, js, jinfo = JO.adamw_update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, jcfg)
        tp, ts, info = O.adamw_update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, cfg)
        assert float(info["grad_norm"]) > 1.0  # clipping is active
        assert_close(info["lr"], np.asarray(jinfo["lr"]), F32)
    tol_dtype = F32 if moment_dtype == "float32" else torch.bfloat16
    for k in shapes:
        assert_close(tp[k], np.asarray(jp[k]), F32)
        assert ts["m"][k].dtype == getattr(torch, moment_dtype)
        assert_close(ts["m"][k].float(), np.asarray(js["m"][k].astype(jnp.float32)), tol_dtype)
        assert_close(ts["v"][k].float(), np.asarray(js["v"][k].astype(jnp.float32)), tol_dtype)
    assert int(ts["count"]) == int(js["count"]) == 5


def test_schedules_match_reference():
    steps = np.arange(0, 12, dtype=np.int32)
    want = np.asarray(JO.cosine_schedule(3e-3, 3, 10)(jnp.asarray(steps)))
    got = O.cosine_schedule(3e-3, 3, 10)(torch.from_numpy(steps))
    assert_close(got, want, F32)
    assert float(O.constant_schedule(0.5)(torch.tensor(3))) == 0.5


def test_adamw_constant_lr_and_no_clip():
    p = {"w": torch.ones(2, 2)}
    g = {"w": torch.full((2, 2), 0.1)}
    cfg = O.AdamWConfig(learning_rate=0.1, grad_clip_norm=None)
    new, state, _ = O.adamw_update(g, O.adamw_init(p, cfg), p, cfg)
    # the first bias-corrected step is sign(g) * lr / (1 + eps / |g|)
    assert torch.allclose(new["w"], torch.full((2, 2), 0.9), atol=1e-6)
    assert int(state["count"]) == 1


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_cluster_centers_are_bit_equal(seed):
    ref = JaxClusterData(seed=seed)
    port = ClusterData(seed=seed, device="cpu")
    assert port.centers.dtype == np.float32
    assert np.array_equal(port.centers, np.asarray(ref.centers))


def test_batch_at_is_deterministic_seekable_and_splits_differ():
    data = make_classification_task(CFG, seed=0, device="cpu")
    assert (data.dim, data.num_classes) == (32, 16)
    a = data.batch_at(7, 64)
    stream = [data.batch_at(s, 64) for s in range(10)]
    assert torch.equal(a["x"], stream[7]["x"]) and torch.equal(a["labels"], stream[7]["labels"])
    assert a["x"].dtype == F32 and a["labels"].dtype == torch.int64
    assert not torch.equal(stream[6]["x"], stream[7]["x"])
    ev = data.batch_at(7, 64, split="eval")
    assert not torch.equal(a["x"], ev["x"])
    assert [torch.equal(b["x"], data.batch_at(i, 512, "eval")["x"])
            for i, b in enumerate(data.eval_batches(3))] == [True] * 3
    # x is a center plus spread-scaled noise, in float32
    noise = (a["x"].numpy() - data.centers[a["labels"].numpy()]) / np.float32(0.3)
    assert 0.8 < float(noise.std()) < 1.2


def test_data_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterData()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_classifier(CFG, 0, 32)


# ---------------------------------------------------------------------------
# batched fault contexts
# ---------------------------------------------------------------------------


def test_stack_contexts_behaves_as_the_reference():
    fm = random_fault_map(0, 8, 8, 0.25)
    j = jax_stack_contexts([jax_from_fault_map(fm), jax_healthy()])
    p = stack_contexts([from_fault_map(fm, device="cpu"), healthy()])
    # healthy members are upcast to an all-ones mask
    assert p.population == j.population == 2 and p.mode == j.mode == "fap"
    assert np.array_equal(_np(p.ok), np.asarray(j.ok))
    assert float(p.ok[1].min()) == 1.0
    # an all-healthy stack collapses to healthy()
    assert stack_contexts([healthy(), healthy()]).ok is None
    assert jax_stack_contexts([jax_healthy(), jax_healthy()]).ok is None
    # empty, mixed modes, mixed shapes and already-batched inputs raise
    other = random_fault_map(1, 4, 4, 0.25)
    bad = {
        "empty": ([], []),
        "modes": ([from_fault_map(fm, "fap", device="cpu"), from_fault_map(fm, "kernel", device="cpu")],
                  [jax_from_fault_map(fm, "fap"), jax_from_fault_map(fm, "pallas")]),
        "shapes": ([from_fault_map(fm, device="cpu"), from_fault_map(other, device="cpu")],
                   [jax_from_fault_map(fm), jax_from_fault_map(other)]),
        "batched": ([from_fault_map(fm, device="cpu"), p], [jax_from_fault_map(fm), j]),
    }
    for port_in, ref_in in bad.values():
        with pytest.raises(ValueError):
            jax_stack_contexts(ref_in)
        with pytest.raises(ValueError):
            stack_contexts(port_in)


def test_batched_context_guard_raises_outside_vmap_only():
    maps = [random_fault_map(i, 8, 8, 0.2) for i in range(3)]
    stacked = stack_contexts([from_fault_map(fm, device="cpu") for fm in maps])
    x, w = torch.randn(2, 8), torch.randn(8, 12)
    with pytest.raises(ValueError, match="vmap"):
        fault_linear(x, w, stacked)
    mm_ops._PACKED.clear()
    for mode in ("fap", "kernel"):
        got = torch.func.vmap(lambda ok: fault_linear(x, w, FaultContext(ok=ok, mode=mode)))(stacked.ok)
        for i, fm in enumerate(maps):
            want = fault_linear(x, w, from_fault_map(fm, mode, device="cpu"))
            assert_close(got[i], want, F32)
    assert len(mm_ops._PACKED) == 0  # the bf16 kernels' bit packing is never reached


def test_mask_params_takes_a_dict():
    fm = random_fault_map(0, 32, 32, 0.3)
    p = init_classifier(CFG, 0, in_dim=32, device="cpu")
    shipped = mask_params(p, from_fault_map(fm, device="cpu"))
    for k, v in shipped.items():
        if v.ndim == 2:
            faulty = fm.faulty[np.arange(v.shape[0])[:, None] % 32, np.arange(v.shape[1])[None] % 32]
            assert (v.numpy()[faulty] == 0).all() and faulty.any()
        else:
            assert torch.equal(v, p[k])
    assert mask_params(p, healthy()) is p


# ---------------------------------------------------------------------------
# fleet helpers of core/faults.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_correlated_family_and_chip_rates_are_bit_equal(seed):
    ref = JF.correlated_family(seed, 12, 32, 32, base_rate=0.07, idio_rate=0.025)
    port = correlated_family(seed, 12, 32, 32, base_rate=0.07, idio_rate=0.025)
    assert [m.chip_id for m in port] == [m.chip_id for m in ref]
    assert all(np.array_equal(a.faulty, b.faulty) for a, b in zip(port, ref))
    assert np.array_equal(gaussian_chip_rates(seed, 50), JF.gaussian_chip_rates(seed, 50))
    rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
    assert np.array_equal(gaussian_chip_rates(rng_a, 9, 0.2, 0.1, 0.05, 0.3),
                          JF.gaussian_chip_rates(rng_b, 9, 0.2, 0.1, 0.05, 0.3))
    a, b = port[0], port[1]
    assert PF.overlap_rate(a, b) == JF.overlap_rate(ref[0], ref[1])
    assert PF.expected_merged_rate(0.1, 0.2) == JF.expected_merged_rate(0.1, 0.2)
    assert PF.expected_merged_rate(0.1, 0.2, 0.05) == JF.expected_merged_rate(0.1, 0.2, 0.05)
    assert np.array_equal((a | b).faulty, a.merge(b).faulty)
    assert (a | b).chip_id == (ref[0] | ref[1]).chip_id


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("suffix", ["", ".npz"])
def test_fault_map_files_load_in_either_package(tmp_path, writer, suffix):
    fm = random_fault_map(4, 16, 24, 0.2, chip_id="chip4")
    path = tmp_path / f"map{suffix}"
    if writer == "port":
        fm.save(path)
    else:
        JF.FaultMap(fm.faulty, chip_id=fm.chip_id).save(path)
    for loaded in (FaultMap.load(path), JF.FaultMap.load(path)):
        assert np.array_equal(loaded.faulty, fm.faulty) and loaded.chip_id == "chip4"


# ---------------------------------------------------------------------------
# fleet scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["lpt", "arrival"])
@pytest.mark.parametrize("size,multiple", [(4, 1), (16, 1), (3, 2)])
def test_fleet_scheduler_matches_reference(policy, size, multiple):
    costs = [float(c) for c in np.random.default_rng(size).integers(0, 200, size=23)]
    port = FleetScheduler(size, policy=policy, width_multiple=multiple)
    ref = JaxFleetScheduler(size, policy=policy, width_multiple=multiple)
    a, b = port.schedule(costs), ref.schedule(costs)
    assert a.order == b.order and a.policy == b.policy
    assert [(c.indices, c.costs, c.width) for c in a.chunks] == [(c.indices, c.costs, c.width) for c in b.chunks]
    assert (a.wasted_steps, a.span_steps) == (b.wasted_steps, b.span_steps)
    assert port.report(costs) == ref.report(costs)
    assert a.unpermute(a.permute(list(range(23)))) == list(range(23))
    with pytest.raises(ValueError):
        a.permute([1, 2])
    with pytest.raises(ValueError):
        FleetScheduler(4, policy="fifo")
