"""Tensor-parallel compute on split leaves (the sharded population engine's
``compute="sharded"``) in the port, on the CPU.

Each GEMM of a split weight runs at its pieces' shapes, each piece masked
through the chip's map rolled to the piece's origin on the whole weight's
``(d_in, d_out)`` view, and must equal the GEMM on the whole weight: float64
at 1e-12, float32 at ``dtype_tol``. The map is a random 32 x 32 map, which
no shift used here leaves unchanged, and origins off multiples of 32 are
the cases that see the roll. The whole weight's GEMM is also held to the
reference's ``fault_linear``. The engine-level results against the
reference are ``tests/test_torch_efat.py`` (``sharded-tp-2x2``, the 4 x 2
trainer) and ``tests/test_torch_lm_fat.py`` (``sharded-tp``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode, flop_registry
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core.masking import FaultContext as JaxFaultContext
from repro.core.masking import fault_linear as jax_fault_linear
from repro_torch.configs import get_arch, reduce_config
from repro_torch.core import FaultContext, fault_einsum, fault_linear, from_fault_map, random_fault_map
from repro_torch.core import masking as MK
from repro_torch.core.mapping import periodic_mask, rolled_map
from repro_torch.fleet import ShardedPopulationEngine
from repro_torch.fleet.tensor_parallel import SplitTensor, vocab_parallel_lookup
from repro_torch.kernels.common import dtype_tol
from repro_torch.launch.mesh import make_fleet_mesh
from repro_torch.models import model as M
from repro_torch.models.classifier import classifier_loss, classifier_param_axes, init_classifier
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.population import make_fat_engine

R = C = 32
SEED = 1234


def _ok(seed=SEED):
    ok = (np.random.default_rng(seed).random((R, C)) > 0.3).astype(np.float32)
    t = torch.from_numpy(ok)
    for shift in ((8, 0), (0, 8), (16, 0), (0, 16), (24, 0), (0, 24), (0, 40 % C)):
        assert not torch.equal(torch.roll(t, shift, (0, 1)), t)
    return t


def _split(w: torch.Tensor, axis: int, size: int) -> SplitTensor:
    n = w.shape[axis]
    offsets = list(range(0, n, size))
    return SplitTensor([w.narrow(axis, o, size) for o in offsets], axis, offsets)


TOL = {torch.float64: (1e-12, 1e-12), torch.float32: dtype_tol(torch.float32)}
# (mode, dtype): fap in float64 and float32; kernel mode's plain version
# computes in float32 whatever x's dtype, so it is held in float32
MODES = [("fap", torch.float64), ("fap", torch.float32), ("kernel", torch.float32)]
# a piece's extent along the split dim: 40 puts origins at 40, 80, 120 (8,
# 16, 24 mod 32), 64 at multiples of 32
SIZES = {"off-grid": 40, "on-grid": 64}


def _case(axis, pieces, size, dtype):
    rng = np.random.default_rng(7)
    k, n = (48, pieces * size) if axis == -1 else (pieces * size, 48)
    x = torch.from_numpy(rng.standard_normal((3, 5, k))).to(dtype)
    w = torch.from_numpy(rng.standard_normal((k, n)) / np.sqrt(k)).to(dtype)
    return x, w


@pytest.mark.parametrize("mode,dtype", MODES, ids=lambda v: str(v).replace("torch.", ""))
@pytest.mark.parametrize("origins", list(SIZES))
@pytest.mark.parametrize("pieces", [2, 4])
@pytest.mark.parametrize("axis", [-1, -2], ids=["column", "row"])
def test_split_fault_linear_equals_the_whole_weight(axis, pieces, origins, mode, dtype):
    x, w = _case(axis, pieces, SIZES[origins], dtype)
    ctx = FaultContext(ok=_ok(), mode=mode)
    got = fault_linear(x, _split(w, axis, SIZES[origins]), ctx)
    want = fault_linear(x, w, ctx)
    assert got.shape == want.shape and got.dtype == want.dtype
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("mode", ["fap", "kernel"])
@pytest.mark.parametrize("axis", [-1, -2], ids=["column", "row"])
def test_without_the_roll_the_split_gemm_is_wrong(monkeypatch, axis, mode):
    """Each piece masked with the unrolled map: pieces at origins off the
    map's grid read other PEs, and the split GEMM leaves the whole one."""
    x, w = _case(axis, 4, SIZES["off-grid"], torch.float64)
    ctx = FaultContext(ok=_ok(), mode=mode)
    want = fault_linear(x, w, ctx)
    monkeypatch.setattr(MK, "rolled_map", lambda ok, r0, c0: ok)
    got = fault_linear(x, _split(w, axis, SIZES["off-grid"]), ctx)
    assert (got - want).abs().max() > 1e-2


def test_rolled_map_is_the_slice_of_the_whole_mask():
    ok = _ok()
    full = periodic_mask((200, 300), ok)
    for r0, c0 in ((0, 0), (40, 0), (0, 72), (24, 8), (64, 96)):
        piece = periodic_mask((50, 60), rolled_map(ok, r0, c0))
        assert torch.equal(piece, full[r0:r0 + 50, c0:c0 + 60])
    stack = torch.stack([ok, _ok(SEED + 1)])  # a chip stack rolls each chip alike
    assert torch.equal(rolled_map(stack, 40, 8)[1], rolled_map(stack[1], 40, 8))
    assert rolled_map(ok, 64, 32) is ok


def test_split_gemm_matches_the_reference_fault_linear():
    """The column split with biases and the row split, float32 fap: the
    reference's ``fault_linear`` on the whole weight."""
    x, w = _case(-1, 4, 40, torch.float32)
    ok = _ok()
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(w.shape[-1]).astype(np.float32))
    ctx = FaultContext(ok=ok, mode="fap")
    got = fault_linear(x, _split(w, -1, 40), ctx, bias=_split(b, -1, 40))
    jctx = JaxFaultContext(ok=jnp.asarray(ok.numpy()), mode="fap")
    want = np.asarray(jax_fault_linear(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), jctx)) + b.numpy()
    rtol, atol = dtype_tol(torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    x, w = _case(-2, 4, 40, torch.float32)
    got = fault_linear(x, _split(w, -2, 40), ctx)
    want = np.asarray(jax_fault_linear(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), jctx))
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def test_transpose_of_a_vocab_split_table_is_the_column_split_unembed():
    """``SplitTensor.T`` of a row-split (vocab) table is the tied unembed:
    a column split whose origins are the vocab offsets; and the vocab-
    parallel lookup equals ``table[ids]``, values and gradients."""
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.standard_normal((120, 48)))
    split = _split(table, -2, 40)
    assert split.T.axis == -1 and split.T.offsets == (0, 40, 80) and torch.equal(split.T.full(), table.T)
    x = torch.from_numpy(rng.standard_normal((2, 3, 48)))
    ctx = FaultContext(ok=_ok(), mode="fap")
    torch.testing.assert_close(fault_linear(x, split.T, ctx), fault_linear(x, table.T, ctx), rtol=1e-12, atol=1e-12)
    ids = torch.from_numpy(rng.integers(0, 120, (4, 7)))
    torch.testing.assert_close(vocab_parallel_lookup(split, ids), table[ids], rtol=0, atol=0)
    pieces = [p.clone().requires_grad_() for p in split.pieces]
    vocab_parallel_lookup(SplitTensor(pieces, -2, split.offsets), ids).square().sum().backward()
    whole = table.clone().requires_grad_()
    whole[ids].square().sum().backward()
    torch.testing.assert_close(torch.cat([p.grad for p in pieces]), whole.grad, rtol=0, atol=0)


def test_split_tensor_is_a_pytree_node_for_vmap_and_grad():
    """``torch.func`` maps and differentiates the pieces: the gradient of a
    split weight is split alike and joins to the whole weight's."""
    x, w = _case(-1, 2, 40, torch.float64)
    ok = torch.stack([_ok(), _ok(SEED + 1)])
    wn = w.expand(2, *w.shape).clone()

    def loss(weight, mask):
        return fault_linear(x, weight, FaultContext(ok=mask, mode="fap")).square().sum()

    g_split = torch.func.vmap(torch.func.grad(loss))(_split(wn, -1, 40), ok)
    g_whole = torch.func.vmap(torch.func.grad(loss))(wn, ok)
    assert isinstance(g_split, SplitTensor) and g_split.offsets == (0, 40)
    torch.testing.assert_close(g_split.full(), g_whole, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the optimizer: the grad norm sums the pieces once
# ---------------------------------------------------------------------------


def test_clipped_grad_norm_over_pieces_equals_the_gathered_one():
    rng = np.random.default_rng(11)
    shapes = {"a": (48, 80), "b": (80, 48), "c": (80,), "d": (48,)}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in shapes.items()}
    grads = {k: torch.from_numpy(3 * rng.standard_normal(s).astype(np.float32)) for k, s in shapes.items()}
    # "a" split on columns, "b" on rows, "c" in four, "d" whole (one piece)
    layout = {"a": (-1, 40), "b": (-2, 40), "c": (-1, 20)}

    def split(tree):
        return {k: _split(v, *layout[k]) if k in layout else v for k, v in tree.items()}

    cfg = AdamWConfig(learning_rate=1e-2, weight_decay=0.1, grad_clip_norm=1.0)
    p_full, s_full, i_full = adamw_update(grads, adamw_init(params, cfg), params, cfg)
    p_split, s_split, i_split = adamw_update(split(grads), adamw_init(split(params), cfg), split(params), cfg)
    assert float(i_full["grad_norm"]) > 10 * cfg.grad_clip_norm  # the clip engages
    rtol, atol = dtype_tol(torch.float32)
    torch.testing.assert_close(i_split["grad_norm"], i_full["grad_norm"], rtol=rtol, atol=0)
    for k in shapes:
        for got, want in ((p_split[k], p_full[k]), (s_split["m"][k], s_full["m"][k]), (s_split["v"][k], s_full["v"][k])):
            if k in layout:
                assert isinstance(got, SplitTensor)
                got = got.full()
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the engine: FLOPs at the pieces' shapes, maps prebuilt, refusals
# ---------------------------------------------------------------------------


class _GemmCalls(TorchDispatchMode):
    """Each call's FLOPs, for every op ``FlopCounterMode`` counts."""

    def __init__(self):
        super().__init__()
        self.flops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func._overloadpacket in flop_registry:
            self.flops.append(int(flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)))
        return out


def _classifier_engine(compute, model, mode="fap"):
    cfg = get_arch("paper-mlp")
    params0 = init_classifier(cfg, 0, 128, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 16, 64))}
    eng = make_fat_engine("sharded", mesh=make_fleet_mesh(1, model, devices=["cpu"] * model), cfg=cfg,
                          param_axes=classifier_param_axes(cfg), compute=compute, population_size=2,
                          loss_fn=lambda p, b, ctx: classifier_loss(p, b, cfg, ctx),
                          opt_cfg=AdamWConfig(learning_rate=3e-3), eval_batches=[batch])
    ctxs = [from_fault_map(random_fault_map(i, 32, 32, 0.1), mode, device="cpu") for i in range(2)]
    return eng, params0, ctxs, batch


@pytest.mark.parametrize("model", [2, 4])
def test_sharded_step_runs_every_gemm_at_its_pieces_shapes(model):
    """One training step of 2 members (a 1 x model mesh): under
    ``compute="sharded"`` every GEMM call (forward and backward) does
    1/model of a gathered call's FLOPs, model times as often, and the
    total equals the gathered step's. Nothing is gathered for a GEMM."""
    counts = {}
    for compute in ("gathered", "sharded"):
        eng, params0, ctxs, batch = _classifier_engine(compute, model)
        calls, total = _GemmCalls(), FlopCounterMode(display=False)
        with total, calls:
            eng.fit_batch(params0, ctxs, [1, 1], lambda step: batch)
        counts[compute] = (sorted(calls.flops), total.get_total_flops())
    (gathered, g_total), (sharded, s_total) = counts["gathered"], counts["sharded"]
    assert gathered and s_total == g_total == sum(gathered)
    assert all(f % model == 0 for f in gathered)
    assert sharded == sorted(f // model for f in gathered for _ in range(model))


def test_reduced_lm_sharded_step_flops_equal_the_gathered_step():
    """The reduced SmolLM on a 1 x 2 mesh: the split step's FLOPs equal the
    gathered step's, and its largest GEMM is smaller (the MLP's and the
    attention projections' pieces)."""
    cfg = reduce_config(get_arch("smollm-135m"))
    params0 = M.param_dict(M.init_params(cfg, 0, device="cpu"))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    ctxs = [from_fault_map(random_fault_map(i, 16, 16, 0.1), device="cpu") for i in range(2)]
    out = {}
    for compute in ("gathered", "sharded"):
        eng = make_fat_engine("sharded", mesh=make_fleet_mesh(1, 2, devices=["cpu"] * 2), cfg=cfg,
                              param_axes=M.param_specs(cfg), compute=compute, population_size=2,
                              loss_fn=lambda p, b, ctx: M.loss_fn(p, b, cfg, ctx, remat="none"),
                              opt_cfg=AdamWConfig(learning_rate=3e-3), eval_batches=[batch])
        calls, total = _GemmCalls(), FlopCounterMode(display=False)
        with total, calls:
            eng.fit_batch(params0, ctxs, [1, 1], lambda step: batch)
        out[compute] = (calls.flops, total.get_total_flops())
    assert out["sharded"][1] == out["gathered"][1]
    assert len(out["sharded"][0]) > len(out["gathered"][0])


@pytest.mark.parametrize("mode", ["fap", "kernel"])
def test_engine_prebuilds_every_rolled_map(monkeypatch, mode):
    """A chunk's maps are rolled once when they enter the math, to every
    origin of the split leaves: no GEMM rolls a map itself, and the
    evaluation equals the gathered engine's."""
    eng, params0, ctxs, batch = _classifier_engine("sharded", 2, mode)
    want = _classifier_engine("gathered", 2, mode)[0].evaluate_batch([params0] * 2, ctxs)

    def refuse(ok, r0, c0):
        raise AssertionError(f"a GEMM rolled its own map to ({r0}, {c0})")

    monkeypatch.setattr(MK, "rolled_map", refuse)
    got = eng.evaluate_batch([params0] * 2, ctxs)
    assert got == pytest.approx(want, abs=1e-6)
    view = eng._slice(0)
    split = view._gather_member_params({k: v[None].expand(2, *v.shape) for k, v in params0.items()})
    masks = view._constrain_masks(torch.stack([c.ok for c in ctxs]), split)
    # w0 (128, 48) and b0 split at column 24; w3 (48, 16) at column 8
    assert sorted(masks) == [(0, 0), (0, 8), (0, 24), (8, 0), (24, 0)]


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-maverick-400b-a17b", "falcon-mamba-7b", "hymba-1.5b"])
def test_moe_and_ssm_configs_are_refused_under_compute_sharded(arch):
    cfg = get_arch(arch)
    kw = dict(mesh=make_fleet_mesh(2, 2, devices=["cpu"] * 4), cfg=cfg, param_axes=M.param_specs(cfg),
              loss_fn=None, opt_cfg=AdamWConfig(), eval_batches=[])
    with pytest.raises(ValueError, match="ROADMAP.md"):
        ShardedPopulationEngine(compute="sharded", **kw)
    assert ShardedPopulationEngine(**kw).compute == "gathered"


def test_fault_einsum_refuses_a_split_weight():
    w = torch.zeros(2, 8, 80)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        fault_einsum("ecd,edf->ecf", torch.zeros(2, 3, 8), _split(w, -1, 40), FaultContext(ok=_ok(), mode="fap"))
