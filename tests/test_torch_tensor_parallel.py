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
from collections import Counter
from types import SimpleNamespace

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


def _split_calls_match(gathered: list, sharded: list, model: int) -> int:
    """Each gathered call is in the sharded step once, whole, or ``model``
    times at 1/model (a split GEMM's pieces); nothing else is. Returns the
    number of gathered calls that were split. The largest calls are matched
    first, so a piece is never taken for a smaller whole call."""
    left, split = Counter(sharded), 0
    for f in sorted(gathered, reverse=True):
        if left[f] > 0:
            left[f] -= 1
        else:
            assert f % model == 0 and left[f // model] >= model, \
                f"a {f}-FLOP call is neither whole nor split in the sharded step"
            left[f // model] -= model
            split += 1
    assert not +left, f"sharded calls with no gathered call: {dict(+left)}"
    return split


@pytest.mark.parametrize("arch", ["smollm-135m", "mixtral-8x22b", "falcon-mamba-7b"])
def test_reduced_lm_sharded_step_flops_equal_the_gathered_step(arch):
    """A reduced LM on a 1 x 2 mesh: the split step's FLOPs equal the
    gathered step's, and each of its calls is a gathered call, whole or at
    1/2 (a piece of the MLP, the attention projections, mixtral's experts
    split over the model axis, falcon-mamba's channel-split projections and
    per-piece scans), forward and backward."""
    cfg = reduce_config(get_arch(arch))
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
    assert _split_calls_match(out["gathered"][0], out["sharded"][0], 2) > 0


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
    # w0 (128, 48) split at column 24, w3 (48, 16) at column 8, each offset
    # a row and a column origin; b0, 1-D, adds none
    assert sorted(masks) == [(0, 0), (0, 8), (0, 24), (8, 0), (24, 0)]


def test_engine_keys_masks_only_by_gemm_view_origins():
    """The engine rolls a chunk's maps to the origins a piece of a split
    leaf of two or more dims can have on a GEMM's ``(d_in, d_out)`` view,
    each offset on the last two dims as a row and as a column, and to no
    other offset: mixtral's experts split over the model axis keep the
    whole map (experts 2 and 3 start at expert 2, no origin), and
    falcon-mamba's 1-D channel leaves (D, biases) add none."""
    ok = torch.stack([c.ok for c in (from_fault_map(random_fault_map(i, 24, 40, 0.1), device="cpu")
                                     for i in range(2))])
    want = {
        # wq's columns at 32, wk's and wv's at 16, wo's rows at 32, each also the other way
        "mixtral-8x22b": (2, {(0, 0), (0, 32), (0, 16), (32 % 24, 0), (16, 0)}),
        # in_proj's columns at 64, 128, 192; dt_w's (and conv_w's) at 32, 64,
        # 96; x_proj's, out_proj's (and A's) rows at 32, 64, 96; each also
        # the other way, which adds no new key here
        "falcon-mamba-7b": (4, {(0, 0), (0, 64 % 40), (0, 128 % 40), (0, 192 % 40), (0, 32), (0, 64 % 40),
                                (0, 96 % 40), (32 % 24, 0), (64 % 24, 0), (96 % 24, 0)}),
    }
    for arch, (model, keys) in want.items():
        cfg = reduce_config(get_arch(arch))
        params0 = M.param_dict(M.init_params(cfg, 0, device="cpu"))
        eng = make_fat_engine("sharded", mesh=make_fleet_mesh(1, model, devices=["cpu"] * model), cfg=cfg,
                              param_axes=M.param_specs(cfg), compute="sharded", population_size=2,
                              loss_fn=None, opt_cfg=AdamWConfig(), eval_batches=[])
        view = eng._slice(0)
        split = view._gather_member_params({k: v[None].expand(2, *v.shape) for k, v in params0.items()})
        assert set(view._constrain_masks(ok, split)) == keys, arch
    assert split["layers.0.ssm.conv_b"].offsets == (0, 32, 64, 96)


# ---------------------------------------------------------------------------
# the MoE experts: fault_einsum on a split expert stack
# ---------------------------------------------------------------------------

E = 4
# (split, its axis, a piece's extent): over the experts, or inside them off
# the map's grid (40: origins 8, 16, 24 mod 32)
EXPERT_SPLITS = {"experts": (-3, 2), "columns": (-1, 40), "rows": (-2, 40)}


def _expert_case(spec, split, dtype):
    rng = np.random.default_rng(13)
    axis, size = EXPERT_SPLITS[split]
    k, n = (48, 48)
    if axis == -1:
        n = 2 * size
    elif axis == -2:
        k = 2 * size
    x = torch.from_numpy(rng.standard_normal((E, 6, k))).to(dtype)
    w = torch.from_numpy(rng.standard_normal((E, k, n)) / np.sqrt(k)).to(dtype)
    return x, w, _split(w, axis, size)


@pytest.mark.parametrize("mode,dtype", MODES, ids=lambda v: str(v).replace("torch.", ""))
@pytest.mark.parametrize("split", list(EXPERT_SPLITS))
@pytest.mark.parametrize("spec", MK.EXPERT_SPECS)
def test_split_fault_einsum_equals_the_whole_expert_stack(spec, split, mode, dtype):
    """Split over the experts (each piece's experts on their slice of the
    tokens) or inside them (each piece under its rolled map): the whole
    stack's einsum, for one chip and under ``vmap`` over two chips' maps
    (in ``kernel`` mode: the chips x experts route of the masked GEMM's
    custom op, its plain version on the host)."""
    x, w, ws = _expert_case(spec, split, dtype)
    ctx = FaultContext(ok=_ok(), mode=mode)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(fault_einsum(spec, x, ws, ctx), fault_einsum(spec, x, w, ctx), rtol=rtol, atol=atol)
    oks = torch.stack([_ok(), _ok(SEED + 1)])

    def run(weight):
        return torch.func.vmap(lambda ok: fault_einsum(spec, x, weight, FaultContext(ok=ok, mode=mode)))(oks)

    torch.testing.assert_close(run(ws), run(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("mode", ["fap", "kernel"])
def test_an_expert_split_keeps_the_whole_map_and_a_split_inside_rolls_it(monkeypatch, mode):
    """No piece of a stack split over its experts rolls the map (each
    expert's view starts at 0); a stack split inside its experts off the
    map's grid is wrong without the roll."""
    ctx = FaultContext(ok=_ok(), mode=mode)
    x, w, ws = _expert_case("ecd,edf->ecf", "columns", torch.float64)
    want = fault_einsum("ecd,edf->ecf", x, w, ctx)
    monkeypatch.setattr(MK, "rolled_map", lambda ok, r0, c0: ok)
    assert (fault_einsum("ecd,edf->ecf", x, ws, ctx) - want).abs().max() > 1e-2

    def refuse(ok, r0, c0):
        raise AssertionError(f"an expert piece rolled the map to ({r0}, {c0})")

    monkeypatch.setattr(MK, "rolled_map", refuse)
    x, w, ws = _expert_case("ecf,efd->ecd", "experts", torch.float64)
    torch.testing.assert_close(fault_einsum("ecf,efd->ecd", x, ws, ctx), fault_einsum("ecf,efd->ecd", x, w, ctx),
                               rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="expert specs"):
        fault_einsum("bd,df->bf", x[0], ws, ctx)


# ---------------------------------------------------------------------------
# the SSM block on channel-split leaves
# ---------------------------------------------------------------------------

# each SSM leaf's split dim under the rules: "inner" on the channels
SSM_AXES = {"in_proj": -1, "conv_w": -1, "conv_b": -1, "x_proj": -2, "dt_w": -1, "dt_b": -1, "a_log": -2,
            "d_skip": -1, "out_proj": -2}


def _ssm_layer():
    cfg = reduce_config(get_arch("falcon-mamba-7b"))
    layer = M.param_dict(M.init_params(cfg, 3, device="cpu"))
    p = {k.rsplit(".", 1)[-1]: v for k, v in layer.items() if k.startswith("layers.0.ssm.")}
    rng = np.random.default_rng(4)
    p["conv_b"] = torch.from_numpy(rng.standard_normal(p["conv_b"].shape).astype(np.float32)) * 0.1
    p["d_skip"] = p["d_skip"] + torch.from_numpy(rng.standard_normal(p["d_skip"].shape).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32))
    return cfg, p, x


def _split_ssm(p, m):
    return {k: _split(v, SSM_AXES[k], v.shape[SSM_AXES[k]] // m) for k, v in p.items()}


@pytest.mark.parametrize("mode", ["fap", "kernel"])
@pytest.mark.parametrize("m", [2, 4])
def test_channel_split_ssm_block_equals_the_whole_block(m, mode):
    """Every ``"inner"`` leaf split m ways (at m = 2 ``in_proj``'s pieces
    are its x and z halves): the block's output, its prefill cache, and
    under ``vmap`` of ``grad`` over two chips its parameter gradients,
    joined, equal the whole block's, on a 24 x 40 map (the pieces start off
    its grid)."""
    from repro_torch.models.ssm import ssm_block

    cfg, p, x = _ssm_layer()
    ps = _split_ssm(p, m)
    if m == 2:
        di = cfg.d_inner
        assert torch.equal(ps["in_proj"].pieces[0], p["in_proj"][:, :di])
        assert torch.equal(ps["in_proj"].pieces[1], p["in_proj"][:, di:])
    ok = from_fault_map(random_fault_map(5, 24, 40, 0.15), mode, device="cpu").ok
    ctx = FaultContext(ok=ok, mode=mode)
    rtol, atol = dtype_tol(torch.float32)
    y, cache = ssm_block(SimpleNamespace(**p), x, cfg, ctx, build_cache=True)
    ys, caches = ssm_block(SimpleNamespace(**ps), x, cfg, ctx, build_cache=True)
    torch.testing.assert_close(ys, y, rtol=rtol, atol=atol)
    torch.testing.assert_close(caches.h, cache.h, rtol=rtol, atol=atol)
    assert torch.equal(caches.conv, cache.conv)
    oks = torch.stack([ok, from_fault_map(random_fault_map(6, 24, 40, 0.15), mode, device="cpu").ok])

    def grads(params):
        def loss(q, okc):
            return ssm_block(SimpleNamespace(**q), x, cfg, FaultContext(ok=okc, mode=mode))[0].square().mean()

        return torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(params, oks)

    g, gs = grads(p), grads(ps)
    for k in p:
        assert isinstance(gs[k], SplitTensor)
        torch.testing.assert_close(gs[k].full(), g[k], rtol=rtol, atol=atol, msg=k)
        assert g[k].abs().max() > 0, k
