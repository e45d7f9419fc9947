"""The port's SSM slice against the reference package: the selective scan,
its decode step, the SSM block, and reduced falcon-mamba (ssm) and hymba
(hybrid) end to end on one set of weights handed over by
``repro_torch.convert``.

Inputs are made with numpy from a seed and given to both packages.
Tolerances:

- the scan's ``h_last``, and its fp32 ``y``: rtol 2e-5 / atol 1e-4, the
  reference's own kernel tests' tolerance. Both sides run the recurrence in
  fp32 and differ only in the order of the N-sum and in exp's last bit;
- the scan's bf16 ``y`` (bf16 u, fp32 dt, as the model gives them): rtol
  2e-2 / atol 1e-2. Both sides round the same fp32 value to bf16, so they
  differ by at most one bf16 step (2^-8 relative) where the fp32 values
  straddle a rounding boundary;
- blocks, models and served logprobs: ``dtype_tol(float32)`` (rtol 2e-5,
  atol 2e-4); the reduced configs run in float32 on the CPU.
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
from repro.kernels.mamba_scan.mamba_scan import selective_scan_pallas
from repro.kernels.mamba_scan.ref import selective_scan_ref as jax_selective_scan_ref
from repro.kernels.mamba_scan.ref import selective_step_ref as jax_selective_step
from repro.models import model as JM
from repro.models import ssm as JS
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_arch, reduce_config
from repro_torch.convert import context_from_ok, params_from_jax
from repro_torch.core import random_fault_map
from repro_torch.kernels.common import assert_close
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan.ops import (
    selective_scan, selective_scan_bwd, selective_scan_bwd_ref, selective_scan_ref, selective_step,
)
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.serve import ServeEngine

F32 = torch.float32
MODES = ["none", "fap", "pallas"]
ARCHS = ["falcon-mamba-7b", "hymba-1.5b"]
SCAN_TOL = dict(rtol=2e-5, atol=1e-4)
BF16_Y_TOL = dict(rtol=2e-2, atol=1e-2)
# (B, L, D, N, bd, bl): the reference's kernel sweep, and a ragged case
SCAN_CASES = [
    (2, 64, 32, 8, 16, 16), (1, 128, 64, 16, 64, 32), (3, 32, 16, 4, 16, 32), (2, 37, 11, 4, 256, 128),
]


def _scan_inputs(b, l, d, n, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, l, d), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, d), np.float32)))  # softplus
    a = -np.exp(rng.standard_normal((d, n), np.float32))
    bb = rng.standard_normal((b, l, n), np.float32)
    c = rng.standard_normal((b, l, n), np.float32)
    dd = rng.standard_normal((d,), np.float32)
    return u, dt, a, bb, c, dd


def _t(*arrays):
    return [torch.from_numpy(np.asarray(x)) for x in arrays]


def _tok(a):
    return torch.from_numpy(np.asarray(a, np.int64))


# ---------------------------------------------------------------------------
# the scan and its decode step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("u_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,d,n,bd,bl", SCAN_CASES)
def test_selective_scan_plain_matches_reference_and_pallas(b, l, d, n, bd, bl, u_dtype):
    u, dt, a, bb, c, dd = _scan_inputs(b, l, d, n)
    ju = jnp.asarray(u).astype(u_dtype)
    ref_y, ref_h = jax_selective_scan_ref(ju, jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bb), jnp.asarray(c), jnp.asarray(dd))
    ker_y, ker_h = selective_scan_pallas(
        ju, jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bb), jnp.asarray(c), jnp.asarray(dd),
        bd=bd, bl=bl, interpret=True,
    )
    tu = torch.from_numpy(u).to(getattr(torch, u_dtype))
    # the wrapper on a CPU tensor is the plain version
    got_y, got_h = selective_scan(tu, *_t(dt, a, bb, c, dd))
    plain_y, plain_h = selective_scan_ref(tu, *_t(dt, a, bb, c, dd))
    assert torch.equal(got_y, plain_y) and torch.equal(got_h, plain_h)
    assert got_y.dtype == tu.dtype and got_h.dtype == F32 and got_h.shape == (b, d, n)
    y_tol = SCAN_TOL if u_dtype == "float32" else BF16_Y_TOL
    for ref_yy, ref_hh in ((ref_y, ref_h), (ker_y, ker_h)):
        np.testing.assert_allclose(got_y.float().numpy(), np.asarray(ref_yy, np.float32), **y_tol)
        np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_hh), **SCAN_TOL)


def test_selective_scan_takes_strided_b_and_c():
    """The model hands B and C over as slices of the x_proj output."""
    u, dt, a, bb, c, dd = _scan_inputs(2, 16, 8, 4, seed=1)
    dbc = torch.from_numpy(np.concatenate([np.zeros((2, 16, 3), np.float32), bb, c], axis=-1))
    _, bs, cs = torch.split(dbc, [3, 4, 4], dim=-1)
    assert not bs.is_contiguous()
    got = selective_scan(*_t(u, dt, a), bs, cs, torch.from_numpy(dd))
    ref = jax_selective_scan_ref(*(jnp.asarray(x) for x in (u, dt, a, bb, c, dd)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **SCAN_TOL)


def test_selective_scan_ref_under_vmap_of_grad_equals_a_member_loop():
    """``vmap`` of ``grad_and_value`` over three members (each its own
    u, A and D): y, h_last and every input's gradient equal one member at a
    time under plain autograd. The plain version writes nothing in place,
    so the map can batch it."""
    u, dt, a, bb, c, dd = _scan_inputs(2, 12, 8, 4, seed=3)
    rng = np.random.default_rng(9)
    us = torch.from_numpy(u[None] + rng.standard_normal((3, *u.shape), np.float32))
    a_s = torch.from_numpy(a[None] * (1 + 0.1 * np.arange(3, dtype=np.float32))[:, None, None])
    ds = torch.from_numpy(dd[None] + np.arange(3, dtype=np.float32)[:, None])
    dt_t, b_t, c_t = _t(dt, bb, c)

    def loss(ut, at, dtt, bt, ct, d_t):
        y, h = selective_scan_ref(ut, dtt, at, bt, ct, d_t)
        return y.square().mean() + h.square().mean(), (y, h)

    grad = torch.func.grad_and_value(loss, argnums=(0, 1, 2, 3, 4, 5), has_aux=True)
    grads, (_, (ys, hs)) = torch.func.vmap(grad, in_dims=(0, 0, None, None, None, 0))(us, a_s, dt_t, b_t, c_t, ds)
    for i in range(3):
        ins = [t.clone().requires_grad_() for t in (us[i], a_s[i], dt_t, b_t, c_t, ds[i])]
        v, (y, h) = loss(*ins)
        v.backward()
        torch.testing.assert_close(ys[i], y.detach(), rtol=0, atol=0)
        torch.testing.assert_close(hs[i], h.detach(), rtol=0, atol=0)
        for g, t in zip(grads, ins):  # each member's gradient, for the shared inputs too
            torch.testing.assert_close(g[i], t.grad, **SCAN_TOL)


@pytest.mark.parametrize("with_gh", [False, True])
@pytest.mark.parametrize("b,l,d,n", [(2, 19, 12, 4), (3, 8, 5, 1), (1, 1, 7, 17)])
def test_selective_scan_bwd_ref_matches_the_reference_vjp(b, l, d, n, with_gh):
    """The backward kernel's plain version against ``jax.vjp`` of the
    reference's scan on the same inputs and cotangents (gh of h_last, or
    none), every input's gradient at the scan's tolerance in units of its
    largest value (gA, gB and gC are sums over B x L or D)."""
    ins = _scan_inputs(b, l, d, n, seed=b + l)
    rng = np.random.default_rng(5)
    gy = rng.standard_normal((b, l, d), np.float32)
    gh = rng.standard_normal((b, d, n), np.float32) if with_gh else np.zeros((b, d, n), np.float32)
    _, vjp = jax.vjp(jax_selective_scan_ref, *[jnp.asarray(x) for x in ins])
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    got = selective_scan_bwd_ref(*_t(*ins), torch.from_numpy(gy), torch.from_numpy(gh) if with_gh else None)
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g.numpy() / scale, w / scale, **SCAN_TOL)


def test_selective_scan_bwd_ref_takes_a_chip_axis():
    """With a chip axis (2 chips x 2 rows, each its own A and D) the plain
    backward equals each chip's own backward, gA and gD one a chip."""
    u, dt, a, bb, c, dd = _t(*_scan_inputs(4, 10, 6, 3, seed=8))
    a2, d2 = torch.stack([a, 1.2 * a]), torch.stack([dd, dd + 1])
    gy = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 10, 6), np.float32))
    got = selective_scan_bwd_ref(u, dt, a2, bb, c, d2, gy)
    for chip in range(2):
        rows = slice(2 * chip, 2 * chip + 2)
        want = selective_scan_bwd_ref(u[rows], dt[rows], a2[chip], bb[rows], c[rows], d2[chip], gy[rows])
        for i, (g, w) in enumerate(zip(got, want)):
            torch.testing.assert_close(g[chip] if i in (2, 5) else g[rows], w, rtol=1e-6, atol=1e-6)


def test_the_scans_autograd_function_equals_plain_autograd_and_batches_its_backward(monkeypatch):
    """The card's training route, run on the CPU: the autograd function
    whose forward is ``selective_scan`` and whose backward is
    ``selective_scan_bwd`` gives plain autograd's gradients under
    ``autograd.grad``, ``torch.func.grad`` and ``vmap`` of
    ``grad_and_value`` over three members; under ``vmap`` the backward
    reaches ``selective_scan_bwd`` once, with the members as its chip axis
    (its vmap rule), as the forward reaches ``selective_scan``. On the CPU
    ``selective_scan`` itself sends a differentiated call to the plain
    version, which autograd differentiates."""
    u, dt, a, bb, c, dd = _t(*_scan_inputs(2, 12, 8, 4, seed=3))

    def loss(fn, ut, at):
        y, h = fn(ut, dt, at, bb, c, dd)
        return y.square().mean() + h.square().mean()

    def route(*ts):
        return scan_ops._DifferentiableScan.apply(*ts, None)

    def plain(ut, at):
        leaves = [ut.clone().requires_grad_(), at.clone().requires_grad_()]
        return torch.autograd.grad(loss(selective_scan_ref, *leaves), leaves)

    want = plain(u, a)
    leaves = [u.clone().requires_grad_(), a.clone().requires_grad_()]
    for got in (torch.autograd.grad(loss(route, *leaves), leaves),
                torch.func.grad(lambda ut, at: loss(route, ut, at), argnums=(0, 1))(u, a)):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **SCAN_TOL)
    seen = []
    bwd = scan_ops.selective_scan_bwd

    def spy(*ts):
        seen.append(ts[2].dim())
        return bwd(*ts)

    monkeypatch.setattr(scan_ops, "selective_scan_bwd", spy)
    us = torch.stack([u, 0.5 * u, u + 1])
    a_s = torch.stack([a, 1.1 * a, 0.9 * a])
    grads, _ = torch.func.vmap(torch.func.grad_and_value(lambda ut, at: loss(route, ut, at), argnums=(0, 1)))(us, a_s)
    assert seen == [2, 3]  # the grad level's call, then the vmap rule's chip-batched one
    for i in range(3):
        for g, w in zip(grads, plain(us[i], a_s[i])):
            torch.testing.assert_close(g[i], w, **SCAN_TOL)
    assert selective_scan(u.clone().requires_grad_(), dt, a, bb, c, dd)[0].grad_fn.name() != "_DifferentiableScanBackward"


def test_selective_scan_bwd_on_the_cpu_runs_the_plain_version():
    """On CPU tensors the backward's wrapper is its plain version, bit for
    bit, and launches nothing."""
    ins = _t(*_scan_inputs(2, 9, 8, 4, seed=2))
    gy = torch.ones(2, 9, 8)
    before = selective_scan_bwd.launches
    for g, w in zip(selective_scan_bwd(*ins, gy), selective_scan_bwd_ref(*ins, gy)):
        assert torch.equal(g, w)
    assert selective_scan_bwd.launches == before


@pytest.mark.parametrize("u_dtype", ["float32", "bfloat16"])
def test_selective_step_matches_reference(u_dtype):
    b, d, n = 3, 12, 8
    rng = np.random.default_rng(2)
    h = rng.standard_normal((b, d, n), np.float32)
    u, dt = rng.standard_normal((b, d), np.float32), np.abs(rng.standard_normal((b, d), np.float32))
    a = -np.exp(rng.standard_normal((d, n), np.float32))
    bt, ct = rng.standard_normal((b, n), np.float32), rng.standard_normal((b, n), np.float32)
    dd = rng.standard_normal((d,), np.float32)
    ju = jnp.asarray(u).astype(u_dtype)
    ref_y, ref_h = jax_selective_step(jnp.asarray(h), ju, *(jnp.asarray(x) for x in (dt, a, bt, ct, dd)))
    tu = torch.from_numpy(u).to(getattr(torch, u_dtype))
    got_y, got_h = selective_step(torch.from_numpy(h), tu, *_t(dt, a, bt, ct, dd))
    assert got_y.dtype == tu.dtype
    y_tol = SCAN_TOL if u_dtype == "float32" else BF16_Y_TOL
    np.testing.assert_allclose(got_y.float().numpy(), np.asarray(ref_y, np.float32), **y_tol)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), **SCAN_TOL)


def test_decode_steps_continue_the_scan():
    """Scanning L steps, then stepping on from h_last, equals one scan."""
    u, dt, a, bb, c, dd = _t(*_scan_inputs(2, 20, 8, 4, seed=3))
    y_all, h_all = selective_scan_ref(u, dt, a, bb, c, dd)
    y, h = selective_scan_ref(u[:, :15], dt[:, :15], a, bb[:, :15], c[:, :15], dd)
    for t in range(15, 20):
        y_t, h = selective_step(h, u[:, t], dt[:, t], a, bb[:, t], c[:, t], dd)
        assert_close(y_t, y_all[:, t], F32)
    assert_close(h, h_all, F32)


# ---------------------------------------------------------------------------
# the SSM block
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ssm_layer():
    jcfg = jax_reduce_config(jax_get_arch("falcon-mamba-7b"))
    cfg = reduce_config(get_arch("falcon-mamba-7b"))
    jp, _ = JM._init_ssm(jcfg, jax.random.PRNGKey(3))
    p = M.SSM(cfg, device="cpu", dtype=F32)
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.tensor(np.asarray(jp[name])))
    ok = random_fault_map(1, 16, 16, 0.2).ok_mask
    x = np.random.default_rng(4).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, p, ok, x


@pytest.mark.parametrize("mode", MODES)
def test_ssm_block_prefill_matches(ssm_layer, mode):
    jcfg, cfg, jp, p, ok, x = ssm_layer
    jctx = JaxFaultContext(ok=None if mode == "none" else jnp.asarray(ok), mode=mode)
    ctx = context_from_ok(ok, mode, device="cpu")
    ref_y, ref_c = JS.ssm_block(jp, jnp.asarray(x), jcfg, jctx, build_cache=True)
    got_y, got_c = S.ssm_block(p, torch.from_numpy(x), cfg, ctx, build_cache=True)
    assert_close(got_y, np.asarray(ref_y), F32)
    assert_close(got_c.conv, np.asarray(ref_c.conv), F32)
    assert_close(got_c.h, np.asarray(ref_c.h), F32)


@pytest.mark.parametrize("prompt", [2, 9])  # shorter and longer than the conv tail
def test_ssm_block_decode_with_cache_matches(ssm_layer, prompt):
    jcfg, cfg, jp, p, ok, x = ssm_layer
    jctx, ctx = JaxFaultContext(ok=jnp.asarray(ok), mode="fap"), context_from_ok(ok, "fap", device="cpu")
    _, jc = JS.ssm_block(jp, jnp.asarray(x[:, :prompt]), jcfg, jctx, build_cache=True)
    _, pc = S.ssm_block(p, torch.from_numpy(x[:, :prompt]), cfg, ctx, build_cache=True)
    cache = S.init_ssm_cache(cfg, 2, F32, device="cpu")
    cache.conv.copy_(pc.conv)
    cache.h.copy_(pc.h)
    step = np.random.default_rng(5).standard_normal((3, 2, 1, cfg.d_model)).astype(np.float32)
    for xs in step:
        ref_y, jc = JS.ssm_block(jp, jnp.asarray(xs), jcfg, jctx, cache=jc)
        got_y, got_c = S.ssm_block(p, torch.from_numpy(xs), cfg, ctx, cache=cache)
        assert got_c is cache  # updated in place
        assert_close(got_y, np.asarray(ref_y), F32)
    assert_close(cache.conv, np.asarray(jc.conv), F32)
    assert_close(cache.h, np.asarray(jc.h), F32)


# ---------------------------------------------------------------------------
# reduced falcon-mamba and hymba end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = jax_reduce_config(jax_get_arch(request.param))
    cfg = reduce_config(get_arch(request.param))
    jparams, _ = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    ok = random_fault_map(0, cfg.array_rows, cfg.array_cols, 0.2).ok_mask
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    return jcfg, cfg, jparams, params, ok, tokens


def _ctxs(ok, mode):
    jctx = JaxFaultContext(ok=None if mode == "none" else jnp.asarray(ok), mode=mode)
    return jctx, context_from_ok(ok, mode, device="cpu")


def _cache_keys(cfg):
    return (("k", "v") if cfg.has_attention else ()) + ("conv", "h")


def test_configs_and_params_match_reference(model):
    jcfg, cfg, jparams, params, *_ = model
    names = {n for n, _ in params.named_parameters()}
    assert "lm_head" in names and "embed" in names  # untied
    assert "layers.1.ssm.a_log" in names
    assert ("layers.0.alpha_attn" in names) == (cfg.family == "hybrid")
    assert sum(p.numel() for p in params.parameters()) == sum(
        np.asarray(x).size for x in jax.tree.leaves(jparams)
    )


@pytest.mark.parametrize("mode", MODES)
def test_forward_logits_match(model, mode):
    jcfg, cfg, jparams, params, ok, tokens = model
    jctx, ctx = _ctxs(ok, mode)
    ref, _ = JM.forward(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, jctx)
    with torch.no_grad():
        got, _ = M.forward(params, {"tokens": _tok(tokens)}, cfg, ctx)
    assert_close(got, np.asarray(ref), F32)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_three_decode_steps_match(model, mode):
    jcfg, cfg, jparams, params, ok, tokens = model
    jctx, ctx = _ctxs(ok, mode)
    jl, jc = JM.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, jctx, cache_len=20)
    pl, pc = M.prefill(params, {"tokens": _tok(tokens)}, cfg, ctx, cache_len=20)
    assert_close(pl, np.asarray(jl), F32)
    assert set(pc) == set(jc)
    for key in _cache_keys(cfg):
        assert_close(pc[key], np.asarray(jc[key]), F32)
    assert pc["h"].dtype == F32 and pc["conv"].shape == (cfg.num_layers, 2, cfg.ssm_conv - 1, cfg.d_inner)
    for t in np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 2, 1)):
        jl, jc = JM.decode_step(jparams, jnp.asarray(t, jnp.int32), jc, jcfg, jctx)
        pl, pc = M.decode_step(params, _tok(t), pc, cfg, ctx)
        assert_close(pl, np.asarray(jl), F32)
    assert pc["index"] == int(jc["index"])
    for key in _cache_keys(cfg):
        assert_close(pc[key], np.asarray(jc[key]), F32)


def test_prefill_through_kernels_matches_reference_pallas(model):
    """The kernel mode with kernel attention: on CPU tensors every wrapper
    runs its plain version."""
    jcfg, cfg, jparams, params, ok, tokens = model
    jctx, ctx = _ctxs(ok, "pallas")
    jl, jc = JM.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, jctx, attn_impl="pallas")
    pl, pc = M.prefill(params, {"tokens": _tok(tokens)}, cfg, ctx, attn_impl="kernel")
    assert_close(pl, np.asarray(jl), F32)
    assert_close(pc["h"], np.asarray(jc["h"]), F32)


def test_hybrid_ring_cache_matches():
    """hymba with a window shorter than the prompt: the KV ring and the SSM
    state advance together through prefill and decode."""
    jcfg = dataclasses.replace(jax_reduce_config(jax_get_arch("hymba-1.5b")), sliding_window=8)
    cfg = dataclasses.replace(reduce_config(get_arch("hymba-1.5b")), sliding_window=8)
    jparams, _ = JM.init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    ok = random_fault_map(2, 16, 16, 0.1).ok_mask
    jctx, ctx = _ctxs(ok, "fap")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jc = JM.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, jctx, cache_len=24)
    pl, pc = M.prefill(params, {"tokens": _tok(tokens)}, cfg, ctx, cache_len=24)
    assert_close(pl, np.asarray(jl), F32)
    assert pc["k"].shape[3] == 8
    for t in np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 2, 1)):
        jl, jc = JM.decode_step(jparams, jnp.asarray(t, jnp.int32), jc, jcfg, jctx)
        pl, pc = M.decode_step(params, _tok(t), pc, cfg, ctx)
        assert_close(pl, np.asarray(jl), F32)
    for key in ("k", "v", "conv", "h"):
        assert_close(pc[key], np.asarray(jc[key]), F32)


def test_prefill_refuses_valid_len(model):
    jcfg, cfg, jparams, params, ok, tokens = model
    with pytest.raises(ValueError, match="causal attention families only"):
        JM.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, valid_len=9)
    with pytest.raises(ValueError, match="causal attention families only"):
        M.prefill(params, {"tokens": _tok(tokens)}, cfg, valid_len=9)


@pytest.mark.parametrize("mode", ["none", "fap", "pallas"])
def test_falcon_mamba_greedy_generate_matches_reference(mode):
    jcfg = jax_reduce_config(jax_get_arch("falcon-mamba-7b"))
    cfg = reduce_config(get_arch("falcon-mamba-7b"))
    jparams, _ = JM.init_params(jcfg, jax.random.PRNGKey(5))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    ok = random_fault_map(3, 16, 16, 0.3).ok_mask
    jctx, ctx = _ctxs(ok, mode)
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    jeng, eng = JaxServeEngine(jcfg, jparams, jctx, max_len=None), ServeEngine(cfg, params, ctx, max_len=None)
    assert eng.prefill_buckets is None and jeng.prefill_buckets is None
    ref = jeng.generate(jnp.asarray(prompts), max_new_tokens=6)
    got = eng.generate(_tok(prompts), max_new_tokens=6)
    assert got.tokens.shape == (2, 13)
    assert np.array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    assert_close(got.logprobs, np.asarray(ref.logprobs), F32)


def test_init_params_ssm_distributions():
    cfg = reduce_config(get_arch("hymba-1.5b"))
    p = M.init_params(cfg, 0, device="cpu")
    s = p.layers[1].ssm
    n = cfg.ssm_state
    assert torch.equal(s.a_log, torch.log(torch.arange(1, n + 1, dtype=F32)).expand(cfg.d_inner, n))
    dt = torch.nn.functional.softplus(s.dt_b)
    assert dt.min() >= 1e-3 * (1 - 1e-4) and dt.max() <= 1e-1 * (1 + 1e-4)
    assert torch.equal(s.conv_b, torch.zeros(cfg.d_inner))
    assert torch.equal(s.d_skip, torch.ones(cfg.d_inner))
    assert torch.equal(p.layers[0].alpha_attn, torch.ones(cfg.d_model))
    assert abs(s.conv_w.std().item() - 0.5) < 0.1  # N(0, 1/K) with K = 4
    assert abs(s.in_proj.std().item() - cfg.d_model**-0.5) < 0.1 * cfg.d_model**-0.5
    assert not torch.equal(s.dt_b, p.layers[0].ssm.dt_b)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_cpu(arch, capsys):
    serve_cli.main([
        "--arch", arch, "--reduced", "--device", "cpu", "--fault-rate", "0.1",
        "--fault-mode", "kernel", "--batch", "2", "--prompt-len", "8", "--new-tokens", "4",
    ])
    out = capsys.readouterr().out
    assert "mode=kernel" in out and "2x4 tokens" in out and "seq1:" in out
