"""The rest of the model zoo against the reference package: phi3-mini,
qwen3 (qk_norm), llama3-405b, mixtral and llama4-maverick (MoE), hubert
(the audio encoder: LayerNorm, gelu, no RoPE, bidirectional) and internvl2
(the vision prefix), each at its reduced config.

Inputs are made by numpy from a seed and handed to both packages; the
reference's parameters reach the port through ``repro_torch.convert``. Both
sides run float32 on the CPU, where ``kernel`` mode runs the masked GEMM's
plain version (the reference's ``pallas`` mode its masked einsum).

Tolerances: ``dtype_tol(float32)`` (rtol 2e-5, atol 2e-4) on logits, KV,
losses and MoE outputs, since the two packages differ only in summation
order; routing decisions, capacity drops, greedy tokens, counts and error
messages for equality.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_config as jax_reduce_config
from repro.core import masking as JMask
from repro.core.masking import FaultContext as JaxFaultContext
from repro.kernels.masked_matmul.ops import masked_matmul_ref as jax_masked_matmul_ref
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.obs import abft as jabft
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch.configs import FRONTEND_DIMS, get_arch, list_archs, reduce_config
from repro_torch.convert import context_from_ok, params_from_jax
from repro_torch.core import fault_einsum, random_fault_map
from repro_torch.kernels.common import assert_close
from repro_torch.kernels.masked_matmul import ops as mm_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MoE
from repro_torch.obs import abft
from repro_torch.serve import ContinuousBatchingEngine, Request, ServeEngine

F32 = torch.float32
MODES = ["none", "fap", "pallas"]
ZOO = ["phi3-mini-3.8b", "qwen3-0.6b", "llama3-405b", "mixtral-8x22b",
       "llama4-maverick-400b-a17b", "hubert-xlarge", "internvl2-26b"]
DECODERS = [n for n in ZOO if n != "hubert-xlarge"]
MOE = ["mixtral-8x22b", "llama4-maverick-400b-a17b"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast, and
    keeps parallel test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PAIRS: dict = {}


def _pair(name):
    """(jcfg, cfg, jparams, params) of the reduced config, one set of
    weights made by the reference and handed over."""
    if name not in _PAIRS:
        jcfg = jax_reduce_config(jax_get_arch(name))
        cfg = reduce_config(get_arch(name))
        jparams, _ = JM.init_params(jcfg, jax.random.PRNGKey(0))
        params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
        _PAIRS[name] = (jcfg, cfg, jparams, params)
    return _PAIRS[name]


OK = random_fault_map(0, 16, 16, 0.2).ok_mask


def _ctxs(mode, ok=OK):
    jctx = JaxFaultContext(ok=None if mode == "none" else jnp.asarray(ok), mode=mode)
    return jctx, context_from_ok(ok, mode, device="cpu")


def _t(a, dtype=torch.int64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _batch(cfg, rng, b=2, s=12, prefix=4):
    """numpy inputs of the config's modality: tokens, audio frames, or a
    vision prefix of ``prefix`` patch embeddings before the tokens."""
    out = {}
    if cfg.modality != "audio":
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.modality in FRONTEND_DIMS:
        n = s if cfg.modality == "audio" else prefix
        out["embeds"] = rng.standard_normal((b, n, FRONTEND_DIMS[cfg.modality])).astype(np.float32)
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pb(batch):
    return {k: _t(v) if v.dtype.kind == "i" else torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Registry and parameters
# ---------------------------------------------------------------------------


def test_every_reference_architecture_is_registered_and_builds():
    """The 11 of the reference registered; every language model builds at
    full width (on the meta device) with the reference's parameter count."""
    from repro.configs import list_archs as jax_list_archs

    assert list_archs(include_paper=True) == jax_list_archs(include_paper=True)
    assert len(list_archs(include_paper=True)) == 11
    for name in list_archs():
        shapes = jax.eval_shape(lambda: JM.init_params(jax_get_arch(name), jax.random.PRNGKey(0))[0])
        want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
        model = M.Model(get_arch(name), device="meta")
        assert sum(p.numel() for p in model.parameters()) == want, name


@pytest.mark.parametrize("name", ZOO)
def test_param_names_and_shapes_match_reference(name):
    jcfg, cfg, jparams, params = _pair(name)
    flat = dict(params.named_parameters())
    ref = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        keys = [k.key for k in path]
        if keys[0] == "layers":
            for i in range(leaf.shape[0]):
                ref[".".join(["layers", str(i), *keys[1:]])] = leaf.shape[1:]
        else:
            ref[".".join(keys)] = leaf.shape
    assert {k: tuple(v.shape) for k, v in flat.items()} == {k: tuple(v) for k, v in ref.items()}


@pytest.mark.parametrize("name", ZOO)
def test_init_params_follows_reference_distributions(name):
    cfg = reduce_config(get_arch(name))
    params = M.init_params(cfg, 0, device="cpu")
    for pname, p in params.named_parameters():
        leaf = pname.rsplit(".", 1)[-1]
        if leaf == "bias":
            assert torch.count_nonzero(p) == 0, pname
        elif p.ndim == 1:
            assert torch.all(p == 1), pname
        elif pname == "embed":
            assert abs(float(p.std()) - 0.02) < 0.005
        else:  # N(0, 1 / fan_in), fan_in the GEMM's d_in axis (an expert's too)
            assert abs(float(p.std()) * p.shape[-2] ** 0.5 - 1) < 0.15, pname


# ---------------------------------------------------------------------------
# forward, loss, prefill and decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ZOO)
def test_forward_logits_and_aux_match_reference(name, mode):
    jcfg, cfg, jparams, params = _pair(name)
    jctx, ctx = _ctxs(mode)
    batch = _batch(cfg, np.random.default_rng(0))
    ref, raux = JM.forward(jparams, _jb(batch), jcfg, jctx)
    with torch.no_grad():
        got, aux = M.forward(params, _pb(batch), cfg, ctx)
    assert got.shape == ref.shape
    assert_close(got, np.asarray(ref), F32)
    assert_close(aux, np.asarray(raux), F32)
    assert (float(aux) > 0) == cfg.has_moe


@pytest.mark.parametrize("name", ZOO)
def test_loss_fn_matches_reference(name):
    jcfg, cfg, jparams, params = _pair(name)
    jctx, ctx = _ctxs("fap")
    rng = np.random.default_rng(1)
    batch = _batch(cfg, rng)
    s_text = 12  # labels cover the text (vlm: the tail after the prefix)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (2, s_text)).astype(np.int32)
    batch["loss_mask"] = (rng.random((2, s_text)) > 0.2).astype(np.float32)
    _, ref = JM.loss_fn(jparams, _jb(batch), jcfg, jctx, remat="none")
    _, got = M.loss_fn(params, _pb(batch), cfg, ctx, remat="none")
    for key in ("loss", "ce", "aux", "accuracy"):
        assert_close(got[key], np.asarray(ref[key]), F32)


@pytest.mark.parametrize("name", ["mixtral-8x22b", "hubert-xlarge"])
def test_loss_gradients_match_reference(name):
    """Training through the router, the experts (mixtral) and LayerNorm's
    bias and the frontend (hubert): the port's autograd, with each layer
    recomputed in the backward pass, against ``jax.grad``."""
    jcfg, cfg, jparams, params = _pair(name)
    jctx, ctx = _ctxs("fap")
    rng = np.random.default_rng(21)
    batch = _batch(cfg, rng)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    ref = jax.grad(lambda p: JM.loss_fn(p, _jb(batch), jcfg, jctx, remat="none")[0])(jparams)
    leaves = {k: v.clone().requires_grad_() for k, v in M.param_dict(params).items()}
    loss, _ = M.loss_fn(leaves, _pb(batch), cfg, ctx, remat="dots")
    loss.backward()

    def grad(name):  # a parameter the loss never reads (hubert's embed) has none: zeros, as in train/step.py
        g = leaves[name].grad
        return torch.zeros_like(leaves[name]) if g is None else g

    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        keys = [k.key for k in path]
        if keys[0] == "layers":
            for i in range(leaf.shape[0]):
                assert_close(grad(".".join(["layers", str(i), *keys[1:]])), np.asarray(leaf[i]), F32)
        else:
            assert_close(grad(".".join(keys)), np.asarray(leaf), F32)


@pytest.mark.parametrize("mode", ["none", "pallas"])
@pytest.mark.parametrize("name", DECODERS)
def test_prefill_and_three_decode_steps_match_reference(name, mode):
    """The vision model prefills its patch prefix before the tokens, which
    stays in the cache; mixtral's window (32 reduced) holds the whole run."""
    jcfg, cfg, jparams, params = _pair(name)
    jctx, ctx = _ctxs(mode)
    rng = np.random.default_rng(2)
    batch = _batch(cfg, rng)
    jl, jc = JM.prefill(jparams, _jb(batch), jcfg, jctx, cache_len=24)
    pl, pc = M.prefill(params, _pb(batch), cfg, ctx, cache_len=24)
    assert_close(pl, np.asarray(jl), F32)
    assert pc["index"] == int(jc["index"]) == 12 + (4 if cfg.modality == "vision" else 0)
    for key in ("k", "v"):
        assert_close(pc[key], np.asarray(jc[key]), F32)
    for toks in rng.integers(0, cfg.vocab_size, (3, 2, 1)).astype(np.int32):
        jl, jc = JM.decode_step(jparams, jnp.asarray(toks), jc, jcfg, jctx)
        pl, pc = M.decode_step(params, _t(toks), pc, cfg, ctx)
        assert_close(pl, np.asarray(jl), F32)
    for key in ("k", "v"):
        assert_close(pc[key], np.asarray(jc[key]), F32)


@pytest.mark.parametrize("name", MOE)
def test_padded_moe_prefill_matches_reference(name):
    """A right-padded prompt: pad tokens are routed too, last in each row's
    expert queues, so they never take a real token's slot."""
    jcfg, cfg, jparams, params = _pair(name)
    jctx, ctx = _ctxs("fap")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jc = JM.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, jctx, cache_len=24, valid_len=11)
    pl, pc = M.prefill(params, {"tokens": _t(tokens)}, cfg, ctx, cache_len=24, valid_len=11)
    assert_close(pl, np.asarray(jl), F32)
    for key in ("k", "v"):
        assert_close(pc[key][..., :11, :], np.asarray(jc[key])[..., :11, :], F32)


def test_vision_prefix_prefill_aligns_to_the_tail_and_decodes():
    """internvl2's patches project through ``frontend`` ahead of the tokens:
    the prefill's logits are the last text token's, the same row the full
    forward gives at its tail, and decoding continues after the prefix."""
    jcfg, cfg, jparams, params = _pair("internvl2-26b")
    _, ctx = _ctxs("pallas")
    batch = _pb(_batch(cfg, np.random.default_rng(4)))
    with torch.no_grad():
        full, _ = M.forward(params, batch, cfg, ctx, attn_impl="dense")
    last, cache = M.prefill(params, batch, cfg, ctx, cache_len=20)
    assert full.shape[1] == 16 and cache["index"] == 16
    assert_close(last, full[:, -1], F32)
    tok = torch.argmax(last, -1)[:, None]
    step, _ = M.decode_step(params, tok, cache, cfg, ctx)
    seq = dict(batch, tokens=torch.cat([batch["tokens"], tok], 1))
    with torch.no_grad():
        full2, _ = M.forward(params, seq, cfg, ctx, attn_impl="dense")
    assert_close(step[:, 0], full2[:, -1], F32)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_inputs(name, b=2, s=16, seed=5, dtype=np.float32):
    jcfg, cfg, jparams, params = _pair(name)
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(dtype)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["moe"])
    return jcfg, cfg, jp, params.layers[0].moe, x


@pytest.mark.parametrize("cf", [1.25, 0.3])
@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("name", MOE)
def test_moe_block_matches_reference_and_drops_what_it_drops(name, impl, cf):
    """Both dispatches at the default capacity and at one small enough to
    drop: a dropped (token, choice) adds nothing, and the reference drops
    the same pairs (a different queue order would drop others, and the
    outputs would part)."""
    jcfg, cfg, jp, p, x = _moe_inputs(name)
    jctx, ctx = _ctxs("fap")
    ry, raux = JMoE.moe_block(jp, jnp.asarray(x), jcfg, jctx, impl=impl, capacity_factor=cf)
    with torch.no_grad():
        y, aux = MoE.moe_block(p, torch.from_numpy(x), cfg, ctx, impl=impl, capacity_factor=cf)
    assert_close(y, np.asarray(ry), F32)
    assert_close(aux, np.asarray(raux), F32)
    # count the pairs past capacity from the routing
    _, idx, _ = MoE._router(p, torch.from_numpy(x).reshape(-1, cfg.d_model), cfg, ctx)
    cap = MoE.capacity(2, 16, cfg, cf)
    load = torch.nn.functional.one_hot(idx.reshape(2, -1), cfg.num_experts).sum(1)
    dropped = int((load - cap).clamp_min(0).sum())
    assert dropped > 0 or cf > 1, (dropped, cap)


@pytest.mark.parametrize("cf", [1.25, 0.3])
@pytest.mark.parametrize("name", MOE)
def test_moe_einsum_and_scatter_agree(name, cf):
    _, cfg, _, p, x = _moe_inputs(name, seed=6)
    _, ctx = _ctxs("pallas")
    with torch.no_grad():
        a, aux_a = MoE.moe_block(p, torch.from_numpy(x), cfg, ctx, impl="einsum", capacity_factor=cf)
        b, aux_b = MoE.moe_block(p, torch.from_numpy(x), cfg, ctx, impl="scatter", capacity_factor=cf)
    assert_close(a, b, F32)
    assert torch.equal(aux_a, aux_b)
    with pytest.raises(ValueError, match="unknown moe impl"):
        MoE.moe_block(p, torch.from_numpy(x), cfg, ctx, impl="dense")


@pytest.mark.parametrize("b,s,e,k,cf", [(4, 128, 8, 2, 1.25), (4, 1, 8, 2, 1.25), (2, 16, 4, 2, 0.3),
                                       (1, 7, 128, 1, 1.25), (3, 5, 4, 1, 2.0)])
def test_capacity_is_the_reference_rule(b, s, e, k, cf):
    cfg = dataclasses.replace(get_arch("mixtral-8x22b"), num_experts=e, experts_per_token=k)
    want = max(k, int(s * k / e * cf)) if b * s >= e else k
    assert MoE.capacity(b, s, cfg, cf) == want
    if (b, s) == (4, 128):
        assert want == 40  # mixtral's serving prefill: M = 4 x 40 = 160 a expert GEMM
    if (b, s) == (4, 1):
        assert want == 2  # a decode step: M = 4 x 2 = 8


def test_top_k_orders_ties_as_jax_lax_top_k():
    rng = np.random.default_rng(7)
    logits = rng.integers(-2, 3, (64, 8)).astype(np.float32)  # ties everywhere
    for k in (1, 2, 3, 8):
        rv, ri = jax.lax.top_k(jnp.asarray(logits), k)
        gv, gi = MoE.top_k(torch.from_numpy(logits), k)
        assert np.array_equal(gi.numpy(), np.asarray(ri))
        assert np.array_equal(gv.numpy(), np.asarray(rv))


def test_forced_bf16_router_tie_routes_as_the_reference():
    """A router with equal columns gives equal bf16 logits: every token has
    a tie among its top experts, and both packages pick the lower index."""
    jcfg, cfg, jp, p, x = _moe_inputs("mixtral-8x22b", seed=8)
    router = np.asarray(jp["router"]).copy()
    router[:, 2] = router[:, 1]
    router[:, 3] = router[:, 0]
    jp = dict(jp, router=jnp.asarray(router))
    xb = jnp.asarray(x).astype(jnp.bfloat16).reshape(-1, cfg.d_model)
    jctx, ctx = _ctxs("none")
    rw, ridx, raux = JMoE._router(jp, xb, jcfg, jctx)
    ns = type("P", (), {"router": torch.from_numpy(router)})
    gw, gidx, gaux = MoE._router(ns, torch.tensor(np.asarray(xb.astype(jnp.float32))).bfloat16(), cfg, ctx)
    assert np.array_equal(gidx.numpy(), np.asarray(ridx))
    top = np.asarray(ridx)  # each row's two picks are a tied pair, {0, 3} or {1, 2}, lower first
    assert (np.sort(top, 1) == top).all() and set(map(tuple, top)) <= {(0, 3), (1, 2)}
    assert_close(gw, np.asarray(rw), F32)
    assert_close(gaux, np.asarray(raux), F32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("spec", ["ecd,edf->ecf", "ecf,efd->ecd"])
def test_fault_einsum_matches_reference(spec, mode):
    rng = np.random.default_rng(9)
    e, c, d, f = 4, 5, 24, 40
    x = rng.standard_normal((e, c, d if spec.startswith("ecd") else f)).astype(np.float32)
    w = rng.standard_normal((e, d, f) if spec.startswith("ecd") else (e, f, d)).astype(np.float32)
    jctx, ctx = _ctxs(mode)
    ref = JMask.fault_einsum(spec, jnp.asarray(x), jnp.asarray(w), jctx)
    got = fault_einsum(spec, torch.from_numpy(x), torch.from_numpy(w), ctx)
    assert_close(got, np.asarray(ref), F32)


def test_fault_einsum_kernel_mode_takes_only_the_expert_specs():
    _, ctx = _ctxs("pallas")
    x, w = torch.ones(2, 3, 4), torch.ones(2, 4, 5)
    with pytest.raises(ValueError, match="expert specs"):
        fault_einsum("ecd,edf->efc", x, w, ctx)
    assert fault_einsum("ecd,edf->ecf", x, w, ctx).shape == (2, 3, 5)


@pytest.mark.parametrize("e,m", [(1, 3), (4, 5), (8, 1)])
def test_masked_matmul_ref_with_a_shared_mask_is_a_loop_over_experts(e, m):
    """w (E, K, N) under one (R, C) mask: each expert's GEMM is the
    reference kernel's plain version under that mask."""
    rng = np.random.default_rng(10 + e)
    x = rng.standard_normal((e, m, 40)).astype(np.float32)
    w = rng.standard_normal((e, 40, 36)).astype(np.float32)
    ok = random_fault_map(e, 16, 16, 0.3).ok_mask.astype(np.float32)
    got = mm_ops.masked_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(ok))
    assert got.shape == (e, m, 36)
    for i in range(e):
        assert_close(got[i], np.asarray(jax_masked_matmul_ref(jnp.asarray(x[i]), jnp.asarray(w[i]), jnp.asarray(ok))), F32)


def test_kernel_mode_decode_step_launches_gemm_shapes(monkeypatch):
    """A kernel-mode decode step of reduced mixtral reaches the masked GEMM
    as ``gemm_shapes`` counts: per layer 4 attention GEMMs, the router and
    3 expert GEMMs, each with the experts as its batch axis and the one
    (R, C) mask, and the unembed."""
    _, cfg, _, params = _pair("mixtral-8x22b")
    _, ctx = _ctxs("pallas")
    calls = []
    real = mm_ops.masked_matmul

    def counted(x, w, ok, **kw):
        calls.append((tuple(w.shape), ok.dim(), x.shape[-2] if w.dim() == 3 else x.reshape(-1, x.shape[-1]).shape[0]))
        return real(x, w, ok, **kw)

    monkeypatch.setattr(mm_ops, "masked_matmul", counted)
    tokens = _t(np.random.default_rng(11).integers(0, cfg.vocab_size, (4, 8)))
    _, cache = M.prefill(params, {"tokens": tokens}, cfg, ctx, cache_len=16)
    prefill_calls, calls[:] = list(calls), []
    M.decode_step(params, tokens[:, :1], cache, cfg, ctx)
    want = sum(uses for _, _, uses in cfg.gemm_shapes())
    assert len(calls) == len(prefill_calls) == want == 8 * cfg.num_layers + 1
    experts = [c for c in calls if len(c[0]) == 3]
    assert len(experts) == 3 * cfg.num_layers
    assert all(ok_dim == 2 and w[0] == cfg.num_experts for w, ok_dim, _ in experts)
    assert {m for _, _, m in experts} == {4 * MoE.capacity(4, 1, cfg, 1.25)}  # 4 rows of 2 slots
    cap = MoE.capacity(4, 8, cfg, 1.25)
    assert {m for w, _, m in prefill_calls if len(w) == 3} == {4 * cap}


@pytest.mark.parametrize("mode", ["fap", "pallas"])
def test_mixtral_paged_decode_matches_reference(mode):
    jcfg, cfg, jparams, params = _pair("mixtral-8x22b")
    jctx, ctx = _ctxs(mode)
    rng = np.random.default_rng(12)
    L, hkv, hd, page = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim, 4
    pool = rng.standard_normal((2, L, 24, hkv, page, hd)).astype(np.float32)
    tables = np.asarray([[3, 7, 9, 0, 0], [4, 0, 0, 0, 0], [11, 2, 5, 6, 0], [8, 10, 0, 0, 0]], np.int32)
    host = dict(k_pages=pool[0], v_pages=pool[1], block_tables=tables, seq_lens=np.asarray([6, 1, 12, 0], np.int32))
    jcache = {k: jnp.asarray(v) for k, v in host.items()}
    pcache = {k: torch.tensor(v) for k, v in host.items()}
    active = (True, False, True, True)
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)
        ref, jcache = JM.decode_step(jparams, jnp.asarray(toks), jcache, jcfg, jctx, active=jnp.asarray(active))
        got, pcache = M.decode_step(params, _t(toks), pcache, cfg, ctx, active=torch.tensor(active))
        assert_close(got, np.asarray(ref), F32)
    assert np.array_equal(pcache["seq_lens"].numpy(), np.asarray(jcache["seq_lens"]))
    for key in ("k_pages", "v_pages"):
        assert_close(pcache[key][:, 1:], np.asarray(jcache[key])[:, 1:], F32)


@pytest.mark.parametrize("moe_impl", ["einsum", "scatter"])
def test_mixtral_prefill_chunk_matches_reference(moe_impl):
    """A 40-token prompt in chunks of 8 across mixtral's 32-token window."""
    from repro_torch.serve import bucketing

    jcfg, cfg, jparams, params = _pair("mixtral-8x22b")
    jctx, ctx = _ctxs("pallas")
    page, chunk, plen, maxp, pool_pages = 4, 8, 40, 12, 16
    L, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(13)
    prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
    chain = list(rng.permutation(np.arange(1, pool_pages))[:11])
    row = np.zeros(maxp, np.int32)
    row[: len(chain)] = chain
    pool0 = rng.standard_normal((2, L, pool_pages, hkv, page, hd)).astype(np.float32)
    jk, jv = jnp.asarray(pool0[0]), jnp.asarray(pool0[1])
    pk, pv = torch.tensor(pool0[0]), torch.tensor(pool0[1])
    for step in bucketing.plan_prefill(plen, buckets=(chunk,), chunk_size=chunk):
        toks = np.zeros(chunk, np.int32)
        toks[: step.valid] = prompt[step.start : step.start + step.valid]
        ref = JM.prefill_chunk(
            jparams, jnp.asarray(toks[None]), jcfg, jctx, k_pages=jk, v_pages=jv,
            row=jnp.asarray(row), prefix_len=step.start, valid_len=step.valid, moe_impl=moe_impl,
        )
        got = M.prefill_chunk(
            params, _t(toks[None]), cfg, ctx, k_pages=pk, v_pages=pv, row=_t(row),
            prefix_len=step.start, valid_len=step.valid, moe_impl=moe_impl,
        )
        for g, r in zip(got, ref):
            assert_close(g, np.asarray(r), F32)
        maps = bucketing.chunk_step_maps(step, chain, page_size=page)
        ix, off = maps["page_ix"], maps["page_off"]
        jk = jk.at[:, ix, :, off].set(jnp.transpose(ref[1][:, 0], (2, 0, 1, 3)))
        jv = jv.at[:, ix, :, off].set(jnp.transpose(ref[2][:, 0], (2, 0, 1, 3)))
        pk[:, _t(ix), :, _t(off)] = got[1][:, 0].permute(2, 0, 1, 3)
        pv[:, _t(ix), :, _t(off)] = got[2][:, 0].permute(2, 0, 1, 3)


def test_mixtral_continuous_engine_matches_reference():
    """Packed admissions, chunks past the top bucket and mid-flight arrivals
    of reduced mixtral: the reference engine's tokens, logprobs and stats."""
    jcfg, cfg, jparams, params = _pair("mixtral-8x22b")
    jctx, ctx = _ctxs("pallas")
    rng = np.random.default_rng(14)
    spec = [(6, 5, 0), (13, 4, 0), (40, 6, 0), (3, 5, 2), (5, 4, 0), (21, 7, 3), (9, 3, 5)]
    trace = [(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32), b, a) for i, (n, b, a) in enumerate(spec)]
    kw = dict(num_slots=2, page_size=4, num_pages=64, prefill_buckets=(8, 16), chunk_size=8, max_pack=2)
    ref, rstats = JaxEngine(jcfg, jparams, jctx, **kw).serve([JaxRequest(*r) for r in trace])
    got, stats = ContinuousBatchingEngine(cfg, params, ctx, **kw).serve([Request(*r) for r in trace])
    assert sorted(got) == sorted(ref)
    for rid in ref:
        assert np.array_equal(got[rid].tokens, ref[rid].tokens), rid
        assert_close(got[rid].logprobs, ref[rid].logprobs, F32)
    assert stats.as_dict() == rstats.as_dict() and stats.chunk_dispatches > 0


@pytest.mark.parametrize("name", MOE + ["qwen3-0.6b"])
def test_serve_engine_generates_the_reference_tokens(name):
    """ServeEngine on the prefill-and-decode path, at the model functions'
    default MoE dispatch as the reference's engine serves."""
    from repro.serve.engine import ServeEngine as JaxServeEngine

    jcfg, cfg, jparams, params = _pair(name)
    jctx, ctx = _ctxs("pallas")
    prompts = np.random.default_rng(15).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    ref = JaxServeEngine(jcfg, jparams, jctx, max_len=None).generate(jnp.asarray(prompts), max_new_tokens=6)
    got = ServeEngine(cfg, params, ctx, max_len=None).generate(_t(prompts), max_new_tokens=6)
    assert np.array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    assert_close(got.logprobs, np.asarray(ref.logprobs), F32)


# ---------------------------------------------------------------------------
# layers: LayerNorm, gelu, qk_norm, the encoder
# ---------------------------------------------------------------------------


def test_layer_norm_and_apply_norm_match_reference():
    rng = np.random.default_rng(16)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    scale, bias = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    ref = JL.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-5)
    got = L.layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), 1e-5)
    assert_close(got, np.asarray(ref), F32)
    with_bias = type("N", (), {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    assert torch.equal(L.apply_norm(torch.from_numpy(x), with_bias, 1e-5), got)
    ref_rms = JL.apply_norm(jnp.asarray(x), {"scale": jnp.asarray(scale)}, 1e-5)
    no_bias = type("N", (), {"scale": torch.from_numpy(scale)})
    assert_close(L.apply_norm(torch.from_numpy(x), no_bias, 1e-5), np.asarray(ref_rms), F32)


def test_gelu_mlp_is_the_tanh_form_of_the_reference():
    jcfg, cfg, jparams, params = _pair("hubert-xlarge")
    x = np.random.default_rng(17).standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["mlp"])
    jctx, ctx = _ctxs("fap")
    ref = JL.mlp_block(jp, jnp.asarray(x), jcfg, jctx)
    with torch.no_grad():
        got = L.mlp_block(params.layers[0].mlp, torch.from_numpy(x), cfg, ctx)
    assert_close(got, np.asarray(ref), F32)
    z = np.linspace(-6, 6, 101).astype(np.float32)
    gelu = torch.nn.functional.gelu(torch.from_numpy(z), approximate="tanh")
    assert_close(gelu, np.asarray(jax.nn.gelu(jnp.asarray(z))), F32)
    erf = torch.nn.functional.gelu(torch.from_numpy(z))
    assert float((erf - gelu).abs().max()) > 1e-4  # the erf form would not pass


@pytest.mark.parametrize("offset", [0, 5])
def test_qk_norm_runs_before_rope_as_the_reference(offset):
    """qwen3's per-head q/k RMSNorm (scales made non-trivial), then RoPE at
    shifted positions: RMSNorm after RoPE would give other scores."""
    jcfg, cfg, jparams, params = _pair("qwen3-0.6b")
    rng = np.random.default_rng(18 + offset)
    hd = cfg.resolved_head_dim
    qn, kn = (rng.random(hd) + 0.5).astype(np.float32), (rng.random(hd) + 0.5).astype(np.float32)
    jp = dict(jax.tree.map(lambda a: a[0], jparams["layers"]["attn"]), q_norm=jnp.asarray(qn), k_norm=jnp.asarray(kn))
    p = params.layers[0].attn
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9) + offset, (2, 9)).astype(np.int32)
    jctx, ctx = _ctxs("none")
    ref, _ = JL.attention_block(jp, jnp.asarray(x), jcfg, jctx, positions=jnp.asarray(pos))
    view = type("A", (), dict(wq=p.wq, wk=p.wk, wv=p.wv, wo=p.wo, q_norm=torch.from_numpy(qn), k_norm=torch.from_numpy(kn)))
    rope = L.rope_tables(_t(pos), hd, cfg.rope_theta)
    with torch.no_grad():
        got, _ = L.attention_block(view, torch.from_numpy(x), cfg, ctx, rope=rope)
    assert_close(got, np.asarray(ref), F32)


def test_encoder_attends_both_ways_without_rope():
    """hubert: a frame's output depends on later frames, and on no
    position (shifting the positions changes nothing)."""
    _, cfg, _, params = _pair("hubert-xlarge")
    _, ctx = _ctxs("none")
    batch = _pb(_batch(cfg, np.random.default_rng(19)))
    with torch.no_grad():
        a, _ = M.forward(params, batch, cfg, ctx)
        shifted, _ = M.forward(params, dict(batch, positions=torch.arange(12)[None].expand(2, 12) + 100), cfg, ctx)
        later = dict(batch, embeds=batch["embeds"].clone())
        later["embeds"][:, -1] += 1.0
        b, _ = M.forward(params, later, cfg, ctx)
    assert torch.equal(a, shifted)
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4


def _message(fn):
    try:
        fn()
    except (ValueError, SystemExit) as e:
        return str(e)
    raise AssertionError("no refusal")


def test_encoder_refusals_carry_the_reference_messages():
    jcfg, cfg, jparams, params = _pair("hubert-xlarge")
    batch = _batch(cfg, np.random.default_rng(20))
    cases = [
        (lambda: JM.prefill(jparams, _jb(batch), jcfg, valid_len=5),
         lambda: M.prefill(params, _pb(batch), cfg, valid_len=5)),
        (lambda: JM.prefill_chunk(jparams, jnp.zeros((1, 4), jnp.int32), jcfg, k_pages=None, v_pages=None,
                                  row=None, prefix_len=0, valid_len=4),
         lambda: M.prefill_chunk(params, torch.zeros((1, 4), dtype=torch.int64), cfg, k_pages=None,
                                 v_pages=None, row=None, prefix_len=0, valid_len=4)),
        (lambda: JM.init_paged_cache(jcfg, 8, 4, 2, 4), lambda: M.init_paged_cache(cfg, 8, 4, 2, 4, device="cpu")),
        (lambda: JaxEngine(jcfg, jparams), lambda: ContinuousBatchingEngine(cfg, params)),
    ]
    for ref, got in cases:
        assert _message(got) == _message(ref)
    # the static engine and the serving CLI: the reference CLI's message
    assert _message(lambda: ServeEngine(cfg, params)) == "encoder-only arch has no decode path"
    cli = ["--arch", "hubert-xlarge", "--reduced", "--device", "cpu"]
    assert _message(lambda: serve_cli.main(cli)) == "encoder-only arch has no decode path"


@pytest.mark.parametrize("name", ["mixtral-8x22b", "hubert-xlarge", "internvl2-26b"])
def test_fleet_engines_refuse_what_they_do_not_map(name):
    """Both fleet engines map the MoE and the vision configs over the chips,
    as the reference's serve them (tests/test_torch_fleet_families.py holds
    what they serve), and refuse the encoder, which has no decode path."""
    from repro_torch.fleet import FleetServeEngine, ShardedFleetServeEngine

    _, cfg, _, params = _pair(name)
    for engine in (FleetServeEngine, ShardedFleetServeEngine):
        kw = dict(devices=["cpu"]) if engine is ShardedFleetServeEngine else {}
        if cfg.is_encoder:
            with pytest.raises(ValueError, match="encoder-only arch .* has no decode path"):
                engine(cfg, [params, params], **kw)
        else:
            assert engine(cfg, [params, params], **kw).num_chips == 2


def _meta_pair(name):
    jcfg = jax_get_arch(name)
    shapes = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0))[0])
    tree = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    return tree, M.Model(get_arch(name), device="meta")


@pytest.mark.parametrize("name", ["mixtral-8x22b", "qwen3-0.6b", "hubert-xlarge", "internvl2-26b"])
def test_select_probe_weight_matches_reference_at_full_width(name):
    """An MoE layer's probe is its first expert's matrix, as the reference
    slices its stacked leaf."""
    jparams, params = _meta_pair(name)
    rname, rw = jabft.select_probe_weight(jparams)
    pname, pw = abft.select_probe_weight(params)
    assert pname == rname and tuple(pw.shape) == tuple(rw.shape)
