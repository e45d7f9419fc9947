"""The port's reduced SmolLM against the reference package on one set of
weights: the reference initializes, ``repro_torch.convert`` hands the numpy
parameters over, and forward / prefill / decode are compared.

Tolerance: ``dtype_tol(float32)`` throughout (rtol 2e-5, atol 2e-4). Both
sides run float32 on the CPU through two layers; the logits differ only by
summation order.
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
from repro.core.masking import mask_selected_params as jax_mask_selected_params
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_arch, reduce_config
from repro_torch.convert import context_from_ok, params_from_jax
from repro_torch.core import mask_selected_params, random_fault_map
from repro_torch.kernels.common import assert_close
from repro_torch.models import layers as L
from repro_torch.models import model as M

F32 = torch.float32
MODES = ["none", "fap", "pallas"]


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduce_config(jax_get_arch("smollm-135m"))
    cfg = reduce_config(get_arch("smollm-135m"))
    jparams, _ = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    ok = random_fault_map(0, cfg.array_rows, cfg.array_cols, 0.2).ok_mask
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    return jcfg, cfg, jparams, params, ok, tokens


def _ctxs(ok, mode):
    jctx = JaxFaultContext(ok=None if mode == "none" else jnp.asarray(ok), mode=mode)
    return jctx, context_from_ok(ok, mode, device="cpu")


def _tok(a):
    return torch.from_numpy(np.asarray(a, np.int64))


@pytest.mark.parametrize("name,per_step", [
    ("smollm-135m", 7 * 30 + 1), ("falcon-mamba-7b", 4 * 64 + 1), ("hymba-1.5b", 11 * 32 + 1),
    ("phi3-mini-3.8b", 7 * 32 + 1), ("qwen3-0.6b", 7 * 28 + 1), ("llama3-405b", 7 * 126 + 1),
    # MoE: 4 attention, the router and 3 expert GEMMs (one launch each for all experts)
    ("mixtral-8x22b", 8 * 56 + 1), ("llama4-maverick-400b-a17b", 8 * 48 + 1),
    # the frontend, then 4 attention and the gelu MLP's 2 (audio) or swiglu's 3 (vision)
    ("hubert-xlarge", 1 + 6 * 48 + 1), ("internvl2-26b", 1 + 7 * 48 + 1),
])
def test_configs_match_reference(name, per_step):
    jcfg, cfg = jax_get_arch(name), get_arch(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduce_config(cfg)) == dataclasses.asdict(jax_reduce_config(jcfg))
    assert (cfg.d_inner, cfg.resolved_dt_rank) == (jcfg.d_inner, jcfg.resolved_dt_rank)
    assert sum(uses for _, _, uses in cfg.gemm_shapes()) == per_step


@pytest.mark.parametrize("mode", MODES)
def test_forward_logits_match(setup, mode):
    jcfg, cfg, jparams, params, ok, tokens = setup
    jctx, ctx = _ctxs(ok, mode)
    ref, _ = JM.forward(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, jctx)
    with torch.no_grad():
        got, _ = M.forward(params, {"tokens": _tok(tokens)}, cfg, ctx)
    assert_close(got, np.asarray(ref), F32)


@pytest.mark.parametrize("valid_len", [None, 9])
@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_three_decode_steps_match(setup, mode, valid_len):
    jcfg, cfg, jparams, params, ok, tokens = setup
    jctx, ctx = _ctxs(ok, mode)
    kw = {} if valid_len is None else dict(valid_len=valid_len)
    jl, jc = JM.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, jctx, cache_len=20, **kw)
    pl, pc = M.prefill(params, {"tokens": _tok(tokens)}, cfg, ctx, cache_len=20, **kw)
    assert_close(pl, np.asarray(jl), F32)
    assert pc["index"] == int(jc["index"])
    for key in ("k", "v"):
        assert_close(pc[key], np.asarray(jc[key]), F32)
    steps = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 2, 1))
    for t in steps:
        jl, jc = JM.decode_step(jparams, jnp.asarray(t, jnp.int32), jc, jcfg, jctx)
        pl, pc = M.decode_step(params, _tok(t), pc, cfg, ctx)
        assert_close(pl, np.asarray(jl), F32)
    assert pc["index"] == int(jc["index"])
    for key in ("k", "v"):
        assert_close(pc[key], np.asarray(jc[key]), F32)


def test_prefill_through_kernel_attention_matches_reference_pallas(setup):
    jcfg, cfg, jparams, params, ok, tokens = setup
    jctx, ctx = _ctxs(ok, "pallas")
    jl, jc = JM.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, jctx, attn_impl="pallas")
    pl, pc = M.prefill(params, {"tokens": _tok(tokens)}, cfg, ctx, attn_impl="kernel")
    assert_close(pl, np.asarray(jl), F32)
    assert_close(pc["k"], np.asarray(jc["k"]), F32)


@pytest.mark.parametrize("valid_len", [None, 13])
def test_sliding_window_ring_cache_matches(setup, valid_len):
    """A window shorter than the prompt: prefill lays the last tokens out as
    a ring and decode keeps writing round it."""
    jcfg, cfg, jparams, params, ok, _ = setup
    jcfg, cfg = dataclasses.replace(jcfg, sliding_window=8), dataclasses.replace(cfg, sliding_window=8)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jctx, ctx = _ctxs(ok, "fap")
    kw = {} if valid_len is None else dict(valid_len=valid_len)
    jl, jc = JM.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, jctx, cache_len=24, **kw)
    pl, pc = M.prefill(params, {"tokens": _tok(tokens)}, cfg, ctx, cache_len=24, **kw)
    assert_close(pl, np.asarray(jl), F32)
    assert_close(pc["k"], np.asarray(jc["k"]), F32)
    for t in np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 2, 1)):
        jl, jc = JM.decode_step(jparams, jnp.asarray(t, jnp.int32), jc, jcfg, jctx)
        pl, pc = M.decode_step(params, _tok(t), pc, cfg, ctx)
        assert_close(pl, np.asarray(jl), F32)


@pytest.mark.parametrize("impl,jimpl,window", [
    (impl, jimpl, window)
    for impl, jimpl in [
        ("dense", "dense"), ("blockwise", "blockwise"), ("blockwise_mx", "blockwise_mx"),
        ("blockwise_unroll", "blockwise_unroll"), ("kernel", "pallas"),
    ]
    for window in (None, 8)
    if not (impl == "blockwise_unroll" and window)  # the reference unrolls windowless only
])
def test_attention_impls_match(impl, jimpl, window):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 4, 32, 16), np.float32)
    k = rng.standard_normal((2, 2, 32, 16), np.float32)
    v = rng.standard_normal((2, 2, 32, 16), np.float32)
    ref = JL.attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=window, impl=jimpl
    )
    got = L.attention_impl(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True,
        window=window, impl=impl,
    )
    assert_close(got, np.asarray(ref), F32)


def test_blockwise_chunks_match_dense():
    """Several q and kv chunks, with causal and window skipping."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 64, 16), np.float32)) for _ in range(3))
    k, v = k[:, :2], v[:, :2]
    for window in (None, 12):
        got = L.blockwise_attention(q, k, v, causal=True, window=window, q_chunk=16, kv_chunk=8)
        ref = L.dense_attention(q, k, v, causal=True, window=window, q_offset=0)
        assert_close(got, ref, F32)


def test_dense_attention_per_sequence_offsets_match():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((3, 4, 1, 16), np.float32)
    k = rng.standard_normal((3, 2, 24, 16), np.float32)
    v = rng.standard_normal((3, 2, 24, 16), np.float32)
    off = np.array([5, 11, 23], np.int32)
    ref = JL.dense_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=None,
        q_offset=jnp.asarray(off), kv_valid_len=jnp.asarray(off + 1),
    )
    got = L.dense_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True, window=None,
        q_offset=torch.from_numpy(off), kv_valid_len=torch.from_numpy(off + 1),
    )
    assert_close(got, np.asarray(ref), F32)


def test_mask_selected_params_matches(setup):
    jcfg, cfg, jparams, params, ok, _ = setup
    jctx, ctx = _ctxs(ok, "fap")
    ref = params_from_jax(
        cfg, jax.tree.map(np.asarray, jax_mask_selected_params(jparams, jctx)), device="cpu"
    )
    got = mask_selected_params(params, ctx)
    for (name, p), (_, r) in zip(got.named_parameters(), ref.named_parameters()):
        assert torch.equal(p, r), name
    assert torch.equal(got.embed, params.embed)  # tied embeddings stay unmasked
    assert not torch.equal(got.layers[0].attn.wq, params.layers[0].attn.wq)


def test_init_params_distributions():
    cfg = reduce_config(get_arch("smollm-135m"))
    a = M.init_params(cfg, 0, device="cpu")
    b = M.init_params(cfg, 0, device="cpu")
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name
    assert abs(a.embed.std().item() - 0.02) < 0.005
    wd = a.layers[0].mlp.wd
    assert abs(wd.std().item() - cfg.d_ff**-0.5) < 0.2 * cfg.d_ff**-0.5
    assert torch.equal(a.final_ln.scale, torch.ones(cfg.d_model))
    assert not torch.equal(a.embed, M.init_params(cfg, 1, device="cpu").embed)
