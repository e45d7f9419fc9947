"""Model assembly for the dense family: parameters, forward, prefill, decode.

Parameters are ``nn.Module``s; the layers are an ``nn.ModuleList`` walked by
a Python loop (the reference stacks them on a leading axis and scans). Every
GEMM weight keeps the reference's ``(d_in, d_out)`` layout, because the
chip's fault mask is defined on that view; ``nn.Linear``'s ``(out, in)``
would mask other weights. Every parameterized GEMM goes through
``fault_linear``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core.masking import FaultContext, fault_linear, healthy
from repro_torch.device import resolve_device
from repro_torch.models.layers import KVCache, apply_norm, attention_block, mlp_block, rope_tables

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _empty(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device, dtype):
        super().__init__()
        self.scale = _empty(d, device=device, dtype=dtype)


class Attention(nn.Module):
    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
        self.wq = _empty(d, q, device=device, dtype=dtype)
        self.wk = _empty(d, kv, device=device, dtype=dtype)
        self.wv = _empty(d, kv, device=device, dtype=dtype)
        self.wo = _empty(q, d, device=device, dtype=dtype)


class MLP(nn.Module):
    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.wg = _empty(d, f, device=device, dtype=dtype)
        self.wu = _empty(d, f, device=device, dtype=dtype)
        self.wd = _empty(f, d, device=device, dtype=dtype)


class Layer(nn.Module):
    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.attn = Attention(cfg, device=device, dtype=dtype)
        self.ln2 = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.mlp = MLP(cfg, device=device, dtype=dtype)


class Model(nn.Module):
    """The parameters of one dense-family model, uninitialized; fill them
    with :func:`init_params` or ``repro_torch.convert.params_from_jax``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        if (cfg.family, cfg.activation, cfg.modality) != ("dense", "swiglu", "text") or (
            cfg.qk_norm or cfg.is_encoder
        ):
            raise NotImplementedError(
                f"{cfg.name}: the port runs the dense causal swiglu text family without qk_norm"
            )
        kw = dict(device=resolve_device(device), dtype=getattr(torch, cfg.param_dtype))
        self.embed = _empty(cfg.vocab_size, cfg.d_model, **kw)
        self.layers = nn.ModuleList(Layer(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_ln = RMSNorm(cfg.d_model, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = _empty(cfg.d_model, cfg.vocab_size, **kw)


@torch.no_grad()
def init_params(cfg, seed: int = 0, *, device=None) -> Model:
    """Random parameters from the port's own seeded generator, with the
    reference's distributions: embeddings N(0, 0.02^2), GEMM weights
    N(0, 1/fan_in), norm scales 1. (``jax.random`` streams cannot be
    replayed here, so parity tests hand weights over with ``convert``.)"""
    model = Model(cfg, device=device)
    dev = model.embed.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        if p.ndim == 1:
            p.fill_(1.0)
        else:
            std = 0.02 if name == "embed" else 1.0 / math.sqrt(p.shape[0])
            p.copy_(torch.randn(p.shape, generator=gen, device=dev, dtype=p.dtype) * std)
    return model


# ---------------------------------------------------------------------------
# Blocks, embedding, unembedding
# ---------------------------------------------------------------------------


def _block(lp: Layer, x, cfg, ctx, *, rope, attn_impl, cache=None, build_cache=False):
    """One layer. Returns (x, kv) — the updated KVCache or the raw (k, v)."""
    h = apply_norm(x, lp.ln1, cfg.norm_eps)
    a, kv = attention_block(
        lp.attn, h, cfg, ctx, rope=rope, impl=attn_impl, cache=cache, return_kv=build_cache
    )
    x = x + a
    h2 = apply_norm(x, lp.ln2, cfg.norm_eps)
    return x + mlp_block(lp.mlp, h2, cfg, ctx), kv


def embed_inputs(cfg, params: Model, batch: dict, ctx: FaultContext) -> tuple[Tensor, Tensor]:
    """Returns (x (B, S, d) in compute dtype, positions (B, S))."""
    tokens = batch["tokens"]
    x = params.embed[tokens].to(getattr(torch, cfg.dtype))
    b, s = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    return x, positions


def unembed(cfg, params: Model, x: Tensor, ctx: FaultContext) -> Tensor:
    # tied: a transposed view; the masked-GEMM kernel reads it in place
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    return fault_linear(x, w, ctx)


# ---------------------------------------------------------------------------
# Forward (train / eval / prefill-without-cache)
# ---------------------------------------------------------------------------


def forward(
    params: Model, batch: dict, cfg, ctx: Optional[FaultContext] = None, *, attn_impl: str = "auto"
) -> Tensor:
    """Full-sequence forward. Returns logits (B, S, V)."""
    ctx = ctx or healthy()
    x, positions = embed_inputs(cfg, params, batch, ctx)
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for lp in params.layers:
        x, _ = _block(lp, x, cfg, ctx, rope=rope, attn_impl=attn_impl)
    x = apply_norm(x, params.final_ln, cfg.norm_eps)
    return unembed(cfg, params, x, ctx)


# ---------------------------------------------------------------------------
# KV cache: init, prefill, decode
# ---------------------------------------------------------------------------


def cache_buffer_len(cfg, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache(cfg, batch: int, seq_len: int, *, device=None) -> dict:
    """Zero cache able to hold ``seq_len`` history (window-bounded for SWA):
    ``k``/``v`` of shape (L, B, Hkv, S_buf, hd) and the int ``index``."""
    s_buf = cache_buffer_len(cfg, seq_len)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, s_buf, cfg.resolved_head_dim)
    kw = dict(dtype=getattr(torch, cfg.dtype), device=resolve_device(device))
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw), "index": 0}


def _ring_perm(s_buf: int, total: int) -> np.ndarray:
    """inv_perm[slot] = index (into the last s_buf tokens) stored at slot."""
    return (np.arange(s_buf) - (total % s_buf)) % s_buf


@torch.no_grad()
def prefill(
    params: Model,
    batch: dict,
    cfg,
    ctx: Optional[FaultContext] = None,
    *,
    cache_len: Optional[int] = None,
    attn_impl: str = "auto",
    valid_len: Optional[int] = None,
) -> tuple[Tensor, dict]:
    """Full-sequence forward that also builds the decode cache.

    Returns (logits_last (B, V), cache). ``valid_len`` marks the real
    prompt length of a right-padded batch: logits come from position
    ``valid_len - 1``, the cache keeps the valid tokens (the SWA ring order
    follows ``valid_len``) and ``cache["index"] = valid_len``, so decode
    overwrites the pad. Causality alone keeps right-pad keys away from every
    real query.
    """
    ctx = ctx or healthy()
    x, positions = embed_inputs(cfg, params, batch, ctx)
    b, s = x.shape[0], x.shape[1]
    cache_len = cache_len or s
    cache = init_cache(cfg, b, cache_len, device=x.device)
    s_buf = cache["k"].shape[3]
    total = s if valid_len is None else int(valid_len)
    ring = bool(cfg.sliding_window) and s_buf == cfg.sliding_window
    if s >= s_buf:
        # the last s_buf VALID tokens end at total
        start = min(max(total - s_buf, 0), s - s_buf)
        perm = _ring_perm(s_buf, total) if ring and total >= s_buf else np.arange(s_buf)
        perm = torch.as_tensor(start + perm, device=x.device)
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for i, lp in enumerate(params.layers):
        x, (k, v) = _block(lp, x, cfg, ctx, rope=rope, attn_impl=attn_impl, build_cache=True)
        if s >= s_buf:
            cache["k"][i] = k[:, :, perm]
            cache["v"][i] = v[:, :, perm]
        else:
            cache["k"][i, :, :, :s] = k
            cache["v"][i, :, :, :s] = v
    last = x[:, total - 1 : total]
    logits = unembed(cfg, params, apply_norm(last, params.final_ln, cfg.norm_eps), ctx)[:, 0]
    cache["index"] = total
    return logits, cache


@torch.no_grad()
def decode_step(
    params: Model, tokens: Tensor, cache: dict, cfg, ctx: Optional[FaultContext] = None
) -> tuple[Tensor, dict]:
    """One autoregressive step against the dense cache from :func:`prefill`
    or :func:`init_cache`. Returns (logits (B, s_new, V), cache).

    The cache is updated IN PLACE (its k/v buffers and its index) and the
    same dict is returned: the counterpart of the reference donating it."""
    ctx = ctx or healthy()
    b, s = tokens.shape
    index = cache["index"]
    positions = (index + torch.arange(s, device=tokens.device))[None].expand(b, s)
    x = params.embed[tokens].to(getattr(torch, cfg.dtype))
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for i, lp in enumerate(params.layers):
        kv = KVCache(cache["k"][i], cache["v"][i], index)
        x, _ = _block(lp, x, cfg, ctx, rope=rope, attn_impl="dense", cache=kv)
    x = apply_norm(x, params.final_ln, cfg.norm_eps)
    logits = unembed(cfg, params, x, ctx)
    cache["index"] = index + s
    return logits, cache
