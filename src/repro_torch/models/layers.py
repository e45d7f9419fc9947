"""Model building blocks — PyTorch, fault-aware.

Every parameterized matmul routes through ``fault_linear`` so a chip's fault
map (FaultContext) masks exactly the weights that the systolic mapping places
on faulty PEs.

Attention has three interchangeable implementations:
  dense      — materializes scores; for short q (decode) and small prompts
  blockwise  — plain-PyTorch flash (online softmax over kv chunks, chunks
               the causal/window masks exclude are skipped)
  kernel     — the hand-written CUDA kernel (``kernels/flash_attention``);
               its plain version on a CPU tensor
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core.masking import FaultContext, fault_linear
from repro_torch.kernels.flash_attention.ops import flash_attention

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor, eps: float = 1e-5) -> Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(x: Tensor, p, eps: float) -> Tensor:
    """``p`` is a norm module with a ``scale``, and a ``bias`` for a
    LayerNorm (the audio family); RMSNorm otherwise."""
    bias = getattr(p, "bias", None)
    if bias is not None:
        return layer_norm(x, p.scale, bias, eps)
    return rms_norm(x, p.scale, eps)


# ---------------------------------------------------------------------------
# RoPE (split-half)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def rope_tables(positions: Tensor, head_dim: int, theta: float) -> tuple[Tensor, Tensor]:
    """(cos, sin), each (B, 1, S, D/2), for absolute ``positions`` (B, S).
    Every layer rotates by the same tables, so a forward builds them once."""
    inv = rope_frequencies(head_dim, theta, positions.device)
    ang = positions[:, None, :, None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: Tensor, rope: tuple[Tensor, Tensor]) -> Tensor:
    """x: (B, H, S, D) rotated split-half by the ``rope_tables``."""
    cos, sin = rope
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention implementations
# ---------------------------------------------------------------------------


def dense_attention(
    q: Tensor, k: Tensor, v: Tensor, *, causal: bool, window: Optional[int],
    q_offset: Union[int, Tensor], kv_valid_len: Union[None, int, Tensor] = None,
    scale: Optional[float] = None, segments: Optional[Tensor] = None,
) -> Tensor:
    """Materializing attention. ``q_offset`` / ``kv_valid_len`` are ints, or
    per-sequence ``(B,)`` tensors where every sequence sits at its own
    position (the paged decode, every slot in its own KV chain).

    ``segments`` is a ``(B, S)`` int tensor for packed prefill (several
    prompts in one row, ``serve/bucketing.py``): tokens attend only within
    their own segment. It needs ``sq == skv``: the ids describe queries and
    keys at once. Causal and window masks stay in packed-row index space,
    which equals each segment's position space because packed positions
    restart per segment (the pad tail is segment 0, so each pad row keeps
    at least itself)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if segments is not None and sq != skv:
        raise ValueError(f"segment masking needs sq == skv, got {sq} vs {skv}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    group = hq // hkv
    qg = q.reshape(b, hkv, group, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    per_seq = isinstance(q_offset, Tensor) or isinstance(kv_valid_len, Tensor) or segments is not None
    cols = torch.arange(skv, device=q.device)
    if per_seq:
        off = torch.as_tensor(q_offset, device=q.device).expand(b)
        rows = off[:, None, None] + torch.arange(sq, device=q.device)[None, :, None]
        keep = torch.ones((b, sq, skv), dtype=torch.bool, device=q.device)
        cols = cols[None, None, :]
    else:
        rows = torch.arange(sq, device=q.device)[:, None] + q_offset
        keep = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
        cols = cols[None, :]
    # out of place: under the fleet's vmap the masks are batched
    if causal:
        keep = keep & (cols <= rows)
    if window is not None:
        keep = keep & (cols > rows - window)
    if kv_valid_len is not None:
        # a Python int stays on the host: a device copy of it would block
        vld = kv_valid_len
        if per_seq:
            vld = torch.as_tensor(vld, device=q.device).expand(b)[:, None, None]
        keep = keep & (cols < vld)
    if segments is not None:
        keep = keep & (segments[:, :, None] == segments[:, None, :])
    keep = keep[:, None, None] if per_seq else keep
    s = s.masked_fill(~keep, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


def blockwise_attention(
    q: Tensor, k: Tensor, v: Tensor, *, causal: bool, window: Optional[int],
    q_offset: int = 0, q_chunk: int = 1024, kv_chunk: int = 1024,
    scale: Optional[float] = None, mixed: bool = False,
) -> Tensor:
    """Plain-PyTorch flash attention: online softmax over kv chunks, one q
    chunk at a time; kv chunks that the causal and window masks exclude for
    the whole q chunk are skipped. ``mixed=True`` rounds the QK/PV operands
    to the input dtype (fp32 accumulation; softmax stats stay fp32)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    group = hq // hkv
    q_chunk = min(q_chunk, sq)
    while sq % q_chunk:
        q_chunk //= 2
    kv_chunk = min(kv_chunk, skv)
    while skv % kv_chunk:
        kv_chunk //= 2
    dot_dtype = q.dtype if mixed else torch.float32

    def rnd(t):
        return t.to(dot_dtype).float()

    kg, vg = rnd(k), rnd(v)
    outs = []
    for qs in range(0, sq, q_chunk):
        lo, hi = q_offset + qs, q_offset + qs + q_chunk - 1
        qc = rnd(q[:, :, qs : qs + q_chunk]).reshape(b, hkv, group, q_chunk, d)
        rows = lo + torch.arange(q_chunk, device=q.device)[:, None]
        acc = torch.zeros((b, hkv, group, q_chunk, d), device=q.device)
        m_run = torch.full((b, hkv, group, q_chunk, 1), -1e30, device=q.device)
        l_run = torch.zeros((b, hkv, group, q_chunk, 1), device=q.device)
        spans = []
        for ks in range(0, skv, kv_chunk):
            if causal and ks > hi:
                break
            if window is not None and ks + kv_chunk - 1 <= lo - window:
                continue
            spans.append((ks, ks + kv_chunk))
        if q.device.type == "meta" and spans:
            # shapes only (the dry run): the visited chunks are contiguous, so
            # one span over them runs the same products in fewer ops
            spans = [(spans[0][0], spans[-1][1])]
        for ks, ke in spans:
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kg[:, :, ks:ke]) * scale
            cols = ks + torch.arange(ke - ks, device=q.device)[None, :]
            keep = torch.ones((q_chunk, ke - ks), dtype=torch.bool, device=q.device)
            if causal:
                keep = keep & (cols <= rows)
            if window is not None:
                keep = keep & (cols > rows - window)
            s = s.masked_fill(~keep, -1e30)
            m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", rnd(p), vg[:, :, ks:ke])
            m_run = m_new
        o = acc / l_run.clamp_min(1e-30)
        outs.append(o.reshape(b, hq, q_chunk, d).to(q.dtype))
    return torch.cat(outs, dim=2)


def attention_impl(
    q, k, v, *, causal, window, q_offset=0, impl="auto", kv_valid_len=None, scale=None,
    segments=None,
):
    sq = q.shape[2]
    if impl == "auto":
        impl = (
            "dense"
            if (sq <= 512 or kv_valid_len is not None or segments is not None)
            else "blockwise"
        )
    if impl == "dense":
        return dense_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            kv_valid_len=kv_valid_len, scale=scale, segments=segments,
        )
    if segments is not None:
        raise ValueError(f"segment-packed attention is dense-only, got impl {impl!r}")
    if impl.startswith("blockwise"):
        return blockwise_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset, scale=scale,
            mixed="_mx" in impl,
        )
    if impl == "kernel":
        return flash_attention(
            q, k, v, causal=causal, window=window, q_offset=int(q_offset), scale=scale
        )
    raise ValueError(f"unknown attention impl {impl!r}")


# ---------------------------------------------------------------------------
# Attention block (GQA + RoPE + qk_norm + SWA) with optional KV cache
# ---------------------------------------------------------------------------


@dataclass
class KVCache:
    k: Tensor  # (B, Hkv, S_buf, D)
    v: Tensor
    index: int  # absolute position of the next token


@dataclass
class PagedKVView:
    """One layer's slice of a paged KV cache (``models/model.py::
    init_paged_cache``).

    The pool holds ``P`` pages of ``page_size`` tokens each; slot ``b``'s
    history is the page chain ``block_tables[b]`` truncated to
    ``seq_lens[b]`` tokens. Page 0 is reserved as a scratch page: writes of
    masked-out slots (``write_mask`` False — retired slots between
    retirement and re-admission) are redirected there so they can never
    corrupt pages the allocator has already handed to another slot. Page 0
    is never read as a valid key: unused block-table entries are 0 and lie
    past ``seq_lens``.
    """

    k_pages: Tensor  # (P, Hkv, page_size, D), written in place
    v_pages: Tensor
    block_tables: Tensor  # (S, max_pages) int64 page ids
    seq_lens: Tensor  # (S,) int64 tokens already cached per slot
    write_mask: Optional[Tensor]  # (S,) bool; None = every slot writes


def attention_block(
    p,
    x: Tensor,  # (B, S, d_model)
    cfg,
    ctx: FaultContext,
    *,
    rope: Optional[tuple[Tensor, Tensor]],
    impl: str = "auto",
    cache: Union[None, KVCache, PagedKVView] = None,
    return_kv: bool = False,
    segments: Optional[Tensor] = None,
):
    """``rope`` holds the ``rope_tables`` of the tokens' positions (None for
    an encoder, which takes no RoPE). With ``cfg.qk_norm`` q and k get a
    per-head RMSNorm over ``head_dim`` (``q_norm`` / ``k_norm``) after their
    projections and before RoPE. An encoder attends bidirectionally.

    Returns (out, new_cache). With ``return_kv`` (prefill) the second
    element is the raw (k, v) pair (B, Hkv, S, D) for cache assembly.
    ``segments`` (packed prefill, cache-free path only) restricts attention
    to same-segment tokens — see ``dense_attention``.

    With a ``cache`` the new keys and values are written INTO the caller's
    buffers by indexed assignment: the port's counterpart of the reference's
    donated KV buffers, which XLA updates in place. A ``PagedKVView`` (paged
    decode, one token a slot) takes each slot's token into its current page,
    a masked-out slot's into scratch page 0, then gathers every slot's chain
    and attends at the slot's own position."""
    b, s, _ = x.shape
    if segments is not None and cache is not None:
        raise ValueError("segment-packed attention is a cache-free prefill path")
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = fault_linear(x, p.wq, ctx).view(b, s, hq, hd)
    k = fault_linear(x, p.wk, ctx).view(b, s, hkv, hd)
    v = fault_linear(x, p.wv, ctx).view(b, s, hkv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q, k = q.transpose(1, 2), k.transpose(1, 2)  # (B, H, S, D)
    if not cfg.is_encoder:
        q = apply_rope(q, rope)
        k = apply_rope(k, rope)

    new_cache = None
    if isinstance(cache, PagedKVView):
        if s != 1:
            raise ValueError(f"paged decode is one token per step, got s={s}")
        page = cache.k_pages.shape[2]
        maxp = cache.block_tables.shape[1]
        pos = cache.seq_lens  # (S,)
        chain_ix = (pos // page).clamp(0, maxp - 1)
        page_ix = cache.block_tables.gather(1, chain_ix[:, None])[:, 0]
        if cache.write_mask is not None:
            page_ix = torch.where(cache.write_mask, page_ix, 0)  # page 0 = scratch
        off = pos % page
        # the two indices around the Hkv slice put the slot dim first: (S, Hkv, D)
        cache.k_pages[page_ix, :, off] = k[:, :, 0].to(cache.k_pages.dtype)
        cache.v_pages[page_ix, :, off] = v[:, :, 0].to(cache.v_pages.dtype)
        # (S, maxp, Hkv, page, D) -> (S, Hkv, maxp * page, D)
        kg = cache.k_pages[cache.block_tables].movedim(2, 1).reshape(b, hkv, maxp * page, hd)
        vg = cache.v_pages[cache.block_tables].movedim(2, 1).reshape(b, hkv, maxp * page, hd)
        o = dense_attention(
            q, kg, vg, causal=True, window=cfg.sliding_window, q_offset=pos, kv_valid_len=pos + 1
        )
        new_cache = cache
    elif cache is not None:
        s_buf = cache.k.shape[2]
        window = cfg.sliding_window
        ring = bool(window) and s_buf == window
        # rolling buffer for SWA; linear buffer otherwise
        slot = cache.index % s_buf if ring else cache.index
        if slot + s > s_buf:
            raise ValueError(f"KV cache of {s_buf} slots cannot take {s} tokens at slot {slot}")
        cache.k[:, :, slot : slot + s] = k
        cache.v[:, :, slot : slot + s] = v
        new_cache = KVCache(cache.k, cache.v, cache.index + s)
        if ring:
            # softmax is order-free given the mask: every written ring slot
            # is an in-window key, unwritten ones are masked by length
            o = dense_attention(
                q, cache.k, cache.v, causal=False, window=None,
                q_offset=0, kv_valid_len=min(cache.index + s, s_buf),
            )
        else:
            o = dense_attention(
                q, cache.k, cache.v, causal=True, window=window,
                q_offset=cache.index, kv_valid_len=cache.index + s,
            )
    else:
        o = attention_impl(
            q, k, v, causal=not cfg.is_encoder, window=cfg.sliding_window, q_offset=0, impl=impl,
            segments=segments,
        )
        if return_kv:
            new_cache = (k, v)
    o = o.transpose(1, 2).reshape(b, s, hq * hd)
    return fault_linear(o, p.wo, ctx), new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_block(p, x: Tensor, cfg, ctx: FaultContext) -> Tensor:
    """SwiGLU MLP (``wg``, ``wu``, ``wd``), or the gelu one (``wi``, ``wd``).
    The gelu is the tanh form: the reference's ``jax.nn.gelu`` defaults to
    ``approximate=True``."""
    if cfg.activation == "swiglu":
        h = F.silu(fault_linear(x, p.wg, ctx)) * fault_linear(x, p.wu, ctx)
    else:
        h = F.gelu(fault_linear(x, p.wi, ctx), approximate="tanh")
    return fault_linear(h, p.wd, ctx)
