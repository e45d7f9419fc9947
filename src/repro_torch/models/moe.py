"""Mixture-of-Experts block: top-k token-choice routing with static
capacity, in two interchangeable implementations.

``einsum``  — GShard/t5x-faithful one-hot dispatch/combine einsums.
``scatter`` — position-in-expert via cumsum, an index-add dispatch and a
              gather combine: no dispatch matmuls, the same semantics.

The reference's ``shard_activation`` calls are layout hints with no math;
the port has no mesh and drops them. The expert FFN's three GEMMs go
through ``fault_einsum``: in ``kernel`` mode each is ONE launch of the
masked-GEMM kernel for all experts, under the chip's one mask.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.masking import FaultContext, fault_einsum, fault_linear

Tensor = torch.Tensor

__all__ = ["moe_block", "top_k", "capacity"]


def top_k(logits: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """(values, indices) of the k largest entries of the last axis, the
    lower index first among equal values, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no order among ties, and bf16 router logits
    tie often enough to matter): a stable descending sort, cut to k."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(b: int, s: int, cfg, capacity_factor: float) -> int:
    """Slots per expert per batch row: the reference's rule, in Python
    floats. A step with fewer tokens than experts (a decode step) gets k."""
    e, k = cfg.num_experts, cfg.experts_per_token
    return max(k, int(s * k / e * capacity_factor)) if b * s >= e else k


def _one_hot(idx: Tensor, n: int) -> Tensor:
    """``F.one_hot(idx, n)`` (int64) as a comparison with ``arange(n)``:
    the same bits, and it runs under ``torch.func.vmap`` of
    ``grad_and_value`` (the population FAT engines), where ``F.one_hot``
    reads its indices on the host and raises."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def _router(p, x2d: Tensor, cfg, ctx: FaultContext):
    """Returns (weights (T, k), expert_idx (T, k), aux_loss scalar), the
    routing and the loss in float32: the Switch load-balance term plus
    1e-3 times the router z-loss."""
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = fault_linear(x2d, p.router, ctx).float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(logits, k)
    weights = torch.softmax(gate_vals, dim=-1)  # renormalized over the chosen
    sel_onehot = _one_hot(expert_idx, e).float().sum(dim=1)  # (T, E)
    f_e = sel_onehot.mean(dim=0) / k
    p_e = probs.mean(dim=0)
    aux = e * torch.sum(f_e * p_e)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return weights, expert_idx, aux + 1e-3 * z


def _expert_ffn(p, h: Tensor, cfg, ctx: FaultContext) -> Tensor:
    """h: (E, C*, d) -> (E, C*, f) -> (E, C*, d), per-expert GEMMs."""
    if cfg.activation == "swiglu":
        g = fault_einsum("ecd,edf->ecf", h, p.wg, ctx)
        u = fault_einsum("ecd,edf->ecf", h, p.wu, ctx)
        z = F.silu(g) * u
    else:
        z = F.gelu(fault_einsum("ecd,edf->ecf", h, p.wi, ctx), approximate="tanh")
    return fault_einsum("ecf,efd->ecd", z, p.wd, ctx)


def moe_block(
    p,
    x: Tensor,  # (B, S, d)
    cfg,
    ctx: FaultContext,
    *,
    impl: str = "einsum",
    capacity_factor: float = 1.25,
) -> tuple[Tensor, Tensor]:
    """Returns (y (B, S, d), aux_loss scalar).

    Each batch row is a group with its own ``capacity`` slots per expert. A
    token's place in an expert's queue is a cumsum over the row's (token,
    choice) pairs in token-major, then choice, order; a pair past the
    capacity is dropped (its expert contributes nothing to that token).
    Dispatch and combine run in x's dtype, as the reference's do: the
    one-hot dispatch is exact, the combine rounds."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    x2d = x.reshape(b * s, d)
    weights, expert_idx, aux = _router(p, x2d, cfg, ctx)
    cap = capacity(b, s, cfg, capacity_factor)
    g, gs = b, s

    oh_g = _one_hot(expert_idx, e).reshape(g, gs, k, e)  # int64
    pos = torch.cumsum(oh_g.reshape(g, gs * k, e), dim=1).reshape(g, gs, k, e) - 1
    keep = (pos < cap) & (oh_g > 0)  # (g, gs, k, E)
    w_g = weights.reshape(g, gs, k)
    xg = x2d.reshape(g, gs, d)
    dt = x.dtype

    if impl == "einsum":
        cap_oh = _one_hot(pos.clamp(0, cap - 1), cap).to(dt)  # (g, gs, k, E, cap)
        dispatch = torch.einsum("gskec,gske->gsec", cap_oh, keep.to(dt))  # (g, gs, E, cap)
        # the reference's einsum("gsec,gsk,gske->gsec"): each (token, expert)
        # has at most one choice, so the k-sum holds one term
        combine = dispatch * torch.einsum("gsk,gske->gse", w_g.to(dt), keep.to(dt))[..., None]
        h = torch.einsum("gsec,gsd->gecd", dispatch, xg)  # (g, E, cap, d)
        h = h.transpose(0, 1).reshape(e, g * cap, d)
        out = _expert_ffn(p, h, cfg, ctx).reshape(e, g, cap, d).transpose(0, 1)  # (g, E, cap, d)
        y = torch.einsum("gsec,gecd->gsd", combine, out)
        return y.reshape(b, s, d), aux

    if impl == "scatter":
        # slot of each (token, choice): e * cap + its place; a dropped pair
        # adds zeros to a clamped slot
        slot = oh_g.argmax(dim=-1) * cap + (pos * oh_g).sum(dim=-1).clamp(0, cap - 1)  # (g, gs, k)
        keep_tok = keep.any(dim=-1)  # (g, gs, k)
        contrib = xg[:, :, None, :] * keep_tok[..., None].to(dt)  # (g, gs, k, d)
        rows = slot + torch.arange(g, device=x.device)[:, None, None] * (e * cap)
        h = torch.zeros(g * e * cap, d, dtype=dt, device=x.device)
        h = h.index_add(0, rows.reshape(-1), contrib.reshape(-1, d))
        h = h.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
        out = _expert_ffn(p, h, cfg, ctx).reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
        gathered = out.gather(1, slot.reshape(g, gs * k, 1).expand(-1, -1, d)).reshape(g, gs, k, d)
        wk = (w_g * keep_tok.to(w_g.dtype))[..., None].to(gathered.dtype)
        y = (gathered * wk).sum(dim=2)  # (g, gs, d)
        return y.reshape(b, s, d), aux

    raise ValueError(f"unknown moe impl {impl!r}")
