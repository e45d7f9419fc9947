"""Mamba-1 selective-SSM block (falcon-mamba, and hymba's SSM branch).

Prefill and forward run the selective scan (the CUDA kernel on the card,
its plain version on the host); decode carries (conv state, SSM state),
O(1) memory in sequence length.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.masking import FaultContext, fault_linear
from repro_torch.device import resolve_device
from repro_torch.kernels.mamba_scan.ops import selective_scan, selective_step

Tensor = torch.Tensor


@dataclass
class SSMCache:
    conv: Tensor  # (B, K-1, d_inner) last inputs to the causal conv
    h: Tensor  # (B, d_inner, N) fp32 SSM state


def _causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv by shift-and-add (K is tiny, typically 4), in
    x's dtype and in the reference's order of terms.

    x: (B, L, D); w: (K, D); b: (D,)."""
    k, length = w.shape[0], x.shape[1]
    w = w.to(x.dtype)
    b = b.to(x.dtype)
    out = x * w[-1]
    for i in range(1, k):
        shifted = F.pad(x, (0, 0, i, 0))[:, :length]
        out = out + shifted * w[k - 1 - i]
    return out + b


def ssm_block(
    p,
    x: Tensor,  # (B, S, d_model)
    cfg,
    ctx: FaultContext,
    *,
    cache: Optional[SSMCache] = None,
    build_cache: bool = False,
):
    """Returns (y (B, S, d_model), new_cache).

    ``build_cache`` (prefill): run the full scan and return the decode cache
    (the conv inputs' tail and the final SSM state). With a ``cache``
    (decode) its conv and h buffers are updated IN PLACE and it is returned:
    the port's counterpart of the reference's donated cache."""
    s = x.shape[1]
    kc = cfg.ssm_conv - 1
    xz = fault_linear(x, p.in_proj, ctx)  # (B, S, 2 * d_inner)
    xb, z = xz.chunk(2, dim=-1)

    new_conv = None
    if cache is None:
        xc = _causal_conv(xb, p.conv_w, p.conv_b)
        if build_cache:
            hist = xb if s >= kc else F.pad(xb, (0, 0, kc - s, 0))
            new_conv = hist[:, -kc:]
    else:
        # decode: prepend the conv state, run the conv, keep the tail
        hist = torch.cat([cache.conv.to(xb.dtype), xb], dim=1)
        xc = _causal_conv(hist, p.conv_w, p.conv_b)[:, -s:]
        new_conv = hist[:, -kc:]
    xc = F.silu(xc)

    dbc = fault_linear(xc, p.x_proj, ctx)  # (B, S, r + 2N)
    r, n = cfg.resolved_dt_rank, cfg.ssm_state
    dt, bmat, cmat = torch.split(dbc, [r, n, n], dim=-1)
    # a bf16 GEMM output plus the fp32 bias: dt is fp32, as in the reference
    dt = F.softplus(fault_linear(dt, p.dt_w, ctx) + p.dt_b)
    a = -torch.exp(p.a_log.float())  # (d_inner, N)

    new_cache = None
    if cache is None:
        y, h_last = selective_scan(xc, dt, a, bmat, cmat, p.d_skip)
        if build_cache:
            new_cache = SSMCache(conv=new_conv, h=h_last)
    else:
        h = cache.h
        ys = []
        for i in range(s):  # decode steps are 1 (or a small static number)
            y_i, h = selective_step(h, xc[:, i], dt[:, i], a, bmat[:, i], cmat[:, i], p.d_skip)
            ys.append(y_i)
        y = torch.stack(ys, dim=1)
        cache.conv.copy_(new_conv)
        cache.h.copy_(h)
        new_cache = cache

    y = y * F.silu(z)
    return fault_linear(y, p.out_proj, ctx), new_cache


def init_ssm_cache(cfg, batch: int, dtype, *, device=None) -> SSMCache:
    """Zero decode state of one SSM layer: the conv tail in ``dtype``, h in
    fp32."""
    device = resolve_device(device)
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype, device=device),
        h=torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32, device=device),
    )
