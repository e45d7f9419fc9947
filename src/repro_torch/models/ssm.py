"""Mamba-1 selective-SSM block (falcon-mamba, and hymba's SSM branch).

Prefill and forward run the selective scan (the CUDA kernel on the card,
its backward kernel where a gradient is asked of it, the plain version on
the host);
decode carries (conv state, SSM state), O(1) memory in sequence length.
Under the sharded engine's ``compute="sharded"`` the ``"inner"`` leaves
come split over model positions, and the block runs a scan a channel
piece (:func:`_scan_pieces`).
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

    if cache is None:
        y, h_last = _scan_pieces(p, xb, cfg, ctx)
        new_cache = None
        if build_cache:
            hist = xb if s >= kc else F.pad(xb, (0, 0, kc - s, 0))
            new_cache = SSMCache(conv=hist[:, -kc:], h=h_last)
    else:
        if not isinstance(p.conv_w, Tensor):
            raise ValueError("a channel-split SSM block runs the forward and prefill; decode takes whole leaves")
        # decode: prepend the conv state, run the conv, keep the tail
        hist = torch.cat([cache.conv.to(xb.dtype), xb], dim=1)
        xc = F.silu(_causal_conv(hist, p.conv_w, p.conv_b)[:, -s:])
        dt, bmat, cmat = _dt_b_c(p, xc, cfg, ctx)
        a = -torch.exp(p.a_log.float())  # (d_inner, N)
        h = cache.h
        ys = []
        for i in range(s):  # decode steps are 1 (or a small static number)
            y_i, h = selective_step(h, xc[:, i], dt[:, i], a, bmat[:, i], cmat[:, i], p.d_skip)
            ys.append(y_i)
        y = torch.stack(ys, dim=1)
        cache.conv.copy_(hist[:, -kc:])
        cache.h.copy_(h)
        new_cache = cache

    y = y * F.silu(z)
    return fault_linear(y, p.out_proj, ctx), new_cache


def _dt_b_c(p, xc: Tensor, cfg, ctx: FaultContext):
    """x_proj's dt, B and C, dt through dt_w and its fp32 bias (a bf16 GEMM
    output plus the bias: dt is fp32, as in the reference)."""
    dbc = fault_linear(xc, p.x_proj, ctx)  # (B, S, r + 2N)
    r, n = cfg.resolved_dt_rank, cfg.ssm_state
    dt, bmat, cmat = torch.split(dbc, [r, n, n], dim=-1)
    return F.softplus(fault_linear(dt, p.dt_w, ctx, bias=p.dt_b)), bmat, cmat


def _scan_pieces(p, xb: Tensor, cfg, ctx: FaultContext):
    """The block's conv, projections and scan with no cache: (y (B, S,
    d_inner), h_last (B, d_inner, N)), both on xb's device.

    The depthwise conv, dt's bias, A, D and the scan act on each channel
    alone, so each runs once a channel piece, on the piece's device: one
    ``selective_scan`` a piece (u, dt, A and D cut at the piece's offsets;
    B and C, which every channel reads, whole). A whole leaf is one piece.
    Under the sharded engine's ``compute="sharded"`` the ``"inner"`` leaves
    come split over model positions: ``x_proj`` is then a row split (K cut,
    partial products summed) and ``dt_w`` a column split whose pieces take
    ``dt_b``'s pieces (``core/masking.py::_split_gemm``); ``in_proj``'s
    column split has come back joined, so its pieces need not line up with
    the x and z halves (at two pieces they are the halves)."""
    # imported here: the fleet package imports the model modules
    from repro_torch.fleet.tensor_parallel import cut, join

    channels = p.conv_w
    for name in ("conv_b", "dt_b", "a_log", "d_skip"):
        leaf = getattr(p, name)
        if isinstance(leaf, Tensor) != isinstance(channels, Tensor) or (
                not isinstance(leaf, Tensor) and leaf.offsets != channels.offsets):
            raise ValueError(f"a channel-split SSM block needs {name} split as conv_w is")
    xcs = [F.silu(_causal_conv(xj, w, b)) for xj, w, b in zip(cut(xb, channels, -1), _pieces(channels),
                                                             _pieces(p.conv_b))]
    dt, bmat, cmat = _dt_b_c(p, join(xcs, -1, xb.device), cfg, ctx)
    ys, hs = [], []
    for xj, dtj, a_log, d_skip in zip(xcs, cut(dt, channels, -1), _pieces(p.a_log), _pieces(p.d_skip)):
        dev = xj.device
        y, h_last = selective_scan(xj, dtj, -torch.exp(a_log.float()), bmat.to(dev), cmat.to(dev), d_skip)
        ys.append(y)
        hs.append(h_last)
    return join(ys, -1, xb.device), join(hs, -2, xb.device)


def _pieces(leaf) -> list:
    return [leaf] if isinstance(leaf, Tensor) else leaf.pieces


def init_ssm_cache(cfg, batch: int, dtype, *, device=None) -> SSMCache:
    """Zero decode state of one SSM layer: the conv tail in ``dtype``, h in
    fp32."""
    device = resolve_device(device)
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype, device=device),
        h=torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32, device=device),
    )
