"""Weight-stationary systolic mapping (paper SII-B, Fig. 6).

A GEMM weight ``W[d_in, d_out]`` executes on an (R, C) array as
ceil(d_in/R) x ceil(d_out/C) stationary tile loads; PE (r, c) hosts
``W[i*R + r, j*C + c]`` for every tile (i, j). A bypassed (faulty) PE zeroes
its weight, so the effective mask on W is the fault map's healthy-mask tiled
periodically:  mask_W[a, b] = ok[a % R, b % C].

Weights keep the ``(d_in, d_out)`` layout everywhere in the port; the mask
is defined on that view, so a transposed weight would mask other entries.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["periodic_mask", "masked_weight"]


def periodic_mask(
    weight_shape: tuple[int, ...], ok: torch.Tensor, dtype=torch.float32
) -> torch.Tensor:
    """Expand the (R, C) healthy mask to a weight's shape.

    The LAST TWO dims of the weight are the GEMM (d_in, d_out) view; leading
    dims replicate the same chip mask.
    """
    ok = ok.to(dtype)
    r_, c_ = ok.shape
    d_in, d_out = weight_shape[-2], weight_shape[-1]
    rows = torch.arange(d_in, device=ok.device) % r_
    cols = torch.arange(d_out, device=ok.device) % c_
    return ok[rows[:, None], cols[None, :]].expand(weight_shape)


def masked_weight(w: torch.Tensor, ok: Optional[torch.Tensor]) -> torch.Tensor:
    """FAP: zero the weights mapped onto faulty PEs."""
    if ok is None:
        return w
    return w * periodic_mask(w.shape, ok, dtype=w.dtype)
