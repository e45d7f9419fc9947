"""Weight-stationary systolic mapping (paper SII-B, Fig. 6).

A GEMM weight ``W[d_in, d_out]`` executes on an (R, C) array as
ceil(d_in/R) x ceil(d_out/C) stationary tile loads; PE (r, c) hosts
``W[i*R + r, j*C + c]`` for every tile (i, j). A bypassed (faulty) PE zeroes
its weight, so the effective mask on W is the fault map's healthy-mask tiled
periodically:  mask_W[a, b] = ok[a % R, b % C].

Weights keep the ``(d_in, d_out)`` layout everywhere in the port; the mask
is defined on that view, so a transposed weight would mask other entries.

Also provides the FAM (SalvageDNN [12]) saliency-driven column-permutation
baseline: mitigation without retraining. Its search runs on the host in
numpy and scipy, as the reference's does, so both packages choose the same
permutation for the same weights.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.faults import FaultMap

__all__ = [
    "periodic_mask",
    "masked_weight",
    "rolled_map",
    "fam_permutation",
    "apply_fam",
    "expected_weight_loss",
]


def periodic_mask(
    weight_shape: tuple[int, ...], ok: torch.Tensor, dtype=torch.float32
) -> torch.Tensor:
    """Expand the (R, C) healthy mask to a weight's shape.

    The LAST TWO dims of the weight are the GEMM (d_in, d_out) view; leading
    dims replicate the same chip mask. A stack of masks (chips, R, C) gives
    each chip's (chips, d_in, d_out) mask.
    """
    ok = ok.to(dtype)
    r_, c_ = ok.shape[-2:]
    d_in, d_out = weight_shape[-2], weight_shape[-1]
    rows = torch.arange(d_in, device=ok.device) % r_
    cols = torch.arange(d_out, device=ok.device) % c_
    return ok[..., rows[:, None], cols[None, :]].expand(weight_shape)


def masked_weight(w: torch.Tensor, ok: Optional[torch.Tensor]) -> torch.Tensor:
    """FAP: zero the weights mapped onto faulty PEs."""
    if ok is None:
        return w
    return w * periodic_mask(w.shape, ok, dtype=w.dtype)


def rolled_map(ok: torch.Tensor, r0: int, c0: int) -> torch.Tensor:
    """The map of a piece of a weight that starts at ``(r0, c0)`` of its
    ``(d_in, d_out)`` view: ``periodic_mask`` of the result over the
    piece's shape is the slice of the whole weight's mask at that origin.
    Entry ``(i, j)`` is ``ok[(i + r0) % R, (j + c0) % C]``, on the last
    two dims, so a chip stack ``(chips, R, C)`` rolls every chip alike. An
    origin on a multiple of ``(R, C)`` gives ``ok`` itself."""
    r_, c_ = ok.shape[-2:]
    shift = (-r0 % r_, -c0 % c_)
    return ok if shift == (0, 0) else torch.roll(ok, shift, dims=(-2, -1))


# ---------------------------------------------------------------------------
# FAM baseline (SalvageDNN [12]) — saliency-driven fault-aware mapping
# ---------------------------------------------------------------------------


_EXACT_ASSIGNMENT_MAX_DOUT = 2048  # Hungarian is O(d_out^3)


def _greedy_perm(saliency: np.ndarray, slot_badness: np.ndarray) -> np.ndarray:
    """Rearrangement-inequality pairing: least-salient logical columns into
    the worst slots — the exact minimizer of the separable proxy cost
    ``sum(saliency[j] * badness[perm[j]])``, so it never exceeds the
    identity (FAP) placement on that proxy."""
    d_out = len(saliency)
    slots_by_badness = np.argsort(-slot_badness, kind="stable")  # worst first
    logical_by_saliency = np.argsort(saliency, kind="stable")  # least salient first
    perm = np.empty(d_out, dtype=np.int64)
    perm[logical_by_saliency] = slots_by_badness
    return perm


def fam_permutation(w: Union[np.ndarray, torch.Tensor], fm: FaultMap) -> np.ndarray:
    """Choose an output-column permutation mapping salient weight columns
    away from faulty array columns.

    Column j of W executes on array column ``j % C``; permuting output
    columns (filters/neurons) re-routes them. The cost of placing logical
    column j in slot s is the saliency mass actually zeroed there —
    ``sum(|W[a, j]|  for GEMM rows a with faulty[a % R, s % C])`` (leading
    dims replicate the same mask per GEMM, as ``periodic_mask`` does). The
    assignment minimizing total zeroed mass is solved exactly (Hungarian);
    the identity (= plain FAP placement) is always feasible, so FAM never
    bypasses more saliency mass than FAP. Layers wider than 2048 columns
    use the greedy saliency/fault-count pairing, which carries the same
    never-worse-than-FAP guarantee on its separable proxy cost.

    Returns ``perm``: logical output j is computed in physical slot
    ``perm[j]``.
    """
    from scipy.optimize import linear_sum_assignment

    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    d_in, d_out = w.shape[-2], w.shape[-1]
    rows, cols = fm.shape
    w2 = np.abs(np.asarray(w, dtype=np.float64).reshape(-1, d_out))
    if d_out > _EXACT_ASSIGNMENT_MAX_DOUT:
        col_faults = fm.faulty.sum(axis=0).astype(np.float64)  # (C,)
        return _greedy_perm(w2.sum(axis=0), col_faults[np.arange(d_out) % cols])
    # fold the R-periodic rows: damage[j, c] is the saliency mass of logical
    # column j zeroed when it runs on physical column c
    row_idx = np.tile(np.arange(d_in) % rows, w2.shape[0] // d_in)
    folded = np.zeros((rows, d_out))
    np.add.at(folded, row_idx, w2)
    damage = folded.T @ fm.faulty.astype(np.float64)  # (d_out, C)
    cost = damage[:, np.arange(d_out) % cols].astype(np.float32)  # (d_out, slots)
    logical, slots = linear_sum_assignment(cost)
    perm = np.empty(d_out, dtype=np.int64)
    perm[logical] = slots
    return perm


def apply_fam(w: torch.Tensor, ok: torch.Tensor, perm: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
    """Effective FAM weight: permute columns into slots, mask, un-permute.

    out[:, j] = (W[:, j] placed in slot perm[j], masked there)
    """
    perm = torch.as_tensor(perm, dtype=torch.int64, device=w.device)
    w_slots = torch.zeros_like(w).index_copy(-1, perm, w)  # slot s holds logical perm^-1(s)
    w_slots = masked_weight(w_slots, ok)
    return w_slots.index_select(-1, perm)  # back to logical order


def expected_weight_loss(weight_shape: tuple[int, int], fm: FaultMap) -> float:
    """Fraction of weight entries zeroed by FAP for this (shape, map)."""
    d_in, d_out = weight_shape
    reps_r = np.bincount(np.arange(d_in) % fm.shape[0], minlength=fm.shape[0])
    reps_c = np.bincount(np.arange(d_out) % fm.shape[1], minlength=fm.shape[1])
    hits = reps_r @ fm.faulty.astype(np.int64) @ reps_c
    return float(hits) / float(d_in * d_out)
