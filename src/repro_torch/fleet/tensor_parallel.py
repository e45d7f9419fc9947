"""Tensor-parallel compute on split member state: the sharded population
engine's ``compute="sharded"`` (:mod:`repro_torch.fleet.sharding`).

A member leaf that the logical-axis rules split over a pop slice's model
positions is a :class:`SplitTensor`: one piece a position, each on its
device, and the static layout (the split dim and each piece's offset on
it). It is a pytree node (``torch.utils._pytree``), so ``torch.func.vmap``
and ``grad_and_value`` map and differentiate its pieces, and the math runs
on them where they lie:

* ``core/masking.py::fault_linear`` runs one GEMM per piece, masked
  through the piece's own rolled map (``core/mapping.py::rolled_map``);
  ``fault_einsum`` does the same for an expert stack split inside its
  experts, and for one split over its experts runs each piece's experts on
  their slice of the dispatched tokens under the chip's whole map;
* ``models/ssm.py::ssm_block`` runs the depthwise conv, dt, A, D and the
  selective scan once a channel piece of its split ``"inner"`` leaves
  (:func:`cut` and :func:`join`);
* ``models/model.py::embed_inputs`` looks tokens up vocab-parallel
  (:func:`vocab_parallel_lookup`), and ``SplitTensor.T`` turns a
  vocab-split embedding into the column-split tied unembed;
* ``train/optimizer.py::adamw_update`` updates each piece elementwise and
  sums each piece's squares once into the grad norm.

A leaf the rules leave whole stays a plain tensor on the slice's first
device: one piece, computed whole. Nothing here gathers a leaf to its whole
shape; the engine gathers only the fit's output, as the reference's
``out_specs`` do. The combinations across positions are the column
split's and the expert split's concatenation, the row split's sum, the
lookup's sum and the grad norm: a host-issued copy or sum, local where the
device repeats in the mesh and a peer copy where it does not.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

__all__ = ["SplitTensor", "cut", "join", "vocab_parallel_lookup"]


class SplitTensor:
    """A leaf split along one dim into pieces, one a model position.

    pieces : the blocks, in position order, each on its position's device.
    axis : the split dim, counted from the end (-1, -2, ...), so it names
        the same dim with or without the leading member axis.
    offsets : each piece's start along ``axis`` in the whole leaf.
    """

    __slots__ = ("pieces", "axis", "offsets")

    def __init__(self, pieces, axis: int, offsets):
        if axis >= 0:
            raise ValueError(f"a SplitTensor's axis counts from the end, got {axis}")
        self.pieces, self.axis, self.offsets = list(pieces), int(axis), tuple(int(o) for o in offsets)

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    @property
    def T(self) -> "SplitTensor":
        """The transpose of the last two dims (a member's 2-D leaf): each
        piece transposed in place, the split dim swapped, the offsets kept.
        A vocab-split ``embed`` (rows) becomes the column-split unembed."""
        return SplitTensor([p.transpose(-1, -2) for p in self.pieces], -3 - self.axis, self.offsets)

    def full(self, device=None) -> torch.Tensor:
        """The whole leaf on ``device`` (default: the first piece's)."""
        device = self.pieces[0].device if device is None else device
        return torch.cat([p.to(device) for p in self.pieces], dim=self.axis)


pytree.register_pytree_node(
    SplitTensor,
    lambda s: (list(s.pieces), (s.axis, s.offsets)),
    lambda pieces, ctx: SplitTensor(pieces, *ctx),
    serialized_type_name="repro_torch.fleet.tensor_parallel.SplitTensor",
)


def cut(x: torch.Tensor, leaf, dim: int) -> list:
    """An activation cut to a split leaf's pieces along ``dim``: piece j is
    ``x``'s span at leaf piece j's offset, as long as that piece along the
    leaf's split dim, on that piece's device (a view where the device is
    x's). The channels of an SSM's split ``"inner"`` leaves, the experts of
    a split expert stack, the K of a row split. A whole leaf (a plain
    tensor) is one piece: ``[x]``."""
    if isinstance(leaf, torch.Tensor):
        return [x]
    return [x.narrow(dim, o, p.shape[leaf.axis]).to(p.device) for p, o in zip(leaf.pieces, leaf.offsets)]


def join(parts, dim: int, device) -> torch.Tensor:
    """The pieces of an activation (``cut``'s, or one output a piece) put
    back together along ``dim`` on ``device``: the one copy across
    positions a column split's output needs. One part is returned as it
    is, moved to ``device`` only if it lies elsewhere."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([t.to(device) for t in parts], dim=dim)


def vocab_parallel_lookup(table: SplitTensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a table split on its rows (the vocab): each piece
    looks up the ids in its row range and writes zero elsewhere, and the
    pieces' rows are summed on the ids' device. Exactly one piece holds
    each id, so the sum adds only zeros to it."""
    if table.axis != -2:
        raise ValueError(f"a vocab-parallel lookup takes a table split on its rows, got axis {table.axis}")
    out = None
    for piece, v0 in zip(table.pieces, table.offsets):
        local = ids.to(piece.device) - v0
        hit = (local >= 0) & (local < piece.shape[-2])
        rows = piece[local.clamp(0, piece.shape[-2] - 1)] * hit[..., None].to(piece.dtype)
        rows = rows.to(ids.device)
        out = rows if out is None else out + rows
    return out
