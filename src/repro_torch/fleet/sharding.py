"""Device-sharded population FAT: the population split over a "pop" mesh
axis, each member's state stored split over a "model" axis.

:class:`repro_torch.train.population.PopulationFATEngine` turns N fault
maps into one ``torch.func.vmap`` step. This engine makes the population
axis a *device* axis: a chunk is split over the pop slices of a fleet mesh
(:func:`repro_torch.launch.mesh.make_pop_mesh` / ``make_fleet_mesh``), and
each slice runs the parent's run bodies (``_fit_run``, ``_steps_run``,
``_eval_pop``) on its sub-population, on the device at its mesh position.

On a 2-D ``("pop", "model")`` mesh each pop slice is itself a sub-mesh:
between steps every member-stacked leaf of (params, opt state) is stored
split along the dim the logical-axis rules assign to "model"
(:func:`repro_torch.launch.sharding.make_rules_for_mesh` with "pop"
reserved), one piece on each model position's device. With
``compute="gathered"`` (the default) it is gathered to full shape on the
slice's first device for every update and evaluation. With
``compute="sharded"`` the math runs on the pieces
(:mod:`repro_torch.fleet.tensor_parallel`): each GEMM at its pieces'
shapes, each piece masked through the chip's map rolled to the piece's
origin, the outputs joined only where the next op needs the whole
activation; the update is elementwise per piece and the grad norm sums
the pieces.

Design invariants, the reference's (``src/repro/fleet/sharding.py``):

* **Identical math.** With ``compute="gathered"`` every update and
  evaluation runs at the vmap engine's per-member shapes, on state gathered
  to full shape: a member's trajectory depends only on its own (mask,
  budget) and the shared batch stream, so steps-to-constraint and
  resilience tables equal the vmap engine's, and params agree to float
  tolerance (a vmap of another width batches the same member math
  differently). ``compute="sharded"`` is tensor-parallel math (FLOPs split
  too), equal to float tolerance: a row split sums partial products. The
  engine is one process that issues every slice's work, so the combination
  across positions is a host-issued copy or sum: local where the device
  repeats in the mesh, a peer copy where it does not. MoE experts split
  over the model axis run each piece's experts on their slice of the
  dispatched tokens; an SSM's split "inner" channels run a scan a piece.
* **Population -> device mapping.** A chunk of ``population_size`` members
  is padded to a multiple of the pop extent and split contiguously: pop
  slice d takes members ``[d*k, (d+1)*k)``. Padding members are zero-budget
  (fit) or duplicates (probe, evaluation) and are sliced off the results.
* **Per-slice early exit, in lockstep.** Each round advances every live
  slice by one step (an eval period in a probe). A slice's only host read,
  the probe's "has every member crossed?", waits on its own previous
  period, which every live slice issued in the round before; so slices on
  several cards overlap. A slice whose fit budget is spent, or whose
  members have all crossed the constraint, is no longer issued. (On one
  card the slices run in turn.)
* **Moves.** Masks and ``params0`` move to a slice's device once per chunk,
  each batch once per step; a device repeated in the mesh moves nothing.

All-healthy submissions (mode ``none``, the pretrain call) have no mask to
split and run the parent's single-slice path.
"""
from __future__ import annotations

import contextlib
import copy
import math
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.mapping import rolled_map
from repro_torch.fleet.scheduler import round_up_to_multiple
from repro_torch.fleet.tensor_parallel import SplitTensor
from repro_torch.launch.mesh import Mesh, make_pop_mesh
from repro_torch.launch.sharding import MeshContext, is_axes_leaf, make_rules_for_mesh, resolve_spec
from repro_torch.train.optimizer import opt_state_specs
from repro_torch.train.population import PopulationFATEngine, _device_of, _tree_map

__all__ = ["ShardedPopulationEngine"]


def _gemm_origins(leaf: SplitTensor) -> list[tuple[int, int]]:
    """The origins on a GEMM's ``(d_in, d_out)`` view that a member-stacked
    split leaf's pieces can have: a leaf of two or more dims (the member
    axis aside) split on one of its last two takes each offset as a row and
    as a column origin (a leaf may be read transposed, as the tied unembed
    reads the embedding). A stack split over its experts keeps each
    expert's whole view, and a 1-D leaf (a bias, the SSM's D) is no GEMM's:
    neither has an origin."""
    if leaf.pieces[0].dim() < 3 or leaf.axis not in (-1, -2):
        return []
    return [key for o in leaf.offsets for key in ((o, 0), (0, o))]


class _Split:
    """A member-stacked leaf stored split over a pop slice's model
    positions: ``pieces[j]`` is the block position j holds, on its device,
    at ``index[j]`` of the full leaf (replicated dims and leaves: whole)."""

    __slots__ = ("pieces", "index", "shape", "dtype")

    def __init__(self, pieces, index, shape, dtype):
        self.pieces, self.index, self.shape, self.dtype = pieces, index, shape, dtype


class ShardedPopulationEngine(PopulationFATEngine):
    """PopulationFATEngine whose chunks run split over a mesh's pop slices.

    Parameters (beyond the population engine's):

    mesh : a 1-D pop mesh (``make_pop_mesh``) or a 2-D ``("pop", "model")``
        fleet mesh (``make_fleet_mesh``). Default: ``make_pop_mesh()`` over
        every visible card. Any axes but the pop axis form each pop slice's
        model sub-mesh.
    axis_name : the population axis name ("pop").
    cfg : the ArchConfig whose rules (``make_rules_for_mesh`` with the pop
        axis reserved) lay member state out; required, with ``param_axes``,
        when the model sub-mesh has more than one position. ``mesh_rules``
        overrides it with a prebuilt MeshContext.
    compute : "gathered" (default): member state stored split, gathered to
        full shape for each update and evaluation. "sharded": the update
        and the evaluation run on the stored pieces (tensor-parallel math;
        equal to float tolerance, not bitwise), every family the rules lay
        out: dense, classifier, MoE (experts or their FFN split), SSM and
        hybrid (channels split).

    ``population_size`` is rounded up to a multiple of the pop extent so
    every chunk tiles the mesh.
    """

    kind = "sharded"

    def __init__(
        self,
        *,
        mesh: Optional[Mesh] = None,
        axis_name: str = "pop",
        cfg: Any = None,
        mesh_rules: Optional[MeshContext] = None,
        compute: str = "gathered",
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.mesh = mesh if mesh is not None else make_pop_mesh(axis=axis_name)
        if axis_name not in self.mesh.shape:
            raise ValueError(
                f"mesh axes {tuple(self.mesh.shape)} lack population axis {axis_name!r}"
            )
        if compute not in ("gathered", "sharded"):
            raise ValueError(
                f"compute must be 'gathered' or 'sharded', got {compute!r}"
            )
        self.axis_name = axis_name
        self.compute = compute
        # num_shards is the POP-AXIS EXTENT, not the device count: chunk
        # rounding, scheduler width rounding and padding all key on how many
        # pop slices exist, however many devices each slice spans
        self.num_shards = int(self.mesh.shape[axis_name])
        self.model_axes = tuple(a for a in self.mesh.axis_names if a != axis_name)
        self.model_size = int(math.prod(self.mesh.shape[a] for a in self.model_axes))
        if self.model_size > 1:
            if mesh_rules is not None:
                self.mesh_rules: Optional[MeshContext] = mesh_rules
            elif cfg is not None:
                self.mesh_rules = make_rules_for_mesh(
                    cfg, self.mesh, fsdp=False, reserved_axes=(axis_name,)
                )
            else:
                raise ValueError(
                    "a 2-D fleet mesh with a model axis needs tensor-parallel rules: pass cfg= (an "
                    "ArchConfig) or mesh_rules= (a MeshContext built with the pop axis reserved)"
                )
            if self.param_axes is None:
                raise ValueError(
                    "a 2-D fleet mesh with a model axis needs param_axes= (the logical-axes pytree "
                    "mirroring the params structure, e.g. models.model.param_specs(cfg) or "
                    "models.classifier.classifier_param_axes(cfg))"
                )
        else:
            self.mesh_rules = mesh_rules
        # chunks must tile the pop axis: round the configured width up
        self.population_size = max(
            self.num_shards, round_up_to_multiple(self.population_size, self.num_shards)
        )
        pop_first = np.moveaxis(self.mesh.devices, self.mesh.axis_names.index(axis_name), 0)
        self._slice_devices = [tuple(row) for row in pop_first.reshape(self.num_shards, -1)]
        self._devices: Optional[tuple] = None  # a pop slice's, on its views (_slice)
        self._layouts: dict = {}
        self.last_fit_stats: Optional[dict] = None

    # -- chunking: every chunk width is a multiple of the pop extent -------

    def _chunks(self, n: int):
        size = max(1, min(self.population_size, n))
        size = round_up_to_multiple(size, self.num_shards)
        for lo in range(0, n, size):
            yield lo, min(size, n - lo), size

    # -- pop slices ----------------------------------------------------------

    def _slice(self, d: int) -> "ShardedPopulationEngine":
        """This engine as pop slice d sees it: the layout hooks below act on
        its devices (model positions in mesh order, the first computes)."""
        view = copy.copy(self)
        view._devices = self._slice_devices[d]
        return view

    def _on_device(self):
        dev = self._devices[0]
        return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()

    def _lockstep(self, start):
        """``start(view, d)`` makes pop slice d's run body; every live one is
        advanced a step in turn until all have returned. A run body's host
        read comes first in its step and reads only its own previous step."""
        views = [self._slice(d) for d in range(self.num_shards)]
        runs = {}
        for d, view in enumerate(views):
            with view._on_device():
                runs[d] = start(view, d)
        out: list = [None] * self.num_shards
        while runs:
            for d in list(runs):
                with views[d]._on_device():
                    try:
                        next(runs[d])
                    except StopIteration as stop:
                        out[d] = stop.value
                        del runs[d]
        return views, out

    def _fit_chunk(self, params0, ok_pop, mode, budgets, batch_fn, keep):
        if ok_pop is None:  # all-healthy: nothing to split
            return super()._fit_chunk(params0, ok_pop, mode, budgets, batch_fn, keep)
        k = len(budgets) // self.num_shards
        views, stored = self._lockstep(lambda view, d: view._fit_run(
            view._constrain_batch(params0), ok_pop[d * k:(d + 1) * k], mode, budgets[d * k:(d + 1) * k],
            batch_fn))
        self._record_fit_output(stored, keep, len(budgets))
        home = _device_of(params0)
        # full-shape params out, as the reference's out_specs hand them back
        full = [view._gather(s) for view, s in zip(views, stored)]
        return _tree_map(lambda *xs: torch.cat([x.to(home) for x in xs]), *full)

    def _steps_chunk(self, params0, ok_pop, mode, constraint, max_steps, batch_fn):
        k = ok_pop.shape[0] // self.num_shards
        _, crossed = self._lockstep(lambda view, d: view._steps_run(
            view._constrain_batch(params0), ok_pop[d * k:(d + 1) * k], mode, constraint, max_steps,
            batch_fn))
        return np.concatenate(crossed)

    def _eval_chunk(self, params_pop, ok_pop, mode):
        if ok_pop is None:
            return super()._eval_chunk(params_pop, ok_pop, mode)
        k = ok_pop.shape[0] // self.num_shards
        vals = []
        for d in range(self.num_shards):  # issued for every slice before any host read
            view = self._slice(d)
            with view._on_device():
                members = _tree_map(lambda x: x[d * k:(d + 1) * k], params_pop)
                vals.append(view._eval_pop(members, ok_pop[d * k:(d + 1) * k], mode))
        return torch.cat([v.to(ok_pop.device) for v in vals])

    # -- member-state layout over the model positions ------------------------

    @property
    def _model_sharded(self) -> bool:
        return self.model_size > 1 and self._devices is not None

    def _layout(self, axes, shape) -> list[tuple]:
        """Each model position's block of a member-stacked leaf of ``shape``:
        the index into the full leaf, from the spec the rules resolve for
        one member's shape."""
        key = (axes, shape)
        if key not in self._layouts:
            spec = resolve_spec(tuple(axes), shape[1:], self.mesh_rules)
            sizes = [self.mesh.shape[a] for a in self.model_axes]
            index = []
            for j in range(self.model_size):
                coord = dict(zip(self.model_axes, np.unravel_index(j, sizes)))
                idx = [slice(None)]
                for dim, entry in zip(shape[1:], spec):
                    if entry is None:
                        idx.append(slice(None))
                        continue
                    names = (entry,) if isinstance(entry, str) else entry
                    if any(a not in coord for a in names):
                        raise ValueError(f"spec {spec} names an axis outside the model sub-mesh "
                                         f"{self.model_axes}: build mesh_rules with the pop axis reserved")
                    count = math.prod(self.mesh.shape[a] for a in names)
                    block = 0
                    for a in names:
                        block = block * self.mesh.shape[a] + int(coord[a])
                    step = dim // count
                    idx.append(slice(block * step, (block + 1) * step))
                index.append(tuple(idx))
            self._layouts[key] = index
        return self._layouts[key]

    def _store(self, axes_tree, tree):
        if not is_axes_leaf(axes_tree):
            return {k: self._store(axes_tree[k], tree[k]) for k in tree}
        leaf = tree
        index = self._layout(axes_tree, tuple(leaf.shape))
        pieces = [
            # a replicated leaf is the same tensor at each position of one
            # device; a split one is a copy of its block
            leaf.to(dev) if all(s == slice(None) for s in idx) else leaf[idx].to(dev, copy=True)
            for dev, idx in zip(self._devices, index)
        ]
        return _Split(pieces, index, tuple(leaf.shape), leaf.dtype)

    def _split(self, axes_tree, tree):
        """compute="sharded"'s layout: each leaf the rules split becomes a
        ``SplitTensor`` of its distinct blocks, each a copy on the device of
        the first position that holds it (position 0 holds piece 0); a leaf
        left whole stays a tensor on the slice's first device; a leaf
        already split is kept as it is."""
        if not is_axes_leaf(axes_tree):
            return {k: self._split(axes_tree[k], tree[k]) for k in tree}
        leaf = tree
        if isinstance(leaf, SplitTensor):
            return leaf
        index = self._layout(axes_tree, tuple(leaf.shape))
        dims = {d for idx in index for d, s in enumerate(idx) if s != slice(None)}
        if not dims:
            return leaf.to(self._devices[0])
        if len(dims) > 1:
            raise ValueError(f"compute='sharded' splits a leaf along one dim; the rules split {axes_tree} "
                             f"along dims {sorted(dims)}")
        (dim,) = dims
        pieces, offsets = [], []
        for dev, idx in zip(self._devices, index):
            if idx[dim].start not in offsets:  # a block repeated over another model axis is held once
                offsets.append(idx[dim].start)
                pieces.append(leaf[idx].to(dev, copy=True))
        return SplitTensor(pieces, dim - leaf.dim(), offsets)

    def _gather(self, tree):
        if isinstance(tree, dict):
            return {k: self._gather(v) for k, v in tree.items()}
        dev = self._devices[0]
        if isinstance(tree, SplitTensor):
            return tree.full(dev)
        if not isinstance(tree, _Split):
            return tree.to(dev)
        if all(s == slice(None) for s in tree.index[0]):
            return tree.pieces[0].to(dev)
        full = torch.empty(tree.shape, dtype=tree.dtype, device=dev)
        seen = set()
        for piece, idx in zip(tree.pieces, tree.index):
            key = tuple((s.start, s.stop) for s in idx)
            if key not in seen:  # a block replicated over an unused axis is written once
                seen.add(key)
                full[idx].copy_(piece)
        return full

    # hooks called by the parent's run bodies

    @property
    def _tensor_parallel(self) -> bool:
        return self.compute == "sharded" and self._model_sharded

    def _constrain_member_state(self, params_pop, opt_pop):
        if not self._model_sharded:
            return params_pop, opt_pop
        store = self._split if self.compute == "sharded" else self._store
        return (store(self.param_axes, params_pop),
                store(opt_state_specs(self.param_axes), opt_pop))

    def _gather_member_state(self, params_pop, opt_pop):
        if self._devices is None or self._tensor_parallel:
            return params_pop, opt_pop
        return self._gather(params_pop), self._gather(opt_pop)

    def _gather_member_params(self, params_pop):
        if self._devices is None:
            return params_pop
        if self._tensor_parallel:
            return self._split(self.param_axes, params_pop)
        return self._gather(params_pop)

    def _constrain_batch(self, tree):
        if self._devices is None or tree is None:
            return tree
        if isinstance(tree, dict):
            return {k: self._constrain_batch(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [self._constrain_batch(v) for v in tree]
        return tree.to(self._devices[0])

    def _constrain_masks(self, ok_pop, params_pop):
        """compute="sharded": the chunk's maps rolled once to every origin
        that a split leaf's piece has on a GEMM view (``_gemm_origins``), so
        each piece's GEMM reads a prebuilt map. A map rolled afresh in each
        call would be packed again for the kernel at every GEMM
        (``packed_mask`` keys on the tensor)."""
        if isinstance(ok_pop, dict) or not self._tensor_parallel:
            return self._constrain_batch(ok_pop)
        ok_pop = self._constrain_batch(ok_pop)
        rows, cols = ok_pop.shape[-2:]
        keys = {(0, 0)}
        for leaf in pytree.tree_leaves(params_pop, is_leaf=lambda x: isinstance(x, SplitTensor)):
            if isinstance(leaf, SplitTensor):
                keys.update((r0 % rows, c0 % cols) for r0, c0 in _gemm_origins(leaf))
        return {key: rolled_map(ok_pop, *key) for key in sorted(keys)}

    # -- resident-memory accounting ------------------------------------------

    def _record_fit_output(self, trained, keep: int, width: int) -> None:
        """Resident bytes of the raw member-stacked fit output at mesh
        position 0 (pop slice 0, model position 0): the proof that member
        params are stored split within each pop slice instead of replicated.
        Counted by position, not by device, since a device may repeat. The
        all-healthy path's output (one dict, not split) is not recorded."""
        if not isinstance(trained, list):
            return

        def leaves(tree):
            return [x for v in tree.values() for x in leaves(v)] if isinstance(tree, dict) else [tree]

        def nbytes(leaf, position=None):
            if isinstance(leaf, SplitTensor):  # position 0 holds piece 0
                pieces = leaf.pieces if position is None else leaf.pieces[:1]
                return sum(p.numel() for p in pieces) * leaf.dtype.itemsize
            if isinstance(leaf, _Split):
                if position is None:
                    return math.prod(leaf.shape) * leaf.dtype.itemsize
                return leaf.pieces[position].numel() * leaf.dtype.itemsize
            return leaf.numel() * leaf.element_size()

        dev0_bytes = sum(nbytes(x, 0) for x in leaves(trained[0]))
        total_bytes = sum(nbytes(x) for s in trained for x in leaves(s))
        members_per_lane = max(1, width // self.num_shards)
        self.last_fit_stats = dict(
            chunk_width=width,
            members_kept=keep,
            members_per_lane=members_per_lane,
            pop_extent=self.num_shards,
            model_extent=self.model_size,
            device0_resident_bytes=int(dev0_bytes),
            per_member_resident_bytes=dev0_bytes / members_per_lane,
            per_member_total_bytes=total_bytes / width,
        )
