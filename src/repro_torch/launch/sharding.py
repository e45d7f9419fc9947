"""Logical-axis layout rules (t5x-style, with a divisibility fallback).

Params are annotated with *logical* axis names ('batch', 'embed', 'heads',
'mlp', 'vocab', 'expert', ...). A :class:`MeshContext` maps each name to an
ordered list of mesh-axis candidates; resolution walks the dims of a
concrete shape, assigns the first candidate whose mesh size divides the dim
(in units of e.g. head_dim, so heads never split mid-head) and that no
earlier dim took, and falls back to replication otherwise. One rule set
thus lays out llama3-405b (128 heads over 16) and smollm-135m (9 heads:
attention replicated, the MLP and vocab still split) alike.

The rules compose with the fleet's 2-D ``("pop", "model")`` meshes
(:func:`repro_torch.launch.mesh.make_fleet_mesh`): a context may *reserve*
axes an outer engine owns (the fleet engine reserves ``"pop"``), and
resolution skips candidates whose mesh axes are reserved or absent. The
model rules therefore resolve inside a pop slice: params split over
``"model"`` within each slice.

A resolved spec is a plain tuple with one entry per leading dim: ``None``
(replicated), a mesh axis name, or a tuple of names; trailing ``None``\\ s
are trimmed, as a ``PartitionSpec`` prints. The port keeps what the
reference's rules decide, and the dry run reads each device's bytes off
them (``launch/dryrun_lib.py::sharded_bytes``). The reference also hands
the specs to XLA as shardings of its production mesh (``named_sharding``,
``shard_activation``, ``tree_shardings``), which steer XLA's layout and
have no counterpart on one card (``ROADMAP.md``).
"""
from __future__ import annotations

import contextvars
import math
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

__all__ = [
    "MeshContext",
    "current_mesh_context",
    "is_axes_leaf",
    "make_rules",
    "make_rules_for_mesh",
    "mesh_context",
    "resolve_spec",
    "tree_specs",
]

AxisCandidate = Union[str, tuple[str, ...]]
LogicalAxes = tuple[Optional[str], ...]
Spec = tuple  # entries: None, a mesh axis name, or a tuple of names


@dataclass
class MeshContext:
    mesh: object  # repro_torch.launch.mesh.Mesh, or anything with a ``shape`` mapping
    rules: dict[str, tuple[AxisCandidate, ...]]
    units: dict[str, int] = field(default_factory=dict)
    # mesh axes owned by an outer engine (the fleet's "pop" axis): never
    # assigned to a logical dim, even where a rule names them
    reserved_axes: tuple[str, ...] = ()

    def axis_size(self, cand: AxisCandidate) -> int:
        names = (cand,) if isinstance(cand, str) else cand
        return int(math.prod(self.mesh.shape[a] for a in names))


_CTX: contextvars.ContextVar[Optional[MeshContext]] = contextvars.ContextVar(
    "repro_torch_mesh_ctx", default=None
)


def current_mesh_context() -> Optional[MeshContext]:
    return _CTX.get()


@contextmanager
def mesh_context(ctx: Optional[MeshContext]):
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def is_axes_leaf(a) -> bool:
    """A logical-axes tuple (the leaves of a spec tree)."""
    return isinstance(a, tuple) and all(x is None or isinstance(x, str) for x in a)


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------


def resolve_spec(axes: LogicalAxes, shape: Sequence[int], ctx: MeshContext) -> Spec:
    """Logical axes -> spec tuple for a concrete shape under ctx's rules.

    Candidates whose mesh axes are reserved (``ctx.reserved_axes``) or not
    present in ``ctx.mesh`` are skipped, so one rule set resolves on a
    ``("data", "model")`` mesh and inside a fleet mesh's pop slice (no
    ``"data"`` axis, ``"pop"`` reserved) alike.
    """
    used: set[str] = set(ctx.reserved_axes)
    parts: list = []
    for name, dim in zip(axes, shape):
        entry = None
        if name is not None:
            unit = ctx.units.get(name, 1)
            for cand in ctx.rules.get(name, ()):
                names = (cand,) if isinstance(cand, str) else tuple(cand)
                if any(a in used for a in names):
                    continue
                if any(a not in ctx.mesh.shape for a in names):
                    continue
                size = ctx.axis_size(cand)
                if dim % unit == 0 and (dim // unit) % size == 0 and size > 1:
                    # a singleton axis tuple collapses to its bare name
                    entry = names[0] if len(names) == 1 else tuple(names)
                    used.update(names)
                    break
        parts.append(entry)
    while parts and parts[-1] is None:  # trim trailing Nones, as PartitionSpec does
        parts.pop()
    return tuple(parts)


def tree_specs(spec_tree, value_tree, ctx: Optional[MeshContext] = None):
    """A tree of logical-axes tuples and a tree of tensors of the same
    structure (nested dicts) -> the tree of resolved specs."""
    ctx = ctx or current_mesh_context()
    if ctx is None:
        raise ValueError("tree_specs needs a MeshContext (pass ctx= or enter mesh_context)")
    if is_axes_leaf(spec_tree):
        return resolve_spec(spec_tree, tuple(value_tree.shape), ctx)
    return {k: tree_specs(spec_tree[k], value_tree[k], ctx) for k in value_tree}


# ---------------------------------------------------------------------------
# Rule sets
# ---------------------------------------------------------------------------


def make_rules(cfg, *, multi_pod: bool = False, fsdp: Optional[bool] = None) -> MeshContext:
    """The arch's MeshContext on the production mesh
    (:func:`repro_torch.launch.mesh.make_production_mesh`).

    fsdp=None turns ZeRO-3-style param splitting over the data (+pod) axes
    on for models over 3B params."""
    from repro_torch.launch.mesh import make_production_mesh

    return make_rules_for_mesh(cfg, make_production_mesh(multi_pod=multi_pod), fsdp=fsdp)


def make_rules_for_mesh(
    cfg, mesh, *, fsdp: Optional[bool] = None, seq_shard: bool = False,
    seq_rule: bool = False, moe_slot_shard: bool = False,
    reserved_axes: tuple[str, ...] = (),
) -> MeshContext:
    """The arch's MeshContext on a mesh, with the reference's rule table.

    ``fsdp=None`` turns ZeRO-3-style param splitting over the data (+pod)
    axes on for models over 3B params. ``reserved_axes`` marks mesh axes an
    outer engine owns: the fleet passes ``("pop",)`` with its 2-D mesh, so
    the model rules resolve per pop slice. Rules naming axes absent from
    ``mesh`` ("data" on a fleet mesh) are skipped at resolution time.
    """
    if fsdp is None:
        fsdp = cfg.param_count() > 3e9
    has_pod = "pod" in mesh.shape
    batch_axes: tuple[AxisCandidate, ...] = ((("pod", "data"),) if has_pod else (("data",),))
    # FSDP splits params over the batch axes (pod+data), composing with TP
    fsdp_axes: tuple[AxisCandidate, ...] = batch_axes if fsdp else ()

    hd = max(1, cfg.resolved_head_dim)
    rules: dict[str, tuple[AxisCandidate, ...]] = {
        # activations
        "batch": batch_axes + (("data",),) if has_pod else batch_axes,
        # seq_rule: attention activations split their seq axis on 'model'
        # where the heads axis cannot (indivisible head counts)
        "seq": ("model",) if seq_rule else (),
        # Megatron-SP: the between-layer carry splits on seq for huge models
        "seq_carry": ("model",) if seq_shard else (),
        "heads": ("model",),  # activation head-count axis
        "kv_heads": ("model",),
        "kv_seq": ("model",),  # decode KV cache: heads first, seq fallback
        # params
        "embed": fsdp_axes,
        "qkv": ("model",),  # flattened heads*head_dim weight axis
        "kv": ("model",),
        # moe_slot_shard: split expert-slot rows over 'model' and gather the
        # expert weights instead
        "moe_slots": ("model",) if moe_slot_shard else (),
        "mlp": () if moe_slot_shard else ("model",),
        "vocab": ("model",),
        "expert": ("model",),
        "inner": ("model",),  # SSM d_inner
        "dt_rank": (),
        "state": (),
        "conv": (),
        "frame": (),
        "layers": (),
    }
    units = {"qkv": hd, "kv": hd}
    return MeshContext(mesh=mesh, rules=rules, units=units, reserved_axes=tuple(reserved_axes))
