"""Sharding lint (SHD001/SHD002): re-resolve the layout rules statically.

``repro_torch.launch.sharding.resolve_spec`` falls back to replication
whenever no rule candidate divides a dim: deliberately (small models
replicate their attention), but silently. A refactor that renames a
logical axis, or a mesh that stops dividing a dim, degrades to full
replication with no signal. This pass re-runs the *same* resolution the
launch layer uses, over the same logical-axes trees
(``models/model.py::param_specs``), on a duck-typed mesh (no devices
needed), and flags:

* SHD001: a subject above ``min_bytes`` resolved to **full replication**
  even though some rule candidate for one of its logical axes exists on the
  mesh (sharding was available and was lost to divisibility or an axis
  conflict, not by design-with-no-rule);
* SHD002: a resolved spec assigns a mesh axis the entry declared as
  **engine-owned** (the fleet layer's ``"pop"`` axis): member state inside a
  pop slice must never be split over the axis the engine itself maps.

The port's parameters are unrolled (``layers.3.attn.wq``) where the
reference stacks them (``layers/attn/wq``, with a leading ``"layers"`` axis
no rule splits). The pass groups the L copies of a layer leaf into the one
subject the reference names (``analysis/tree.py::subject``), sums their
bytes, applies ``min_bytes`` to the sum, and raises if two layers of a
group resolve differently; so the findings' keys are the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.tree import flatten, is_struct, leaf_bytes, subject
from repro_torch.launch.sharding import MeshContext, is_axes_leaf, resolve_spec

__all__ = ["FakeMesh", "ShardingEntry", "lint_sharding"]


@dataclass(frozen=True)
class FakeMesh:
    """Duck-typed stand-in for ``repro_torch.launch.mesh.Mesh``: resolution
    only reads ``mesh.shape`` (an axis-name -> size mapping)."""

    axes: tuple  # ((name, size), ...)

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    @classmethod
    def of(cls, **sizes: int) -> "FakeMesh":
        return cls(axes=tuple(sizes.items()))


@dataclass
class ShardingEntry:
    """One program's layout surface: logical axes + concrete shapes.

    ``axes``/``structs`` are trees of one structure (axes leaves are tuples
    of logical-axis names, structs leaves are tensors, meta ones included).
    ``engine_axes`` are the mesh axes an outer engine owns for this entry:
    any resolved spec touching them is SHD002.
    """

    name: str
    mctx: MeshContext
    axes: Any
    structs: Any
    engine_axes: tuple = ()


def _spec_axes(spec) -> set:
    out: set = set()
    for part in spec:
        if part is None:
            continue
        out.update((part,) if isinstance(part, str) else part)
    return out


def _shardable_rule_exists(axes, mctx: MeshContext) -> Optional[str]:
    """First logical axis with a live (present, unreserved, >1) candidate."""
    for name in axes:
        if name is None:
            continue
        for cand in mctx.rules.get(name, ()):
            names = (cand,) if isinstance(cand, str) else tuple(cand)
            if any(a in mctx.reserved_axes for a in names):
                continue
            if any(a not in mctx.mesh.shape for a in names):
                continue
            if mctx.axis_size(cand) > 1:
                return name
    return None


def _subjects(entry: ShardingEntry) -> dict:
    """subject -> (resolved spec, summed bytes, logical axes), a layer leaf's
    copies grouped."""
    axes = dict(flatten(entry.axes, is_leaf=is_axes_leaf))
    structs = dict(flatten(entry.structs, is_leaf=is_struct))
    if axes.keys() != structs.keys():
        missing = sorted(set(axes) ^ set(structs))[:4]
        raise ValueError(
            f"{entry.name}: axes tree has {len(axes)} leaves but structs tree has "
            f"{len(structs)} (unmatched {missing})"
        )
    groups: dict = {}
    for path, ax in axes.items():
        struct = structs[path]
        spec = resolve_spec(ax, tuple(struct.shape), entry.mctx)
        label = subject(path)
        if label in groups:
            have = groups[label]
            if have[0] != spec:
                raise ValueError(
                    f"{entry.name}: the layers of {label} resolve differently: {have[0]} and {spec}"
                )
            groups[label] = (spec, have[1] + leaf_bytes(struct), ax)
        else:
            groups[label] = (spec, leaf_bytes(struct), ax)
    return groups


def lint_sharding(
    entries: Sequence[ShardingEntry], *, min_bytes: int = 1 << 20
) -> tuple[list, dict]:
    """Returns (findings, stats) over every entry's subjects."""
    findings: list = []
    stats: dict = {}
    for entry in entries:
        groups = _subjects(entry)
        n_sharded = n_replicated = 0
        replicated_bytes = 0
        for label, (spec, nbytes, axes) in groups.items():
            assigned = _spec_axes(spec)
            owned = assigned & set(entry.engine_axes)
            if owned:
                findings.append(
                    Finding(
                        code="SHD002",
                        entry_point=entry.name,
                        subject=label,
                        message=(
                            f"{label} resolved to spec {spec} using engine-owned "
                            f"mesh axes {sorted(owned)}: the outer engine splits "
                            "that axis itself; pass it via reserved_axes so the "
                            "model rules skip it"
                        ),
                        severity="error",
                        bytes=nbytes,
                    )
                )
            if assigned:
                n_sharded += 1
                continue
            n_replicated += 1
            replicated_bytes += nbytes
            if nbytes < min_bytes:
                continue
            lost_axis = _shardable_rule_exists(axes, entry.mctx)
            if lost_axis is None:
                continue  # replication by design: no live rule for any axis
            findings.append(
                Finding(
                    code="SHD001",
                    entry_point=entry.name,
                    subject=label,
                    message=(
                        f"{label} ({nbytes/2**20:.2f} MiB, logical axes "
                        f"{tuple(a for a in axes if a)}) fell back to full "
                        f"replication although axis {lost_axis!r} has a live "
                        "rule on this mesh: a divisibility or axis-conflict "
                        "regression, not replication by design"
                    ),
                    severity="warn",
                    bytes=nbytes,
                )
            )
        stats[entry.name] = dict(
            leaves=len(groups),
            sharded=n_sharded,
            replicated=n_replicated,
            replicated_bytes=replicated_bytes,
        )
    return findings, stats
