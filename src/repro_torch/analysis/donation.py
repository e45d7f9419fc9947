"""Donation lint (DON001): a carried leaf that did not keep its storage.

A serve or train dispatch that carries big state (KV page pools, params,
optimizer moments) back out should write it in place. The reference asks
XLA to alias the buffer (``donate_argnums``) and reads the compiled
module's ``input_output_alias`` table. Eager PyTorch has no alias table:
whether a dispatch writes in place or returns a new tensor is a fact of the
code that runs. So this pass runs the entry point once on live tensors and
compares each carried leaf's storage (``untyped_storage().data_ptr()``)
before and after the dispatch:

* for a functional entry, the input leaf against the output leaf at the
  same place (``ProgramSpec.returns`` names where a carried argument's new
  value sits in the output);
* for an engine method, the state object's leaves before the call against
  the same object's leaves after it (an argument ``returns`` does not name).

The same storage counts as donated. A carried leaf that came back in new
storage (rebound), above ``min_bytes``, is a DON001 finding weighted by its
bytes: each dispatch allocates and fills a new buffer where it could write
the old one, and a CUDA graph of the dispatch cannot capture it.

Subjects follow ``analysis/tree.py::subject``: an argument's label and the
leaf's path, the copies of a layer leaf (``params/layers/attn/wq``) grouped
into one subject, kept only when every layer kept its storage.

Stats keep the reference's names (``carried_bytes``, ``donated_bytes``,
``undonated_carried_bytes``, ``donated_fraction``, ``arg_leaves``,
``total_arg_bytes``) and add ``subjects`` (each carried subject, ``kept``
or ``rebound``) and ``reused_intact``. The reference's ``entry_params``,
``aliased_params`` and ``hlo_alias_table`` read the compiled module and
have no counterpart here. ``ProgramSpec.reused`` names arguments the
caller reuses after the call (the population sweep's ``params0``):
``reused_intact`` is whether every tensor of them kept its storage and its
values, ``None`` where the spec names none. A ``torch.Generator`` is
advanced in place by construction and is no tensor leaf.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.tree import flatten, leaf_bytes, subject

__all__ = ["ProgramSpec", "lint_donation", "donation_stats"]


@dataclass
class ProgramSpec:
    """One entry point on live arguments, plus the facts the linter can't
    infer.

    ``carried`` are the *top-level positional* arg indices whose tensors the
    host loop takes from the previous dispatch (and so could be written in
    place); everything else (params reused across calls, scalars, the fault
    context) is not linted. ``returns`` maps a carried index to the index of
    its new value in ``fn``'s output tuple; a carried index it lacks is read
    back from the argument object itself after the call (an engine's state,
    updated in place or rebound attribute by attribute).
    """

    name: str
    fn: Callable
    args: tuple  # live arguments: tensors, trees of tensors, other values
    carried: frozenset  # top-level positional indices that are loop-carried
    arg_names: tuple = ()  # labels for top-level args (defaults to arg<i>)
    returns: dict = field(default_factory=dict)  # carried arg index -> output index
    reused: frozenset = frozenset()  # args the caller reuses: storage and values must hold

    def arg_label(self, i: int) -> str:
        if i < len(self.arg_names):
            return self.arg_names[i]
        return f"arg{i}"


def _tensors(tree) -> list:
    return [(p, x) for p, x in flatten(tree) if isinstance(x, torch.Tensor)]


def _ptr(x: torch.Tensor) -> int:
    return x.untyped_storage().data_ptr()


def lint_donation(spec: ProgramSpec, *, min_bytes: int = 1 << 16) -> tuple[list, dict]:
    """Run one entry point once; returns (findings, stats)."""
    leaves = [(i, p, x) for i, a in enumerate(spec.args) for p, x in _tensors(a)]
    # the tensors themselves are held across the call, so no storage they
    # own can be freed and handed to a new tensor at the same address
    before = {(i, p): (x, _ptr(x)) for i, p, x in leaves if i in spec.carried}
    snapshots = [(x, _ptr(x), x.detach().clone()) for i, _, x in leaves if i in spec.reused]
    out = spec.fn(*spec.args)
    after: dict = {}
    for i in spec.carried:
        new = out[spec.returns[i]] if i in spec.returns else spec.args[i]
        after.update({(i, p): _ptr(x) for p, x in _tensors(new)})

    groups: dict = {}  # subject -> [kept bytes, rebound bytes, a rebound leaf, rebound leaves]
    total_bytes = sum(leaf_bytes(x) for _, _, x in leaves)
    for (i, p), (x, ptr) in before.items():
        label = spec.arg_label(i)
        sub = subject(p)
        name = f"{label}/{sub}" if p else label
        g = groups.setdefault(name, [0, 0, None, 0])
        if after.get((i, p)) == ptr:
            g[0] += leaf_bytes(x)
        else:
            g[1] += leaf_bytes(x)
            g[2] = g[2] if g[2] is not None else x
            g[3] += 1

    findings: list = []
    carried_bytes = donated_bytes = 0
    subjects: dict = {}
    for name, (kept, rebound, x, n) in groups.items():
        carried_bytes += kept + rebound
        donated_bytes += kept
        subjects[name] = "rebound" if rebound else "kept"
        if not rebound or rebound < min_bytes:
            continue
        findings.append(
            Finding(
                code="DON001",
                entry_point=spec.name,
                subject=name,
                message=(
                    f"loop-carried buffer {name} ({rebound/2**20:.2f} MiB in {n} "
                    f"{str(x.dtype).replace('torch.', '')}{list(x.shape)} leaves) came back "
                    "in new storage: every dispatch allocates and fills a new buffer; "
                    "write it in place"
                ),
                severity="error",
                bytes=rebound,
            )
        )
    intact = None
    if spec.reused:
        intact = all(_ptr(x) == ptr and torch.equal(x, old) for x, ptr, old in snapshots)
    stats = dict(
        arg_leaves=len(leaves),
        total_arg_bytes=total_bytes,
        carried_bytes=carried_bytes,
        donated_bytes=donated_bytes,
        undonated_carried_bytes=carried_bytes - donated_bytes,
        donated_fraction=(donated_bytes / carried_bytes) if carried_bytes else 1.0,
        subjects=subjects,
        reused_intact=intact,
    )
    return findings, stats


def donation_stats(specs, *, min_bytes: int = 1 << 16) -> tuple[list, dict]:
    """Run the donation lint over a registry of specs; aggregates stats."""
    findings: list = []
    per_entry: dict = {}
    carried = donated = 0
    for spec in specs:
        f, s = lint_donation(spec, min_bytes=min_bytes)
        findings.extend(f)
        per_entry[spec.name] = s
        carried += s["carried_bytes"]
        donated += s["donated_bytes"]
    agg = dict(
        entries=per_entry,
        carried_bytes=carried,
        donated_bytes=donated,
        donated_fraction=(donated / carried) if carried else 1.0,
    )
    return findings, agg
