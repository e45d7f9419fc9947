"""Recompile-hazard census (RCP001/RCP002) over analytic program signatures.

The port's copy of the reference's ``analysis/recompile.py``. A serving
engine keys its programs on shapes and static arguments: the continuous
engine's ``("prefill_admit", width)``, ``("prefill_chunk", chunk_size)``
and ``("decode",)`` (``serve/continuous.py::_run``), the static engine's
prefill width. A key that depends on the request (a prefill at the raw
prompt length) is a new program per distinct prompt length: kernels built,
launch plans looked up and, once the programs are CUDA graphs, a capture
each. That volume grows without bound under real traffic.

Running every entry point over a traffic sweep just to count programs is
what a static lint avoids, so each entry point declares its **signature
function**: the tuple of shape and static values its boundary keys on, as
a pure function of a :class:`TraceRequest`. Those functions are small and
auditable (``analysis/programs.py`` mirrors the engines' own keys), and the
tests pin them against the program keys a real engine records
(``ContinuousBatchingEngine.used_programs``).

Two findings:

* RCP001: an *unbounded* hazard: sweeping one request dimension produces a
  distinct signature per value (injective growth), i.e. real traffic keeps
  adding programs forever.
* RCP002: the given synthetic trace alone already induces more distinct
  signatures than ``max_signatures``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Sequence

from repro_torch.analysis.findings import Finding

__all__ = [
    "TraceRequest",
    "EntryTraceModel",
    "synthetic_trace",
    "census",
    "lint_recompile",
]

# Request dimensions a signature may legally depend on in *bounded* ways
# (e.g. through a page-rounded, capacity-clamped cache length).
SWEEP_DIMS = ("prompt_len", "max_new_tokens", "batch")


@dataclass(frozen=True)
class TraceRequest:
    """One request of the synthetic traffic trace."""

    prompt_len: int
    max_new_tokens: int = 32
    batch: int = 1


@dataclass(frozen=True)
class EntryTraceModel:
    """An entry point's analytic program signature.

    ``signature_of(req)`` returns the hashable tuple the engine keys its
    program on for that request: argument shapes that vary with the request
    plus any static arguments. Dimensions the entry point never sees can be
    excluded from the sweep via ``dims``.
    """

    name: str
    signature_of: Callable[[TraceRequest], tuple]
    dims: tuple = SWEEP_DIMS


def synthetic_trace(
    *,
    prompt_lens: Sequence[int] = (7, 12, 17, 33, 52, 64, 99, 128, 200, 311),
    max_new: Sequence[int] = (8, 16, 32, 64),
    batch: int = 1,
) -> list:
    """A deterministic mixed-length traffic trace (no RNG: resumable)."""
    out = []
    for i, p in enumerate(prompt_lens):
        out.append(
            TraceRequest(
                prompt_len=int(p),
                max_new_tokens=int(max_new[i % len(max_new)]),
                batch=batch,
            )
        )
    return out


def census(model: EntryTraceModel, trace: Sequence[TraceRequest]) -> dict:
    """Distinct signatures the trace induces on one entry point."""
    sigs = {model.signature_of(r) for r in trace}
    return dict(requests=len(trace), signatures=len(sigs))


def _sweep_values(lo: int = 1, n: int = 12) -> list:
    # strictly increasing, mixed parity/alignment so page rounding and
    # bucketing genuinely collapse values when the signature is bounded
    vals = []
    v = lo
    for i in range(n):
        vals.append(v)
        v += 3 + (i % 5)
    return vals


def lint_recompile(
    models: Sequence[EntryTraceModel],
    trace: Sequence[TraceRequest],
    *,
    max_signatures: int = 8,
    base: TraceRequest = TraceRequest(prompt_len=16, max_new_tokens=32, batch=1),
) -> tuple[list, dict]:
    """Returns (findings, stats). RCP001 per unbounded request dimension;
    RCP002 when the concrete trace exceeds the signature budget."""
    findings: list = []
    stats: dict = {}
    for model in models:
        entry: dict = {}
        for dim in model.dims:
            values = _sweep_values()
            sigs = {
                model.signature_of(replace(base, **{dim: v})) for v in values
            }
            entry[f"sweep_{dim}"] = len(sigs)
            if len(sigs) == len(values):
                findings.append(
                    Finding(
                        code="RCP001",
                        entry_point=model.name,
                        subject=dim,
                        message=(
                            f"trace signature varies injectively with {dim} "
                            f"({len(sigs)} signatures over {len(values)} swept "
                            "values): every distinct value is a new program; bucket "
                            f"{dim} (pad to a fixed set of shapes) at this "
                            "boundary"
                        ),
                        severity="error",
                    )
                )
        c = census(model, trace)
        entry.update(c)
        if c["signatures"] > max_signatures:
            findings.append(
                Finding(
                    code="RCP002",
                    entry_point=model.name,
                    subject="trace",
                    message=(
                        f"synthetic trace of {c['requests']} requests induces "
                        f"{c['signatures']} distinct trace signatures "
                        f"(budget {max_signatures}): program volume scales "
                        "with traffic shape diversity"
                    ),
                    severity="warn",
                )
            )
        stats[model.name] = entry
    return findings, stats
