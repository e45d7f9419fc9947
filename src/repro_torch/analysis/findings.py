"""Finding/report model for the port's program linter, the port's copy of
the reference's ``analysis/findings.py``.

A :class:`Finding` is one violation with a *stable identity*, the
``(code, entry_point, subject)`` triple, so a committed baseline can tell
pre-existing violations (tolerated) from new ones (a failed check). Codes
are grouped by pass:

====== =====================================================================
code   meaning
====== =====================================================================
DON001 a loop-carried buffer did not keep its storage through a dispatch:
       the entry point returned a new tensor where it could have written
       the old one in place
RCP001 trace-signature set unbounded in a request dimension (a new program
       per distinct value: unbounded warm-up volume under real traffic)
RCP002 distinct trace signatures on the given traffic trace exceed budget
SHD001 array above the size threshold fell back to full replication
       although a layout rule for its logical axis exists
SHD002 resolved layout assigns a mesh axis owned by an outer engine (the
       fleet layer's reserved "pop" axis)
KRN001 a launch the wrapper refuses: a tile that is not built, lanes the
       scan's plan refuses, a K split beyond the masked GEMM's cap
KRN002 the dynamic shared memory the CUDA kernel requests exceeds the
       card's per-block limit
KRN003 a degenerate launch: an empty axis or a non-positive tile
====== =====================================================================

The report is plain JSON (``Report.as_dict``); the committed baseline is
the sorted list of finding keys plus metadata (``Report.baseline_dict``).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

__all__ = ["Finding", "Report", "load_baseline", "SEVERITIES"]

SEVERITIES = ("info", "warn", "error")


@dataclass(frozen=True)
class Finding:
    """One violation. ``subject`` must be stable across runs (an arg label,
    a param leaf path, a kernel axis name): it is the baseline identity."""

    code: str
    entry_point: str
    subject: str
    message: str
    severity: str = "error"
    bytes: float = 0.0

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in {SEVERITIES}")

    @property
    def key(self) -> str:
        return f"{self.code}:{self.entry_point}:{self.subject}"

    def as_dict(self) -> dict:
        return dict(
            code=self.code,
            entry_point=self.entry_point,
            subject=self.subject,
            message=self.message,
            severity=self.severity,
            bytes=float(self.bytes),
        )

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(
            code=d["code"],
            entry_point=d["entry_point"],
            subject=d["subject"],
            message=d.get("message", ""),
            severity=d.get("severity", "error"),
            bytes=float(d.get("bytes", 0.0)),
        )


def _severity_rank(f: Finding) -> tuple:
    return (-SEVERITIES.index(f.severity), -f.bytes, f.key)


@dataclass
class Report:
    """All findings of one analyzer run plus per-pass summary stats."""

    findings: list = field(default_factory=list)
    passes: dict = field(default_factory=dict)  # pass name -> stats dict
    meta: dict = field(default_factory=dict)

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    def sorted_findings(self) -> list:
        return sorted(self.findings, key=_severity_rank)

    def keys(self) -> set:
        return {f.key for f in self.findings}

    def new_vs_baseline(self, baseline_keys) -> list:
        """Findings not covered by the baseline: what ``--check`` fails on."""
        baseline_keys = set(baseline_keys)
        return [f for f in self.sorted_findings() if f.key not in baseline_keys]

    def resolved_vs_baseline(self, baseline_keys) -> list:
        """Baselined keys that no longer fire (candidates for re-baselining)."""
        return sorted(set(baseline_keys) - self.keys())

    def as_dict(self) -> dict:
        return dict(
            meta=self.meta,
            passes=self.passes,
            findings=[f.as_dict() for f in self.sorted_findings()],
        )

    def baseline_dict(self) -> dict:
        """The committable baseline: stable keys only (messages and byte
        counts drift with configs; identities don't)."""
        return dict(
            meta={k: self.meta[k] for k in ("arch",) if k in self.meta},
            keys=sorted(self.keys()),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=1)
            f.write("\n")


def load_baseline(path: str) -> set:
    """Baseline keys from a committed baseline file (or a full report)."""
    with open(path) as f:
        d = json.load(f)
    if "keys" in d:
        return set(d["keys"])
    return {Finding.from_dict(fd).key for fd in d.get("findings", ())}
