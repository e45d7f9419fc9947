"""One lint finding: the port's minimal counterpart of the reference's
``analysis/findings.py``.

The kernel-geometry codes the port uses:

====== =====================================================================
code   meaning
====== =====================================================================
KRN001 a launch the wrapper refuses: a tile that is not built, lanes the
       scan's plan refuses, a K split beyond the masked GEMM's cap
KRN002 the dynamic shared memory the CUDA kernel requests exceeds the
       card's per-block limit
KRN003 a degenerate launch: an empty axis or a non-positive tile
====== =====================================================================
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["Finding"]


@dataclass(frozen=True)
class Finding:
    code: str
    entry_point: str
    subject: str
    message: str
    bytes: float = 0.0
