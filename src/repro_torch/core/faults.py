"""Fault maps for systolic-array DNN accelerators (paper SII-B, SIV-A).

A fault map is a boolean grid over the PE array: ``faulty[r, c] == True``
means PE (r, c) has a permanent fault and is bypassed (FAP semantics of
Zhang et al. [8]): any weight mapped onto it contributes zero.

Host-side numpy, a copy of the reference's ``core/faults.py``: the same
seed draws the same map on both sides, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

__all__ = ["FaultMap", "random_fault_map", "clustered_fault_map", "merge_fault_maps"]


@dataclass(frozen=True)
class FaultMap:
    """Permanent-fault map of one chip's computational array."""

    faulty: np.ndarray  # bool (rows, cols)
    chip_id: str = ""

    def __post_init__(self):
        object.__setattr__(self, "faulty", np.asarray(self.faulty, dtype=bool))
        if self.faulty.ndim != 2:
            raise ValueError(f"fault map must be 2-D, got {self.faulty.shape}")

    # Eq. 2: Pr = #faulty / total
    @property
    def fault_rate(self) -> float:
        return float(self.faulty.mean())

    @property
    def num_faults(self) -> int:
        return int(self.faulty.sum())

    @property
    def shape(self) -> tuple[int, int]:
        return self.faulty.shape  # type: ignore[return-value]

    @property
    def ok_mask(self) -> np.ndarray:
        """float32 multiplicative mask: 1 healthy, 0 faulty."""
        return (~self.faulty).astype(np.float32)

    def merge(self, other: "FaultMap") -> "FaultMap":
        """Fuse two fault maps: a PE is faulty if faulty in either (union)."""
        if self.shape != other.shape:
            raise ValueError(f"shape mismatch {self.shape} vs {other.shape}")
        return FaultMap(
            self.faulty | other.faulty,
            chip_id=f"{self.chip_id}+{other.chip_id}" if self.chip_id else other.chip_id,
        )


def random_fault_map(
    rng: np.random.Generator | int,
    rows: int = 256,
    cols: int = 256,
    fault_rate: float = 0.05,
    chip_id: str = "",
    exact: bool = True,
) -> FaultMap:
    """Paper's model: i.i.d. random permanent faults ([8], [12]).

    ``exact=True`` places exactly round(rate * R * C) faults (paper's fault
    rate is a count ratio, Eq. 2); ``False`` samples i.i.d. Bernoulli.
    """
    rng = np.random.default_rng(rng) if isinstance(rng, (int, np.integer)) else rng
    n = rows * cols
    if exact:
        k = int(round(fault_rate * n))
        flat = np.zeros(n, dtype=bool)
        if k > 0:
            flat[rng.choice(n, size=k, replace=False)] = True
        return FaultMap(flat.reshape(rows, cols), chip_id=chip_id)
    return FaultMap(rng.random((rows, cols)) < fault_rate, chip_id=chip_id)


def clustered_fault_map(
    rng: np.random.Generator | int,
    rows: int = 256,
    cols: int = 256,
    fault_rate: float = 0.05,
    cluster_sigma: float = 8.0,
    chip_id: str = "",
) -> FaultMap:
    """Spatially clustered defects around a few Gaussian defect centers."""
    rng = np.random.default_rng(rng) if isinstance(rng, (int, np.integer)) else rng
    n_target = int(round(fault_rate * rows * cols))
    faulty = np.zeros((rows, cols), dtype=bool)
    n_clusters = max(1, n_target // max(1, int(4 * cluster_sigma**2 * 0.3)))
    centers = rng.uniform([0, 0], [rows, cols], size=(n_clusters, 2))
    placed = 0
    guard = 0
    while placed < n_target and guard < 100 * n_target + 100:
        guard += 1
        c = centers[rng.integers(n_clusters)]
        r = int(round(rng.normal(c[0], cluster_sigma))) % rows
        q = int(round(rng.normal(c[1], cluster_sigma))) % cols
        if not faulty[r, q]:
            faulty[r, q] = True
            placed += 1
    return FaultMap(faulty, chip_id=chip_id)


def merge_fault_maps(maps: Sequence[FaultMap]) -> FaultMap:
    if not maps:
        raise ValueError("no fault maps to merge")
    out = maps[0]
    for m in maps[1:]:
        out = out.merge(m)
    return out
