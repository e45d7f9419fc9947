"""Fault maps for systolic-array DNN accelerators (paper SII-B, SIV-A).

A fault map is a boolean grid over the PE array: ``faulty[r, c] == True``
means PE (r, c) has a permanent fault and is bypassed (FAP semantics of
Zhang et al. [8]): any weight mapped onto it contributes zero.

Host-side numpy, a copy of the reference's ``core/faults.py``: the same
seed draws the same map on both sides, bit for bit.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "FaultMap",
    "random_fault_map",
    "clustered_fault_map",
    "correlated_family",
    "merge_fault_maps",
    "expected_merged_rate",
    "overlap_rate",
    "gaussian_chip_rates",
]


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

    def __or__(self, other: "FaultMap") -> "FaultMap":
        return self.merge(other)

    # --- serialization -------------------------------------------------
    # The reference's .npz keys (``faulty``, ``chip_id``), so a map written
    # by either package loads in the other. np.savez_compressed appends
    # '.npz' to suffix-less paths, so save and load both normalize the
    # suffix: load(p) always reads what save(p) wrote.
    @staticmethod
    def _npz_path(path) -> str:
        path = os.fspath(path)
        return path if path.endswith(".npz") else path + ".npz"

    def save(self, path) -> None:
        np.savez_compressed(self._npz_path(path), faulty=self.faulty, chip_id=self.chip_id)

    @staticmethod
    def load(path) -> "FaultMap":
        z = np.load(FaultMap._npz_path(path), allow_pickle=False)
        return FaultMap(z["faulty"], chip_id=str(z["chip_id"]))


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


def correlated_family(
    rng: np.random.Generator | int,
    n_chips: int,
    rows: int = 256,
    cols: int = 256,
    base_rate: float = 0.05,
    idio_rate: float = 0.02,
    chip_prefix: str = "chip",
) -> list[FaultMap]:
    """Chips from the same wafer region: shared base defects + per-chip
    idiosyncratic faults. Fusion of such maps is profitable (Eq. 3 with
    Pr_A AND Pr_B >> Pr_A * Pr_B)."""
    rng = np.random.default_rng(rng) if isinstance(rng, (int, np.integer)) else rng
    base = random_fault_map(rng, rows, cols, base_rate)
    out = []
    for i in range(n_chips):
        idio = random_fault_map(rng, rows, cols, idio_rate)
        out.append(FaultMap(base.faulty | idio.faulty, chip_id=f"{chip_prefix}{i}"))
    return out


def gaussian_chip_rates(
    rng: np.random.Generator | int,
    n_chips: int,
    mean: float = 0.1,
    sigma: float = 0.02,
    lo: float = 0.0,
    hi: float = 1.0,
) -> np.ndarray:
    """Fault-rate distribution of the paper's SIV-C fleet experiment
    (Gaussian, mean 0.1, sigma 0.02), clipped to [lo, hi]."""
    rng = np.random.default_rng(rng) if isinstance(rng, (int, np.integer)) else rng
    return np.clip(rng.normal(mean, sigma, size=n_chips), lo, hi)


# ---------------------------------------------------------------------------
# Fusion algebra (paper Eq. 3)
# ---------------------------------------------------------------------------


def merge_fault_maps(maps: Sequence[FaultMap]) -> FaultMap:
    if not maps:
        raise ValueError("no fault maps to merge")
    out = maps[0]
    for m in maps[1:]:
        out = out.merge(m)
    return out


def expected_merged_rate(pr_a: float, pr_b: float, pr_ab: Optional[float] = None) -> float:
    """Eq. 3: Pr_comb = Pr_A + Pr_B - Pr_{A AND B}; independent maps give
    Pr_{A AND B} = Pr_A * Pr_B."""
    if pr_ab is None:
        pr_ab = pr_a * pr_b
    return pr_a + pr_b - pr_ab


def overlap_rate(a: FaultMap, b: FaultMap) -> float:
    """Measured Pr_{A AND B}: fraction of PEs faulty in both maps."""
    return float((a.faulty & b.faulty).mean())
