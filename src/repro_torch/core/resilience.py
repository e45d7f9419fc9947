"""Resilience analysis — eFAT Step 1 + Step 2 (paper SIII-B, SIII-C).

Step 1 measures, by fault-injection + FAT runs, the amount of retraining
needed to reach the user accuracy constraint at each fault rate from the
Algo-1 list, repeated over several random fault patterns (min/mean/max kept,
paper Fig. 12 recommends max).

Step 2 answers per-chip queries by interpolating the measured curve
(linear between the two nearest rates — the paper's "bilinear" collapses to
linear in the single-fault-type case; a true bilinear 2-D table is provided
for dual fault-type systems, paper SIII-B last paragraph).

Host-side numpy, the reference's ``core/resilience.py``: the same fault-map
grid from the same seed, and tables whose JSON either package reads.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol, Sequence

import numpy as np

from repro_torch.core.faults import FaultMap, random_fault_map

__all__ = [
    "fault_rate_list",
    "FATTrainer",
    "BatchFATTrainer",
    "ResilienceTable",
    "ResilienceTable2D",
    "measure_resilience",
]


# ---------------------------------------------------------------------------
# Algorithm 1 — fault-rate list
# ---------------------------------------------------------------------------


def fault_rate_list(
    chip_fault_rates: Sequence[float],
    max_fr: float = 0.5,
    max_interval: float = 0.05,
    step: float = 0.5,
) -> list[float]:
    """Paper Algo 1. Geometric ramp from the fleet's min fault rate with
    interval growth ``Current_FR * step`` capped at ``max_interval``, covering
    up to max(max chip rate, max_fr) — the headroom above the max chip rate
    is what lets fused (higher-rate) maps interpolate instead of extrapolate.
    """
    if len(chip_fault_rates) == 0:
        raise ValueError("need at least one chip fault rate")
    frs = [float(f) for f in chip_fault_rates]
    current = min(frs)
    upper = max(max(frs), max_fr)
    out = [current]
    # degenerate start (rate 0) would never advance via current*step
    floor_step = max_interval / 64.0
    while current <= upper:
        current = current + max(min(current * step, max_interval), floor_step)
        out.append(current)
    return out


# ---------------------------------------------------------------------------
# Trainer protocol (implemented in repro_torch.train.fat_trainer)
# ---------------------------------------------------------------------------


class FATTrainer(Protocol):
    """Anything that can run fault-aware training to a constraint."""

    def steps_to_constraint(
        self, fault_map: FaultMap, constraint: float, max_steps: int
    ) -> Optional[int]:
        """FAT with this map until eval metric >= constraint; return steps
        used, or None if not reached within max_steps."""
        ...


class BatchFATTrainer(FATTrainer, Protocol):
    """A trainer that can probe a whole population of fault maps at once
    (repro_torch.train.population). Step 1 submits the full rates x repeats grid
    through this method when available."""

    def steps_to_constraint_batch(
        self, fault_maps: Sequence[FaultMap], constraint: float, max_steps: int
    ) -> list[Optional[int]]: ...


# ---------------------------------------------------------------------------
# Resilience tables
# ---------------------------------------------------------------------------


@dataclass
class ResilienceTable:
    """required-retraining vs fault-rate with min/mean/max statistics.

    ``rates`` strictly increasing; stats arrays aligned. ``cap`` is the
    max_steps used during measurement (entries at cap mean 'constraint not
    reachable' — cost clamps there).
    """

    rates: np.ndarray
    min_steps: np.ndarray
    mean_steps: np.ndarray
    max_steps_stat: np.ndarray
    cap: int
    constraint: float
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        self.rates = np.asarray(self.rates, dtype=np.float64)
        self.min_steps = np.asarray(self.min_steps, dtype=np.float64)
        self.mean_steps = np.asarray(self.mean_steps, dtype=np.float64)
        self.max_steps_stat = np.asarray(self.max_steps_stat, dtype=np.float64)
        if not np.all(np.diff(self.rates) > 0):
            raise ValueError("rates must be strictly increasing")

    def _series(self, stat: str) -> np.ndarray:
        return {
            "min": self.min_steps,
            "mean": self.mean_steps,
            "max": self.max_steps_stat,
        }[stat]

    def required_steps(self, fault_rate: float, stat: str = "max") -> float:
        """Paper Step 2: interpolate between the two nearest measured rates.

        Below the measured range: clamp to the first point (conservative).
        Above: extrapolate with the last segment's slope, clamped to cap —
        Algo 1's Max_FR headroom makes this path rare.
        """
        r, y = self.rates, self._series(stat)
        fr = float(fault_rate)
        if fr <= r[0]:
            return float(y[0])
        if fr >= r[-1]:
            if len(r) >= 2 and r[-1] > r[-2]:
                slope = (y[-1] - y[-2]) / (r[-1] - r[-2])
                return float(min(self.cap, max(0.0, y[-1] + slope * (fr - r[-1]))))
            return float(y[-1])
        return float(np.interp(fr, r, y))

    def reachable(self, fault_rate: float, stat: str = "max") -> bool:
        return self.required_steps(fault_rate, stat) < self.cap

    # --- persistence ----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            dict(
                rates=self.rates.tolist(),
                min_steps=self.min_steps.tolist(),
                mean_steps=self.mean_steps.tolist(),
                max_steps_stat=self.max_steps_stat.tolist(),
                cap=self.cap,
                constraint=self.constraint,
                meta=self.meta,
            )
        )

    @staticmethod
    def from_json(s: str) -> "ResilienceTable":
        d = json.loads(s)
        return ResilienceTable(
            np.array(d["rates"]),
            np.array(d["min_steps"]),
            np.array(d["mean_steps"]),
            np.array(d["max_steps_stat"]),
            cap=d["cap"],
            constraint=d["constraint"],
            meta=d.get("meta", {}),
        )

    @staticmethod
    def from_function(
        rates: Sequence[float], fn: Callable[[float], float], cap: int = 10**9, constraint: float = 0.0
    ) -> "ResilienceTable":
        """Analytic table (used in unit tests / synthetic studies)."""
        rates = np.asarray(sorted(set(float(r) for r in rates)))
        y = np.array([min(cap, fn(r)) for r in rates], dtype=np.float64)
        return ResilienceTable(rates, y, y, y, cap=cap, constraint=constraint)


@dataclass
class ResilienceTable2D:
    """Bilinear table over two fault types (e.g. stuck-at-0 x stuck-at-1 in
    weight memory) — paper SIII-B's multi-dimensional extension."""

    rates_a: np.ndarray
    rates_b: np.ndarray
    steps: np.ndarray  # (len(rates_a), len(rates_b))
    cap: int
    constraint: float

    def __post_init__(self):
        self.rates_a = np.asarray(self.rates_a, dtype=np.float64)
        self.rates_b = np.asarray(self.rates_b, dtype=np.float64)
        self.steps = np.asarray(self.steps, dtype=np.float64)
        assert self.steps.shape == (len(self.rates_a), len(self.rates_b))

    def required_steps(self, ra: float, rb: float) -> float:
        """True bilinear interpolation on the 2-D grid (clamped at edges)."""
        a, b, z = self.rates_a, self.rates_b, self.steps
        ra = float(np.clip(ra, a[0], a[-1]))
        rb = float(np.clip(rb, b[0], b[-1]))
        i = int(np.clip(np.searchsorted(a, ra) - 1, 0, len(a) - 2))
        j = int(np.clip(np.searchsorted(b, rb) - 1, 0, len(b) - 2))
        ta = 0.0 if a[i + 1] == a[i] else (ra - a[i]) / (a[i + 1] - a[i])
        tb = 0.0 if b[j + 1] == b[j] else (rb - b[j]) / (b[j + 1] - b[j])
        top = z[i, j] * (1 - tb) + z[i, j + 1] * tb
        bot = z[i + 1, j] * (1 - tb) + z[i + 1, j + 1] * tb
        return float(top * (1 - ta) + bot * ta)


# ---------------------------------------------------------------------------
# Step-1 measurement
# ---------------------------------------------------------------------------


def measure_resilience(
    trainer: FATTrainer,
    rates: Sequence[float],
    constraint: float,
    *,
    array_shape: tuple[int, int] = (256, 256),
    repeats: int = 5,
    max_steps: int = 2000,
    seed: int = 0,
    fault_gen=random_fault_map,
    progress: Optional[Callable[[str], None]] = None,
    engine: Optional[str] = None,
) -> ResilienceTable:
    """Run FAT experiments at each rate x repeat, recording steps-to-
    constraint (paper: 'each data point ... averaged over multiple
    iterations to cope with the variations in fault patterns').

    The fault-map grid is generated up front (rate-major, identical rng
    stream to the historical serial loop) and, when the trainer implements
    the batch protocol, the WHOLE rates x repeats grid is submitted as one
    ``steps_to_constraint_batch`` call. How that population is packed into
    chunks is the trainer's scheduler's job (repro_torch.fleet.FleetScheduler
    packs by fault rate, so chunk members cross at similar times and the
    early-exit loop wastes little straggler work) — Step 1 and Step 4 share
    that single chunking implementation instead of this function hand-sorting
    by rate. ``engine`` forces the submission path: "population" requires
    the batch protocol, "serial" forces the per-map reference loop, None
    (auto) prefers batch when available. Which math runs under either
    submission is the *trainer's* engine choice; this flag only controls
    batching. Per-member results are identical either way.
    """
    rng = np.random.default_rng(seed)
    grid: list[tuple[float, list[FaultMap]]] = [
        (
            rate,
            [fault_gen(rng, array_shape[0], array_shape[1], rate) for _ in range(repeats)],
        )
        for rate in rates
    ]
    batch_capable = hasattr(trainer, "steps_to_constraint_batch")
    if engine == "population" and not batch_capable:
        raise ValueError("engine='population' needs a trainer with steps_to_constraint_batch")
    use_batch = batch_capable and engine != "serial"
    if use_batch:
        # one submission for the whole grid: progress necessarily reports
        # after the population program returns
        flat_maps = [fm for _rate, fms in grid for fm in fms]
        flat_steps = trainer.steps_to_constraint_batch(flat_maps, constraint, max_steps)
    mins, means, maxs = [], [], []
    kept_rates = []
    for k, (rate, fms) in enumerate(grid):
        if use_batch:
            steps_list = flat_steps[k * repeats : (k + 1) * repeats]
        else:
            # serial reference: one map at a time, progress stays live
            steps_list = [trainer.steps_to_constraint(fm, constraint, max_steps) for fm in fms]
        samples = []
        for rep, steps in enumerate(steps_list):
            samples.append(max_steps if steps is None else steps)
            if progress:
                progress(f"rate={rate:.4f} rep={rep} steps={samples[-1]}")
        kept_rates.append(rate)
        mins.append(min(samples))
        means.append(float(np.mean(samples)))
        maxs.append(max(samples))
    # de-duplicate non-increasing rates defensively
    kept = np.asarray(kept_rates)
    order = np.argsort(kept)
    kept, mins, means, maxs = (
        kept[order],
        np.asarray(mins)[order],
        np.asarray(means)[order],
        np.asarray(maxs)[order],
    )
    uniq, idx = np.unique(kept, return_index=True)
    return ResilienceTable(
        uniq,
        np.asarray(mins)[idx],
        np.asarray(means)[idx],
        np.asarray(maxs)[idx],
        cap=max_steps,
        constraint=constraint,
        meta=dict(repeats=repeats, array_shape=list(array_shape)),
    )
