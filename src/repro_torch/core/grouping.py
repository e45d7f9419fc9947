"""Resilience-driven grouping & fusion of fault maps — eFAT Step 3
(paper SIII-D, Algorithm 2) plus the baselines it is compared against:
fixed per-chip policy ([8]) and random pairwise merging (TRE-map [16]).

Host-side numpy, the reference's ``core/grouping.py``: the same
``default_rng(seed)`` draws, so both packages make the same plans.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.faults import FaultMap
from repro_torch.core.resilience import ResilienceTable

__all__ = [
    "RetrainingPlan",
    "group_and_fuse",
    "fixed_policy_plan",
    "random_pair_merge_plan",
    "individual_plan",
]


@dataclass
class RetrainingPlan:
    """Output of Step 3: one entry per retraining job.

    ``links[g]`` lists the original chip indices served by job ``g``
    (the paper's T_Link), ``steps[g]`` the selected retraining amount.
    """

    fault_maps: list[FaultMap]
    links: list[list[int]]
    steps: list[float]
    method: str = ""

    @property
    def total_steps(self) -> float:
        return float(sum(self.steps))

    @property
    def num_jobs(self) -> int:
        return len(self.fault_maps)

    @property
    def num_chips(self) -> int:
        return sum(len(l) for l in self.links)

    def summary(self) -> dict:
        return dict(
            method=self.method,
            jobs=self.num_jobs,
            chips=self.num_chips,
            total_steps=self.total_steps,
            mean_steps_per_chip=self.total_steps / max(1, self.num_chips),
        )


def _cost(table: ResilienceTable, rate: float, stat: str) -> float:
    """Retraining amount at the table's measurement resolution.

    Rewards and prescribed amounts are read at *measured* points: the query
    rate rounds UP to the first rate Step 1 actually measured at or above
    it (conservative — the prescribed amount is a real measured requirement
    for a rate at least as high, never an interpolated undershoot).
    Comparing sub-knot linear interpolants instead manufactures phantom
    cost deltas — a fused map sitting between two knots gets charged a
    fraction of the next knot's cost even when the measurement says the
    whole band needs the same amount, which silently vetoes every
    correlated-map merge. Above the measured range the table's capped
    extrapolation applies unchanged.
    """
    r = np.asarray(table.rates)
    idx = int(np.searchsorted(r, float(rate), side="left"))
    if idx >= len(r):
        return float(table.required_steps(float(rate), stat=stat))
    return float(table.required_steps(float(r[idx]), stat=stat))


# ---------------------------------------------------------------------------
# Algorithm 2 (faithful implementation)
# ---------------------------------------------------------------------------


def group_and_fuse(
    fault_maps: Sequence[FaultMap],
    table: ResilienceTable,
    *,
    m_comparisons: int = 8,
    k_iterations: int = 2,
    stat: str = "max",
    seed: int = 0,
    require_reachable: bool = True,
) -> RetrainingPlan:
    """Paper Algo 2.

    Sort maps by fault rate ascending; for each map, compare against at most
    M randomly selected other maps, pick the candidate giving the lowest
    fused fault rate (paper SIII-D text), and merge when the saving
    ``cost(A) + cost(B) - cost(fused)`` is non-negative (costs evaluated at
    the resilience table's measurement resolution — see ``_cost``). A
    zero-saving merge is still a win: it removes a whole retraining job at
    no modeled step cost, which is the point of Step 3. Repeat K passes.
    Merged maps re-enter the sorted list at their rate position, so they can
    be fused again in later passes.

    ``require_reachable`` refuses merges whose fused rate cannot reach the
    constraint within the measurement cap (cost == cap) — retraining a group
    that can never satisfy the constraint helps nobody.
    """
    rng = np.random.default_rng(seed)
    maps = list(fault_maps)
    links: list[list[int]] = [[i] for i in range(len(maps))]
    rates = [m.fault_rate for m in maps]
    order = np.argsort(rates, kind="stable")
    maps = [maps[i] for i in order]
    links = [links[i] for i in order]
    rates = [rates[i] for i in order]

    for _ in range(k_iterations):
        i = 0
        while i < len(maps) - 1:
            fm = maps[i]
            # candidate pool: every other map (paper selects among MFMs
            # excluding the current one; we sample from the tail like the
            # pseudo-code's MFMs(:, :, i+1:end))
            pool = list(range(i + 1, len(maps)))
            if not pool:
                break
            if len(pool) > m_comparisons:
                pool = list(rng.choice(pool, size=m_comparisons, replace=False))
            # select the pairing with the least fused fault rate
            fused_rates = []
            for j in pool:
                fused = fm.faulty | maps[j].faulty
                fused_rates.append(float(fused.mean()))
            best_pos = int(np.argmin(fused_rates))
            j = pool[best_pos]
            fused_rate = fused_rates[best_pos]
            fused_cost = _cost(table, fused_rate, stat)
            saving = (
                _cost(table, rates[i], stat)
                + _cost(table, rates[j], stat)
                - fused_cost
            )
            # feasibility must use the same knot-quantized cost the plan
            # records, or a merge could be accepted whose prescribed job
            # sits at the cap (= constraint unreachable)
            feasible = (not require_reachable) or fused_cost < table.cap
            if saving >= 0 and feasible:
                fused_map = maps[i].merge(maps[j])
                fused_link = links[i] + links[j]
                # remove j first (j > i), then i
                for idx in sorted((i, j), reverse=True):
                    maps.pop(idx)
                    links.pop(idx)
                    rates.pop(idx)
                # insert at sorted position by rate
                pos = int(np.searchsorted(rates, fused_rate))
                maps.insert(pos, fused_map)
                links.insert(pos, fused_link)
                rates.insert(pos, fused_rate)
                # do not advance: the element now at i is unexamined
            else:
                i += 1

    steps = [_cost(table, r, stat) for r in rates]
    return RetrainingPlan(maps, links, steps, method=f"efat(M={m_comparisons},K={k_iterations},{stat})")


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------


def individual_plan(
    fault_maps: Sequence[FaultMap], table: ResilienceTable, stat: str = "max"
) -> RetrainingPlan:
    """eFAT Steps 1+2 without Step 3: per-chip resilience-selected amounts."""
    maps = list(fault_maps)
    steps = [_cost(table, m.fault_rate, stat) for m in maps]
    return RetrainingPlan(maps, [[i] for i in range(len(maps))], steps, method=f"individual({stat})")


def fixed_policy_plan(
    fault_maps: Sequence[FaultMap], steps_per_chip: float
) -> RetrainingPlan:
    """[8]-style fixed policy: same pre-specified amount for every chip."""
    maps = list(fault_maps)
    return RetrainingPlan(
        maps,
        [[i] for i in range(len(maps))],
        [float(steps_per_chip)] * len(maps),
        method=f"fixed({steps_per_chip})",
    )


def random_pair_merge_plan(
    fault_maps: Sequence[FaultMap],
    table: Optional[ResilienceTable] = None,
    steps_per_job: Optional[float] = None,
    stat: str = "max",
    seed: int = 0,
) -> RetrainingPlan:
    """TRE-map [16] as simulated in the paper SIV-C: randomly pair all chips,
    merge each pair, retrain once per pair (either a fixed amount or the
    resilience-table amount at the fused rate)."""
    rng = np.random.default_rng(seed)
    n = len(fault_maps)
    perm = rng.permutation(n)
    maps, links, steps = [], [], []
    for a in range(0, n - 1, 2):
        i, j = int(perm[a]), int(perm[a + 1])
        fused = fault_maps[i].merge(fault_maps[j])
        maps.append(fused)
        links.append([i, j])
        steps.append(
            float(steps_per_job)
            if steps_per_job is not None
            else _cost(table, fused.fault_rate, stat)
        )
    if n % 2:
        i = int(perm[-1])
        maps.append(fault_maps[i])
        links.append([i])
        steps.append(
            float(steps_per_job)
            if steps_per_job is not None
            else _cost(table, fault_maps[i].fault_rate, stat)
        )
    return RetrainingPlan(maps, links, steps, method="tre-map-random-pairs")
