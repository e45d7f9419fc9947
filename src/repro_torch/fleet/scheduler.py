"""Budget-aware fleet scheduling — packing retraining jobs into population
chunks.

The population engines run a chunk of members as ONE program: ``fit_batch``
drives every member of a chunk to the chunk's **largest** step budget
(smaller-budget members are select-masked off and ride along), and
``steps_to_constraint_batch`` runs a chunk until its **slowest** member
crosses the constraint. Vectorized lanes spent on already-finished members
are pure waste, so chunk *composition* matters: packing a 10-step job next
to a 500-step job wastes 490 lane-steps.

``FleetScheduler`` decides submission order. Because per-member results are
chunk-invariant, reordering changes **only** wall-clock/waste, never the
math. Plain Python, the reference's ``fleet/scheduler.py`` line for line,
so both packages pack a fleet into the same chunks.

Policies
--------
arrival : submit in caller order (the pre-fleet behavior).
lpt     : longest-processing-time — sort by descending cost (prescribed
          steps for Step-4 ``fit_batch``; fault rate as the cost proxy for
          Step-1 probing, where the answer *is* the unknown) and slice
          contiguously into ``population_size``-wide chunks, so each chunk
          holds similar-cost members and the span ≈ every member's own cost.

``wasted_steps`` counts lane-steps where a lane runs past its member's
budget — including padding lanes of a partial final chunk (they occupy real
vectorized width at zero budget). LPT strictly reduces it on skewed plans;
``EFAT.execute_plan`` reports the reduction.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

__all__ = ["ScheduledChunk", "FleetSchedule", "FleetScheduler", "round_up_to_multiple"]


def round_up_to_multiple(x: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= ``x`` — the mesh-tiling rounding
    a sharded engine's chunk widths must share with the scheduler's, or
    ``wasted_steps`` accounting desyncs from what actually runs."""
    return -(-x // multiple) * multiple


@dataclass(frozen=True)
class ScheduledChunk:
    """One population submission: ``indices`` into the caller's job list (in
    submission order) and their costs. ``width`` is the compiled chunk width
    (>= len(indices); the remainder is padding lanes at cost 0)."""

    indices: tuple[int, ...]
    costs: tuple[float, ...]
    width: int

    @property
    def span(self) -> float:
        """Steps the whole chunk runs for: its largest member budget."""
        return max(self.costs) if self.costs else 0.0

    @property
    def wasted_steps(self) -> float:
        """Lane-steps spent past a member's own budget, padding included."""
        return self.span * self.width - sum(self.costs)


@dataclass(frozen=True)
class FleetSchedule:
    """A submission order + its chunk decomposition and waste accounting."""

    order: tuple[int, ...]  # order[k] = original index of the k-th submitted job
    chunks: tuple[ScheduledChunk, ...]
    policy: str
    population_size: int

    @property
    def wasted_steps(self) -> float:
        return sum(c.wasted_steps for c in self.chunks)

    @property
    def span_steps(self) -> float:
        """Sequential makespan: chunks run one after another, each to its span."""
        return sum(c.span for c in self.chunks)

    def permute(self, seq: Sequence):
        """Reorder caller-order ``seq`` into submission order."""
        if len(seq) != len(self.order):
            raise ValueError(f"schedule covers {len(self.order)} jobs, got {len(seq)}")
        return [seq[i] for i in self.order]

    def unpermute(self, seq: Sequence) -> list:
        """Map submission-order results back to caller order."""
        if len(seq) != len(self.order):
            raise ValueError(f"schedule covers {len(self.order)} jobs, got {len(seq)}")
        out = [None] * len(seq)
        for k, i in enumerate(self.order):
            out[i] = seq[k]
        return out


class FleetScheduler:
    """Bin-packs jobs into ``population_size``-wide chunks by cost.

    One scheduler instance serves both Step-1 (cost = fault rate) and
    Step-4 (cost = prescribed steps) so the fleet has a single chunking
    implementation; the trainer routes every batch submission through it.
    """

    POLICIES = ("lpt", "arrival")

    def __init__(self, population_size: int, policy: str = "lpt", width_multiple: int = 1):
        """``width_multiple``: the engine's tiling constraint — a sharded
        engine runs chunks whose width is a multiple of its pop-axis extent
        (padding lanes included), so waste accounting must round up the same
        way. Prefer :meth:`for_engine`, which reads it off the engine."""
        if policy not in self.POLICIES:
            raise ValueError(f"unknown schedule policy {policy!r} (use {self.POLICIES})")
        self.population_size = max(1, int(population_size))
        self.policy = policy
        self.width_multiple = max(1, int(width_multiple))

    @classmethod
    def for_engine(cls, engine, policy: str = "lpt") -> "FleetScheduler":
        """Scheduler matched to a FAT engine's chunking: population width
        from the engine, width rounding from its pop-axis extent
        (``num_shards``; 1 for the population and serial engines)."""
        return cls(
            engine.population_size,
            policy=policy,
            width_multiple=getattr(engine, "num_shards", 1),
        )

    def _order(self, costs: Sequence[float], policy: str) -> list[int]:
        n = len(costs)
        if policy == "arrival":
            return list(range(n))
        # LPT: descending cost, stable index tiebreak for determinism
        return sorted(range(n), key=lambda i: (-float(costs[i]), i))

    def schedule(self, costs: Sequence[float], policy: str | None = None) -> FleetSchedule:
        policy = policy or self.policy
        order = self._order(costs, policy)
        size = self.population_size
        chunks = []
        for lo in range(0, len(order), size):
            idx = tuple(order[lo : lo + size])
            # the engine pads a partial final chunk to full width (its chunk
            # width is min(population_size, n), rounded up to the device
            # tiling — mirror that so waste accounting matches what runs)
            width = min(size, len(order)) if len(order) else size
            width = round_up_to_multiple(width, self.width_multiple)
            chunks.append(
                ScheduledChunk(
                    indices=idx,
                    costs=tuple(float(costs[i]) for i in idx),
                    width=width,
                )
            )
        return FleetSchedule(
            order=tuple(order),
            chunks=tuple(chunks),
            policy=policy,
            population_size=size,
        )

    def report(self, costs: Sequence[float]) -> dict:
        """Waste accounting of this scheduler's policy vs arrival order —
        surfaced by ``EFAT.execute_plan``."""
        mine = self.schedule(costs)
        arrival = self.schedule(costs, policy="arrival")
        reduction = arrival.wasted_steps - mine.wasted_steps
        return dict(
            policy=self.policy,
            population_size=self.population_size,
            jobs=len(costs),
            chunks=len(mine.chunks),
            wasted_steps=mine.wasted_steps,
            arrival_wasted_steps=arrival.wasted_steps,
            wasted_steps_reduction=reduction,
            span_steps=mine.span_steps,
            arrival_span_steps=arrival.span_steps,
        )
