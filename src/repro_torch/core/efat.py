"""The eFAT orchestrator — Steps 1-4 of paper Fig. 7, end to end.

Inputs: a pre-trained model + training data (wrapped in a FATTrainer), a
user-defined accuracy constraint, and the fleet's fault maps.
Output: a RetrainingPlan, the fault-aware weights per retraining job, and
per-chip evaluation — plus the same pipeline run under baseline policies
for comparison (paper SIV-C).

The reference's ``core/efat.py``, with one addition: ``EFATResult.job_params``
keeps the shipped (FAP-masked) weights of every job, which the reference's
result drops, so they can be deployed and checked.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Protocol, Sequence

import numpy as np

from repro_torch.core.faults import FaultMap
from repro_torch.core.grouping import (
    RetrainingPlan,
    fixed_policy_plan,
    group_and_fuse,
    individual_plan,
    random_pair_merge_plan,
)
from repro_torch.core.resilience import (
    ResilienceTable,
    fault_rate_list,
    measure_resilience,
)

__all__ = ["EFATConfig", "EFATResult", "EFAT", "FATTrainerFull", "BatchFATTrainerFull"]


class FATTrainerFull(Protocol):
    """Full trainer protocol: resilience probing + consolidated FAT + eval."""

    def steps_to_constraint(
        self, fault_map: FaultMap, constraint: float, max_steps: int
    ) -> Optional[int]: ...

    def train(self, fault_map: FaultMap, steps: int) -> Any:
        """Run FAT for ``steps`` with this (possibly fused) map; return the
        shipped fault-aware params (already FAP-masked)."""
        ...

    def evaluate(self, params: Any, fault_map: FaultMap) -> float:
        """Deployed metric of params on a chip with this fault map."""
        ...


class BatchFATTrainerFull(FATTrainerFull, Protocol):
    """Batch extension of the full protocol (repro_torch.train.population):
    a trainer that can run every retraining job of a plan as one population
    and evaluate a batch of (params, chip) pairs in one vmapped step.
    ``execute_plan`` uses these when present; the single-map methods remain
    the serial fallback."""

    def steps_to_constraint_batch(
        self, fault_maps: Sequence[FaultMap], constraint: float, max_steps: int
    ) -> list[Optional[int]]: ...

    def train_batch(
        self, fault_maps: Sequence[FaultMap], steps: Sequence[int]
    ) -> list[Any]: ...

    def evaluate_batch(
        self, params_list: Sequence[Any], fault_maps: Sequence[FaultMap]
    ) -> list[float]: ...


@dataclass
class EFATConfig:
    constraint: float
    # Algo 1
    max_fr: float = 0.3
    max_interval: float = 0.05
    step_ratio: float = 0.5
    # Step 1 measurement
    repeats: int = 5
    max_steps: int = 2000
    seed: int = 0
    # Algo 2
    m_comparisons: int = 8
    k_iterations: int = 2
    stat: str = "max"  # paper recommends max bounds (Fig. 12)


@dataclass
class EFATResult:
    plan: RetrainingPlan
    table: Optional[ResilienceTable]
    chip_metrics: dict[int, float]  # chip index -> deployed metric
    constraint: float
    wall_seconds: float = 0.0
    # repro_torch.fleet.FleetScheduler.report for the executed plan's job budgets
    # (None when the trainer has no scheduler): how the jobs were packed into
    # population chunks and the wasted vectorized lane-steps vs arrival order
    scheduling: Optional[dict] = None
    # the shipped (FAP-masked) params of job g, in plan order
    job_params: Optional[list] = None

    @property
    def satisfied_fraction(self) -> float:
        if not self.chip_metrics:
            return 0.0
        ok = sum(1 for v in self.chip_metrics.values() if v >= self.constraint)
        return ok / len(self.chip_metrics)

    @property
    def total_retraining_steps(self) -> float:
        return self.plan.total_steps

    def summary(self) -> dict:
        s = self.plan.summary()
        s.update(
            satisfied_fraction=self.satisfied_fraction,
            constraint=self.constraint,
            mean_metric=float(np.mean(list(self.chip_metrics.values()))) if self.chip_metrics else 0.0,
            wall_seconds=self.wall_seconds,
        )
        if self.scheduling is not None:
            s["wasted_steps"] = self.scheduling["wasted_steps"]
            s["wasted_steps_reduction"] = self.scheduling["wasted_steps_reduction"]
        return s


class EFAT:
    """End-to-end framework: resilience map -> amounts -> grouping -> FAT."""

    def __init__(self, trainer: FATTrainerFull, config: EFATConfig):
        self.trainer = trainer
        self.config = config
        self.table: Optional[ResilienceTable] = None

    # -- Step 1 ----------------------------------------------------------
    def build_resilience_table(
        self,
        fault_maps: Sequence[FaultMap],
        progress: Optional[Callable[[str], None]] = None,
        cache_path: Optional[str] = None,
    ) -> ResilienceTable:
        """Measure (or load) the Step-1 resilience table.

        ``cache_path``: JSON file reused across runs. A cached table is
        only accepted when its recorded measurement config (rates,
        constraint, repeats, cap, array shape, seed) matches this run's —
        otherwise it is re-measured and the file rewritten.
        """
        cfg = self.config
        rates = fault_rate_list(
            [fm.fault_rate for fm in fault_maps],
            max_fr=cfg.max_fr,
            max_interval=cfg.max_interval,
            step=cfg.step_ratio,
        )
        array_shape = fault_maps[0].shape
        config_key = dict(
            rates=[float(r) for r in rates],
            constraint=float(cfg.constraint),
            repeats=int(cfg.repeats),
            max_steps=int(cfg.max_steps),
            seed=int(cfg.seed),
            array_shape=[int(s) for s in array_shape],
        )
        if cache_path is not None and os.path.exists(cache_path):
            try:
                with open(cache_path) as f:
                    cached = ResilienceTable.from_json(f.read())
            except (ValueError, KeyError, OSError):
                cached = None  # corrupt/truncated cache -> re-measure
            if cached is not None and cached.meta.get("config") == config_key:
                if progress:
                    progress(f"resilience table loaded from {cache_path}")
                self.table = cached
                return cached
        self.table = measure_resilience(
            self.trainer,
            rates,
            cfg.constraint,
            array_shape=array_shape,
            repeats=cfg.repeats,
            max_steps=cfg.max_steps,
            seed=cfg.seed,
            progress=progress,
        )
        self.table.meta["config"] = config_key
        if cache_path is not None:
            # atomic replace: a killed run must not leave half a JSON doc
            tmp = cache_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(self.table.to_json())
            os.replace(tmp, cache_path)
        return self.table

    # -- Steps 2+3 ---------------------------------------------------------
    def make_plan(self, fault_maps: Sequence[FaultMap]) -> RetrainingPlan:
        assert self.table is not None, "run build_resilience_table first"
        return group_and_fuse(
            fault_maps,
            self.table,
            m_comparisons=self.config.m_comparisons,
            k_iterations=self.config.k_iterations,
            stat=self.config.stat,
            seed=self.config.seed,
        )

    # -- Step 4 ------------------------------------------------------------
    def execute_plan(
        self,
        plan: RetrainingPlan,
        fault_maps: Sequence[FaultMap],
        progress: Optional[Callable[[str], None]] = None,
    ) -> EFATResult:
        """Run consolidated FAT per job; evaluate each chip with its own map
        applied on top of the shipped (FAP-masked) weights.

        With a batch-capable trainer every retraining job of the plan is
        trained as ONE population (packed into chunks by the trainer's
        FleetScheduler — see ``result.scheduling`` for the waste accounting)
        and all per-chip deployments are evaluated as one vmapped batch;
        otherwise the serial per-job loop runs (same math — the population
        engine is proven equivalent)."""
        t0 = time.time()
        chip_metrics: dict[int, float] = {}
        job_params: list = []
        job_steps = [int(round(s)) for s in plan.steps]
        scheduler = getattr(self.trainer, "scheduler", None)
        scheduling = scheduler.report(job_steps) if scheduler is not None else None
        if hasattr(self.trainer, "train_batch") and hasattr(self.trainer, "evaluate_batch"):
            job_params = self.trainer.train_batch(plan.fault_maps, job_steps)
            pairs = [
                (g, chip) for g, chips in enumerate(plan.links) for chip in chips
            ]
            metrics = self.trainer.evaluate_batch(
                [job_params[g] for g, _ in pairs],
                [fault_maps[chip] for _, chip in pairs],
            )
            for (_, chip), m in zip(pairs, metrics):
                chip_metrics[chip] = float(m)
        else:
            for g, (fm, chips, steps) in enumerate(
                zip(plan.fault_maps, plan.links, job_steps)
            ):
                params = self.trainer.train(fm, steps)
                job_params.append(params)
                for chip in chips:
                    chip_metrics[chip] = float(
                        self.trainer.evaluate(params, fault_maps[chip])
                    )
        if progress:
            for g, chips in enumerate(plan.links):
                progress(
                    f"job {g + 1}/{plan.num_jobs}: chips={chips} "
                    f"steps={plan.steps[g]:.0f} "
                    f"metrics={[f'{chip_metrics[c]:.3f}' for c in chips]}"
                )
        return EFATResult(
            plan=plan,
            table=self.table,
            chip_metrics=chip_metrics,
            constraint=self.config.constraint,
            wall_seconds=time.time() - t0,
            scheduling=scheduling,
            job_params=job_params,
        )

    # -- convenience: full pipeline + baselines ------------------------------
    def run(
        self,
        fault_maps: Sequence[FaultMap],
        progress: Optional[Callable[[str], None]] = None,
    ) -> EFATResult:
        if self.table is None:
            self.build_resilience_table(fault_maps, progress=progress)
        plan = self.make_plan(fault_maps)
        return self.execute_plan(plan, fault_maps, progress=progress)

    def run_baseline(
        self,
        fault_maps: Sequence[FaultMap],
        method: str,
        *,
        steps_per_chip: Optional[float] = None,
        progress: Optional[Callable[[str], None]] = None,
    ) -> EFATResult:
        """Baselines of paper SIV-C: 'fixed' ([8]), 'random-merge' ([16]),
        'individual' (eFAT without Step 3)."""
        if method == "fixed":
            assert steps_per_chip is not None
            plan = fixed_policy_plan(fault_maps, steps_per_chip)
        elif method == "random-merge":
            plan = random_pair_merge_plan(
                fault_maps,
                table=self.table if steps_per_chip is None else None,
                steps_per_job=steps_per_chip,
                stat=self.config.stat,
                seed=self.config.seed,
            )
        elif method == "individual":
            assert self.table is not None
            plan = individual_plan(fault_maps, self.table, stat=self.config.stat)
        else:
            raise ValueError(f"unknown baseline {method!r}")
        return self.execute_plan(plan, fault_maps, progress=progress)
