"""End-to-end eFAT fleet retraining (the paper's headline experiment, SIV-C /
Fig. 13): tune one pre-trained DNN for a fleet of faulty chips.

Pipeline (paper Fig. 7): resilience analysis (Step 1, Algo 1 rates) ->
per-chip retraining amounts (Step 2) -> resilience-driven grouping and
fusion (Step 3, Algo 2) -> consolidated FAT and per-chip evaluation
(Step 4). Compared against: individual (no fusion), a fixed policy [8] and
random pairwise merging (TRE-map [16]).

    PYTHONPATH=src python -m repro_torch.examples.fleet_retraining [--chips 100] \
        [--independent] [--device cpu]

The population engines train every job of a chunk in one vmapped program.
Runs on the CUDA card unless ``--device cpu`` asks for the host.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.core import EFAT, EFATConfig, correlated_family, gaussian_chip_rates, random_fault_map
from repro_torch.train.fat_trainer import ClassifierFATTrainer

PRETRAIN_STEPS = 600
EFAT_SETTINGS = dict(max_fr=0.35, max_interval=0.05, step_ratio=0.6, repeats=5, max_steps=400, m_comparisons=8,
                     k_iterations=2, stat="max")
METHODS = ("individual", {}), ("fixed", dict(steps_per_chip=80)), ("random-merge", {})


def make_fleet(n_chips: int, correlated: bool, seed: int = 0):
    """Paper SIV-C: rates ~ N(0.1, 0.02). ``correlated`` adds shared wafer
    defects (the regime where Step-3 fusion pays off: Eq. 3)."""
    if correlated:
        return correlated_family(seed, n_chips, 32, 32, base_rate=0.07, idio_rate=0.025, chip_prefix="chip")
    rng = np.random.default_rng(seed)
    rates = gaussian_chip_rates(rng, n_chips, mean=0.1, sigma=0.02)
    return [random_fault_map(rng, 32, 32, float(r), chip_id=f"chip{i}") for i, r in enumerate(rates)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=100)
    ap.add_argument("--independent", action="store_true",
                    help="i.i.d. fault maps (fusion should find about no pairs)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    if args.chips < 1:
        ap.error("--chips must be >= 1")

    print("=== eFAT fleet retraining ===")
    t0 = time.perf_counter()
    trainer = ClassifierFATTrainer(get_arch("paper-mlp"), pretrain_steps=PRETRAIN_STEPS, eval_batches=4,
                                   device=args.device)
    constraint = trainer.baseline_accuracy - 0.03
    print(f"pretrained acc={trainer.baseline_accuracy:.3f}; constraint={constraint:.3f} "
          f"({time.perf_counter() - t0:.0f}s on {trainer.device})")

    fleet = make_fleet(args.chips, correlated=not args.independent)
    rates = [fm.fault_rate for fm in fleet]
    print(f"fleet: {len(fleet)} chips, rates {min(rates):.3f}..{max(rates):.3f}")

    ef = EFAT(trainer, EFATConfig(constraint=constraint, **EFAT_SETTINGS))
    t0 = time.perf_counter()
    ef.build_resilience_table(fleet)
    print(f"\n[Step 1] resilience map ({time.perf_counter() - t0:.0f}s):")
    for r, mx in zip(ef.table.rates, ef.table.max_steps_stat):
        print(f"   rate={r:.3f} -> steps(max)={mx:.0f}")

    results = {}
    t0 = time.perf_counter()
    results["eFAT"] = ef.run(fleet)
    for method, kw in METHODS:
        results[method] = ef.run_baseline(fleet, method, **kw)

    print(f"\n=== comparison (paper Fig. 13) [{time.perf_counter() - t0:.0f}s] ===")
    print(f"{'method':14s} {'jobs':>5s} {'total_steps':>12s} {'steps/chip':>11s} {'satisfied':>10s}")
    for name, r in results.items():
        s = r.summary()
        print(f"{name:14s} {s['jobs']:5d} {s['total_steps']:12.0f} "
              f"{s['mean_steps_per_chip']:11.1f} {s['satisfied_fraction']:9.0%}")

    # fleet scheduling: how the eFAT plan's jobs were packed into population
    # chunks, and the vectorized lane-steps LPT saved against arrival order
    sched = results["eFAT"].scheduling
    if sched is not None:
        print(f"\nscheduler ({sched['policy']}, chunks of {sched['population_size']}): "
              f"{sched['jobs']} jobs -> {sched['chunks']} chunks, "
              f"wasted lane-steps {sched['wasted_steps']:.0f} "
              f"(arrival order: {sched['arrival_wasted_steps']:.0f}, "
              f"saved {sched['wasted_steps_reduction']:.0f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
