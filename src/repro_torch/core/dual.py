"""Dual fault types — the paper's §III-B multi-dimensional extension.

Besides PE bypass (FAP), the on-chip *weight memory* can hold stuck-at
cells: a weight stored in a stuck-at-1 cell reads back with a forced
magnitude (worst-case MSB). Both follow the same periodic (R, C) geometry
as the PE array (the weight buffer is tiled with the array). FAT under
dual faults is projected training: after every optimizer step the stored
weights are re-projected onto the feasible set. The resilience surface
over (pe_rate, sa1_rate) populates a ``ResilienceTable2D``, which Step 2
interpolates bilinearly — the paper's proposal for multi-fault-type
systems.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.faults import FaultMap, random_fault_map
from repro_torch.core.mapping import periodic_mask
from repro_torch.core.resilience import ResilienceTable2D

__all__ = ["dual_fault_weight", "project_params", "measure_resilience_2d"]


def dual_fault_weight(
    w: torch.Tensor, fm_pe: Optional[FaultMap], fm_sa1: Optional[FaultMap],
    magnitude: float = 1.0,
) -> torch.Tensor:
    """Effective weight under PE-bypass + weight-memory stuck-at-1 faults.

    SA1 cells read back sign(w) * magnitude; PE bypass then zeroes whatever
    maps onto faulty PEs (bypass dominates: the product never reaches the
    accumulator)."""
    if fm_sa1 is not None:
        faulty = torch.as_tensor(fm_sa1.faulty, dtype=torch.float32, device=w.device)
        sa1 = periodic_mask(w.shape, faulty, dtype=w.dtype)
        forced = torch.sign(torch.where(w == 0, 1.0, w)) * magnitude
        w = torch.where(sa1 > 0, forced.to(w.dtype), w)
    if fm_pe is not None:
        ok = torch.as_tensor(fm_pe.ok_mask, device=w.device)
        w = w * periodic_mask(w.shape, ok, dtype=w.dtype)
    return w


def project_params(params: dict, fm_pe, fm_sa1, *, key_prefix: str = "w", magnitude: float = 1.0) -> dict:
    """Project classifier params onto the dual-fault feasible set."""
    return {
        k: dual_fault_weight(v, fm_pe, fm_sa1, magnitude)
        if k.startswith(key_prefix) and v.ndim >= 2 else v
        for k, v in params.items()
    }


def measure_resilience_2d(
    trainer,  # ClassifierFATTrainer
    rates_pe: Sequence[float],
    rates_sa1: Sequence[float],
    constraint: float,
    *,
    array_shape=(32, 32),
    max_steps: int = 300,
    repeats: int = 1,
    seed: int = 0,
    magnitude: float = 1.0,
) -> ResilienceTable2D:
    """Steps-to-constraint over the (pe_rate, sa1_rate) grid via projected
    FAT; returns a bilinear-interpolating ResilienceTable2D. The maps are
    drawn from ``np.random.default_rng(seed)`` in the reference's order, so
    both packages probe the same maps."""
    from repro_torch.train.optimizer import adamw_init, adamw_update

    rng = np.random.default_rng(seed)
    grid = np.zeros((len(rates_pe), len(rates_sa1)))
    for i, rp in enumerate(rates_pe):
        for j, rs in enumerate(rates_sa1):
            samples = []
            for _ in range(repeats):
                fm_pe = random_fault_map(rng, *array_shape, rp)
                fm_sa1 = random_fault_map(rng, *array_shape, rs)
                ctx = trainer._context(fm_pe)

                def evaluate(p):
                    return trainer.evaluate_params(
                        project_params(p, None, fm_sa1, magnitude=magnitude), ctx
                    )

                params = project_params(trainer.base_params, None, fm_sa1, magnitude=magnitude)
                if evaluate(params) >= constraint:
                    samples.append(0)
                    continue
                opt = adamw_init(params, trainer.opt_cfg)
                used = max_steps
                for s in range(1, max_steps + 1):
                    batch = trainer.data.batch_at(s, trainer.batch_size)
                    _, g = trainer.grad_fn(params, batch, ctx)
                    params, opt, _ = adamw_update(g, opt, params, trainer.opt_cfg)
                    # hardware projection: stuck cells cannot store updates
                    params = project_params(params, None, fm_sa1, magnitude=magnitude)
                    if s % trainer.eval_every == 0 and evaluate(params) >= constraint:
                        used = s
                        break
                samples.append(used)
            grid[i, j] = max(samples)
    return ResilienceTable2D(
        np.asarray(rates_pe, float), np.asarray(rates_sa1, float), grid,
        cap=max_steps, constraint=constraint,
    )
