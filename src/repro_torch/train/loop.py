"""Fault-tolerant training loop.

Responsibilities: deterministic resume (checkpoint step -> data seek),
periodic async checkpointing, periodic eval, straggler detection (per-step
wall-clock watchdog -> logged + surfaced), and crash recovery (any
exception triggers restore-from-latest and continue, up to a retry budget —
the same path a preempted or failed node takes).

The card runs asynchronously, so the watchdog synchronizes it after each
step before it reads the clock: a step's time is the device's as well as
the host's. ``LoopState.restarts`` counts every recovery, so a caller can
tell a clean run from one the retry budget carried through a failure.
An interrupt is not a crash: it stops the run after the checkpoint being
written has landed, so running the same command again resumes from it.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.train import checkpoint as ckpt_lib

log = logging.getLogger("repro_torch.train")


@dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 200
    eval_every: int = 100
    log_every: int = 50
    keep_checkpoints: int = 3
    straggler_factor: float = 3.0  # step slower than factor x median => straggler
    max_restarts: int = 2


@dataclass
class LoopState:
    step: int = 0
    metrics_history: list = field(default_factory=list)
    straggler_events: list = field(default_factory=list)
    restarts: int = 0
    step_times: list = field(default_factory=list)  # seconds of each step this run took


def _sync(metrics: dict) -> None:
    """Wait for the card to finish the step that produced ``metrics``."""
    devices = {v.device for v in metrics.values() if isinstance(v, torch.Tensor) and v.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


def _restore(ckpt_dir: str, params, opt_state):
    step, flat, _ = ckpt_lib.load_checkpoint(ckpt_dir)
    tree = ckpt_lib.restore_sharded({"params": params, "opt": opt_state}, flat)
    return step, tree["params"], tree["opt"]


def run_training(
    cfg: LoopConfig,
    *,
    train_step: Callable,  # (params, opt, batch, ctx) -> (params, opt, metrics)
    batch_at: Callable[[int], Any],
    params: Any,
    opt_state: Any,
    ctx: Any,
    eval_fn: Optional[Callable[[Any], dict]] = None,  # params -> metrics
    on_metrics: Optional[Callable[[int, dict], None]] = None,
) -> tuple[Any, Any, LoopState]:
    """Run (or resume) training to cfg.total_steps. Returns final
    (params, opt_state, loop_state)."""
    state = LoopState()
    saver = (
        ckpt_lib.AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep_checkpoints)
        if cfg.ckpt_dir
        else None
    )

    # ---- resume ---------------------------------------------------------
    if cfg.ckpt_dir and ckpt_lib.latest_step(cfg.ckpt_dir) is not None:
        state.step, params, opt_state = _restore(cfg.ckpt_dir, params, opt_state)
        log.info("resumed from step %d", state.step)

    step_times = state.step_times
    while state.step < cfg.total_steps:
        try:
            batch = batch_at(state.step)  # deterministic seek: no data loss
            t0 = time.time()
            params, opt_state, metrics = train_step(params, opt_state, batch, ctx)
            _sync(metrics)
            dt = time.time() - t0
            state.step += 1

            # ---- straggler watchdog --------------------------------------
            if len(step_times) >= 8:
                med = float(np.median(step_times[-64:]))
                if dt > cfg.straggler_factor * med:
                    state.straggler_events.append((state.step, dt, med))
                    log.warning(
                        "straggler step %d: %.3fs vs median %.3fs", state.step, dt, med
                    )
            step_times.append(dt)

            if state.step % cfg.log_every == 0 or state.step == 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step_time_s"] = dt
                state.metrics_history.append((state.step, m))
                if on_metrics:
                    on_metrics(state.step, m)

            if eval_fn and state.step % cfg.eval_every == 0:
                em = {"eval_" + k: float(v) for k, v in eval_fn(params).items()}
                state.metrics_history.append((state.step, em))
                if on_metrics:
                    on_metrics(state.step, em)

            if saver and state.step % cfg.ckpt_every == 0:
                saver.save(state.step, {"params": params, "opt": opt_state})

        except KeyboardInterrupt:  # stopped from outside: finish the pending write, then stop
            if saver:
                saver.wait()
            raise
        except Exception as e:  # crash -> restore-from-checkpoint path
            state.restarts += 1
            log.exception("step %d failed (%s); restart %d", state.step, e, state.restarts)
            if state.restarts > cfg.max_restarts or not cfg.ckpt_dir:
                raise
            if saver:
                saver.wait()
            if ckpt_lib.latest_step(cfg.ckpt_dir) is None:
                raise
            state.step, params, opt_state = _restore(cfg.ckpt_dir, params, opt_state)

    if saver:
        saver.save(state.step, {"params": params, "opt": opt_state})
        saver.wait()
    return params, opt_state, state
