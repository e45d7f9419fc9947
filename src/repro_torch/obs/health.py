"""Per-chip health scoring — EWMA detectors + a debounced state machine.

Sits between the raw sensors (``repro_torch.obs.abft`` probe results,
per-decode logit statistics, ``PageAllocator`` telemetry) and the consumers
(the alert engine, and a recovery loop that drains or swaps a chip). Per
chip it keeps:

* EWMA detectors over canary mismatch counts and checksum syndromes
  (hard, bitwise-grounded evidence), a z-score drift detector over the
  mean emitted-token logprob (soft evidence), and an allocator
  backpressure EWMA;
* a **debounced** ``healthy -> suspect -> degraded`` state machine driven
  by consecutive bad probes (``HealthConfig.suspect_after`` /
  ``degraded_after``), recovering after ``recover_after`` consecutive
  clean probes;
* a [0, 1] health score (EWMA of the per-tick evidence) recorded as a
  gauge series on the chip's own track, so Perfetto draws one health
  swimlane per chip next to its slot lanes.

Soft evidence (logit drift, backpressure) only moves the *score* by
default — state transitions need probe evidence, which is bitwise-exact
against the golden snapshot, so a healthy fleet can never false-positive
its way into ``suspect``. Set
``HealthConfig.drift_z`` to let sustained drift raise ``suspect`` on its
own (for deployments without a probe budget).

Host-side numpy only, so the detector stack runs against a numpy silicon
model in milliseconds. The port's copy of the reference's ``obs/health.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.obs.abft import ProbeResult
from repro_torch.obs.recorder import NULL_RECORDER, Recorder

__all__ = [
    "HEALTHY",
    "SUSPECT",
    "DEGRADED",
    "STATE_LEVEL",
    "Ewma",
    "DriftDetector",
    "HealthConfig",
    "ChipHealth",
    "HealthTracker",
]

HEALTHY, SUSPECT, DEGRADED = "healthy", "suspect", "degraded"
STATE_LEVEL = {HEALTHY: 0, SUSPECT: 1, DEGRADED: 2}


@dataclass
class Ewma:
    """Exponentially-weighted moving average, seeded by its first sample."""

    alpha: float = 0.25
    value: float = 0.0
    initialized: bool = False

    def update(self, x: float) -> float:
        x = float(x)
        if not self.initialized:
            self.value = x
            self.initialized = True
        else:
            self.value += self.alpha * (x - self.value)
        return self.value


class DriftDetector:
    """EWMA mean/variance z-score: how far the current sample sits from the
    running distribution. Returns 0.0 during warmup (no baseline yet)."""

    def __init__(self, alpha: float = 0.05, warmup: int = 8,
                 min_std: float = 1e-3):
        self.mean = Ewma(alpha)
        self.var = Ewma(alpha)
        self.warmup = warmup
        self.min_std = min_std
        self.n = 0

    def update(self, x: float) -> float:
        x = float(x)
        self.n += 1
        if self.n <= self.warmup:
            self.mean.update(x)
            self.var.update((x - self.mean.value) ** 2)
            return 0.0
        z = (x - self.mean.value) / max(self.min_std, math.sqrt(self.var.value))
        self.mean.update(x)
        self.var.update((x - self.mean.value) ** 2)
        return z


@dataclass(frozen=True)
class HealthConfig:
    """Debounce thresholds and score weights for one fleet's detectors."""

    suspect_after: int = 2  # consecutive bad probes: healthy -> suspect
    degraded_after: int = 5  # consecutive bad probes: suspect -> degraded
    recover_after: int = 3  # consecutive clean probes: -> healthy
    drift_z: Optional[float] = None  # z threshold for drift-driven suspect
    drift_after: int = 5  # consecutive over-threshold drift ticks
    score_alpha: float = 0.25
    w_canary: float = 0.6
    w_syndrome: float = 0.3
    w_drift: float = 0.05
    w_backpressure: float = 0.05


@dataclass
class ChipHealth:
    """One chip's detector state; fed by :class:`HealthTracker`."""

    chip: int
    config: HealthConfig
    state: str = HEALTHY
    score: Ewma = field(init=False)
    drift: DriftDetector = field(default_factory=DriftDetector)
    backpressure: Ewma = field(default_factory=lambda: Ewma(0.1))
    bad_probes: int = 0  # consecutive
    clean_probes: int = 0  # consecutive
    drift_ticks: int = 0  # consecutive over-threshold
    probes: int = 0
    detections: int = 0  # healthy -> suspect transitions
    detected_at: Optional[int] = None  # clock of the FIRST detection
    last_delta: Optional[np.ndarray] = None  # bool (R, C) reconstructed
    last_result: Optional[ProbeResult] = None
    transitions: list = field(default_factory=list)  # (clock, frm, to, why)
    _alloc_failures: int = 0

    def __post_init__(self):
        self.score = Ewma(self.config.score_alpha, value=1.0, initialized=True)

    def _transition(self, to: str, clock: Optional[int], why: str):
        frm = self.state
        self.state = to
        self.transitions.append((clock, frm, to, why))
        if frm == HEALTHY and to != HEALTHY:
            self.detections += 1
            if self.detected_at is None:
                self.detected_at = clock
        return (clock, frm, to, why)

    def observe_probe(self, result: ProbeResult, *, clock: Optional[int] = None):
        """Feed one probe tick; returns the transition tuple if the state
        machine moved, else None."""
        cfg = self.config
        self.probes += 1
        self.last_result = result
        if result.delta is not None and result.delta.any():
            self.last_delta = result.delta
        bad = result.detected
        if bad:
            self.bad_probes += 1
            self.clean_probes = 0
        else:
            self.clean_probes += 1
            self.bad_probes = 0
        ncols = max(1, result.syndrome_cols.size)
        penalty = (
            cfg.w_canary * (1.0 if result.canary_mismatches else 0.0)
            + cfg.w_syndrome
            * min(1.0, float((result.syndrome_cols > 0).sum()) / ncols * 4.0)
        )
        self.score.update(max(0.0, 1.0 - penalty))
        if self.state == HEALTHY and self.bad_probes >= cfg.suspect_after:
            return self._transition(SUSPECT, clock, "probe")
        if self.state == SUSPECT and self.bad_probes >= cfg.degraded_after:
            return self._transition(DEGRADED, clock, "probe")
        if self.state != HEALTHY and self.clean_probes >= cfg.recover_after:
            return self._transition(HEALTHY, clock, "recovered")
        return None

    def observe_decode(self, *, clock: Optional[int] = None,
                       mean_logprob: Optional[float] = None,
                       alloc_failures: Optional[int] = None):
        """Feed one decode dispatch's soft telemetry; may transition only
        when ``HealthConfig.drift_z`` is set."""
        cfg = self.config
        soft = 0.0
        if mean_logprob is not None and math.isfinite(mean_logprob):
            z = self.drift.update(mean_logprob)
            over = cfg.drift_z is not None and abs(z) > cfg.drift_z
            self.drift_ticks = self.drift_ticks + 1 if over else 0
            soft += cfg.w_drift * min(1.0, abs(z) / 6.0)
        if alloc_failures is not None:
            delta = max(0, alloc_failures - self._alloc_failures)
            self._alloc_failures = alloc_failures
            soft += cfg.w_backpressure * self.backpressure.update(
                1.0 if delta else 0.0
            )
        self.score.update(max(0.0, 1.0 - soft))
        if (
            cfg.drift_z is not None
            and self.state == HEALTHY
            and self.drift_ticks >= cfg.drift_after
        ):
            return self._transition(SUSPECT, clock, "logit-drift")
        return None

    def summary(self) -> dict:
        delta = self.last_delta
        return dict(
            chip=self.chip,
            state=self.state,
            score=self.score.value,
            probes=self.probes,
            detections=self.detections,
            detected_at=self.detected_at,
            bad_probes=self.bad_probes,
            delta_faults=int(delta.sum()) if delta is not None else 0,
            delta_coords=[
                [int(a), int(b)] for a, b in zip(*np.nonzero(delta))
            ][:64] if delta is not None else [],
            transitions=[
                dict(clock=t[0], frm=t[1], to=t[2], why=t[3])
                for t in self.transitions
            ],
        )


class HealthTracker:
    """Fleet-wide health: one :class:`ChipHealth` per chip, recorded as
    gauge series (``health.chip{c}.score`` / ``.state``) on per-chip
    tracks plus ``health.transition`` / ``fault.detected`` instants and a
    ``health.detections`` counter — the signal surface the alert engine's
    rules and the Chrome-trace swimlanes read."""

    def __init__(self, num_chips: int, recorder: Optional[Recorder] = None, *,
                 config: Optional[HealthConfig] = None, proc: str = "serve",
                 track_of=None):
        if num_chips < 1:
            raise ValueError(f"num_chips must be >= 1, got {num_chips}")
        self.config = config or HealthConfig()
        self.rec = recorder if recorder is not None else NULL_RECORDER
        self.proc = proc
        self.chips = [ChipHealth(c, self.config) for c in range(num_chips)]
        if track_of is None:
            track_of = (
                (lambda c: "health") if num_chips == 1
                else (lambda c: f"chip{c}/health")
            )
        self._track_of = track_of

    def __bool__(self) -> bool:
        return True

    # -- feeding -----------------------------------------------------------

    def _record_state(self, ch: ChipHealth):
        if not self.rec:
            return
        t = self._track_of(ch.chip)
        self.rec.sample(f"health.chip{ch.chip}.score", ch.score.value,
                        proc=self.proc, track=t)
        self.rec.sample(f"health.chip{ch.chip}.state", STATE_LEVEL[ch.state],
                        proc=self.proc, track=t)

    def _record_transition(self, ch: ChipHealth, moved, result=None):
        if not self.rec or moved is None:
            return
        clock, frm, to, why = moved
        args = dict(chip=ch.chip, clock=clock, frm=frm, to=to, why=why)
        self.rec.instant("health.transition", proc=self.proc,
                         track=self._track_of(ch.chip), args=args)
        if frm == HEALTHY and to != HEALTHY:
            self.rec.count("health.detections")
            det = dict(args)
            if result is not None:
                det.update(result.as_dict())
            self.rec.instant("fault.detected", proc=self.proc,
                             track=self._track_of(ch.chip), args=det)

    def observe_probe(self, chip: int, result: ProbeResult, *,
                      clock: Optional[int] = None):
        ch = self.chips[chip]
        moved = ch.observe_probe(result, clock=clock)
        self._record_transition(ch, moved, result)
        self._record_state(ch)
        return moved

    def observe_decode(self, chip: int, *, clock: Optional[int] = None,
                       mean_logprob: Optional[float] = None,
                       alloc_failures: Optional[int] = None):
        ch = self.chips[chip]
        moved = ch.observe_decode(clock=clock, mean_logprob=mean_logprob,
                                  alloc_failures=alloc_failures)
        self._record_transition(ch, moved)
        return moved

    def finalize(self) -> None:
        """Closing gauge samples so every chip's health series extends to
        the end of the trace (mirrors ``PoolMonitor.flush``)."""
        for ch in self.chips:
            self._record_state(ch)

    # -- queries -----------------------------------------------------------

    def state(self, chip: int) -> str:
        return self.chips[chip].state

    def score(self, chip: int) -> float:
        return self.chips[chip].score.value

    def detected_at(self, chip: int) -> Optional[int]:
        return self.chips[chip].detected_at

    def last_delta(self, chip: int) -> Optional[np.ndarray]:
        return self.chips[chip].last_delta

    @property
    def detections(self) -> int:
        return sum(ch.detections for ch in self.chips)

    def summary(self) -> dict:
        return dict(
            num_chips=len(self.chips),
            detections=self.detections,
            states={ch.chip: ch.state for ch in self.chips},
            chips=[ch.summary() for ch in self.chips],
        )
