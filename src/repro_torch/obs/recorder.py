"""The Recorder — bounded structured-event log + metrics registry.

One :class:`Recorder` instance is shared by everything a process observes
(serve engine, population trainer, kernel autotuner); engines take it as an
optional constructor argument and fall back to the module-level
:data:`NULL_RECORDER`, a permanently-disabled instance that makes every
record call a cheap early return — so an uninstrumented run pays one
truthiness check per hook site and nothing else.

Events live in a **bounded ring buffer** (:class:`RingBuffer`): when the
buffer is full the oldest event is overwritten and ``dropped`` increments,
so a long-running server can never grow without bound. Metrics
(:mod:`repro_torch.obs.metrics`) are aggregates and never dropped.

Event kinds (mirroring the Chrome trace-event phases they export to —
see :mod:`repro_torch.obs.export`):

* ``span`` — a closed interval on a named track (``ph: "X"``): decode
  dispatches, prefill admissions, per-request decode lifetimes, training
  chunk submissions.
* ``instant`` — a point event (``ph: "i"``): request retirement,
  constraint crossings, schedule decisions.
* ``sample`` — a timestamped numeric sample of a named series on a track
  (``ph: "C"``): page-pool free/in-use, backpressure stalls.

Every event carries a ``proc`` (process lane: "serve", "fleet", "train")
and a ``track`` (thread lane: "engine", "slot3", "chip1/slot0", …); the
Chrome exporter maps those to pid/tid so Perfetto draws one swimlane per
track.

Timestamps are ``time.perf_counter()`` seconds relative to the recorder's
construction (``t0``); ``wall0`` keeps the construction wall-clock epoch
for cross-process alignment. The recorder accumulates its own cost in
``self_time_s``: recording must stay a few percent of wall time, and
enabling it must change zero sampled tokens (all hooks are host-side,
outside the tensor code). The port's copy of the reference's
``obs/recorder.py``.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["Event", "RingBuffer", "Recorder", "NULL_RECORDER"]

JSONL_VERSION = 1


@dataclass(frozen=True)
class Event:
    """One recorded event. ``ts``/``dur`` are seconds relative to the
    recorder's ``t0``; ``dur`` is None for instants, ``value`` is set for
    samples only."""

    kind: str  # "span" | "instant" | "sample"
    name: str
    proc: str
    track: str
    ts: float
    dur: Optional[float] = None
    value: Optional[float] = None
    args: Optional[dict] = None

    def as_dict(self) -> dict:
        d = dict(kind=self.kind, name=self.name, proc=self.proc,
                 track=self.track, ts=self.ts)
        if self.dur is not None:
            d["dur"] = self.dur
        if self.value is not None:
            d["value"] = self.value
        if self.args:
            d["args"] = self.args
        return d


@dataclass
class RingBuffer:
    """Fixed-capacity overwrite-oldest event store."""

    capacity: int
    _buf: list = field(default_factory=list)
    _head: int = 0  # next write position once the buffer is full
    dropped: int = 0

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {self.capacity}")

    def append(self, item) -> None:
        if len(self._buf) < self.capacity:
            self._buf.append(item)
        else:
            self._buf[self._head] = item
            self._head = (self._head + 1) % self.capacity
            self.dropped += 1

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self) -> Iterator:
        """Oldest-first iteration."""
        yield from self._buf[self._head:]
        yield from self._buf[: self._head]


class Recorder:
    """Bounded event log + metrics registry; see module docstring."""

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        self.enabled = bool(enabled)
        self.events = RingBuffer(capacity)
        self.metrics = MetricsRegistry()
        self.t0 = time.perf_counter()
        self.wall0 = time.time()
        self.self_time_s = 0.0

    def __bool__(self) -> bool:
        # hook sites gate all host bookkeeping on `if recorder:` — a
        # disabled recorder costs one truthiness check per site
        return self.enabled

    # -- clock ------------------------------------------------------------

    def now(self) -> float:
        """Seconds since this recorder's t0 (the trace epoch)."""
        return time.perf_counter() - self.t0

    # -- event emission ---------------------------------------------------

    def _emit(self, ev: Event) -> None:
        self.events.append(ev)

    def span(self, name: str, *, proc: str = "serve", track: str = "engine",
             t0: float, t1: Optional[float] = None,
             args: Optional[dict] = None) -> None:
        """Record a closed interval [t0, t1] (recorder-relative seconds;
        ``t1=None`` closes at now). Use :meth:`timed` for the common
        wrap-a-block case."""
        if not self.enabled:
            return
        s = time.perf_counter()
        if t1 is None:
            t1 = s - self.t0
        self._emit(Event("span", name, proc, track, t0, dur=max(0.0, t1 - t0),
                         args=args))
        self.self_time_s += time.perf_counter() - s

    @contextmanager
    def timed(self, name: str, *, proc: str = "serve", track: str = "engine",
              args: Optional[dict] = None):
        """Context manager emitting one span over the enclosed block."""
        if not self.enabled:
            yield
            return
        t0 = self.now()
        try:
            yield
        finally:
            self.span(name, proc=proc, track=track, t0=t0, args=args)

    def instant(self, name: str, *, proc: str = "serve", track: str = "engine",
                args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        s = time.perf_counter()
        self._emit(Event("instant", name, proc, track, s - self.t0, args=args))
        self.self_time_s += time.perf_counter() - s

    def sample(self, name: str, value: float, *, proc: str = "serve",
               track: str = "engine") -> None:
        """Timestamped numeric sample (Chrome counter track); also mirrors
        into the gauge of the same name so the last value + high-water are
        queryable without scanning events."""
        if not self.enabled:
            return
        s = time.perf_counter()
        self._emit(Event("sample", name, proc, track, s - self.t0,
                         value=float(value)))
        self.metrics.gauge(name).set(value)
        self.self_time_s += time.perf_counter() - s

    # -- metric shorthands (enabled-gated like event emission) ------------

    def count(self, name: str, n: int | float = 1) -> None:
        if not self.enabled:
            return
        self.metrics.counter(name).inc(n)

    def observe(self, name: str, value: float, buckets=None) -> None:
        if not self.enabled:
            return
        s = time.perf_counter()
        self.metrics.histogram(name, buckets).observe(value)
        self.self_time_s += time.perf_counter() - s

    def gauge_set(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        self.metrics.gauge(name).set(value)

    # -- summaries --------------------------------------------------------

    def event_list(self) -> list[Event]:
        return list(self.events)

    def summary(self) -> dict:
        """Everything aggregate: metric dump + event accounting + the
        recorder's own overhead model. When the ring overwrote events the
        summary says so loudly (``ring`` subdict + a ``warnings`` entry) —
        a trace built from this recorder is missing its oldest events."""
        kinds: dict[str, int] = {}
        for ev in self.events:
            kinds[ev.kind] = kinds.get(ev.kind, 0) + 1
        dropped = self.events.dropped
        out = dict(
            events=len(self.events),
            events_dropped=dropped,
            event_kinds=kinds,
            self_time_s=self.self_time_s,
            ring=dict(capacity=self.events.capacity, len=len(self.events),
                      dropped=dropped),
            metrics=self.metrics.as_dict(),
        )
        if dropped:
            out["warnings"] = [
                f"ring overwrote {dropped} event(s) (capacity "
                f"{self.events.capacity}); the oldest events are missing — "
                "grow Recorder(capacity=...) for complete traces"
            ]
        return out


class _NullRecorder(Recorder):
    """Permanently disabled; shared singleton. Guards against accidental
    state accumulation if a hook site forgets its `if recorder:` gate."""

    def __init__(self):
        super().__init__(capacity=1, enabled=False)

    def __setattr__(self, k: str, v: Any):
        if k == "enabled" and getattr(self, "enabled", None) is False:
            raise AttributeError("NULL_RECORDER cannot be enabled; make a Recorder()")
        super().__setattr__(k, v)


NULL_RECORDER = _NullRecorder()
