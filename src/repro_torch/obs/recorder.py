"""The Recorder — bounded structured-event log + metrics registry.

The port's copy of the reference's ``obs/recorder.py``. One
:class:`Recorder` is shared by everything a process observes (today the
kernel autotuner); callers take it as an optional argument and fall back to
the module-level :data:`NULL_RECORDER`, a permanently-disabled instance that
makes every record call a cheap early return — so an uninstrumented run
pays one truthiness check per hook site and nothing else.

Events live in a **bounded ring buffer** (:class:`RingBuffer`): when the
buffer is full the oldest event is overwritten and ``dropped`` increments,
so a long-running server can never grow without bound. Metrics
(:mod:`repro_torch.obs.metrics`) are aggregates and never dropped.

Event kinds (mirroring the Chrome trace-event phases of the reference's
exporter, which waits for the continuous-serving slice):

* ``span`` — a closed interval on a named track (``ph: "X"``): the
  measurement of one tuner candidate.
* ``instant`` — a point event (``ph: "i"``): a candidate's result.

Every event carries a ``proc`` (process lane: "serve", "tune", …) and a
``track`` (thread lane: "engine", a kernel name, …).

Timestamps are ``time.perf_counter()`` seconds relative to the recorder's
construction (``t0``). The recorder accumulates its own cost in
``self_time_s``: recording must stay a few percent of wall time, and every
hook is host-side.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["Event", "RingBuffer", "Recorder", "NULL_RECORDER"]

@dataclass(frozen=True)
class Event:
    """One recorded event. ``ts``/``dur`` are seconds relative to the
    recorder's ``t0``; ``dur`` is None for instants."""

    kind: str  # "span" | "instant"
    name: str
    proc: str
    track: str
    ts: float
    dur: Optional[float] = None
    args: Optional[dict] = None


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

    def event_list(self) -> list[Event]:
        return list(self.events)


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
