"""Metrics primitives for the in-process observability layer.

Three metric kinds, all host-side and allocation-light:

* :class:`Counter` — monotone count (events, tokens, stalls).
* :class:`Gauge` — last-value sample with a high-water mark (free pages,
  allocator in-use, compile counts bridged at serve end).
* :class:`Histogram` — explicit-bucket distribution (``le`` semantics: a
  value lands in the first bucket whose upper edge is >= the value,
  Prometheus-style). Raw observations are additionally kept up to
  ``max_samples`` so percentiles are exact on bench-scale runs; past that
  the raw ring stops growing (``samples_truncated``) and
  :meth:`Histogram.percentile` falls back to linear interpolation within
  the bucket that holds the requested rank.

:class:`MetricsRegistry` is a get-or-create name → metric map; the serve
and train stacks and the kernel autotuner share one registry per
:class:`~repro_torch.obs.recorder.Recorder`, so every reader sees the same
numbers. The port's copy of the reference's ``obs/metrics.py``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "TTFT_BUCKETS_S",
    "STEP_LATENCY_BUCKETS_S",
    "TPOT_BUCKETS_S",
    "QUEUE_WAIT_STEP_BUCKETS",
]

# Default bucket ladders (seconds unless named otherwise). TTFT spans
# warmed-AOT sub-millisecond dispatch up to cold multi-second admission;
# per-dispatch/step latencies sit one decade lower; queue wait is measured
# in scheduler steps (dispatch clock ticks), not seconds.
TTFT_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
STEP_LATENCY_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0,
)
TPOT_BUCKETS_S = STEP_LATENCY_BUCKETS_S
QUEUE_WAIT_STEP_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


class Counter:
    """Monotone counter. ``inc`` only; negative increments are rejected."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        self.value += n

    def as_dict(self) -> dict:
        return dict(type="counter", name=self.name, value=self.value)


class Gauge:
    """Last-value gauge with a high-water mark."""

    __slots__ = ("name", "value", "high_water", "_set")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.high_water = 0.0
        self._set = False

    def set(self, v: float) -> None:
        v = float(v)
        self.value = v
        self.high_water = v if not self._set else max(self.high_water, v)
        self._set = True

    def as_dict(self) -> dict:
        return dict(
            type="gauge", name=self.name, value=self.value,
            high_water=self.high_water,
        )


class Histogram:
    """Explicit-bucket histogram with a bounded exact-sample store.

    ``buckets`` are the finite upper edges (``le``); one implicit +inf
    bucket catches the overflow. Edge values land in the bucket whose edge
    they equal (``v <= edge``), as the reference's do.
    """

    __slots__ = (
        "name", "buckets", "counts", "count", "sum", "min", "max",
        "_samples", "max_samples", "samples_truncated",
    )

    def __init__(self, name: str, buckets: Sequence[float], max_samples: int = 65536):
        edges = tuple(float(b) for b in buckets)
        if not edges:
            raise ValueError(f"histogram {name}: needs at least one bucket edge")
        if any(b2 <= b1 for b1, b2 in zip(edges, edges[1:])):
            raise ValueError(f"histogram {name}: bucket edges must strictly increase")
        self.name = name
        self.buckets = edges
        self.counts = [0] * (len(edges) + 1)  # [+inf] overflow last
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._samples: list[float] = []
        self.max_samples = int(max_samples)
        self.samples_truncated = False

    def observe(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            return  # NaN observations (e.g. a request with no wall stamp) are skipped
        i = 0
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                break
        else:
            i = len(self.buckets)
        self.counts[i] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self._samples) < self.max_samples:
            self._samples.append(v)
        else:
            self.samples_truncated = True

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def percentile(self, q: float) -> float:
        """q in [0, 100]. Exact (numpy-linear) while the raw sample store
        holds every observation; bucket-interpolated once truncated."""
        if not self.count:
            return float("nan")
        if not self.samples_truncated:
            import numpy as np

            return float(np.percentile(np.asarray(self._samples), q))
        rank = (q / 100.0) * self.count
        seen = 0.0
        lo = 0.0 if self.min > 0 else self.min
        for i, c in enumerate(self.counts):
            if not c:
                continue
            hi = self.buckets[i] if i < len(self.buckets) else self.max
            if seen + c >= rank:
                frac = (rank - seen) / c
                return lo + frac * (hi - lo)
            seen += c
            lo = hi
        return self.max

    def as_dict(self) -> dict:
        return dict(
            type="histogram",
            name=self.name,
            buckets=list(self.buckets),
            counts=list(self.counts),
            count=self.count,
            sum=self.sum,
            min=self.min if self.count else None,
            max=self.max if self.count else None,
            mean=self.mean if self.count else None,
            p50=self.percentile(50) if self.count else None,
            p90=self.percentile(90) if self.count else None,
            p99=self.percentile(99) if self.count else None,
            samples_truncated=self.samples_truncated,
        )


class MetricsRegistry:
    """Get-or-create registry of named metrics; one per Recorder."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, kind, *args, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            m = kind(name, *args, **kwargs)
            self._metrics[name] = m
        elif not isinstance(m, kind):
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}, "
                f"requested {kind.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, buckets: Optional[Sequence[float]] = None) -> Histogram:
        if name in self._metrics:
            return self._get(name, Histogram)
        if buckets is None:
            raise ValueError(f"histogram {name!r} not registered and no buckets given")
        return self._get(name, Histogram, buckets)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def items(self):
        """Live (name, metric) pairs — cheap iteration WITHOUT serializing
        aggregates (``as_dict`` computes histogram percentiles; the alert
        engine's per-tick path must not pay that for metrics it never
        reads)."""
        return self._metrics.items()

    def as_dict(self) -> dict:
        return {name: m.as_dict() for name, m in sorted(self._metrics.items())}
