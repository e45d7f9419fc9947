"""Shared instrumentation hooks for the serving engines.

The continuous-batching engine traces the request lifecycle — enqueue → admit (packed bucket or chunk stream) →
decode ticks → retire — so the span bookkeeping lives here once and both
engines call it at their dispatch boundaries. Everything is host-side: no
hook touches a tensor the model computes, so enabling a recorder cannot
change a sampled token.

Track layout (what Perfetto draws):

* one track per decode slot (``slot3``, or ``chip1/slot3`` for the fleet)
  carrying that slot's ``admit``/``chunk`` spans, the per-request
  ``decode`` span (admission → retirement) and the ``retire`` instant;
* one ``engine`` track per process carrying the fused ``decode_step``
  dispatch spans;
* one ``pages`` counter track per allocator (:class:`PoolMonitor`)
  sampling free/in-use/high-water/alloc-failure series.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.metrics import (
    QUEUE_WAIT_STEP_BUCKETS,
    STEP_LATENCY_BUCKETS_S,
    TPOT_BUCKETS_S,
    TTFT_BUCKETS_S,
)
from repro_torch.obs.recorder import NULL_RECORDER, Recorder

__all__ = ["RequestTracer", "PoolMonitor"]


class RequestTracer:
    """Per-request lifecycle spans on per-slot tracks, plus the request
    latency histograms (TTFT, time-per-output-token, queue wait, prefill
    latency) every serving tier records the same way."""

    def __init__(self, recorder: Optional[Recorder], *, proc: str = "serve",
                 track_prefix: str = ""):
        self.rec = recorder if recorder is not None else NULL_RECORDER
        self.proc = proc
        self.prefix = track_prefix
        self._decode_t0: dict = {}  # rid -> trace time its decode life began

    def __bool__(self) -> bool:
        return bool(self.rec)

    def _slot_track(self, slot: int) -> str:
        return f"{self.prefix}slot{slot}"

    # -- admission ---------------------------------------------------------

    def admitted(self, rid: int, slot: int, t0: float, t1: float, *,
                 args: Optional[dict] = None) -> None:
        """One request admitted by a prefill dispatch spanning [t0, t1]
        (several packed requests share the dispatch — each gets an ``admit``
        span on its own slot track). Starts the request's decode span."""
        if not self.rec:
            return
        self.rec.span("admit", proc=self.proc, track=self._slot_track(slot),
                      t0=t0, t1=t1, args=dict(rid=rid, **(args or {})))
        self.rec.observe("serve.prefill_admit_s", t1 - t0, STEP_LATENCY_BUCKETS_S)
        self._decode_t0[rid] = t1

    def chunk(self, rid: int, slot: int, t0: float, t1: float, *,
              final: bool, args: Optional[dict] = None) -> None:
        """One chunk of a long prompt streamed into the slot's page chain;
        the final chunk activates the slot and starts the decode span."""
        if not self.rec:
            return
        self.rec.span("chunk", proc=self.proc, track=self._slot_track(slot),
                      t0=t0, t1=t1, args=dict(rid=rid, final=final, **(args or {})))
        self.rec.observe("serve.prefill_chunk_s", t1 - t0, STEP_LATENCY_BUCKETS_S)
        if final:
            self._decode_t0[rid] = t1

    # -- decode ------------------------------------------------------------

    def decode_dispatch(self, t0: float, t1: float, *, n_active: int,
                        clock: int) -> None:
        """One fused decode dispatch (all active slots advance a token)."""
        if not self.rec:
            return
        self.rec.span("decode_step", proc=self.proc, track=f"{self.prefix}engine",
                      t0=t0, t1=t1, args=dict(n_active=n_active, clock=clock))
        self.rec.observe("serve.decode_step_s", t1 - t0, STEP_LATENCY_BUCKETS_S)

    # -- retirement --------------------------------------------------------

    def retired(self, out, slot: int, t1: float) -> None:
        """Request ``out`` (a RequestOutput) left slot ``slot`` at trace
        time ``t1``: close its decode span, mark the retirement, record its
        latency histograms."""
        if not self.rec:
            return
        t0 = self._decode_t0.pop(out.rid, t1)
        track = self._slot_track(slot)
        n = len(out.tokens)
        self.rec.span(
            "decode", proc=self.proc, track=track, t0=t0, t1=t1,
            args=dict(rid=out.rid, tokens=n, finish_reason=out.finish_reason),
        )
        self.rec.instant(
            "retire", proc=self.proc, track=track,
            args=dict(rid=out.rid, finish_reason=out.finish_reason,
                      queue_wait_steps=out.queue_wait_steps),
        )
        self.rec.count("serve.requests_retired")
        self.rec.count("serve.tokens_emitted", n)
        self.rec.observe("serve.ttft_wall_s", out.ttft_wall_s, TTFT_BUCKETS_S)
        self.rec.observe("serve.queue_wait_steps", float(out.queue_wait_steps),
                         QUEUE_WAIT_STEP_BUCKETS)
        if n > 1:
            self.rec.observe("serve.tpot_s", (t1 - t0) / (n - 1), TPOT_BUCKETS_S)


class PoolMonitor:
    """Page-pool gauge sampling at dispatch boundaries: free pages, pages
    in use, the allocator high-water mark and its admission-failure count,
    as Chrome counter-track series + registry gauges."""

    def __init__(self, recorder: Optional[Recorder], alloc, *,
                 proc: str = "serve", track: str = "pages",
                 name_prefix: str = "kv."):
        self.rec = recorder if recorder is not None else NULL_RECORDER
        self.alloc = alloc
        self.proc = proc
        self.track = track
        self.prefix = name_prefix
        self._last: Optional[tuple] = None

    def __bool__(self) -> bool:
        return bool(self.rec)

    def sample(self) -> None:
        """Record the pool's current state; consecutive identical samples
        collapse (only changes are recorded, so idle ticks are free)."""
        if not self.rec:
            return
        a = self.alloc
        state = (a.free_pages, a.pages_in_use, a.high_water, a.alloc_failures)
        if state == self._last:
            return
        self._last = state
        self._emit(state)

    def flush(self) -> None:
        """Emit the current state unconditionally — called at serve end so
        every counter series extends to the trace's final timestamp instead
        of cutting off at its last *change* (the dedupe above never emits a
        closing sample on its own)."""
        if not self.rec:
            return
        a = self.alloc
        state = (a.free_pages, a.pages_in_use, a.high_water, a.alloc_failures)
        self._last = state
        self._emit(state)

    def _emit(self, state: tuple) -> None:
        p, t = self.proc, self.track
        self.rec.sample(self.prefix + "free_pages", state[0], proc=p, track=t)
        self.rec.sample(self.prefix + "pages_in_use", state[1], proc=p, track=t)
        self.rec.sample(self.prefix + "high_water", state[2], proc=p, track=t)
        self.rec.sample(self.prefix + "alloc_failures", state[3], proc=p, track=t)
