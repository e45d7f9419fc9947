"""Exporters: JSON-lines event log and Chrome trace-event format.

Two on-disk forms of one recording:

* **JSONL** (:func:`write_jsonl` / :func:`read_jsonl`) — the lossless form:
  a ``meta`` header line, one line per event (oldest first), then one line
  per metric aggregate. Greppable, streamable, and re-exportable —
  :func:`jsonl_to_chrome` converts a saved JSONL log to a Chrome trace
  without re-running anything.
* **Chrome trace-event JSON** (:func:`write_chrome_trace`) — the viewable
  form: load it in ``chrome://tracing`` or https://ui.perfetto.dev. Spans
  become complete events (``ph: "X"``), instants ``ph: "i"``, samples
  counter tracks (``ph: "C"``); each recorder ``proc`` maps to a pid and
  each ``track`` to a tid, with metadata events naming both, so Perfetto
  draws one swimlane per slot/chip/engine track. Timestamps are
  microseconds relative to the recorder's epoch.

:func:`validate_chrome_trace` is the schema check CI runs against exported
traces (non-empty, named processes/threads, numeric non-negative ts/dur);
it returns a list of problems, empty when valid.
"""
from __future__ import annotations

import json
import warnings
from typing import Iterable, Optional, Sequence, Union

from repro_torch.obs.recorder import JSONL_VERSION, Event, Recorder

__all__ = [
    "chrome_trace",
    "write_chrome_trace",
    "validate_chrome_trace",
    "write_jsonl",
    "read_jsonl",
    "jsonl_to_chrome",
]

RecorderOrEvents = Union[Recorder, Iterable[Event]]


def _events_of(src: RecorderOrEvents) -> list[Event]:
    if isinstance(src, Recorder):
        return src.event_list()
    return list(src)


def chrome_trace(sources: Union[RecorderOrEvents, Sequence[RecorderOrEvents]],
                 *, events_dropped: Optional[int] = None) -> dict:
    """Build the Chrome trace-event object from one or several recorders
    (or raw event lists — e.g. re-read from a JSONL log). Multiple sources
    merge into one trace; their ``proc`` names keep them on separate
    process lanes.

    A trace built from a ring that overwrote events is INCOMPLETE — its
    oldest events are gone. The drop count (summed off Recorder sources,
    or passed explicitly via ``events_dropped`` when re-exporting a JSONL
    log) is embedded as ``otherData.events_dropped`` so
    :func:`validate_chrome_trace` can warn downstream."""
    if isinstance(sources, Recorder) or not isinstance(sources, (list, tuple)):
        sources = [sources]  # a single recorder / event iterable
    elif sources and all(isinstance(s, Event) for s in sources):
        sources = [sources]  # a bare list of events IS one source
    events: list[Event] = []
    dropped = 0
    for s in sources:
        if isinstance(s, Recorder):
            dropped += s.events.dropped
        events.extend(_events_of(s))
    if events_dropped is not None:
        dropped = int(events_dropped)

    pids: dict[str, int] = {}
    tids: dict[tuple, int] = {}
    out: list[dict] = []
    for ev in events:
        pid = pids.get(ev.proc)
        if pid is None:
            pid = pids[ev.proc] = len(pids) + 1
            out.append(dict(ph="M", name="process_name", pid=pid, tid=0,
                            args=dict(name=ev.proc)))
        tkey = (ev.proc, ev.track)
        tid = tids.get(tkey)
        if tid is None:
            tid = tids[tkey] = sum(1 for p, _ in tids if p == ev.proc) + 1
            out.append(dict(ph="M", name="thread_name", pid=pid, tid=tid,
                            args=dict(name=ev.track)))
        ts = ev.ts * 1e6  # µs
        if ev.kind == "span":
            out.append(dict(ph="X", name=ev.name, cat=ev.proc, pid=pid, tid=tid,
                            ts=ts, dur=(ev.dur or 0.0) * 1e6,
                            args=ev.args or {}))
        elif ev.kind == "instant":
            out.append(dict(ph="i", s="t", name=ev.name, cat=ev.proc, pid=pid,
                            tid=tid, ts=ts, args=ev.args or {}))
        elif ev.kind == "sample":
            out.append(dict(ph="C", name=ev.name, pid=pid, tid=tid, ts=ts,
                            args=dict(value=ev.value)))
        else:
            raise ValueError(f"unknown event kind {ev.kind!r}")
    trace = dict(traceEvents=out, displayTimeUnit="ms")
    if dropped:
        trace["otherData"] = dict(events_dropped=dropped)
    return trace


def write_chrome_trace(path: str,
                       sources: Union[RecorderOrEvents, Sequence[RecorderOrEvents]],
                       ) -> dict:
    trace = chrome_trace(sources)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


def validate_chrome_trace(trace: Union[str, dict]) -> list[str]:
    """Schema check; returns problems (empty list == valid). Accepts the
    trace object or a path to one.

    A schema-valid trace can still be *incomplete*: when it was built from
    a ring that overwrote events (``otherData.events_dropped`` embedded by
    :func:`chrome_trace`), this emits a ``UserWarning`` — dropped history
    is not a schema error, but it must not pass silently."""
    if isinstance(trace, str):
        try:
            with open(trace) as f:
                trace = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return [f"unreadable trace: {e}"]
    problems: list[str] = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["top level must be an object with a traceEvents list"]
    dropped = 0
    other = trace.get("otherData")
    if isinstance(other, dict):
        d = other.get("events_dropped")
        if isinstance(d, (int, float)):
            dropped = int(d)
    if dropped:
        warnings.warn(
            f"trace was built from a ring that overwrote {dropped} event(s); "
            "the oldest events are missing (grow Recorder(capacity=...))",
            UserWarning, stacklevel=2,
        )
    events = trace["traceEvents"]
    if not isinstance(events, list) or not events:
        return ["traceEvents must be a non-empty list"]
    named_pids, named_tids = set(), set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev:
            problems.append(f"event {i}: not an object with a ph")
            continue
        ph = ev["ph"]
        if not isinstance(ev.get("pid"), int) or not isinstance(ev.get("tid"), int):
            problems.append(f"event {i} ({ph}): pid/tid must be ints")
            continue
        if ph == "M":
            if ev.get("name") == "process_name":
                named_pids.add(ev["pid"])
            elif ev.get("name") == "thread_name":
                named_tids.add((ev["pid"], ev["tid"]))
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i} ({ph} {ev.get('name')}): bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i} (X {ev.get('name')}): bad dur {dur!r}")
        if ph == "C" and "value" not in ev.get("args", {}):
            problems.append(f"event {i} (C {ev.get('name')}): counter without value")
    real = [e for e in events if isinstance(e, dict) and e.get("ph") != "M"]
    if not real:
        problems.append("trace holds only metadata events")
    for e in real:
        if not isinstance(e, dict) or "ph" not in e:
            continue
        if e.get("pid") not in named_pids:
            problems.append(f"pid {e.get('pid')} has no process_name metadata")
            break
    for e in real:
        if not isinstance(e, dict) or "ph" not in e:
            continue
        if (e.get("pid"), e.get("tid")) not in named_tids:
            problems.append(
                f"tid {e.get('tid')} (pid {e.get('pid')}) has no thread_name metadata"
            )
            break
    return problems


# -- JSONL ------------------------------------------------------------------


def write_jsonl(path: str, recorder: Recorder) -> None:
    """Lossless event + metrics log: meta header, events oldest-first,
    metric aggregates last."""
    with open(path, "w") as f:
        meta = dict(kind="meta", version=JSONL_VERSION, wall0=recorder.wall0,
                    self_time_s=recorder.self_time_s,
                    events_dropped=recorder.events.dropped)
        f.write(json.dumps(meta) + "\n")
        for ev in recorder.events:
            f.write(json.dumps(ev.as_dict()) + "\n")
        for m in recorder.metrics.as_dict().values():
            f.write(json.dumps(dict(kind="metric", **m)) + "\n")


def read_jsonl(path: str) -> dict:
    """Parse a :func:`write_jsonl` log into ``{"meta": dict, "events":
    [Event], "metrics": [dict], "dropped": int}`` — the ring's drop count
    is lifted to the top level so callers cannot miss that the event list
    is missing its oldest entries when it is nonzero."""
    meta: Optional[dict] = None
    events: list[Event] = []
    metrics: list[dict] = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: bad JSONL line: {e}") from e
            kind = obj.get("kind")
            if kind == "meta":
                meta = obj
            elif kind == "metric":
                metrics.append(obj)
            elif kind in ("span", "instant", "sample"):
                events.append(Event(
                    kind=kind, name=obj["name"], proc=obj["proc"],
                    track=obj["track"], ts=obj["ts"], dur=obj.get("dur"),
                    value=obj.get("value"), args=obj.get("args"),
                ))
            else:
                raise ValueError(f"{path}:{ln}: unknown record kind {kind!r}")
    if meta is None:
        raise ValueError(f"{path}: missing meta header line")
    return dict(meta=meta, events=events, metrics=metrics,
                dropped=int(meta.get("events_dropped", 0) or 0))


def jsonl_to_chrome(in_path: str, out_path: str) -> dict:
    """Re-export a saved JSONL log as a viewable Chrome trace. The log's
    recorded drop count propagates into the trace's ``otherData`` so the
    validator still warns about incomplete history after a round-trip."""
    log = read_jsonl(in_path)
    trace = chrome_trace(log["events"], events_dropped=log["dropped"])
    with open(out_path, "w") as f:
        json.dump(trace, f)
    return trace
