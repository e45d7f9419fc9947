"""Observability CLI: self-check, log conversion, and log summaries.

Works entirely on the pure-python :mod:`repro_torch.obs` layer — no torch
tensor, no model, no devices — so a CI job can gate on ``--check`` in
milliseconds. The port's copy of the reference's ``launch/obs.py``: the same
checks, the same output and the same exit codes.

* ``--check`` — exercise the recorder end to end in-process (spans /
  instants / samples / metrics, ring wraparound, JSONL round-trip, Chrome
  export + schema validation) PLUS the fault-detection stack (ABFT prober
  against a numpy silicon model, health state-machine debounce, alert
  fire/resolve) and exit 0 iff everything holds. This is the canary that
  the exporters CI later feeds real serve traces through are
  self-consistent.
* ``--convert IN.jsonl --trace-out OUT.json`` — re-export a saved JSONL
  event log (``--metrics-out`` from the serve CLIs / benches) as a Chrome
  trace viewable in https://ui.perfetto.dev.
* ``--summary IN.jsonl`` — print a log's meta line, event-kind counts,
  metric aggregates, dropped-event accounting and any alert fire/resolve
  instants as JSON (a dropped-ring log warns on stderr). Combined with
  ``--check``, exits 1 if the log holds alerts that fired.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.obs --check
    PYTHONPATH=src python -m repro_torch.launch.obs --convert run.jsonl --trace-out run.trace.json
    PYTHONPATH=src python -m repro_torch.launch.obs --summary run.jsonl
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def _self_check() -> list[str]:
    """Run the in-process smoke; returns problems (empty == healthy)."""
    from repro_torch.obs import (
        NULL_RECORDER,
        Recorder,
        RingBuffer,
        chrome_trace,
        read_jsonl,
        validate_chrome_trace,
        write_jsonl,
    )
    from repro_torch.obs.metrics import TTFT_BUCKETS_S

    problems: list[str] = []

    # ring wraparound: bounded, oldest-first, dropped accounted
    rb = RingBuffer(4)
    for i in range(10):
        rb.append(i)
    if list(rb) != [6, 7, 8, 9] or rb.dropped != 6:
        problems.append(f"ring wraparound broken: {list(rb)} dropped={rb.dropped}")

    # null recorder: falsy, un-enableable
    if NULL_RECORDER:
        problems.append("NULL_RECORDER is truthy")
    try:
        NULL_RECORDER.enabled = True
        problems.append("NULL_RECORDER accepted enable")
    except AttributeError:
        pass

    # record one of everything, export both ways, validate, round-trip
    rec = Recorder(capacity=64)
    t0 = rec.now()
    rec.span("admit", proc="serve", track="slot0", t0=t0, t1=t0 + 0.01,
             args=dict(rid=0))
    rec.span("decode", proc="serve", track="slot0", t0=t0 + 0.01, t1=t0 + 0.05,
             args=dict(rid=0, tokens=4))
    rec.instant("retire", proc="serve", track="slot0", args=dict(rid=0))
    rec.sample("kv.free_pages", 7, proc="serve", track="pages")
    rec.count("serve.tokens_emitted", 4)
    rec.observe("serve.ttft_wall_s", 0.012, TTFT_BUCKETS_S)
    rec.gauge_set("serve.compiles.total", 2)

    trace = chrome_trace(rec)
    problems += validate_chrome_trace(trace)

    h = rec.summary()["metrics"].get("serve.ttft_wall_s")
    if not h or h["count"] != 1 or not (0.01 <= h["p50"] <= 0.025):
        problems.append(f"histogram aggregate wrong: {h}")

    fd, path = tempfile.mkstemp(suffix=".jsonl")
    os.close(fd)
    try:
        write_jsonl(path, rec)
        back = read_jsonl(path)
        if len(back["events"]) != len(rec.event_list()):
            problems.append(
                f"jsonl round-trip lost events: {len(back['events'])} "
                f"!= {len(rec.event_list())}"
            )
        if back["events"] != rec.event_list():
            problems.append("jsonl round-trip changed event content")
        round_trip = chrome_trace(back["events"])
        problems += [f"re-exported: {p}" for p in validate_chrome_trace(round_trip)]
    finally:
        os.unlink(path)
    return problems + _detection_check()


def _detection_check() -> list[str]:
    """Device-free smoke of the fault-detection stack: the ABFT prober against
    a numpy silicon model, the health state machine's debounce, and alert
    fire/resolve."""
    import numpy as np

    from repro_torch.obs import (
        HEALTHY,
        SUSPECT,
        AlertEngine,
        AlertRule,
        ChipHealth,
        ChipProber,
        HealthConfig,
        Recorder,
    )
    from repro_torch.obs.abft import periodic_mask_np
    from repro_torch.obs.health import DriftDetector, Ewma

    problems: list[str] = []

    # -- ABFT prober over a numpy silicon model ---------------------------
    rng = np.random.default_rng(0)
    R, C, K, N = 4, 4, 24, 20
    W = rng.standard_normal((K, N)).astype(np.float32)
    ok = np.ones((R, C), bool)

    def dispatch(x):
        m = periodic_mask_np(W.shape, ok)
        y = (np.asarray(x, np.float64) @ (W * m)).astype(np.float32)
        chk = (np.asarray(x, np.float64).sum(axis=0) @ (W * m)).astype(np.float32)
        return y, chk

    prober = ChipProber(dispatch, array_shape=(R, C), k_dim=K)
    res = prober.probe(clock=0)
    if res.detected or res.canary_mismatches or res.dispatches != 1:
        problems.append(f"healthy probe not clean: {res.as_dict()}")
    ok[2, 1] = False  # silicon degrades under the prober
    res = prober.probe(clock=1)
    if not res.detected:
        problems.append("prober missed an injected fault")
    elif res.delta is None or not res.delta[2, 1] or int(res.delta.sum()) != 1:
        problems.append(f"prober mislocalized the fault: {res.as_dict()}")
    prober.rebase()  # accept the new silicon as the believed map
    res = prober.probe(clock=2)
    if res.detected:
        problems.append("probe after rebase still detects")

    # -- EWMA / drift primitives ------------------------------------------
    e = Ewma(alpha=0.5)
    e.update(1.0)
    e.update(0.0)
    if not (0.4 < e.value < 0.6):
        problems.append(f"ewma update wrong: {e.value}")
    d = DriftDetector(warmup=3)
    zs = [d.update(1.0) for _ in range(8)]
    if any(zs):
        problems.append(f"drift z nonzero on a constant series: {zs}")

    # -- health state machine debounce ------------------------------------
    cfg = HealthConfig(suspect_after=2, recover_after=2)
    bad = type(res)(canary_mismatches=3, syndrome_cols=np.ones(C), detected=True,
                    dispatches=2)
    clean = type(res)(canary_mismatches=0, syndrome_cols=np.zeros(C),
                      detected=False, dispatches=1)
    h = ChipHealth(0, cfg)
    h.observe_probe(bad, clock=0)
    if h.state != HEALTHY:
        problems.append("single bad probe transitioned before debounce")
    h.observe_probe(bad, clock=1)
    if h.state != SUSPECT or h.detected_at != 1:
        problems.append(f"debounced suspect transition broken: {h.summary()}")
    h.observe_probe(clean, clock=2)
    h.observe_probe(clean, clock=3)
    if h.state != HEALTHY:
        problems.append(f"recovery after clean streak broken: {h.summary()}")

    # -- alert engine fire / debounce / resolve ---------------------------
    rec = Recorder(capacity=32)
    eng = AlertEngine(rec, [AlertRule("hot", "temp", ">", 10.0, for_ticks=2)])
    rec.gauge_set("temp", 50.0)
    if eng.evaluate(clock=0) != []:
        problems.append("alert fired before for_ticks debounce")
    if eng.evaluate(clock=1) != ["hot"]:
        problems.append("alert failed to fire after debounce")
    rec.gauge_set("temp", 1.0)
    eng.evaluate(clock=2)
    if eng.firing() or eng.fired_total != 1:
        problems.append(f"alert resolve broken: {eng.summary()}")
    alert_events = [e for e in rec.event_list() if e.name == "alert"]
    states = [e.args["state"] for e in alert_events]
    if states != ["firing", "resolved"]:
        problems.append(f"alert instants wrong: {states}")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="run the recorder/exporter self-check; exit 1 on failure")
    ap.add_argument("--convert", metavar="IN.jsonl", default=None,
                    help="JSONL event log to convert (needs --trace-out)")
    ap.add_argument("--trace-out", metavar="OUT.json", default=None,
                    help="Chrome trace output path for --convert")
    ap.add_argument("--summary", metavar="IN.jsonl", default=None,
                    help="print a JSONL log's meta + aggregates as JSON")
    args = ap.parse_args(argv)

    if not (args.check or args.convert or args.summary):
        ap.error("nothing to do: pass --check, --convert or --summary")

    rc = 0
    if args.check:
        problems = _self_check()
        if problems:
            for p in problems:
                print(f"FAIL: {p}", file=sys.stderr)
            rc = 1
        else:
            print("obs self-check OK")

    if args.convert:
        if not args.trace_out:
            ap.error("--convert needs --trace-out")
        from repro_torch.obs import jsonl_to_chrome, validate_chrome_trace

        trace = jsonl_to_chrome(args.convert, args.trace_out)
        problems = validate_chrome_trace(trace)
        if problems:
            for p in problems:
                print(f"FAIL: {p}", file=sys.stderr)
            rc = 1
        else:
            print(f"wrote {args.trace_out} ({len(trace['traceEvents'])} events)")

    if args.summary:
        from repro_torch.obs import read_jsonl

        log = read_jsonl(args.summary)
        kinds: dict[str, int] = {}
        for ev in log["events"]:
            kinds[ev.kind] = kinds.get(ev.kind, 0) + 1
        alert_events = [
            dict(ts=ev.ts, **(ev.args or {}))
            for ev in log["events"]
            if ev.kind == "instant" and ev.name == "alert"
        ]
        fired = sorted({a.get("name") for a in alert_events
                        if a.get("state") == "firing"})
        detections = [
            dict(ts=ev.ts, **(ev.args or {}))
            for ev in log["events"]
            if ev.kind == "instant" and ev.name == "fault.detected"
        ]
        out = dict(
            meta=log["meta"],
            events=len(log["events"]),
            events_dropped=log["dropped"],
            event_kinds=kinds,
            alerts=dict(fired=fired, events=alert_events),
            fault_detections=detections,
            metrics={m["name"]: m for m in log["metrics"]},
        )
        if log["dropped"]:
            out["warnings"] = [
                f"ring overwrote {log['dropped']} event(s); the oldest "
                "events are missing from this log"
            ]
            print(f"WARNING: {out['warnings'][0]}", file=sys.stderr)
        print(json.dumps(out, indent=2, default=str))
        if args.check and fired:
            print(f"FAIL: log holds fired alerts: {fired}", file=sys.stderr)
            rc = 1

    return rc


if __name__ == "__main__":
    sys.exit(main())
