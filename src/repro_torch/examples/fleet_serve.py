"""Serve a whole fleet of faulty chips' deployed models in one program.

The deployment half of eFAT at fleet scale, as *request streams*: each chip
runs the fault-aware weights its retraining job shipped, under its own
fault map, and consumes its OWN ragged stream of requests (mixed prompt
lengths, mixed budgets, staggered arrivals) through its own continuous-batch
slot table over a paged KV cache. One fused dispatch advances every chip's
in-flight slots a token (``ShardedFleetServeEngine``; each masked GEMM is
one chip-batched kernel launch), so no chip waits on another chip's traffic,
and greedy decoding still reproduces a per-chip ``ContinuousBatchingEngine``
token for token, which the example checks (on the card, a token may part
only at a near-tie: the chip-batched kernel may split K otherwise).

    PYTHONPATH=src python -m repro_torch.examples.fleet_serve [--chips 4] \
        [--probe-every 8] [--trace-out fleet.trace.json] \
        [--metrics-out fleet.jsonl] [--health-out health.json]

It pretrains SmolLM-135M (full width by default, random weights from a
seed) briefly on a synthetic token stream, runs a short fault-aware
training pass per faulty chip (chip 0 stays healthy, a zero-fault map, to
show a mixed fleet) and ships each chip's weights masked once
(``mask_selected_params``: every array-mapped GEMM weight; the tied
embedding keeps its rows for the lookup). Training runs in ``fap`` mode,
serving in ``--fault-mode`` (default ``kernel``, the masked-GEMM kernel).

``--trace-out`` writes a Chrome trace of the fleet run (one Perfetto
swimlane per chip slot plus per-chip page-pool counters); ``--metrics-out``
writes the JSONL event+metrics log (``python -m repro_torch.launch.obs``
converts or summarizes it). ``--probe-every N`` turns on the online
fault-detection stack (per-chip ABFT probes, health scoring and alerts) and
``--health-out`` saves the per-chip health summary JSON.

Runs on the CUDA card; ``--device cpu --reduced`` runs the plain PyTorch
path on the host with a tiny model.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", help="the reduced config (host runs)")
    ap.add_argument("--chips", type=int, default=4)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--fault-mode", choices=("fap", "kernel"), default="kernel")
    ap.add_argument("--pretrain-steps", type=int, default=100)
    ap.add_argument("--fat-steps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write the fleet run's Chrome trace")
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="write the fleet run's JSONL event+metrics log")
    ap.add_argument("--probe-every", type=int, default=None, metavar="N",
                    help="dispatch per-chip ABFT probes every N fused decode "
                         "dispatches and score chip health")
    ap.add_argument("--health-out", default=None, metavar="FILE",
                    help="write the per-chip health + alert summary JSON (needs --probe-every)")
    args = ap.parse_args(argv)
    if args.health_out and not args.probe_every:
        ap.error("--health-out needs --probe-every")
    if args.chips < 1:
        ap.error("--chips must be >= 1")

    import torch

    from repro_torch.configs import get_arch, reduce_config
    from repro_torch.core import from_fault_map, healthy, random_fault_map
    from repro_torch.core.masking import mask_selected_params
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.device import resolve_device
    from repro_torch.fleet import ShardedFleetServeEngine
    from repro_torch.models import model as M
    from repro_torch.serve import ContinuousBatchingEngine, Request
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    stream = TokenStream(cfg.vocab_size, 32, 8, seed=2, noise=0.02, device=dev)
    params = M.param_dict(M.init_params(cfg, args.seed, device=dev))
    ocfg = AdamWConfig(learning_rate=3e-3)
    train = make_train_step(cfg, ocfg, remat="none")

    t0 = time.perf_counter()
    opt = adamw_init(params, ocfg)
    for i in range(args.pretrain_steps):
        params, opt, _ = train(params, opt, stream.batch_at(i), healthy())

    # one quick FAT pass per chip, shipping masked weights. Chip 0 stays
    # healthy to show a mixed fleet: a zero-fault map, so it and its own
    # engine serve through the same masked-GEMM kernel as the others
    chips = []
    for c in range(args.chips):
        if c == 0:
            fm = random_fault_map(0, cfg.array_rows, cfg.array_cols, 0.0, chip_id="edge-0")
            chips.append((params, from_fault_map(fm, mode=args.fault_mode, device=dev), 0.0))
            continue
        fm = random_fault_map(c, cfg.array_rows, cfg.array_cols, 0.1 + 0.05 * c, chip_id=f"edge-{c}")
        train_ctx = from_fault_map(fm, mode="fap", device=dev)
        p, o = params, adamw_init(params, ocfg)
        for i in range(args.fat_steps):
            p, o, _ = train(p, o, stream.batch_at(500 + i), train_ctx)
        chips.append((mask_selected_params(p, train_ctx), from_fault_map(fm, mode=args.fault_mode, device=dev),
                      fm.fault_rate))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"training: {args.pretrain_steps} pretrain + {args.fat_steps} FAT steps x "
          f"{args.chips - 1} faulty chips in {time.perf_counter() - t0:.2f}s on {dev}")

    # each chip gets its OWN traffic: different lengths, budgets, arrivals
    def stream_for(c: int) -> list:
        tok = lambda i, n: stream.batch_at(60 + 10 * c + i)["tokens"][0, :n].cpu().numpy()
        return [
            Request(0, tok(0, 8 + 2 * c), max_new_tokens=4 + 3 * c),
            Request(1, tok(1, 12), max_new_tokens=max(1, 16 - 2 * c)),
            Request(2, tok(2, 6), max_new_tokens=6, arrival=2 + c),
            Request(3, tok(3, 10), max_new_tokens=8, arrival=4),
        ]

    streams = [stream_for(c) for c in range(args.chips)]
    rec = None
    if args.trace_out or args.metrics_out or args.health_out:
        from repro_torch.obs import Recorder

        rec = Recorder()
    alert_rules = None
    if args.probe_every:
        from repro_torch.obs import default_slo_rules

        alert_rules = default_slo_rules()
    kw = dict(num_slots=2, page_size=8, num_pages=64)
    t0 = time.perf_counter()
    fleet_eng = ShardedFleetServeEngine(
        cfg, [p for p, _, _ in chips], [c for _, c, _ in chips], devices=[dev], recorder=rec,
        probe_every=args.probe_every, alert_rules=alert_rules, **kw,
    )
    outs, stats = fleet_eng.serve(streams)
    t_fleet = time.perf_counter() - t0
    print(
        f"fleet engine: {len(chips)} chips on {len(fleet_eng.devices)} device(s) served "
        f"{stats.emitted_tokens} tokens across {stats.admitted} ragged requests in "
        f"{stats.decode_dispatches} fused dispatches / {t_fleet:.2f}s "
        f"(slot utilization {stats.slot_utilization:.0%})"
    )

    def near_tie(p, ctx, prompt, own, fleet):
        """Where the fleet's tokens first part from the chip's own engine's,
        the gap of the two chosen tokens' logits there, teacher-forced
        through the chip's path on its own engine's sequence, and the
        largest gap that counts as a tie: 1e-3 in float32; in bfloat16,
        whose logits carry 8 significant bits, 4 units in the last place of
        the larger logit. The chip-batched kernel may split K otherwise than
        one chip's launch, so a near-tie may fall the other way."""
        i = int(np.flatnonzero(own != fleet)[0])
        seq = np.concatenate([prompt, own[:i]]).astype(np.int64)
        with torch.no_grad():
            logits = M.forward(p, {"tokens": torch.as_tensor(seq[None], device=dev)}, cfg, ctx,
                               attn_impl="dense")[0][0, -1].float()
        a, b = float(logits[int(own[i])]), float(logits[int(fleet[i])])
        tie = 1e-3 if cfg.dtype == "float32" else 4 * 2.0 ** (np.floor(np.log2(max(abs(a), abs(b)))) - 7)
        return abs(a - b), tie

    t0 = time.perf_counter()
    per_chip_dispatches, ties = 0, []
    for c, (p, ctx, _) in enumerate(chips):
        ref, ref_stats = ContinuousBatchingEngine(cfg, p, ctx, **kw).serve(streams[c])
        per_chip_dispatches += ref_stats.decode_dispatches
        for rid, out in ref.items():
            if np.array_equal(outs[c][rid].tokens, out.tokens):
                continue
            gap, tie = near_tie(p, ctx, out.prompt, out.tokens, outs[c][rid].tokens)
            if gap > tie:
                raise SystemExit(f"chip {c} request {rid}: the fleet's tokens differ from its own engine's "
                                 f"where their logits are {gap:.3g} apart (a tie is within {tie:.3g})")
            ties.append((c, rid))
    t_serial = time.perf_counter() - t0
    print(
        f"per-chip engines: {per_chip_dispatches} dispatches / {t_serial:.2f}s; fleet output "
        f"matches token for token{f' but for near-ties in (chip, request) {ties}' if ties else ''}; "
        f"{per_chip_dispatches / stats.decode_dispatches:.2f}x dispatch amortization"
    )
    for c, (_, _, rate) in enumerate(chips):
        lead = outs[c][0]
        health = f" health={fleet_eng.health.state(c)}" if fleet_eng.health is not None else ""
        print(f"  chip {c}: fault_rate={rate:.2f} requests={len(outs[c])} "
              f"ttft(rid0)={lead.ttft} continuation={lead.tokens.tolist()}{health}")
    if args.probe_every:
        print(f"probes: {stats.probe_dispatches} dispatches (every {args.probe_every} fused steps), "
              f"detections={fleet_eng.health.detections}, alerts firing="
              f"{fleet_eng.alerts.firing() if fleet_eng.alerts else []}")
    if args.health_out:
        with open(args.health_out, "w") as f:
            json.dump(dict(health=fleet_eng.health.summary(),
                           alerts=fleet_eng.alerts.summary() if fleet_eng.alerts else None), f, indent=2)
        print(f"health: {args.health_out}")
    if args.trace_out:
        from repro_torch.obs import write_chrome_trace

        tr = write_chrome_trace(args.trace_out, rec)
        print(f"trace: {args.trace_out} ({len(tr['traceEvents'])} events, one Perfetto lane per chip slot)")
    if args.metrics_out:
        from repro_torch.obs import write_jsonl

        write_jsonl(args.metrics_out, rec)
        print(f"metrics: {args.metrics_out} ({len(rec.event_list())} events, "
              f"recorder self time {rec.self_time_s * 1e3:.2f} ms)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
