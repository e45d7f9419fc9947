"""Serving launcher CLI: batched generation with an optional fault map.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --fault-rate 0.1 --fault-mode kernel --batch 4 --new-tokens 16

``--arch`` is any registered decoder (an encoder, hubert-xlarge, has no
decode path and is refused).

``--continuous`` serves the same prompts as a request stream through the
continuous-batching engine (paged KV cache, per-request budgets skewed
around --new-tokens, an attention family only) instead of one static
batch. With ``--trace-out`` / ``--metrics-out`` the continuous run records
its request lifecycle (``repro_torch.obs``) and writes a Chrome trace /
JSONL event+metrics log. ``--probe-every N`` turns on the online
fault-detection stack (ABFT checksum/canary probes + health scoring + SLO
alerts) and ``--health-out`` saves its summary JSON:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --fault-rate 0.1 --fault-mode kernel --continuous --warmup --probe-every 8

Runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path on the
host (with ``--reduced`` for a tiny model).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--fault-rate", type=float, default=0.0)
    ap.add_argument("--fault-mode", choices=("fap", "kernel"), default="fap",
                    help="fap: plain PyTorch masking; kernel: the masked-GEMM CUDA kernel")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching (paged KV, skewed budgets)")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--buckets", type=int, nargs="+", default=None, metavar="W",
                    help="prefill bucket ladder (default 32 64 128 256); "
                         "pass 0 to disable bucketing (exact-length prefill)")
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="chunked-prefill width for prompts past the top "
                         "bucket (default: the top bucket)")
    ap.add_argument("--max-pack", type=int, default=4,
                    help="max short prompts packed into one bucket dispatch")
    ap.add_argument("--warmup", action="store_true",
                    help="run every (bucket, chunk, decode) program once "
                         "before serving (continuous engine only)")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write the run's Chrome trace (continuous only)")
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="write the run's JSONL event+metrics log "
                         "(continuous only)")
    ap.add_argument("--probe-every", type=int, default=None, metavar="N",
                    help="run an ABFT checksum/canary probe every N decode "
                         "dispatches and score chip health (continuous only)")
    ap.add_argument("--health-out", default=None, metavar="FILE",
                    help="write the health + alert summary JSON "
                         "(needs --probe-every)")
    args = ap.parse_args(argv)
    if args.health_out and not args.probe_every:
        ap.error("--health-out needs --probe-every")

    import torch

    from repro_torch.configs import get_arch, reduce_config
    from repro_torch.core import from_fault_map, healthy, random_fault_map
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    if cfg.is_encoder:
        raise SystemExit("encoder-only arch has no decode path")
    params = M.init_params(cfg, 0, device=dev)
    ctx = healthy()
    if args.fault_rate > 0:
        fm = random_fault_map(0, cfg.array_rows, cfg.array_cols, args.fault_rate)
        ctx = from_fault_map(fm, mode=args.fault_mode, device=dev)
        print(f"fault map rate={fm.fault_rate:.3f} mode={args.fault_mode}")

    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen, device=dev
    )
    if args.continuous:
        _serve_continuous(args, cfg, params, ctx, prompts)
        return
    engine = ServeEngine(cfg, params, ctx, max_len=args.max_len)
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=args.new_tokens, temperature=args.temperature)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"{args.batch}x{args.new_tokens} tokens in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s on {dev})")
    for i in range(min(2, args.batch)):
        print(f"seq{i}: {out.tokens[i, args.prompt_len:].tolist()}")


def _serve_continuous(args, cfg, params, ctx, prompts) -> None:
    import json

    from repro_torch.obs import (
        Recorder,
        default_slo_rules,
        write_chrome_trace,
        write_jsonl,
    )
    from repro_torch.serve import ContinuousBatchingEngine, Request
    from repro_torch.serve.bucketing import DEFAULT_PREFILL_BUCKETS

    budgets = [max(1, args.new_tokens // (4 if i % 2 else 1)) for i in range(args.batch)]
    host = prompts.cpu().numpy()
    reqs = [
        Request(i, host[i], max_new_tokens=budgets[i], arrival=i % 3) for i in range(args.batch)
    ]
    buckets = (
        None if args.buckets == [0]
        else tuple(args.buckets) if args.buckets else DEFAULT_PREFILL_BUCKETS
    )
    rec = Recorder() if (args.trace_out or args.metrics_out or args.health_out) else None
    eng = ContinuousBatchingEngine(
        cfg, params, ctx, num_slots=args.slots, prefill_buckets=buckets,
        chunk_size=args.chunk_size, max_pack=args.max_pack, recorder=rec,
        probe_every=args.probe_every,
        alert_rules=default_slo_rules() if args.probe_every else None,
    )
    if args.warmup:
        t0 = time.perf_counter()
        n = eng.warmup()
        print(f"warmup: {n} programs in {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    outs, stats = eng.serve(reqs, temperature=args.temperature)
    dt = time.perf_counter() - t0
    cc = eng.compile_counts()
    print(
        f"{stats.emitted_tokens} tokens over {args.batch} requests in "
        f"{stats.decode_dispatches} dispatches / {dt:.2f}s "
        f"({stats.emitted_tokens / dt:.1f} tok/s on {eng.device}, "
        f"slot util {stats.slot_utilization:.0%}, "
        f"peak KV {stats.peak_resident_kv_bytes} B, "
        f"programs warmed={cc['aot']} first run in traffic={cc['jit_fallback']})"
    )
    for i in range(min(2, args.batch)):
        o = outs[i]
        print(f"req{i}: ttft={o.ttft} qwait={o.queue_wait_steps} {o.tokens.tolist()}")
    if args.probe_every:
        print(
            f"probes: {stats.probe_dispatches} dispatches "
            f"(every {args.probe_every}), health={eng.health.state(0)}, "
            f"alerts firing={eng.alerts.firing() if eng.alerts else []}"
        )
    if args.health_out:
        with open(args.health_out, "w") as f:
            json.dump(dict(
                health=eng.health.summary(),
                alerts=eng.alerts.summary() if eng.alerts else None,
            ), f, indent=2)
        print(f"health: {args.health_out}")
    if args.trace_out:
        t = write_chrome_trace(args.trace_out, rec)
        print(f"trace: {args.trace_out} ({len(t['traceEvents'])} events)")
    if args.metrics_out:
        write_jsonl(args.metrics_out, rec)
        print(f"metrics: {args.metrics_out} "
              f"({len(rec.event_list())} events, "
              f"self time {rec.self_time_s * 1e3:.2f} ms)")


if __name__ == "__main__":
    main()
