"""Serve a faulty chip's fault-aware model with continuous batching.

The deployment half of the eFAT story as a *request stream*, the way a
serving chip sees traffic: requests with mixed prompt lengths, mixed
generation budgets and staggered arrival times flow through a
continuous-batching engine (paged KV cache and slot table) on the chip they
were tuned for, and the static rectangular-batch engine serves the same
requests one at a time for comparison: the tokens must match, and the
example counts the dispatches and the KV bytes each engine holds.

    PYTHONPATH=src python -m repro_torch.examples.serve_faulty_chip [--device cpu] \
        [--fault-mode kernel]

It pretrains a reduced Qwen3 on the synthetic token stream, runs FAT for one
chip (``fap``: the masked-GEMM kernel has no backward) and ships the weights
masked once (``mask_params``); serving runs in ``--fault-mode`` (default
``kernel``: the masked-GEMM kernel on the card, its plain version on the
host). Runs on the CUDA card unless ``--device cpu`` asks for the host. On
the card a token may part from the static engine's only at a near-tie
(``TIE``): the kernels split K by the batch's shape, and the two engines'
batches differ.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduce_config
from repro_torch.core import from_fault_map, healthy, random_fault_map
from repro_torch.core.masking import mask_params
from repro_torch.data.synthetic import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve import ContinuousBatchingEngine, Request, ServeEngine, dense_kv_bytes
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.step import make_eval_step, make_train_step

PRETRAIN_STEPS = 120
FAT_STEPS = 60
TIE = 1e-3  # float32 logits closer than this may fall either way on the card


def _near_tie(cfg, params, ctx, prompt, static, continuous) -> float:
    """The gap of the two engines' tokens' logits where they first part,
    teacher-forced through the chip's path on the static engine's
    sequence."""
    i = int(np.flatnonzero(static != continuous)[0])
    seq = torch.as_tensor(np.concatenate([prompt, static[:i]]).astype(np.int64)[None],
                          device=next(iter(M.param_dict(params).values())).device)
    with torch.no_grad():
        logits = M.forward(params, {"tokens": seq}, cfg, ctx, attn_impl="dense")[0][0, -1].float()
    return abs(float(logits[int(static[i])] - logits[int(continuous[i])]))


def run(device=None, fault_mode: str = "kernel", pretrain_steps: int = PRETRAIN_STEPS,
        fat_steps: int = FAT_STEPS, log=print) -> dict:
    """The example's sequence; returns the deployed accuracy, the continuous
    engine's outputs and stats, and the static engine's tokens, dispatches
    and peak KV bytes."""
    dev = resolve_device(device)
    cfg = reduce_config(get_arch("qwen3-0.6b"))
    stream = TokenStream(cfg.vocab_size, 32, 8, seed=2, noise=0.02, device=dev)
    params = M.param_dict(M.init_params(cfg, 0, device=dev))
    ocfg = AdamWConfig(learning_rate=3e-3)
    train = make_train_step(cfg, ocfg, remat="none")
    evaluate = make_eval_step(cfg, remat="none")

    opt = adamw_init(params, ocfg)
    for i in range(pretrain_steps):
        params, opt, _ = train(params, opt, stream.batch_at(i), healthy())

    fm = random_fault_map(3, cfg.array_rows, cfg.array_cols, 0.2, chip_id="edge-3")
    train_ctx = from_fault_map(fm, "fap", device=dev)
    # FAT for this chip, then ship FAP-masked weights
    opt = adamw_init(params, ocfg)
    for i in range(fat_steps):
        params, opt, _ = train(params, opt, stream.batch_at(500 + i), train_ctx)
    shipped = mask_params(params, train_ctx)
    ctx = from_fault_map(fm, fault_mode, device=dev)

    acc = float(evaluate(shipped, stream.batch_at(10_000_001), ctx)["accuracy"])
    log(f"chip {fm.chip_id}: fault rate {fm.fault_rate:.2f}, deployed acc {acc:.3f} ({fault_mode} mode on {dev})")

    # --- the request stream: mixed lengths, mixed budgets, staggered arrivals
    tok = lambda i, n: stream.batch_at(40 + i)["tokens"][0, :n].cpu().numpy()
    requests = [
        Request(0, tok(0, 16), max_new_tokens=4),
        Request(1, tok(1, 12), max_new_tokens=24),
        Request(2, tok(2, 8), max_new_tokens=6, arrival=2),
        Request(3, tok(3, 20), max_new_tokens=8, arrival=4),
        Request(4, tok(4, 6), max_new_tokens=16, arrival=4),
        Request(5, tok(5, 10), max_new_tokens=5, arrival=9),
    ]

    engine = ContinuousBatchingEngine(cfg, shipped, ctx, num_slots=2, page_size=8, num_pages=64)
    t0 = time.perf_counter()
    outs, stats = engine.serve(requests)
    dt = time.perf_counter() - t0
    log(f"continuous: {stats.emitted_tokens} tokens over {len(requests)} requests in "
        f"{stats.decode_dispatches} decode dispatches ({stats.emitted_tokens / dt:.0f} tok/s, "
        f"slot utilization {stats.slot_utilization:.0%}, peak KV {stats.peak_resident_kv_bytes} B)")
    for r in requests:
        o = outs[r.rid]
        log(f"  rid {r.rid}: prompt {len(r.tokens)} arrival {r.arrival} ttft {o.ttft} "
            f"finished@{o.finished_step} ({o.finish_reason}) -> {o.tokens[:8].tolist()}"
            f"{'...' if len(o.tokens) > 8 else ''}")

    # --- the static engine on the same requests: one padded-horizon batch per
    # request (rectangular batches cannot mix lengths), tokens pinned
    static = ServeEngine(cfg, shipped, ctx, max_len=None, page_size=8)
    dispatches, kv, ties, static_tokens = 0, 0, [], {}
    for r in requests:
        ref = static.generate(torch.as_tensor(r.tokens, device=dev)[None], max_new_tokens=r.max_new_tokens)
        static_tokens[r.rid] = want = ref.tokens[0, len(r.tokens):].cpu().numpy()
        got = outs[r.rid].tokens
        if not np.array_equal(got, want):
            gap = _near_tie(cfg, shipped, ctx, r.tokens, want, got) if dev.type == "cuda" else None
            if gap is None or gap > TIE:
                raise SystemExit(f"request {r.rid}: the continuous engine's tokens {got.tolist()} differ from the "
                                 f"static engine's {want.tolist()}"
                                 + ("" if gap is None else f" where their logits are {gap:.3g} apart"))
            ties.append(r.rid)
        dispatches += r.max_new_tokens
        kv = max(kv, dense_kv_bytes(cfg, 1, static.cache_len_for(len(r.tokens), r.max_new_tokens)))
    log(f"static (per-request, tokens pinned{f' but for near-ties in requests {ties}' if ties else ''}): "
        f"{dispatches} dispatches vs {stats.decode_dispatches} continuous, peak KV {kv} B vs "
        f"{stats.peak_resident_kv_bytes} B; continuous packs {len(requests)} ragged requests into 2 slots "
        f"with identical outputs")
    return dict(accuracy=acc, outputs=outs, stats=stats, static_tokens=static_tokens,
                static_dispatches=dispatches, static_peak_kv_bytes=kv, ties=ties)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--fault-mode", choices=("fap", "kernel"), default="kernel")
    args = ap.parse_args(argv)
    run(args.device, args.fault_mode)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
