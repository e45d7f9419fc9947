"""Training launcher CLI.

Runs (or resumes) fault-aware training of a registered arch on one device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 100 --fault-rate 0.1 --ckpt-dir build/ckpt

The flags are the reference's, plus ``--device`` (default: the CUDA card;
``--device cpu`` trains on the host, with ``--reduced`` for a tiny model).
A run stopped part way (an interrupt, a preemption) resumes from its last
checkpoint when the same command is run again, and follows the straight run.
``--moe-impl`` picks an MoE model's dispatch (``models/moe.py``).
``main(argv)`` returns the final (params, opt_state, LoopState).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="CPU-scale config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--fault-rate", type=float, default=0.0)
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--moe-impl", default="einsum", choices=["einsum", "scatter"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch, reduce_config
    from repro_torch.core import from_fault_map, healthy, random_fault_map
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.train.loop import LoopConfig, run_training
    from repro_torch.train.optimizer import AdamWConfig, adamw_init, cosine_schedule
    from repro_torch.train.step import make_eval_step, make_jit_train_step

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    params = M.param_dict(M.init_params(cfg, 0, device=dev))
    print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"params={sum(p.numel() for p in params.values())/1e6:.1f}M")

    stream = TokenStream(cfg.vocab_size, args.seq, args.batch, seed=0, device=dev)
    ocfg = AdamWConfig(
        learning_rate=cosine_schedule(args.lr, warmup=20, total=args.steps)
    )
    train_step = make_jit_train_step(
        cfg, ocfg, moe_impl=args.moe_impl, remat="none", microbatches=args.microbatches
    )
    eval_step = make_eval_step(cfg, moe_impl=args.moe_impl, remat="none")
    opt = adamw_init(params, ocfg)

    ctx = healthy()
    if args.fault_rate > 0:
        fm = random_fault_map(
            args.fault_seed, cfg.array_rows, cfg.array_cols, args.fault_rate
        )
        ctx = from_fault_map(fm, device=dev)
        print(f"fault map: rate={fm.fault_rate:.3f} ({fm.num_faults} faulty PEs)")

    eval_batch = stream.batch_at(10_000_000)

    def eval_fn(p):
        return eval_step(p, eval_batch, ctx)

    def on_metrics(step, m):
        keys = ("loss", "accuracy", "eval_loss", "eval_accuracy", "grad_norm", "step_time_s")
        line = " ".join(f"{k}={m[k]:.4f}" for k in keys if k in m)
        print(f"step {step}: {line}", flush=True)

    lc = LoopConfig(
        total_steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        eval_every=args.eval_every,
        log_every=10,
    )
    t0 = time.time()
    params, opt, state = run_training(
        lc, train_step=train_step, batch_at=stream.batch_at,
        params=params, opt_state=opt, ctx=ctx,
        eval_fn=eval_fn, on_metrics=on_metrics,
    )
    print(f"done: {state.step} steps in {time.time()-t0:.1f}s, "
          f"restarts={state.restarts}, stragglers={len(state.straggler_events)}")
    return params, opt, state


if __name__ == "__main__":
    main()
