"""Serving launcher CLI: batched generation with an optional fault map.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --fault-rate 0.1 --fault-mode kernel --batch 4 --new-tokens 16

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
    args = ap.parse_args(argv)

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


if __name__ == "__main__":
    main()
