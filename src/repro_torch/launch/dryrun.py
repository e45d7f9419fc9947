"""Multi-pod dry-run CLI.

Builds every runnable (arch x shape) cell on the reference's production
meshes, 16x16 (one pod, 256 chips) and 2x16x16 (two pods, 512 chips), over
the meta device, and records per cell the per-device bytes of params,
optimizer moments and cache under the layout rules and the FLOPs of one
step (products only, the whole global batch; ``launch/dryrun_lib.py``).
It sets no XLA flag and touches no card.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--fault-mode", type=str, default="fap", choices=["fap", "none", "kernel"])
    ap.add_argument("--moe-impl", type=str, default="einsum", choices=["einsum", "scatter"])
    ap.add_argument("--profile", type=str, default="baseline", choices=["baseline", "optimized"])
    ap.add_argument("--out", type=str, default="build/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import SHAPES, cell_skip_reason, get_arch, valid_cells
    from repro_torch.launch.dryrun_lib import run_cell

    if args.all:
        cells = valid_cells()
    else:
        if not args.arch:
            ap.error("--arch required without --all")
        shapes = [args.shape] if args.shape else [
            s for s in SHAPES if cell_skip_reason(get_arch(args.arch), SHAPES[s]) is None
        ]
        cells = [(args.arch.replace("-", "_").replace(".", "_"), s) for s in shapes]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for multi_pod in meshes:
        tag = "pod2" if multi_pod else "pod1"
        for arch, shape in cells:
            out_path = os.path.join(args.out, f"{arch}__{shape}__{tag}.json")
            if args.skip_existing and os.path.exists(out_path):
                try:
                    with open(out_path) as f:
                        if json.load(f).get("status") == "ok":
                            print(f"[skip] {arch} {shape} {tag} (cached)")
                            continue
                except (OSError, ValueError):
                    pass
            t0 = time.time()
            info = run_cell(
                arch, shape, multi_pod=multi_pod, fault_mode=args.fault_mode,
                moe_impl=args.moe_impl, profile=args.profile, out_dir=args.out,
            )
            dt = time.time() - t0
            if info["status"] == "ok":
                state = info.get("opt_bytes_per_device", info.get("cache_bytes_per_device", 0))
                print(
                    f"[ok]   {arch:28s} {shape:12s} {tag}  "
                    f"flops={info['flops_total']:.3e} (products, whole batch) "
                    f"params/dev={info['param_bytes_per_device']/1e9:.3f}GB "
                    f"{'opt' if info['kind'] == 'train' else 'cache'}/dev={state/1e9:.3f}GB "
                    f"[{dt:.0f}s]",
                    flush=True,
                )
            else:
                failures += 1
                print(f"[FAIL] {arch:28s} {shape:12s} {tag}  {info['error']}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
