"""Quickstart: fault-aware training (FAT) of a small LM for one faulty chip.

1. Pre-train a reduced SmolLM on the synthetic token stream: the
   "user-provided pre-trained DNN" of the paper's pipeline.
2. Inject a permanent-fault map into the accelerator's systolic array.
3. Observe the accuracy drop, run FAT, observe recovery.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu] \
        [--fault-mode kernel]

Training runs the plain masked product (``fap``: the masked-GEMM kernel has
no backward); each evaluation of the faulty chip runs in ``--fault-mode``
(default ``kernel``: the masked-GEMM kernel on the card, its plain version
on the host). Runs on the CUDA card unless ``--device cpu`` asks for the
host.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch, reduce_config
from repro_torch.core import from_fault_map, healthy, random_fault_map
from repro_torch.data.synthetic import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.step import make_eval_step, make_train_step

PRETRAIN_STEPS = 150
FAT_STEPS = 80


def run(device=None, fault_mode: str = "kernel", pretrain_steps: int = PRETRAIN_STEPS,
        fat_steps: int = FAT_STEPS, log=print) -> dict:
    """The quickstart's sequence; returns each training step's metrics
    (``pretrain``, ``fat``: lists of {loss, accuracy}) and the evaluations
    (``acc0`` healthy after pretraining, ``acc_faulty`` on the faulty chip,
    ``acc_fat`` on it after FAT)."""
    dev = resolve_device(device)
    cfg = reduce_config(get_arch("smollm-135m"))
    log(f"arch: {cfg.name} (reduced: {cfg.num_layers}L d={cfg.d_model}) on {dev}")
    log(f"systolic array: {cfg.array_rows}x{cfg.array_cols}")

    stream = TokenStream(cfg.vocab_size, seq_len=32, batch_size=8, seed=1, noise=0.02, device=dev)
    params = M.param_dict(M.init_params(cfg, 0, device=dev))
    ocfg = AdamWConfig(learning_rate=3e-3)
    train = make_train_step(cfg, ocfg, remat="none")
    evaluate = make_eval_step(cfg, remat="none")
    eval_batch = stream.batch_at(10_000_000)
    out = dict(pretrain=[], fat=[])

    def metrics(m):
        return {k: float(v) for k, v in m.items()}

    # 1) pre-train healthy
    opt = adamw_init(params, ocfg)
    t0 = time.perf_counter()
    for i in range(pretrain_steps):
        params, opt, m = train(params, opt, stream.batch_at(i), healthy())
        out["pretrain"].append(metrics(m))
    out["acc0"] = acc0 = float(evaluate(params, eval_batch, healthy())["accuracy"])
    log(f"[pretrain] acc={acc0:.3f}  ({time.perf_counter() - t0:.1f}s)")

    # 2) a chip comes back from the fab with permanent faults
    fm = random_fault_map(7, cfg.array_rows, cfg.array_cols, fault_rate=0.25, chip_id="chip-7")
    train_ctx = from_fault_map(fm, "fap", device=dev)
    chip_ctx = from_fault_map(fm, fault_mode, device=dev)
    out["acc_faulty"] = acc_f = float(evaluate(params, eval_batch, chip_ctx)["accuracy"])
    log(f"[faulty  ] chip {fm.chip_id}: rate={fm.fault_rate:.2f} acc={acc_f:.3f} "
        f"(drop {acc0 - acc_f:+.3f}; {fault_mode} mode)")

    # 3) FAT: retrain WITH the fault mask applied
    opt = adamw_init(params, ocfg)
    for i in range(fat_steps):
        params, opt, m = train(params, opt, stream.batch_at(1000 + i), train_ctx)
        out["fat"].append(metrics(m))
    out["acc_fat"] = acc_fat = float(evaluate(params, eval_batch, chip_ctx)["accuracy"])
    log(f"[FAT     ] acc={acc_fat:.3f} (recovered {acc_fat - acc_f:+.3f})")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--fault-mode", choices=("fap", "kernel"), default="kernel",
                    help="the faulty chip's evaluations (training runs fap)")
    args = ap.parse_args(argv)
    run(args.device, args.fault_mode)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
