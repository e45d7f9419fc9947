#!/usr/bin/env python3
"""Does stage (d) of ``chip_smoke.py``'s phase 14 see a fleet kernel that
reads another chip's data, and does phase 12's tensor-parallel gate see a
weight piece masked under the wrong map? One planted fault per run, on one
CUDA card.

    python3 tools/planted_faults.py mask      # hymba-1.5b: chip 1 reads chip 0's mask
    python3 tools/planted_faults.py scan      # hymba-1.5b: every scan row reads chip 0's A and D
    python3 tools/planted_faults.py experts   # mixtral-8x22b: chip 1's experts read chip 0's weights
    python3 tools/planted_faults.py roll      # smollm-135m, compute="sharded": every piece under the unrolled map
    python3 tools/planted_faults.py bwd       # falcon-mamba-7b: the scan's backward reads h_t for h_{t-1}

Each run copies ``src/`` and ``chip_smoke.py`` into ``build/planted-<fault>``
(the built kernels too, so nothing is compiled again), plants the fault in
the copy's Python, and runs there ``chip_smoke.fleet_families`` for the
fault's family alone, or for ``roll`` ``chip_smoke.lm_tp_parity`` on two
chips of float32 SmolLM-135M at full width (random weights from seeds 0
and 1) split as a 2 x ``LM_TP_MODEL`` mesh's rules split them, or for
``bwd`` (a fault in the CUDA source, built again in the copy)
``chip_smoke.ssm_grad_gate`` on one full-width falcon-mamba-7b layer
(random weights from seed 0). The tree itself is never changed. ``mask`` and
``scan`` turn the serving gates that come before the one under test into
log lines (``mask``: the chip-0 and anchor gates, so that the near-tie rule
reads the fault; ``scan``: all three, so that the per-chip scan check reads
it). The last lines say which gate stopped the run and what it read; a run
that passes prints ``the fault did not show`` and exits 1.

It needs a card (and ``nvcc`` unless ``build/kernels`` holds the kernels),
and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OPS_MM = "src/repro_torch/kernels/masked_matmul/ops.py"
OPS_SCAN = "src/repro_torch/kernels/mamba_scan/ops.py"
MASKING = "src/repro_torch/core/masking.py"
SCAN_BWD = "src/repro_torch/kernels/csrc/selective_scan_bwd.cu"
# a serving gate of fleet_families, and the same check made a log line
GATES = {
    "chip 0": ('raise Failed(f"fleet (d) {c.name}: chip {i} (rate', 'log(f"(planted) fleet (d) {c.name}: chip {i} (rate'),
    "anchor": ('raise Failed(f"fleet (d) {c.name} chip {i}: served', 'log(f"(planted) fleet (d) {c.name} chip {i}: served'),
    "near-tie": ('raise Failed(f"fleet (d) {c.name}: tokens part', 'log(f"(planted) fleet (d) {c.name}: tokens part'),
}
# fault: (family, [(file, text, planted text)], gates made log lines)
FAULTS = {
    "mask": ("hymba-1.5b", [(OPS_MM, "    return masked_matmul(x, w, ok.contiguous(), variant=variant), 0\n",
                             "    ok = ok.contiguous().clone()\n    ok[1] = ok[0]\n"
                             "    return masked_matmul(x, w, ok, variant=variant), 0\n")],
             ("chip 0", "anchor")),
    "scan": ("hymba-1.5b", [(OPS_SCAN, "    sa, sd = (a.stride(0), d.stride(0)) if lead else (0, 0)\n",
                             "    sa, sd = 0, 0\n")],
             ("chip 0", "anchor", "near-tie")),
    "experts": ("mixtral-8x22b", [(OPS_MM, "    kdim, n = w.shape[-2:]\n    chips = math.prod(lead_w)\n",
                                   "    if w.dim() == 4:\n        w = w[:1].expand_as(w).contiguous()\n"
                                   "    kdim, n = w.shape[-2:]\n    chips = math.prod(lead_w)\n")],
                ()),
    "roll": ("smollm-135m", [(MASKING, "    key = (r0 % rows, c0 % cols)\n", "    key = (0, 0)\n")], ()),
    "bwd": ("falcon-mamba-7b", [(SCAN_BWD, "      get<S>(hp, hs + j * NT * S, tid);  // h_{t-1}",
                                 "      get<S>(hp, hs + (j + 1) * NT * S, tid);  // h_t")], ()),
}

RUN = """
import sys, time, torch
sys.path.insert(0, "src")
import chip_smoke
chip_smoke.FLEET_FAMILIES = tuple(f for f in chip_smoke.FLEET_FAMILIES if f[0] == {family!r})
t0 = time.perf_counter()
try:
    chip_smoke.fleet_families(torch, print, chip_smoke.card_line())
except chip_smoke.Failed as e:
    print("planted {fault}: stage (d) failed:", e)
    print("seconds", time.perf_counter() - t0)
    sys.exit(0)
print("planted {fault}: stage (d) passed: the fault did not show")
sys.exit(1)
"""

RUN_ROLL = """
import dataclasses, sys, time, torch
sys.path.insert(0, "src")
import chip_smoke
from repro_torch.configs import get_arch
from repro_torch.core import random_fault_map
from repro_torch.launch.mesh import make_fleet_mesh
from repro_torch.models import model as M
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.population import make_fat_engine
torch.backends.cuda.matmul.allow_tf32 = False
cfg = dataclasses.replace(get_arch({family!r}), dtype="float32")
params = [M.param_dict(M.init_params(cfg, seed, device="cuda")) for seed in (0, 1)]
model = chip_smoke.LM_TP_MODEL
eng = make_fat_engine("sharded", mesh=make_fleet_mesh(2, model, devices=["cuda"] * 2 * model), cfg=cfg,
                      param_axes=M.param_specs(cfg), compute="sharded", loss_fn=None, opt_cfg=AdamWConfig(),
                      eval_batches=[])
oks = [torch.as_tensor(random_fault_map(c, 256, 256, 0.05 * (c + 1)).ok_mask, dtype=torch.float32, device="cuda")
       for c in range(2)]
t0 = time.perf_counter()
try:
    chip_smoke.lm_tp_parity(torch, print, cfg, params, oks, eng)
except chip_smoke.Failed as e:
    print("planted {fault}: phase 12's tensor-parallel gate failed:", e)
    print("seconds", time.perf_counter() - t0)
    sys.exit(0)
print("planted {fault}: phase 12's tensor-parallel gate passed: the fault did not show")
sys.exit(1)
"""


RUN_BWD = """
import dataclasses, sys, time, torch
sys.path.insert(0, "src")
import chip_smoke
from repro_torch.configs import get_arch
from repro_torch.core import random_fault_map
from repro_torch.models import model as M
torch.backends.cuda.matmul.allow_tf32 = False
cfg = dataclasses.replace(get_arch({family!r}), num_layers=1, dtype="float32", param_dtype="float32")
flat = M.param_dict(M.init_params(cfg, 0, device="cuda"))
lp = {{k.rsplit(".", 1)[-1]: v for k, v in flat.items() if k.startswith("layers.0.ssm.")}}
t0 = time.perf_counter()
try:
    chip_smoke.ssm_grad_gate(torch, print, cfg, lp, random_fault_map(0, 256, 256, 0.05))
except chip_smoke.Failed as e:
    print("planted {fault}: phase 12's gradient gate failed:", e)
    print("seconds", time.perf_counter() - t0)
    sys.exit(0)
print("planted {fault}: phase 12's gradient gate passed: the fault did not show")
sys.exit(1)
"""


def plant(fault: str) -> pathlib.Path:
    """The copy of the tree with ``fault`` planted; raises if a patched text
    is not found exactly once."""
    family, subs, gates = FAULTS[fault]
    dst = ROOT / "build" / f"planted-{fault}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src", dst / "src")
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    if (ROOT / "build" / "kernels").is_dir():
        shutil.copytree(ROOT / "build" / "kernels", dst / "build" / "kernels")
    for path, old, new in [*subs, *(("chip_smoke.py", *GATES[g]) for g in gates)]:
        p = dst / path
        text = p.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{path}: the text to patch is found {text.count(old)} times: {old!r}")
        p.write_text(text.replace(old, new))
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("fault", choices=sorted(FAULTS))
    fault = ap.parse_args().fault
    dst = plant(fault)
    code = {"roll": RUN_ROLL, "bwd": RUN_BWD}.get(fault, RUN).format(family=FAULTS[fault][0], fault=fault)
    return subprocess.run([sys.executable, "-c", code], cwd=dst).returncode


if __name__ == "__main__":
    sys.exit(main())
