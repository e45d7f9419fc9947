#!/usr/bin/env python3
"""Where the time of the selective-scan kernel goes, on one CUDA card.

    python3 tools/selective_scan_probe.py [--out build/selective_scan_probe.json]

1. The floor of the timing method: a one-element ``add_`` timed as the
   kernels are (CUDA events around one launch, the 50 MB L2 overwritten
   first).
2. The instructions of the inner loop: ``cuobjdump -sass`` of the built
   kernel, the loop that holds the exponentials of the plan's instance at
   each main shape, counted by opcode and divided by the (step, state)
   pairs one pass of it covers, so the binding pipe (SFU or FP32 and issue)
   can be read off.
3. The plan: at each shape of ``chip_smoke.py``'s scan rows (bf16 and
   float32 u), the kernel's time and its error against the plain version
   at every lane count a channel may take, the plan's own starred. Each
   run is held to the gates of ``chip_smoke.py``: h_last, and float32 y,
   at rtol 2e-5 / atol 1e-4; bf16 y at rtol 2e-2 and atol 1e-2 x RMS(y);
   and two launches must give the same bits.
4. Two variants of the kernel, each built from a copy of the source that
   this script patches into ``build/kernels``, timed at the plan's launch
   beside the kernel as built: ``ex2.approx`` of a pre-scaled argument in
   place of the precise ``expf`` (held to the same gates), and a
   diagnostic with no exponential at all (its results are wrong and not
   gated): what the exponentials cost.

It needs a card and ``nvcc``, and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# chip_smoke.py's scan rows: falcon-mamba's and hymba's serving prefills, their long prefills,
# a ragged case, a larger state and an odd one
SHAPES = [(4, 128, 8192, 16), (4, 128, 3200, 16), (4, 2048, 3200, 16), (4, 2048, 8192, 16),
          (2, 37, 11, 4), (2, 256, 1024, 64), (2, 100, 300, 17)]
F32_TOL = (2e-5, 1e-4)
# source patches of the variants: (text of the kernel as built, its replacement)
EXPF = "{ return expf(x); }"
A_LOAD = "ap[(long long)d * a.N + n]"
VARIANTS = {
    "ex2.approx": ((EXPF, '{ float y; asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x)); return y; }'),
                   (A_LOAD, A_LOAD + " * 1.4426950408889634f")),  # A pre-scaled by log2 e
    "no exp": ((EXPF, "{ return x; }"),),
}


def sass_loop_counts(sass: str, lanes: int, states: int) -> dict:
    """Opcode counts of the loop that holds the exponentials in the
    ``selective_scan_kernel<lanes, states>`` instance, per pass and per
    (step, state) pair of one lane."""
    funcs = re.split(r"\n\s*Function : ", sass)
    want = f"selective_scan_kernelILi{lanes}ELi{states}E"
    body = next((f for f in funcs if f.split("\n", 1)[0].strip().find(want) >= 0), None)
    if body is None:
        return {}
    instrs, labels = [], {}
    pending = []
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if not m:
            continue
        addr, text = int(m.group(1), 16), m.group(2).strip()
        for name in pending:
            labels[name] = addr
        pending = []
        instrs.append((addr, text))
    loops = []
    for addr, text in instrs:
        m = re.search(r"BRA\s+(?:`\()?(\.L_x_\d+|0x[0-9a-f]+)", text)
        if not m:
            continue
        tgt = m.group(1)
        target = labels.get(tgt) if tgt.startswith(".L") else int(tgt, 16)
        if target is not None and target < addr:
            loop = [t for a, t in instrs if target <= a <= addr]
            ex = sum("MUFU.EX2" in t for t in loop)
            if ex:
                loops.append((len(loop), ex, loop))
    if not loops:
        return {}
    _, ex, loop = min(loops, key=lambda x: (-x[1], x[0]))  # all the exps, the tightest loop
    ops = collections.Counter()
    for t in loop:
        op = re.sub(r"^@!?U?P\w+\s+", "", t).split()[0]
        ops[op.split(".")[0] if not op.startswith("MUFU") else op] += 1
    pairs = max(lanes, 8) * states  # one pass: max(lanes, 8) steps x `states` states of one lane
    return dict(instructions=len(loop), exps=ex, pairs_per_pass=pairs,
                per_pair=len(loop) / pairs, by_opcode=dict(ops.most_common()))


def build_variants(common, argtypes) -> dict:
    """Each variant's entry point, built in parallel from a patched copy of
    the kernel's source under ``build/kernels``."""
    src = (common.CSRC_DIR / "selective_scan.cu").read_text()
    procs = {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the source no longer holds {old!r} once")
            text = text.replace(old, new)
        tag = hashlib.sha1((text + " ".join(common.NVCC_FLAGS)).encode()).hexdigest()[:12]
        cu, lib = (common.BUILD_DIR / f"selective_scan_variant-{tag}{ext}" for ext in (".cu", ".so"))
        proc = None
        if not lib.exists():
            common.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            cu.write_text(text)
            proc = subprocess.Popen([common._nvcc(), *common.NVCC_FLAGS, "-o", str(lib), str(cu)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        procs[name] = (proc, lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        if proc is not None:
            out, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"variant {name} failed to build:\n{out.decode(errors='replace')}")
        fn = getattr(ctypes.CDLL(str(lib)), "selective_scan")
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "selective_scan_probe.json"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("selective_scan_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import common
    from repro_torch.kernels.mamba_scan import ops as sc

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    sms = common.sm_count(dev)
    from repro_torch.tune import TuningCache, set_tuning_cache

    set_tuning_cache(TuningCache())  # the wrappers' plans, not the committed table's tuned blocks
    logs = common.build_kernels(["selective_scan"])
    for line in logs.get("selective_scan", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    main_fn = common.load_kernel("selective_scan", sc._ARGTYPES)
    variant_fns = build_variants(common, sc._ARGTYPES)

    flush = torch.empty(2**28, dtype=torch.int32, device=dev)

    def time_ms(fn, reps=10):
        fn()
        times = []
        for _ in range(reps):
            flush.zero_()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    one = torch.zeros(1, device=dev)
    report = dict(card=card, floor_ms=time_ms(lambda: one.add_(1)), sass={}, sweep={}, variants={})
    print(f"floor: a one-element add_ {report['floor_ms']:.4f} ms", flush=True)

    # SASS of the main shapes' instances
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(common._lib_path("selective_scan"))],
                          capture_output=True, text=True).stdout
    res = subprocess.run([cuobjdump, "-res-usage", str(common._lib_path("selective_scan"))],
                         capture_output=True, text=True).stdout
    regs = {}
    for m in re.finditer(r"selective_scan_kernelILi(\d+)ELi(\d+)E\S*\s*\n\s*REG:(\d+)", res):
        regs[f"{m.group(1)}x{m.group(2)}"] = int(m.group(3))
    report["registers"] = regs
    print(f"registers by lanes x states: {regs}", flush=True)
    for lanes, states in sorted({(p.lanes, p.states) for p in (sc.scan_plan(b, d, n, sms) for b, _, d, n in SHAPES[:4])}
                                | {(8, 2), (4, 4), (16, 1), (2, 8)}):
        counts = sass_loop_counts(sass, lanes, states)
        report["sass"][f"{lanes}x{states}"] = counts
        if counts:
            top = ", ".join(f"{k} {v}" for k, v in list(counts["by_opcode"].items())[:12])
            print(f"sass {lanes} lanes x {states} states: loop of {counts['instructions']} instructions a pass "
                  f"of {counts['pairs_per_pass']} (step, state) pairs, {counts['exps']} MUFU.EX2, "
                  f"{counts['per_pair']:.2f} per (step, state) pair; {top}", flush=True)
        else:
            print(f"sass {lanes} lanes x {states} states: loop not found", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)

    def worst(got, ref, tol):
        rtol, atol = tol
        diff = (got.float() - ref.float()).abs()
        return float(diff.max()), bool((diff <= atol + rtol * ref.float().abs()).all())

    fails = []
    for u_dtype in (torch.bfloat16, torch.float32):
        for bsz, length, dim, n in SHAPES:
            u = torch.randn(bsz, length, dim, generator=gen, device=dev).to(u_dtype)
            dt = torch.nn.functional.softplus(torch.randn(bsz, length, dim, generator=gen, device=dev) - 3.0)
            a = -torch.exp(torch.randn(dim, n, generator=gen, device=dev))
            dbc = torch.randn(bsz, length, 8 + 2 * n, generator=gen, device=dev).to(u_dtype)
            _, bm, cm = torch.split(dbc, [8, n, n], dim=-1)
            d_skip = torch.randn(dim, generator=gen, device=dev)
            args_ = (u, dt, a, bm, cm, d_skip)
            ref_y, ref_h = sc.selective_scan_ref(*args_)
            y_tol = F32_TOL if u_dtype == torch.float32 else \
                (2e-2, 1e-2 * float(ref_y.float().pow(2).mean().sqrt()))
            plan = sc.scan_plan(bsz, dim, n, sms)
            key = f"{str(u_dtype)[6:]} {bsz}x{length}x{dim}x{n}"
            rows = {}
            for lanes in (1, 2, 4, 8, 16, 32):
                if sc._pow2_at_least(-(-n // lanes)) > sc.MAX_STATES_PER_LANE or (lanes > 1 and lanes // 2 >= n):
                    continue
                y, h = sc.selective_scan(*args_, lanes=lanes)
                torch.cuda.synchronize()
                p = sc.selective_scan.last_plan
                ye, yg = worst(y, ref_y, y_tol)
                he, hg = worst(h, ref_h, F32_TOL)
                again = sc.selective_scan(*args_, lanes=lanes)
                same = torch.equal(again[0], y) and torch.equal(again[1], h)
                ms = time_ms(lambda: sc.selective_scan(*args_, lanes=lanes))
                rows[f"{p.lanes}x{p.states}{'*' if p == plan else ''}"] = dict(
                    ms=ms, y_err=ye, h_err=he, within_gates=yg and hg, same_bits=same)
                if not (yg and hg and same):
                    fails.append(f"{key} {p.lanes}x{p.states}")
            report["sweep"][key] = dict(plan=plan._asdict(), rows=rows)
            print(f"sweep {key:24s}: " + "  ".join(
                f"{k}: {v['ms']:.4f} ms{'' if v['within_gates'] and v['same_bits'] else ' FAIL'}"
                for k, v in rows.items()), flush=True)

            # the variants at the plan's launch
            star = next(v for k, v in rows.items() if k.endswith("*"))
            vrows = {"as built": dict(ms=star["ms"], y_err=star["y_err"], h_err=star["h_err"],
                                      within_gates=star["within_gates"])}
            for name, fn in variant_fns.items():
                common._FNS["selective_scan"] = fn
                try:
                    y, h = sc.selective_scan(*args_)
                    torch.cuda.synchronize()
                    ye, yg = worst(y, ref_y, y_tol)
                    he, hg = worst(h, ref_h, F32_TOL)
                    ms = time_ms(lambda: sc.selective_scan(*args_))
                finally:
                    common._FNS["selective_scan"] = main_fn
                # the diagnostic computes no exponential: its results are not gated
                vrows[name] = dict(ms=ms, y_err=ye, h_err=he, within_gates=(yg and hg) if name != "no exp" else None)
            report["variants"][key] = vrows
            print(f"variants {key:24s} ({plan.lanes}x{plan.states}): " + "  ".join(
                f"{k} {v['ms']:.4f} ms" + ("" if v["within_gates"] is None else
                                            f" (y err {v['y_err']:.3g}, h err {v['h_err']:.3g}, within the "
                                            f"gates {v['within_gates']})")
                for k, v in vrows.items()), flush=True)
            del u, dt, a, dbc, bm, cm, args_, ref_y, ref_h
            torch.cuda.empty_cache()

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}; launches of the kernel as built outside the gates or not bit-stable: {fails or 'none'}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
