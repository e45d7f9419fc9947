#!/usr/bin/env python3
"""The float32 kernels on the card: the masked GEMM's ``v1`` and flash
attention's ``v1``, each against its plain version and timed beside its
bound and one PyTorch call for the same function.

    python3 tools/f32_kernels_probe.py [--out build/f32_kernels_probe.json] [--quick] [--variants]

Prints ptxas's registers, shared memory and spills for every float32 kernel
instance, then one line per shape: the kernel's time (median of single
launches, CUDA events, L2 overwritten before each), the operations bound at
67 TFLOP/s FP32 (or the bytes bound at 3.35 TB/s where larger),
``torch.matmul`` on the pre-masked fp32 weight (TF32 off) or SDPA, and the
largest error against the plain version at ``dtype_tol(float32)``. Exits 1
where a shape misses its tolerance or two launches differ in a bit.
``--quick`` runs the parity checks and one shape of each kernel.
``--variants`` also builds patched copies of ``csrc/masked_matmul.cu``
(``VARIANTS``: the tiled kernel's design constants changed one at a time)
into ``build/kernels/`` and times each at the M = 8192 GEMMs, in turns with
the source as it is, and counts the SASS instructions of the float 128 x
128 tiled kernel of each (``cuobjdump -sass``).
"""
from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# (label, M, K, N, embed.T): SmolLM-135M's layer GEMMs at its long prefill and decode, its tied
# unembedding, hymba-1.5b's and falcon-mamba-7b's widest layer GEMMs
GEMMS = [
    ("smollm qkvo", 8192, 576, 576, False), ("smollm kv", 8192, 576, 192, False),
    ("smollm up", 8192, 576, 1536, False), ("smollm down", 8192, 1536, 576, False),
    ("smollm unembed", 1024, 576, 49152, True), ("smollm unembed", 4, 576, 49152, True),
    ("smollm qkvo", 4, 576, 576, False), ("smollm up", 4, 576, 1536, False),
    ("smollm down", 4, 1536, 576, False), ("smollm qkvo", 8, 576, 576, False),
    ("smollm qkvo", 512, 576, 576, False), ("hymba in_proj", 8192, 1600, 6400, False),
    ("hymba out_proj", 8192, 3200, 1600, False), ("falcon in_proj", 512, 4096, 16384, False),
]
# patched copies of csrc/masked_matmul.cu: (name, [(text, replacement), ...])
VARIANTS = [
    # k depth 4: half the unrolled loop body
    ("bk4", [("constexpr int TL_BK = 8;", "constexpr int TL_BK = 4;")], {}),
    # the source as it is with every tile run whole (no K split)
    ("no-split", [], {"_split_plan": lambda m, n, k, sms, chips=1, kc=False: _V1_PLAN(m, n, k, sms, chips, kc)._replace(
        splits=1, scratch_bytes=0, split_tiles=0) if m > 16 else _V1_PLAN(m, n, k, sms, chips, kc)}),
]
_V1_TILES = _V1_PLAN = None  # the wrapper's own, set before a variant patches them
# (label, B, Hq, Hkv, S, D, causal, window)
FLASH = [
    ("smollm", 4, 9, 3, 2048, 64, True, None), ("hymba window", 4, 25, 5, 2048, 64, True, 1024),
    ("hubert", 4, 16, 16, 2048, 80, False, None), ("phi3", 4, 32, 32, 2048, 96, True, None),
    ("qwen3", 4, 16, 8, 2048, 128, True, None),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "f32_kernels_probe.json"))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core import random_fault_map
    from repro_torch.kernels.common import build_kernels, dtype_tol
    from repro_torch.kernels.flash_attention.ops import attention_ref, flash_attention
    from repro_torch.kernels.masked_matmul.ops import masked_matmul, masked_matmul_ref

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    logs = build_kernels(["masked_matmul", "flash_attention"])
    report = {"card": card, "ptxas": [], "gemm": [], "flash": []}
    for name, text in logs.items():
        fn = ""
        for line in text.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
            elif ("registers" in line or "spill" in line) and (
                "tiled" in fn or "IffLi" in fn or "flash_attention_kernel" in fn):
                report["ptxas"].append(f"{name}: {fn}: {line.strip()}")
                print(report["ptxas"][-1])

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

    tol = dtype_tol(torch.float32)
    failed = []

    def check(label, got, ref, again):
        err = float((got - ref).abs().max())
        good = bool(((got - ref).abs() <= tol[1] + tol[0] * ref.abs()).all())
        same = torch.equal(got, again)
        if not (good and same):
            failed.append(f"{label}: err {err}, repeat equal {same}")
        return err, same

    gen = torch.Generator(device=dev).manual_seed(0)
    ok = torch.from_numpy(random_fault_map(0, 256, 256, 0.1).ok_mask).to(dev)
    # parity at ragged edges, both layouts, a chip axis, an unaligned view
    for m, k, n, tied in [(17, 100, 132, False), (65, 577, 130, True), (300, 1000, 257, False),
                          (129, 64, 1000, True), (5, 33, 70, False), (9, 576, 300, True),
                          (512, 1600, 32001, False), (8192, 576, 192, False), (1024, 576, 49152, True)]:
        x = torch.randn(m, k, generator=gen, device=dev)
        w = torch.randn(n, k, generator=gen, device=dev).T if tied else torch.randn(k, n, generator=gen, device=dev)
        err, _ = check(f"gemm {m}x{k}x{n}", masked_matmul(x, w, ok), masked_matmul_ref(x, w, ok),
                       masked_matmul(x, w, ok))
        print(f"parity gemm M={m} K={k} N={n}{' embed.T' if tied else ''}: err {err:.3g}")
    xs = torch.randn(3, 40, 577, generator=gen, device=dev)
    ws = torch.randn(3, 578, 129, generator=gen, device=dev)[:, 1:]  # 4-byte offset, odd strides
    oks = torch.stack([ok, ok.flip(0), ok.flip(1)]).contiguous()
    err, _ = check("gemm chips unaligned", masked_matmul(xs, ws, oks), masked_matmul_ref(xs, ws, oks),
                   masked_matmul(xs, ws, oks))
    print(f"parity gemm 3 chips, unaligned w: err {err:.3g}")

    gemms = GEMMS[:1] + GEMMS[5:6] if args.quick else GEMMS
    for label, m, k, n, tied in gemms:
        x = torch.randn(m, k, generator=gen, device=dev)
        w = (torch.randn(n, k, generator=gen, device=dev).T if tied else
             torch.randn(k, n, generator=gen, device=dev)) / math.sqrt(k)
        wm = w * ok[torch.arange(k, device=dev) % 256][:, torch.arange(n, device=dev) % 256]
        got = masked_matmul(x, w, ok)
        err, _ = check(f"gemm {label} M={m}", got, masked_matmul_ref(x, w, ok), masked_matmul(x, w, ok))
        ops_ms = 2 * m * k * n / FP32_OPS_PER_S * 1e3
        bytes_ms = ((m * k + m * n + k * n) * 4 + 256 * 32) / HBM_BYTES_PER_S * 1e3
        row = dict(label=label, m=m, k=k, n=n, tied=tied, ms=time_ms(lambda: masked_matmul(x, w, ok)),
                   library_ms=time_ms(lambda: torch.matmul(x, wm)), bound_ms=max(ops_ms, bytes_ms),
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes", max_abs_err=err)
        row["tflops"] = 2 * m * k * n / row["ms"] / 1e9
        report["gemm"].append(row)
        print(f"gemm {label:15s} M={m:5d} K={k:5d} N={n:6d}{' embed.T' if tied else '        '}: "
              f"v1 {row['ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s, {row['bound_ms'] / row['ms']:.0%} of "
              f"{row['bound_by']} bound {row['bound_ms']:.4f})  torch.matmul {row['library_ms']:.4f} ms  "
              f"err {err:.3g}")
        del x, w, wm, got

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, b, hq, hkv, s, d, causal, window in (FLASH[:1] if args.quick else FLASH):
        q = torch.randn(b, hq, s, d, generator=gen, device=dev)
        kk = torch.randn(b, hkv, s, d, generator=gen, device=dev)
        vv = torch.randn(b, hkv, s, d, generator=gen, device=dev)
        kw = dict(causal=causal, window=window)
        got = flash_attention(q, kk, vv, **kw)
        err, _ = check(f"flash {label}", got, attention_ref(q, kk, vv, **kw), flash_attention(q, kk, vv, **kw))
        rows = torch.arange(s, device=dev)[:, None]
        cols = torch.arange(s, device=dev)[None, :]
        keep = cols <= rows if causal else torch.ones(s, s, dtype=torch.bool, device=dev)
        if window:
            keep &= cols > rows - window
        pairs = int(keep.sum())
        kr, vr = kk.repeat_interleave(hq // hkv, 1), vv.repeat_interleave(hq // hkv, 1)
        bound = max(4 * b * hq * d * pairs / FP32_OPS_PER_S,
                    (2 * b * hq * s * d + 2 * b * hkv * s * d) * 4 / HBM_BYTES_PER_S) * 1e3
        row = dict(label=label, b=b, hq=hq, hkv=hkv, s=s, d=d, causal=causal, window=window,
                   ms=time_ms(lambda: flash_attention(q, kk, vv, **kw)),
                   library_ms=time_ms(lambda: sdpa(q, kr, vr, attn_mask=keep)), bound_ms=bound, max_abs_err=err)
        report["flash"].append(row)
        print(f"flash {label:12s} {b}x{hq}/{hkv}x{s}^2 D={d}: v1 {row['ms']:.4f} ms ({bound / row['ms']:.0%} of "
              f"bound {bound:.4f})  sdpa {row['library_ms']:.4f} ms  err {err:.3g}")
        del q, kk, vv, kr, vr, keep, got
    # an unaligned float32 view (plain loads) and the zero-mass rule
    base = torch.randn(2, 130, 3 * 64 + 1, generator=gen, device=dev)
    qv = base[:, 1:, 1:193].unflatten(-1, (3, 64)).transpose(1, 2)  # 4-byte offset, row stride 193
    err, _ = check("flash unaligned", flash_attention(qv, qv, qv), attention_ref(qv, qv, qv),
                   flash_attention(qv, qv, qv))
    print(f"parity flash unaligned view: err {err:.3g}")
    z = flash_attention(qv, qv[:, :, :40], qv[:, :, :40], causal=False, window=4, q_offset=100)
    if z.abs().any():
        failed.append("flash zero-mass rows are not 0")

    if args.variants:
        report["variants"] = variants(torch, time_ms, gen, ok, masked_matmul)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    if failed:
        print("FAILED: " + "; ".join(failed))
        return 1
    print("ok")
    return 0


def _sass_counts(lib: Path, kernel: str) -> dict:
    """Opcode counts of the loop body of one kernel's SASS in a built library:
    the backward branch's range that holds the most FFMAs (the k-tile loop)."""
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)], capture_output=True, text=True).stdout
    ops, inside = [], False  # (address, opcode, operands)
    for line in out.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = kernel in line
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if inside and m:
            ops.append((int(m.group(1), 16), m.group(2).split(".")[0], m.group(3)))
    best = []
    for i, (addr, op, rest) in enumerate(ops):
        tgt = re.search(r"0x([0-9a-f]+)", rest)
        if op == "BRA" and tgt and int(tgt.group(1), 16) < addr:
            body = [o for a, o, _ in ops if int(tgt.group(1), 16) <= a <= addr]
            if body.count("FFMA") > best.count("FFMA"):
                best = body
    if not best:
        return dict(total=0, parsed=len(ops))
    counts = {}
    for op in best:
        counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]), total=len(best))


def variants(torch, time_ms, gen, ok, masked_matmul) -> list:
    """Each VARIANTS entry built from a patched copy of the source, swapped in
    for the wrapper's entry point and timed at the M = 8192 GEMMs, in turns
    with the source as it is (base, variant, variant, base)."""
    import ctypes

    from repro_torch.kernels import common
    from repro_torch.kernels.masked_matmul import ops

    base_fn = common.load_kernel("masked_matmul", ops._ARGTYPES)
    src = (common.CSRC_DIR / "masked_matmul.cu").read_text()
    shapes = [g for g in GEMMS if g[1] >= 1024]
    operands = []
    for _, m, k, n, tied in shapes:
        x = torch.randn(m, k, generator=gen, device="cuda")
        w = torch.randn(n, k, generator=gen, device="cuda").T if tied else torch.randn(k, n, generator=gen, device="cuda")
        operands.append((x, w))
    out = []
    builds = {}
    for name, subs, _ in VARIANTS:
        text = src
        for a, b in subs:
            if a not in text:
                raise RuntimeError(f"variant {name}: {a!r} not in the source")
            text = text.replace(a, b)
        path = common.BUILD_DIR / f"masked_matmul-variant-{name}.cu"
        path.write_text(text)
        lib = path.with_suffix(".so")
        if not subs:  # the source as it is
            builds[name] = (None, common._lib_path("masked_matmul"))
            continue
        proc = subprocess.Popen([common._nvcc(), *common.NVCC_FLAGS, "-o", str(lib), str(path)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        builds[name] = (proc, lib)
    kern = "tiled_kernelIfLi128ELi128E"
    base_sass = _sass_counts(common._lib_path("masked_matmul"), kern)
    print(f"variant base: SASS of the float 128x128 tiled kernel's k-tile loop {base_sass}")
    global _V1_TILES, _V1_PLAN
    _V1_TILES, _V1_PLAN = ops._v1_tiles, ops._split_plan
    patches = {name: py for name, _, py in VARIANTS}
    for name, (proc, lib) in builds.items():
        log, _ = proc.communicate() if proc else (b"", None)
        if proc and proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log.decode()}")
        regs, fn_name = [], ""
        for line in log.decode().splitlines():
            hit = re.search(r"Function properties for (\S+)", line)
            if hit:
                fn_name = hit.group(1)
            elif kern in fn_name and ("registers" in line or "spill" in line):
                regs.append(line.strip())
        fn = getattr(ctypes.CDLL(str(lib)), "masked_matmul")
        fn.argtypes, fn.restype = ops._ARGTYPES, ctypes.c_int
        sass = _sass_counts(lib, kern)
        for (label, m, k, n, tied), (x, w) in zip(shapes, operands):
            times = {}
            for turn, f in (("base", base_fn), (name, fn), (name, fn), ("base", base_fn)):
                common._FNS["masked_matmul"] = f
                for attr, repl in (patches[name] if turn == name else {}).items():
                    setattr(ops, attr, repl)
                try:
                    got = masked_matmul(x, w, ok)
                    times.setdefault(turn, []).append(time_ms(lambda: masked_matmul(x, w, ok)))
                finally:
                    ops._v1_tiles, ops._split_plan = _V1_TILES, _V1_PLAN
                if turn == name and not torch.equal(got, masked_matmul(x, w, ok)):
                    print(f"variant {name}: {label} M={m} differs from the base in bits "
                          f"(max {float((got - masked_matmul(x, w, ok)).abs().max()):.3g})")
            common._FNS["masked_matmul"] = base_fn
            row = dict(variant=name, label=label, m=m, k=k, n=n, base_ms=min(times["base"]), ms=min(times[name]))
            out.append(row)
            print(f"variant {name:12s} {label:15s} M={m} K={k} N={n}: {row['ms']:.4f} ms, base {row['base_ms']:.4f} ms")
        print(f"variant {name}: SASS {sass}; ptxas of the float tiled 128x128: " + " | ".join(regs))
        out.append(dict(variant=name, sass=sass))
    return out


if __name__ == "__main__":
    sys.exit(main())
