#!/usr/bin/env python3
"""Where the time of the selective scan's backward kernel goes, on one CUDA
card, and the kernel as built against an earlier commit's.

    git archive <commit> | tar -x -C build/parent      # the earlier tree, once
    python3 tools/selective_scan_bwd_probe.py [--parent build/parent] [--out build/selective_scan_bwd_probe.json]

The earlier tree's ``selective_scan_bwd.cu`` ("parent") is built beside the
tree's ("tree"); a parent whose source is the tree's is measured once. At
the population fit's launch (2 chips x 8 rows x 64 steps x 8192 channels x
16 states, float32, gh given) and hymba-1.5b's vmap fit's (4 x 8 x 64 x 3200
x 16), for each kernel:

1. ``-Xptxas -v``: registers, stack and spills of every instance; the
   loops of the N = 16 instance in ``cuobjdump -sass``, counted by opcode
   (its SASS written beside ``--out``, one file a kernel).
2. The split of one call into its four launches, each timed apart: the main
   kernel (a copy of the source whose entry returns after it) and
   ``launch_sum`` for gB/gC, gA and gD (an entry point appended to the
   copy, run on the call's own scratch shapes).
3. Diagnostic copies of the main kernel, patched as ``DIAGNOSTICS`` lists:
   their results are wrong and not gated; the difference is what the part
   left out costs.
4. The whole call, parent and tree in turns (parent, tree, tree, parent),
   then the tree's ``VARIANTS`` once each, every one held to the plain version at ``chip_smoke.py``'s float32 gate (rtol
   2e-5, atol 1e-4, each gradient in units of its largest plain value) and
   to its own bits on a second launch; the scratch bytes each allocates.

Every time is the median of 10 single calls timed by CUDA events, the 50 MB
L2 overwritten before each. It needs a card and ``nvcc``, and imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
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
SOURCE = "src/repro_torch/kernels/csrc/selective_scan_bwd.cu"
# (chips, rows a chip, L, D, N)
SHAPES = {"population fit": (2, 8, 64, 8192, 16), "hymba vmap fit": (4, 8, 64, 3200, 16)}
F32_TOL = (2e-5, 1e-4)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# the entry returns after the main kernel: the same text in both sources
MAIN_ONLY = ("  if (err) return err;\n  const int chips = B / rows;", "  return err;\n  const int chips = B / rows;")
PROBE_SUM = """
extern "C" int probe_sum(const void* in, void* out, long long outer, int K, long long inner, void* stream) {
  return launch_sum(static_cast<const float*>(in), static_cast<float*>(out), outer, K, inner,
                    static_cast<cudaStream_t>(stream));
}
"""
# diagnostic patches of each source's main kernel: (text, replacement, times the text is found)
DIAGNOSTICS = {
    "parent": {
        "no expf": [("expf(dtv * a2[s])", "(1.f + dtv * a2[s])", 3)],
        "no pbc store": [("if (lane < P) {", "if (lane < P && a.L < 0) {", 1)],
        "no shuffle tree": [("          gb[s] += __shfl_xor_sync(0xffffffffu, gb[s], m);\n"
                             "          gc[s] += __shfl_xor_sync(0xffffffffu, gc[s], m);\n", "", 1)],
    },
    "tree": {
        "no expf": [("expf(xv.x * a2[s])", "(1.f + xv.x * a2[s])", 2)],
        "no channel sum": [("      const int base = reduce_channels<P>(v, lane, ms, writer);\n",
                            "      const int base = 0;\n", 1)],
        "no partial store": [("      for (int col = lane; col < 2 * a.N; col += 32) {",
                              "      for (int col = lane; col < 2 * a.N && a.L < 0; col += 32) {", 1)],
        "no pass 1 steps": [("      for (int j = 0; j < CT; ++j) {\n        const float4 xv = x[j * CPB + ch];\n"
                             "        float bv[S], cv[S];\n",
                             "      for (int j = 0; j < 0; ++j) {\n        const float4 xv = x[j * CPB + ch];\n"
                             "        float bv[S], cv[S];\n", 1)],
    },
}


# alternatives to the tree's kernel, built from patched copies of its source, held to the gate
# and timed beside it
VARIANTS = {"3 blocks an SM": [("constexpr int MIN_BLOCKS = 4;", "constexpr int MIN_BLOCKS = 3;", 1)]}


def _pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def parent_scratch(bsz, length, dim, n) -> dict:
    """The scratch shapes of 77fb41a's wrapper: per-warp partials of gB and
    gC, each row's gA and gD, a checkpoint of h every 8 steps."""
    states = min(8, _pow2(n))
    lanes = _pow2(-(-n // states))
    nw = -(-dim // (128 // lanes)) * 4
    nch = -(-length // 8)
    return dict(lanes=lanes, states=states, parts=nw, slots=nch, pbc=(bsz, length, nw, 2, n), pa=(bsz, dim, n),
                pd=(bsz, dim), ckpt=(bsz, nch, dim, n))


def diagnostics_for(src: str) -> dict:
    """The set of ``DIAGNOSTICS`` whose patches all apply to ``src``."""
    for patches in DIAGNOSTICS.values():
        if all(src.count(old) == times for name in patches for old, _, times in patches[name]):
            return patches
    return {}


def patch(text: str, patches) -> str:
    for old, new, times in patches:
        if text.count(old) != times:
            raise RuntimeError(f"the source holds {old!r} {text.count(old)} times, not {times}")
        text = text.replace(old, new)
    return text


def ptxas_table(log: str) -> dict:
    """Registers, stack and spill bytes of each function in an ``nvcc
    -Xptxas -v`` log, by kernel instance (lanes x states) or name."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            k = re.search(r"kernelILi(\d+)ELi(\d+)E", m.group(1))
            named = re.search(r"sum_middle", m.group(1))
            fn = f"{k.group(1)}x{k.group(2)}" if k else named.group(0) if named else m.group(1)
            out.setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out[fn].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return out


def instance_sass(sass: str, lanes: int, states: int):
    """The ``selective_scan_bwd_kernel<lanes, states>`` instance's part of
    ``cuobjdump -sass`` output, or None."""
    want = f"selective_scan_bwd_kernelILi{lanes}ELi{states}E"
    return next((f for f in re.split(r"\n\s*Function : ", sass) if want in f.split("\n", 1)[0]), None)


def sass_loops(sass: str, lanes: int, states: int) -> list:
    """Each loop (a backward branch) of the ``selective_scan_bwd_kernel<lanes,
    states>`` instance in ``cuobjdump -sass`` output, in address order: its
    instructions, and how many of them are exponentials, shuffles, shared
    loads and stores, barriers and device loads and stores."""
    body = instance_sass(sass, lanes, states)
    if body is None:
        return []
    instrs, labels, pending = [], {}, []
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            addr = int(m.group(1), 16)
            labels.update((name, addr) for name in pending)
            pending = []
            instrs.append((addr, re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())))
    loops = []
    for addr, text in instrs:
        m = re.search(r"BRA\s+(?:`\()?(\.L_x_\d+|0x[0-9a-f]+)", text)
        target = m and (labels.get(m.group(1)) if m.group(1).startswith(".L") else int(m.group(1), 16))
        if target is not None and target is not False and target < addr:
            ops = [t.split()[0].split(".")[0] for a, t in instrs if target <= a <= addr]
            loops.append(dict(start=target, end=addr, instructions=len(ops),
                              **{k: ops.count(k) for k in ("MUFU", "SHFL", "LDS", "STS", "BAR", "LDGSTS", "LDG", "STG")}))
    return loops


def build_all(common, texts: dict) -> dict:
    """Each named source text built into ``build/kernels`` (one nvcc each, all
    started together); returns name -> (library path, compiler log)."""
    common.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        tag = hashlib.sha1((text + " ".join(common.NVCC_FLAGS)).encode()).hexdigest()[:12]
        cu, lib, log = (common.BUILD_DIR / f"bwd_probe-{tag}{ext}" for ext in (".cu", ".so", ".log"))
        proc = None
        if not lib.exists():
            cu.write_text(text)
            proc = subprocess.Popen([common._nvcc(), *common.NVCC_FLAGS, "-o", str(lib), str(cu)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        procs[name] = (proc, lib, log)
    out = {}
    for name, (proc, lib, log) in procs.items():
        if proc is not None:
            text = proc.communicate()[0].decode(errors="replace")
            if proc.returncode:
                raise RuntimeError(f"{name} failed to build:\n{text}")
            log.write_text(text)
        out[name] = (lib, log.read_text() if log.exists() else "")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=str(ROOT / "build" / "parent"))
    ap.add_argument("--out", default=str(ROOT / "build" / "selective_scan_bwd_probe.json"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("selective_scan_bwd_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import common
    from repro_torch.kernels.mamba_scan import ops as sc

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    sources = {"tree": (ROOT / SOURCE).read_text()}
    parent_src = Path(args.parent) / SOURCE
    if parent_src.exists() and parent_src.read_text() != sources["tree"]:
        sources["parent"] = parent_src.read_text()
    else:
        print(f"parent: {parent_src} {'is the tree' if parent_src.exists() else 'not found'}: the tree alone",
              flush=True)
    texts, diags = {}, {who: diagnostics_for(src) for who, src in sources.items()}
    for who, src in sources.items():
        split = patch(src, [(*MAIN_ONLY, 1)]) + PROBE_SUM
        texts[f"{who} as built"] = src
        texts[f"{who} split"] = split
        for name, patches in diags[who].items():
            texts[f"{who} {name}"] = patch(split, patches)
        if diags[who] is DIAGNOSTICS["tree"]:
            for name, patches in VARIANTS.items():
                texts[f"{who} {name}"] = patch(src, patches)
    built = build_all(common, texts)
    report = dict(card=card, ptxas={}, split={}, diagnostics={}, turns={}, scratch_bytes={}, errors={})
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    report["sass_loops"] = {}
    for who in sources:
        lanes, states = (2, 8) if diags[who] is DIAGNOSTICS["parent"] else sc.bwd_plan(16)
        sass = subprocess.run([cuobjdump, "-sass", str(built[f"{who} as built"][0])], capture_output=True,
                              text=True).stdout
        report["sass_loops"][who] = sass_loops(sass, lanes, states)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).with_suffix(f".{who}.sass").write_text(instance_sass(sass, lanes, states) or "")
        for loop in report["sass_loops"][who]:
            print(f"sass {who} {lanes}x{states} loop {loop['start']:#x}-{loop['end']:#x}: "
                  + ", ".join(f"{k} {v}" for k, v in loop.items() if k not in ("start", "end")), flush=True)
    variants = [f"tree {name}" for name in VARIANTS if f"tree {name}" in built]
    for who in [*sources, *variants]:
        report["ptxas"][who] = ptxas_table(built[who if who in variants else f"{who} as built"][1])
        print(f"ptxas {who}: {report['ptxas'][who]}", flush=True)

    def entry(name, fn_name="selective_scan_bwd", argtypes=sc._BWD_ARGTYPES):
        fn = getattr(ctypes.CDLL(str(built[name][0])), fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    sum_types = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                 ctypes.c_void_p]
    dev = torch.device("cuda")
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

    gen = torch.Generator(device=dev).manual_seed(0)
    for key, (chips, rows, length, dim, n) in SHAPES.items():
        bsz = chips * rows
        u, gy = torch.randn(2, bsz, length, dim, generator=gen, device=dev)
        dt = torch.nn.functional.softplus(torch.randn(bsz, length, dim, generator=gen, device=dev) - 3)
        a = -torch.exp(torch.randn(chips, dim, n, generator=gen, device=dev))
        bm, cm = torch.randn(2, bsz, length, n, generator=gen, device=dev)
        d_skip = torch.randn(chips, dim, generator=gen, device=dev)
        gh = torch.randn(bsz, dim, n, generator=gen, device=dev)
        ins = (u, dt, a, bm, cm, d_skip, gy, gh)
        ref = sc.selective_scan_bwd_ref(*ins)
        f32 = dict(dtype=torch.float32, device=dev)
        outs = dict(gu=torch.empty(bsz, length, dim, **f32), gdt=torch.empty(bsz, length, dim, **f32),
                    gbc=torch.empty(bsz, length, 2, n, **f32), ga=torch.empty(chips, dim, n, **f32),
                    gd=torch.empty(chips, dim, **f32))
        # the parent's design by its text: its wrapper's scratch; else the tree's wrapper's
        geo = {who: parent_scratch(bsz, length, dim, n) if diags[who] is DIAGNOSTICS["parent"]
               else sc.bwd_scratch(bsz, length, dim, n) for who in sources}
        scratch = {who: {k: torch.empty(g[k], **f32) for k in ("pbc", "pa", "pd", "ckpt")} for who, g in geo.items()}
        report["scratch_bytes"][key] = {who: sum(t.numel() * 4 for t in s.values()) for who, s in scratch.items()}

        def run(fn, who):
            g, s = geo[who], scratch[who]
            err = fn(0, *(t.data_ptr() for t in ins), *(outs[k].data_ptr() for k in ("gu", "gdt", "gbc", "ga", "gd")),
                     *(s[k].data_ptr() for k in ("pbc", "pa", "pd", "ckpt")), bsz, length, dim, n, g["lanes"],
                     g["states"], g["parts"], g["slots"], *sc._strides(u, dt, bm, cm), rows, dim * n, dim,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{who} launch failed with CUDA error {err}")

        def gathered():
            gb, gc = outs["gbc"][:, :, 0], outs["gbc"][:, :, 1]
            return [outs["gu"], outs["gdt"], outs["ga"], gb, gc, outs["gd"]]

        whole = {who: entry(f"{who} as built") for who in sources}
        whole.update({v: entry(v) for v in variants})
        errs, same = {}, {}
        for who, fn in whole.items():
            run(fn, who.split(" ")[0])
            torch.cuda.synchronize()
            first = [t.clone() for t in gathered()]
            errs[who] = {}
            for name, x, w in zip(("gu", "gdt", "ga", "gb", "gc", "gd"), first, ref):
                scale = max(float(w.abs().max()), 1.0)
                diff = ((x - w) / scale).abs()
                errs[who][name] = float(diff.max())
                if not bool((diff <= F32_TOL[1] + F32_TOL[0] * (w / scale).abs()).all()):
                    errs[who][name + " over the gate"] = True
            run(fn, who.split(" ")[0])
            torch.cuda.synchronize()
            same[who] = all(torch.equal(x, y) for x, y in zip(first, gathered()))
        report["errors"][key] = dict(errs=errs, same_bits=same)
        print(f"{key}: errors in units of each gradient's largest plain value {errs}; two launches the same bits "
              f"{same}", flush=True)

        order = ["parent", "tree", "tree", "parent"] if "parent" in sources else ["tree", "tree"]
        turns = {who: [] for who in sources}
        for who in order:
            turns[who].append(time_ms(lambda: run(whole[who], who)))
        for v in variants:
            turns[v] = [time_ms(lambda: run(whole[v], "tree"))]
        report["turns"][key] = turns
        nbytes = 4 * (4 * bsz * length * dim + 4 * bsz * length * n + 2 * chips * (dim * n + dim)
                      + bsz * length * dim + bsz * dim * n)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"{key} ({chips} chips x {rows} x {length} x {dim} x {n}, float32, gh given; {card}): whole call in "
              f"turns {turns} ms; bytes bound {bound:.4f} ms; scratch bytes {report['scratch_bytes'][key]}",
              flush=True)

        for who in sources:
            g, s = geo[who], scratch[who]
            split = entry(f"{who} split")
            psum = entry(f"{who} split", "probe_sum", sum_types)
            stream = torch.cuda.current_stream().cuda_stream
            row = dict(main=time_ms(lambda: run(split, who)))
            sums = dict(gbc=(s["pbc"], outs["gbc"], bsz * length, g["parts"], 2 * n),
                        ga=(s["pa"], outs["ga"], chips, rows, dim * n), gd=(s["pd"], outs["gd"], chips, rows, dim))
            for name, (src, dst, outer, k, inner) in sums.items():
                row[f"sum {name}"] = time_ms(lambda: psum(src.data_ptr(), dst.data_ptr(), outer, k, inner, stream))
            row["four launches"] = sum(row.values())
            row["whole call"] = statistics.mean(turns[who])
            report["split"].setdefault(key, {})[who] = row
            print(f"{key} {who} split (ms): " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
            diag = {"main as built": row["main"]}
            for name in diags[who]:
                fn = entry(f"{who} {name}")
                diag[name] = time_ms(lambda: run(fn, who))
            report["diagnostics"].setdefault(key, {})[who] = diag
            print(f"{key} {who} main kernel, diagnostic copies (ms; results not gated): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in diag.items()), flush=True)
        del ins, ref, outs, scratch, u, gy, dt, a, bm, cm, d_skip, gh
        torch.cuda.empty_cache()

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    bad = [f"{k} {who}" for k, e in report["errors"].items() for who in e["errs"]
           if any(n.endswith("over the gate") for n in e["errs"][who]) or not e["same_bits"][who]]
    print(f"wrote {out}; launches outside the gate or not bit-stable: {bad or 'none'}")
    bad = [b for b in bad if b.rsplit(" ", 1)[-1] in sources]  # a variant's miss is a finding, not a fault
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
