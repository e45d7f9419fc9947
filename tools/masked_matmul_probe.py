#!/usr/bin/env python3
"""The bf16 masked GEMM's ``mma`` kernel on one CUDA card, against the kernel
as built at an earlier commit.

    git archive <commit> | tar -x -C build/parent      # the earlier tree, once
    python3 tools/masked_matmul_probe.py [--parent build/parent] [--out build/masked_matmul_probe.json]
                                         [--quick] [--no-diagnostics] [--rows 1,1b,...] [--prefills]

The earlier tree's ``masked_matmul.cu`` ("parent") is built beside the
tree's ("tree"), each by one ``nvcc`` with the port's flags, all started
together; a parent whose source is the tree's is measured once. Each is
called through its own C entry point and its own plan (``masked_matmul_plan``
in each source), on the same inputs:

1. Each build's wall seconds, and ``-Xptxas -v`` (registers, stack, spills)
   of every ``mma_kernel`` instance; ``cuobjdump -sass`` counted for
   ``HGMMA`` (``wgmma``) and ``UTMALDG`` (TMA loads) in each instance.
2. The host's cost of one launch call (the C entry point alone, enqueue
   only, at a small shape): the tree encodes two TMA maps a call.
3. At the shapes of ``PERF.md``'s kernel table: SmolLM-135M's long-prefill
   layer GEMMs (M = 8192, row 1), 8 chips at its serving prefill (M = 512,
   row 1b), mixtral-8x22b's ``wg`` and ``wd`` over 8 experts at M = 160 (row
   1d) and over 2 chips x 8 experts (row 1e), and hymba-1.5b's and
   llama3-405b's layer GEMMs at M = 512 and 8192: both w dtypes (the fp32
   master read in place, and its bf16 copy), parent and tree in turns
   (parent, tree, tree, parent), ``torch.matmul`` / ``torch.bmm`` on the
   pre-masked bf16 weight, and the bound (inputs once and y once at 3.35
   TB/s, the mask as bits, or the product at 989 TFLOP/s). Each launch is
   held to the plain version (``masked_matmul_ref``) at ``chip_smoke.py``'s
   bf16 gate, the fp32-w launch to the bf16-w launch's bits and a second
   launch to the first's.
4. Copies of the tree's kernel built with other design constants
   (``VARIANTS``), held to the same gate and timed once each beside the
   turns; and diagnostic copies (``DIAGNOSTICS``), patched to leave a part
   out, whose results are wrong and not gated: the difference is what the
   part costs.

5. With ``--prefills``, the 4x2048 bf16 prefill of SmolLM-135M, qwen3-0.6b
   and hymba-1.5b in ``kernel`` mode, each tree's whole package (the
   parent's from ``--parent``) in a process of its own, in turns (parent,
   tree, tree, parent), then once each with ``CUDA_MODULE_LOADING=EAGER``
   (every kernel loaded when its library is, not at its first launch).
   Each process builds its own kernels first (both trees' builds started
   together), then times one masked GEMM (SmolLM's 576x1536 on a bf16 w,
   whose kernel instances the prefills, on the fp32 master, do not use)
   at M = 1024 and five times at M = 8192, by host clock with a sync and
   by CUDA events; then each model after a 4x256 warmup, five
   prefills by host clock with a sync (``chip_smoke.py`` times one such
   run). The first prefill less the median of the other four is the cost
   of what the 4x256 warmup did not use yet.

Every time is the median of 10 single launches timed by CUDA events, the
50 MB L2 overwritten before each. ``--quick`` takes the first shape of each
row only. It needs a card and ``nvcc``, and imports nothing of JAX.
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
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = "src/repro_torch/kernels/csrc/masked_matmul.cu"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12
BF16_TOL = (2e-2, 0.2)  # chip_smoke.py's dtype_tol(bfloat16)
# the entry points' argument lists: the tree's adds the token tile, the grid and the load routes
PARENT_ARGS = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3
               + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p])
TREE_ARGS = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3
             + [ctypes.c_int] * 8 + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p])
PLAN_ARGS = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
# diagnostic copies of the tree's mma kernel: (text, replacement, times the text is found)
MASK_LOOP = ("          for (int h = 0; h < 2; ++h)\n#pragma unroll\n            for (int j = 0; j < 2; ++j) {\n"
             "              const uint32_t m = mask_pair")
NO_MASK = (MASK_LOOP, MASK_LOOP.replace("h < 2", "h < 0"), 1)
NO_PREP = ("          load_a<WT, KCONTIG>(f, ws, off, s, t4);\n",
           "          f[0] = f[1] = f[2] = f[3] = 0x3F803F80u + s;\n", 1)
NO_WGMMA = ("        for (int q = 0; q < G; ++q) wgmma_rs<TOK>(acc, fs[q], b_desc(xaddr + 32 * (gi * G + q)));\n",
            "        for (int q = 0; q < G; ++q) acc[q] += __uint_as_float((fs[q][0] ^ fs[q][3]) & 0x3FFFFFu);\n", 1)
DIAGNOSTICS = {
    "no mask": [NO_MASK],
    "no A prep": [NO_MASK, NO_PREP],
    "no wgmma": [NO_WGMMA],
    "ring only": [NO_MASK, NO_PREP, NO_WGMMA],
}
# alternatives to the tree's kernel, built from patched copies of its source, held to the gate and
# timed beside it: one k step a wgmma group (four, a whole k tile, measured slower in turns)
GROUP = "constexpr int MMA_STEP_GROUP = 2;"
VARIANTS = {"step group 1": [(GROUP, GROUP.replace("2", "1"), 1)]}


def patch(text: str, patches) -> str:
    for old, new, times in patches:
        if text.count(old) != times:
            raise RuntimeError(f"the source holds {old!r} {text.count(old)} times, not {times}")
        text = text.replace(old, new)
    return text


def build_all(common, texts: dict) -> dict:
    """Each named source text built into ``build/kernels`` (one nvcc each, all
    started together); returns name -> (library, compiler log, wall seconds)."""
    common.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        tag = hashlib.sha1((text + " ".join(common.NVCC_FLAGS)).encode()).hexdigest()[:12]
        cu, lib, log = (common.BUILD_DIR / f"mm_probe-{tag}{ext}" for ext in (".cu", ".so", ".log"))
        cu.write_text(text)
        proc = subprocess.Popen([common._nvcc(), *common.NVCC_FLAGS, "-o", str(lib), str(cu)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        procs[name] = (proc, lib, log, time.perf_counter())
    out = {}
    for name, (proc, lib, log, t0) in procs.items():
        text = proc.communicate()[0].decode(errors="replace")
        seconds = time.perf_counter() - t0
        if proc.returncode:
            raise RuntimeError(f"{name} failed to build:\n{text}")
        log.write_text(text)
        out[name] = (lib, text, seconds)
    return out


def ptxas_table(log: str) -> dict:
    """Registers, stack and spill bytes of each ``mma_kernel`` instance in an
    ``nvcc -Xptxas -v`` log, keyed by its template arguments."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            k = re.search(r"mma_kernelI(\w+?)EEv", m.group(1))
            fn = k.group(1) if k else None
            if fn:
                out.setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out[fn].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return out


def sass_counts(sass: str) -> dict:
    """HGMMA and UTMALDG instructions of each ``mma_kernel`` instance, its
    local loads and stores (spills), those of them inside a loop that issues
    ``wgmma`` (between a backward branch and its target, a span holding an
    HGMMA), its ``setmaxnreg`` and the highest register it names."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0]
        k = re.search(r"mma_kernelI(\w+?)EEv", name)
        if k:
            ops = [(int(a, 16), o.split(".")[0], rest) for a, o, rest in re.findall(
                r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;\n]*)", part)]
            heads = [o for _, o, _ in ops]
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", part)]
            wgmma = [a for a, o, _ in ops if o == "HGMMA"]
            loops = []
            for a, o, rest in ops:
                t = re.search(r"0x([0-9a-f]+)", rest) if o == "BRA" else None
                if t and int(t.group(1), 16) < a and any(int(t.group(1), 16) <= h <= a for h in wgmma):
                    loops.append((int(t.group(1), 16), a))
            local = [a for a, o, _ in ops if o in ("LDL", "STL")]
            out[k.group(1)] = dict(HGMMA=len(wgmma), UTMALDG=heads.count("UTMALDG"),
                                   HMMA=heads.count("HMMA"), LDL=heads.count("LDL"), STL=heads.count("STL"),
                                   local_in_wgmma_loop=sum(any(lo <= a <= hi for lo, hi in loops) for a in local),
                                   USETMAXREG=heads.count("USETMAXREG"), top_register=max(regs, default=-1),
                                   instructions=len(heads))
    return out


def mma_sass(sass: str) -> str:
    """The ``mma_kernel`` instances' part of a ``cuobjdump -sass`` listing."""
    return "".join("\n        Function : " + part for part in re.split(r"\n\s*Function : ", sass)[1:]
                   if "mma_kernelI" in part.split("\n", 1)[0])


def shapes(quick: bool) -> list:
    """(row, label, lead, M, K, N, uses): lead is () for one GEMM, (chips,)
    for a chip stack, ("E", E) for experts under one mask, (chips, E) for
    chips x experts; ``uses`` are the launches of that shape in the row's
    sum (a step's or a prefill's)."""
    from repro_torch.configs import get_arch

    out = []
    for row, arch, m, lead in (("1", "smollm-135m", 8192, ()), ("1b", "smollm-135m", 512, (8,)),
                               ("hymba 512", "hymba-1.5b", 512, ()), ("hymba 8192", "hymba-1.5b", 8192, ()),
                               ("llama3 512", "llama3-405b", 512, ()), ("llama3 8192", "llama3-405b", 8192, ())):
        cfg = get_arch(arch)
        seen = {}
        for k, n, uses in cfg.gemm_shapes()[:-1]:  # the layers; the unembed is not an mma launch at prefill
            seen[(k, n)] = seen.get((k, n), 0) + uses
        for (k, n), uses in list(seen.items())[: 1 if quick else None]:
            out.append((row, arch, lead, m, k, n, uses))
    out.append(("1d", "mixtral-8x22b wg", ("E", 8), 160, 6144, 16384, 1))
    if not quick:
        out.append(("1d", "mixtral-8x22b wd", ("E", 8), 160, 16384, 6144, 1))
    out.append(("1e", "mixtral-8x22b wg", (2, 8), 160, 6144, 16384, 1))
    if not quick:
        out.append(("1e", "mixtral-8x22b wd", (2, 8), 160, 16384, 6144, 1))
    return out


# the prefills' models, and the GEMM whose first uses a turn times (SmolLM-135M's 576x1536 on a bf16
# w: other kernel instances than the prefills' fp32 master takes)
PREFILL_ARCHS = ("smollm-135m", "qwen3-0.6b", "hymba-1.5b")
FIRST_USE = (576, 1536, (1024, 8192, 8192, 8192, 8192, 8192))


def prefill_worker(root: Path, out: Path) -> int:
    """One turn of ``--prefills``: the package under ``root``'s ``src``, its
    kernels built there; writes the turn's times to ``out``."""
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import from_fault_map, random_fault_map
    from repro_torch.kernels.common import build_kernels
    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    from repro_torch.models import model as M

    build_kernels(["masked_matmul", "flash_attention", "selective_scan"])
    dev = torch.device("cuda")
    rep = dict(root=str(root), loading=__import__("os").environ.get("CUDA_MODULE_LOADING", "default"),
               gemm=[], prefills={})
    ok = from_fault_map(random_fault_map(0, 256, 256, 0.1), "kernel", device=dev).ok
    k, n, ms = FIRST_USE
    w = torch.randn(k, n, device=dev).to(torch.bfloat16)
    for m in ms:  # the M = 1024 launch is the 4x256 warmup's shape, then the long prefill's
        x = torch.randn(m, k, device=dev).to(torch.bfloat16)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.record()
        masked_matmul(x, w, ok)
        e.record()
        torch.cuda.synchronize()
        rep["gemm"].append(dict(m=m, host_ms=(time.perf_counter() - t0) * 1e3, device_ms=s.elapsed_time(e)))
    for arch in PREFILL_ARCHS:
        cfg = get_arch(arch)
        params = M.init_params(cfg, 0, device=dev)
        ctx = from_fault_map(random_fault_map(0, cfg.array_rows, cfg.array_cols, 0.1), "kernel", device=dev)
        g = torch.Generator(device=dev).manual_seed(0)
        tokens = torch.randint(0, cfg.vocab_size, (4, 2048), generator=g, device=dev)
        M.prefill(params, {"tokens": tokens[:, :256]}, cfg, ctx, attn_impl="kernel")
        torch.cuda.synchronize()
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            M.prefill(params, {"tokens": tokens}, cfg, ctx, attn_impl="kernel")
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        rep["prefills"][arch] = runs
        del params
        torch.cuda.empty_cache()
    out.write_text(json.dumps(rep))
    return 0


def prefill_turns(parent: Path, stem: Path, card: str) -> dict:
    """``--prefills``: both trees' kernels built together, then one process
    a turn (parent, tree, tree, parent, then each with every kernel loaded
    eagerly); returns each turn's times, keyed by its order and tree."""
    import os

    trees = {"tree": ROOT, "parent": parent}
    if not (parent / SOURCE).exists():
        print(f"prefills: {parent} not found: the tree alone", flush=True)
        trees.pop("parent")
    code = "import sys; sys.path.insert(0, sys.argv[1] + '/src'); from repro_torch.kernels.common import " \
           "build_kernels; build_kernels(['masked_matmul', 'flash_attention', 'selective_scan'])"
    t0 = time.perf_counter()
    builds = [subprocess.Popen([sys.executable, "-c", code, str(r)]) for r in trees.values()]
    if any(b.wait() for b in builds):
        raise RuntimeError("prefills: a tree's kernels failed to build")
    print(f"prefills: both trees built in {time.perf_counter() - t0:.2f} s", flush=True)
    order = [(who, "default") for who in ("parent", "tree", "tree", "parent") if who in trees]
    order += [(who, "EAGER") for who in ("tree", "parent") if who in trees]
    turns = []
    for i, (who, loading) in enumerate(order):
        env = dict(os.environ)
        if loading == "EAGER":
            env["CUDA_MODULE_LOADING"] = "EAGER"
        out = Path(f"{stem}.prefill{i}.json")
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--prefill-worker", str(trees[who]),
                               "--out", str(out)], env=env)
        if proc.returncode:
            raise RuntimeError(f"prefills: turn {i} ({who}) failed")
        rep = json.loads(out.read_text())
        rep.update(turn=i, who=who)
        turns.append(rep)
        gemm = ", ".join(f"M={r['m']} {r['host_ms']:.3f}/{r['device_ms']:.3f}" for r in rep["gemm"])
        print(f"prefills turn {i} {who} (module loading {rep['loading']}; {card}): masked GEMM 576x1536 bf16 w, "
              f"host/device ms: {gemm}", flush=True)
        for arch, runs in rep["prefills"].items():
            first_use = runs[0] - statistics.median(runs[1:])
            print(f"prefills turn {i} {who} {arch} 4x2048 bf16 after a 4x256 warmup, five runs (host clock with a "
                  f"sync): " + ", ".join(f"{t:.2f}" for t in runs) + f" ms; first less the median of the rest "
                  f"{first_use:.2f} ms", flush=True)
    for who in trees:
        for arch in PREFILL_ARCHS:
            warm = [statistics.median(t["prefills"][arch][1:]) for t in turns
                    if t["who"] == who and t["loading"] == "default"]
            print(f"prefills {who} {arch}: warm median of its default turns {statistics.mean(warm):.2f} ms "
                  f"({', '.join(f'{t:.2f}' for t in warm)})", flush=True)
    return dict(turns=turns)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=str(ROOT / "build" / "parent"))
    ap.add_argument("--out", default=str(ROOT / "build" / "masked_matmul_probe.json"))
    ap.add_argument("--quick", action="store_true", help="the first shape of each row only")
    ap.add_argument("--no-diagnostics", action="store_true")
    ap.add_argument("--rows", default="", help="comma-separated rows to run (1, 1b, 1d, 1e, 'hymba 512', ...); "
                    "default every row")
    ap.add_argument("--prefills", action="store_true",
                    help="also time the 4x2048 prefills of SmolLM-135M, qwen3-0.6b and hymba-1.5b, parent and "
                         "tree in turns, each in a process of its own")
    ap.add_argument("--sass-dir", default="", help="write the tree's and the parent's mma instances' SASS here")
    ap.add_argument("--prefill-worker", default="", help=argparse.SUPPRESS)  # a checkout's root: one turn
    args = ap.parse_args(argv)
    if args.prefill_worker:
        return prefill_worker(Path(args.prefill_worker), Path(args.out))
    import torch

    if not torch.cuda.is_available():
        print("masked_matmul_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import random_fault_map
    from repro_torch.kernels import common
    from repro_torch.kernels.masked_matmul import ops as mm

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    sources = {"tree": (ROOT / SOURCE).read_text()}
    parent_src = Path(args.parent) / SOURCE
    if parent_src.exists() and parent_src.read_text() != sources["tree"]:
        sources["parent"] = parent_src.read_text()
    else:
        print(f"parent: {parent_src} {'is the tree' if parent_src.exists() else 'not found'}: the tree alone",
              flush=True)
    texts = dict(sources)
    diags = {} if args.no_diagnostics else DIAGNOSTICS
    for name, patches in {**diags, **VARIANTS}.items():
        texts[f"tree {name}"] = patch(sources["tree"], patches)
    variants = [f"tree {name}" for name in VARIANTS]
    built = build_all(common, texts)
    report = dict(card=card, build_seconds={k: v[2] for k, v in built.items()}, ptxas={}, sass={}, rows=[],
                  host_us={})
    print("build wall seconds (all started together): "
          + ", ".join(f"{k} {v[2]:.2f}" for k, v in built.items()), flush=True)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for who in [*sources, *variants]:
        report["ptxas"][who] = ptxas_table(built[who][1])
        sass = subprocess.run([cuobjdump, "-sass", str(built[who][0])], capture_output=True, text=True).stdout
        report["sass"][who] = sass_counts(sass)
        if args.sass_dir and who in sources:
            Path(args.sass_dir).mkdir(parents=True, exist_ok=True)
            (Path(args.sass_dir) / f"masked_matmul_mma.{who}.sass").write_text(mma_sass(sass))
        for inst in sorted(report["ptxas"][who]):
            print(f"{who} mma_kernel<{inst}>: ptxas {report['ptxas'][who][inst]}; sass "
                  f"{report['sass'][who].get(inst)}", flush=True)

    libs = {name: ctypes.CDLL(str(lib)) for name, (lib, _, _) in built.items()}

    def entry(name):
        fn = libs[name].masked_matmul
        fn.argtypes, fn.restype = (PARENT_ARGS if name == "parent" else TREE_ARGS), ctypes.c_int
        return fn

    def c_plan(name, chips, m, n, k, kcontig, sms):
        fn = libs[name].masked_matmul_plan
        fn.argtypes, fn.restype = PLAN_ARGS, ctypes.c_int
        out = (ctypes.c_longlong * 4)()
        if fn(3, chips, m, n, k, int(kcontig), sms, out):
            raise RuntimeError(f"{name}: no plan for {chips} x {m} x {k} x {n}")
        return list(out)

    dev = torch.device("cuda")
    sms = common.sm_count(dev)
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

    def caller(name, x3, w, ok, group, chips):
        """A zero-argument launch of ``name``'s mma kernel on x3 (chips, M, K),
        w (K, N) or stacked with entry stride w.stride(-3), ok (R, C) or
        (masks, R, C); returns (launch, y)."""
        m, k = x3.shape[1:]
        n = w.shape[-1]
        kcontig = w.stride(-1) != 1
        swc = w.stride(-3) if w.dim() >= 3 else 0
        splits, scratch_bytes, tiles, tokens = c_plan(name, chips, m, n, k, kcontig, sms)
        y = torch.empty(chips, m, n, dtype=torch.bfloat16, device=dev)
        scratch = torch.empty(max(scratch_bytes, 1), dtype=torch.uint8, device=dev)
        counters = torch.zeros(max(tiles, 1), dtype=torch.int32, device=dev)
        bits, bits_t = mm.packed_mask(ok)
        fn = entry(name)
        stream = torch.cuda.current_stream().cuda_stream
        head = (3, 1, 1 if w.dtype == torch.bfloat16 else 0, chips, x3.data_ptr(), w.data_ptr(), bits.data_ptr(),
                bits_t.data_ptr(), y.data_ptr(), m, n, k, w.stride(-2), w.stride(-1), swc, ok.shape[-2],
                ok.shape[-1], group, splits, 0)
        tail = (scratch.data_ptr(), scratch_bytes, counters.data_ptr(), counters.numel(), stream)
        if name == "parent":
            argv_ = head + tail
        else:
            loads = mm._mma_loads(x3.data_ptr(), k, w, swc)
            blocks = min(tiles * splits, sms)
            argv_ = head + (tokens, blocks, (loads[0] == "copy") | (loads[1] == "copy") << 1) + tail

        keep = (x3, w, y, scratch, counters, bits, bits_t)  # alive while the launch is

        def launch():
            err = fn(*argv_)
            if err or keep is None:
                raise RuntimeError(f"{name} launch failed with CUDA error {err}")
        return launch, y

    # the host's cost of a launch call: the C entry point alone, enqueue only
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(1, 64, 576, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(576, 576, generator=g, device=dev)
    ok = torch.from_numpy(random_fault_map(0, 256, 256, 0.1).ok_mask).to(dev)
    for who in sources:
        launch, _ = caller(who, x, w, ok, 0, 1)
        launch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            launch()
        report["host_us"][who] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    print("host cost of one launch call, enqueue only (us): "
          + ", ".join(f"{k} {v:.2f}" for k, v in report["host_us"].items()), flush=True)

    bad, variant_bad = [], []
    rows = {r.strip() for r in args.rows.split(",") if r.strip()}
    for row, label, lead, m, k, n, uses in shapes(args.quick):
        if rows and row not in rows:
            continue
        experts = bool(lead) and lead[0] == "E"
        chips = lead[1] if experts else (lead[0] * lead[1] if len(lead) == 2 else lead[0] if lead else 1)
        masks = lead[0] if lead and not experts else 1  # one mask a chip; experts share their chip's
        group = 0 if experts or not lead else (lead[1] if len(lead) == 2 else 1)
        x3 = torch.randn(chips, m, k, generator=g, device=dev).to(torch.bfloat16)
        w32 = torch.randn(chips, k, n, generator=g, device=dev) / k ** 0.5
        oks = torch.stack([torch.from_numpy(random_fault_map(c, 256, 256, 0.1).ok_mask) for c in range(masks)])
        ok = oks.to(dev) if lead and not experts else oks[0].to(dev)
        w32 = w32 if chips > 1 else w32[0]
        wb = w32.to(torch.bfloat16)
        # the plain version's operands (chips x experts as (chips, E, ...)), and the pre-masked bf16
        # weight the library call reads
        inner = (lead[0], lead[1]) if len(lead) == 2 and not experts else (chips,) if chips > 1 else ()
        xs = x3.reshape(*inner, m, k)
        ws32 = w32.reshape(*inner, k, n)
        ref = mm.masked_matmul_ref(xs, ws32, ok).reshape(chips, m, n)
        wm = (ws32.to(torch.bfloat16).float()
              * mm.periodic_mask(ws32.shape, ok[:, None] if ws32.dim() == 4 else ok, dtype=torch.float32)
              ).to(torch.bfloat16).reshape(chips, k, n)
        rec = dict(row=row, shape=label, lead=list(map(str, lead)), m=m, k=k, n=n, uses=uses,
                   loads=mm._mma_loads(x3.data_ptr(), k, w32, w32.stride(-3) if w32.dim() >= 3 else 0))
        size = 2
        mask_bytes = masks * 256 * 32
        for wname, wt in (("fp32 w", w32), ("bf16 w", wb)):
            calls = {who: caller(who, x3, wt, ok, group, chips) for who in texts}
            got = {}
            for who in [*sources, *variants]:
                launch, y = calls[who]
                launch()
                torch.cuda.synchronize()
                got[who] = y.clone()
                launch()
                torch.cuda.synchronize()
                diff = (got[who].float() - ref.float()).abs()
                good = bool((diff <= BF16_TOL[1] + BF16_TOL[0] * ref.float().abs()).all())
                same = torch.equal(y, got[who])
                rec[f"{who} {wname} err"] = float(diff.max())
                if not (good and same):  # a variant's miss is a finding, not a fault of the tree
                    (bad if who in sources else variant_bad).append(
                        f"{row} {label} {wname} {who}: err {float(diff.max())} repeat-bits {same}")
            order = ["parent", "tree", "tree", "parent"] if "parent" in sources else ["tree", "tree"]
            turns = {who: [] for who in sources}
            for who in order:
                turns[who].append(time_ms(calls[who][0]))
            for who in variants:
                turns[who] = [time_ms(calls[who][0])]
            rec[f"{wname} turns"] = turns
            for name in diags:
                rec.setdefault(f"{wname} diagnostics", {})[name] = time_ms(calls[f"tree {name}"][0])
            nbytes = 2 * chips * m * (k + n) + chips * k * n * wt.element_size() + mask_bytes
            rec[f"{wname} bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        rec["ops_ms"] = 2 * chips * m * k * n / BF16_OPS_PER_S * 1e3
        x_l, w_l = (x3, wm) if chips > 1 else (x3[0], wm[0])
        rec["library_ms"] = time_ms(lambda: torch.bmm(x_l, w_l) if chips > 1 else torch.matmul(x_l, w_l))
        rec["library"] = "torch.bmm" if chips > 1 else "torch.matmul"
        report["rows"].append(rec)
        bound = {w_: max(rec[f"{w_} bytes_ms"], rec["ops_ms"]) for w_ in ("fp32 w", "bf16 w")}
        print(f"row {row} {label} {'x'.join(map(str, lead)) or '1'} M={m} K={k} N={n} (x{uses}; loads "
              f"{rec['loads']}): "
              + "; ".join(f"{w_} turns " + ", ".join(f"{who} " + "/".join(f"{t:.4f}" for t in ts)
                                                     for who, ts in rec[f"{w_} turns"].items())
                          + f" bound {bound[w_]:.4f}"
                          + (" diagnostics " + ", ".join(f"{d} {t:.4f}" for d, t in rec[f"{w_} diagnostics"].items())
                             if diags else "")
                          for w_ in ("fp32 w", "bf16 w"))
              + f"; {rec['library']} {rec['library_ms']:.4f} ms; errs "
              + ", ".join(f"{k_} {v:.3g}" for k_, v in rec.items() if k_.endswith(" err")), flush=True)
        del x3, w32, wb, ref, wm, calls, got
        torch.cuda.empty_cache()

    if args.prefills:
        report["prefills"] = prefill_turns(Path(args.parent), Path(args.out).with_suffix(""), card)

    sums = {}
    for rec in report["rows"]:
        s = sums.setdefault(rec["row"], {})
        for w_ in ("fp32 w", "bf16 w"):
            for who, ts in rec[f"{w_} turns"].items():
                s[f"{who} {w_}"] = s.get(f"{who} {w_}", 0.0) + statistics.mean(ts) * rec["uses"]
        s["library"] = s.get("library", 0.0) + rec["library_ms"] * rec["uses"]
    report["sums"] = sums
    for row, s in sums.items():
        print(f"row {row}, each shape's mean of turns times its uses (ms; {card}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in s.items()), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    report["variants_outside_the_gate"] = variant_bad
    print(f"wrote {out}; launches outside the gate or not bit-stable: {bad or 'none'}; variants: "
          f"{variant_bad or 'none'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
