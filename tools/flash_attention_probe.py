#!/usr/bin/env python3
"""Flash attention's bf16 ``mma`` kernel on one CUDA card, against the kernel
as built at an earlier commit.

    git archive <commit> | tar -x -C build/parent      # the earlier tree, once
    python3 tools/flash_attention_probe.py [--parent build/parent] [--out build/flash_attention_probe.json]
                                           [--quick] [--cells 0,5,7] [--diagnostics] [--extra NAME=PATH]
                                           [--prefills]

The earlier tree's ``flash_attention.cu`` ("parent") is built beside the
tree's ("tree"), each by one ``nvcc`` with the port's flags, both started
together. Each is called through its own C entry point on the same inputs;
the parent at its one bf16 tile (64, 64), the tree at each of its ``mma``
instances (``TILES["mma"]``):

1. Each build's wall seconds, ``-Xptxas -v`` (registers, stack, spills) of
   every ``flash_mma_kernel`` instance, and ``cuobjdump -sass`` counted for
   ``HGMMA`` (``wgmma``), ``UTMALDG`` (TMA loads), ``HMMA`` (``mma.sync``),
   ``LDGSTS`` (``cp.async``) and local loads and stores in each instance.
2. The host's cost of one call of the C entry point (enqueue only, at a
   small shape, the builds in turns): the tree finds its three TMA maps in
   a cache.
3. Parity of every tree instance at every head dim (64, 80, 96, 128):
   ragged Sq and Skv, a window with a ``q_offset``, rows that keep no key,
   a batch of one with one kv head, and a V whose every column holds its
   own offset, each held to ``attention_ref`` at ``chip_smoke.py``'s bf16
   flash gate (rtol 2e-2, atol 1e-2) and a second launch to the first's
   bits.
4. ``chip_smoke.py``'s bf16 flash cells at 4 x 2048 (SmolLM-135M's 9/3
   heads causal, window 256 and q_offset; hymba-1.5b's 25/5 under its
   window of 1024; hubert-xlarge's 16/16 at D = 80 not causal, phi3-mini's
   32/32 at D = 96, qwen3-0.6b's 16/8 at D = 128, both causal), parent and
   tree in turns (parent, tree, tree, parent), each tree instance once, the
   bound (the products' operations at 989 TFLOP/s, or q, k, v and o once at
   3.35 TB/s), and SDPA at its best route (``is_causal`` where the cell is
   plain causal from position 0, no mask for the encoder, ``enable_gqa`` on
   the unrepeated K and V) beside the masked call ``chip_smoke.py`` timed
   before (K and V repeated, a boolean mask). ``--extra NAME=PATH`` builds
   another copy of the source beside the tree's and times it at its tiles;
   ``--diagnostics`` times the tree's kernel patched to leave a part out
   (``DIAGNOSTICS``: no P V, no Q K^T, no exp, no products, the ring alone;
   wrong results, not gated) at the first two tiles.
5. With ``--prefills``, the 4 x 2048 bf16 prefills of SmolLM-135M,
   qwen3-0.6b and hymba-1.5b and hubert-xlarge's bf16 forward over 4 x 1024
   frames, in ``kernel`` mode, each tree's whole package (the parent's from
   ``--parent``) in a process of its own, in turns (parent, tree, tree,
   parent): a warmup at a short length, then ten runs by host clock with
   a sync; a turn's number is the median of the last nine.

Every kernel time is the median of 10 single launches timed by CUDA events,
the 50 MB L2 overwritten before each. ``--quick`` runs sections 1 to 3 and
the first cell of section 4, ``--cells`` the cells of those indices. The
tree's whole SASS listing goes to ``flash_sass/`` beside ``--out``. It
needs a card and ``nvcc``, and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
GATE = (2e-2, 1e-2)  # chip_smoke.py's FLASH_BF16_TOL
PEAK_BF16, HBM = 989e12, 3.35e12
LONG = 2048
# (label, B, Hq, Hkv, S, Sq, D, causal, window): chip_smoke.py's bf16 flash cells at 4 x 2048
CELLS = [
    ("smollm causal", 4, 9, 3, LONG, LONG, 64, True, None),
    ("smollm window256", 4, 9, 3, LONG, LONG, 64, True, 256),
    ("smollm q_offset", 4, 9, 3, LONG, LONG // 2, 64, True, None),
    ("hymba window1024", 4, 25, 5, LONG, LONG, 64, True, 1024),
    ("hymba window1024 q_offset", 4, 25, 5, LONG, LONG // 2, 64, True, 1024),
    ("hubert encoder d80", 4, 16, 16, LONG, LONG, 80, False, None),
    ("phi3 causal d96", 4, 32, 32, LONG, LONG, 96, True, None),
    ("qwen3 causal d128", 4, 16, 8, LONG, LONG, 128, True, None),
]
PREFILL_ARCHS = ("smollm-135m", "qwen3-0.6b", "hymba-1.5b")
# diagnostic copies of the tree's kernel, patched to leave a part out (their results are wrong and
# not gated; the difference in time is what the part costs): (text, replacement, times found)
NO_PV = ("for (int kk = 0; kk < BKV / 16; ++kk) wgmma_rs<D>(", "for (int kk = 0; kk < 0; ++kk) wgmma_rs<D>(", 1)
NO_QK = ("    for (int kk = 0; kk < D / 16; ++kk)\n      wgmma_ss<BKV>(",
         "    for (int kk = 0; kk < 0; ++kk)\n      wgmma_ss<BKV>(", 1)
NO_EXP = [("x0 = fast_exp2(fmaf(x0, a.scale_log2, -m_use));", "x0 = fmaf(x0, a.scale_log2, -m_use);", 1),
          ("x1 = fast_exp2(fmaf(x1, a.scale_log2, -m_use));", "x1 = fmaf(x1, a.scale_log2, -m_use);", 1)]
LOADS_ONLY = ("    if (!live || (a.causal && t0 > w_hi)", "    if (a.Hq > 0 || !live || (a.causal && t0 > w_hi)", 1)
DIAGNOSTICS = {"no PV": [NO_PV], "no QK": [NO_QK], "no exp": NO_EXP, "no GEMMs": [NO_PV, NO_QK],
               "ring only": [LOADS_ONLY]}
HUBERT_FRAMES = 1024  # chip_smoke.py's ZOO_FRAMES
PREFILL_RUNS = 10  # a turn's runs of each model; its number is the median of all but the first


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
        cu, lib = (common.BUILD_DIR / f"fa_probe-{tag}{ext}" for ext in (".cu", ".so"))
        cu.write_text(text)
        proc = subprocess.Popen([common._nvcc(), *common.NVCC_FLAGS, "-o", str(lib), str(cu)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        procs[name] = (proc, lib, time.perf_counter())
    out = {}
    for name, (proc, lib, t0) in procs.items():
        text = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"{name} failed to build:\n{text}")
        out[name] = (lib, text, time.perf_counter() - t0)
    return out


def instance(mangled: str) -> str:
    """``D,BQ,BKV`` of a mangled instance's template arguments (``Li64ELi128ELi128``)."""
    return ",".join(re.findall(r"Li(\d+)", mangled))


def ptxas_table(log: str) -> dict:
    """Registers, stack and spill bytes of each ``flash_mma_kernel``
    instance in an ``nvcc -Xptxas -v`` log, keyed by its template
    arguments."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            k = re.search(r"flash_mma_kernelI(\w+?)EEv", m.group(1))
            fn = instance(k.group(1)) if k else None
            if fn:
                out.setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out[fn].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    warnings = sorted({w for w in re.findall(r"ptxas warning : (.*)", log)})
    return dict(instances=out, warnings=warnings)


def sass_counts(sass: str) -> dict:
    """HGMMA, UTMALDG, HMMA, LDGSTS and local loads and stores of each
    ``flash_mma_kernel`` instance in a ``cuobjdump -sass`` listing."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0]
        k = re.search(r"flash_mma_kernelI(\w+?)EEv", name)
        if k:
            text = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", part)
            heads = [re.sub(r"^@!?U?P\w+\s+", "", t.strip()).split(" ")[0].split(".")[0] for t in text]
            # an HGMMA that waits for its predecessor: a WARPGROUP.DEPBAR between two of them (ptxas
            # serializes a wgmma pipeline it cannot prove safe)
            at = [i for i, o in enumerate(heads) if o == "HGMMA"]
            bars = [i for i, t in enumerate(text) if "DEPBAR" in t]
            serial = sum(1 for x, y in zip(at, at[1:]) if any(x < b < y for b in bars))
            out[instance(k.group(1))] = dict(**{op: heads.count(op) for op in (
                "HGMMA", "UTMALDG", "HMMA", "LDGSTS", "LDL", "STL", "USETMAXREG")}, serialized=serial,
                instructions=len(heads))
    return out


def bind(lib: Path):
    from repro_torch.kernels.flash_attention import ops

    fn = ctypes.CDLL(str(lib)).flash_attention
    fn.argtypes = ops._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(torch, fn, q, k, v, tile, causal=True, window=None, q_offset=0, o=None):
    """One launch of a build's C entry point (variant mma), as the wrapper
    makes it; returns o."""
    from repro_torch.kernels.flash_attention import ops

    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if o is None:
        o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    st = [ops._strides(t) for t in (q, k, v, o)]
    err = fn(2, 1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, hkv, sq, skv, d, *tile,
             *st[0], *st[1], *st[2], *st[3], 1.0 / math.sqrt(d), int(causal), int(window or 0), int(q_offset),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash launch failed with CUDA error {err} at tile {tile}, shape {tuple(q.shape)}")
    return o


def event_ms(torch, fn, flush, reps=10):
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


def bshd(torch, b, s, h, d, gen, scale=1.0):
    """A (B, H, S, D) view of a fresh (B, S, H, D) bf16 tensor, as the model's projections."""
    return (torch.randn(b, s, h, d, generator=gen, device="cuda") * scale).to(torch.bfloat16).transpose(1, 2)


def parity(torch, fn, tiles) -> list:
    """Section 3: every instance at every head dim on ragged, windowed,
    offset, zero-mass and single-head cases; held to attention_ref."""
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS, attention_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    # (B, Hq, Hkv, Sq, Skv, causal, window, q_offset)
    cases = [(2, 6, 2, 200, 200, True, None, 0), (2, 6, 3, 63, 200, True, 37, 100),
             (2, 5, 1, 129, 77, False, None, 0), (1, 4, 1, 37, 37, True, None, 0), (1, 3, 3, 1, 1, True, None, 0),
             (1, 6, 2, 70, 40, False, 4, 100), (1, 6, 2, 70, 40, True, 8, 30), (2, 4, 2, 300, 1100, True, 1024, 800)]
    rows = []
    for d in HEAD_DIMS:
        for b, hq, hkv, sq, skv, causal, window, off in cases:
            q, k = bshd(torch, b, sq, hq, d, gen), bshd(torch, b, skv, hkv, d, gen)
            # V: every column its own offset, so a column read from the wrong place shows
            v = (torch.randn(b, skv, hkv, d, generator=gen, device="cuda")
                 + torch.arange(d, device="cuda") / 8).to(torch.bfloat16).transpose(1, 2)
            kw = dict(causal=causal, window=window, q_offset=off)
            ref = attention_ref(q, k, v, **kw).float()
            for tile in tiles:
                got = launch(torch, fn, q, k, v, tile, **kw)
                again = launch(torch, fn, q, k, v, tile, **kw)
                torch.cuda.synchronize()
                err = (got.float() - ref).abs()
                bad = err > GATE[1] + GATE[0] * ref.abs()
                rows.append(dict(d=d, tile=list(tile), case=[b, hq, hkv, sq, skv, causal, window, off],
                                 max_abs_err=float(err.max()), bad=int(bad.sum()), same_bits=bool(torch.equal(got, again))))
    return rows


def sdpa_routes(torch, q, k, v, causal, window, off):
    """(best route, masked route) of SDPA for this cell as callables."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, hq, sq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    rows = torch.arange(sq, device="cuda")[:, None] + off
    cols = torch.arange(s, device="cuda")[None, :]
    keep = cols <= rows if causal else torch.ones(sq, s, dtype=torch.bool, device="cuda")
    if window:
        keep &= cols > rows - window
    kr, vr = k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv, 1)
    plain = not window and (not causal or (off == 0 and sq == s))
    gqa = dict(enable_gqa=True) if hq != hkv else {}
    if plain:
        best = lambda: sdpa(q, k, v, is_causal=causal, **gqa)  # noqa: E731
    else:
        best = lambda: sdpa(q, k, v, attn_mask=keep, **gqa)  # noqa: E731
    try:
        best()
    except (TypeError, RuntimeError):  # a torch without enable_gqa: the repeated K and V
        best = (lambda: sdpa(q, kr, vr, is_causal=causal)) if plain else (lambda: sdpa(q, kr, vr, attn_mask=keep))
    return best, (lambda: sdpa(q, kr, vr, attn_mask=keep)), keep


def timings(torch, fns, tiles, cells) -> list:
    """Section 4: each cell, parent and tree in turns, every tree instance,
    SDPA's two routes, the bound."""
    from repro_torch.kernels.flash_attention.ops import attention_ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(2**28, dtype=torch.int32, device="cuda")
    out = []
    for label, b, hq, hkv, s, sq, d, causal, window in cells:
        off = s - sq
        q, k, v = bshd(torch, b, sq, hq, d, gen), bshd(torch, b, s, hkv, d, gen), bshd(torch, b, s, hkv, d, gen)
        kw = dict(causal=causal, window=window, q_offset=off)
        best, masked, keep = sdpa_routes(torch, q, k, v, causal, window, off)
        pairs = int(keep.sum())
        bound = max(4 * b * hq * d * pairs / PEAK_BF16, (2 * b * hq * sq * d + 2 * b * hkv * s * d) * 2 / HBM) * 1e3
        ref = attention_ref(q, k, v, **kw).float()
        row = dict(cell=label, shape=[b, hq, hkv, sq, s, d], causal=causal, window=window, q_offset=off,
                   bound_ms=bound, turns=[], tiles={})
        order = [w for w in ("parent", "tree", "tree", "parent") if w in fns]
        default = tiles[0]
        for who in order:
            tile = (64, 64) if who == "parent" else default
            row["turns"].append(dict(who=who, tile=list(tile), ms=event_ms(
                torch, lambda: launch(torch, fns[who], q, k, v, tile, **kw), flush)))
        for who in [w for w in fns if w != "parent"]:
            for tile in tiles[:2] if who.startswith("diag") else tiles:
                got = launch(torch, fns[who], q, k, v, tile, **kw)
                err = float((got.float() - ref).abs().max())
                good = bool(((got.float() - ref).abs() <= GATE[1] + GATE[0] * ref.abs()).all())
                row["tiles"][f"{'' if who == 'tree' else who + ' '}{tile[0]}x{tile[1]}"] = dict(
                    ms=event_ms(torch, lambda: launch(torch, fns[who], q, k, v, tile, **kw), flush),
                    max_abs_err=err, good=good)
        row["sdpa_best_ms"] = event_ms(torch, best, flush)
        row["sdpa_masked_ms"] = event_ms(torch, masked, flush)
        for who in ("parent", "tree"):
            ms = [t["ms"] for t in row["turns"] if t["who"] == who]
            if ms:
                row[f"{who}_ms"] = statistics.mean(ms)
        tiles_txt = ", ".join(f"{t} {r['ms']:.4f}{'' if r['good'] else ' FAILED'}" for t, r in row["tiles"].items())
        print(f"cell {label:26s} B={b} Hq={hq} Hkv={hkv} Sq={sq} Skv={s} D={d}: parent (64x64) "
              f"{row.get('parent_ms', float('nan')):.4f} ms, tree {tiles[0][0]}x{tiles[0][1]} "
              f"{row['tree_ms']:.4f} ms (turns {[round(t['ms'], 4) for t in row['turns']]}); tree tiles: {tiles_txt}; "
              f"SDPA best {row['sdpa_best_ms']:.4f} ms, masked {row['sdpa_masked_ms']:.4f} ms; bound {bound:.4f} ms",
              flush=True)
        out.append(row)
        del q, k, v, ref, keep
    return out


def host_cost(torch, fns) -> dict:
    """Section 2: microseconds of one C entry call (its arguments built once,
    enqueue only) at a small shape: batches of 200 calls, the builds in
    turns, eight rounds; the median batch of each build."""
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = bshd(torch, 1, 64, 4, 64, gen), bshd(torch, 1, 64, 2, 64, gen), bshd(torch, 1, 64, 2, 64, gen)
    o = torch.empty((1, 64, 4, 64), dtype=torch.bfloat16, device="cuda").transpose(1, 2)
    st = [ops._strides(t) for t in (q, k, v, o)]
    args = (2, 1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, 4, 2, 64, 64, 64, 64, 64,
            *st[0], *st[1], *st[2], *st[3], 0.125, 1, 0, 0, torch.cuda.current_stream().cuda_stream)
    runs = {who: [] for who in fns}
    for r in range(8):
        for who in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            fn = fns[who]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn(*args)
            runs[who].append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
    return {who: statistics.median(r) for who, r in runs.items()}


def prefill_worker(root: Path, out: Path) -> int:
    """One turn of ``--prefills``: the package under ``root``'s ``src``, its
    kernels built there; writes the turn's times to ``out``."""
    import dataclasses

    sys.path.insert(0, str(root / "src"))
    for name in [m for m in sys.modules if m.startswith("repro_torch")]:
        del sys.modules[name]
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import from_fault_map, random_fault_map
    from repro_torch.kernels.common import build_kernels
    from repro_torch.models import model as M

    build_kernels(["masked_matmul", "flash_attention", "selective_scan"])
    dev = torch.device("cuda")
    rep = dict(root=str(root), runs={})

    def timed(run):
        runs = []
        for _ in range(PREFILL_RUNS):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        return runs

    with torch.no_grad():
        for arch in PREFILL_ARCHS:
            cfg = get_arch(arch)
            params = M.init_params(cfg, 0, device=dev)
            ctx = from_fault_map(random_fault_map(0, cfg.array_rows, cfg.array_cols, 0.1), "kernel", device=dev)
            g = torch.Generator(device=dev).manual_seed(0)
            tokens = torch.randint(0, cfg.vocab_size, (4, LONG), generator=g, device=dev)
            M.prefill(params, {"tokens": tokens[:, :256]}, cfg, ctx, attn_impl="kernel")
            torch.cuda.synchronize()
            rep["runs"][arch] = timed(lambda: M.prefill(params, {"tokens": tokens}, cfg, ctx, attn_impl="kernel"))
            del params
            torch.cuda.empty_cache()
        hub = get_arch("hubert-xlarge")
        params = M.init_params(hub, 0, device=dev)
        c = dataclasses.replace(hub, dtype="bfloat16")
        ctx = from_fault_map(random_fault_map(0, hub.array_rows, hub.array_cols, 0.1), "kernel", device=dev)
        frames = torch.as_tensor(np.random.default_rng(0).standard_normal((4, HUBERT_FRAMES, 512)),
                                 dtype=torch.float32, device=dev)
        M.forward(params, {"embeds": frames[:, :128]}, c, ctx, attn_impl="kernel")
        torch.cuda.synchronize()
        rep["runs"]["hubert-xlarge"] = timed(lambda: M.forward(params, {"embeds": frames}, c, ctx, attn_impl="kernel"))
    out.write_text(json.dumps(rep))
    return 0


def prefill_turns(parent: Path, stem: Path, card: str) -> dict:
    """``--prefills``: both trees' kernels built together, then one process
    a turn (parent, tree, tree, parent)."""
    trees = {"tree": ROOT, "parent": parent}
    if not (parent / SOURCE).exists():
        print(f"prefills: {parent} not found: the tree alone", flush=True)
        trees.pop("parent")
    code = "import sys; sys.path.insert(0, sys.argv[1] + '/src'); from repro_torch.kernels.common import " \
           "build_kernels; build_kernels(['masked_matmul', 'flash_attention', 'selective_scan'])"
    builds = [subprocess.Popen([sys.executable, "-c", code, str(r)]) for r in trees.values()]
    if any(b.wait() for b in builds):
        raise RuntimeError("prefills: a tree's kernels failed to build")
    turns = []
    for i, who in enumerate(w for w in ("parent", "tree", "tree", "parent") if w in trees):
        out = Path(f"{stem}.prefill{i}.json")
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--prefill-worker", str(trees[who]),
                               "--out", str(out)])
        if proc.returncode:
            raise RuntimeError(f"prefills: turn {i} ({who}) failed")
        rep = json.loads(out.read_text())
        rep.update(turn=i, who=who)
        turns.append(rep)
        for arch, runs in rep["runs"].items():
            print(f"prefills turn {i} {who} {arch} ({card}): {len(runs)} runs (host clock with a sync) "
                  + ", ".join(f"{t:.2f}" for t in runs) + f" ms; warm median {statistics.median(runs[1:]):.2f}",
                  flush=True)
    summary = {}
    for who in trees:
        for arch in (*PREFILL_ARCHS, "hubert-xlarge"):
            warm = [statistics.median(t["runs"][arch][1:]) for t in turns if t["who"] == who]
            summary[f"{who} {arch}"] = statistics.mean(warm)
            print(f"prefills {who} {arch}: mean of its turns' warm medians {statistics.mean(warm):.2f} ms "
                  f"({', '.join(f'{t:.2f}' for t in warm)})", flush=True)
    return dict(turns=turns, summary=summary)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=str(ROOT / "build" / "parent"))
    ap.add_argument("--out", default=str(ROOT / "build" / "flash_attention_probe.json"))
    ap.add_argument("--quick", action="store_true", help="sections 1-3 and the first cell of section 4")
    ap.add_argument("--diagnostics", action="store_true", help="time the DIAGNOSTICS copies beside the tree")
    ap.add_argument("--cells", default="", help="comma-separated indices of CELLS to time (default: all)")
    ap.add_argument("--prefills", action="store_true", help="section 5, the prefills in turns")
    ap.add_argument("--extra", action="append", default=[],
                    help="NAME=PATH: another flash_attention.cu built beside the tree's and timed at its tiles")
    ap.add_argument("--prefill-worker", default="", help=argparse.SUPPRESS)  # a checkout's root: one turn
    args = ap.parse_args(argv)
    out = Path(args.out)
    if args.prefill_worker:
        return prefill_worker(Path(args.prefill_worker), out)

    import torch

    if not torch.cuda.is_available():
        print("flash_attention_probe: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention.ops import TILES

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    parent = Path(args.parent)
    texts = {"tree": (ROOT / SOURCE).read_text()}
    if (parent / SOURCE).exists() and (parent / SOURCE).read_text() != texts["tree"]:
        texts["parent"] = (parent / SOURCE).read_text()
    else:
        print(f"no parent source under {parent} that differs from the tree's: the tree alone", flush=True)
    for extra in args.extra:
        name, path = extra.split("=", 1)
        texts[name] = Path(path).read_text()
    diagnostics = {f"diag {name}": patch(texts["tree"], p) for name, p in DIAGNOSTICS.items()} \
        if args.diagnostics else {}
    texts.update(diagnostics)
    built = build_all(common, texts)
    rep = dict(card=card, builds={}, sass={})
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for who, (lib, log, secs) in built.items():
        table = ptxas_table(log)
        sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True).stdout
        rep["builds"][who] = dict(seconds=secs, **table)
        rep["sass"][who] = sass_counts(sass)
        print(f"build {who}: {secs:.1f} s; ptxas warnings {table['warnings']}", flush=True)
        for line in log.splitlines():
            if ("arning" in line and "#177-D" not in line) or "Performance" in line or "serializ" in line:
                print(f"  {who} log: {line[:300]}", flush=True)
        if who == "tree":  # its whole listing (about 22 MB), for reading the instances' code
            sass_dir = out.parent / "flash_sass"
            sass_dir.mkdir(parents=True, exist_ok=True)
            (sass_dir / f"{who.replace(' ', '_')}.sass").write_text(sass)
        for inst, r in table["instances"].items():
            print(f"  {who} flash_mma_kernel<{inst}>: ptxas {r}; SASS {rep['sass'][who].get(inst)}", flush=True)
    fns = {who: bind(lib) for who, (lib, _, _) in built.items()}
    tiles = TILES["mma"]

    rep["host_us"] = host_cost(torch, fns)
    print(f"host cost of one C entry call (enqueue only, us): {rep['host_us']}", flush=True)
    rows = parity(torch, fns["tree"], tiles)
    bad = [r for r in rows if r["bad"] or not r["same_bits"]]
    rep["parity"] = dict(cases=len(rows), failed=bad, worst=max(r["max_abs_err"] for r in rows))
    print(f"parity: {len(rows)} launches at rtol, atol {GATE}: {len(bad)} failed; worst max abs err "
          f"{rep['parity']['worst']:.4g}", flush=True)
    for r in bad[:20]:
        print(f"  FAILED {r}", flush=True)
    cells = [CELLS[int(i)] for i in args.cells.split(",")] if args.cells else CELLS[:1] if args.quick else CELLS
    rep["cells"] = timings(torch, fns, tiles, cells)
    if args.prefills and not args.quick:
        rep["prefills"] = prefill_turns(parent, out.with_suffix(""), card)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rep, indent=1, default=str))
    print(f"wrote {out}", flush=True)
    return 1 if bad or any(not t["good"] for c in rep["cells"] for name, t in c["tiles"].items()
                           if not name.startswith("diag")) else 0


if __name__ == "__main__":
    sys.exit(main())
