#!/usr/bin/env python3
"""Where the time of the split-KV int8 decode-attention kernel goes, on one CUDA card.

    python3 tools/decode_attention_probe.py [--out build/decode_attention_probe.json]

1. The floor of the timing method: a one-element ``add_`` timed as the
   kernels are (CUDA events around one launch, the 50 MB L2 overwritten
   first).
2. The split rule: at each of ``chip_smoke.py``'s dense cells (bf16 q),
   the kernel's time for every split count in {1, 2, 4, ..., 64, the
   plan's, one per tile} at several tiles ``bkv``; the plan's count is
   starred.
3. The phases of one launch: a copy of ``csrc/decode_attention.cu`` with a
   ``%globaltimer`` stamp per block at the end of each phase (the prologue
   with q in shared memory, the first chunk landed, the chunk loop done,
   the block's partial stored, the arrival counted, the merge's inputs in
   shared memory, the merge done) is
   built into ``build/kernels`` and run at each cell's planned split
   count; each phase prints the median and the last block's time after the
   first block started.

It needs a card and ``nvcc``, and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELLS = [  # chip_smoke.py's dense cells: (label, (B, Hq, Hkv, S, D))
    ("tune-suite", (1, 2, 2, 512, 32)),
    ("smollm-b4", (4, 9, 3, 2048, 64)),
    ("smollm-b32", (32, 9, 3, 2048, 64)),
    ("hymba-b4", (4, 25, 5, 1024, 64)),
]
PHASES = ["prologue", "chunk 0 landed", "loop done", "partial stored", "arrived", "merged",
          "merge inputs in shared memory"]
STAMPS = [  # (anchor in the kernel, stamp inserted after it)
    ("  const Layout L = layout(a.bkv, D, a.G);\n", 0),
    ("  __syncthreads();\n\n  float m[GP], l[GP];\n", 1),
    ("    __syncwarp();                   // and so have the other lanes'\n", 2),
    ("  cp_async_wait<0>();\n  __syncwarp();\n", 3),
    ("  if (a.splits == 1) return;\n\n", 4),
    ("  if (!is_last) return;\n", 5),
    ("  if (tid == 0) a.counters[grp] = 0;\n", 6),
    ("    cp_async_wait<0>();\n    __syncthreads();\n", 7),
]


def stamped_source(src: str) -> str:
    """The kernel source with a globaltimer stamp per block after each phase."""
    head = """
__device__ unsigned long long probe_stamps[1 << 19];
__device__ __forceinline__ void probe_stamp(int k) {
  if (threadIdx.x) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  probe_stamps[((long long)blockIdx.y * gridDim.x + blockIdx.x) * 8 + k] = t;
}
"""
    out = src.replace("namespace {\n", "namespace {\n" + head, 1)
    for anchor, k in STAMPS:
        if anchor not in out:
            raise SystemExit(f"probe: anchor for stamp {k} not found in decode_attention.cu")
        stamp = f"    if (i == 0) probe_stamp({k});\n" if k == 2 else f"  probe_stamp({k});\n"
        out = out.replace(anchor, anchor + stamp, 1)
    return out + """
extern "C" int probe_read(void* host, long long n) {
  return (int)cudaMemcpyFromSymbol(host, probe_stamps, n * 8);
}
extern "C" int probe_clear(long long n) {
  void* p;
  cudaGetSymbolAddress(&p, probe_stamps);
  return (int)cudaMemset(p, 0, n * 8);
}
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "decode_attention_probe.json"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("decode_attention_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import common
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.tune import TuningCache, set_tuning_cache

    set_tuning_cache(TuningCache())  # the heuristic tile, not the committed table's tuned ones
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dev = torch.device("cuda")
    sms = da.sm_count(dev)
    flush = torch.empty(2**28, dtype=torch.int32, device=dev)

    def time_us(fn, reps=20):
        """Median of single launches, the L2 overwritten first (chip_smoke.py's method)."""
        fn()
        times = []
        for _ in range(reps):
            flush.zero_()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e) * 1e3)
        return statistics.median(times)

    one = torch.zeros(1, device=dev)
    report = dict(card=card, floor_us=time_us(lambda: one.add_(1)), sweep={}, phases={})
    print(f"floor: a one-element add_ {report['floor_us']:.2f} us")

    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = {}
    for label, (b, hq, hkv, s, d) in CELLS:
        ki, ks = da.quantize_kv(torch.randn(b, hkv, s, d, generator=gen, device=dev))
        vi, vs = da.quantize_kv(torch.randn(b, hkv, s, d, generator=gen, device=dev))
        q = torch.randn(b, hq, 1, d, generator=gen, device=dev).to(torch.bfloat16)
        inputs[label] = (q, (ki, ks, vi, vs))
        for bkv in (32, 64, 128, 256, 512, 1024):
            if bkv > s:
                continue
            tiles = -(-s // bkv)
            plan = da.split_plan(b, hkv, s, bkv, sms)
            row = {}
            for n in sorted({1, 2, 4, 8, 16, 32, 64, plan, tiles}):
                if n <= tiles:
                    row[n] = time_us(lambda: da.decode_attention(q, ki, ks, vi, vs, s, bkv=bkv, splits=n))
            report["sweep"][f"{label} bkv {bkv}"] = dict(plan=plan, us=row)
            print(f"sweep {label:10s} bkv {bkv:4d}: splits:us "
                  + " ".join(f"{n}{'*' if n == plan else ''}:{t:.2f}" for n, t in row.items()), flush=True)

    # the phases, from a stamped copy of the kernel
    src = (common.CSRC_DIR / "decode_attention.cu").read_text()
    common.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = common.BUILD_DIR / "decode_attention_probe.cu", common.BUILD_DIR / "decode_attention_probe.so"
    cu.write_text(stamped_source(src))
    subprocess.run([common._nvcc(), *common.NVCC_FLAGS, "-o", str(so), str(cu)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.decode_attention
    fn.argtypes, fn.restype = da._DENSE_ARGTYPES, ctypes.c_int
    lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.probe_clear.argtypes = [ctypes.c_longlong]
    saved = common._FNS.get("decode_attention")
    common._FNS["decode_attention"] = fn  # the wrapper launches the stamped copy
    try:
        for label, (b, hq, hkv, s, d) in CELLS:
            q, cache = inputs[label]
            call = lambda: da.decode_attention(q, *cache, s)  # noqa: E731
            timed = time_us(call)
            splits = da.decode_attention.last_splits
            n = b * hkv * da.head_chunks(hq // hkv) * splits * 8
            lib.probe_clear(n)
            flush.zero_()
            call()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * n)()
            lib.probe_read(buf, n)
            rows = [buf[i:i + 8] for i in range(0, n, 8)]
            t0 = min(r[0] for r in rows)
            phases = {}
            for k, name in enumerate(PHASES, start=1):
                v = sorted((r[k] - t0) / 1e3 for r in rows if r[k])
                if v:
                    phases[name] = dict(blocks=len(v), median_us=statistics.median(v), last_us=v[-1])
            phases = dict(sorted(phases.items(), key=lambda kv: kv[1]["median_us"]))
            report["phases"][label] = dict(splits=splits, timed_us=timed, phases=phases)
            print(f"phases {label} ({splits} splits, {timed:.2f} us timed), us after the first block started: "
                  + "; ".join(f"{k} {p['median_us']:.2f} (last {p['last_us']:.2f}, {p['blocks']} blocks)"
                              for k, p in phases.items()), flush=True)
    finally:
        if saved is not None:
            common._FNS["decode_attention"] = saved
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
