"""The kernel autotuner: a lint-gated search over a kernel's launch blocks.

For one ``(kernel, shape, dtype, backend)`` launch the tuner:

1. builds the candidate lattice of each tunable parameter
   (``repro_torch.tune.search``), its bound a function of the shape (the
   masked GEMM's K slices stop at the plan's own cap), and normalizes every
   raw point to the launch the wrapper would make, read off the
   ``analysis.kernelgeom`` launch builder, which runs the wrapper's own plan
   functions: points that collapse to one launch are timed once;
2. accepts or rejects each candidate statically through the geometry lint
   (KRN001: a tile that is not built, lanes the scan refuses, a K split
   beyond the cap; KRN002: the shared memory the CUDA kernel requests
   against the card's 227 KiB; KRN003: a degenerate launch): a rejected
   candidate is never launched;
3. times the survivors under a greedy hillclimb seeded at the heuristic
   (the wrapper's own choice with an empty cache): one warm-up call, then
   the fastest of ``iters`` launches timed by CUDA events with the L2
   flushed before each (a host clock on the CPU), with ``repro_torch.obs``
   recorder spans around every measurement;
4. records the winner with its speedup over the heuristic and its
   achieved-against-roofline fraction at the dtype's peak
   (:mod:`repro_torch.tune.roofline`) as a tuning-cache entry.

The heuristic seeds the climb, so the winner beats or ties it. Numerics do
not depend on the blocks beyond the order of fp32 sums.

The four spaces, with the reference's shape keys (``SHAPE_FIELDS``) so
cache keys match:

- ``masked_matmul``: ``splits``, the K slices (heuristic: ``gemm_plan``'s
  count); runs the launch the main path makes: bf16 x with the float32
  master w (``fault_linear`` in ``kernel`` mode), or float32 x and w, w
  row-major, under a 10%-faulty chip's mask;
- ``flash_attention``: ``bq, bkv``, the tile (heuristic 64 x 64; the
  lattice spans the built instances, ``flash_attention.ops.TILES``);
- ``decode_attention``: ``bkv``, the dense kernel's tile (heuristic 128);
- ``mamba_scan``: ``lanes``, the lanes a channel (heuristic:
  ``scan_plan``'s), with softplus dt and negative A as the model gives them.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional

import torch

from repro_torch.analysis.kernelgeom import (
    KernelLaunch,
    decode_attention_launch,
    flash_attention_launch,
    lint_launch,
    mamba_scan_launch,
    masked_matmul_launch,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.common import backend_tag, dtype_name
from repro_torch.kernels.flash_attention.ops import TILES as FLASH_TILES
from repro_torch.kernels.mamba_scan.ops import LANES
from repro_torch.kernels.masked_matmul.ops import max_splits, pick_variant
from repro_torch.obs.recorder import NULL_RECORDER
from repro_torch.tune.cache import TuningCache, cache_key
from repro_torch.tune.roofline import kernel_flops_bytes, roofline_fraction
from repro_torch.tune.search import hillclimb, lattice_neighbors, pow2_lattice

__all__ = [
    "KERNELS",
    "SHAPE_FIELDS",
    "HEURISTIC_BLOCKS",
    "KernelSpace",
    "TuneResult",
    "normalize_blocks",
    "lint_candidate",
    "tune_kernel",
    "tune_many",
]

# shape-key fields per kernel, in the reference's declaration order
SHAPE_FIELDS = {
    "masked_matmul": ("m", "k", "n", "r", "c"),
    "flash_attention": ("b", "hq", "hkv", "sq", "skv", "d", "causal"),
    "decode_attention": ("b", "hq", "hkv", "skv", "d"),
    "mamba_scan": ("b", "l", "d", "n"),
}

# the wrappers' heuristics, the hillclimb seed; None is the wrapper's plan, read off its launch
HEURISTIC_BLOCKS = {
    "masked_matmul": dict(splits=None),
    "flash_attention": dict(bq=64, bkv=64),
    "decode_attention": dict(bkv=128),
    "mamba_scan": dict(lanes=None),
}


def _dt(dtype) -> torch.dtype:
    return getattr(torch, dtype_name(dtype))


def _mm_launch(shape, dtype, blocks) -> KernelLaunch:
    return masked_matmul_launch(shape["m"], shape["k"], shape["n"], (shape["r"], shape["c"]),
                                dtype=_dt(dtype), splits=blocks["splits"])


def _fa_launch(shape, dtype, blocks) -> KernelLaunch:
    return flash_attention_launch(shape["b"], shape["hq"], shape["hkv"], shape["sq"], shape["skv"],
                                  shape["d"], bq=blocks["bq"], bkv=blocks["bkv"], dtype=_dt(dtype))


def _da_launch(shape, dtype, blocks) -> KernelLaunch:
    return decode_attention_launch(
        shape["b"], shape["hq"], shape["hkv"], shape["skv"], shape["d"], bkv=blocks["bkv"],
    )


def _ms_launch(shape, dtype, blocks) -> KernelLaunch:
    return mamba_scan_launch(shape["b"], shape["l"], shape["d"], shape["n"], lanes=blocks["lanes"])


def _mm_lattice(shape, dtype):
    """K slices 1, 2, 4, ... up to the plan's cap, and the cap itself."""
    kind = pick_variant(_dt(dtype), shape["m"])
    return dict(splits=pow2_lattice(max_splits(kind, shape["m"], shape["k"]), lo=1))


def _fa_lattice(shape, dtype):
    """Each tile coordinate over the values the built instances take."""
    return dict(bq=sorted({t[0] for t in FLASH_TILES}), bkv=sorted({t[1] for t in FLASH_TILES}))


def _da_lattice(shape, dtype):
    return dict(bkv=pow2_lattice(shape["skv"], lo=8))


def _ms_lattice(shape, dtype):
    return dict(lanes=list(LANES))


def _mm_runner(shape, dtype, device):
    from repro_torch.core import from_fault_map, random_fault_map
    from repro_torch.kernels.masked_matmul.ops import masked_matmul

    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((shape["m"], shape["k"]), generator=gen, device=device).to(dtype)
    w = torch.randn((shape["k"], shape["n"]), generator=gen, device=device)  # the fp32 master
    ok = from_fault_map(random_fault_map(0, shape["r"], shape["c"], 0.1), "kernel", device=device).ok

    def call(blocks):
        return masked_matmul(x, w, ok, **blocks)

    return call


def _fa_runner(shape, dtype, device):
    from repro_torch.kernels.flash_attention.ops import flash_attention

    gen = torch.Generator(device=device).manual_seed(0)
    b, hq, hkv, sq, skv, d = (shape[f] for f in SHAPE_FIELDS["flash_attention"][:6])
    q = torch.randn((b, hq, sq, d), generator=gen, device=device).to(dtype)
    k = torch.randn((b, hkv, skv, d), generator=gen, device=device).to(dtype)
    v = torch.randn((b, hkv, skv, d), generator=gen, device=device).to(dtype)
    causal = bool(shape.get("causal", 1))

    def call(blocks):
        return flash_attention(q, k, v, causal=causal, **blocks)

    return call


def _da_runner(shape, dtype, device):
    from repro_torch.kernels.decode_attention.ops import decode_attention, quantize_kv

    gen = torch.Generator(device=device).manual_seed(0)
    b, hq, hkv, skv, d = (shape[f] for f in SHAPE_FIELDS["decode_attention"])
    q = torch.randn((b, hq, 1, d), generator=gen, device=device).to(dtype)
    ki, ksc = quantize_kv(torch.randn((b, hkv, skv, d), generator=gen, device=device))
    vi, vsc = quantize_kv(torch.randn((b, hkv, skv, d), generator=gen, device=device))

    def call(blocks):
        return decode_attention(q, ki, ksc, vi, vsc, skv, **blocks)

    return call


def _ms_runner(shape, dtype, device):
    from repro_torch.kernels.mamba_scan.ops import selective_scan

    gen = torch.Generator(device=device).manual_seed(0)
    b, length, d, n = (shape[f] for f in SHAPE_FIELDS["mamba_scan"])
    u = torch.randn((b, length, d), generator=gen, device=device).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, length, d), generator=gen, device=device))
    a = -torch.exp(torch.randn((d, n), generator=gen, device=device))
    bb = torch.randn((b, length, n), generator=gen, device=device).to(dtype)
    cc = torch.randn((b, length, n), generator=gen, device=device).to(dtype)
    dd = torch.randn((d,), generator=gen, device=device)

    def call(blocks):
        return selective_scan(u, dt, a, bb, cc, dd, **blocks)[0]

    return call


@dataclass(frozen=True)
class KernelSpace:
    """One kernel's tunable space: its block parameters, each one's
    candidate lattice for a shape and dtype, the launch's geometry (the
    wrapper's own plan, via analysis.kernelgeom; the tuned parameters as
    launched are its ``params``) and the measurement runner."""

    params: tuple
    lattice: Callable[[Mapping, Any], Mapping[str, list]]
    build_launch: Callable[[Mapping, Any, Mapping], KernelLaunch]
    make_runner: Callable[[Mapping, Any, torch.device], Callable]


KERNELS: dict[str, KernelSpace] = {
    "masked_matmul": KernelSpace(("splits",), _mm_lattice, _mm_launch, _mm_runner),
    "flash_attention": KernelSpace(("bq", "bkv"), _fa_lattice, _fa_launch, _fa_runner),
    "decode_attention": KernelSpace(("bkv",), _da_lattice, _da_launch, _da_runner),
    "mamba_scan": KernelSpace(("lanes",), _ms_lattice, _ms_launch, _ms_runner),
}


@dataclass
class TuneResult:
    """Outcome of tuning one launch; ``entry`` is the cache-ready record."""

    kernel: str
    shape: dict
    dtype: str
    backend: str
    key: str
    heuristic_blocks: dict
    heuristic_s: float
    best_blocks: dict
    best_s: float
    speedup: float
    roofline_fraction: float
    smem_bytes: int
    evaluated: int
    rejected: int
    rejected_configs: list = field(default_factory=list)

    @property
    def entry(self) -> dict:
        return dict(
            blocks=dict(self.best_blocks),
            time_us=round(self.best_s * 1e6, 3),
            heuristic_us=round(self.heuristic_s * 1e6, 3),
            speedup=round(self.speedup, 4),
            roofline_fraction=self.roofline_fraction,
            smem_bytes=int(self.smem_bytes),
            backend=self.backend,
            evaluated=self.evaluated,
            rejected=self.rejected,
        )


def normalize_blocks(
    kernel: str, shape: Mapping[str, int], blocks: Mapping[str, Optional[int]], dtype: Any = torch.float32,
) -> dict:
    """Raw lattice point -> the blocks the wrapper would launch for it,
    read off the kernelgeom launch (which runs the wrapper's own rules: a
    clamp to the cache, the plan's count for None, empty K slices dropped)."""
    launch = KERNELS[kernel].build_launch(shape, dtype, dict(blocks))
    return {p: int(launch.params[p]) for p in KERNELS[kernel].params}


def lint_candidate(
    kernel: str,
    shape: Mapping[str, int],
    dtype: Any,
    blocks: Mapping[str, int],
) -> tuple[list, int]:
    """Static accept or reject of one candidate: (findings, the shared
    memory one block requests); no findings means it may launch."""
    launch = KERNELS[kernel].build_launch(shape, dtype, dict(blocks))
    return lint_launch(launch), launch.smem_bytes


def _fastest_s(fn: Callable, iters: int, device: torch.device) -> float:
    """One warm-up call (the build and first launch stay off the clock),
    then the fastest of ``iters`` calls: CUDA events on the card, the host
    clock on the CPU.

    On the card each timed call follows an overwrite of 1 GiB, which evicts
    the 50 MB L2 (a decode step finds each layer's cache cold) and keeps the
    device busy for about 0.3 ms, longer than the host takes to enqueue the
    call: the events then time the device alone. Without it, an idle device
    waits on the host's Python and ctypes work between the two events."""
    fn()
    best = math.inf
    if device.type == "cuda":
        flush = torch.empty(2**28, dtype=torch.int32, device=device)
        torch.cuda.synchronize(device)
        for _ in range(max(1, iters)):
            flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        del flush
    else:
        for _ in range(max(1, iters)):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def tune_kernel(
    kernel: str,
    shape: Mapping[str, int],
    dtype: Any = torch.float32,
    *,
    iters: int = 10,
    max_evals: int = 24,
    device: Any = None,
    recorder=NULL_RECORDER,
) -> TuneResult:
    """Tune one launch; see the module docstring. ``device`` defaults to the
    card and raises without one; ``device="cpu"`` times the plain version."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r} (have {sorted(KERNELS)})")
    space = KERNELS[kernel]
    shape = {k: int(v) for k, v in shape.items()}
    missing = [f for f in SHAPE_FIELDS[kernel] if f != "causal" and f not in shape]
    if missing:
        raise ValueError(f"{kernel} shape is missing fields {missing}")
    dev = resolve_device(device)
    backend = backend_tag(dev)
    dname = dtype_name(dtype)

    lattices = space.lattice(shape, dtype)
    runner = space.make_runner(shape, dtype, dev)

    timed: dict[tuple, float] = {}
    rejected: list[dict] = []

    def score(raw_blocks: Mapping[str, int]) -> Optional[float]:
        blocks = normalize_blocks(kernel, shape, raw_blocks, dtype)
        key = tuple(sorted(blocks.items()))
        if key in timed:
            return timed[key]
        findings, _ = lint_candidate(kernel, shape, dtype, blocks)
        if findings:
            recorder.count("tune.lint_rejected")
            rejected.append(dict(blocks=blocks, codes=[f.code for f in findings]))
            return None
        label = ",".join(f"{k}={v}" for k, v in sorted(blocks.items()))
        with recorder.timed(f"tune:{kernel}", proc="tune", track=kernel, args=dict(blocks=dict(blocks))):
            best = _fastest_s(lambda: runner(blocks), iters, dev)
        recorder.observe(f"tune.{kernel}.candidate_s", best, buckets=(1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0))
        recorder.instant(f"tuned:{label}", proc="tune", track=kernel, args=dict(seconds=best))
        timed[key] = best
        return best

    heuristic = normalize_blocks(kernel, shape, HEURISTIC_BLOCKS[kernel], dtype)
    heuristic_s = score(heuristic)
    if heuristic_s is None:
        raise ValueError(
            f"heuristic config {heuristic} for {kernel} {shape} fails the geometry lint: "
            "the launch is broken before tuning"
        )
    best, best_s, _ = hillclimb(
        heuristic, lambda b: lattice_neighbors(b, lattices), score, max_evals=max_evals,
    )
    # the blocks the wrapper launches for the winning lattice point (a raw point may collapse: 16 K
    # slices of 36 stages are 12), so the table holds what a launch reports in its ``last_*``
    best = normalize_blocks(kernel, shape, best, dtype)
    _, best_smem = lint_candidate(kernel, shape, dtype, best)
    flops, byts = kernel_flops_bytes(kernel, shape, dtype)
    return TuneResult(
        kernel=kernel,
        shape=dict(shape),
        dtype=dname,
        backend=backend,
        key=cache_key(kernel, shape, dname, backend),
        heuristic_blocks=heuristic,
        heuristic_s=heuristic_s,
        best_blocks=best,
        best_s=best_s,
        speedup=heuristic_s / best_s if best_s > 0 else float("inf"),
        roofline_fraction=roofline_fraction(flops, byts, best_s, dtype),
        smem_bytes=best_smem,
        evaluated=len(timed),
        rejected=len(rejected),
        rejected_configs=rejected,
    )


def tune_many(
    cells: list[tuple[str, Mapping[str, int]]],
    *,
    cache: Optional[TuningCache] = None,
    **kwargs,
) -> tuple[list[TuneResult], TuningCache]:
    """Tune a list of (kernel, shape) cells; the winners land in ``cache``
    (a new one when None). Returns (results, cache)."""
    cache = cache if cache is not None else TuningCache()
    results = []
    for kernel, shape in cells:
        res = tune_kernel(kernel, shape, **kwargs)
        cache.put(res.key, res.entry)
        results.append(res)
    return results, cache
