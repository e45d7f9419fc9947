"""Shared kernel-runtime layer: the per-dtype tolerance table, the build and
binding of the hand-written CUDA kernels, the zeroed counters of split
launches, the card's SM count and shared-memory limit and the ``tuned_block``
seam between the wrappers and the tuning cache.

Kernels live in ``kernels/csrc/*.cu``, each with a plain C entry point. At
first use ``nvcc`` compiles a source for ``sm_90a`` into a shared library
under ``build/kernels/`` at the repository root (named by a hash of the
source, the ``csrc/`` headers it includes and the flags, so an edited
source or header never loads a stale library), and
``ctypes`` loads it. Importing this module builds nothing, so the CPU tests
(which have no ``nvcc``) import every kernel module freely.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Callable, Iterable, Mapping, Optional, Union

import numpy as np
import torch

__all__ = [
    "DEFAULT_TOLS",
    "dtype_tol",
    "assert_close",
    "CSRC_DIR",
    "BUILD_DIR",
    "NVCC_FLAGS",
    "build_kernels",
    "load_kernel",
    "check_launch",
    "under_vmap",
    "functorch_wrapped",
    "wants_grad",
    "SMEM_LIMIT_BYTES",
    "sm_count",
    "dtype_name",
    "backend_tag",
    "tuned_block",
    "split_counters",
]

# ---------------------------------------------------------------------------
# Per-dtype tolerances (the reference's table)
# ---------------------------------------------------------------------------

DEFAULT_TOLS: dict[torch.dtype, float] = {
    torch.bfloat16: 2e-2,
    torch.float16: 1e-2,
    torch.float32: 2e-5,
    torch.float64: 1e-12,
}


def dtype_tol(dtype: Any, *, atol_scale: float = 10.0) -> tuple[float, float]:
    """(rtol, atol) defaults for comparing a kernel against its reference."""
    rtol = DEFAULT_TOLS.get(dtype, 2e-5)
    return rtol, rtol * atol_scale


def _np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


def assert_close(actual, expected, dtype: Any = None, *, atol_scale: float = 10.0) -> None:
    """np.testing.assert_allclose with the shared per-dtype tolerances; both
    sides are compared in float32."""
    if dtype is None:
        dtype = getattr(actual, "dtype", torch.float32)
    rtol, atol = dtype_tol(dtype, atol_scale=atol_scale)
    np.testing.assert_allclose(_np32(actual), _np32(expected), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Building and loading the CUDA kernels
# ---------------------------------------------------------------------------

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC_DIR),
)

_FNS: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_bytes(path: Path) -> bytes:
    """A source's bytes and those of every header of ``csrc/`` it includes
    (``#include "..."``, followed into the headers), each once: what a
    build of it reads from this repository."""
    seen, todo, out = set(), [Path(path)], []
    while todo:
        p = todo.pop(0)
        if p in seen or not p.exists():
            continue
        seen.add(p)
        text = p.read_bytes()
        out.append(text)
        todo += [CSRC_DIR / m.decode() for m in _INCLUDE.findall(text)]
    return b"".join(out)


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1(source_bytes(CSRC_DIR / f"{name}.cu") + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_kernels(names: Iterable[str]) -> dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns each new build's compiler log
    (ptxas register and shared-memory report); raises on a failed build.
    ``build_kernels.seconds`` holds each new build's wall seconds."""
    todo = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    build_kernels.seconds = {}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    start = time.perf_counter()
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = open(path.with_suffix(f".{os.getpid()}.log"), "w+b")  # a file: a full pipe would stall nvcc
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, log)
    while len(build_kernels.seconds) < len(procs):
        for name, (proc, _, _) in procs.items():
            if name not in build_kernels.seconds and proc.poll() is not None:
                build_kernels.seconds[name] = time.perf_counter() - start
        time.sleep(0.05)
    logs, failed = {}, []
    for name, (proc, tmp, log) in procs.items():
        with log:
            log.seek(0)
            logs[name] = log.read().decode(errors="replace")
        os.remove(log.name)
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n" + "\n".join(logs[n] for n in failed)
        )
    return logs


build_kernels.seconds = {}


def load_kernel(name: str, argtypes: list, source: Optional[str] = None) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of ``csrc/<source>.cu`` (``source``
    defaults to ``name``), built and bound on first use, then cached for the
    process."""
    fn = _FNS.get(name)
    if fn is None:
        source = source or name
        build_kernels([source])
        fn = getattr(ctypes.CDLL(str(_lib_path(source))), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def check_launch(name: str, err: int) -> None:
    """Raise when a C entry point reports a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def under_vmap(*ts: torch.Tensor) -> bool:
    """True where one of the tensors is a ``torch.func.vmap`` batched
    tensor (it has no data pointer, and a wrapper's custom op and its vmap
    rule take it) and none is differentiated by ``torch.func.grad``. A
    differentiated call never reaches this check: the scan's wrapper sends
    one that asks for a gradient (:func:`wants_grad`) to its autograd
    function, whose forward and backward kernels ``vmap`` maps through the
    custom ops' rules, and the masked GEMM's training refuses ``kernel``
    mode off the CPU (``train/population.py``)."""
    ft = torch._C._functorch
    return any(ft.is_batchedtensor(t) for t in ts) and not any(ft.is_gradtrackingtensor(t) for t in ts)


def functorch_wrapped(*ts: torch.Tensor) -> bool:
    """True where one of the tensors is a ``torch.func`` wrapper, batched
    or grad-tracking: a backward under ``vmap`` of ``grad`` sees its
    batched cotangents through the grad level's wrappers."""
    ft = torch._C._functorch
    return any(ft.is_batchedtensor(t) or ft.is_gradtrackingtensor(t) for t in ts)


def wants_grad(*ts: torch.Tensor) -> bool:
    """True where a gradient is asked of the call: an input requires grad
    while autograd records, or is a ``torch.func.grad`` tracking tensor."""
    ft = torch._C._functorch
    return (any(ft.is_gradtrackingtensor(t) for t in ts)
            or (torch.is_grad_enabled() and any(t.requires_grad for t in ts)))


_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def split_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Zeroed int32 counters for one split launch on ``stream`` of
    ``device``: the last block of each group to arrive merges the group's
    partials and sets its counter back to 0, so a buffer is zeroed once (and
    again only when it grows), not per launch. Launches that share a buffer
    must run one at a time, so each stream has its own: launches on two
    streams may overlap. The masked GEMM and decode attention share it."""
    device = torch.device(device)
    key = (torch.cuda.current_device() if device.index is None else device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 1 << 14), dtype=torch.int32, device=device)
    return buf


# ---------------------------------------------------------------------------
# The card's SMs and shared memory, and the tuning-cache seam
# ---------------------------------------------------------------------------

_SMS: dict[int, int] = {}


def sm_count(device) -> int:
    """The card's SM count, read once per device; the wrappers' launch
    plans take it."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


# Dynamic shared memory one block of an H100 may use: 227 KiB of the SM's
# 256 KiB, above 48 KiB only after cudaFuncSetAttribute(...,
# cudaFuncAttributeMaxDynamicSharedMemorySize, bytes), which the kernels'
# C entry points set. It takes the place of the TPU's VMEM budget.
SMEM_LIMIT_BYTES = 232448


def dtype_name(dtype: Any) -> str:
    """The tuning-cache spelling of a dtype: ``float32``, ``bfloat16``, ...
    (the same names JAX uses). Takes a torch dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


def backend_tag(device: Any) -> str:
    """The backend component of a tuning-cache key: ``"cuda"`` where the
    wrapper launches its kernel, ``"cpu"`` where it runs the plain version.
    Timings of the two never share an entry."""
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def tuned_block(
    kernel: str,
    shape: Mapping[str, int],
    dtype: Any,
    *,
    device: Any,
    defaults: Union[Mapping[str, Optional[int]], Callable[[], Mapping[str, Optional[int]]]],
    overrides: Optional[Mapping[str, Optional[int]]] = None,
) -> dict[str, Optional[int]]:
    """The seam between the ``ops.py`` wrappers and the tuning cache.

    Resolution order, per block parameter:

    1. an explicit caller value (an ``overrides`` entry that is not None);
    2. the process-wide tuning cache (:mod:`repro_torch.tune.cache`) under
       the ``(kernel, shape, dtype, backend)`` key;
    3. the wrapper's heuristic ``defaults`` (a mapping, or a function that
       returns one, called only on a miss), so an empty cache changes
       nothing. A default of None leaves the choice to the wrapper's plan.

    Steps 2 and 3 are memoized per ``(kernel, shape, dtype, backend)``: the
    wrappers call this on every launch (a decode step of SmolLM-135M makes
    211 masked-GEMM calls), so a call after the first is one dict lookup.
    The memo is dropped whenever the process table is replaced or an entry
    is put into it (``repro_torch.tune.cache``). A wrapper's defaults must
    therefore depend on the key alone (and the card's SM count)."""
    from repro_torch.tune import cache as tc  # cycle-free at call time

    key = (kernel, tuple(shape.items()), dtype, device.type if isinstance(device, torch.device) else
           torch.device(device).type)
    blocks = tc.SEAM_MEMO.get(key)
    if blocks is None:
        blocks = dict(defaults() if callable(defaults) else defaults)
        blocks = {k: None if v is None else int(v) for k, v in blocks.items()}
        hit = tc.get_tuning_cache().lookup_blocks(kernel, shape, dtype_name(dtype), backend_tag(key[3]))
        if hit:
            for k in blocks:
                if k in hit:
                    blocks[k] = int(hit[k])
        tc.SEAM_MEMO[key] = blocks
    if overrides and any(v is not None for v in overrides.values()):
        blocks = dict(blocks)
        for k, v in overrides.items():
            if v is not None:
                blocks[k] = int(v)
    return blocks
