"""Shared kernel-runtime layer: the per-dtype tolerance table, and the build
and binding of the hand-written CUDA kernels.

Kernels live in ``kernels/csrc/*.cu``, each with a plain C entry point. At
first use ``nvcc`` compiles a source for ``sm_90a`` into a shared library
under ``build/kernels/`` at the repository root (named by a hash of the
source and flags, so an edited source never loads a stale library), and
``ctypes`` loads it. Importing this module builds nothing, so the CPU tests
(which have no ``nvcc``) import every kernel module freely.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any, Iterable

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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_FNS: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_kernels(names: Iterable[str]) -> dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns each new build's compiler log
    (ptxas register and shared-memory report); raises on a failed build."""
    todo = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
    logs, failed = {}, []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n" + "\n".join(logs[n] for n in failed)
        )
    return logs


def load_kernel(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of ``csrc/<name>.cu``, built and bound on
    first use, then cached for the process."""
    fn = _FNS.get(name)
    if fn is None:
        build_kernels([name])
        fn = getattr(ctypes.CDLL(str(_lib_path(name))), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def check_launch(name: str, err: int) -> None:
    """Raise when a C entry point reports a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
