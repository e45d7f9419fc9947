"""Fault-masked GEMM: the CUDA kernel's wrapper, its plain PyTorch version
and its launch count.

Kernel: ``kernels/csrc/masked_matmul.cu``. It replaces the TPU kernel
``repro/kernels/masked_matmul/masked_matmul.py::masked_matmul_pallas``.

Bound on an H100: at decode (M = batch) the weight bytes bound it, so the
kernel reads each weight once, applies the mask on chip and never writes a
masked copy; ``w`` is taken through its strides so the tied unembedding's
``embed.T`` is read in place, and K is split across blocks so a narrow GEMM
still spreads its reads over the whole card. At prefill (M = batch x prompt)
operations bound it; this first version uses fp32 SIMT FMAs, not tensor
cores.

``masked_matmul`` launches the kernel for a CUDA tensor and counts the launch
in ``masked_matmul.launches``; for a CPU tensor it runs
``masked_matmul_ref``, the plain version. There is no fallback between the
two.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.mapping import periodic_mask
from repro_torch.kernels.common import check_launch, load_kernel

__all__ = ["masked_matmul", "masked_matmul_ref"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
    + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
)
# (BM, BN, BK) of the kernel's tiles for small M (decode) and otherwise; these
# mirror the dispatch in csrc/masked_matmul.cu, which checks the scratch sizes
_SMALL_M = 16
_TILES = {True: (16, 64, 32), False: (64, 64, 16)}


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split_plan(m: int, n: int, k: int, sms: int) -> tuple[int, int]:
    """(K slices, scratch bytes): K is split until about two blocks per SM
    are in flight, or every slice holds one K tile. A split needs one int
    counter per output tile (16-byte aligned) and every slice's fp32
    partial output."""
    bm, bn, bk = _TILES[m <= _SMALL_M]
    tiles_out = math.ceil(m / bm) * math.ceil(n / bn)
    tiles_k = max(1, math.ceil(k / bk))
    want = min(tiles_k, math.ceil(2 * sms / tiles_out))
    if want <= 1:
        return 1, 0
    splits = math.ceil(tiles_k / math.ceil(tiles_k / want))
    return splits, -(-4 * tiles_out // 16) * 16 + 4 * splits * m * n


def masked_matmul_ref(x: torch.Tensor, w: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Plain version: y = x @ (w * periodic_mask(ok)) with fp32 accumulation.
    x: (..., K); w: (K, N); ok: (R, C) 1/0 healthy mask."""
    mask = periodic_mask(w.shape, ok, dtype=torch.float32)
    wm = (w.float() * mask).to(w.dtype)
    return torch.matmul(x.float(), wm.float()).to(x.dtype)


def masked_matmul(x: torch.Tensor, w: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """y = x @ (w * periodic_mask(ok)); x: (..., K), w: (K, N), ok: (R, C).

    On CUDA: x and w share a dtype (float32 or bfloat16), w has a unit
    stride along one of its axes, ok is a contiguous float32 tensor."""
    if x.device.type == "cpu":
        return masked_matmul_ref(x, w, ok)
    if x.device.type != "cuda":
        raise ValueError(f"masked_matmul runs on cpu or cuda, got {x.device}")
    if w.dim() != 2 or ok.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"bad shapes x{tuple(x.shape)} w{tuple(w.shape)} ok{tuple(ok.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"masked_matmul takes float32 or bfloat16 x and w alike, got {x.dtype}, {w.dtype}")
    if ok.dtype != torch.float32 or not ok.is_contiguous():
        raise TypeError("ok must be a contiguous float32 (R, C) mask")
    if w.device != x.device or ok.device != x.device or x.device.index != torch.cuda.current_device():
        raise ValueError("x, w and ok must lie on the current CUDA device")
    if w.stride(1) != 1 and w.stride(0) != 1:
        raise ValueError(f"w needs a unit stride along one axis, got strides {w.stride()}")
    kdim, n = w.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, kdim).contiguous()
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m and n:
        splits, scratch_bytes = _split_plan(m, n, kdim, _num_sms(x.device.index))
        scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=x.device)
        fn = load_kernel("masked_matmul", _ARGTYPES)
        err = fn(
            _DTYPES[x.dtype], x2.data_ptr(), w.data_ptr(), ok.data_ptr(), y.data_ptr(),
            m, n, kdim, w.stride(0), w.stride(1), ok.shape[0], ok.shape[1],
            splits, scratch.data_ptr(), scratch_bytes, torch.cuda.current_stream().cuda_stream,
        )
        check_launch("masked_matmul", err)
        masked_matmul.launches += 1
    return y.reshape(*lead, n)


masked_matmul.launches = 0
