"""Analytic roofline terms for the port's kernels on one NVIDIA H100.

Per-kernel operation and byte counts (the same counts as the reference's
``tune/roofline.py``, so a fraction here and there describes the same work)
and the card's data-sheet peaks, so the autotuner can record the
achieved-against-roofline fraction of every winner:

    bound_s  = max(flops / peak_flops(dtype), bytes / HBM_BW)
    fraction = bound_s / measured_s

The peak follows the dtype, since the port's kernels run each dtype on other
units: bf16 on the tensor cores (``PEAK_FLOPS``), float32 on the SIMT cores
(``PEAK_FLOPS_FP32``), because tensor cores would round fp32 to tf32.
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.kernels.common import dtype_name

__all__ = ["PEAK_FLOPS", "PEAK_FLOPS_FP32", "HBM_BW", "peak_flops", "kernel_flops_bytes", "roofline_fraction"]

# H100 SXM, NVIDIA data sheet: dense bf16 tensor-core rate, fp32 rate outside the tensor
# cores, and HBM3 bandwidth
PEAK_FLOPS = 989e12  # FLOP/s, bf16 and fp16
PEAK_FLOPS_FP32 = 67e12  # FLOP/s, float32 on the SIMT cores
HBM_BW = 3.35e12  # bytes/s


def peak_flops(dtype) -> float:
    """The operation rate a kernel in ``dtype`` (a torch dtype or its name)
    can reach: the SIMT rate for float32, the tensor cores' otherwise."""
    return PEAK_FLOPS_FP32 if dtype_name(dtype) == "float32" else PEAK_FLOPS


def kernel_flops_bytes(kernel: str, shape: Mapping[str, int], dtype) -> tuple[float, float]:
    """(flops, device-memory bytes) of one logical kernel call.

    Shapes use the reference's tuning-cache field names. The counts are of
    the logical, unpadded problem: 2mnk GEMM FLOPs and one touch of each
    operand. ``dtype`` is a torch dtype or its name."""
    s = {k: int(v) for k, v in shape.items()}
    isz = getattr(torch, dtype_name(dtype)).itemsize
    if kernel == "masked_matmul":
        m, k, n, r, c = s["m"], s["k"], s["n"], s["r"], s["c"]
        flops = 2.0 * m * k * n + k * n  # GEMM + the fused mask multiply
        byts = (m * k + k * n + m * n) * isz + r * c * 4
        return flops, byts
    if kernel == "flash_attention":
        b, hq, sq, skv, d = s["b"], s["hq"], s["sq"], s["skv"], s["d"]
        causal = s.get("causal", 1)
        flops = 4.0 * b * hq * sq * skv * d  # qk^T + pv
        if causal and sq == skv:
            flops /= 2.0  # the masked half of the score matrix
        byts = (b * hq * sq * d * 2 + b * s["hkv"] * skv * d * 2) * isz
        return flops, byts
    if kernel == "decode_attention":
        b, hq, hkv, skv, d = s["b"], s["hq"], s["hkv"], s["skv"], s["d"]
        flops = 4.0 * b * hq * skv * d
        # int8 K/V and their f32 scales dominate; q and out are one token, counted at
        # 4 bytes whatever their dtype, as the reference counts them
        byts = 2.0 * b * hkv * skv * (d + 4) + 2.0 * b * hq * d * 4
        return flops, byts
    if kernel == "mamba_scan":
        b, length, d, n = s["b"], s["l"], s["d"], s["n"]
        flops = b * length * d * (8.0 * n + 2.0)
        byts = (4.0 * b * length * d + 2.0 * b * length * n) * isz + d * n * 4 + d * 4
        return flops, byts
    raise ValueError(f"unknown kernel {kernel!r}")


def roofline_fraction(flops: float, hbm_bytes: float, measured_s: float, dtype="bfloat16") -> float:
    """The bound over the measured time (1.0 runs at the bound), the
    operations at ``dtype``'s peak (the tuner passes the launch's dtype)."""
    if measured_s <= 0:
        return 0.0
    return max(flops / peak_flops(dtype), hbm_bytes / HBM_BW) / measured_s
