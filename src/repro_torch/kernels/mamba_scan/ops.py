"""Mamba-1 selective scan: the CUDA kernel's wrapper, its plain PyTorch
version, the one-step decode update and the launch count.

Kernel: ``kernels/csrc/selective_scan.cu``. It replaces the TPU kernel
``repro/kernels/mamba_scan/mamba_scan.py::selective_scan_pallas``.

Bound on an H100: bytes at the serving prefill (each input read once, y
written once); the one ``expf`` per (batch, step, channel, state) on the
special-function units can bound it instead at long prompts. The kernel
keeps each channel's state in registers for the whole sequence, stages the
shared B and C rows in shared memory and writes no intermediate to device
memory; one thread per channel leaves most of each SM idle (see the source).

``selective_scan`` launches the kernel for a CUDA tensor and counts the
launch in ``selective_scan.launches``; for a CPU tensor it runs
``selective_scan_ref``, the plain version. There is no fallback between the
two. The TPU wrapper pads L and D to block multiples for its BlockSpecs; the
kernel masks its own ragged edge, so nothing is padded here.

Decode runs ``selective_step``, plain PyTorch, on every device: the
reference runs its plain step at decode on the TPU too, with no kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import check_launch, load_kernel

__all__ = ["selective_scan", "selective_scan_ref", "selective_step"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 8
    + [ctypes.c_void_p]
)
MAX_STATE = 16  # the kernel keeps at most 16 states per channel in registers


def selective_scan_ref(u, dt, a, b, c, d):
    """Plain version, in fp32. u, dt: (B, L, D); a: (D, N); b, c: (B, L, N);
    d: (D,). Returns (y (B, L, D) in u's dtype, h_last (B, D, N) fp32)."""
    bsz, length, dim = u.shape
    u32, dt32, a32 = u.float(), dt.float(), a.float()
    da = torch.exp(dt32[..., None] * a32)  # (B, L, D, N)
    dbu = (dt32 * u32)[..., None] * b.float()[:, :, None, :]
    hs = torch.empty((length, bsz, dim, a.shape[1]), dtype=torch.float32, device=u.device)
    h = torch.zeros((bsz, dim, a.shape[1]), dtype=torch.float32, device=u.device)
    for t in range(length):
        h = hs[t] = da[:, t] * h + dbu[:, t]
    y = torch.einsum("lbdn,bln->bld", hs, c.float()) + u32 * d.float()
    return y.to(u.dtype), h


def selective_step(h, u_t, dt_t, a, b_t, c_t, d):
    """One decode step. h: (B, D, N) fp32; u_t, dt_t: (B, D); b_t, c_t: (B, N).
    Returns (y_t (B, D) in u_t's dtype, the new h)."""
    da = torch.exp(dt_t.float()[..., None] * a.float())
    h = da * h + (dt_t * u_t).float()[..., None] * b_t.float()[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, c_t.float()) + u_t * d
    return y.to(u_t.dtype), h


def selective_scan(u, dt, a, b, c, d):
    """(y, h_last) of the selective scan; shapes as ``selective_scan_ref``.

    On CUDA: u, b and c share a dtype (float32 or bfloat16); dt, a and d
    are float32 (the model's dt is fp32: a bf16 GEMM output plus the fp32
    bias). u, dt, b and c have a unit stride on their last axis and are
    read through their other strides, so b and c may be slices of one
    tensor; a and d are contiguous; N is at most 16."""
    if u.device.type == "cpu":
        return selective_scan_ref(u, dt, a, b, c, d)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cpu or cuda, got {u.device}")
    if u.dim() != 3 or a.dim() != 2 or d.dim() != 1:
        raise ValueError(f"bad shapes u{tuple(u.shape)} a{tuple(a.shape)} d{tuple(d.shape)}")
    bsz, length, dim = u.shape
    n = a.shape[1]
    if (tuple(dt.shape) != (bsz, length, dim) or tuple(a.shape) != (dim, n)
            or tuple(b.shape) != (bsz, length, n) or tuple(c.shape) != (bsz, length, n)
            or tuple(d.shape) != (dim,)):
        raise ValueError(
            f"bad shapes u{tuple(u.shape)} dt{tuple(dt.shape)} a{tuple(a.shape)} "
            f"b{tuple(b.shape)} c{tuple(c.shape)} d{tuple(d.shape)}"
        )
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"the CUDA kernel takes 1 to {MAX_STATE} states, got {n}")
    if u.dtype not in _DTYPES or b.dtype != u.dtype or c.dtype != u.dtype:
        raise TypeError(f"u, b and c must share float32 or bfloat16, got {u.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError(f"dt, a and d must be float32, got {dt.dtype}, {a.dtype}, {d.dtype}")
    if any(t.device != u.device for t in (dt, a, b, c, d)) or u.device.index != torch.cuda.current_device():
        raise ValueError("u, dt, a, b, c and d must lie on the current CUDA device")
    if any(t.stride(-1) != 1 for t in (u, dt, b, c)) or not (a.is_contiguous() and d.is_contiguous()):
        raise ValueError("u, dt, b and c need a unit last stride; a and d must be contiguous")
    y = torch.empty((bsz, length, dim), dtype=u.dtype, device=u.device)
    h_last = torch.empty((bsz, dim, n), dtype=torch.float32, device=u.device)
    if bsz and dim:
        fn = load_kernel("selective_scan", _ARGTYPES)
        err = fn(
            _DTYPES[u.dtype], u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), d.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            bsz, length, dim, n, u.stride(0), u.stride(1), dt.stride(0), dt.stride(1),
            b.stride(0), b.stride(1), c.stride(0), c.stride(1),
            torch.cuda.current_stream().cuda_stream,
        )
        check_launch("selective_scan", err)
        selective_scan.launches += 1
    return y, h_last


selective_scan.launches = 0
