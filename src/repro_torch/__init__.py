"""PyTorch/CUDA port of the eFAT reproduction (``repro``), for one NVIDIA H100.

Layout mirrors the reference package: ``configs``, ``core`` (fault maps,
periodic masks, the fault context), ``kernels`` (hand-written CUDA for the
masked GEMM and flash attention, each beside its plain PyTorch version),
``models``, ``serve`` and ``launch``; ``convert`` hands the reference's
numpy parameters over for parity tests. Nothing here imports JAX.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
