"""Static checks of the port's launches before anything runs: the kernel
geometry lint (``kernelgeom.py``: the four kernels' launch builders,
``lint_launch`` and ``lint_kernels``), the launches it certifies for each
architecture (``programs.py::kernel_launches``) and its ``Finding`` record
(``findings.py``). The reference's donation, recompile and sharding passes
are JAX-specific and have no counterpart here."""
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.kernelgeom import (
    KernelLaunch,
    decode_attention_launch,
    flash_attention_launch,
    lint_kernels,
    lint_launch,
    mamba_scan_launch,
    masked_matmul_launch,
)
from repro_torch.analysis.programs import kernel_launches

__all__ = [
    "Finding",
    "KernelLaunch",
    "lint_launch",
    "lint_kernels",
    "masked_matmul_launch",
    "flash_attention_launch",
    "decode_attention_launch",
    "mamba_scan_launch",
    "kernel_launches",
]
