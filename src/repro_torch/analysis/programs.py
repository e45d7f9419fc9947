"""The launches the geometry lint certifies for one architecture.

``kernel_launches(cfg)`` is the counterpart of the reference's
``analysis/programs.py::_kernel_launches``: the same kernels, in the same
order, at the same logical shapes, built by the port's launch builders
(``analysis/kernelgeom.py``) at the wrappers' heuristics. The rest of the
reference's module (its donation, recompile and sharding program registry)
lints XLA programs; it waits for the slice that ports those analyses.
"""
from __future__ import annotations

from repro_torch.analysis.kernelgeom import (
    KernelLaunch,
    decode_attention_launch,
    flash_attention_launch,
    mamba_scan_launch,
    masked_matmul_launch,
)

__all__ = ["kernel_launches"]

# the reference's paged-decode shape: slots and tokens a page
_SLOTS = 4
_PAGE_SIZE = 8


def kernel_launches(cfg) -> list[KernelLaunch]:
    """Production-representative launches of every kernel for ``cfg``: the
    masked GEMM at a full-sequence MLP shape (2048 tokens x d_model -> d_ff),
    flash attention at 8 x 2048^2, dense decode attention over 4096 keys,
    paged decode attention over the reference's pool, and the SSM scan,
    which ships whatever the family."""
    hq = cfg.num_heads or 8
    hkv = cfg.num_kv_heads or hq
    hd = cfg.resolved_head_dim or 64
    return [
        masked_matmul_launch(2048, cfg.d_model, cfg.d_ff or 4 * cfg.d_model,
                             (cfg.array_rows, cfg.array_cols), dtype=cfg.dtype),
        flash_attention_launch(8, hq, hkv, 2048, 2048, hd, dtype=cfg.dtype),
        decode_attention_launch(8, hq, hkv, 4096, hd),
        decode_attention_launch(_SLOTS, hq, hkv, 4096, hd, paged=True, page_size=_PAGE_SIZE),
        mamba_scan_launch(8, 2048, 1536, 16),
    ]
