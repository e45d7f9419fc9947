"""The launches the geometry lint certifies for one architecture.

``kernel_launches(cfg)`` is the counterpart of the reference's
``analysis/programs.py::_kernel_launches``: the same kernels, in the same
order, at the same logical shapes, built by the port's launch builders
(``analysis/kernelgeom.py``) at the wrappers' heuristics. The rest of the
reference's module (its donation, recompile and sharding program registry)
lints XLA programs; it waits for the slice that ports those analyses.
``fleet_kernel_launches(cfg, chips)`` adds the launches only a fleet
makes: the reference gets them from ``jax.vmap`` of its kernels and lints
none of them.
"""
from __future__ import annotations

from repro_torch.analysis.kernelgeom import (
    KernelLaunch,
    decode_attention_launch,
    flash_attention_launch,
    mamba_scan_launch,
    masked_matmul_launch,
)
from repro_torch.models.moe import capacity

__all__ = ["kernel_launches", "fleet_kernel_launches"]

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


def fleet_kernel_launches(cfg, chips: int, *, batch: int = 4, prompt: int = 2048) -> list[KernelLaunch]:
    """The chip-batched launches a ``FleetServeEngine`` of ``chips`` chips
    makes for ``cfg`` with ``batch`` prompts of ``prompt`` tokens: a decode
    step's MLP GEMM (one launch over the chips), an MoE layer's expert
    GEMMs at decode (one launch over chips x experts, each expert's rows the
    batch's capacity slots) and the prefill's selective scan (one launch
    over chips x batch rows), as the family has them. Encoders have no
    decode path, and the fleet engines refuse them: none."""
    if cfg.is_encoder:
        return []
    d, f, mask = cfg.d_model, cfg.d_ff or 4 * cfg.d_model, (cfg.array_rows, cfg.array_cols)
    out = [masked_matmul_launch(batch, d, f, mask, dtype=cfg.dtype, chips=chips)]
    if cfg.has_moe:
        m = batch * capacity(batch, 1, cfg, 1.25)
        kw = dict(dtype=cfg.dtype, chips=chips, experts=cfg.num_experts)
        out += [masked_matmul_launch(m, d, f, mask, **kw), masked_matmul_launch(m, f, d, mask, **kw)]
    if cfg.has_ssm:
        out.append(mamba_scan_launch(batch, prompt, cfg.d_inner, cfg.ssm_state, chips=chips))
    return out
