"""Kernel geometry lint for the port's CUDA launches: checked before launch.

A launch with bad geometry fails when the card refuses it, the first time a
shape reaches it. Each failure is a pure function of static geometry, so
the lint checks it before anything is built or launched:

* KRN001 — a launch the wrapper refuses: a tile the kernel is not built
  for (flash attention's ``tiles_built``), lanes the scan's plan refuses
  (more than ``MAX_STATES_PER_LANE`` states a lane), or a K split beyond the
  masked GEMM's cap (``max_splits``). It takes the place of the
  reference's KRN001 (a block that does not divide its padded axis, or
  does not fit the mask period): the CUDA kernels mask their own ragged
  edge and pad nothing;
* KRN002 — the dynamic shared memory the CUDA kernel requests for this
  launch (each wrapper's own function: ``decode_attention.ops.smem_bytes``,
  ``flash_attention.ops.smem_bytes``) exceeds the card's 227 KiB per block
  (``kernels/common.py::SMEM_LIMIT_BYTES``). It replaces the reference's
  double-buffered VMEM sum;
* KRN003 — a degenerate launch: an empty or non-positive axis or tile.

The ``*_launch`` builders reproduce what the wrappers launch for given
logical shapes, through the wrappers' own plan functions, so linting the
shipped stack means building its launches (``analysis/programs.py::
kernel_launches``) and running :func:`lint_kernels` over them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.kernels.common import SMEM_LIMIT_BYTES
from repro_torch.kernels.decode_attention.ops import (
    GMAX,
    H100_SMS,
    head_chunks,
    launch_bkv,
    paged_tile,
    smem_bytes,
    split_plan,
)
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.mamba_scan import ops as ms
from repro_torch.kernels.masked_matmul import ops as mm

__all__ = [
    "KernelLaunch",
    "lint_launch",
    "lint_kernels",
    "masked_matmul_launch",
    "flash_attention_launch",
    "decode_attention_launch",
    "mamba_scan_launch",
]


@dataclass(frozen=True)
class KernelLaunch:
    """Static description of one kernel launch. ``dims`` are the logical
    axes the launch covers, ``blocks`` the extent of one block or step along
    each, ``smem_bytes`` the dynamic shared memory one block requests,
    ``grid`` the CUDA grid the wrapper launches (empty where not modelled),
    ``params`` the tunable parameters as launched (what the tuner reads
    back), ``refused`` why the wrapper would refuse the launch (empty
    where it takes it) and ``threads`` a block's threads (0 where not
    modelled)."""

    kernel: str
    dims: tuple
    blocks: tuple
    smem_bytes: int
    grid: tuple = ()
    params: dict = field(default_factory=dict)
    refused: str = ""
    threads: int = 0


def lint_launch(launch: KernelLaunch) -> list:
    """Every geometry finding for one launch; an empty list launches."""
    findings: list = []
    name = launch.kernel
    if launch.refused:
        findings.append(Finding(code="KRN001", entry_point=name, subject="launch", message=launch.refused))
    for axis, (d, b) in enumerate(zip(launch.dims, launch.blocks)):
        if b <= 0 or d <= 0:
            findings.append(Finding(
                code="KRN003", entry_point=name, subject=f"axis{axis}",
                message=f"degenerate launch axis {axis}: dim {d}, block {b}"))
    if launch.smem_bytes > SMEM_LIMIT_BYTES:
        findings.append(Finding(
            code="KRN002", entry_point=name, subject="smem",
            message=(f"one block requests {launch.smem_bytes / 1024:.1f} KiB of shared memory "
                     f"(limit {SMEM_LIMIT_BYTES / 1024:.1f} KiB): shrink the tile"),
            bytes=launch.smem_bytes))
    return findings


def lint_kernels(launches: Sequence[KernelLaunch]) -> tuple[list, dict]:
    """:func:`lint_launch` over a stack's launches: (findings, stats), the
    stats per launch as the reference's (``grid``, ``findings``) with
    ``smem_bytes`` in place of its ``vmem_bytes``; a kernel launched twice is
    keyed ``name[i]`` the second time."""
    findings: list = []
    stats: dict = {}
    for i, launch in enumerate(launches):
        f = lint_launch(launch)
        findings.extend(f)
        key = launch.kernel if launch.kernel not in stats else f"{launch.kernel}[{i}]"
        stats[key] = dict(grid=list(launch.grid), smem_bytes=int(launch.smem_bytes), findings=len(f))
    return findings, stats


def _dtype(dtype: Any) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def masked_matmul_launch(
    m: int,
    k: int,
    n: int,
    mask_shape: tuple,
    *,
    dtype: Any = torch.float32,
    splits: Optional[int] = None,
    chips: int = 1,
    experts: int = 1,
    k_contiguous: bool = False,
    sm_count: int = H100_SMS,
) -> KernelLaunch:
    """Geometry of ``masked_matmul`` with x of ``dtype`` (m, k), w (k, n)
    and a ``mask_shape`` mask, for ``chips`` stacks of ``experts`` in one
    launch (a fleet's chips x an MoE layer's experts: the grid's batch axis
    is every (chip, expert)): the variant the dtype and M pick, and
    ``gemm_plan``'s tiles, K slices and grid (``splits`` forced, as the
    wrapper forces a caller's or the cache's). ``dims`` are (M, N, K),
    ``blocks`` one tile's rows and columns and one slice's K; ``smem_bytes``
    is the mma kernel's dynamic shared memory for the fp32 master w, the
    larger of its two w dtypes, and the bf16 decode kernel's ring at the
    larger of its two (v1's kernels have static shared memory only)."""
    kind = mm.pick_variant(_dtype(dtype), m)
    r, c = mask_shape
    chips *= experts
    live = min(m, k, n, r, c, chips) > 0
    refused = ""
    if live and splits is not None and not 1 <= splits <= mm.max_splits(kind, m, k):
        refused = f"{kind} at M {m}, K {k} takes 1 to {mm.max_splits(kind, m, k)} K slices, not {splits}"
    if not live:
        return KernelLaunch("masked_matmul", (m, n, k), (0, 0, 0), 0, (), dict(splits=splits or 0))
    if refused:  # no geometry to check beyond the refusal
        return KernelLaunch("masked_matmul", (m, n, k), (1, 1, 1), 0, (), dict(splits=splits), refused)
    plan = mm.gemm_plan(kind, m, n, k, sm_count, chips, k_contiguous, splits)
    bm, bn, bk = plan.tile
    slice_k = -(-mm._tiles_k(kind, k, k_contiguous) // plan.splits) * bk
    return KernelLaunch(
        kernel="masked_matmul",
        dims=(m, n, k),
        blocks=(min(bm, m), min(bn, n), min(slice_k, k)),
        smem_bytes=(mm._mma_smem(bm) if kind == "mma" else
                    max(mm._dec_smem(m, size, k_contiguous) for size in (2, 4)) if kind == "decode" else 0),
        grid=plan.grid,
        params=dict(splits=plan.splits),
    )


def flash_attention_launch(
    batch: int,
    hq: int,
    hkv: int,
    sq: int,
    skv: int,
    head_dim: int,
    *,
    bq: Optional[int] = None,
    bkv: Optional[int] = None,
    dtype: Any = torch.float32,
    variant: str = "auto",
) -> KernelLaunch:
    """Geometry of ``flash_attention`` (B, H, S, D) at tile (bq, bkv), the
    variant's default where not given: the variant the dtype picks, one
    block per (sequence x query head, bq query rows) of ``fa.threads``
    threads, the instance's shared memory; refused where the tile or the
    head dim is not built for the variant (an over-limit v1 tile is refused
    by KRN002)."""
    dt = _dtype(dtype)
    kind = fa.pick_variant(dt, variant)
    bq = fa.DEFAULT_TILE[kind][0] if bq is None else bq
    bkv = fa.DEFAULT_TILE[kind][1] if bkv is None else bkv
    refused = ""
    if head_dim not in fa.HEAD_DIMS:
        refused = f"flash is built for head dims {fa.HEAD_DIMS}, not {head_dim}"
    elif (bq, bkv) not in (fa.TILES["v1"] if kind == "v1" and dt == torch.float32 else
                           fa.tiles_built(kind, dt, head_dim)):  # v1's tiles over the limit: KRN002
        refused = f"flash {kind} in {dt} at D = {head_dim} is built for tiles {fa.tiles_built(kind, dt, head_dim)}"
    q_tiles = -(-sq // bq) if bq > 0 else 0
    grid = (q_tiles, batch * hq) if kind == "mma" else (batch * hq, q_tiles)
    return KernelLaunch(
        kernel="flash_attention",
        dims=(batch * hq, sq, skv),
        blocks=(1, bq, bkv),
        smem_bytes=fa.smem_bytes(kind, bq, bkv, head_dim),
        grid=grid,
        params=dict(bq=bq, bkv=bkv),
        refused=refused,
        threads=fa.threads(kind, bq),
    )


def mamba_scan_launch(
    batch: int,
    length: int,
    dim: int,
    state: int,
    *,
    lanes: Optional[int] = None,
    chips: int = 1,
    sm_count: int = H100_SMS,
) -> KernelLaunch:
    """Geometry of ``selective_scan`` (B, L, D) with N states, for ``chips``
    chips in one launch (a fleet's prefill: the grid's rows are chips x B):
    ``lanes`` lanes a channel (``scan_plan``'s where None), the states a
    lane, the channels a block and the grid of chips x B x ceil(D /
    channels) blocks; lanes the plan refuses are KRN001. The shared memory
    is the C entry point's own (a chunk of time steps it sizes itself), so
    it is not modelled."""
    batch *= chips
    live = min(batch, length, dim) > 0 and 1 <= state <= ms.MAX_STATE
    if lanes is None and live:
        lanes = ms.scan_plan(batch, dim, state, sm_count).lanes
    try:
        plan = ms._plan(batch, dim, state, lanes) if live else None
        refused = ""
    except ValueError as e:
        plan, refused = None, str(e)
    if plan is None:  # degenerate, or refused with no geometry to check beyond the refusal
        return KernelLaunch("mamba_scan", (batch, dim, state), (1, 1, 1) if refused else (0, 0, 0), 0, (),
                            dict(lanes=lanes or 0), refused)
    return KernelLaunch(
        kernel="mamba_scan",
        dims=(batch, dim, state),
        blocks=(1, plan.channels, plan.lanes * plan.states),
        smem_bytes=0,
        grid=(plan.blocks,),
        params=dict(lanes=plan.lanes),
    )


def decode_attention_launch(
    batch: int,
    hq: int,
    hkv: int,
    skv: int,
    head_dim: int,
    *,
    bkv: int = 128,
    paged: bool = False,
    page_size: int = 0,
    sm_count: int = H100_SMS,
) -> KernelLaunch:
    """Geometry of ``decode_attention`` (int8 KV, ``skv`` the cache length)
    or, with ``paged=True``, of ``paged_decode_attention`` (``skv`` the
    table's span ``maxp * page`` in tokens, ``page_size`` the pool's page):
    one block per (sequence, KV head, chunk of at most GMAX query heads,
    split), each split whole tiles of keys (``split_plan`` on ``sm_count``
    SMs); ``grid`` is (sequence x KV head x head chunk, splits)."""
    group = hq // hkv if hkv > 0 else 0
    if paged:
        tile = paged_tile(page_size) if page_size > 0 else 0
    else:
        tile = launch_bkv(bkv, skv)
    live = min(batch, hkv, group, skv, tile) > 0
    splits = split_plan(batch, hkv, skv, tile, sm_count) if live else 0
    return KernelLaunch(
        kernel="paged_decode_attention" if paged else "decode_attention",
        dims=(batch * hkv, skv, group),
        blocks=(1, tile, min(group, GMAX)),
        smem_bytes=smem_bytes(max(tile, 0), head_dim, max(group, 0)),
        grid=(batch * hkv * head_chunks(max(group, 0)), splits),
        params=dict(bkv=tile),
    )
