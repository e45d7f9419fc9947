"""Kernel geometry lint for the port's CUDA launches: checked before launch.

A launch with bad geometry fails when the card refuses it, the first time a
shape reaches it. Each failure is a pure function of static geometry, so
the lint checks it before anything is built or launched:

* KRN002 — the dynamic shared memory the CUDA kernel requests for this
  tile, head dim and query group (``kernels/decode_attention/ops.py::
  smem_bytes``, the very function the wrapper launches with) exceeds the
  card's 227 KiB per block (``kernels/common.py::SMEM_LIMIT_BYTES``). It
  replaces the reference's double-buffered VMEM sum;
* KRN003 — a degenerate launch: an empty or non-positive axis or tile.

The reference's KRN001 (a block that does not divide its padded axis) has
no counterpart: the CUDA kernels mask their own ragged edge and pad
nothing. The ``*_launch`` builders reproduce the geometry the wrappers
launch for given logical shapes.
"""
from __future__ import annotations

from dataclasses import dataclass

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

__all__ = ["KernelLaunch", "lint_launch", "decode_attention_launch"]


@dataclass(frozen=True)
class KernelLaunch:
    """Static description of one kernel launch. ``dims`` are the logical
    axes the launch covers (blocks first, then the axis the block walks in
    tiles), ``blocks`` the extent of one block or step along each,
    ``smem_bytes`` the dynamic shared memory one block requests, and
    ``grid`` the CUDA grid the wrapper launches (empty where not modelled)."""

    kernel: str
    dims: tuple
    blocks: tuple
    smem_bytes: int
    grid: tuple = ()


def lint_launch(launch: KernelLaunch) -> list:
    """Every geometry finding for one launch; an empty list launches."""
    findings: list = []
    name = launch.kernel
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
    )
