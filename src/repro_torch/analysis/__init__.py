"""repro_torch.analysis: the program linter for the port's serve, train and
fleet stack, the counterpart of the reference's ``repro.analysis``.

Four passes (see the pass modules' docstrings):

* :mod:`~repro_torch.analysis.donation`: DON001, a loop-carried buffer that
  did not keep its storage through a dispatch. Eager PyTorch has no alias
  table, so the pass runs each entry point once on live tensors;
* :mod:`~repro_torch.analysis.recompile`: RCP001/RCP002, program signatures
  that grow without bound with request traffic;
* :mod:`~repro_torch.analysis.shardlint`: SHD001/SHD002, silent
  replication fallbacks and engine-owned-axis use in the layout rules;
* :mod:`~repro_torch.analysis.kernelgeom`: KRN001-KRN003, the CUDA
  kernels' launch geometry (tiles, lanes, splits, shared memory).

``analyze_stack`` runs them over the registry in
:mod:`~repro_torch.analysis.programs` and returns a :class:`Report`; the CLI
is ``python -m repro_torch.launch.analyze``, with a committed
``baseline.json`` so a check fails on NEW findings only.
"""
from __future__ import annotations

import os

from repro_torch.analysis.donation import ProgramSpec, donation_stats, lint_donation
from repro_torch.analysis.findings import Finding, Report, load_baseline
from repro_torch.analysis.kernelgeom import (
    KernelLaunch,
    decode_attention_launch,
    flash_attention_launch,
    lint_kernels,
    lint_launch,
    mamba_scan_launch,
    masked_matmul_launch,
)
from repro_torch.analysis.programs import (
    StackPrograms,
    build_stack,
    fleet_kernel_launches,
    kernel_launches,
)
from repro_torch.analysis.recompile import (
    EntryTraceModel,
    TraceRequest,
    lint_recompile,
    synthetic_trace,
)
from repro_torch.analysis.shardlint import FakeMesh, ShardingEntry, lint_sharding

__all__ = [
    "Finding",
    "Report",
    "load_baseline",
    "ProgramSpec",
    "lint_donation",
    "donation_stats",
    "EntryTraceModel",
    "TraceRequest",
    "synthetic_trace",
    "lint_recompile",
    "FakeMesh",
    "ShardingEntry",
    "lint_sharding",
    "KernelLaunch",
    "lint_launch",
    "lint_kernels",
    "masked_matmul_launch",
    "flash_attention_launch",
    "decode_attention_launch",
    "mamba_scan_launch",
    "kernel_launches",
    "fleet_kernel_launches",
    "StackPrograms",
    "build_stack",
    "analyze_stack",
    "default_baseline_path",
]

PASSES = ("donation", "recompile", "sharding", "kernels")


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), "baseline.json")


def analyze_stack(
    arch: str = "smollm-135m",
    *,
    programs: StackPrograms = None,
    min_bytes: int = 1 << 14,
    shard_min_bytes: int = 1 << 20,
    max_signatures: int = 8,
    passes: tuple = PASSES,
    device=None,
) -> Report:
    """Run the linter passes over one arch's stack; returns a :class:`Report`.

    ``min_bytes`` gates DON001 (per subject); ``shard_min_bytes`` gates
    SHD001. ``passes`` selects a subset. The donation pass runs the reduced
    entry points on ``device`` (default: the card; it raises without one
    unless ``device="cpu"``); the other three touch no device.
    """
    progs = programs if programs is not None else build_stack(arch, device=device)
    report = Report(meta=dict(arch=progs.arch, min_bytes=min_bytes))

    if "donation" in passes:
        f, stats = donation_stats(progs.donation_specs, min_bytes=min_bytes)
        report.extend(f)
        report.passes["donation"] = stats
    if "recompile" in passes:
        f, stats = lint_recompile(progs.trace_models, synthetic_trace(), max_signatures=max_signatures)
        report.extend(f)
        report.passes["recompile"] = stats
    if "sharding" in passes:
        f, stats = lint_sharding(progs.sharding_entries, min_bytes=shard_min_bytes)
        report.extend(f)
        report.passes["sharding"] = stats
    if "kernels" in passes:
        f, stats = lint_kernels(progs.kernel_launches)
        report.extend(f)
        report.passes["kernels"] = stats
    return report
