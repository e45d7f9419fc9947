"""Dry-run core: each (arch x shape x mesh) cell's per-device bytes under
the layout rules, and its FLOPs from one run of its step on meta tensors.

The port's counterpart of the reference's ``launch/dryrun_lib.py``. The
reference lowers and compiles each cell for XLA and reads the compiled
program; the port has no compiler to ask, and keeps the two parts that do
not need one:

* ``sharded_bytes``: the analytic per-device bytes of params, optimizer
  moments and cache under the resolved layouts, equal to the reference's
  (the same rules, ``launch/sharding.py``, on the same production mesh);
* ``flops_total``: the cell's step run once on ``torch.device("meta")``
  tensors under ``torch.utils.flop_counter.FlopCounterMode``, for the
  global batch (not per device), the backward included for a train cell.
  FlopCounterMode counts products only (matmuls, einsum contractions,
  convolutions, and the formulas the kernels' custom ops register:
  ``kernels/masked_matmul/ops.py``, ``kernels/mamba_scan/ops.py``); the
  elementwise work XLA's ``flops`` also counts is not in it, so the two
  are not comparable.

XLA's ``memory_analysis``, its HLO cost model (``launch/hlo_cost.py``) and
the collectives read off the compiled program have no counterpart here.
Import-safe: nothing touches a card.
"""
from __future__ import annotations

import json
import os
import time
import traceback
from dataclasses import replace
from typing import Any, Callable, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.tree import flatten, is_struct, leaf_bytes
from repro_torch.configs import SHAPES, ShapeConfig, cell_skip_reason, get_arch
from repro_torch.core.masking import FaultContext
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.policy import launch_policy
from repro_torch.launch.sharding import MeshContext, is_axes_leaf, make_rules_for_mesh, resolve_spec
from repro_torch.launch.specs import META, cache_struct, input_specs, opt_struct, param_struct
from repro_torch.models import model as M
from repro_torch.train.optimizer import AdamWConfig, opt_state_specs
from repro_torch.train.step import make_train_step

__all__ = ["sharded_bytes", "build_cell", "run_cell"]


def sharded_bytes(specs, structs, mctx: MeshContext) -> float:
    """Analytic per-device bytes of a tree under the resolved layouts."""
    values = dict(flatten(structs, is_leaf=is_struct))
    total = 0.0
    for path, axes in flatten(specs, is_leaf=is_axes_leaf):
        v = values[path]
        shards = 1
        for entry in resolve_spec(axes, tuple(v.shape), mctx):
            if entry is not None:
                shards *= mctx.axis_size(entry)
        total += leaf_bytes(v) / shards
    return total


def _ctx(cfg, mode: str) -> FaultContext:
    if mode == "none":
        return FaultContext(ok=None, mode="none")
    return FaultContext(ok=torch.empty((cfg.array_rows, cfg.array_cols), device=META), mode=mode)


def build_cell(
    arch: str,
    shape_name,
    *,
    multi_pod: bool = False,
    fault_mode: str = "fap",
    moe_impl: str = "einsum",
    profile: str = "baseline",
    mesh=None,
    overrides: Optional[dict] = None,
    cfg=None,
) -> tuple[Callable[[], Any], dict]:
    """Returns (step, info) for one cell: ``step()`` runs the cell's program
    once on meta tensors. ``shape_name`` names a ``SHAPES`` cell or is a
    ``ShapeConfig``; ``mesh=None`` -> the production mesh; ``cfg`` replaces
    the registry's config of ``arch`` (tests pass reduced ones)."""
    cfg = cfg if cfg is not None else get_arch(arch)
    shape = shape_name if isinstance(shape_name, ShapeConfig) else SHAPES[shape_name]
    skip = cell_skip_reason(cfg, shape)
    if skip:
        raise ValueError(f"cell skipped: {skip}")
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    n_pod = mesh.shape.get("pod", 1)
    n_data = mesh.shape["data"]
    pol = launch_policy(cfg, shape, n_data=n_data, n_pod=n_pod, moe_impl=moe_impl, profile=profile)
    if overrides:
        pol = replace(pol, **overrides)
    mctx = make_rules_for_mesh(
        cfg, mesh, fsdp=pol.fsdp, seq_shard=pol.seq_shard, seq_rule=pol.seq_rule,
        moe_slot_shard=pol.moe_slot_shard,
    )
    ctx = _ctx(cfg, fault_mode)
    params, specs = param_struct(cfg)
    batch, _ = input_specs(cfg, shape)
    info: dict[str, Any] = dict(
        arch=arch,
        shape=shape.name,
        kind=shape.kind,
        mesh=dict(mesh.shape),
        policy=pol.describe(),
        fault_mode=fault_mode,
        param_bytes_per_device=sharded_bytes(specs, params, mctx),
        params_total=cfg.param_count(),
    )

    if shape.kind == "train":
        ocfg = AdamWConfig(moment_dtype=pol.moment_dtype, learning_rate=1e-4)
        train_step = make_train_step(
            cfg, ocfg, attn_impl=pol.attn_impl, moe_impl=pol.moe_impl, remat=pol.remat,
            microbatches=pol.microbatches, fault_apply=pol.fault_apply,
        )
        opt = opt_struct(cfg, params, pol.moment_dtype)
        info["opt_bytes_per_device"] = sharded_bytes(opt_state_specs(specs), opt, mctx)

        def step():
            return train_step(params, opt, batch, ctx)
    else:
        cache = cache_struct(cfg, shape.global_batch, shape.seq_len)
        info["cache_bytes_per_device"] = sharded_bytes(M.cache_specs(cfg), cache, mctx)
        if shape.kind == "prefill":
            def step():
                return M.prefill(params, batch, cfg, ctx, attn_impl=pol.attn_impl, moe_impl=pol.moe_impl)
        else:
            # the step runs at the cache's last position: the attention reads
            # the whole buffer at any index
            cache["index"] = shape.seq_len - 1
            tokens = torch.empty((shape.global_batch, 1), dtype=torch.int64, device=META)

            def step():
                return M.decode_step(params, tokens, cache, cfg, ctx, moe_impl=pol.moe_impl)
    return step, info


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    fault_mode: str = "fap",
    moe_impl: str = "einsum",
    profile: str = "baseline",
    out_dir: Optional[str] = None,
    overrides: Optional[dict] = None,
    cfg=None,
) -> dict:
    """One cell's ``info`` with ``flops_total`` and ``status`` (``ok`` or
    ``error`` with ``error``); written to ``out_dir`` when given."""
    t0 = time.time()
    try:
        step, info = build_cell(
            arch, shape_name, multi_pod=multi_pod, fault_mode=fault_mode, moe_impl=moe_impl,
            profile=profile, overrides=overrides, cfg=cfg,
        )
        info["build_seconds"] = time.time() - t0
        t1 = time.time()
        with FlopCounterMode(display=False) as counter:
            step()
        info["flops_total"] = int(counter.get_total_flops())
        info["flops_note"] = "products only (FlopCounterMode), whole global batch, not per device"
        info["count_seconds"] = time.time() - t1
        info["status"] = "ok"
    except Exception as e:
        info = dict(
            arch=arch, shape=shape_name, status="error",
            error=f"{type(e).__name__}: {e}",
            traceback=traceback.format_exc()[-2000:],
        )
    info["multi_pod"] = multi_pod
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = "pod2" if multi_pod else "pod1"
        with open(os.path.join(out_dir, f"{arch}__{shape_name}__{tag}.json"), "w") as f:
            json.dump(info, f, indent=1, default=str)
    return info
