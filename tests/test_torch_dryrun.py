"""The port's dry run against the reference's, on the CPU.

Per-device bytes: for every runnable (arch, shape) cell on both production
meshes (16 x 16 and 2 x 16 x 16), the port's ``param_bytes_per_device``,
``opt_bytes_per_device`` and ``cache_bytes_per_device`` equal the
reference's ``sharded_bytes`` under the same ``launch_policy`` and
``make_rules_for_mesh`` on a ``FakeMesh`` of the same shape, with no
compile. Tolerance: exact equality.

FLOPs: on reduced configs of the dense, MoE, SSM and hybrid families, the
dry run's ``flops_total`` of a train, a prefill and a decode cell equals a
count made here by hand: 2 * M * K * N over the config's GEMMs
(``gemm_shapes``), the attention products over the keys the kernels'
plain versions visit, the MoE dispatch contractions and the scan's formula
(2 * B * L * D * N); a train cell adds the backward (a product per operand
that takes a gradient) and one more forward of each layer (the policy's
``remat="full"``) but its last product: non-reentrant checkpointing stops
recomputing once every tensor the backward saved is back, and the last
product's output is not one of them. An einsum whose contracted axis has
length 1 (a decode step's dispatch over its one token) is an elementwise
product, which FlopCounterMode does not count. Tolerance: exact for
products.
"""
import functools
import math
from collections import Counter

import pytest

from repro.analysis.shardlint import FakeMesh as JaxFakeMesh
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.configs import valid_cells as jax_valid_cells
from repro.launch import dryrun_lib as jax_dryrun
from repro.launch import specs as jax_specs
from repro.launch.policy import launch_policy as jax_launch_policy
from repro.launch.sharding import make_rules_for_mesh as jax_rules
from repro.models import model as JM
from repro.train.optimizer import opt_state_specs as jax_opt_state_specs
from repro_torch.configs import SHAPES, get_arch, reduce_config, valid_cells
from repro_torch.launch.dryrun_lib import build_cell, run_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.policy import launch_policy
from repro_torch.models.model import cache_buffer_len
from repro_torch.models.moe import capacity

MESHES = {"pod1": dict(data=16, model=16), "pod2": dict(pod=2, data=16, model=16)}
CELLS = valid_cells()


def test_cells_and_shapes_are_the_references():
    assert CELLS == jax_valid_cells()
    assert {k: vars(v) for k, v in SHAPES.items()} == {k: vars(v) for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_launch_policy_is_the_references(arch, shape):
    for n_pod in (1, 2):
        for profile in ("baseline", "optimized"):
            got = launch_policy(get_arch(arch), SHAPES[shape], n_pod=n_pod, profile=profile)
            want = jax_launch_policy(jax_get_arch(arch), JAX_SHAPES[shape], n_pod=n_pod, profile=profile)
            assert vars(got) == vars(want)


@pytest.mark.parametrize("multi_pod", [False, True], ids=list(MESHES))
def test_production_mesh(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert mesh.shape == MESHES["pod2" if multi_pod else "pod1"]
    assert {d.type for d in mesh.devices.flat} == {"meta"}


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax_specs.param_struct(jax_get_arch(arch))


def _jax_bytes(arch, shape_name, mesh_axes):
    cfg, shape = jax_get_arch(arch), JAX_SHAPES[shape_name]
    pol = jax_launch_policy(cfg, shape, n_data=mesh_axes["data"], n_pod=mesh_axes.get("pod", 1))
    mctx = jax_rules(cfg, JaxFakeMesh.of(**mesh_axes), fsdp=pol.fsdp, seq_shard=pol.seq_shard,
                     seq_rule=pol.seq_rule, moe_slot_shard=pol.moe_slot_shard)
    params_s, specs = _jax_params(arch)
    out = dict(param_bytes_per_device=jax_dryrun.sharded_bytes(specs, params_s, mctx))
    if shape.kind == "train":
        opt_s = jax_specs.opt_struct(cfg, params_s, pol.moment_dtype)
        out["opt_bytes_per_device"] = jax_dryrun.sharded_bytes(jax_opt_state_specs(specs), opt_s, mctx)
    else:
        cache_s = jax_specs.cache_struct(cfg, shape.global_batch, shape.seq_len)
        out["cache_bytes_per_device"] = jax_dryrun.sharded_bytes(JM.cache_specs(cfg), cache_s, mctx)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_per_device_bytes_equal_the_references(arch, shape, mesh):
    _, info = build_cell(arch, shape, multi_pod=mesh == "pod2")
    want = _jax_bytes(arch, shape, MESHES[mesh])
    got = {k: info[k] for k in want}
    assert got == want
    assert set(info) >= {"arch", "shape", "kind", "mesh", "policy", "fault_mode", "params_total"}
    assert info["mesh"] == MESHES[mesh]
    assert info["params_total"] == jax_get_arch(arch).param_count()


# ---------------------------------------------------------------------------
# FLOPs, counted by hand
# ---------------------------------------------------------------------------


def _visited_keys(sq, skv, window, causal=True, chunk=1024):
    """Keys each q chunk of the blockwise attention attends over: its kv
    chunks that the causal and window masks do not exclude as a whole."""
    qc = min(chunk, sq)
    while sq % qc:
        qc //= 2
    kc = min(chunk, skv)
    while skv % kc:
        kc //= 2
    out = []
    for qs in range(0, sq, qc):
        lo, hi = qs, qs + qc - 1
        n = 0
        for ks in range(0, skv, kc):
            if causal and ks > hi:
                break
            if window is not None and ks + kc - 1 <= lo - window:
                continue
            n += kc
        out.append((qc, n))
    return out


def _hand_count(cfg, shape):
    """(one layer's products in forward order, the outer products): lists
    of (flops, operands that take a gradient in training)."""
    b, kind = shape.global_batch, shape.kind
    s = 1 if kind == "decode" else shape.seq_len
    t = b * s
    d, hd, hq = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads
    layer, shapes = [], Counter()

    def gemm(m, k, n, uses=1):
        layer.extend([(2 * m * k * n, 2)] * uses)
        shapes[(k, n)] += uses * cfg.num_layers

    if cfg.has_attention:
        q, kv = hq * hd, cfg.num_kv_heads * hd
        gemm(t, d, q)
        gemm(t, d, kv, 2)
        gemm(t, q, d)
        if kind == "decode":
            skv = cache_buffer_len(cfg, shape.seq_len)
            layer.extend([(2 * b * hq * skv * hd, 2)] * 2)
        else:
            for qc, keys in _visited_keys(s, s, cfg.sliding_window):
                layer.extend([(2 * b * hq * qc * keys * hd, 2)] * 2)
    if cfg.has_moe:
        e, k = cfg.num_experts, cfg.experts_per_token
        cap = capacity(b, s, cfg, 1.25)
        gemm(t, d, e)  # the router
        layer += [
            (2 * b * s * k * e * cap, 0),  # dispatch: one-hot slots x kept choices
            (2 * b * s * k * e, 1),  # combine weights: gates x kept choices
        ]
        if s > 1:
            layer.append((2 * b * s * e * cap * d, 1))  # dispatch x tokens, over the tokens
        gemm(e * b * cap, d, cfg.d_ff, 2)
        gemm(e * b * cap, cfg.d_ff, d)
        layer.append((2 * b * s * e * cap * d, 2))  # combine x expert outputs
    if cfg.has_ssm:
        di, r, n = cfg.d_inner, cfg.resolved_dt_rank, cfg.ssm_state
        gemm(t, d, 2 * di)
        gemm(t, di, r + 2 * n)
        gemm(t, r, di)
        layer.append((2 * t * di * n, 2))  # the scan's C . h (a decode step's too)
        gemm(t, di, d)
    if cfg.d_ff and not cfg.has_moe:
        gemm(t, d, cfg.d_ff, 2 if cfg.activation == "swiglu" else 1)
        gemm(t, cfg.d_ff, d)
    rows = t if kind == "train" else b  # prefill unembeds the last position alone
    outer = [(2 * rows * d * cfg.vocab_size, 2)]
    shapes[(d, cfg.vocab_size)] += 1
    want = Counter()
    for k_, n_, uses in cfg.gemm_shapes():
        want[(k_, n_)] += uses
    assert shapes == want  # every GEMM of gemm_shapes(), each once a use
    return layer, outer


def _hand_flops(cfg, shape):
    layer, outer = _hand_count(cfg, shape)
    if shape.kind != "train":
        return cfg.num_layers * sum(f for f, _ in layer) + sum(f for f, _ in outer)
    # train: forward, the backward, and remat's second forward of each layer
    # but its last product
    per_layer = sum(f * (2 + g) for f, g in layer) - layer[-1][0]
    return cfg.num_layers * per_layer + sum(f * (1 + g) for f, g in outer)


FAMILIES = ("smollm-135m", "mixtral-8x22b", "falcon-mamba-7b", "hymba-1.5b")


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_flops_total_equals_the_hand_count(arch, shape):
    cfg = reduce_config(get_arch(arch))
    pol = launch_policy(cfg, SHAPES[shape])
    assert pol.microbatches == 1 and pol.remat == ("full" if shape == "train_4k" else "none")
    info = run_cell(arch, shape, cfg=cfg)
    assert info["status"] == "ok", info.get("error")
    assert info["flops_total"] == _hand_flops(cfg, SHAPES[shape])
    assert math.isfinite(info["param_bytes_per_device"])


def test_kernel_mode_counts_the_masked_gemm_formula():
    """In kernel mode every masked GEMM is the custom op's 2 * M * K * N,
    so a forward cell counts what fap mode counts."""
    cfg = reduce_config(get_arch("smollm-135m"))
    got = {m: run_cell("smollm-135m", "decode_32k", cfg=cfg, fault_mode=m)["flops_total"]
           for m in ("fap", "kernel", "none")}
    assert got["fap"] == got["kernel"] == got["none"] == _hand_flops(cfg, SHAPES["decode_32k"])
