"""Per-(arch x shape) launch policy: the knobs that make each cell fit and
run well on the production mesh, derived from analytic memory estimates.
The port's copy of the reference's ``launch/policy.py``, equal to it: the
dry run (``launch/dryrun_lib.py``) resolves its layouts and counts its
FLOPs under the same knobs. The port's attention takes every ``blockwise*``
impl (``models/layers.py::attention_impl``; ``_mx`` rounds the products'
operands to the input dtype).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclass(frozen=True)
class LaunchPolicy:
    fsdp: bool
    moment_dtype: str
    microbatches: int
    seq_shard: bool  # Megatron-SP style: shard the between-layer carry on seq
    attn_impl: str
    moe_impl: str
    remat: str
    # 'per_use' = paper-faithful mask at every matmul; 'per_step' = exact
    # pre-masking optimization
    fault_apply: str = "per_use"
    # allow attention seq axes to shard on 'model' (for archs whose head
    # count does not divide the TP degree)
    seq_rule: bool = False
    # shard MoE slot rows over 'model' instead of TP-splitting expert FFNs
    moe_slot_shard: bool = False

    def describe(self) -> str:
        return (
            f"fsdp={self.fsdp} moments={self.moment_dtype} mb={self.microbatches} "
            f"seq_shard={self.seq_shard} attn={self.attn_impl} moe={self.moe_impl} "
            f"remat={self.remat} fault_apply={self.fault_apply}"
        )


def launch_policy(
    cfg: ArchConfig,
    shape: ShapeConfig,
    *,
    n_data: int = 16,
    n_pod: int = 1,
    n_model: int = 16,
    carry_budget_bytes: float = 2.5e9,
    moe_impl: str = "einsum",
    profile: str = "baseline",
) -> LaunchPolicy:
    """profile='baseline' is the paper-faithful configuration; 'optimized'
    applies the reference's beyond-paper choices: per-step fault masking,
    causal-unrolled mixed-precision attention, scatter MoE dispatch, and
    seq-split attention for archs whose head count cannot use tensor
    parallelism."""
    params = cfg.param_count()
    fsdp_train = params > 3e9
    fsdp_serve = params * 2 > 8e9  # bf16 weights won't fit replicated-ish
    opt = profile == "optimized"
    fault_apply = "per_step" if opt else "per_use"
    moe = ("scatter" if opt else "einsum") if moe_impl == "einsum" else moe_impl
    # the unroll/mixed/seq-shard attention choices apply only to full causal
    # attention; the reference measured SWA and encoder attention slower
    # with them
    causal_full = (
        cfg.has_attention and not cfg.is_encoder and cfg.sliding_window is None
    )
    seq_rule = bool(
        opt and causal_full and cfg.num_heads and cfg.num_heads % n_model
    )
    if shape.kind == "train":
        local_batch = max(1, shape.global_batch // (n_data * n_pod))
        # choose microbatches so the saved scan carry fits the budget:
        # carry bytes = (local/mb) * S * d * 2 * L   (/16 more if seq_shard)
        seq_shard = params >= 50e9
        denom = 16 if seq_shard else 1
        mb = 1
        while (
            mb < local_batch
            and (local_batch / mb) * shape.seq_len * cfg.d_model * 2 * cfg.num_layers / denom
            > carry_budget_bytes
        ):
            mb *= 2
        attn = "blockwise" if shape.seq_len > 512 else "dense"
        if opt and attn == "blockwise" and causal_full:
            attn = "blockwise_mx_unroll"
        return LaunchPolicy(
            fsdp=fsdp_train,
            moment_dtype="bfloat16" if params > 50e9 else "float32",
            microbatches=mb,
            seq_shard=seq_shard,
            attn_impl=attn,
            moe_impl=moe,
            remat="full",
            fault_apply=fault_apply,
            seq_rule=seq_rule,
        )
    if shape.kind == "prefill":
        return LaunchPolicy(
            fsdp=fsdp_serve,
            moment_dtype="float32",
            microbatches=1,
            seq_shard=params >= 50e9,
            attn_impl="blockwise_mx_unroll" if (opt and causal_full) else "blockwise",
            moe_impl=moe,
            remat="none",
            fault_apply=fault_apply,
            seq_rule=seq_rule,
        )
    # decode: per_step masking is moot (weights static per request);
    # production serving masks offline (fault_mode none + pre-masked params)
    return LaunchPolicy(
        fsdp=fsdp_serve,
        moment_dtype="float32",
        microbatches=1,
        seq_shard=False,
        attn_impl="dense",
        moe_impl=moe,
        remat="none",
        fault_apply="per_use",
        seq_rule=False,
    )
