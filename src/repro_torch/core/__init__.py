"""eFAT core: fault maps, systolic mapping and the FAM baseline, the fault
context, dual fault types, resilience analysis, grouping & fusion, and the
end-to-end orchestrator (paper Fig. 7). ``fault_einsum`` waits for the MoE
family (ROADMAP.md §1.5)."""
from repro_torch.core.dual import dual_fault_weight, measure_resilience_2d, project_params
from repro_torch.core.efat import EFAT, BatchFATTrainerFull, EFATConfig, EFATResult
from repro_torch.core.faults import (
    FaultMap,
    clustered_fault_map,
    correlated_family,
    expected_merged_rate,
    gaussian_chip_rates,
    merge_fault_maps,
    overlap_rate,
    random_fault_map,
)
from repro_torch.core.grouping import (
    RetrainingPlan,
    fixed_policy_plan,
    group_and_fuse,
    individual_plan,
    random_pair_merge_plan,
)
from repro_torch.core.mapping import (
    apply_fam,
    expected_weight_loss,
    fam_permutation,
    masked_weight,
    periodic_mask,
)
from repro_torch.core.masking import (
    MASKABLE_KEYS,
    FaultContext,
    context_leak_reason,
    fault_einsum,
    fault_linear,
    from_fault_map,
    healthy,
    mask_params,
    mask_selected_params,
    stack_contexts,
)
from repro_torch.core.resilience import (
    BatchFATTrainer,
    ResilienceTable,
    ResilienceTable2D,
    fault_rate_list,
    measure_resilience,
)

__all__ = [
    "EFAT",
    "EFATConfig",
    "EFATResult",
    "BatchFATTrainer",
    "BatchFATTrainerFull",
    "FaultMap",
    "FaultContext",
    "MASKABLE_KEYS",
    "RetrainingPlan",
    "ResilienceTable",
    "ResilienceTable2D",
    "apply_fam",
    "clustered_fault_map",
    "context_leak_reason",
    "correlated_family",
    "dual_fault_weight",
    "expected_merged_rate",
    "expected_weight_loss",
    "fam_permutation",
    "fault_einsum",
    "fault_linear",
    "fault_rate_list",
    "fixed_policy_plan",
    "from_fault_map",
    "gaussian_chip_rates",
    "group_and_fuse",
    "healthy",
    "individual_plan",
    "mask_params",
    "mask_selected_params",
    "masked_weight",
    "measure_resilience",
    "measure_resilience_2d",
    "merge_fault_maps",
    "overlap_rate",
    "periodic_mask",
    "project_params",
    "random_fault_map",
    "random_pair_merge_plan",
    "stack_contexts",
]
