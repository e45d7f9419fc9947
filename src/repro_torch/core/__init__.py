from repro_torch.core.faults import (
    FaultMap,
    clustered_fault_map,
    merge_fault_maps,
    random_fault_map,
)
from repro_torch.core.mapping import masked_weight, periodic_mask
from repro_torch.core.masking import (
    MASKABLE_KEYS,
    FaultContext,
    context_leak_reason,
    fault_linear,
    from_fault_map,
    healthy,
    mask_params,
    mask_selected_params,
)

__all__ = [
    "FaultMap",
    "clustered_fault_map",
    "merge_fault_maps",
    "random_fault_map",
    "masked_weight",
    "periodic_mask",
    "MASKABLE_KEYS",
    "FaultContext",
    "context_leak_reason",
    "fault_linear",
    "from_fault_map",
    "healthy",
    "mask_params",
    "mask_selected_params",
]
