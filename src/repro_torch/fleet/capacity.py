"""Fleet capacity planning: size population lanes against device memory.

A population chunk holds, per member, fp32 master params plus the two AdamW
moments. ``suggest_population_size`` turns (arch, devices, per-device
memory) into a ``population_size`` the population engine can run without
running out of device memory. The device's memory is what
``torch.cuda.mem_get_info`` reports for it; on the CPU the caller passes the
budget, and without one the function raises: there is no assumed default.

With ``reserve_kernel_smem=True`` the planner also reserves the largest
shared-memory footprint each tuned kernel recorded in the tuning cache
(:func:`kernel_smem_reserve`, ``TuningCache.smem_footprints``). The
reference reserves its TPU kernels' VMEM; the card's counterpart is shared
memory, hence the names.

The port's copy of the reference's ``fleet/capacity.py``. The extents come
from a fleet mesh (``repro_torch.launch.mesh``): its "pop" axis is the
number of pop slices the population spreads over, and its other axes the
model positions each member's state is split over. Without a mesh the
population is one lane on one device.
"""
from __future__ import annotations

from typing import Optional

import math

import torch

from repro_torch.device import resolve_device

__all__ = ["suggest_population_size", "kernel_smem_reserve", "device_memory_bytes"]

# fp32 master params + fp32 AdamW m and v (train/optimizer.py defaults;
# a bfloat16 moment_dtype would be 4 + 2 + 2)
_DEFAULT_BYTES_PER_PARAM = 12


def device_memory_bytes(device=None) -> int:
    """The device's total memory in bytes, from ``torch.cuda.mem_get_info``.
    The CPU has no such figure: pass ``hbm_bytes`` there."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(
            f"no device memory figure for {dev}; pass hbm_bytes, the budget to plan against"
        )
    return int(torch.cuda.mem_get_info(dev)[1])


def kernel_smem_reserve(cache=None) -> int:
    """Total shared memory the tuned kernels keep resident, in bytes.

    Sums the tuning cache's recorded per-kernel maximum shared-memory
    footprints (``TuningCache.smem_footprints()``): the worst tuned geometry
    each kernel may pick. An empty or missing cache contributes 0, matching
    the "empty cache == heuristic behaviour" contract. ``cache=None`` reads
    the process-global cache (default table + env overlay)."""
    if cache is None:
        from repro_torch.tune.cache import get_tuning_cache

        cache = get_tuning_cache()
    return int(sum(cache.smem_footprints().values()))


def suggest_population_size(
    cfg,
    mesh=None,
    *,
    device=None,
    hbm_bytes: Optional[int] = None,
    headroom: float = 0.6,
    bytes_per_param: int = _DEFAULT_BYTES_PER_PARAM,
    max_members_per_lane: int = 64,
    reserve_kernel_smem: bool = False,
    tuning_cache=None,
) -> int:
    """Largest population chunk width the devices can hold resident.

    Parameters
    ----------
    cfg : ArchConfig; ``cfg.param_count()`` sets the per-member state size.
    mesh : fleet mesh (1-D pop or 2-D pop x model); None = a single lane on
        one device (the vmap engine's situation).
    device : the device whose memory is the budget (default: the mesh's
        first device, else the card); ignored when ``hbm_bytes`` is given.
    hbm_bytes : per-device memory budget; default: the device's total memory
        (``torch.cuda.mem_get_info``). Required on the CPU.
    headroom : fraction of ``hbm_bytes`` the member state may use; the rest
        is activations and gradients for the in-flight update.
    bytes_per_param : resident optimizer+param bytes per parameter per
        member (default fp32 params + fp32 AdamW moments = 12).
    max_members_per_lane : cap on members per lane.
    reserve_kernel_smem : subtract :func:`kernel_smem_reserve` from the
        budget before sizing.
    tuning_cache : explicit ``TuningCache`` for the reserve; None reads the
        process-global cache. Ignored unless ``reserve_kernel_smem=True``.

    Returns a positive multiple of the mesh's pop extent. Raises ValueError
    when even ONE member per lane exceeds the budget.
    """
    pop_extent = model_extent = 1
    if mesh is not None:
        sizes = dict(mesh.shape)
        pop_extent = int(sizes.pop("pop", 1))
        model_extent = int(math.prod(sizes.values()))
        if device is None:
            device = mesh.devices.flat[0]
    if hbm_bytes is None:
        hbm_bytes = device_memory_bytes(device)
    if hbm_bytes <= 0:
        raise ValueError(f"hbm_bytes must be positive, got {hbm_bytes}")
    if not 0.0 < headroom <= 1.0:
        raise ValueError(f"headroom must be in (0, 1], got {headroom}")
    if reserve_kernel_smem:
        reserve = kernel_smem_reserve(tuning_cache)
        if reserve >= hbm_bytes:
            raise ValueError(
                f"kernel shared-memory reserve {reserve} bytes exceeds the "
                f"{hbm_bytes}-byte device budget"
            )
        hbm_bytes = hbm_bytes - reserve

    member_bytes = int(cfg.param_count()) * int(bytes_per_param)
    # the model axis shards each member's resident state within a pop slice
    per_device_member_bytes = max(1, member_bytes // model_extent)
    budget = int(hbm_bytes * headroom)
    members_per_lane = budget // per_device_member_bytes
    if members_per_lane < 1:
        raise ValueError(
            f"one member needs {per_device_member_bytes / 2**30:.2f} GiB resident "
            f"({member_bytes / 2**30:.2f} GiB / model extent {model_extent}) but the "
            f"budget is {budget / 2**30:.2f} GiB ({headroom:.0%} of "
            f"{hbm_bytes / 2**30:.2f} GiB) — grow the mesh's model axis"
        )
    members_per_lane = min(int(members_per_lane), int(max_members_per_lane))
    return members_per_lane * pop_extent
