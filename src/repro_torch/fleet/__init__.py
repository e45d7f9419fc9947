"""The fleet layer between the FAT engines and the serve stack.

* :mod:`repro_torch.fleet.scheduler`: :class:`FleetScheduler`, budget-aware
  (LPT) packing of retraining jobs into population chunks.
* :mod:`repro_torch.fleet.capacity`: :func:`suggest_population_size`,
  sizing population lanes against device memory.
* :mod:`repro_torch.fleet.serve`: :class:`FleetServeEngine`, one engine
  advancing N faulty chips' deployed models a token per dispatch, and
  :class:`ShardedFleetServeEngine`, continuous-batch fleet serving with one
  ragged request stream and paged-KV slot table per chip.
* :mod:`repro_torch.fleet.sharding`: :class:`ShardedPopulationEngine`,
  population FAT split over the pop slices of a fleet mesh, member state
  stored split over its model axis.
* :mod:`repro_torch.fleet.tensor_parallel`: ``SplitTensor``, a split
  member leaf the math runs on (the engine's ``compute="sharded"``).
"""
from repro_torch.fleet.capacity import suggest_population_size
from repro_torch.fleet.scheduler import (
    FleetSchedule,
    FleetScheduler,
    ScheduledChunk,
    round_up_to_multiple,
)
from repro_torch.fleet.serve import (
    FleetGenerateResult,
    FleetServeEngine,
    ShardedFleetServeEngine,
)
from repro_torch.fleet.sharding import ShardedPopulationEngine

__all__ = [
    "FleetSchedule",
    "FleetScheduler",
    "ScheduledChunk",
    "FleetGenerateResult",
    "FleetServeEngine",
    "ShardedFleetServeEngine",
    "ShardedPopulationEngine",
    "round_up_to_multiple",
    "suggest_population_size",
]
