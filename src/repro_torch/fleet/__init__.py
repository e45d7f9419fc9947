"""The fleet layer: how retraining jobs are packed into population chunks
(``scheduler``). The sharded engine and fleet serving wait (ROADMAP.md
§1.4)."""
from repro_torch.fleet.scheduler import (
    FleetSchedule,
    FleetScheduler,
    ScheduledChunk,
    round_up_to_multiple,
)

__all__ = ["FleetSchedule", "FleetScheduler", "ScheduledChunk", "round_up_to_multiple"]
