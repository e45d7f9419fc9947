"""In-process observability, host-side only: one :class:`Recorder` (bounded
event ring + metrics registry) shared by the serve and train stacks and the
kernel autotuner, the request and page-pool hooks, the exporters (a
lossless JSONL log and a Chrome trace viewable in Perfetto), and the
detection layer: ABFT checksum/canary probes (:mod:`repro_torch.obs.abft`),
per-chip EWMA health scoring with a debounced healthy→suspect→degraded
state machine (:mod:`repro_torch.obs.health`), and the declarative
alert/SLO engine over the metrics registry (:mod:`repro_torch.obs.alerts`).
"""
from repro_torch.obs.abft import ChipProber, ProbeResult
from repro_torch.obs.alerts import (
    AlertEngine,
    AlertRule,
    default_slo_rules,
    detection_rules,
)
from repro_torch.obs.export import (
    chrome_trace,
    jsonl_to_chrome,
    read_jsonl,
    validate_chrome_trace,
    write_chrome_trace,
    write_jsonl,
)
from repro_torch.obs.health import (
    DEGRADED,
    HEALTHY,
    SUSPECT,
    ChipHealth,
    HealthConfig,
    HealthTracker,
)
from repro_torch.obs.hooks import PoolMonitor, RequestTracer
from repro_torch.obs.metrics import (
    QUEUE_WAIT_STEP_BUCKETS,
    STEP_LATENCY_BUCKETS_S,
    TPOT_BUCKETS_S,
    TTFT_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.recorder import NULL_RECORDER, Event, Recorder, RingBuffer

__all__ = [
    "AlertEngine",
    "AlertRule",
    "ChipHealth",
    "ChipProber",
    "Counter",
    "DEGRADED",
    "Event",
    "Gauge",
    "HEALTHY",
    "HealthConfig",
    "HealthTracker",
    "Histogram",
    "MetricsRegistry",
    "NULL_RECORDER",
    "PoolMonitor",
    "ProbeResult",
    "QUEUE_WAIT_STEP_BUCKETS",
    "Recorder",
    "RequestTracer",
    "RingBuffer",
    "SUSPECT",
    "STEP_LATENCY_BUCKETS_S",
    "TPOT_BUCKETS_S",
    "TTFT_BUCKETS_S",
    "chrome_trace",
    "default_slo_rules",
    "detection_rules",
    "jsonl_to_chrome",
    "read_jsonl",
    "validate_chrome_trace",
    "write_chrome_trace",
    "write_jsonl",
]
