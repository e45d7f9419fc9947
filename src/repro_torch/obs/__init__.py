"""In-process observability: the bounded-ring ``Recorder`` and its metrics
registry (counters and histograms). Host-side only. The reference's
hooks, exporters, health and alert modules wait for the continuous-serving
slice."""
from repro_torch.obs.metrics import Counter, Histogram, MetricsRegistry
from repro_torch.obs.recorder import NULL_RECORDER, Event, Recorder, RingBuffer

__all__ = ["Counter", "Histogram", "MetricsRegistry", "NULL_RECORDER", "Event",
           "Recorder", "RingBuffer"]
