"""repro_torch.serve — the serving subsystem.

Two engine tiers over one sampling + decode step:

* :mod:`repro_torch.serve.engine` — :class:`ServeEngine`, static-batch
  generation (one rectangular prompt batch, dense KV cache, optional EOS
  masking).
* :mod:`repro_torch.serve.continuous` — :class:`ContinuousBatchingEngine`,
  request queue + slot table over the paged KV cache
  (:mod:`repro_torch.serve.kvcache`): admit into free slots, retire on EOS
  or budget, pages freed mid-flight.
"""
from repro_torch.serve.continuous import (
    ContinuousBatchingEngine,
    Request,
    RequestOutput,
    ServeStats,
)
from repro_torch.serve.engine import GenerateResult, ServeEngine, make_sample_decode
from repro_torch.serve.kvcache import (
    DEFAULT_PAGE_SIZE,
    PageAllocator,
    dense_kv_bytes,
    page_bytes,
    pages_needed,
    round_up_to_page,
)

__all__ = [
    "ContinuousBatchingEngine",
    "DEFAULT_PAGE_SIZE",
    "GenerateResult",
    "PageAllocator",
    "Request",
    "RequestOutput",
    "ServeEngine",
    "ServeStats",
    "dense_kv_bytes",
    "make_sample_decode",
    "page_bytes",
    "pages_needed",
    "round_up_to_page",
]
