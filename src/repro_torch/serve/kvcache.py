"""KV-cache sizing helpers. The paged pool and its allocator wait for the
continuous-serving slice; the static engine uses the dense cache
(``models/model.py::init_cache``)."""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_PAGE_SIZE", "pages_needed", "round_up_to_page", "dense_kv_bytes"]

DEFAULT_PAGE_SIZE = 8


def pages_needed(num_tokens: int, page_size: int) -> int:
    """Pages required to hold ``num_tokens`` KV entries."""
    return -(-int(num_tokens) // int(page_size))


def round_up_to_page(num_tokens: int, page_size: int) -> int:
    return pages_needed(num_tokens, page_size) * int(page_size)


def dense_kv_bytes(cfg, batch: int, cache_len: int) -> int:
    """Resident bytes of a dense ``init_cache(cfg, batch, cache_len)``
    (window-bounded for SWA)."""
    buf = min(cfg.sliding_window, cache_len) if cfg.sliding_window else cache_len
    entry = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.resolved_head_dim
    return entry * getattr(torch, cfg.dtype).itemsize * int(batch) * int(buf)
