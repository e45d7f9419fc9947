"""KV-cache sizing helpers, the page allocator and the page-chain layout.

The static engine uses the dense cache (``models/model.py::init_cache``).
A paged pool is a shared set of fixed-size pages: each sequence owns a page
chain, a row of block tables holding its page ids in order, truncated to
its length; the host-side :class:`PageAllocator` hands page ids out of a
free list and takes them back. ``kernels/decode_attention/ops.py::
paged_decode_attention`` reads an int8 pool through such tables; the
paged model cache (``models/model.py::init_paged_cache``) holds the pool
the continuous-batching engine serves from, in the model's dtype.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import torch

__all__ = [
    "DEFAULT_PAGE_SIZE",
    "PageAllocator",
    "chain_layout",
    "pages_needed",
    "round_up_to_page",
    "dense_kv_bytes",
    "page_bytes",
]

DEFAULT_PAGE_SIZE = 8


def pages_needed(num_tokens: int, page_size: int) -> int:
    """Pages required to hold ``num_tokens`` KV entries."""
    return -(-int(num_tokens) // int(page_size))


def round_up_to_page(num_tokens: int, page_size: int) -> int:
    return pages_needed(num_tokens, page_size) * int(page_size)


@dataclass
class PageAllocator:
    """Host-side free-list allocator over a pool of ``num_pages`` pages.

    Page 0 is reserved as the scratch page for masked writes and is never
    handed out. Allocation is LIFO over the free list (freed pages are
    reused first); ``peak_pages`` is the high-water mark. Freeing a page
    that is not outstanding (a double free, or a page another chain owns)
    raises. ``alloc_failures`` counts refusals, from :meth:`alloc` and from
    a ``False`` answer of :meth:`can_alloc`.
    """

    num_pages: int
    page_size: int
    _free: list = field(default_factory=list)
    _in_use: set = field(default_factory=set)
    peak_pages: int = 0
    alloc_failures: int = 0

    def __post_init__(self):
        if self.num_pages < 2:
            raise ValueError(f"need >= 2 pages (page 0 is reserved), got {self.num_pages}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        # descending, so pop() hands out low page ids first
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._in_use = set()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    @property
    def high_water(self) -> int:
        """Peak pages in use over the allocator's lifetime."""
        return self.peak_pages

    def can_alloc(self, n: int) -> bool:
        ok = n <= len(self._free)
        if not ok:
            self.alloc_failures += 1
        return ok

    def alloc(self, n: int) -> list[int]:
        if n < 1:
            raise ValueError(f"alloc needs n >= 1, got {n}")
        if n > len(self._free):
            self.alloc_failures += 1
            raise MemoryError(
                f"page pool exhausted: need {n} pages, {len(self._free)} free "
                f"of {self.num_pages - 1} allocatable"
            )
        out = [self._free.pop() for _ in range(n)]
        self._in_use.update(out)
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        return out

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            p = int(p)
            if p in self._in_use:
                self._in_use.discard(p)
                self._free.append(p)
                continue
            if 0 < p < self.num_pages and p in self._free:
                raise ValueError(f"double free of page {p}")
            raise ValueError(
                f"free of page {p} this allocator never handed out "
                "(reserved, outside the pool, or owned by another allocator)"
            )


def chain_layout(k_dense: torch.Tensor, page_size: int, chain_len: int) -> torch.Tensor:
    """One sequence's dense KV ``(L, 1, Hkv, plen, hd)`` in page-chain form
    ``(L, chain_len, Hkv, page_size, hd)``, ready to be written into a pool's
    pages in one indexed assignment. The tail page is zero past ``plen``."""
    L, b, hkv, plen, hd = k_dense.shape
    if b != 1:
        raise ValueError(f"chain_layout takes one sequence, got batch {b}")
    total = chain_len * page_size
    if plen > total:
        raise ValueError(f"{plen} tokens exceed chain capacity {total}")
    k = torch.nn.functional.pad(k_dense[:, 0], (0, 0, 0, total - plen))
    return k.reshape(L, hkv, chain_len, page_size, hd).movedim(1, 2)


def _kv_entry_bytes(cfg) -> int:
    """Bytes of one token's K+V across all layers."""
    entry = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.resolved_head_dim
    return entry * getattr(torch, cfg.dtype).itemsize


def page_bytes(cfg, page_size: int) -> int:
    """Resident bytes of ONE page (K+V, all layers)."""
    return _kv_entry_bytes(cfg) * int(page_size)


def dense_kv_bytes(cfg, batch: int, cache_len: int) -> int:
    """Resident bytes of a dense ``init_cache(cfg, batch, cache_len)``
    (window-bounded for SWA)."""
    buf = min(cfg.sliding_window, cache_len) if cfg.sliding_window else cache_len
    return _kv_entry_bytes(cfg) * int(batch) * int(buf)
