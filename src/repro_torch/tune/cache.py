"""Persistent kernel-tuning cache: versioned JSON, one entry per launch key.

The cache maps a canonical ``(kernel, shape, dtype, backend)`` key to the
block config the autotuner (:mod:`repro_torch.tune.tuner`) measured as the
winner for that launch, with its evidence: tuned and heuristic
microseconds, speedup, the shared memory the launch requests and the
achieved-against-roofline fraction. ``kernels/common.py::tuned_block``,
the one seam the ``ops.py`` wrappers consult, looks blocks up here; a miss
(or a corrupt or stale file) leaves the heuristics as they are.

Keys and file schema are the reference's (``kernel|dims|dtype|backend``,
``{"version": 1, "entries": {...}}``), with torch's dtype names, which
spell as JAX's, and the port's backend tags (``cuda``, ``cpu``). Two layers
merge into the process-wide cache (:func:`get_tuning_cache`):

1. the committed default table shipped with the package
   (``default_cache.json``: the H100 entries that beat the heuristic by at
   least 5% in two separate runs of ``chip_smoke.py``'s phase 5), and
2. a user table named by ``$REPRO_TORCH_TUNING_CACHE``, whose entries win.
   The variable is the port's own, so the port never reads a TPU table.
"""
from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

__all__ = [
    "CACHE_VERSION",
    "DEFAULT_CACHE_PATH",
    "ENV_CACHE_PATH",
    "TuningCache",
    "cache_key",
    "parse_key",
    "get_tuning_cache",
    "set_tuning_cache",
    "reset_tuning_cache",
    "SEAM_MEMO",
]

CACHE_VERSION = 1
DEFAULT_CACHE_PATH = os.path.join(os.path.dirname(__file__), "default_cache.json")
ENV_CACHE_PATH = "REPRO_TORCH_TUNING_CACHE"


def cache_key(kernel: str, shape: Mapping[str, int], dtype: str, backend: str) -> str:
    """Canonical cache key: shape fields sorted by name, so any dict order
    of the same shape gives the same key."""
    if not kernel or "|" in kernel:
        raise ValueError(f"bad kernel name {kernel!r}")
    dims = ",".join(f"{k}={int(v)}" for k, v in sorted(shape.items()))
    return f"{kernel}|{dims}|{dtype}|{backend}"


def parse_key(key: str) -> tuple[str, dict, str, str]:
    """Inverse of :func:`cache_key`."""
    kernel, dims, dtype, backend = key.split("|")
    shape = {}
    if dims:
        for item in dims.split(","):
            name, value = item.split("=")
            shape[name] = int(value)
    return kernel, shape, dtype, backend


@dataclass
class TuningCache:
    """An in-memory tuning table and its (de)serialization. ``entries``
    maps canonical keys to plain dicts; the seam reads only ``"blocks"``."""

    entries: dict[str, dict] = field(default_factory=dict)
    version: int = CACHE_VERSION
    source: str = "<memory>"

    def __len__(self) -> int:
        return len(self.entries)

    def get(self, key: str) -> Optional[dict]:
        return self.entries.get(key)

    def lookup_blocks(
        self, kernel: str, shape: Mapping[str, int], dtype: str, backend: str
    ) -> Optional[dict[str, int]]:
        """The seam's query: tuned blocks for one launch, or None (a miss)."""
        entry = self.entries.get(cache_key(kernel, shape, dtype, backend))
        if not entry:
            return None
        blocks = entry.get("blocks")
        if not isinstance(blocks, Mapping):
            return None
        try:
            return {str(k): int(v) for k, v in blocks.items()}
        except (TypeError, ValueError):
            return None

    def put(self, key: str, entry: Mapping[str, Any]) -> None:
        parse_key(key)  # validates the canonical form
        self.entries[key] = dict(entry)
        if self is _GLOBAL:
            SEAM_MEMO.clear()

    def merge(self, other: "TuningCache") -> "TuningCache":
        """New cache with ``other``'s entries winning on key collisions."""
        merged = dict(self.entries)
        merged.update(other.entries)
        return TuningCache(entries=merged, source=f"{self.source}+{other.source}")

    def smem_footprints(self) -> dict[str, int]:
        """kernel name -> largest recorded shared-memory footprint (bytes,
        the tuner's ``smem_bytes``) among its cached winners: what
        ``fleet.capacity`` reserves. The counterpart of the reference's
        ``vmem_footprints``, named after the card's on-chip memory, which is
        shared memory, not a TPU's VMEM."""
        out: dict[str, int] = {}
        for key, entry in self.entries.items():
            kernel = key.split("|", 1)[0]
            try:
                smem = int(entry.get("smem_bytes", 0))
            except (TypeError, ValueError):
                continue
            out[kernel] = max(out.get(kernel, 0), smem)
        return out

    def as_dict(self) -> dict:
        return {"version": self.version, "entries": self.entries}

    def save(self, path: str) -> None:
        doc = json.dumps(self.as_dict(), indent=1, sort_keys=True)
        with open(path, "w") as f:
            f.write(doc + "\n")

    @classmethod
    def load(cls, path: str) -> "TuningCache":
        """Load a cache file. Any defect (unparsable, wrong version, no
        entries table, malformed entries) degrades to an empty cache, or
        drops the bad entries, with a warning: a broken table must never
        break a kernel call. A missing file is silently empty."""
        if not os.path.exists(path):
            return cls(source=path)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            warnings.warn(f"tuning cache {path!r} is unreadable ({e}); "
                          "falling back to heuristic block sizes", stacklevel=2)
            return cls(source=path)
        if not isinstance(doc, dict) or doc.get("version") != CACHE_VERSION:
            found = doc.get("version") if isinstance(doc, dict) else "<none>"
            warnings.warn(f"tuning cache {path!r} has version {found} (want {CACHE_VERSION}); "
                          "falling back to heuristic block sizes", stacklevel=2)
            return cls(source=path)
        entries = doc.get("entries")
        if not isinstance(entries, dict):
            warnings.warn(f"tuning cache {path!r} has no entries table; "
                          "falling back to heuristic block sizes", stacklevel=2)
            return cls(source=path)
        good: dict[str, dict] = {}
        bad = 0
        for key, entry in entries.items():
            try:
                parse_key(key)
            except ValueError:
                bad += 1
                continue
            if isinstance(entry, dict):
                good[key] = entry
            else:
                bad += 1
        if bad:
            warnings.warn(f"tuning cache {path!r}: dropped {bad} malformed "
                          f"entr{'y' if bad == 1 else 'ies'}", stacklevel=2)
        return cls(entries=good, source=path)


# ---------------------------------------------------------------------------
# Process-wide cache (what kernels/common.py::tuned_block consults)
# ---------------------------------------------------------------------------

_GLOBAL: Optional[TuningCache] = None
# kernels/common.py::tuned_block's memo of resolved blocks, per (kernel, shape items, dtype,
# backend): valid for the process table it was read from, so dropped with it and on a put into it
SEAM_MEMO: dict[tuple, dict] = {}


def get_tuning_cache() -> TuningCache:
    """The process-wide cache: the committed defaults overlaid with the
    ``$REPRO_TORCH_TUNING_CACHE`` table. Loaded once; ``reset_tuning_cache``
    forces a reload."""
    global _GLOBAL
    if _GLOBAL is None:
        cache = TuningCache.load(DEFAULT_CACHE_PATH)
        user_path = os.environ.get(ENV_CACHE_PATH)
        if user_path:
            cache = cache.merge(TuningCache.load(user_path))
        _GLOBAL = cache
    return _GLOBAL


def set_tuning_cache(cache: Optional[TuningCache]) -> Optional[TuningCache]:
    """Install ``cache`` as the process-wide table and return the previous
    one. None drops the table, as ``reset_tuning_cache`` does, so the next
    lookup reloads the defaults and the overlay: ``prev =
    set_tuning_cache(t) ... set_tuning_cache(prev)`` then restores the
    process's table even when none had been loaded. (The reference installs
    an empty table for None; pass ``TuningCache()`` for that.)"""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = cache
    SEAM_MEMO.clear()
    return prev


def reset_tuning_cache() -> None:
    """Drop the loaded table; the next lookup reloads from disk."""
    global _GLOBAL
    _GLOBAL = None
    SEAM_MEMO.clear()
