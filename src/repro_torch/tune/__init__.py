"""Kernel autotuning: a lint-gated block search and a persistent tuning cache.

* :mod:`repro_torch.tune.cache` — versioned JSON tuning table (committed
  default, empty for now, and the ``$REPRO_TORCH_TUNING_CACHE`` overlay)
  consulted by the wrappers through ``kernels/common.py::tuned_block``;
* :mod:`repro_torch.tune.tuner` — the autotuner (candidates gated by the
  ``repro_torch.analysis.kernelgeom`` lint before anything launches);
* :mod:`repro_torch.tune.search` — powers-of-two lattice and greedy hillclimb;
* :mod:`repro_torch.tune.roofline` — the H100's peaks and per-kernel
  operation and byte counts.
"""
from repro_torch.tune.cache import (
    TuningCache,
    cache_key,
    get_tuning_cache,
    parse_key,
    reset_tuning_cache,
    set_tuning_cache,
)
from repro_torch.tune.tuner import KERNELS, SHAPE_FIELDS, TuneResult, tune_kernel, tune_many

__all__ = [
    "TuningCache",
    "cache_key",
    "parse_key",
    "get_tuning_cache",
    "set_tuning_cache",
    "reset_tuning_cache",
    "KERNELS",
    "SHAPE_FIELDS",
    "TuneResult",
    "tune_kernel",
    "tune_many",
]
