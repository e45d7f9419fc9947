"""The port's kernel autotuner against the reference's ``repro.tune``.

The pure parts (lattice, neighbours, hillclimb, cache keys and files,
roofline counts, the recorder's metrics) are run on the same inputs in both
packages. The pipeline runs on the CPU with its runner stubbed, so no
kernel is needed; ``tests/test_torch_cuda.py`` tunes on the card.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs.metrics import Histogram as JaxHistogram
from repro.obs.recorder import Recorder as JaxRecorder
from repro.tune import cache as jax_cache
from repro.tune import roofline as jax_roofline
from repro.tune import search as jax_search
from repro.tune.tuner import normalize_blocks as jax_normalize_blocks
from repro_torch.kernels.common import SMEM_LIMIT_BYTES, backend_tag, dtype_name
from repro_torch.kernels.decode_attention.ops import DEFAULT_BKV, resolve_bkv, smem_bytes
from repro_torch.obs.metrics import Histogram
from repro_torch.obs.recorder import NULL_RECORDER, Recorder
from repro_torch.tune import cache as tc
from repro_torch.tune import roofline
from repro_torch.tune.cache import TuningCache, cache_key, parse_key, set_tuning_cache
from repro_torch.tune.search import hillclimb, lattice_neighbors, pow2_lattice
from repro_torch.tune.tuner import (
    HEURISTIC_BLOCKS,
    KERNELS,
    lint_candidate,
    normalize_blocks,
    tune_kernel,
    tune_many,
)

DA_SHAPE = dict(b=4, hq=9, hkv=3, skv=2048, d=64)


@pytest.fixture
def isolated_cache():
    prev = set_tuning_cache(TuningCache())
    try:
        yield tc.get_tuning_cache()
    finally:
        set_tuning_cache(prev)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim,lo", [(64, 8), (96, 8), (4, 8), (2048, 8), (1000, 8), (512, 16), (1, 1)])
def test_pow2_lattice_matches_the_reference(dim, lo):
    assert pow2_lattice(dim, lo=lo) == jax_search.pow2_lattice(dim, lo=lo)


@pytest.mark.parametrize("start", [dict(bm=16, bn=8), dict(bm=8, bn=32), dict(bm=20, bn=8)])
def test_lattice_neighbors_match_the_reference(start):
    lat = dict(bm=[8, 16, 32], bn=[8, 16, 32])
    assert list(lattice_neighbors(start, lat)) == list(jax_search.lattice_neighbors(start, lat))


@pytest.mark.parametrize("name,fn", [
    ("bigger", lambda b: -b["x"]),
    ("valley", lambda b: abs(b["x"] - 16)),
    ("some_unscoreable", lambda b: None if b["x"] == 4 else float(b["x"] % 5)),
    ("budget", lambda b: 1.0 / b["x"]),
])
def test_hillclimb_matches_the_reference(name, fn):
    lat = dict(x=[1, 2, 4, 8, 16, 32, 64])
    for max_evals in (2, 4, 32):
        ours = hillclimb(dict(x=2), lambda b: lattice_neighbors(b, lat), fn, max_evals=max_evals)
        ref = jax_search.hillclimb(dict(x=2), lambda b: jax_search.lattice_neighbors(b, lat), fn,
                                   max_evals=max_evals)
        assert ours == ref
    with pytest.raises(ValueError):
        hillclimb(dict(x=1), lambda b: [], lambda b: None)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tdtype,jdtype", [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)])
def test_cache_keys_match_the_reference(tdtype, jdtype):
    assert dtype_name(tdtype) == jnp.dtype(jdtype).name
    shape = dict(skv=2048, b=4, hq=9, hkv=3, d=64)
    ours = cache_key("decode_attention", shape, dtype_name(tdtype), "cuda")
    assert ours == jax_cache.cache_key("decode_attention", shape, jnp.dtype(jdtype).name, "cuda")
    assert ours == f"decode_attention|b=4,d=64,hkv=3,hq=9,skv=2048|{dtype_name(tdtype)}|cuda"
    assert parse_key(ours) == jax_cache.parse_key(ours) == ("decode_attention", shape, dtype_name(tdtype), "cuda")
    for bad in ("", "a|b"):
        with pytest.raises(ValueError):
            cache_key(bad, shape, "float32", "cuda")


def test_backend_tags():
    assert backend_tag("cuda") == backend_tag(torch.device("cuda", 0)) == "cuda"
    assert backend_tag("cpu") == "cpu"


def test_a_reference_cache_file_loads_in_the_port_and_back(tmp_path):
    ref = jax_cache.TuningCache()
    key = jax_cache.cache_key("decode_attention", DA_SHAPE, "bfloat16", "cuda")
    ref.put(key, dict(blocks=dict(bkv=512), time_us=12.5))
    ref.save(str(tmp_path / "ref.json"))
    ours = TuningCache.load(str(tmp_path / "ref.json"))
    assert ours.entries == ref.entries
    assert ours.lookup_blocks("decode_attention", DA_SHAPE, "bfloat16", "cuda") == dict(bkv=512)
    ours.save(str(tmp_path / "ours.json"))
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "ref.json").read_text()
    assert jax_cache.TuningCache.load(str(tmp_path / "ours.json")).entries == ref.entries


def test_cache_merge_and_degradation_match_the_reference(tmp_path):
    a, b = TuningCache(), TuningCache()
    k1 = cache_key("decode_attention", dict(b=1), "float32", "cuda")
    k2 = cache_key("decode_attention", dict(b=2), "float32", "cuda")
    a.put(k1, dict(blocks=dict(bkv=8)))
    b.put(k1, dict(blocks=dict(bkv=64)))
    b.put(k2, dict(blocks=dict(bkv=32)))
    assert a.merge(b).entries == {k1: dict(blocks=dict(bkv=64)), k2: dict(blocks=dict(bkv=32))}
    assert len(TuningCache.load(str(tmp_path / "missing.json"))) == 0
    docs = {
        "corrupt": "{not json",
        "stale": json.dumps({"version": 99, "entries": {}}),
        "no_entries": json.dumps({"version": 1}),
        "malformed": json.dumps({"version": 1, "entries": {k1: {"blocks": {"bkv": 8}}, "bad": {}, k2: 3}}),
    }
    for name, doc in docs.items():
        path = tmp_path / f"{name}.json"
        path.write_text(doc)
        with pytest.warns(UserWarning):
            ours = TuningCache.load(str(path))
        with pytest.warns(UserWarning):
            ref = jax_cache.TuningCache.load(str(path))
        assert ours.entries == ref.entries
    bad_blocks = TuningCache({k1: dict(blocks=dict(bkv="x")), k2: dict(blocks=[1])})
    assert bad_blocks.lookup_blocks("decode_attention", dict(b=1), "float32", "cuda") is None
    assert bad_blocks.lookup_blocks("decode_attention", dict(b=2), "float32", "cuda") is None


def test_the_ports_overlay_wins_and_ignores_the_reference_variable(tmp_path, monkeypatch):
    path = tmp_path / "user.json"
    table = TuningCache()
    table.put(cache_key("decode_attention", DA_SHAPE, "bfloat16", "cuda"), dict(blocks=dict(bkv=256)))
    table.save(str(path))
    monkeypatch.delenv(tc.ENV_CACHE_PATH, raising=False)
    monkeypatch.setenv(jax_cache.ENV_CACHE_PATH, str(path))
    prev = set_tuning_cache(None)
    try:
        tc.reset_tuning_cache()
        assert len(tc.get_tuning_cache()) == 0  # the committed default is empty; no TPU table is read
        monkeypatch.setenv(tc.ENV_CACHE_PATH, str(path))
        tc.reset_tuning_cache()
        assert tc.get_tuning_cache().lookup_blocks("decode_attention", DA_SHAPE, "bfloat16", "cuda") == \
            dict(bkv=256)
    finally:
        set_tuning_cache(prev)
    assert tc.ENV_CACHE_PATH == "REPRO_TORCH_TUNING_CACHE"
    assert json.loads(open(tc.DEFAULT_CACHE_PATH).read()) == {"entries": {}, "version": 1}


def test_restoring_an_unloaded_table_keeps_the_overlay(tmp_path, monkeypatch):
    path = tmp_path / "user.json"
    table = TuningCache()
    table.put(cache_key("decode_attention", DA_SHAPE, "bfloat16", "cuda"), dict(blocks=dict(bkv=256)))
    table.save(str(path))
    monkeypatch.setenv(tc.ENV_CACHE_PATH, str(path))
    outer = set_tuning_cache(None)  # nothing loaded yet
    try:
        prev = set_tuning_cache(TuningCache())
        assert prev is None
        assert resolve_bkv(*DA_SHAPE.values(), torch.bfloat16, "cuda") == DEFAULT_BKV
        set_tuning_cache(prev)
        assert resolve_bkv(*DA_SHAPE.values(), torch.bfloat16, "cuda") == 256  # the overlay again
    finally:
        set_tuning_cache(outer)


# ---------------------------------------------------------------------------
# roofline counts
# ---------------------------------------------------------------------------

ROOFLINE_CASES = [
    ("masked_matmul", dict(m=4, k=576, n=1536, r=256, c=256)),
    ("flash_attention", dict(b=4, hq=9, hkv=3, sq=2048, skv=2048, d=64, causal=1)),
    ("flash_attention", dict(b=1, hq=2, hkv=1, sq=128, skv=256, d=32, causal=0)),
    ("decode_attention", DA_SHAPE),
    ("mamba_scan", dict(b=4, l=128, d=8192, n=16)),
]


@pytest.mark.parametrize("tdtype,jdtype", [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)])
@pytest.mark.parametrize("kernel,shape", ROOFLINE_CASES)
def test_kernel_flops_bytes_match_the_reference(kernel, shape, tdtype, jdtype):
    assert roofline.kernel_flops_bytes(kernel, shape, tdtype) == \
        jax_roofline.kernel_flops_bytes(kernel, shape, jdtype)
    assert roofline.kernel_flops_bytes(kernel, shape, dtype_name(tdtype)) == \
        roofline.kernel_flops_bytes(kernel, shape, tdtype)


def test_roofline_uses_the_h100_data_sheet():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    flops, byts = roofline.kernel_flops_bytes("decode_attention", DA_SHAPE, torch.bfloat16)
    assert byts == pytest.approx(3.36e6, rel=1e-3)  # SmolLM-135M decode at b=4: about 1.0 us
    assert roofline.roofline_fraction(flops, byts, byts / 3.35e12) == pytest.approx(1.0)
    assert roofline.roofline_fraction(flops, byts, 0.0) == 0.0
    with pytest.raises(ValueError):
        roofline.kernel_flops_bytes("nope", {}, torch.float32)


# ---------------------------------------------------------------------------
# the recorder the tuner writes to
# ---------------------------------------------------------------------------


def test_histogram_matches_the_reference():
    rng = np.random.default_rng(0)
    values = rng.lognormal(-9, 1.5, 500).tolist() + [1e-5, 1e-4]
    buckets = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2)
    for max_samples in (1000, 50):
        ours, ref = Histogram("h", buckets, max_samples), JaxHistogram("h", buckets, max_samples)
        for v in values:
            ours.observe(v)
            ref.observe(v)
        assert ours.as_dict() == ref.as_dict()


def test_recorder_counts_like_the_reference():
    ours, ref = Recorder(capacity=4), JaxRecorder(capacity=4)
    for rec in (ours, ref):
        for i in range(6):
            with rec.timed("tune:x", proc="tune", track="x"):
                pass
            rec.count("c", 2)
        rec.instant("i", proc="tune")
    assert (len(ours.events), ours.events.dropped) == (len(ref.events), ref.events.dropped) == (4, 3)
    assert ours.metrics.counter("c").value == ref.metrics.counter("c").value == 12
    assert not NULL_RECORDER
    with pytest.raises(AttributeError):
        NULL_RECORDER.enabled = True


# ---------------------------------------------------------------------------
# the tuner's pipeline, with the runner stubbed
# ---------------------------------------------------------------------------


def _stub(monkeypatch, times):
    """Replace decode_attention's runner by one that records each launch and
    costs ``times(bkv)`` seconds on a fake clock."""
    launched = []
    clock = [0.0]

    def make_runner(shape, dtype, device):
        def call(blocks):
            launched.append(blocks["bkv"])
            clock[0] += times(blocks["bkv"])
        return call

    monkeypatch.setitem(KERNELS, "decode_attention",
                        dataclasses.replace(KERNELS["decode_attention"], make_runner=make_runner))
    monkeypatch.setattr("repro_torch.tune.tuner.time.perf_counter", lambda: clock[0])
    return launched


@pytest.mark.parametrize("skv", [512, 1000, 2048, 64])
def test_normalize_blocks_matches_the_reference(skv):
    shape = dict(b=1, hq=2, hkv=2, skv=skv, d=32)
    for bkv in pow2_lattice(skv) + [4096]:
        assert normalize_blocks("decode_attention", shape, dict(bkv=bkv)) == \
            jax_normalize_blocks("decode_attention", shape, dict(bkv=bkv))


def test_lint_rejected_candidates_never_reach_the_runner(monkeypatch):
    launched = _stub(monkeypatch, lambda bkv: 1.0 / bkv)  # bigger tiles are faster
    # at D=64 and a group of 3, bkv 1024 fits the 227 KiB and 2048 does not
    assert smem_bytes(1024, 64, 3) <= SMEM_LIMIT_BYTES < smem_bytes(2048, 64, 3)
    res = tune_kernel("decode_attention", DA_SHAPE, torch.bfloat16, device="cpu", iters=2)
    assert launched[0] == HEURISTIC_BLOCKS["decode_attention"]["bkv"] == DEFAULT_BKV  # the seed
    assert res.best_blocks == dict(bkv=1024)
    assert res.rejected_configs == [dict(blocks=dict(bkv=2048), codes=["KRN002"])]
    assert 2048 not in launched
    for bkv in set(launched):
        assert lint_candidate("decode_attention", DA_SHAPE, torch.bfloat16, dict(bkv=bkv))[0] == []
    assert res.best_s <= res.heuristic_s and res.speedup == pytest.approx(8.0)
    assert res.smem_bytes == smem_bytes(1024, 64, 3) and res.backend == "cpu"
    assert res.key == cache_key("decode_attention", DA_SHAPE, "bfloat16", "cpu")
    assert 0.0 < res.roofline_fraction


def test_the_winner_ties_the_heuristic_when_nothing_beats_it(monkeypatch):
    _stub(monkeypatch, lambda bkv: abs(bkv - 128) + 1.0)
    rec = Recorder()
    res = tune_kernel("decode_attention", DA_SHAPE, torch.float32, device="cpu", iters=3, recorder=rec)
    assert res.best_blocks == res.heuristic_blocks == dict(bkv=128)
    assert res.speedup == 1.0 and res.evaluated == 3  # 128, then 256 and 64
    spans = [e for e in rec.event_list() if e.kind == "span"]
    assert len(spans) == res.evaluated
    assert rec.metrics.histogram("tune.decode_attention.candidate_s").count == res.evaluated


def test_a_heuristic_that_fails_the_lint_raises_before_any_launch(monkeypatch):
    launched = _stub(monkeypatch, lambda bkv: 1.0)
    monkeypatch.setattr("repro_torch.analysis.kernelgeom.SMEM_LIMIT_BYTES", 1)
    with pytest.raises(ValueError, match="fails the geometry lint"):
        tune_kernel("decode_attention", DA_SHAPE, device="cpu")
    assert not launched
    with pytest.raises(ValueError, match="missing fields"):
        tune_kernel("decode_attention", dict(b=1), device="cpu")
    with pytest.raises(ValueError, match="unknown kernel"):
        tune_kernel("masked_matmul", dict(m=1, k=1, n=1, r=1, c=1), device="cpu")


def test_tune_many_fills_a_cache_that_steers_the_wrapper(monkeypatch, isolated_cache):
    _stub(monkeypatch, lambda bkv: abs(bkv - 512) + 1.0)
    cells = [("decode_attention", DA_SHAPE), ("decode_attention", dict(b=1, hq=2, hkv=2, skv=512, d=32))]
    results, table = tune_many(cells, dtype=torch.bfloat16, device="cpu", iters=1)
    assert len(results) == len(table) == 2
    assert [r.best_blocks for r in results] == [dict(bkv=512), dict(bkv=512)]
    for res in results:
        assert table.get(res.key)["blocks"] == res.best_blocks
        assert table.get(res.key)["smem_bytes"] == res.smem_bytes
    # the table is keyed by backend: a cpu-tuned entry does not steer a cuda launch
    shape = tuple(DA_SHAPE.values())
    set_tuning_cache(table)
    assert resolve_bkv(*shape, torch.bfloat16, "cuda") == DEFAULT_BKV


def test_tuned_block_resolution_order_read_off_the_launch(isolated_cache):
    shape = tuple(DA_SHAPE.values())
    assert resolve_bkv(*shape, torch.bfloat16, "cuda") == 128  # the heuristic
    isolated_cache.put(cache_key("decode_attention", DA_SHAPE, "bfloat16", "cuda"),
                       dict(blocks=dict(bkv=512, bogus=3)))
    assert resolve_bkv(*shape, torch.bfloat16, "cuda") == 512  # the cache
    assert resolve_bkv(*shape, torch.bfloat16, "cuda", bkv=64) == 64  # the caller
    assert resolve_bkv(*shape, torch.float32, "cuda") == 128  # another dtype misses
    assert resolve_bkv(*shape, torch.bfloat16, "cpu") == 128  # another backend misses
    assert resolve_bkv(4, 9, 3, 100, 64, torch.bfloat16, "cuda", bkv=512) == 100  # clamped to the cache


def test_tune_kernel_without_a_card_raises(monkeypatch):
    launched = _stub(monkeypatch, lambda bkv: 1.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune_kernel("decode_attention", DA_SHAPE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune_many([("decode_attention", DA_SHAPE)])
    assert not launched


def test_the_real_runner_times_the_plain_version_on_the_cpu(isolated_cache):
    res = tune_kernel("decode_attention", dict(b=1, hq=2, hkv=2, skv=64, d=32), device="cpu",
                      iters=1, max_evals=3)
    assert res.backend == "cpu" and res.evaluated >= 1 and res.best_s > 0
