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
        # the committed default alone: no TPU table is read
        assert tc.get_tuning_cache().entries == TuningCache.load(tc.DEFAULT_CACHE_PATH).entries
        monkeypatch.setenv(tc.ENV_CACHE_PATH, str(path))
        tc.reset_tuning_cache()
        assert tc.get_tuning_cache().lookup_blocks("decode_attention", DA_SHAPE, "bfloat16", "cuda") == \
            dict(bkv=256)
    finally:
        set_tuning_cache(prev)
    assert tc.ENV_CACHE_PATH == "REPRO_TORCH_TUNING_CACHE"
    # the committed H100 table: card entries only, each faster than the heuristic by 5% in two runs
    doc = json.loads(open(tc.DEFAULT_CACHE_PATH).read())
    assert doc["version"] == 1
    for key, entry in doc["entries"].items():
        kernel, shape, _, backend = parse_key(key)
        assert kernel in KERNELS and backend == "cuda"
        assert min(entry["speedups"]) >= 1.05 and entry["speedup"] == entry["speedups"][0]
        assert all(card.startswith("NVIDIA H100") for card in entry["cards"])


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
        tune_kernel("no_such_kernel", dict(m=1, k=1, n=1, r=1, c=1), device="cpu")


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


# ---------------------------------------------------------------------------
# the four spaces: shape keys, the float32 roofline, the seams of the three new wrappers
# ---------------------------------------------------------------------------

from repro.tune.tuner import SHAPE_FIELDS as JAX_SHAPE_FIELDS  # noqa: E402
from repro_torch.kernels.flash_attention.ops import DEFAULT_TILE, TILES, resolve_tile  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.masked_matmul import ops as mm_ops  # noqa: E402
from repro_torch.tune.tuner import SHAPE_FIELDS  # noqa: E402

SPACE_SHAPES = {
    "masked_matmul": dict(m=4, k=576, n=1536, r=256, c=256),
    "flash_attention": dict(b=4, hq=9, hkv=3, sq=2048, skv=2048, d=64, causal=1),
    "decode_attention": DA_SHAPE,
    "mamba_scan": dict(b=4, l=128, d=8192, n=16),
}


def test_shape_fields_and_keys_are_the_references_for_all_four_kernels():
    assert SHAPE_FIELDS == JAX_SHAPE_FIELDS
    assert set(KERNELS) == set(SHAPE_FIELDS) == {"masked_matmul", "flash_attention", "decode_attention",
                                                 "mamba_scan"}
    for kernel, shape in SPACE_SHAPES.items():
        assert set(shape) == set(SHAPE_FIELDS[kernel])
        for dname in ("float32", "bfloat16"):
            ours = cache_key(kernel, dict(reversed(list(shape.items()))), dname, "cuda")
            assert ours == jax_cache.cache_key(kernel, shape, dname, "cuda")
            assert parse_key(ours) == jax_cache.parse_key(ours)


def test_a_float32_operation_bound_fraction_uses_the_simt_rate():
    """The float32 kernels run on the SIMT cores: 67 TFLOP/s, not the bf16
    tensor-core rate that the fraction of a bf16 launch uses."""
    shape = dict(m=512, k=576, n=192, r=256, c=256)  # v1's one-wave row
    flops, byts = roofline.kernel_flops_bytes("masked_matmul", shape, torch.float32)
    assert flops / 67e12 > byts / 3.35e12  # bound by operations
    t = 100e-6
    assert roofline.PEAK_FLOPS_FP32 == 67e12 and roofline.peak_flops("float32") == 67e12
    assert roofline.peak_flops(torch.bfloat16) == roofline.PEAK_FLOPS == 989e12
    assert roofline.roofline_fraction(flops, byts, t, torch.float32) == pytest.approx(flops / 67e12 / t)
    assert roofline.roofline_fraction(flops, byts, t, "bfloat16") == pytest.approx(
        max(flops / 989e12, byts / 3.35e12) / t)
    # at the bf16 rate this shape would look bound by its bytes, at 40% of the float32 fraction
    assert roofline.roofline_fraction(flops, byts, t, torch.float32) > 2 * roofline.roofline_fraction(
        flops, byts, t, torch.bfloat16)


def test_the_tuner_records_the_fraction_at_the_dtypes_peak(monkeypatch):
    shape = dict(m=512, k=576, n=192, r=256, c=256)
    _stub_space(monkeypatch, "masked_matmul", lambda b: 1e-3)
    res = tune_kernel("masked_matmul", shape, torch.float32, device="cpu", iters=1)
    flops, byts = roofline.kernel_flops_bytes("masked_matmul", shape, torch.float32)
    assert res.roofline_fraction == pytest.approx(flops / 67e12 / res.best_s)


def _stub_space(monkeypatch, kernel, times):
    """Replace a kernel's runner by one that records each launch's blocks and
    costs ``times(blocks)`` seconds on a fake clock."""
    launched = []
    clock = [0.0]

    def make_runner(shape, dtype, device):
        def call(blocks):
            launched.append(dict(blocks))
            clock[0] += times(blocks)
        return call

    monkeypatch.setitem(KERNELS, kernel, dataclasses.replace(KERNELS[kernel], make_runner=make_runner))
    monkeypatch.setattr("repro_torch.tune.tuner.time.perf_counter", lambda: clock[0])
    return launched


STUB_CASES = [  # (kernel, shape, dtype, seconds of a candidate)
    ("masked_matmul", dict(m=4, k=576, n=1536, r=256, c=256), torch.bfloat16, lambda b: 1.0 / b["splits"]),
    ("masked_matmul", dict(m=512, k=576, n=192, r=256, c=256), torch.float32, lambda b: abs(b["splits"] - 3) + 1),
    ("masked_matmul", dict(m=8192, k=576, n=1536, r=256, c=256), torch.bfloat16, lambda b: b["splits"]),
    ("flash_attention", dict(b=4, hq=9, hkv=3, sq=2048, skv=2048, d=64, causal=1), torch.bfloat16,
     lambda b: 1.0 / (b["bq"] * b["bkv"])),
    ("flash_attention", dict(b=4, hq=16, hkv=8, sq=2048, skv=2048, d=128, causal=1), torch.float32,
     lambda b: 1.0 / (b["bq"] * b["bkv"])),
    ("mamba_scan", dict(b=4, l=128, d=8192, n=16), torch.bfloat16, lambda b: abs(b["lanes"] - 4) + 1),
    ("mamba_scan", dict(b=4, l=2048, d=3200, n=16), torch.bfloat16, lambda b: 1.0 / b["lanes"]),
]


def test_the_table_holds_the_blocks_the_wrapper_launches(monkeypatch):
    """A winning lattice point that collapses (16 K slices of SmolLM's 36
    stages are 12) is stored as the launch it makes, so a wrapper reading the
    table reports in ``last_splits`` what the table holds."""
    shape = dict(m=4, k=576, n=1536, r=256, c=256)
    _stub_space(monkeypatch, "masked_matmul", lambda b: 1.0 / b["splits"])
    res = tune_kernel("masked_matmul", shape, torch.bfloat16, device="cpu", iters=2)
    assert res.best_blocks == dict(splits=12) == normalize_blocks("masked_matmul", shape, dict(splits=16),
                                                                  torch.bfloat16)
    assert mm_ops.gemm_plan("decode", 4, 1536, 576, 132, splits=res.best_blocks["splits"]).splits == 12


@pytest.mark.parametrize("kernel,shape,dtype,times", STUB_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(STUB_CASES)])
def test_each_new_space_beats_or_ties_its_seed_and_never_launches_a_rejected_point(
        monkeypatch, kernel, shape, dtype, times):
    launched = _stub_space(monkeypatch, kernel, times)
    res = tune_kernel(kernel, shape, dtype, device="cpu", iters=2)
    heur = normalize_blocks(kernel, shape, HEURISTIC_BLOCKS[kernel], dtype)
    assert launched[0] == res.heuristic_blocks == heur  # the seed is the wrapper's own choice
    assert res.best_s <= res.heuristic_s and res.speedup >= 1.0
    rejected = [r["blocks"] for r in res.rejected_configs]
    assert not any(b in rejected for b in launched)
    for b in launched:
        assert lint_candidate(kernel, shape, dtype, b)[0] == []
        assert normalize_blocks(kernel, shape, b, dtype) == b  # timed as launched
    for r in res.rejected_configs:
        assert r["codes"] and lint_candidate(kernel, shape, dtype, r["blocks"])[0]
    assert res.key == cache_key(kernel, shape, dtype_name(dtype), "cpu")
    assert len({tuple(sorted(b.items())) for b in launched}) == res.evaluated  # each launch timed once


def test_the_flash_space_rejects_tiles_that_are_not_built_or_do_not_fit(monkeypatch):
    launched = _stub_space(monkeypatch, "flash_attention", lambda b: 1.0 / (b["bq"] * b["bkv"]))
    shape = dict(b=4, hq=16, hkv=8, sq=2048, skv=2048, d=128, causal=1)
    res = tune_kernel("flash_attention", shape, torch.float32, device="cpu", iters=1, max_evals=99)
    codes = {(r["blocks"]["bq"], r["blocks"]["bkv"]): r["codes"] for r in res.rejected_configs}
    assert codes[(128, 64)] == ["KRN002"] and codes[(64, 128)] == ["KRN002"]  # 237,568 and 337,920 B
    assert all(c == ["KRN001"] for t, c in codes.items() if t not in TILES)
    assert {(b["bq"], b["bkv"]) for b in launched} <= {(64, 64), (64, 32)}
    assert res.best_blocks == dict(bq=64, bkv=64) and res.smem_bytes == 186368


def test_the_split_lattice_stops_at_the_plans_cap():
    from repro_torch.tune.tuner import _mm_lattice

    # bf16 decode: a cluster of at most 16 slices, each at least a stage of 16 rows
    assert _mm_lattice(dict(m=4, k=576, n=1536), torch.bfloat16) == dict(splits=[1, 2, 4, 8, 16])
    assert _mm_lattice(dict(m=4, k=100, n=1536), torch.bfloat16) == dict(splits=[1, 2, 4, 7])
    assert _mm_lattice(dict(m=8192, k=576, n=1536), torch.bfloat16) == dict(splits=[1, 2, 4])
    assert _mm_lattice(dict(m=512, k=576, n=192), torch.float32) == dict(splits=[1, 2, 4, 8, 9])
    assert _mm_lattice(dict(m=4, k=8192, n=4096), torch.bfloat16) == dict(splits=[1, 2, 4, 8, 16])
    assert _mm_lattice(dict(m=4, k=8192, n=4096), torch.float32) == dict(splits=[1, 2, 4, 8, 16, 32])
    # raw points that collapse to one launch: 8 slices of 9 stages are 5 of 2
    assert normalize_blocks("masked_matmul", dict(m=4, k=144, n=1536, r=256, c=256), dict(splits=8),
                            torch.bfloat16) == dict(splits=5)


@pytest.mark.parametrize("kernel,shape,dtype", [
    ("masked_matmul", dict(m=4, k=64, n=48, r=16, c=16), torch.float32),
    ("masked_matmul", dict(m=24, k=128, n=40, r=16, c=16), torch.bfloat16),
    ("flash_attention", dict(b=1, hq=2, hkv=1, sq=48, skv=48, d=64, causal=1), torch.float32),
    ("flash_attention", dict(b=1, hq=2, hkv=2, sq=40, skv=40, d=80, causal=0), torch.bfloat16),
    ("mamba_scan", dict(b=1, l=12, d=24, n=4), torch.float32),
])
def test_the_real_runners_time_the_plain_versions_on_the_cpu(isolated_cache, kernel, shape, dtype):
    res = tune_kernel(kernel, shape, dtype, device="cpu", iters=1, max_evals=3)
    assert res.backend == "cpu" and res.evaluated >= 1 and res.best_s > 0
    assert res.best_s <= res.heuristic_s


def test_the_masked_gemm_seam_resolution_order(isolated_cache):
    shape = dict(m=4, k=144, n=1536, r=256, c=256)
    plan = mm_ops.gemm_plan("decode", 4, 1536, 144, 132)

    def launched(**kw):
        return mm_ops.resolve_plan(torch.bfloat16, 4, 144, 1536, (256, 256), "cuda", 132, **kw).splits

    assert launched() == plan.splits == 5  # the plan: 8 slices of 9 stages are 5
    isolated_cache.put(cache_key("masked_matmul", shape, "bfloat16", "cuda"), dict(blocks=dict(splits=2)))
    assert launched() == 2  # the cache
    assert launched(splits=3) == 3  # the caller
    assert launched(splits=4) == 3  # 4 slices of 9 stages leave one empty: 3 of 3
    assert launched(k_contiguous=True) == mm_ops.gemm_plan("decode", 4, 1536, 144, 132, k_contiguous=True).splits
    assert launched(chips=2) == mm_ops.gemm_plan("decode", 4, 1536, 144, 132, 2).splits  # chip-batched: the plan
    assert launched(variant="v1") == mm_ops.gemm_plan("v1", 4, 1536, 144, 132).splits  # a forced v1: the plan
    assert mm_ops.resolve_plan(torch.float32, 4, 576, 1536, (256, 256), "cuda", 132).splits == 9  # float32 misses
    assert mm_ops.resolve_plan(torch.bfloat16, 4, 144, 1536, (256, 256), "cpu", 132).splits == 5  # cpu misses
    isolated_cache.put(cache_key("masked_matmul", shape, "bfloat16", "cuda"), dict(blocks=dict(splits=64)))
    with pytest.raises(ValueError, match="K slices"):  # a tuned entry the plan refuses raises
        launched()


def test_the_flash_seam_resolution_order(isolated_cache):
    args = (4, 9, 3, 2048, 2048, 64, True, torch.bfloat16, "cuda")
    assert resolve_tile(*args) == DEFAULT_TILE == (64, 64)
    isolated_cache.put(cache_key("flash_attention", dict(b=4, hq=9, hkv=3, sq=2048, skv=2048, d=64, causal=1),
                                 "bfloat16", "cuda"), dict(blocks=dict(bq=128, bkv=32)))
    assert resolve_tile(*args) == (128, 32)
    assert resolve_tile(*args, bkv=128) == (128, 128)  # the caller, per parameter
    assert resolve_tile(*args[:6], False, *args[7:]) == (64, 64)  # not causal: another key
    assert resolve_tile(*args, variant="v1") == (64, 64)  # a forced v1 keeps the default


def test_the_scan_seam_resolution_order(isolated_cache):
    plan = scan_ops.scan_plan(4, 8192, 16, 132)
    assert scan_ops.resolve_plan(4, 128, 8192, 16, torch.bfloat16, "cuda", 132) == plan
    isolated_cache.put(cache_key("mamba_scan", dict(b=4, l=128, d=8192, n=16), "bfloat16", "cuda"),
                       dict(blocks=dict(lanes=8)))
    assert scan_ops.resolve_plan(4, 128, 8192, 16, torch.bfloat16, "cuda", 132).lanes == 8
    assert scan_ops.resolve_plan(4, 128, 8192, 16, torch.bfloat16, "cuda", 132, lanes=4).lanes == 4
    assert scan_ops.resolve_plan(4, 129, 8192, 16, torch.bfloat16, "cuda", 132) == plan  # another L misses
    isolated_cache.put(cache_key("mamba_scan", dict(b=4, l=128, d=8192, n=16), "bfloat16", "cuda"),
                       dict(blocks=dict(lanes=1)))
    with pytest.raises(ValueError, match="no scan kernel"):  # 16 states in one lane: refused, not skipped
        scan_ops.resolve_plan(4, 128, 8192, 16, torch.bfloat16, "cuda", 132)


def test_the_seam_memo_is_one_lookup_and_drops_with_the_table(isolated_cache):
    calls = []

    def defaults():
        calls.append(1)
        return dict(lanes=2)

    from repro_torch.kernels.common import tuned_block

    shape = dict(b=1, l=2, d=3, n=4)

    def get():
        return tuned_block("mamba_scan", shape, torch.float32, device="cuda", defaults=defaults)

    assert get() == get() == dict(lanes=2) and len(calls) == 1  # memoized: the defaults ran once
    assert len(tc.SEAM_MEMO) == 1
    isolated_cache.put(cache_key("mamba_scan", shape, "float32", "cuda"), dict(blocks=dict(lanes=8)))
    assert not tc.SEAM_MEMO  # a put into the process table drops it
    assert get() == dict(lanes=8) and len(calls) == 2
    TuningCache().put(cache_key("mamba_scan", shape, "float32", "cuda"), dict(blocks=dict(lanes=4)))
    assert tc.SEAM_MEMO and get() == dict(lanes=8)  # a put into another table does not
    set_tuning_cache(TuningCache())
    assert not tc.SEAM_MEMO and get() == dict(lanes=2)
    tc.reset_tuning_cache()
    assert not tc.SEAM_MEMO


def test_the_default_table_keeps_what_two_runs_agree_on_at_5_percent(tmp_path):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "default_table.py"
    spec = importlib.util.spec_from_file_location("default_table", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    keys = [cache_key("flash_attention", dict(b=i), "bfloat16", "cuda") for i in range(5)]
    a, b = TuningCache(), TuningCache()
    for key, (ea, eb) in zip(keys, [((64, 1.2), (64, 1.06)),  # kept
                                    ((64, 1.2), (64, 1.04)),  # run B under 5%
                                    ((64, 1.2), (32, 1.2)),  # the runs disagree on the blocks
                                    ((64, 1.05), (64, 1.05))]):  # kept: at 5% exactly
        a.put(key, dict(blocks=dict(bq=ea[0]), speedup=ea[1], smem_bytes=1))
        b.put(key, dict(blocks=dict(bq=eb[0]), speedup=eb[1], smem_bytes=1))
    a.put(keys[4], dict(blocks=dict(bq=64), speedup=2.0))  # in run A only
    for run, table in (("a", a), ("b", b)):
        (tmp_path / run).mkdir()
        table.save(str(tmp_path / run / "tune_table.json"))
        (tmp_path / run / "chip_smoke.json").write_text(json.dumps(dict(card=f"card {run}")))
    assert tool.main([str(tmp_path / "a"), str(tmp_path / "b"), "--out", str(tmp_path / "out.json")]) == 0
    out = TuningCache.load(str(tmp_path / "out.json"))
    assert sorted(out.entries) == sorted([keys[0], keys[3]])
    assert out.get(keys[0]) == dict(blocks=dict(bq=64), speedup=1.2, smem_bytes=1, speedups=[1.2, 1.06],
                                    cards=["card a", "card b"])
