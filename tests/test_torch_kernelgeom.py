"""The port's kernel geometry lint and launch builders against the reference's.

``analysis/programs.py::kernel_launches`` is held to the reference's
``_kernel_launches``: the same kernels, in the same order, at the same
logical shapes, for every configuration both packages register. Each
launch builder is held to its wrapper's own plan (the geometry the CUDA
kernels launch), and golden broken launches get their codes: KRN001 for a launch the
wrapper refuses, KRN002 for shared memory over the card's 227 KiB, KRN003
for a degenerate axis. Nothing here needs a card.
"""
import jax.numpy as jnp
import pytest
import torch

from repro.analysis import kernelgeom as jax_kg
from repro.analysis.programs import _kernel_launches as jax_kernel_launches
from repro.configs import get_arch as jax_get_arch
from repro_torch.analysis import (
    KernelLaunch,
    decode_attention_launch,
    flash_attention_launch,
    kernel_launches,
    lint_kernels,
    lint_launch,
    mamba_scan_launch,
    masked_matmul_launch,
)
from repro_torch.analysis.programs import _PAGE_SIZE, _SLOTS
from repro_torch.configs import get_arch, list_archs
from repro_torch.kernels.common import SMEM_LIMIT_BYTES
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.mamba_scan import ops as ms
from repro_torch.kernels.masked_matmul import ops as mm

ARCHS = list_archs(include_paper=True)
SMS = 132


def _codes(launch):
    return sorted({f.code for f in lint_launch(launch)})


# ---------------------------------------------------------------------------
# the launches of every configuration, against the reference's
# ---------------------------------------------------------------------------


def _logical(cfg):
    """The logical shapes the reference's ``_kernel_launches`` builds, by
    kernel: the arguments of each of its builder calls."""
    hq = cfg.num_heads or 8
    hkv = cfg.num_kv_heads or hq
    hd = cfg.resolved_head_dim or 64
    return [
        ("masked_matmul", (2048, cfg.d_model, cfg.d_ff or 4 * cfg.d_model)),
        ("flash_attention", (8, hq, hkv, 2048, 2048, hd)),
        ("decode_attention", (8, hq, hkv, 4096, hd)),
        ("paged_decode_attention", (_SLOTS, hq, hkv, 4096, hd)),
        ("mamba_scan", (8, 2048, 1536, 16)),
    ]


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_launches_match_the_reference_kernels_order_and_shapes(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    ours, ref = kernel_launches(cfg), jax_kernel_launches(jcfg)
    logical = _logical(cfg)
    assert [l.kernel for l in ours] == [l.kernel for l in ref] == [name for name, _ in logical]
    # the reference builds exactly these logical shapes ...
    (m, k, n), flash, dense, paged, scan = (args for _, args in logical)
    dtype = jnp.dtype(jcfg.dtype)
    mask = (jcfg.array_rows, jcfg.array_cols)
    assert ref[0] == jax_kg.masked_matmul_launch(m, k, n, mask, dtype=dtype, ctx=ref[0].ctx)
    assert ref[1] == jax_kg.flash_attention_launch(*flash, dtype=dtype)
    assert ref[2] == jax_kg.decode_attention_launch(*dense)
    assert ref[3] == jax_kg.decode_attention_launch(*paged, paged=True, page_size=_PAGE_SIZE)
    assert ref[4] == jax_kg.mamba_scan_launch(*scan)
    # ... and so does the port, at its wrappers' heuristics
    assert ours[0] == masked_matmul_launch(m, k, n, mask, dtype=cfg.dtype)
    assert ours[0].dims == (m, n, k)
    assert ours[1] == flash_attention_launch(*flash, dtype=cfg.dtype)
    assert ours[1].dims == (flash[0] * flash[1], flash[3], flash[4]) == ref[1].dims  # 2048 pads nothing
    assert ours[2] == decode_attention_launch(*dense)
    assert ours[2].dims == (dense[0] * dense[2], dense[3], dense[1] // dense[2])
    assert ours[3] == decode_attention_launch(*paged, paged=True, page_size=_PAGE_SIZE)
    assert ours[4] == mamba_scan_launch(*scan)
    assert ours[4].dims == (scan[0], 1536, 16)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_lint_is_clean_over_every_config_at_the_heuristics(arch):
    launches = kernel_launches(get_arch(arch))
    findings, stats = lint_kernels(launches)
    assert findings == []
    assert list(stats) == ["masked_matmul", "flash_attention", "decode_attention", "paged_decode_attention",
                           "mamba_scan"]
    for launch, row in zip(launches, stats.values()):
        assert row == dict(grid=list(launch.grid), smem_bytes=launch.smem_bytes, findings=0)
        assert all(g > 0 for g in launch.grid)


def test_lint_kernels_keys_a_repeated_kernel_like_the_reference():
    a = masked_matmul_launch(4, 576, 576, (256, 256), dtype="bfloat16")
    b = masked_matmul_launch(0, 576, 576, (256, 256), dtype="bfloat16")
    findings, stats = lint_kernels([a, b])
    _, jstats = jax_kg.lint_kernels([jax_kg.masked_matmul_launch(4, 576, 576, (256, 256))] * 2)
    assert list(stats) == list(jstats) == ["masked_matmul", "masked_matmul[1]"]
    assert stats["masked_matmul[1]"]["findings"] == len(findings) > 0
    assert set(stats["masked_matmul"]) == set(jstats["masked_matmul"]) - {"vmem_bytes"} | {"smem_bytes"}


# ---------------------------------------------------------------------------
# the launch builders mirror the wrappers' plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,m,k,n", [
    ("bfloat16", 4, 576, 576), ("bfloat16", 4, 576, 1536), ("bfloat16", 4, 4096, 16384),
    ("bfloat16", 8192, 576, 1536), ("bfloat16", 512, 576, 192), ("float32", 4, 576, 1536),
    ("float32", 512, 576, 192), ("float32", 8192, 1536, 576), ("float32", 17, 100, 132),
])
def test_masked_matmul_launch_is_the_wrappers_plan(dtype, m, k, n):
    kind = mm.pick_variant(getattr(torch, dtype), m)
    for splits in [None] + list(range(1, mm.max_splits(kind, m, k) + 1)):
        launch = masked_matmul_launch(m, k, n, (256, 256), dtype=dtype, splits=splits)
        plan = mm.gemm_plan(kind, m, n, k, SMS, splits=splits)
        assert launch.grid == plan.grid and launch.params == dict(splits=plan.splits)
        assert lint_launch(launch) == []
        blocks = launch.grid[0] * launch.grid[1] * (launch.grid[2] if len(launch.grid) > 2 else 1)
        if kind == "mma":  # persistent: one block an SM at most, walking every tile's slices
            assert blocks == min(plan.tiles * plan.splits, SMS)
        else:
            assert blocks == plan.tiles + (plan.split_tiles * (plan.splits - 1) if kind == "v1" and m > 16 else
                                           plan.tiles * (plan.splits - 1))
    # the chip axis multiplies the grid's chip extent (mma: the tiles its persistent blocks walk),
    # and k-contiguous w is the decode kernels' 32 columns
    three = masked_matmul_launch(m, k, n, (256, 256), dtype=dtype, chips=3)
    if kind == "mma":
        plan3 = mm.gemm_plan(kind, m, n, k, SMS, 3)
        assert plan3.tiles == 3 * mm.gemm_plan(kind, m, n, k, SMS).tiles
        assert three.grid == (min(plan3.tiles * plan3.splits, SMS), 1)
    else:
        assert three.grid[1] == 3
    if m <= 16:
        assert masked_matmul_launch(m, k, n, (256, 256), dtype=dtype, k_contiguous=True).blocks[1] == min(32, n)


def test_the_split_plan_is_the_c_sources_rule_and_its_cap():
    # bf16 decode: a cluster of 16 slices at most, of 16-row stages; v1 at M <= 16: 32 slices at most,
    # of 64-row granules; mma: 2 k tiles of 64 a slice; tiled v1: 8
    assert mm.max_splits("decode", 4, 8192) == 16 and mm.max_splits("decode", 4, 100) == 7
    assert mm.max_splits("v1", 4, 8192) == 32
    assert mm.max_splits("mma", 512, 576) == 9 // 2 and mm.max_splits("mma", 512, 100) == 1
    assert mm.max_splits("v1", 4, 576) == 9 and mm.max_splits("v1", 512, 576) == 72 // 8
    # the heuristic is the plan, and forcing its own count gives the same launch
    for kind, m, n, k in (("decode", 4, 1536, 576), ("mma", 512, 192, 576), ("v1", 4, 1536, 576),
                          ("v1", 512, 192, 576), ("v1", 8192, 1536, 576)):
        plan = mm.gemm_plan(kind, m, n, k, SMS)
        assert mm.gemm_plan(kind, m, n, k, SMS, splits=plan.splits) == plan
        if kind == "v1":
            assert tuple(mm._split_plan(m, n, k, SMS)) == (plan.splits, plan.scratch_bytes, plan.tiles,
                                                            plan.split_tiles)
        else:
            assert mm._plan(kind, m, n, k, False, SMS) == (plan.splits, plan.scratch_bytes, plan.tiles,
                                                            plan.tile[0])
    # a forced count loses its empty slices, as the plan's does; a v1 shape with no partial wave runs whole
    assert mm.gemm_plan("mma", 512, 192, 576, SMS, splits=4).splits == mm._split_count(9, 4) == 3
    assert mm.gemm_plan("decode", 4, 1536, 144, SMS, splits=8).splits == mm._split_count(9, 8) == 5
    whole = mm.gemm_plan("v1", 1024, 4224, 576, SMS)  # 8 x 33 = 264 tiles: two blocks on each of 132 SMs
    assert whole.tiles % (2 * SMS) == 0
    assert mm.gemm_plan("v1", 1024, 4224, 576, SMS, splits=8)[2:5] == (1, 0, 0)
    with pytest.raises(ValueError, match="K slices"):
        mm.gemm_plan("mma", 512, 192, 576, SMS, splits=5)
    with pytest.raises(ValueError):
        mm._plan("decode", 17, 288, 576, False, SMS)


def test_the_forced_split_scratch_stays_within_the_cap():
    """At M = 8192 a split costs 4 * splits * M * N bytes: the cap keeps
    SmolLM's prefill GEMMs under 240 MB."""
    for k, n in ((576, 1536), (1536, 576)):
        cap = mm.max_splits("mma", 8192, k)
        assert mm.gemm_plan("mma", 8192, n, k, SMS, splits=cap).scratch_bytes <= 4 * cap * 8192 * n < 240e6


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_flash_launch_mirrors_the_built_instances(d):
    for kind, dtype in (("mma", "bfloat16"), ("v1", "float32")):
        for bq, bkv in fa.TILES[kind]:
            launch = flash_attention_launch(4, 9, 3, 2048, 2048, d, bq=bq, bkv=bkv, dtype=dtype)
            assert launch.smem_bytes == fa.smem_bytes(kind, bq, bkv, d)
            assert launch.params == dict(bq=bq, bkv=bkv)
            built = (bq, bkv) in fa.tiles_built(kind, getattr(torch, dtype), d)
            assert (lint_launch(launch) == []) == built
            assert launch.grid == ((2048 // bq, 36) if kind == "mma" else (36, 2048 // bq))
            # mma: a consumer warpgroup a 64 rows and the producer warpgroup; v1: 256 threads
            assert launch.threads == (128 * (bq // 64 + 1) if kind == "mma" else 256)
        # no tile given: the variant's default
        assert flash_attention_launch(4, 9, 3, 2048, 2048, d, dtype=dtype).params == dict(
            zip(("bq", "bkv"), fa.DEFAULT_TILE[kind]))
    # bf16 v1 (a timing variant) is built at the default tile alone
    assert "KRN001" in _codes(flash_attention_launch(1, 2, 2, 64, 64, d, bq=128, bkv=64, dtype="bfloat16",
                                                     variant="v1"))


def test_flash_v1_shared_memory_is_the_c_sources():
    # 4 ((BQ + 4 BKV)(D + 4) + BQ (BKV + 4)) bytes at D = 128; the last two are over 232,448
    assert [fa.smem_bytes("v1", *t, 128) for t in ((64, 64), (128, 64), (64, 128))] == [186368, 237568, 337920]
    # mma: 1 KiB of alignment, Q and two (K, V) stages of 128-byte rows, ceil(D / 64) boxes a row
    assert fa.smem_bytes("mma", 64, 64, 64) == 41984 and fa.smem_bytes("mma", 64, 64, 128) == 82944
    assert fa.smem_bytes("mma", 128, 128, 80) == fa.smem_bytes("mma", 128, 128, 128) == 164864
    assert SMEM_LIMIT_BYTES == 232448
    assert fa.tiles_built("v1", torch.float32, 128) == ((64, 64), (64, 32))
    assert fa.tiles_built("v1", torch.float32, 80) == fa.TILES["v1"]


@pytest.mark.parametrize("b,d,n", [(4, 8192, 16), (4, 3200, 16), (2, 300, 64), (1, 11, 4)])
def test_scan_launch_is_the_wrappers_plan(b, d, n):
    heur = mamba_scan_launch(b, 128, d, n)
    assert heur.params == dict(lanes=ms.scan_plan(b, d, n, SMS).lanes)
    for lanes in ms.LANES:
        launch = mamba_scan_launch(b, 128, d, n, lanes=lanes)
        if lanes in ms.lane_choices(n):
            plan = ms._plan(b, d, n, lanes)
            assert launch.grid == (plan.blocks,) and lint_launch(launch) == []
            assert launch.blocks == (1, plan.channels, plan.lanes * plan.states)
        else:
            assert _codes(launch) == ["KRN001"]


# ---------------------------------------------------------------------------
# golden broken launches
# ---------------------------------------------------------------------------


def test_krn002_flash_v1_at_d128_with_a_128_row_tile():
    launch = flash_attention_launch(4, 16, 8, 2048, 2048, 128, bq=128, bkv=64, dtype=torch.float32)
    findings = lint_launch(launch)
    assert [f.code for f in findings] == ["KRN002"]
    assert findings[0].bytes == 237568 > SMEM_LIMIT_BYTES
    assert _codes(flash_attention_launch(4, 16, 8, 2048, 2048, 128, bq=64, bkv=128)) == ["KRN002"]
    assert _codes(flash_attention_launch(4, 16, 8, 2048, 2048, 128, bq=128, bkv=64, dtype="bfloat16")) == []


@pytest.mark.parametrize("launch", [
    masked_matmul_launch(0, 576, 576, (256, 256), dtype="bfloat16"),
    masked_matmul_launch(4, 576, 0, (256, 256)),
    flash_attention_launch(0, 9, 3, 2048, 2048, 64),
    flash_attention_launch(4, 9, 3, 2048, 2048, 64, bq=0, bkv=64),
    mamba_scan_launch(4, 128, 0, 16),
    decode_attention_launch(0, 9, 3, 2048, 64),
], ids=["mm-m0", "mm-n0", "fa-b0", "fa-bq0", "ms-d0", "da-b0"])
def test_krn003_for_a_degenerate_axis(launch):
    assert "KRN003" in _codes(launch)


def test_krn001_for_what_the_wrappers_refuse():
    # the scan's lanes: 16 states at one lane a channel is more than 8 a lane
    assert _codes(mamba_scan_launch(4, 128, 8192, 16, lanes=1)) == ["KRN001"]
    assert _codes(mamba_scan_launch(4, 128, 8192, 256, lanes=16)) == ["KRN001"]
    assert _codes(mamba_scan_launch(4, 128, 8192, 16, lanes=3)) == ["KRN001"]
    # a K split beyond the cap, and tiles no instance is built for
    assert _codes(masked_matmul_launch(512, 576, 192, (256, 256), dtype="bfloat16", splits=5)) == ["KRN001"]
    assert _codes(masked_matmul_launch(4, 576, 192, (256, 256), dtype="bfloat16", splits=17)) == ["KRN001"]
    assert _codes(flash_attention_launch(4, 9, 3, 2048, 2048, 64, bq=64, bkv=32, dtype="bfloat16")) == ["KRN001"]
    assert _codes(flash_attention_launch(4, 9, 3, 2048, 2048, 48)) == ["KRN001"]
    assert isinstance(masked_matmul_launch(4, 576, 192, (256, 256)), KernelLaunch)
