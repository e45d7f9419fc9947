"""The bf16 masked GEMM's ``decode`` kernel (M <= 16), its schedule emulated on
the CPU and held to the reference.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``). What it
computes in which order is emulated here in numpy float32, step for step as
``csrc/masked_matmul.cu::decode_kernel`` lays it out, and held to the
reference package's Pallas kernel in interpret mode and to the port's plain
version, on the same seeded numpy inputs:

- the plan (``ops._plan``, ``gemm_plan``): column tiles of 256 (row-major w)
  or 32 (the tied unembedding's ``embed.T``), K cut into whole stages (16
  rows, or 128 k) over a cluster of at most 8 blocks a tile, the grid (tiles
  x slices, entries), no scratch;
- a row-major slice: stages of 16 rows, consumer warp q taking rows 2q and
  2q + 1 of each, each thread's fp32 sums in k order, the eight warps'
  partials added in warp order;
- a k-contiguous slice: stages of 128 k, 8 lanes a column, lane s taking k
  8s .. 8s + 7 and 64 + 8s .. 64 + 8s + 7 of each, the 8 lanes summed by a
  butterfly (xor 1, 2, 4);
- the mask bits as the kernel reads them (``packed_mask``: along C, or the
  transposed bits along R), each weight rounded to bf16 before its bit;
- the cluster's sum: the slices' partials added in rank order.

Shapes: M of 1, 4, 5, 8, 9 and 16 (the kernel's three instances), K of 8, 100
and 576, N of 8, 70, 132 and 300, masks of 8 x 8, 256 x 256 and 12 x 20,
row-major and k-contiguous w, a chip stack with one shared w (chip stride 0),
experts under one mask, and chips x experts (a mask group).

Tolerance: ``dtype_tol(bfloat16)`` (rtol 2e-2, atol 0.2): y is bf16, and the
emulation, the reference and the plain version sum K in different orders.
Bit equality is asserted only between two emulations of one schedule.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.faults import random_fault_map as jax_random_fault_map
from repro.kernels.masked_matmul.ops import masked_matmul as jax_masked_matmul
from repro_torch.kernels.common import assert_close
from repro_torch.kernels.masked_matmul import ops as mm

BF16 = torch.bfloat16
SMS = 132
ROWS_BN, ROWS_KD, COLS_BN, COLS_KD, WARPS = 256, 16, 32, 128, 8  # csrc/masked_matmul.cu's decode shape


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (round to nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16).float().numpy()


def _mask(bits: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Bits (rows, cols) of a packed bit matrix (8 entries a byte, entry j in
    bit j % 8 of byte j // 8), as 0/1 float32."""
    return ((bits[rows[:, None], cols[None, :] >> 3] >> (cols[None, :] & 7)) & 1).astype(np.float32)


def _slices(chips, m, n, k, kcontig, splits=None):
    """The plan's K slices (``splits`` forced in their place) and each
    slice's rows [k0, k1), checked against the launch geometry."""
    plan = mm.gemm_plan("decode", m, n, k, SMS, chips, kcontig, splits)
    bn, kd = (COLS_BN, COLS_KD) if kcontig else (ROWS_BN, ROWS_KD)
    s = plan.splits
    stages = -(-k // kd)
    per = -(-stages // s) * kd
    assert plan.grid == (-(-n // bn) * s, chips) and plan.scratch_bytes == 0 and plan.tile == (m, bn, kd)
    assert 1 <= s <= 16 and (s - 1) * per < k  # no empty slice
    return [(z * per, min(k, z * per + per)) for z in range(s)]


def _rows_slice(xe, wm, k0, k1):
    """One row-major slice's block partial (M, BN): warp q's sums over rows
    2q, 2q + 1 of each stage of 16, in k order, then warps 0 .. 7 in order."""
    acc = np.zeros((WARPS, xe.shape[0], wm.shape[1]), np.float32)
    q = np.arange(WARPS)
    for s0 in range(k0, k1, ROWS_KD):
        for rr in range(ROWS_KD // WARPS):
            kk = s0 + ROWS_KD // WARPS * q + rr
            live = kk < k1
            kk = np.minimum(kk, k1 - 1)
            prod = xe[:, kk].T[:, :, None] * wm[kk][:, None, :]  # exact: bf16 x bf16 in float32
            acc = np.where(live[:, None, None], acc + prod, acc)
    out = acc[0]
    for w in range(1, WARPS):
        out = out + acc[w]
    return out


def _cols_slice(xe, wm, k0, k1):
    """One k-contiguous slice's block partial (M, BN): lane s of a column
    sums k 8s + 64h + j of each stage of 128 (h = 0, 1; j = 0 .. 7) in that
    order; the 8 lanes meet by the butterfly xor 1, 2, 4 (lane 0's sum)."""
    acc = np.zeros((8, xe.shape[0], wm.shape[1]), np.float32)
    sub = np.arange(8)
    for s0 in range(k0, k1, COLS_KD):
        for h in range(2):
            for j in range(8):
                kk = s0 + 8 * sub + 64 * h + j
                live = kk < k1
                kk = np.minimum(kk, k1 - 1)
                prod = xe[:, kk].T[:, :, None] * wm[kk][:, None, :]
                acc = np.where(live[:, None, None], acc + prod, acc)
    for d in (1, 2, 4):
        acc = acc + acc[sub ^ d]
    return acc[0]


def _emulate_decode(x, w, bits, r, c, kcontig=False, mgroup=1, splits=None):
    """One decode launch over ``chips`` entries: x (chips, M, K), w (chips, K,
    N) as stored (fp32 or bf16 values), bits the packed masks (masks, R,
    ceil(C / 8)) along C, or for k-contiguous w the transposed ones (masks,
    C, ceil(R / 8)); entry i reads mask i // mgroup (mgroup 0: mask 0 for
    every entry). Returns y (chips, M, N) as float32 of its bf16 values."""
    chips, m, k = x.shape
    n = w.shape[2]
    bn = COLS_BN if kcontig else ROWS_BN
    slices = _slices(chips, m, n, k, kcontig, splits)
    wq = _bf16(w)  # each weight rounded to bf16 as it leaves the stage, before its bit
    y = np.zeros((chips, m, n), np.float32)
    kr = np.arange(k) % r
    for e in range(chips):
        b = bits[e // mgroup if mgroup else 0]
        for n0 in range(0, n, bn):
            cols = np.arange(n0, min(n0 + bn, n))
            ok = _mask(b, cols % c, kr).T if kcontig else _mask(b, kr, cols % c)  # (K, cols)
            wm = np.zeros((k, bn), np.float32)
            wm[:, : len(cols)] = wq[e][:, cols] * ok
            parts = [(_cols_slice if kcontig else _rows_slice)(x[e], wm, k0, k1) for k0, k1 in slices]
            out = parts[0]
            for p in parts[1:]:  # the cluster's rank order
                out = out + p
            y[e, :, cols] = out[:, : len(cols)].T
    return _bf16(y)


def _inputs(m, k, n, mask, chips=1, shared=False, transposed=False, masks=None, seed=0):
    """bf16-valued x (chips, M, K), fp32 w (chips or 1, K, N) (a transposed
    view for embed.T) and (masks, R, C) 0/1 masks, from numpy seeds."""
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((chips, m, k), np.float32))
    w = rng.standard_normal((1 if shared else chips, n, k), np.float32) / np.float32(np.sqrt(k))
    w = w.transpose(0, 2, 1)
    if not transposed:
        w = np.ascontiguousarray(w)
    r, c = mask
    ok = np.stack([jax_random_fault_map(seed + i, r, c, 0.3).ok_mask
                   for i in range(chips if masks is None else masks)]).astype(np.float32)
    return x, w, ok


def _bits(ok: np.ndarray, kcontig: bool) -> np.ndarray:
    """The packed masks the kernel reads (``packed_mask``), one a chip."""
    got = mm.packed_mask(torch.from_numpy(ok if ok.shape[0] > 1 else ok[0]))[1 if kcontig else 0].numpy()
    return got if got.ndim == 3 else got[None]


def _pallas(x, w, ok):
    """The reference's Pallas kernel in interpret mode on one (M, K) x
    (K, N) GEMM under one (R, C) mask, bf16 in and out."""
    y = jax_masked_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(_bf16(w), jnp.bfloat16),
                          jnp.asarray(ok), interpret=True)
    return np.asarray(y.astype(jnp.float32))


def _plain(x, w, ok):
    return mm.masked_matmul_ref(torch.from_numpy(x).to(BF16), torch.from_numpy(np.ascontiguousarray(w)),
                                torch.from_numpy(ok))


CASES = [  # (M, K, N, mask, embed.T): each M, K, N, mask and layout at least twice
    (1, 8, 8, (8, 8), False),
    (1, 576, 300, (12, 20), True),
    (4, 576, 132, (256, 256), False),
    (4, 100, 70, (8, 8), True),
    (5, 100, 300, (12, 20), False),
    (5, 576, 8, (256, 256), True),
    (8, 576, 70, (12, 20), False),
    (8, 8, 132, (256, 256), True),
    (9, 100, 8, (256, 256), False),
    (9, 576, 132, (8, 8), True),
    (16, 576, 300, (8, 8), False),
    (16, 100, 70, (12, 20), True),
]


@pytest.mark.parametrize("m,k,n,mask,transposed", CASES)
def test_decode_schedule_matches_the_pallas_kernel_and_the_plain_version(m, k, n, mask, transposed):
    x, w, ok = _inputs(m, k, n, mask, transposed=transposed, seed=m + k + n)
    got = _emulate_decode(x, w, _bits(ok, transposed), *mask, kcontig=transposed)[0]
    assert_close(got, _pallas(x[0], w[0], ok[0]), BF16)
    assert_close(got, _plain(x[0], w[0], ok[0]), BF16)


@pytest.mark.parametrize("m,k,n,transposed", [(4, 576, 300, False), (8, 2000, 132, False), (5, 1000, 70, True)])
def test_decode_slices_summed_in_rank_order_match_one_slice(m, k, n, transposed):
    """K cut into the plan's slices, 2 and the most ``max_splits`` allows:
    the cluster's rank-order sum against one slice and the reference."""
    x, w, ok = _inputs(m, k, n, (256, 256), transposed=transposed, seed=k)
    bits = _bits(ok, transposed)
    whole = _emulate_decode(x, w, bits, 256, 256, kcontig=transposed, splits=1)[0]
    assert transposed or mm._plan("decode", m, n, k, False, SMS)[0] > 1  # a narrow row-major w splits K
    for splits in (None, 2, mm.max_splits("decode", m, k)):
        got = _emulate_decode(x, w, bits, 256, 256, kcontig=transposed, splits=splits)[0]
        assert_close(got, whole, BF16)
        assert_close(got, _pallas(x[0], w[0], ok[0]), BF16)


@pytest.mark.parametrize("m", [1, 4, 5, 8, 9, 15])
@pytest.mark.parametrize("transposed", [False, True])
def test_decode_rows_keep_their_bits_with_one_more_row(m, transposed):
    """The k order of an output depends on neither M nor the instance M
    picks: the rows of an M-row launch are the bits of the same rows in an
    (M + 1)-row launch (``masked_matmul_checksummed``'s canary), the plan
    giving both the same slices."""
    k, n = 576, 300
    x, w, ok = _inputs(m + 1, k, n, (12, 20), transposed=transposed, seed=m)
    bits = _bits(ok, transposed)
    assert mm._plan("decode", m, n, k, transposed, SMS)[0] == mm._plan("decode", m + 1, n, k, transposed, SMS)[0]
    more = _emulate_decode(x, w, bits, 12, 20, kcontig=transposed)
    fewer = _emulate_decode(x[:, :m], w, bits, 12, 20, kcontig=transposed)
    assert np.array_equal(more[:, :m], fewer)


@pytest.mark.parametrize("m,k,n,transposed", [(4, 100, 132, False), (8, 576, 300, True)])
def test_decode_chip_stack_with_a_shared_weight(m, k, n, transposed):
    """Three chips' x and masks, one w for every chip (chip stride 0); each
    chip's rows are the bits of its own launch (the slices do not depend on
    the chip count)."""
    chips = 3
    x, w, ok = _inputs(m, k, n, (8, 8), chips=chips, shared=True, transposed=transposed, seed=7)
    bits = _bits(ok, transposed)
    got = _emulate_decode(x, np.broadcast_to(w, (chips, k, n)), bits, 8, 8, kcontig=transposed)
    kern = jax.vmap(lambda a, o: jax_masked_matmul(a, jnp.asarray(_bf16(w[0]), jnp.bfloat16), o, interpret=True))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(ok))
    assert_close(got, np.asarray(kern.astype(jnp.float32)), BF16)
    plain = mm.masked_matmul_ref(torch.from_numpy(x).to(BF16), torch.from_numpy(w).expand(chips, k, n),
                                 torch.from_numpy(ok))
    assert_close(got, plain, BF16)
    for c in range(chips):
        alone = _emulate_decode(x[c:c + 1], w, bits[c:c + 1], 8, 8, kcontig=transposed)
        assert np.array_equal(got[c], alone[0])


@pytest.mark.parametrize("m,k,n", [(4, 200, 132), (8, 576, 300)])
def test_decode_experts_under_one_mask(m, k, n):
    """Four experts' x and w under ONE mask: the mask group 0, every entry
    reading mask 0."""
    experts = 4
    x, w, ok = _inputs(m, k, n, (256, 256), chips=experts, masks=1, seed=11)
    got = _emulate_decode(x, w, _bits(ok, False), 256, 256, mgroup=0)
    kern = jax.vmap(lambda a, b: jax_masked_matmul(a, b, jnp.asarray(ok[0]), interpret=True))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(_bf16(w), jnp.bfloat16))
    assert_close(got, np.asarray(kern.astype(jnp.float32)), BF16)
    plain = mm.masked_matmul_ref(torch.from_numpy(x).to(BF16), torch.from_numpy(w), torch.from_numpy(ok[0]))
    assert_close(got, plain, BF16)


def test_decode_chips_x_experts_read_each_chips_mask():
    """Two chips x three experts: entry i reads mask i // 3 (a mask group of
    the expert count)."""
    chips, experts, m, k, n = 2, 3, 8, 200, 132
    x, w, ok = _inputs(m, k, n, (8, 8), chips=chips * experts, masks=chips, seed=13)
    got = _emulate_decode(x, w, _bits(ok, False), 8, 8, mgroup=experts).reshape(chips, experts, m, n)
    one = lambda a, b, o: jax_masked_matmul(a, b, o, interpret=True)  # noqa: E731
    kern = jax.vmap(jax.vmap(one, in_axes=(0, 0, None)))(
        jnp.asarray(x.reshape(chips, experts, m, k), jnp.bfloat16),
        jnp.asarray(_bf16(w).reshape(chips, experts, k, n), jnp.bfloat16), jnp.asarray(ok))
    assert_close(got, np.asarray(kern.astype(jnp.float32)), BF16)
    plain = mm.masked_matmul_ref(torch.from_numpy(x.reshape(chips, experts, m, k)).to(BF16),
                                 torch.from_numpy(w.reshape(chips, experts, k, n)), torch.from_numpy(ok))
    assert_close(got, plain, BF16)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,n,transposed", [(576, 576, False), (576, 192, False), (576, 1536, False),
                                            (1536, 576, False), (6144, 16384, False), (16384, 6144, False),
                                            (1600, 32001, False), (100, 3200, False), (3200, 132, False),
                                            (8, 8, False), (576, 49152, True), (1024, 151936, True),
                                            (100, 70, True)])
def test_decode_plan_slices_depend_on_one_entrys_shape_alone(k, n, transposed):
    """The slices: at most a cluster of 16 (8 beyond 3 column tiles), each at least a stage, none empty,
    as many as two blocks an SM over one entry's column tiles ask for; the
    same count at every chip count and every M (so a chip's or an expert's
    rows of a batched launch keep its own launch's bits); no scratch."""
    bn, kd = (COLS_BN, COLS_KD) if transposed else (ROWS_BN, ROWS_KD)
    tiles, stages = -(-n // bn), -(-k // kd)
    want = mm._split_count(stages, min(16 if tiles <= 3 else 8, max(1, 2 * SMS // tiles)))
    for m in (1, 4, 5, 8, 9, 16):
        for chips in (1, 2, 3, 8, 16):
            splits, scratch, tiles_all, rows = mm._plan("decode", m, n, k, transposed, SMS, chips)
            assert (splits, scratch, tiles_all, rows) == (want, 0, chips * tiles, m)
            plan = mm.gemm_plan("decode", m, n, k, SMS, chips, transposed)
            assert plan.grid == (tiles * want, chips) and plan.scratch_bytes == 0
    per = -(-stages // want)
    assert 1 <= want <= min(16, stages) and (want - 1) * per < stages
    assert want == 1 or tiles * want <= 2 * SMS


def test_decode_max_splits_is_a_cluster_of_stages():
    assert mm.max_splits("decode", 4, 576) == 16 and mm.max_splits("decode", 4, 100) == 7
    assert mm.max_splits("decode", 16, 8) == 1
    for splits in range(1, 17):  # a forced count drops its empty slices, as the plan does
        plan = mm.gemm_plan("decode", 4, 300, 400, SMS, splits=splits)
        assert plan.splits == mm._split_count(25, splits) and plan.scratch_bytes == 0
    with pytest.raises(ValueError, match="K slices"):
        mm.gemm_plan("decode", 4, 300, 576, SMS, splits=17)


ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "src/repro_torch/kernels/csrc/masked_matmul.cu").read_text()


def test_the_wrappers_decode_constants_are_the_c_sources():
    """``ops.py`` mirrors the decode kernel's stage, cluster cap, ring and
    block of ``csrc/masked_matmul.cu``, and its shared memory stays within a
    block's 227 KB at every instance (two blocks an SM for M <= 8 row-major
    fp32 w, the decode step's instance)."""
    import re

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))

    assert (const("DEC_ROWS_KD"), const("DEC_COLS_KD"), const("DEC_MAX_CLUSTER")) == (
        mm._DEC_ROWS_KD, mm._DEC_COLS_KD, mm._DEC_MAX_CLUSTER)
    assert const("DEC_MAX_STAGES") == mm._DEC_MAX_STAGES
    assert (const("DEC_WIDE_CLUSTER"), const("DEC_NARROW_TILES")) == (mm._DEC_WIDE_CLUSTER, mm._DEC_NARROW_TILES)
    assert "constexpr int DEC_RING_BYTES = 104 * 1024;" in SOURCE and mm._DEC_RING_BYTES == 104 * 1024
    for m in (4, 8, 16):
        for size in (2, 4):
            for kc in (False, True):
                smem = mm._dec_smem(m, size, kc)
                assert smem <= 232448
                if m <= 8:  # two blocks an SM (1 KB reserved a block)
                    assert 2 * (smem + 1024) <= 233472
    # row-major fp32 w at M <= 4: six stages of 16 rows of 256 columns (+ 16 bytes a row) and x
    assert mm._dec_smem(4, 4) == 192 + 128 + 6 * (16 * (256 * 4 + 16) + 4 * 16 * 2) + 4 * 256 * 4


# ---------------------------------------------------------------------------
# tools/masked_matmul_probe.py --decode
# ---------------------------------------------------------------------------


def _probe():
    import importlib.util

    spec = importlib.util.spec_from_file_location("masked_matmul_probe", ROOT / "tools" / "masked_matmul_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_decode_probe_patches_the_source_as_it_counts():
    probe = _probe()
    for patches in probe.DEC_DIAGNOSTICS.values():
        assert probe.patch(SOURCE, patches) != SOURCE
    for text in (*probe.DEC_FMA, probe.DEC_SLOT, probe.DEC_NO_MASK[0]):
        assert SOURCE.count(text) == 1


def test_decode_probe_counts_bulk_copies_and_cluster_barriers():
    probe = _probe()
    sass = """
        Function : _ZN12_GLOBAL__N_113decode_kernelIfLb0ELi8EEEvNS_7DecArgsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/              @!P0 UBLKCP.S.G [UR4], [UR6], UR8 ;
        /*0018*/              @!P0 UTMALDG.3D [UR8], [UR4] ;
        /*0020*/                   SYNCS.ARRIVE.TRANS64.RED.A1T0 RZ, [UR4], RZ ;
        /*0030*/                   UCGABAR_ARV ;
        /*0040*/                   UCGABAR_WAIT ;
        /*0050*/                   STL [R1], R2 ;
        Function : _ZN12_GLOBAL__N_118decode_rows_kernelI13__nv_bfloat16S1_Li4EEEvPKT_
        /*0000*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        Function : _ZN12_GLOBAL__N_118decode_rows_kernelIffLi4EEEvPKT_
        /*0000*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
"""
    got = probe.decode_sass_counts(sass)
    assert got == {
        "decode_kernel<fLb0ELi8E>": dict(UTMALDG=1, UBLKCP=1, UCGABAR=2, SYNCS=1, LDG128=0, LDL=0, STL=1,
                                         instructions=7),
        "decode_rows_kernel<13__nv_bfloat16S1_Li4E>": dict(UTMALDG=0, UBLKCP=0, UCGABAR=0, SYNCS=0, LDG128=1, LDL=0,
                                                          STL=0, instructions=1),
    }


def test_decode_probe_shapes_are_the_table_rows():
    """The probe's decode rows: each model's whole decode step at M = 4 with
    its launches (211, 257, 353; SmolLM's unembed embed.T), SmolLM's for 8
    chips, mixtral's wg and wd at M = 8 over 8 experts and 2 x 8."""
    from repro_torch.configs import get_arch

    rows = {}
    for row, arch, lead, m, k, n, uses, tied in _probe().decode_shapes(False):
        rows.setdefault(row, []).append((arch, lead, m, k, n, uses, tied))
    for row, arch, steps in (("1", "smollm-135m", 211), ("1a falcon", "falcon-mamba-7b", 257),
                             ("1a hymba", "hymba-1.5b", 353), ("1b", "smollm-135m", 211)):
        assert sum(r[5] for r in rows[row]) == steps
        assert {(k, n) for _, _, _, k, n, _, _ in rows[row]} == {(k, n) for k, n, _ in get_arch(arch).gemm_shapes()}
        assert [r[6] for r in rows[row]] == [False] * (len(rows[row]) - 1) + [arch == "smollm-135m"]
    assert {r[1] for r in rows["1b"]} == {(8,)} and {r[2] for r in rows["1"]} == {4}
    assert [r[1:5] for r in rows["1d"]] == [(("E", 8), 8, 6144, 16384), (("E", 8), 8, 16384, 6144)]
    assert [r[1:5] for r in rows["1e"]] == [((2, 8), 8, 6144, 16384), ((2, 8), 8, 16384, 6144)]
