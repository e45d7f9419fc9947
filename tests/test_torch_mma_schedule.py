"""The bf16 masked GEMM's ``mma`` kernel, its walk emulated on the CPU and held
to the reference.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``). What it
computes in which order is emulated here in numpy float32, step for step as
``csrc/masked_matmul.cu::mma_kernel`` lays it out, and held to the reference
package's Pallas kernel in interpret mode and to the port's plain version, on
the same seeded numpy inputs:

- the plan (``ops._plan``): the token tile, the K slices and the persistent
  grid of at most one block an SM, whose blocks walk every work item (chip,
  output tile, slice) in the kernel's order, each item exactly once;
- an item: two consumer warpgroups of 64 weight columns each, over the
  slice's k tiles of 64 and each tile's four k steps of 16, every step one
  ``wgmma`` of (w rounded to bf16, times its mask bit)^T (64 x 16) by the x
  tile (16 x tokens), summed in fp32;
- the mask bits as the kernel reads them: each column's row of the
  transposed bit matrix (``packed_mask(ok)[1]``) at k % R, by one 8-byte
  word a k tile where R is a multiple of 64, bit by bit otherwise;
- K split: each slice's fp32 partial, summed in slice order.

Shapes: M of 17, 24, 160 and 257 (token tiles 128 and 256, and 128-row
tiles where one 256-row tile and a ragged second would leave the card idle), K not a multiple of 64, N not a multiple of 64, masks
of 8 x 8, 256 x 256 and 12 x 20, row-major and k-contiguous w (the tied
unembedding's ``embed.T``), a chip stack with one shared w (chip stride 0),
experts under one mask, and chips x experts (a mask group).

Tolerance: ``dtype_tol(bfloat16)`` (rtol 2e-2, atol 0.2): y is bf16, and the
emulation, the reference and the plain version sum K in different orders.
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
BN, BK, GROUP_M = 128, 64, 8  # csrc/masked_matmul.cu: MMA_BN, MMA_BK, MMA_GROUP_M


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (round to nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16).float().numpy()


def _items(chips, m, n, k, splits=None):
    """The plan's token tile and K slices (``splits`` forced in their place,
    empty slices dropped as ``gemm_plan`` drops them) and every work item in
    the kernel's order (``locate``): chip, then output tile, then slice;
    tiles in groups of 8 token tiles walked across the column tiles, token
    tiles fastest. An item is (chip, m0, n0, slice, first k tile, k tiles)."""
    plan = mm.gemm_plan("mma", m, n, k, SMS, chips, splits=splits)
    tok, splits = plan.tile[0], plan.splits
    tiles_m, tiles_n, tiles_k = -(-m // tok), -(-n // BN), -(-k // BK)
    per = -(-tiles_k // splits)
    items = []
    for item in range(chips * tiles_m * tiles_n * splits):
        chip, rem = divmod(item, tiles_m * tiles_n * splits)
        tile, z = divmod(rem, splits)
        group = tile // (GROUP_M * tiles_n)
        first_m = group * GROUP_M
        group_m = min(tiles_m - first_m, GROUP_M)
        in_group = tile - group * GROUP_M * tiles_n
        m0 = (first_m + in_group % group_m) * tok
        n0 = in_group // group_m * BN
        items.append((chip, m0, n0, z, z * per, max(0, min(tiles_k - z * per, per))))
    assert plan.grid == (min(len(items), SMS), 1) and plan.tiles == chips * tiles_m * tiles_n
    return tok, splits, items


def _mask_word(row: np.ndarray, r: int, kr: int) -> int:
    """mask_word: 64 mask bits of one column from its row of the transposed
    bit matrix (bytes, bit j of byte i = mask row 8i + j), bit i for
    k = k0 + i, kr = k0 % R."""
    if r % 64 == 0:  # one little-endian 8-byte word
        return int.from_bytes(row[kr // 8: kr // 8 + 8].tobytes(), "little")
    v = 0
    for i in range(64):
        q = (kr + i) % r
        v |= ((int(row[q >> 3]) >> (q & 7)) & 1) << i
    return v


def _emulate_mma(x, w, bits_t, r, c, mgroup=1, splits=None):
    """One mma launch over ``chips`` entries: x (chips, M, K), w (chips, K,
    N) as stored (fp32 or bf16 values), bits_t (masks, C, ceil(R / 8)), entry
    i reading mask i // mgroup (mgroup 0: mask 0 for every entry). Returns y
    (chips, M, N) as float32 of its bf16 values."""
    chips, m, k = x.shape
    n = w.shape[2]
    tok, splits, items = _items(chips, m, n, k, splits)
    tiles_k, tiles_n, tiles_m = -(-k // BK), -(-n // BN), -(-m // tok)
    # the ring's zero fill past every edge (TMA, or the producer's copies)
    xp = np.zeros((chips, tiles_m * tok, tiles_k * BK), np.float32)
    xp[:, :m, :k] = x
    wp = np.zeros((chips, tiles_k * BK, tiles_n * BN), np.float32)
    wp[:, :k, :n] = _bf16(w)  # each weight rounded to bf16 as it leaves the tile
    part = np.zeros((chips, splits, m, n), np.float32)
    y = np.zeros((chips, m, n), np.float32)
    blocks = min(len(items), SMS)
    done = []
    for b in range(blocks):  # the persistent walk: block b takes items b, b + blocks, ...
        for chip, m0, n0, z, t0, nt in items[b::blocks]:
            done.append((chip, m0, n0, z))
            mask = bits_t[chip // mgroup if mgroup else 0]
            acc = np.zeros((BN, tok), np.float32)  # y^T of the tile: two warpgroups of 64 columns
            for wg in range(2):
                cols = slice(n0 + 64 * wg, n0 + 64 * wg + 64)
                rows = [mask[col % c] for col in range(cols.start, cols.stop)]
                kr = t0 * BK % r
                for t in range(t0, t0 + nt):
                    words = np.array([_mask_word(row, r, kr) for row in rows], np.uint64)
                    for s in range(4):
                        k16 = slice(t * BK + 16 * s, t * BK + 16 * s + 16)
                        shift = (16 * s + np.arange(16)).astype(np.uint64)
                        bits = ((words[:, None] >> shift) & np.uint64(1)).astype(np.float32)
                        a = wp[chip, k16, cols].T * bits  # (64, 16): the A fragment's values
                        acc[64 * wg: 64 * wg + 64] += a @ xp[chip, m0: m0 + tok, k16].T
                    kr = (kr + BK) % r
            rows_m, cols_n = slice(m0, min(m0 + tok, m)), slice(n0, min(n0 + BN, n))
            out = acc[: cols_n.stop - n0, : rows_m.stop - m0].T
            if splits == 1:
                y[chip, rows_m, cols_n] = out
            else:
                part[chip, z, rows_m, cols_n] = out
    want = [(chip, m0, n0, z) for tiles_m in [-(-m // tok)] for chip in range(chips) for mt in range(tiles_m)
            for m0 in [mt * tok] for n0 in range(0, tiles_n * BN, BN) for z in range(splits)]
    assert sorted(done) == sorted(want)  # every output tile's every slice, once
    for z in range(splits if splits > 1 else 0):  # the last slice's block sums the partials in slice order
        y = y + part[:, z]
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


def _bits(ok: np.ndarray) -> np.ndarray:
    """The transposed bit matrices the kernel reads (``packed_mask``)."""
    return packed_t(torch.from_numpy(ok if ok.shape[0] > 1 else ok[0]))


def packed_t(ok_t: torch.Tensor) -> np.ndarray:
    bits_t = mm.packed_mask(ok_t)[1].numpy()
    return bits_t if bits_t.ndim == 3 else bits_t[None]


def _pallas(x, w, ok):
    """The reference's Pallas kernel in interpret mode on one (M, K) x
    (K, N) GEMM under one (R, C) mask, bf16 in and out."""
    y = jax_masked_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(_bf16(w), jnp.bfloat16),
                          jnp.asarray(ok), interpret=True)
    return np.asarray(y.astype(jnp.float32))


CASES = [  # (M, K, N, mask, embed.T)
    (17, 100, 132, (8, 8), False),
    (17, 100, 132, (256, 256), True),
    (24, 300, 200, (256, 256), False),
    (24, 300, 200, (8, 8), True),
    (160, 200, 132, (256, 256), False),
    (160, 576, 200, (12, 20), True),
    (257, 300, 132, (8, 8), False),
    (257, 200, 200, (256, 256), True),
    (257, 100, 70, (12, 20), False),
]


@pytest.mark.parametrize("m,k,n,mask,transposed", CASES)
def test_mma_walk_matches_the_pallas_kernel_and_the_plain_version(m, k, n, mask, transposed):
    x, w, ok = _inputs(m, k, n, mask, transposed=transposed, seed=m + k + n)
    got = _emulate_mma(x, w, _bits(ok), *mask)[0]
    assert_close(got, _pallas(x[0], w[0], ok[0]), BF16)
    plain = mm.masked_matmul_ref(torch.from_numpy(x[0]).to(BF16), torch.from_numpy(w[0]), torch.from_numpy(ok[0]))
    assert_close(got, plain, BF16)


@pytest.mark.parametrize("m,k,n", [(24, 1000, 200), (160, 2000, 132), (257, 576, 70)])
def test_mma_split_slices_summed_in_order_match_one_slice(m, k, n):
    """K cut into the plan's slices, 2 and the most ``max_splits`` allows:
    each slice's partial summed in slice order, against one slice and the
    reference."""
    x, w, ok = _inputs(m, k, n, (256, 256), seed=k)
    bits = _bits(ok)
    whole = _emulate_mma(x, w, bits, 256, 256, splits=1)[0]
    assert mm._plan("mma", m, n, k, False, SMS)[0] > 1  # these shapes leave SMs idle: the plan splits K
    for splits in (None, 2, mm.max_splits("mma", m, k)):
        got = _emulate_mma(x, w, bits, 256, 256, splits=splits)[0]
        assert_close(got, whole, BF16)
        assert_close(got, _pallas(x[0], w[0], ok[0]), BF16)


def test_mma_walk_at_the_mask_modes_reads_the_same_bits():
    """The two ways a column's word is read (R a multiple of 64, any other
    R, 8 and 32 among them) give the bits of the (k % R, n % C) mask."""
    rng = np.random.default_rng(0)
    for r, c in ((256, 256), (64, 8), (8, 8), (32, 16), (12, 20), (100, 3)):
        ok = (rng.random((r, c)) > 0.3).astype(np.float32)
        bits_t = packed_t(torch.from_numpy(ok))[0]
        for col in (0, c - 1):
            for k0 in (0, 64, 192, 640):
                kr = k0 % r
                word = _mask_word(bits_t[col], r, kr)
                want = sum(int(ok[(k0 + i) % r, col]) << i for i in range(64))
                assert word == want, (r, c, col, k0)


@pytest.mark.parametrize("m,k,n,transposed", [(17, 100, 132, False), (160, 300, 200, True)])
def test_mma_chip_stack_with_a_shared_weight(m, k, n, transposed):
    """Three chips' x and masks, one w for every chip (chip stride 0)."""
    chips = 3
    x, w, ok = _inputs(m, k, n, (8, 8), chips=chips, shared=True, transposed=transposed, seed=7)
    got = _emulate_mma(x, np.broadcast_to(w, (chips, k, n)), _bits(ok), 8, 8)
    kern = jax.vmap(lambda a, o: jax_masked_matmul(a, jnp.asarray(_bf16(w[0]), jnp.bfloat16), o, interpret=True))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(ok))
    assert_close(got, np.asarray(kern.astype(jnp.float32)), BF16)
    plain = mm.masked_matmul_ref(torch.from_numpy(x).to(BF16), torch.from_numpy(w).expand(chips, k, n),
                                 torch.from_numpy(ok))
    assert_close(got, plain, BF16)


@pytest.mark.parametrize("m,k,n", [(24, 200, 132), (160, 300, 70)])
def test_mma_experts_under_one_mask(m, k, n):
    """Four experts' x and w under ONE mask: the mask group 0, every entry
    reading mask 0."""
    experts = 4
    x, w, ok = _inputs(m, k, n, (256, 256), chips=experts, masks=1, seed=11)
    got = _emulate_mma(x, w, _bits(ok), 256, 256, mgroup=0)
    kern = jax.vmap(lambda a, b: jax_masked_matmul(a, b, jnp.asarray(ok[0]), interpret=True))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(_bf16(w), jnp.bfloat16))
    assert_close(got, np.asarray(kern.astype(jnp.float32)), BF16)
    plain = mm.masked_matmul_ref(torch.from_numpy(x).to(BF16), torch.from_numpy(w), torch.from_numpy(ok[0]))
    assert_close(got, plain, BF16)


def test_mma_chips_x_experts_read_each_chips_mask():
    """Two chips x three experts: entry i reads mask i // 3 (a mask group of
    the expert count)."""
    chips, experts, m, k, n = 2, 3, 160, 200, 132
    x, w, ok = _inputs(m, k, n, (8, 8), chips=chips * experts, masks=chips, seed=13)
    got = _emulate_mma(x, w, _bits(ok), 8, 8, mgroup=experts).reshape(chips, experts, m, n)
    one = lambda a, b, o: jax_masked_matmul(a, b, o, interpret=True)  # noqa: E731
    kern = jax.vmap(jax.vmap(one, in_axes=(0, 0, None)))(
        jnp.asarray(x.reshape(chips, experts, m, k), jnp.bfloat16),
        jnp.asarray(_bf16(w).reshape(chips, experts, k, n), jnp.bfloat16), jnp.asarray(ok))
    assert_close(got, np.asarray(kern.astype(jnp.float32)), BF16)
    plain = mm.masked_matmul_ref(torch.from_numpy(x.reshape(chips, experts, m, k)).to(BF16),
                                 torch.from_numpy(w.reshape(chips, experts, k, n)), torch.from_numpy(ok))
    assert_close(got, plain, BF16)


@pytest.mark.parametrize("m,n,chips", [(17, 132, 1), (160, 16384, 8), (257, 576, 1), (512, 576, 8),
                                       (8192, 576, 1), (8192, 1536, 1), (8192, 192, 1), (1024, 49152, 1)])
def test_mma_plan_tiles_and_grid(m, n, chips):
    """The token tile, the persistent grid and the launch geometry the lint
    reads: tiles of 128 or 256 tokens by 128 weight columns, at most one
    block an SM, each slice at least two k tiles of 64."""
    k = 576
    splits, scratch, tiles, tok = mm._plan("mma", m, n, k, False, SMS, chips)
    assert tok == mm._mma_tokens(m, n, SMS, chips)
    tiles256 = chips * -(-m // 256) * -(-n // BN)
    assert tok == (128 if m <= 128 else 256 if m <= 256 or 2 * tiles256 >= SMS else 128)
    assert tiles == chips * -(-m // tok) * -(-n // BN)
    plan = mm.gemm_plan("mma", m, n, k, SMS, chips)
    assert plan.tile == (tok, BN, BK) and plan.grid == (min(tiles * splits, SMS), 1)
    per = -(-9 // splits)
    # K is cut as one entry alone would cut it: the same slices at every chip count
    tiles1 = -(-m // mm._mma_tokens(m, n, SMS)) * -(-n // BN)
    assert splits == 1 or (per >= 2 and tiles1 * splits <= SMS and 8 * tiles1 <= SMS)
    assert splits == mm._plan("mma", m, n, k, False, SMS)[0]
    assert scratch == (0 if splits == 1 else 4 * chips * splits * m * n)
    assert mm._mma_smem(tok, 4) <= 227 * 1024 and mm._mma_smem(tok, 2) <= 227 * 1024


# ---------------------------------------------------------------------------
# the C source's constants the wrapper mirrors, and tools/masked_matmul_probe.py
# ---------------------------------------------------------------------------

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "src/repro_torch/kernels/csrc/masked_matmul.cu").read_text()


def _probe():
    import importlib.util

    spec = importlib.util.spec_from_file_location("masked_matmul_probe", ROOT / "tools" / "masked_matmul_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_wrappers_mma_constants_are_the_c_sources():
    """``ops.py`` mirrors the tile, the k depth, the slice floor and the
    ring's budget of ``csrc/masked_matmul.cu``, and the token-tile rule."""
    import re

    def const(name):  # an integer constant of the source, its expression evaluated (200 * 1024)
        return eval(re.search(rf"constexpr int {name} = ([0-9* ]+);", SOURCE).group(1), {})

    assert (const("MMA_BN"), const("MMA_BK"), const("MMA_MIN_TILES"), const("MMA_SPLIT_SHARE")) == (
        mm._MMA_BN, mm._MMA_BK, mm._MMA_MIN_TILES, mm._MMA_SPLIT_SHARE)
    assert (const("MMA_RING_BYTES"), const("MMA_MAX_STAGES")) == (mm._MMA_RING_BYTES, mm._MMA_MAX_STAGES)
    assert "return 2 * tiles < sms ? 128 : 256;" in SOURCE and "if (M <= 128) return 128;" in SOURCE
    # the ring at each token tile and w dtype: 3-6 stages, within a block's 227 KB
    for tok in (128, 256):
        for size in (2, 4):
            stage = tok * 64 * 2 + 64 * 128 * size
            assert 3 <= (mm._mma_smem(tok, size) - 1024) // stage <= 6 and mm._mma_smem(tok, size) <= 232448


def test_mma_probe_patches_the_source_as_it_counts():
    """Each diagnostic and variant of ``tools/masked_matmul_probe.py`` is a
    text found in the tree's source as many times as it lists, and changes
    it; a text the source lacks is refused."""
    probe = _probe()
    for patches in (*probe.DIAGNOSTICS.values(), *probe.VARIANTS.values()):
        assert probe.patch(SOURCE, patches) != SOURCE
    with pytest.raises(RuntimeError, match="times, not"):
        probe.patch(SOURCE, [("no such text", "", 1)])
    assert SOURCE.count(probe.GROUP) == 1


def test_mma_probe_reads_ptxas_and_counts_wgmma_and_tma():
    probe = _probe()
    log = """ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__44436105_16_masked_matmul_cu_a1785ba810mma_kernelIfLb0ELi256EEEv14CUtensorMap_stS1_NS_7MmaArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__44436105_16_masked_matmul_cu_a1785ba810mma_kernelIfLb0ELi256EEEv14CUtensorMap_stS1_NS_7MmaArgsE
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers, 64 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118decode_rows_kernelI13__nv_bfloat16fLi4EEEvPKT_' for 'sm_90a'
ptxas info    : Used 64 registers
"""
    assert probe.ptxas_table(log) == {"fLb0ELi256E": dict(stack=8, spill_stores=4, spill_loads=4, registers=168)}
    sass = """
        Function : _ZN49_GLOBAL__N__44436105_16_masked_matmul_cu_a1785ba810mma_kernelIfLb0ELi256EEEv14CUtensorMap_stS1_NS_7MmaArgsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/              @!P0 UTMALDG.3D [UR8], [UR4] ;
        /*0020*/                   HGMMA.64x256x16.F32.BF16 R24, R152, gdesc[UR4], R24 ;
        /*0030*/                   HGMMA.64x256x16.F32.BF16 R24, R156, gdesc[UR8], R24, gsb0 ;
        /*0040*/                   USETMAXREG.TRY_ALLOC.CTAPOOL 0xe0 ;
        /*0050*/                   STL [R1+0x4], R201 ;
        /*0060*/              @P1 BRA 0x20 ;
        /*0070*/                   LDL R201, [R1+0x4] ;
        /*0080*/                   BRA 0x50 ;
        Function : _ZN12_GLOBAL__N_118decode_rows_kernelI13__nv_bfloat16fLi4EEEvPKT_
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""
    # the STL lies in the loop that branches back to the first HGMMA; the LDL only in one without wgmma
    assert probe.sass_counts(sass) == {"fLb0ELi256E": dict(HGMMA=2, UTMALDG=1, HMMA=0, LDL=1, STL=1,
                                                           local_in_wgmma_loop=1, USETMAXREG=1,
                                                           top_register=201, instructions=9)}
    assert "mma_kernelI" in probe.mma_sass(sass) and "decode_rows_kernel" not in probe.mma_sass(sass)


def test_mma_probe_shapes_are_the_table_rows():
    """The probe's shapes: every layer GEMM of SmolLM (rows 1, 1b), hymba and
    llama3 with its launches a forward, and mixtral's wg and wd."""
    from repro_torch.configs import get_arch

    shapes = _probe().shapes(False)
    rows = {}
    for row, _, lead, m, k, n, uses in shapes:
        rows.setdefault(row, []).append((lead, m, k, n, uses))
    for row, arch in (("1", "smollm-135m"), ("1b", "smollm-135m"), ("hymba 8192", "hymba-1.5b"),
                      ("llama3 512", "llama3-405b")):
        layers = get_arch(arch).gemm_shapes()[:-1]
        assert sum(u for *_, u in rows[row]) == sum(u for *_, u in layers)
        assert {(k, n) for _, _, k, n, _ in rows[row]} == {(k, n) for k, n, _ in layers}
    assert rows["1"][0][:2] == ((), 8192) and rows["1b"][0][:2] == ((8,), 512)
    assert [r[:4] for r in rows["1d"]] == [(("E", 8), 160, 6144, 16384), (("E", 8), 160, 16384, 6144)]
    assert [r[:4] for r in rows["1e"]] == [((2, 8), 160, 6144, 16384), ((2, 8), 160, 16384, 6144)]
