"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the file
imports neither JAX nor the reference package, so it runs where only the port
is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import FRONTEND_DIMS, get_arch, reduce_config
from repro_torch.core import from_fault_map, healthy, random_fault_map
from repro_torch.data.synthetic import TokenStream, make_classification_task
from repro_torch.kernels.common import assert_close, dtype_tol
from repro_torch.kernels.decode_attention.ops import (
    decode_attention,
    decode_attention_ref,
    paged_decode_attention,
    paged_decode_attention_ref,
    quantize_kv,
)
from repro_torch.kernels.flash_attention.ops import attention_ref, flash_attention
from repro_torch.kernels.mamba_scan.ops import (
    BWD_CHUNK, bwd_plan, selective_scan, selective_scan_bwd, selective_scan_bwd_ref, selective_scan_ref,
)
from repro_torch.kernels.masked_matmul.ops import masked_matmul, masked_matmul_checksummed, masked_matmul_ref
from repro_torch.models import model as M
from repro_torch.models.classifier import classifier_forward, classifier_loss, init_classifier
from repro_torch.train.fat_trainer import ClassifierFATTrainer, LMFATTrainer
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.launch.mesh import make_fleet_mesh, make_pop_mesh
from repro_torch.models.classifier import classifier_param_axes
from repro_torch.train.population import PopulationFATEngine, evaluate_metric, make_fat_engine

MM_CASES = [  # (M, K, N, w given as a transposed view)
    (5, 48, 40, False),
    (5, 48, 97, True),  # tied-unembed layout: w = embed.T
    (3, 33, 16, False),
    (4, 576, 576, False),  # decode
    (4, 576, 1000, True),
    (64, 576, 1000, True),  # prefill tile, ragged N
    (100, 1536, 576, False),
    (4, 576, 49152, True),  # the tied unembedding at decode: no K split
    (8, 64, 20000, False),
    (4, 8192, 288, False),  # falcon-mamba x_proj: ragged N
    (512, 1600, 32001, False),  # hymba's unembed at prefill width: ragged N
]
# (B, L, D, N): the serving prefills of falcon-mamba and hymba, hymba's long
# prefill, and a ragged case
SCAN_CASES = [(4, 128, 8192, 16), (4, 128, 3200, 16), (4, 2048, 3200, 16), (2, 37, 11, 4)]
# y and h_last at the reference kernel tests' fp32 tolerance; bf16 y within
# one bf16 step of the same fp32 value
SCAN_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,transposed", MM_CASES)
def test_masked_matmul_kernel_matches_plain_on_card(cuda, dtype, m, k, n, transposed):
    g = torch.Generator(device=cuda).manual_seed(m + n)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    w = torch.randn(n, k, generator=g, device=cuda).to(dtype)
    w = w.T if transposed else w.T.contiguous()
    ok = torch.from_numpy(random_fault_map(n, 256, 256, 0.3).ok_mask).to(cuda)
    before = masked_matmul.launches
    got = masked_matmul(x, w, ok)
    torch.cuda.synchronize()
    assert masked_matmul.launches == before + 1
    assert_close(got, masked_matmul_ref(x, w, ok), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,causal,window,q_offset", [
    (128, 128, True, None, 0), (200, 200, True, 64, 0), (16, 80, True, None, 64),
    (70, 70, False, None, 0),
])
def test_flash_attention_kernel_matches_plain_on_card(cuda, dtype, sq, skv, causal, window, q_offset):
    g = torch.Generator(device=cuda).manual_seed(sq)
    q = torch.randn(2, 9, sq, 64, generator=g, device=cuda).to(dtype)
    k = torch.randn(2, 3, skv, 64, generator=g, device=cuda).to(dtype)
    v = torch.randn(2, 3, skv, 64, generator=g, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    rtol, atol = dtype_tol(dtype)
    torch.testing.assert_close(got.float(), attention_ref(q, k, v, **kw).float(), rtol=rtol, atol=atol)


def test_masked_matmul_split_k_is_deterministic(cuda):
    """The split-K slices are summed in a fixed order: two runs agree bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(4, 1536, generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn(1536, 576, generator=g, device=cuda).to(torch.bfloat16)
    ok = torch.from_numpy(random_fault_map(0, 256, 256, 0.1).ok_mask).to(cuda)
    assert torch.equal(masked_matmul(x, w, ok), masked_matmul(x, w, ok))


# ---------------------------------------------------------------------------
# the bf16 kernels: decode (M <= 16) and mma (M > 16) masked GEMMs, mma flash
# ---------------------------------------------------------------------------

def _gemm_inputs(cuda, m, k, n, transposed, seed=0):
    """bf16 x and the fp32 master w (row-major, or a transposed view as the
    tied unembedding's embed.T), scaled so y has an RMS of about 1."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn(n, k, generator=g, device=cuda) / k ** 0.5
    w = w.T if transposed else w.T.contiguous()
    ok = torch.from_numpy(random_fault_map(seed, 256, 256, 0.3).ok_mask).to(cuda)
    return x, w, ok


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("n", [132, 288, 32001])
@pytest.mark.parametrize("k", [100, 576, 1600])
@pytest.mark.parametrize("m", [1, 4, 15, 16, 17, 512])
def test_bf16_masked_matmul_kernels_match_plain_and_read_fp32_w_in_place(cuda, m, k, n, transposed):
    """The decode and mma kernels against the plain version, with the fp32
    master read in place: bit for bit the launch on the bf16 copy of w."""
    x, w32, ok = _gemm_inputs(cuda, m, k, n, transposed, seed=m + k + n)
    w16 = w32.to(torch.bfloat16)  # keeps embed.T's strides
    assert w16.stride() == w32.stride()
    want = "decode" if m <= 16 else "mma"
    before = dict(masked_matmul.launches_by_variant)
    got32 = masked_matmul(x, w32, ok)
    got16 = masked_matmul(x, w16, ok)
    torch.cuda.synchronize()
    assert masked_matmul.launches_by_variant[want] == before[want] + 2
    assert masked_matmul.launches_by_variant["v1"] == before["v1"]
    assert got32.dtype == torch.bfloat16 and got32.shape == (m, n)
    assert torch.equal(got32, got16)
    assert_close(got32, masked_matmul_ref(x, w32, ok), torch.bfloat16)
    assert torch.equal(masked_matmul_ref(x, w32, ok), masked_matmul_ref(x, w16, ok))


@pytest.mark.parametrize("m", [4, 512])
def test_bf16_masked_matmul_split_k_is_deterministic(cuda, m):
    x, w, ok = _gemm_inputs(cuda, m, 8192, 288, False, seed=2)
    first = masked_matmul(x, w, ok)
    for _ in range(3):
        assert torch.equal(masked_matmul(x, w, ok), first)


def test_masked_matmul_v1_variant_is_reachable_and_agrees(cuda):
    x, w32, ok = _gemm_inputs(cuda, 4, 576, 576, False)
    w16 = w32.to(torch.bfloat16)
    before = masked_matmul.launches_by_variant["v1"]
    got = masked_matmul(x, w16, ok, variant="v1")
    assert masked_matmul.launches_by_variant["v1"] == before + 1
    assert_close(got, masked_matmul(x, w16, ok), torch.bfloat16)
    with pytest.raises(TypeError):
        masked_matmul(x, w32, ok, variant="v1")  # v1 takes x and w of one dtype
    with pytest.raises(TypeError):
        masked_matmul(x.float(), w16, ok)  # float32 x with a bf16 w


@pytest.mark.parametrize("m,k,n,contig", [
    (4, 576, 576, False), (4, 8192, 288, False), (4, 4096, 65024, False), (4, 576, 49152, True),
    (1, 100, 3200, False), (16, 64, 20000, False), (4, 8, 8, False), (4, 4096, 16384, False),
])
def test_decode_plan_fills_one_wave_without_empty_slices(cuda, m, k, n, contig):
    """The decode plan cuts K into whole stages (16 rows, or 128 k of
    embed.T), as many slices as two blocks an SM over one entry's column
    tiles ask for, at most a cluster of 16 (8 beyond 3 column tiles), none empty, no scratch; the same
    slices at every chip count and at M and M + 1."""
    from repro_torch.kernels.masked_matmul.ops import _plan

    splits, part_bytes, tiles_out, rows = _plan("decode", m, n, k, contig, 132)
    assert rows == m and part_bytes == 0
    tiles = -(-n // (32 if contig else 256))
    assert tiles_out == tiles
    stages = -(-k // (128 if contig else 16))
    per = -(-stages // splits)
    assert 1 <= splits <= min(16, stages) and (splits - 1) * per < stages
    # within one wave of two blocks per SM for one entry, and not far below either
    assert splits == 1 or tiles * splits <= 2 * 132
    assert splits <= (16 if tiles <= 3 else 8) and splits >= min(16 if tiles <= 3 else 8, 2 * 132 // tiles, stages) // 2
    for chips in (2, 8, 16):
        assert _plan("decode", m, n, k, contig, 132, chips) == (splits, 0, chips * tiles, m)
    if m < 16:
        assert _plan("decode", m + 1, n, k, contig, 132)[0] == splits


@pytest.mark.parametrize("m,k,n", [(512, 576, 192), (8192, 576, 576), (512, 8192, 16384), (17, 100, 132),
                                   (8192, 5504, 1600), (1024, 576, 49152), (512, 1536, 576)])
def test_mma_plan_keeps_four_k_tiles_per_slice(cuda, m, k, n):
    """A slice keeps at least 128 rows of K (four k tiles of 32; two of the
    kernel's 64), and K is cut only where the tiles fill at most an eighth
    of the card's SMs, never past one round of the persistent blocks."""
    from repro_torch.kernels.masked_matmul.ops import _mma_tokens, _plan

    splits, part_bytes, tiles_out, tokens = _plan("mma", m, n, k, False, 132)
    assert tokens == _mma_tokens(m, n, 132) and tiles_out == -(-m // tokens) * -(-n // 128)
    tiles_k = -(-k // 64)
    per = -(-tiles_k // splits)
    assert 1 <= splits and (splits - 1) * per < tiles_k
    assert splits == 1 or (per * 64 >= 128 and tiles_out * splits <= 132 and 8 * tiles_out <= 132)
    assert part_bytes == (0 if splits == 1 else 4 * splits * m * n)
    if 8 * tiles_out <= 132 and tiles_k >= 4:
        assert splits > 1


# the mma kernel (wgmma, TMA) at its edges: token tiles of 128 and 256 (257: three 128-row tiles, the
# last ragged), K not a multiple of its 64-deep k tiles, N not a multiple of its 64-column warpgroups, a
# mask of 8 x 8 and of 256 x 256, row-major w and embed.T; N = 70 also takes w by the producer's
# copies (its rows are 280 bytes apart in fp32, 140 in bf16: not a multiple of 16), K = 100 x
MMA_EDGES = [(100, 132), (200, 200), (576, 70)]


@pytest.mark.parametrize("mask", [(8, 8), (256, 256)])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("k,n", MMA_EDGES)
@pytest.mark.parametrize("m", [17, 24, 160, 257])
def test_mma_edge_shapes_match_plain_and_repeat_their_bits(cuda, m, k, n, transposed, mask):
    """The mma kernel against the plain version at its edges; the fp32-w
    launch gives the bf16-w launch's bits, and a second launch the first's."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    w32 = torch.randn(n, k, generator=g, device=cuda) / k ** 0.5
    w32 = w32.T if transposed else w32.T.contiguous()
    w16 = w32.to(torch.bfloat16)
    ok = torch.from_numpy(random_fault_map(m, *mask, 0.3).ok_mask).to(cuda)
    before = masked_matmul.launches_by_variant["mma"]
    got32 = masked_matmul(x, w32, ok)
    loads = masked_matmul.last_loads
    got16 = masked_matmul(x, w16, ok)
    again = masked_matmul(x, w32, ok)
    torch.cuda.synchronize()
    assert masked_matmul.launches_by_variant["mma"] == before + 3
    assert loads[0] == ("copy" if k % 8 else "tma")
    assert torch.equal(got32, got16) and torch.equal(got32, again)
    assert_close(got32, masked_matmul_ref(x, w32, ok), torch.bfloat16)


@pytest.mark.parametrize("m", [24, 160, 257])
def test_mma_chip_stack_experts_and_mask_group_match_plain(cuda, m):
    """A chip stack with one w for every chip (chip stride 0), 4 experts
    under one mask, and 2 chips x 3 experts (a mask group), at a ragged
    shape, against the plain version, fp32-w bits equal to bf16-w bits."""
    k, n = 200, 132
    g = torch.Generator(device=cuda).manual_seed(m)
    maps = [torch.from_numpy(random_fault_map(c, 8, 8, 0.3).ok_mask).to(cuda) for c in range(3)]
    shared = torch.randn(k, n, generator=g, device=cuda).expand(3, k, n)
    experts = torch.randn(4, k, n, generator=g, device=cuda)
    both = torch.randn(2, 3, k, n, generator=g, device=cuda)
    cases = [
        (torch.randn(3, m, k, generator=g, device=cuda).to(torch.bfloat16), shared, torch.stack(maps)),
        (torch.randn(4, m, k, generator=g, device=cuda).to(torch.bfloat16), experts, maps[0]),
        (torch.randn(2, 3, m, k, generator=g, device=cuda).to(torch.bfloat16), both, torch.stack(maps[:2])),
    ]
    for x, w32, ok in cases:
        got32 = masked_matmul(x, w32, ok)
        assert masked_matmul.last_loads == ("tma", "tma")
        got16 = masked_matmul(x, w32.to(torch.bfloat16), ok)  # rows of 264 bytes: w by copies
        torch.cuda.synchronize()
        assert masked_matmul.last_loads == ("tma", "copy")
        assert torch.equal(got32, got16)
        assert_close(got32, masked_matmul_ref(x, w32, ok), torch.bfloat16)


@pytest.mark.parametrize("m", [40, 257])
def test_mma_takes_an_operand_tma_refuses_by_the_producers_copies(cuda, m):
    """x or w at an address TMA refuses (not 16-byte aligned) goes through
    the same kernel, loaded by its producer warpgroup's own copies: named
    in ``last_loads``, counted in ``copy_launches``, and the same bits as
    the aligned operands' launch by TMA."""
    k, n = 576, 300
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn(k, n, generator=g, device=cuda)
    ok = torch.from_numpy(random_fault_map(1, 256, 256, 0.3).ok_mask).to(cuda)
    want = masked_matmul(x, w, ok)
    assert masked_matmul.last_loads == ("tma", "tma")
    xbuf = torch.empty(m * k + 1, dtype=torch.bfloat16, device=cuda)
    x_off = xbuf[1:].view(m, k)
    x_off.copy_(x)
    wbuf = torch.empty(k, n + 1, device=cuda)
    w_off = wbuf[:, 1:]
    w_off.copy_(w)
    for xi, wi, loads in ((x_off, w, ("copy", "tma")), (x, w_off, ("tma", "copy")), (x_off, w_off, ("copy", "copy"))):
        copies = masked_matmul.copy_launches
        got = masked_matmul(xi, wi, ok)
        torch.cuda.synchronize()
        assert masked_matmul.last_loads == loads
        assert masked_matmul.copy_launches == copies + 1
        assert torch.equal(got, want), loads


@pytest.mark.parametrize("chips,m,n", [(8, 512, 576), (3, 257, 300), (4, 64, 1600)])
def test_mma_chip_batched_rows_have_each_chips_own_launch_bits(cuda, chips, m, n):
    """The mma plan cuts K as one entry's launch would, whatever the chip
    count, and the token tile (256 rows for 8 chips at M = 512, 128 for one)
    changes no bit: each chip's rows of a chip-batched launch are the bits
    of that chip's own launch, at the plans' own counts."""
    x, w, ok = _fleet_inputs(cuda, chips, m, 576, n, False, torch.bfloat16, torch.float32, seed=m)
    got = masked_matmul(x, w, ok)
    for c in range(chips):
        assert torch.equal(got[c], masked_matmul(x[c], w[c], ok[c])), c


# the bf16 decode kernel (bulk-copy ring, K split over a cluster) at its edges: M 1-16 over its three
# instances, K below one stage (8) and not a multiple of one (100), N ragged (70, 132, 300: not a
# multiple of the 256-column tile; 70 fp32 and 132 bf16 rows start off 16 bytes), masks that divide
# no tile (12 x 20), row-major w and embed.T
DECODE_EDGES = [(8, 8), (100, 132), (576, 70), (576, 300)]


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("k,n", DECODE_EDGES)
@pytest.mark.parametrize("m", [1, 4, 5, 8, 9, 16])
def test_decode_edge_shapes_match_plain_and_repeat_their_bits(cuda, m, k, n, transposed):
    """The decode kernel against the plain version at its edges; the fp32-w
    launch gives the bf16-w launch's bits, and a second launch the first's."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    w32 = torch.randn(n, k, generator=g, device=cuda) / k ** 0.5
    w32 = w32.T if transposed else w32.T.contiguous()
    w16 = w32.to(torch.bfloat16)
    ok = torch.from_numpy(random_fault_map(m, 12, 20, 0.3).ok_mask).to(cuda)
    before = masked_matmul.launches_by_variant["decode"]
    got32 = masked_matmul(x, w32, ok)
    got16 = masked_matmul(x, w16, ok)
    again = masked_matmul(x, w32, ok)
    torch.cuda.synchronize()
    assert masked_matmul.launches_by_variant["decode"] == before + 3
    assert torch.equal(got32, got16) and torch.equal(got32, again)
    assert_close(got32, masked_matmul_ref(x, w32, ok), torch.bfloat16)


@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("chips", [2, 4, 8])
def test_decode_chip_batched_rows_have_each_chips_own_launch_bits(cuda, chips, m):
    """The decode plan's slices depend on one entry's shape alone, so each
    chip's rows of a chip-batched launch are the bits of that chip's own
    launch: row-major w (SmolLM's 576 x 1536, a plan of several slices) and
    the tied unembedding's embed.T, and a weight shared by every chip."""
    for k, n, transposed in ((576, 1536, False), (1536, 576, False), (576, 3000, True)):
        x, w, ok = _fleet_inputs(cuda, chips, m, k, n, transposed, torch.bfloat16, torch.float32, seed=chips + m)
        got = masked_matmul(x, w, ok)
        torch.cuda.synchronize()
        for c in range(chips):
            assert torch.equal(got[c], masked_matmul(x[c], w[c], ok[c])), (k, n, c)
        shared = w[0].expand(chips, *w.shape[1:])
        got = masked_matmul(x, shared, ok)
        for c in range(chips):
            assert torch.equal(got[c], masked_matmul(x[c], w[0], ok[c])), (k, n, c, "shared")


@pytest.mark.parametrize("m", [4, 8])
def test_decode_experts_and_chips_x_experts_have_each_entrys_own_launch_bits(cuda, m):
    """Experts under one mask and 2 chips x 4 experts (a mask group): each
    entry's rows equal the launch of that expert alone under its mask."""
    k, n = 300, 700
    g = torch.Generator(device=cuda).manual_seed(m)
    maps = [torch.from_numpy(random_fault_map(c, 256, 256, 0.3).ok_mask).to(cuda) for c in range(2)]
    experts = torch.randn(4, k, n, generator=g, device=cuda) / k ** 0.5
    x = torch.randn(4, m, k, generator=g, device=cuda).to(torch.bfloat16)
    got = masked_matmul(x, experts, maps[0])
    assert_close(got, masked_matmul_ref(x, experts, maps[0]), torch.bfloat16)
    for e in range(4):
        assert torch.equal(got[e], masked_matmul(x[e], experts[e], maps[0])), e
    both = torch.randn(2, 4, k, n, generator=g, device=cuda) / k ** 0.5
    xb = torch.randn(2, 4, m, k, generator=g, device=cuda).to(torch.bfloat16)
    ok = torch.stack(maps)
    got = masked_matmul(xb, both, ok)
    assert_close(got, masked_matmul_ref(xb, both, ok), torch.bfloat16)
    for c in range(2):
        for e in range(4):
            assert torch.equal(got[c, e], masked_matmul(xb[c, e], both[c, e], maps[c])), (c, e)


@pytest.mark.parametrize("m", [1, 4, 8])
def test_decode_load_routes_are_named_and_bit_equal(cuda, m):
    """w and x that TMA takes go by one box a stage each ("tma"); w whose
    rows start off 16 bytes (a view one element in; hymba-1.5b's untied
    head, 1600 x 32001 fp32, rows 128,004 bytes apart) by 1-D bulk copies
    from the 16-byte boundary below, read at each run's offset ("offset",
    counted in ``offset_launches``); x off 16 bytes by the producer warp's
    own loads ("copy"). Each route is named in ``last_loads`` and gives the
    bits of the same operands on TMA."""
    g = torch.Generator(device=cuda).manual_seed(m)
    ok = torch.from_numpy(random_fault_map(1, 256, 256, 0.1).ok_mask).to(cuda)
    for k, n in ((576, 300), (1600, 32001)):
        x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
        pad = torch.randn(k, -(-n // 4) * 4, generator=g, device=cuda) / k ** 0.5  # rows 16-byte multiples apart
        w_tma = pad[:, :n] if n % 4 else pad[:, :n].contiguous()
        wbuf = torch.empty(k * n + 1, device=cuda)
        w_off = wbuf[1:].view(k, n)  # every row starts 4 bytes (or more) off 16
        w_off.copy_(w_tma)
        xbuf = torch.empty(m * k + 1, dtype=torch.bfloat16, device=cuda)
        x_off = xbuf[1:].view(m, k)
        x_off.copy_(x)
        want = masked_matmul(x, w_tma, ok)
        assert masked_matmul.last_loads == ("tma", "tma")
        offsets = masked_matmul.offset_launches
        for xi, wi, loads in ((x, w_off, ("tma", "offset")), (x_off, w_tma, ("copy", "tma")),
                              (x_off, w_off, ("copy", "offset")), (x, w_off.to(torch.bfloat16), ("tma", "offset"))):
            got = masked_matmul(xi, wi, ok)
            torch.cuda.synchronize()
            assert masked_matmul.last_loads == loads, (k, n, loads)
            assert torch.equal(got, want), (k, n, loads)
        assert masked_matmul.offset_launches == offsets + 3
        assert_close(want, masked_matmul_ref(x, w_off, ok), torch.bfloat16)


def test_a_decode_launch_allocates_no_scratch_and_takes_no_counters(cuda):
    """A decode launch sums its K slices in its cluster's shared memory: it
    allocates y alone, and takes no split-K counter buffer, also on a stream
    that has never launched before."""
    from repro_torch.kernels import common
    from repro_torch.kernels.masked_matmul.ops import gemm_plan, sm_count

    x, w, ok = _gemm_inputs(cuda, 4, 1536, 576, False, seed=5)
    assert gemm_plan("decode", 4, 576, 1536, sm_count(cuda)).splits > 1
    masked_matmul(x, w, ok)  # the mask packed, the library loaded
    stream = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(stream):
        before = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
        y = masked_matmul(x, w, ok)
        after = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
    torch.cuda.synchronize()
    assert after - before == 1 and masked_matmul.last_splits > 1
    assert (cuda.index or 0, stream.cuda_stream) not in common._COUNTERS
    assert torch.equal(y, masked_matmul(x, w, ok))


def test_the_plan_refuses_what_no_bf16_kernel_runs(cuda):
    from repro_torch.kernels.masked_matmul.ops import _c_plan, _plan

    for args in (("decode", 17, 288, 576), ("v1", 4, 288, 576), ("mma", 512, 0, 576)):
        with pytest.raises(ValueError):
            _plan(*args, False, 132)
        with pytest.raises(RuntimeError):
            _c_plan(*args, False, 132)


@pytest.mark.parametrize("kind", ["decode", "mma"])
def test_the_python_plan_is_the_c_sources(cuda, kind):
    """``_plan``, which the wrapper launches and the geometry lint reads,
    against ``masked_matmul_plan`` in the C source, over the serving shapes
    and a sweep of ragged ones, with a chip axis and both w layouts."""
    from repro_torch.kernels.masked_matmul.ops import _c_plan, _plan

    ms = (1, 4, 16) if kind == "decode" else (17, 100, 512, 1024, 8192)
    for m in ms:
        for k, n in ((576, 576), (576, 192), (576, 1536), (1536, 576), (4096, 16384), (8192, 4096),
                     (100, 3200), (64, 20000), (5504, 1600), (576, 49152), (33, 7)):
            for contig in (False, True):
                for chips in (1, 3, 8):
                    for sms in (132, 114):
                        args = (kind, m, n, k, contig, sms, chips)
                        assert _plan(*args) == _c_plan(*args), args


@pytest.mark.parametrize("m", [4, 512])
def test_split_k_launches_on_two_streams_at_once_agree(cuda, m):
    """Each stream has its own split-K counters, so launches that overlap on
    two streams give the bits of launches one at a time."""
    from repro_torch.kernels.common import split_counters

    x, w, ok = _gemm_inputs(cuda, m, 8192, 288, False, seed=4)
    want = masked_matmul(x, w, ok)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(8):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(masked_matmul(x, w, ok))
    torch.cuda.synchronize()
    for got in outs[0] + outs[1]:
        assert torch.equal(got, want)
    bufs = [split_counters(cuda, st.cuda_stream, 1) for st in streams]
    assert bufs[0].data_ptr() != bufs[1].data_ptr()
    assert not bufs[0].any() and not bufs[1].any()


def test_packed_mask_is_cached_and_repacked_after_an_in_place_change(cuda):
    from repro_torch.kernels.masked_matmul.ops import packed_mask

    ok = torch.from_numpy(random_fault_map(3, 256, 256, 0.1).ok_mask).to(cuda)
    bits, bits_t = packed_mask(ok)
    assert packed_mask(ok)[0] is bits
    ok[0, 0] = 1.0 - ok[0, 0]
    again, _ = packed_mask(ok)
    assert again is not bits and int(again[0, 0] ^ bits[0, 0]) == 1


# ---------------------------------------------------------------------------
# the float32 kernels (v1): the streaming decode template at M <= 16, the
# register-tiled SIMT kernel above it; flash v1
# ---------------------------------------------------------------------------

F32_TOL = dtype_tol(torch.float32)


def _f32_gemm(cuda, m, k, n, transposed, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=cuda)
    w = torch.randn(n, k, generator=g, device=cuda) / k ** 0.5
    w = w.T if transposed else w.T.contiguous()
    ok = torch.from_numpy(random_fault_map(seed, 256, 256, 0.3).ok_mask).to(cuda)
    return x, w, ok


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("n", [130, 576])
@pytest.mark.parametrize("k", [100, 1536])
@pytest.mark.parametrize("m", [1, 5, 9, 17, 65, 300])
def test_f32_masked_matmul_matches_plain_and_repeats_its_bits(cuda, m, k, n, transposed):
    """v1 at ragged M, N and K, both w layouts (embed.T read in place): one
    counted v1 launch a call, the plain version at dtype_tol(float32), and a
    second launch gives the same bits."""
    x, w, ok = _f32_gemm(cuda, m, k, n, transposed, seed=m + k + n)
    before = dict(masked_matmul.launches_by_variant)
    got = masked_matmul(x, w, ok)
    again = masked_matmul(x, w, ok)
    torch.cuda.synchronize()
    assert masked_matmul.launches_by_variant == {**before, "v1": before["v1"] + 2}
    assert torch.equal(got, again)
    rtol, atol = F32_TOL
    torch.testing.assert_close(got, masked_matmul_ref(x, w, ok), rtol=rtol, atol=atol)


@pytest.mark.parametrize("m,k,n", [(8192, 576, 576), (8192, 576, 192), (512, 1536, 576), (4, 8192, 288),
                                   (1024, 576, 49152)])
def test_f32_split_launches_reuse_the_zeroed_counters(cuda, m, k, n):
    """A split v1 launch (K cut for every tile below one wave, for the last
    wave's tiles from one wave on) takes the stream's shared counter buffer,
    which it leaves zeroed: no memset a launch, no buffer of its own."""
    from repro_torch.kernels.common import split_counters
    from repro_torch.kernels.masked_matmul.ops import _split_plan, sm_count

    x, w, ok = _f32_gemm(cuda, m, k, n, n == 49152, seed=7)
    plan = _split_plan(m, n, k, sm_count(cuda), 1, n == 49152)
    assert plan.splits > 1
    stream = torch.cuda.current_stream().cuda_stream
    buf = split_counters(cuda, stream, plan.tiles)
    got = [masked_matmul(x, w, ok) for _ in range(3)]
    torch.cuda.synchronize()
    assert split_counters(cuda, stream, plan.tiles).data_ptr() == buf.data_ptr()
    assert not buf.any()
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[2])
    rtol, atol = F32_TOL
    torch.testing.assert_close(got[0], masked_matmul_ref(x, w, ok), rtol=rtol, atol=atol)


@pytest.mark.parametrize("m", [4, 9, 300])
def test_f32_masked_matmul_takes_unaligned_views(cuda, m):
    """x at a 4-byte offset, w with strides that are not multiples of 4 (both
    layouts) and a chip stack whose chips start at odd offsets: plain loads
    inside the kernels, the same results."""
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(m * 301 + 1, generator=g, device=cuda)[1:].view(m, 301)
    ok = torch.from_numpy(random_fault_map(1, 256, 256, 0.2).ok_mask).to(cuda)
    rows = torch.randn(301, 131, generator=g, device=cuda)[:, 1:]  # row stride 131
    cols = torch.randn(130, 303, generator=g, device=cuda)[:, 2:].T  # embed.T, column stride 303
    for w in (rows, cols):
        assert w.data_ptr() % 16
        got = masked_matmul(x, w, ok)
        rtol, atol = F32_TOL
        torch.testing.assert_close(got, masked_matmul_ref(x, w, ok), rtol=rtol, atol=atol)
    xs = torch.randn(3 * m * 301 + 1, generator=g, device=cuda)[1:].view(3, m, 301)
    ws = torch.randn(3 * 301 * 130 + 3, generator=g, device=cuda)[3:].view(3, 301, 130)
    oks = torch.stack([ok, ok.flip(0), ok.flip(1)]).contiguous()
    got = masked_matmul(xs, ws, oks)
    torch.testing.assert_close(got, masked_matmul_ref(xs, ws, oks), rtol=F32_TOL[0], atol=F32_TOL[1])


@pytest.mark.parametrize("m", [65, 512])
@pytest.mark.parametrize("transposed", [False, True])
def test_v1_variant_on_bf16_runs_the_tiled_template(cuda, m, transposed):
    """``variant="v1"`` with bf16 x and w above M = 16: the tiled kernel's
    bf16 instance, one counted v1 launch, within bf16's tolerance of the
    plain version and of the mma kernel."""
    x, w32, ok = _gemm_inputs(cuda, m, 576, 1000, transposed, seed=m)
    w16 = w32.to(torch.bfloat16)
    before = dict(masked_matmul.launches_by_variant)
    got = masked_matmul(x, w16, ok, variant="v1")
    torch.cuda.synchronize()
    assert masked_matmul.launches_by_variant == {**before, "v1": before["v1"] + 1}
    assert_close(got, masked_matmul_ref(x, w16, ok), torch.bfloat16)
    assert_close(got, masked_matmul(x, w16, ok), torch.bfloat16)


@pytest.mark.parametrize("d", [64, 80, 96, 128])
@pytest.mark.parametrize("hq,hkv,sq,skv,causal,window,q_offset", [
    (9, 3, 130, 130, True, None, 0), (25, 5, 300, 300, True, 64, 0), (9, 3, 70, 200, True, 37, 130),
    (4, 4, 65, 65, False, None, 0), (9, 3, 1, 1000, True, None, 999), (8, 2, 200, 1100, True, 1024, 900),
])
def test_f32_flash_kernel_matches_plain_and_repeats_its_bits(cuda, d, hq, hkv, sq, skv, causal, window, q_offset):
    """Flash v1 at every built head dim and mask case, GQA, ragged Sq and
    Skv, on the (B, S, H, D) projections' layout: the plain version at
    dtype_tol(float32), the same bits on a second launch."""
    g = torch.Generator(device=cuda).manual_seed(d + sq + skv)
    q = torch.randn(2, sq, hq, d, generator=g, device=cuda).transpose(1, 2)
    k = torch.randn(2, skv, hkv, d, generator=g, device=cuda).transpose(1, 2)
    v = torch.randn(2, skv, hkv, d, generator=g, device=cuda).transpose(1, 2)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = dict(flash_attention.launches_by_variant)
    got = flash_attention(q, k, v, **kw)
    again = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_variant == {**before, "v1": before["v1"] + 2}
    assert torch.equal(got, again)
    torch.testing.assert_close(got, attention_ref(q, k, v, **kw), rtol=F32_TOL[0], atol=F32_TOL[1])


@pytest.mark.parametrize("d", [64, 128])
def test_f32_flash_kernel_takes_unaligned_views(cuda, d):
    """q, k and v at 4-byte offsets with row strides that are not multiples
    of 4 floats: plain loads inside the kernel, the same result."""
    g = torch.Generator(device=cuda).manual_seed(d)
    base = torch.randn(2, 130, 3 * d + 1, generator=g, device=cuda)
    t = base[:, 1:, 1:].unflatten(-1, (3, d)).transpose(1, 2)  # (2, 3, 129, d), row stride 3d + 1
    assert t.data_ptr() % 16 and t.stride(2) % 4
    got = flash_attention(t, t, t)
    torch.testing.assert_close(got, attention_ref(t, t, t), rtol=F32_TOL[0], atol=F32_TOL[1])
    got = flash_attention(t, t[:, :, :40], t[:, :, :40], causal=False, window=4, q_offset=100)
    assert not got.abs().any()


# ---------------------------------------------------------------------------
# the masked GEMM with a chip axis: one launch for a fleet of chips
# ---------------------------------------------------------------------------

FLEET_KINDS = [  # (x dtype, w dtype, variant)
    (torch.float32, torch.float32, "auto"),
    (torch.bfloat16, torch.float32, "auto"),
    (torch.bfloat16, torch.bfloat16, "auto"),
    (torch.bfloat16, torch.bfloat16, "v1"),
]


def _fleet_inputs(cuda, chips, m, k, n, transposed, x_dtype, w_dtype, seed=0):
    """Per-chip x, fp32 or bf16 w (row-major, or each chip's a transposed
    view as the tied unembedding's embed.T) and 0/1 masks, chip 0 healthy."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(chips, m, k, generator=g, device=cuda).to(x_dtype)
    w = (torch.randn(chips, n, k, generator=g, device=cuda) / k ** 0.5).to(w_dtype)
    w = w.transpose(1, 2) if transposed else w.transpose(1, 2).contiguous()
    ok = torch.stack([
        torch.from_numpy(random_fault_map(seed + c, 256, 256, 0.1 * c).ok_mask) for c in range(chips)
    ]).to(cuda)
    return x, w, ok


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 257])
@pytest.mark.parametrize("chips", [1, 3, 8])
@pytest.mark.parametrize("x_dtype,w_dtype,variant", FLEET_KINDS)
def test_chip_batched_masked_matmul_matches_plain_in_one_launch(
    cuda, x_dtype, w_dtype, variant, chips, m, transposed
):
    """Every variant with a chip axis: one counted launch, each chip's rows
    against the plain version's under that chip's own weights and mask."""
    from repro_torch.kernels.masked_matmul.ops import pick_variant

    x, w, ok = _fleet_inputs(cuda, chips, m, 576, 288, transposed, x_dtype, w_dtype, seed=chips + m)
    kind = pick_variant(x_dtype, m, variant)
    before = dict(masked_matmul.launches_by_variant)
    fleet_before = dict(masked_matmul.fleet_launches_by_variant)
    launches = masked_matmul.launches
    got = masked_matmul(x, w, ok, variant=variant)
    torch.cuda.synchronize()
    assert masked_matmul.launches == launches + 1
    assert masked_matmul.launches_by_variant[kind] == before[kind] + 1
    assert masked_matmul.fleet_launches_by_variant[kind] == fleet_before[kind] + 1
    assert got.shape == (chips, m, 288) and got.dtype == x_dtype
    assert_close(got, masked_matmul_ref(x, w, ok), x_dtype)
    for c in range(chips):
        assert_close(got[c], masked_matmul_ref(x[c], w[c], ok[c]), x_dtype)


@pytest.mark.parametrize("m", [4, 64])
def test_chip_batched_masked_matmul_reads_a_shared_weight_with_chip_stride_zero(cuda, m):
    x, w, ok = _fleet_inputs(cuda, 3, m, 576, 288, False, torch.bfloat16, torch.float32)
    shared = w[0].expand(3, *w[0].shape)
    assert shared.stride(0) == 0
    got = masked_matmul(x, shared, ok)
    assert_close(got, masked_matmul_ref(x, w[0].expand(3, *w[0].shape).contiguous(), ok), torch.bfloat16)


def test_chip_batched_masked_matmul_is_one_launch_under_vmap(cuda):
    x, w, ok = _fleet_inputs(cuda, 8, 4, 576, 1536, False, torch.bfloat16, torch.float32)
    launches = masked_matmul.launches
    got = torch.func.vmap(masked_matmul)(x, w, ok)
    torch.cuda.synchronize()
    assert masked_matmul.launches == launches + 1
    assert_close(got, masked_matmul_ref(x, w, ok), torch.bfloat16)


@pytest.mark.parametrize("x_dtype,w_dtype,variant", FLEET_KINDS)
def test_in_place_change_of_one_chip_is_seen_by_the_next_launch(cuda, x_dtype, w_dtype, variant):
    """``set_silicon`` copies a chip's new map into the stacked mask in
    place: the next launch computes through it, and only that chip's bits
    are packed again."""
    from repro_torch.kernels.masked_matmul.ops import packed_mask

    x, w, ok = _fleet_inputs(cuda, 4, 4, 576, 288, False, x_dtype, w_dtype, seed=5)
    first = masked_matmul(x, w, ok, variant=variant)
    packed = packed_mask.chips_packed
    ok[2].copy_(torch.from_numpy(random_fault_map(99, 256, 256, 0.3).ok_mask).to(cuda))
    got = masked_matmul(x, w, ok, variant=variant)
    torch.cuda.synchronize()
    assert_close(got, masked_matmul_ref(x, w, ok), x_dtype)
    assert not torch.equal(got[2], first[2])
    for c in (0, 1, 3):
        assert torch.equal(got[c], first[c])
    if x_dtype == torch.bfloat16 and variant == "auto":
        assert packed_mask.chips_packed == packed + 1


# ---------------------------------------------------------------------------
# the masked GEMM with an expert axis: an MoE layer's experts under one mask
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("m", [1, 8, 160, 257])
@pytest.mark.parametrize("experts", [1, 8, 128])
@pytest.mark.parametrize("x_dtype,w_dtype,variant", FLEET_KINDS)
def test_expert_batched_masked_matmul_shares_one_mask_in_one_launch(
    cuda, x_dtype, w_dtype, variant, experts, m, transposed
):
    """w (E, K, N) with ONE (R, C) mask: one counted launch (an expert
    launch, not a fleet one), the mask packed once (``chips_packed`` grows
    by 1, not E), every expert held to the plain version under that mask,
    and a second launch giving the same bits without packing again."""
    from repro_torch.kernels.masked_matmul.ops import packed_mask, pick_variant

    g = torch.Generator(device=cuda).manual_seed(experts + m)
    x = torch.randn(experts, m, 576, generator=g, device=cuda).to(x_dtype)
    w = (torch.randn(experts, 288, 576, generator=g, device=cuda) / 24).to(w_dtype).transpose(1, 2)
    w = w if transposed else w.contiguous()
    ok = torch.from_numpy(random_fault_map(experts + m, 256, 256, 0.1).ok_mask).to(cuda)
    kind = pick_variant(x_dtype, m, variant)
    before = dict(masked_matmul.launches_by_variant)
    expert_before = dict(masked_matmul.expert_launches_by_variant)
    fleet_before = dict(masked_matmul.fleet_launches_by_variant)
    launches, packed = masked_matmul.launches, packed_mask.chips_packed
    got = masked_matmul(x, w, ok, variant=variant)
    torch.cuda.synchronize()
    assert masked_matmul.launches == launches + 1
    assert masked_matmul.launches_by_variant[kind] == before[kind] + 1
    assert masked_matmul.expert_launches_by_variant[kind] == expert_before[kind] + 1
    assert masked_matmul.fleet_launches_by_variant == fleet_before
    assert packed_mask.chips_packed == packed + 1
    assert got.shape == (experts, m, 288) and got.dtype == x_dtype
    assert_close(got, masked_matmul_ref(x, w, ok), x_dtype)
    for e in (0, experts // 2, experts - 1):
        assert_close(got[e], masked_matmul_ref(x[e], w[e], ok), x_dtype)
    again = masked_matmul(x, w, ok, variant=variant)
    torch.cuda.synchronize()
    assert torch.equal(again, got) and packed_mask.chips_packed == packed + 1


def test_expert_batched_masked_matmul_is_fault_einsum_kernel_mode(cuda):
    """``fault_einsum`` in kernel mode: both expert specs are one launch of
    the kernel on the fp32 master, against the plain ``fap`` einsum."""
    from repro_torch.core import fault_einsum

    g = torch.Generator(device=cuda).manual_seed(3)
    fm = random_fault_map(3, 256, 256, 0.1)
    kctx, fctx = from_fault_map(fm, "kernel", device=cuda), from_fault_map(fm, "fap", device=cuda)
    h = torch.randn(8, 40, 576, generator=g, device=cuda).bfloat16()
    w1 = torch.randn(8, 576, 1536, generator=g, device=cuda) / 24
    w2 = torch.randn(8, 1536, 576, generator=g, device=cuda) / 40
    launches = masked_matmul.launches
    z = fault_einsum("ecd,edf->ecf", h, w1, kctx)
    y = fault_einsum("ecf,efd->ecd", z, w2, kctx)
    torch.cuda.synchronize()
    assert masked_matmul.launches == launches + 2
    assert_close(z, fault_einsum("ecd,edf->ecf", h, w1, fctx), torch.bfloat16)
    assert_close(y, fault_einsum("ecf,efd->ecd", z, w2, fctx), torch.bfloat16)


# ---------------------------------------------------------------------------
# the masked GEMM with both axes: a fleet's chips x an MoE layer's experts
# ---------------------------------------------------------------------------


def _chips_x_experts(cuda, chips, experts, m, transposed, x_dtype, w_dtype, seed=0):
    """x (chips, E, M, 576), w (chips, E, 576, 288) a stack of per-chip
    expert weights (each expert a transposed view where ``transposed``) and
    one 0/1 mask a chip, chip 0 healthy."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(chips, experts, m, 576, generator=g, device=cuda).to(x_dtype)
    w = (torch.randn(chips, experts, 288, 576, generator=g, device=cuda) / 24).to(w_dtype).transpose(-1, -2)
    w = w if transposed else w.contiguous()
    ok = torch.stack([
        torch.from_numpy(random_fault_map(seed + c, 256, 256, 0.1 * c).ok_mask) for c in range(chips)
    ]).to(cuda)
    return x, w, ok


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("m", [1, 8, 160])
@pytest.mark.parametrize("chips,experts", [(1, 8), (2, 8), (3, 2)])
@pytest.mark.parametrize("x_dtype,w_dtype,variant", FLEET_KINDS)
def test_chips_x_experts_masked_matmul_reads_each_chips_mask_in_one_launch(
    cuda, x_dtype, w_dtype, variant, chips, experts, m, transposed
):
    """w (chips, E, K, N) and one mask a chip: one counted chips x experts
    launch (neither a fleet nor an expert launch), each chip's mask packed
    once (``chips_packed`` grows by the chips, not chips x E), every
    (chip, expert) held to the plain version under its chip's mask."""
    from repro_torch.kernels.masked_matmul.ops import packed_mask, pick_variant

    x, w, ok = _chips_x_experts(cuda, chips, experts, m, transposed, x_dtype, w_dtype, seed=chips + m)
    kind = pick_variant(x_dtype, m, variant)
    before = dict(masked_matmul.launches_by_variant)
    both_before = dict(masked_matmul.fleet_expert_launches_by_variant)
    fleet_before = dict(masked_matmul.fleet_launches_by_variant)
    expert_before = dict(masked_matmul.expert_launches_by_variant)
    launches, packed = masked_matmul.launches, packed_mask.chips_packed
    got = masked_matmul(x, w, ok, variant=variant)
    torch.cuda.synchronize()
    assert masked_matmul.launches == launches + 1
    assert masked_matmul.launches_by_variant[kind] == before[kind] + 1
    assert masked_matmul.fleet_expert_launches_by_variant[kind] == both_before[kind] + 1
    assert masked_matmul.fleet_launches_by_variant == fleet_before
    assert masked_matmul.expert_launches_by_variant == expert_before
    assert packed_mask.chips_packed == packed + chips
    assert got.shape == (chips, experts, m, 288) and got.dtype == x_dtype
    assert_close(got, masked_matmul_ref(x, w, ok), x_dtype)
    for c in range(chips):
        for e in (0, experts - 1):
            assert_close(got[c, e], masked_matmul_ref(x[c, e], w[c, e], ok[c]), x_dtype)


@pytest.mark.parametrize("m", [4, 8, 160])
@pytest.mark.parametrize("x_dtype,w_dtype,variant", FLEET_KINDS)
def test_chips_x_experts_launch_gives_each_chips_expert_launch_bits(cuda, x_dtype, w_dtype, variant, m):
    """Each chip's rows of the chips x experts launch against that chip's own
    expert launch (w (E, K, N), its one mask) at the same K slices: the same
    bits, forced to one slice and to the expert launch's plan; with the
    plans' own counts where the two plans agree."""
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.masked_matmul.ops import gemm_plan, pick_variant

    chips, experts = 3, 8
    x, w, ok = _chips_x_experts(cuda, chips, experts, m, False, x_dtype, w_dtype, seed=m)
    kind = pick_variant(x_dtype, m, variant)
    sms = sm_count(cuda)
    single = gemm_plan(kind, m, 288, 576, sms, experts)
    both = gemm_plan(kind, m, 288, 576, sms, chips * experts)
    forced = [1] + ([single.splits] if kind != "v1" or m <= 16 else [])
    for s in forced:
        got = masked_matmul(x, w, ok, variant=variant, splits=s)
        for c in range(chips):
            assert torch.equal(got[c], masked_matmul(x[c], w[c], ok[c], variant=variant, splits=s)), (s, c)
    if (single.splits, single.split_tiles) == (both.splits, both.split_tiles):
        got = masked_matmul(x, w, ok, variant=variant)
        for c in range(chips):
            assert torch.equal(got[c], masked_matmul(x[c], w[c], ok[c], variant=variant)), c


def test_chips_x_experts_is_one_launch_under_vmap_and_fault_einsum(cuda):
    """``fault_einsum``'s expert specs in kernel mode mapped over the chips:
    one chips x experts launch for each, against the plain ``fap`` einsum
    and a loop over the chips."""
    from repro_torch.core import FaultContext, fault_einsum

    x, w, ok = _chips_x_experts(cuda, 3, 8, 40, False, torch.bfloat16, torch.float32, seed=9)
    w = w.float()
    launches = masked_matmul.launches
    both_before = sum(masked_matmul.fleet_expert_launches_by_variant.values())
    got = torch.func.vmap(lambda x_, w_, ok_: fault_einsum("ecd,edf->ecf", x_, w_, FaultContext(ok_, "kernel")))(
        x, w, ok)
    torch.cuda.synchronize()
    assert masked_matmul.launches == launches + 1
    assert sum(masked_matmul.fleet_expert_launches_by_variant.values()) == both_before + 1
    for c in range(3):
        assert_close(got[c], fault_einsum("ecd,edf->ecf", x[c], w[c], FaultContext(ok[c], "fap")), torch.bfloat16)


def test_chips_x_experts_refuses_a_stack_it_cannot_view(cuda):
    x, w, ok = _chips_x_experts(cuda, 2, 4, 8, False, torch.bfloat16, torch.float32)
    launches = masked_matmul.launches
    with pytest.raises(ValueError, match="expert stride"):
        masked_matmul(x, w.transpose(0, 1).contiguous().transpose(0, 1), ok)  # experts outermost
    with pytest.raises(ValueError, match="bad shapes"):
        masked_matmul(x, w, ok[:1])  # a mask for one chip of two
    with pytest.raises(ValueError, match="bad shapes"):
        masked_matmul(x, w, ok[0])  # one mask for every chip: a mask a chip is the form
    assert masked_matmul.launches == launches


@pytest.mark.parametrize("hq,hkv", [(9, 9), (9, 3), (25, 5)])
@pytest.mark.parametrize("sq,skv,q_offset,window", [
    (1, 1, 0, None), (63, 63, 0, None), (65, 65, 0, None), (200, 200, 0, None), (200, 200, 0, 64),
    (65, 200, 135, None), (63, 200, 100, 37), (200, 1100, 900, 1024),
])
def test_bf16_flash_kernel_matches_plain(cuda, hq, hkv, sq, skv, q_offset, window):
    g = torch.Generator(device=cuda).manual_seed(sq + skv)
    q = torch.randn(2, sq, hq, 64, generator=g, device=cuda).to(torch.bfloat16).transpose(1, 2)
    k = torch.randn(2, skv, hkv, 64, generator=g, device=cuda).to(torch.bfloat16).transpose(1, 2)
    v = torch.randn(2, skv, hkv, 64, generator=g, device=cuda).to(torch.bfloat16).transpose(1, 2)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    before = dict(flash_attention.launches_by_variant)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_variant == {**before, "mma": before["mma"] + 1}
    torch.testing.assert_close(got.float(), attention_ref(q, k, v, **kw).float(), rtol=2e-2, atol=1e-2)
    v1 = flash_attention(q, k, v, variant="v1", **kw)
    assert flash_attention.launches_by_variant["v1"] == before["v1"] + 1
    torch.testing.assert_close(got.float(), v1.float(), rtol=2e-2, atol=1e-2)


@pytest.mark.parametrize("d", [64, 80, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,q_offset,window", [(65, 65, 0, None), (200, 200, 0, 64), (63, 200, 100, 37)])
def test_flash_kernels_take_every_built_head_dim(cuda, d, dtype, sq, skv, q_offset, window):
    """Both kernels (mma and v1 in bf16, v1 in float32) at each head dim the
    source builds, on the (B, S, H, D) projections' layout."""
    g = torch.Generator(device=cuda).manual_seed(d + sq)
    q = torch.randn(2, sq, 6, d, generator=g, device=cuda).to(dtype).transpose(1, 2)
    k = torch.randn(2, skv, 2, d, generator=g, device=cuda).to(dtype).transpose(1, 2)
    v = torch.randn(2, skv, 2, d, generator=g, device=cuda).to(dtype).transpose(1, 2)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    ref = attention_ref(q, k, v, **kw).float()
    rtol, atol = (2e-2, 1e-2) if dtype == torch.bfloat16 else dtype_tol(dtype)
    variants = ("auto", "v1") if dtype == torch.bfloat16 else ("auto",)
    for variant in variants:
        kind = "mma" if variant == "auto" and dtype == torch.bfloat16 else "v1"
        before = dict(flash_attention.launches_by_variant)
        got = flash_attention(q, k, v, variant=variant, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches_by_variant == {**before, kind: before[kind] + 1}
        assert got.shape == (2, 6, sq, d)
        torch.testing.assert_close(got.float(), ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("d", [64, 80, 96, 128])
@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "auto"), (torch.bfloat16, "v1"), (torch.float32, "auto")])
def test_flash_kernels_zero_mass_rows_at_every_head_dim(cuda, d, dtype, variant):
    q = torch.randn(1, 6, 70, d, device=cuda).to(dtype)
    k = torch.randn(1, 2, 40, d, device=cuda).to(dtype)
    got = flash_attention(q, k, k, causal=False, window=4, q_offset=100, variant=variant)
    assert not got.abs().any()
    got = flash_attention(q, k, k, causal=True, window=8, q_offset=30, variant=variant)
    ref = attention_ref(q, k, k, causal=True, window=8, q_offset=30)
    assert not got[:, :, 18:].abs().any()
    rtol, atol = (2e-2, 1e-2) if dtype == torch.bfloat16 else dtype_tol(dtype)
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)


def test_flash_attention_refuses_head_dims_it_does_not_build(cuda):
    q = torch.randn(1, 2, 8, 48, device=cuda).to(torch.bfloat16)
    before = flash_attention.launches
    for variant in ("auto", "v1"):
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention(q, q, q, variant=variant)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q.float()[..., :32].contiguous(), q.float()[..., :32].contiguous(),
                        q.float()[..., :32].contiguous())
    assert flash_attention.launches == before


def test_bf16_flash_kernel_zero_mass_rows_are_exact_zero(cuda):
    q = torch.randn(1, 6, 70, 64, device=cuda).to(torch.bfloat16)
    k = torch.randn(1, 2, 40, 64, device=cuda).to(torch.bfloat16)
    # rows at positions 100..169 with a window of 4 over 40 keys keep nothing
    got = flash_attention(q, k, k, causal=False, window=4, q_offset=100)
    assert not got.abs().any()
    # the first rows keep keys, the rest keep none
    got = flash_attention(q, k, k, causal=True, window=8, q_offset=30)
    ref = attention_ref(q, k, k, causal=True, window=8, q_offset=30)
    assert not got[:, :, 18:].abs().any() and not ref[:, :, 18:].abs().any()
    torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2, atol=1e-2)


FLASH_MMA_TILES = ((128, 128), (128, 64), (64, 128), (64, 64))  # ops.TILES["mma"]
# (B, Hq, Hkv, Sq, Skv, causal, window, q_offset): ragged lengths that cut through both tile sizes,
# a window and an offset, rows that keep no key, a batch of one with one kv head, Sq of 1
FLASH_MMA_CASES = [
    (2, 6, 2, 203, 333, True, 150, 130), (2, 5, 5, 129, 77, False, None, 0), (1, 4, 1, 300, 300, True, None, 0),
    (1, 3, 1, 1, 1, True, None, 0), (1, 6, 2, 70, 40, True, 8, 30), (2, 6, 3, 37, 1100, True, 1024, 1063),
]


@pytest.mark.parametrize("tile", FLASH_MMA_TILES, ids=[f"{t[0]}x{t[1]}" for t in FLASH_MMA_TILES])
@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_bf16_flash_every_mma_instance_on_strided_views_and_edges(cuda, d, tile):
    """Every mma instance at every head dim, on the model's (B, S, H, D)
    projections (q, k and v sliced from one fused buffer), a V whose every
    column holds its own offset (a column read from the wrong box shows),
    held to the plain version; the same bits on a second launch."""
    from repro_torch.kernels.flash_attention.ops import TILES

    assert TILES["mma"] == FLASH_MMA_TILES
    g = torch.Generator(device=cuda).manual_seed(d + tile[0] + tile[1])
    for b, hq, hkv, sq, skv, causal, window, off in FLASH_MMA_CASES:
        qkv = torch.randn(b, max(sq, skv), hq + 2 * hkv, d, generator=g, device=cuda)
        qkv[..., hq + hkv:, :] += torch.arange(d, device=cuda) / 8
        qkv = qkv.to(torch.bfloat16)
        q = qkv[:, :sq, :hq].transpose(1, 2)
        k = qkv[:, :skv, hq:hq + hkv].transpose(1, 2)
        v = qkv[:, :skv, hq + hkv:].transpose(1, 2)
        kw = dict(causal=causal, window=window, q_offset=off)
        ref = attention_ref(q, k, v, **kw).float()
        before = dict(flash_attention.launches_by_variant)
        got = flash_attention(q, k, v, bq=tile[0], bkv=tile[1], **kw)
        again = flash_attention(q, k, v, bq=tile[0], bkv=tile[1], **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches_by_variant == {**before, "mma": before["mma"] + 2}
        assert flash_attention.last_blocks == dict(bq=tile[0], bkv=tile[1])
        assert got.shape == (b, hq, sq, d) and got.transpose(1, 2).is_contiguous()
        torch.testing.assert_close(got.float(), ref, rtol=2e-2, atol=1e-2, msg=f"case {b, hq, hkv, sq, skv, kw}")
        assert torch.equal(got, again)
        empty = ~ref.abs().amax(-1).bool()  # rows that keep no key: exact zeros
        assert not got.float()[empty].abs().any()


def test_bf16_flash_refuses_what_the_mma_kernel_cannot_read(cuda):
    """A tile the mma kernel is not built for, and a broadcast (zero-stride)
    dim TMA cannot step, raise before any launch: no fallback to v1."""
    q = torch.randn(1, 4, 64, 64, device=cuda).to(torch.bfloat16)
    before = dict(flash_attention.launches_by_variant)
    for bq, bkv in ((64, 32), (256, 64), (32, 128)):
        with pytest.raises(ValueError, match="built for tiles"):
            flash_attention(q, q, q, bq=bq, bkv=bkv)
    kb = torch.randn(1, 1, 64, 64, device=cuda).to(torch.bfloat16).expand(1, 4, 64, 64)
    with pytest.raises(ValueError, match="broadcast"):
        flash_attention(q, kb, kb)
    assert flash_attention.launches_by_variant == before


def test_bf16_flash_kernel_refuses_a_misaligned_view(cuda):
    base = torch.randn(2, 65, 3, 64, device=cuda).to(torch.bfloat16)
    q = base[:, 1:].transpose(1, 2)  # fine: every stride a multiple of 8
    k = base.reshape(-1)[4:4 + 2 * 64 * 3 * 64].view(2, 64, 3, 64).transpose(1, 2)  # 8-byte offset
    before = flash_attention.launches
    flash_attention(q, q, q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, k, k)
    odd = torch.randn(2, 64, 3 * 64 + 4, device=cuda).to(torch.bfloat16)[..., :192].view(2, 64, 3, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, odd.transpose(1, 2), odd.transpose(1, 2))  # row stride 196
    assert flash_attention.launches == before + 1
    flash_attention(q.float(), k.float(), k.float())  # float32 runs v1, which takes any stride


def _scan_inputs(cuda, b, l, d, n, u_dtype, seed=0):
    """As the model gives them: dt fp32 from a softplus, B and C strided
    slices of one (B, L, r + 2N) tensor in u's dtype."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    u = torch.randn(b, l, d, generator=g, device=cuda).to(u_dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, l, d, generator=g, device=cuda) - 3.0)
    a = -torch.exp(torch.randn(d, n, generator=g, device=cuda))
    dbc = torch.randn(b, l, 5 + 2 * n, generator=g, device=cuda).to(u_dtype)
    _, bm, cm = torch.split(dbc, [5, n, n], dim=-1)
    d_skip = torch.randn(d, generator=g, device=cuda)
    return u, dt, a, bm, cm, d_skip


@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,d,n", SCAN_CASES)
def test_selective_scan_kernel_matches_plain_on_card(cuda, b, l, d, n, u_dtype):
    args = _scan_inputs(cuda, b, l, d, n, u_dtype)
    before = selective_scan.launches
    y, h = selective_scan(*args)
    torch.cuda.synchronize()
    assert selective_scan.launches == before + 1
    ref_y, ref_h = selective_scan_ref(*args)
    assert y.dtype == u_dtype and h.dtype == torch.float32
    rtol, atol = SCAN_TOL[u_dtype]
    torch.testing.assert_close(y.float(), ref_y.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(h, ref_h, rtol=2e-5, atol=1e-4)


def test_selective_scan_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.mamba_scan.ops import MAX_STATE

    u, dt, a, bm, cm, d_skip = _scan_inputs(cuda, 2, 16, 64, 16, torch.bfloat16)
    before = selective_scan.launches
    with pytest.raises(TypeError):
        selective_scan(u, dt.to(torch.bfloat16), a, bm, cm, d_skip)  # dt must be fp32
    with pytest.raises(TypeError):
        selective_scan(u, dt, a, bm.float(), cm, d_skip)  # b in another dtype than u
    with pytest.raises(ValueError):
        selective_scan(u, dt, a.cpu(), bm, cm, d_skip)  # a on the host
    big = _scan_inputs(cuda, 2, 16, 64, MAX_STATE + 1, torch.bfloat16)
    with pytest.raises(ValueError, match=f"1 to {MAX_STATE} states"):
        selective_scan(*big)  # more states than the kernel's cap
    with pytest.raises(ValueError, match="no scan kernel"):
        selective_scan(u, dt, a, bm, cm, d_skip, lanes=1)  # 16 states a lane: more than 8
    with pytest.raises(ValueError, match="no scan kernel"):
        selective_scan(u, dt, a, bm, cm, d_skip, lanes=3)  # not a power of two
    assert selective_scan.launches == before


# (B, L, D, N): every state count from 1 to the cap, at ragged D and L
SCAN_STATE_CASES = [(2, 37, 11, 1), (3, 70, 100, 4), (2, 45, 130, 16), (2, 33, 77, 17), (2, 50, 64, 32),
                    (2, 256, 1024, 64), (1, 19, 13, 256), (2, 100, 300, 17)]


@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,d,n", SCAN_STATE_CASES)
def test_selective_scan_kernel_takes_every_state_count(cuda, b, l, d, n, u_dtype):
    args = _scan_inputs(cuda, b, l, d, n, u_dtype, seed=n)
    before = selective_scan.launches
    y, h = selective_scan(*args)
    torch.cuda.synchronize()
    assert selective_scan.launches == before + 1
    ref_y, ref_h = selective_scan_ref(*args)
    rtol, atol = SCAN_TOL[u_dtype]
    torch.testing.assert_close(y.float(), ref_y.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(h, ref_h, rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_selective_scan_every_plan_agrees_and_repeats_its_bits(cuda, lanes, u_dtype):
    """Each lane count a channel may take against the plain version; two
    launches of one plan give the same bits. At 1 and 2 lanes in float32 (and
    1 in bf16) four blocks of 32-step chunks would not fit an SM, so the
    kernel stages 16 steps: both chunk lengths run."""
    b, l, d, n = 2, 75, 200, 8
    args = _scan_inputs(cuda, b, l, d, n, u_dtype, seed=lanes)
    ref_y, ref_h = selective_scan_ref(*args)
    rtol, atol = SCAN_TOL[u_dtype]
    y, h = selective_scan(*args, lanes=lanes)
    torch.cuda.synchronize()
    plan = selective_scan.last_plan
    assert (plan.lanes, plan.states, plan.channels) == (lanes, max(1, n // lanes), 128 // lanes)
    torch.testing.assert_close(y.float(), ref_y.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(h, ref_h, rtol=2e-5, atol=1e-4)
    y2, h2 = selective_scan(*args, lanes=lanes)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_takes_unaligned_slices(cuda, u_dtype):
    """u a slice of a wider tensor (the in_proj output's first half), B and C
    slices at an odd element (2-byte copies in bf16) and L = 0."""
    g = torch.Generator(device=cuda).manual_seed(5)
    b, l, d, n = 2, 40, 96, 16
    xz = torch.randn(b, l, 2 * d, generator=g, device=cuda).to(u_dtype)
    u = xz[..., :d]
    dt = torch.nn.functional.softplus(torch.randn(b, l, d, generator=g, device=cuda) - 3.0)
    a = -torch.exp(torch.randn(d, n, generator=g, device=cuda))
    dbc = torch.randn(b, l, 3 + 2 * n, generator=g, device=cuda).to(u_dtype)
    _, bm, cm = torch.split(dbc, [3, n, n], dim=-1)
    d_skip = torch.randn(d, generator=g, device=cuda)
    y, h = selective_scan(u, dt, a, bm, cm, d_skip)
    ref_y, ref_h = selective_scan_ref(u, dt, a, bm, cm, d_skip)
    rtol, atol = SCAN_TOL[u_dtype]
    torch.testing.assert_close(y.float(), ref_y.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(h, ref_h, rtol=2e-5, atol=1e-4)
    y0, h0 = selective_scan(u[:, :0], dt[:, :0], a, bm[:, :0], cm[:, :0], d_skip)
    torch.cuda.synchronize()
    assert y0.shape == (b, 0, d) and not h0.any()


def test_selective_scan_is_deterministic(cuda):
    args = _scan_inputs(cuda, 4, 128, 8192, 16, torch.bfloat16, seed=1)
    y1, h1 = selective_scan(*args)
    y2, h2 = selective_scan(*args)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def _chip_scan_inputs(cuda, chips, b, l, d, n, u_dtype, shared, seed=0):
    """Chips x B rows of scan inputs as the model gives them, and each
    chip's a (chips, D, N) and d (chips, D); ``shared`` gives every chip
    chip 0's, read with chip stride 0."""
    u, dt, _, bm, cm, _ = _scan_inputs(cuda, chips * b, l, d, n, u_dtype, seed=seed)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    a = -torch.exp(torch.randn(chips, d, n, generator=g, device=cuda))
    d_skip = torch.randn(chips, d, generator=g, device=cuda)
    if shared:
        a, d_skip = a[0].expand(chips, d, n), d_skip[0].expand(chips, d)
    return u, dt, a, bm, cm, d_skip


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chips,b,l,d,n", [(1, 2, 75, 200, 16), (2, 2, 75, 200, 16), (3, 1, 37, 11, 4),
                                           (4, 4, 128, 3200, 16), (4, 2, 50, 64, 32)])
def test_chip_batched_scan_matches_plain_in_one_launch(cuda, chips, b, l, d, n, u_dtype, shared):
    """a (chips, D, N) and d (chips, D), per chip or one shared (chip stride
    0): one counted chip-batched launch over chips x B rows, against the
    plain version; each chip's rows are the bits of that chip's own launch
    at the same lanes."""
    args = _chip_scan_inputs(cuda, chips, b, l, d, n, u_dtype, shared, seed=chips + n)
    u, dt, a, bm, cm, d_skip = args
    before, fleet_before = selective_scan.launches, selective_scan.fleet_launches
    y, h = selective_scan(*args)
    torch.cuda.synchronize()
    plan = selective_scan.last_plan
    assert selective_scan.launches == before + 1 and selective_scan.fleet_launches == fleet_before + 1
    assert plan.blocks == chips * b * -(-d // plan.channels)
    ref_y, ref_h = selective_scan_ref(*args)
    rtol, atol = SCAN_TOL[u_dtype]
    torch.testing.assert_close(y.float(), ref_y.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(h, ref_h, rtol=2e-5, atol=1e-4)
    for c in range(chips):
        rows = slice(c * b, (c + 1) * b)
        one_y, one_h = selective_scan(u[rows], dt[rows], a[c], bm[rows], cm[rows], d_skip[c], lanes=plan.lanes)
        assert torch.equal(y[rows], one_y) and torch.equal(h[rows], one_h), c
    assert selective_scan.fleet_launches == fleet_before + 1


def test_chip_batched_scan_is_one_launch_under_vmap(cuda):
    """``torch.func.vmap`` of the scan over a chip axis: the custom op's
    vmap rule makes one chip-batched launch; eager calls reach the kernel
    directly."""
    chips, b = 3, 2
    u, dt, a, bm, cm, d_skip = _chip_scan_inputs(cuda, chips, b, 40, 96, 16, torch.bfloat16, False, seed=2)
    split = lambda t: t.unflatten(0, (chips, b))
    launches, fleet = selective_scan.launches, selective_scan.fleet_launches
    y, h = torch.func.vmap(selective_scan)(split(u), split(dt), a, split(bm), split(cm), d_skip)
    torch.cuda.synchronize()
    assert selective_scan.launches == launches + 1 and selective_scan.fleet_launches == fleet + 1
    ref_y, ref_h = selective_scan_ref(u, dt, a, bm, cm, d_skip)
    torch.testing.assert_close(y.flatten(0, 1).float(), ref_y.float(), rtol=2e-2, atol=1e-2)
    torch.testing.assert_close(h.flatten(0, 1), ref_h, rtol=2e-5, atol=1e-4)


def test_chip_batched_scan_refuses_what_it_does_not_take(cuda):
    u, dt, a, bm, cm, d_skip = _chip_scan_inputs(cuda, 2, 2, 16, 64, 16, torch.bfloat16, False)
    before = selective_scan.launches
    with pytest.raises(ValueError, match="bad shapes"):
        selective_scan(u[:3], dt[:3], a, bm[:3], cm[:3], d_skip)  # 3 rows do not tile 2 chips
    with pytest.raises(ValueError, match="bad shapes"):
        selective_scan(u, dt, a, bm, cm, d_skip[0])  # a per chip, d not
    with pytest.raises(ValueError, match="contiguous|chip stride"):
        selective_scan(u, dt, a.transpose(1, 2).contiguous().transpose(1, 2), bm, cm, d_skip)
    assert selective_scan.launches == before


# ---------------------------------------------------------------------------
# int8 decode attention, dense and paged
# ---------------------------------------------------------------------------

# f32 at the repository's table; bf16 at the flash rule (outputs' RMS is well under 1)
DECODE_TOL = {torch.float32: dtype_tol(torch.float32), torch.bfloat16: (2e-2, 1e-2)}


def _int8_cache(cuda, b, hkv, s, d, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    ki, ks = quantize_kv(torch.randn(b, hkv, s, d, generator=g, device=cuda))
    vi, vs = quantize_kv(torch.randn(b, hkv, s, d, generator=g, device=cuda))
    return ki, ks, vi, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,valid,bkv", [
    (1, 2, 2, 512, 32, 512, None),  # the reference's tune-suite shape
    (4, 9, 3, 2048, 64, 1000, None),  # SmolLM-135M heads, ragged length
    (4, 25, 5, 1024, 64, 1024, 1024),  # hymba-1.5b heads, the whole ring in one tile
    (2, 8, 2, 300, 128, 257, 64),
    (3, 4, 4, 96, 64, 0, 32),  # zero length gives 0
])
def test_decode_attention_kernel_matches_plain_on_card(cuda, dtype, b, hq, hkv, s, d, valid, bkv):
    cache = _int8_cache(cuda, b, hkv, s, d, seed=s)
    q = torch.randn(b, hq, 1, d, device=cuda).to(dtype)
    before = decode_attention.launches
    got = decode_attention(q, *cache, valid, bkv=bkv)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = decode_attention_ref(q, *cache, kv_valid_len=valid)
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = DECODE_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)
    if valid == 0:
        assert not got.abs().any()
    # a device-resident length launches the same kernel and gives the same result
    dev_len = torch.tensor([valid], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(decode_attention(q, *cache, dev_len, bkv=bkv), got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d", [(9, 3, 64), (4, 2, 32), (8, 8, 128), (12, 4, 96), (32, 32, 96)])
def test_paged_decode_attention_kernel_matches_plain_on_card(cuda, dtype, hq, hkv, d):
    b, page, maxp, pool = 6, 8, 40, 400
    lens = torch.tensor([0, 1, 77, 320, 8, 200], dtype=torch.int32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(d)
    ki, ks = quantize_kv(torch.randn(hkv, pool, page, d, generator=g, device=cuda))
    vi, vs = quantize_kv(torch.randn(hkv, pool, page, d, generator=g, device=cuda))
    # shuffled page ids; ids past a sequence's pages are stale (out of the pool, never read)
    ids = torch.randperm(pool - 1, generator=g, device=cuda)[: b * maxp].reshape(b, maxp) + 1
    used = (lens + page - 1) // page
    stale = torch.arange(maxp, device=cuda)[None] >= used[:, None]
    tables = torch.where(stale, torch.full_like(ids, 10**6), ids).to(torch.int32)
    q = torch.randn(b, hq, 1, d, generator=g, device=cuda).to(dtype)
    before = paged_decode_attention.launches
    got = paged_decode_attention(q, ki, ks, vi, vs, tables, lens)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    ref = paged_decode_attention_ref(q, ki, ks, vi, vs, ids.to(torch.int32), lens)
    rtol, atol = DECODE_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)
    assert not got[0].abs().any()


# (B, Hq, Hkv, S, D, bkv): the tune-suite shape, SmolLM-135M's and hymba-1.5b's head groups, a
# group over GMAX query heads (two head chunks) at D = 128, then every group size at D = 96
# (phi3-mini's heads, 32 / 32, are the group of 1): each is its own compile-time instance
SPLIT_CASES = [(1, 2, 2, 512, 32, 128), (4, 9, 3, 2048, 64, 128), (4, 25, 5, 1024, 64, 128),
               (2, 40, 4, 700, 128, 64), (2, 32, 32, 700, 96, 128), (2, 4, 2, 700, 96, 64),
               (4, 12, 4, 1000, 96, 64), (2, 8, 2, 700, 96, 128), (2, 40, 8, 700, 96, 128),
               (2, 12, 2, 300, 96, 64), (2, 14, 2, 300, 96, 64), (2, 8, 1, 700, 96, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,bkv", SPLIT_CASES)
def test_decode_attention_split_counts_agree_on_card(cuda, dtype, b, hq, hkv, s, d, bkv):
    """Splits forced to 1, to the plan's and to one per tile, at lengths that
    end on a split boundary, inside the last split, at one key and at 0 (every
    split empty: exact zeros); two launches, and an int against a device
    length, give the same bits; one counted launch per call."""
    from repro_torch.kernels.decode_attention.ops import sm_count, split_plan

    cache = _int8_cache(cuda, b, hkv, s, d, seed=s + hq)
    q = torch.randn(b, hq, 1, d, device=cuda).to(dtype)
    tiles = -(-s // bkv)
    plan = split_plan(b, hkv, s, bkv, sm_count(cuda))
    rtol, atol = DECODE_TOL[dtype]
    for splits in sorted({1, plan, tiles}):
        per = -(-tiles // splits) * bkv  # keys per split
        for valid in sorted({0, 1, min(per, s), s - 5, s}):
            before = decode_attention.launches
            got = decode_attention(q, *cache, valid, bkv=bkv, splits=splits)
            torch.cuda.synchronize()
            assert decode_attention.launches == before + 1 and decode_attention.last_splits == splits
            ref = decode_attention_ref(q, *cache, kv_valid_len=valid)
            torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)
            if valid == 0:
                assert not got.abs().any()
            dev_len = torch.tensor([valid], dtype=torch.int32, device=cuda)
            assert torch.equal(decode_attention(q, *cache, valid, bkv=bkv, splits=splits), got)
            assert torch.equal(decode_attention(q, *cache, dev_len, bkv=bkv, splits=splits), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_attention_split_counts_agree_on_card(cuda, dtype):
    """Chains whose lengths end in different splits (and on a split edge),
    stale ids past each chain out of the pool (never read), the splits forced
    to 1 and to one per tile; two launches give the same bits."""
    b, hq, hkv, d, page, maxp, pool = 8, 9, 3, 64, 8, 64, 600
    tile = 128  # paged_tile(8): 4 tiles of the 512-token table span
    lens = torch.tensor([0, 3, 128, 129, 256, 300, 511, 512], dtype=torch.int32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    ki, ks = quantize_kv(torch.randn(hkv, pool, page, d, generator=g, device=cuda))
    vi, vs = quantize_kv(torch.randn(hkv, pool, page, d, generator=g, device=cuda))
    ids = torch.randperm(pool - 1, generator=g, device=cuda)[: b * maxp].reshape(b, maxp) + 1
    used = (lens + page - 1) // page
    stale = torch.arange(maxp, device=cuda)[None] >= used[:, None]
    tables = torch.where(stale, torch.full_like(ids, 2**30), ids).to(torch.int32)
    q = torch.randn(b, hq, 1, d, generator=g, device=cuda).to(dtype)
    ref = paged_decode_attention_ref(q, ki, ks, vi, vs, ids.to(torch.int32), lens)
    rtol, atol = DECODE_TOL[dtype]
    for splits in (None, 1, 2, maxp * page // tile):
        before = paged_decode_attention.launches
        got = paged_decode_attention(q, ki, ks, vi, vs, tables, lens, splits=splits)
        torch.cuda.synchronize()
        assert paged_decode_attention.launches == before + 1
        torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)
        assert not got[0].abs().any()
        assert torch.equal(paged_decode_attention(q, ki, ks, vi, vs, tables, lens, splits=splits), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(32, 32), (40, 8), (8, 1)])
def test_paged_decode_attention_at_d96_with_forced_splits(cuda, dtype, hq, hkv):
    """phi3-mini's head dim over a paged pool, at its heads (a group of 1)
    and at groups of 5 and 8: the splits forced to 1 and to one per tile,
    and the plan's, against the plain version."""
    b, d, page, maxp, pool = 4, 96, 16, 32, 200
    tile = 128  # paged_tile(16): 4 tiles of the 512-token table span
    lens = torch.tensor([0, 129, 300, 512], dtype=torch.int32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(96)
    ki, ks = quantize_kv(torch.randn(hkv, pool, page, d, generator=g, device=cuda))
    vi, vs = quantize_kv(torch.randn(hkv, pool, page, d, generator=g, device=cuda))
    ids = (torch.randperm(pool - 1, generator=g, device=cuda)[: b * maxp].reshape(b, maxp) + 1).to(torch.int32)
    q = torch.randn(b, hq, 1, d, generator=g, device=cuda).to(dtype)
    ref = paged_decode_attention_ref(q, ki, ks, vi, vs, ids, lens)
    rtol, atol = DECODE_TOL[dtype]
    for splits in (None, 1, maxp * page // tile):
        got = paged_decode_attention(q, ki, ks, vi, vs, ids, lens, splits=splits)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)
        assert not got[0].abs().any()
        assert torch.equal(paged_decode_attention(q, ki, ks, vi, vs, ids, lens, splits=splits), got)


def test_decode_attention_refuses_what_it_does_not_take(cuda):
    ki, ks, vi, vs = _int8_cache(cuda, 1, 2, 64, 48)
    q = torch.randn(1, 4, 1, 48, device=cuda)
    before = decode_attention.launches
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention(q, ki, ks, vi, vs, 64)  # D = 48 is not built
    ki, ks, vi, vs = _int8_cache(cuda, 1, 2, 64, 64)
    with pytest.raises(ValueError, match="multiple"):
        decode_attention(torch.randn(1, 3, 1, 64, device=cuda), ki, ks, vi, vs, 64)
    with pytest.raises(ValueError, match="shared memory"):
        decode_attention(torch.randn(1, 4, 1, 64, device=cuda), *_int8_cache(cuda, 1, 2, 4096, 64), 64,
                         bkv=4096)
    with pytest.raises(TypeError):
        decode_attention(torch.randn(1, 4, 1, 64, device=cuda).half(), ki, ks, vi, vs, 64)
    with pytest.raises(ValueError, match="int8"):
        decode_attention(torch.randn(1, 4, 1, 64, device=cuda), ki.float(), ks, vi, vs, 64)
    for splits in (0, 2):  # at least one split, and no more splits than 64-key tiles
        with pytest.raises(ValueError, match="splits must be in"):
            decode_attention(torch.randn(1, 4, 1, 64, device=cuda), ki, ks, vi, vs, 64, bkv=64, splits=splits)
    assert decode_attention.launches == before


def test_tuned_cache_changes_bkv_not_result(cuda):
    from repro_torch.tune.cache import TuningCache, cache_key, set_tuning_cache

    b, hq, hkv, s, d = 2, 6, 2, 1000, 64
    cache = _int8_cache(cuda, b, hkv, s, d)
    q = torch.randn(b, hq, 1, d, device=cuda)
    prev = set_tuning_cache(TuningCache())
    try:
        base = decode_attention(q, *cache, 900)
        assert decode_attention.last_bkv == 128
        table = TuningCache()
        table.put(cache_key("decode_attention", dict(b=b, hq=hq, hkv=hkv, skv=s, d=d), "float32", "cuda"),
                  dict(blocks=dict(bkv=512)))
        set_tuning_cache(table)
        tuned = decode_attention(q, *cache, 900)
        assert decode_attention.last_bkv == 512
        decode_attention(q, *cache, 900, bkv=64)  # an explicit bkv beats the cache
        assert decode_attention.last_bkv == 64
    finally:
        set_tuning_cache(prev)
    rtol, atol = dtype_tol(torch.float32)
    torch.testing.assert_close(tuned, base, rtol=rtol, atol=atol)


def test_tuner_on_card_beats_or_ties_heuristic(cuda):
    from repro_torch.tune import tune_many
    from repro_torch.tune.tuner import lint_candidate

    before = decode_attention.launches
    results, table = tune_many([("decode_attention", dict(b=4, hq=9, hkv=3, skv=2048, d=64))],
                               dtype=torch.bfloat16, iters=3)
    res = results[0]
    assert res.backend == "cuda" and res.best_s <= res.heuristic_s
    findings, _ = lint_candidate("decode_attention", res.shape, torch.bfloat16, dict(bkv=2048))
    assert [f.code for f in findings] == ["KRN002"]  # over the 227 KiB limit: never launched
    assert all("KRN002" in r["codes"] for r in res.rejected_configs)
    assert decode_attention.launches > before
    assert table.get(res.key)["blocks"] == res.best_blocks


# ---------------------------------------------------------------------------
# the autotuner's spaces on the card: every tile, split count and lane count it may pick
# ---------------------------------------------------------------------------


@pytest.fixture
def empty_cache():
    from repro_torch.tune.cache import TuningCache, set_tuning_cache

    prev = set_tuning_cache(TuningCache())
    try:
        yield
    finally:
        set_tuning_cache(prev)


@pytest.mark.parametrize("d", [64, 80, 96, 128])
@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "auto"), (torch.bfloat16, "v1"), (torch.float32, "auto")])
def test_every_built_flash_tile_matches_plain(cuda, d, dtype, variant):
    """Each (bq, bkv) instance the source builds, at each head dim and for
    each variant, causal with an offset and a window and not causal, at
    ragged lengths that cut through the tiles."""
    from repro_torch.kernels.flash_attention.ops import pick_variant, tiles_built

    kind = pick_variant(dtype, variant)
    g = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn(2, 203, 6, d, generator=g, device=cuda).to(dtype).transpose(1, 2)
    k = torch.randn(2, 333, 2, d, generator=g, device=cuda).to(dtype).transpose(1, 2)
    v = torch.randn(2, 333, 2, d, generator=g, device=cuda).to(dtype).transpose(1, 2)
    rtol, atol = (2e-2, 1e-2) if dtype == torch.bfloat16 else dtype_tol(dtype)
    for kw in (dict(causal=True, q_offset=130, window=150), dict(causal=False)):
        ref = attention_ref(q, k, v, **kw).float()
        for bq, bkv in tiles_built(kind, dtype, d):
            before = dict(flash_attention.launches_by_variant)
            got = flash_attention(q, k, v, variant=variant, bq=bq, bkv=bkv, **kw)
            torch.cuda.synchronize()
            assert flash_attention.launches_by_variant == {**before, kind: before[kind] + 1}
            assert flash_attention.last_blocks == dict(bq=bq, bkv=bkv)
            torch.testing.assert_close(got.float(), ref, rtol=rtol, atol=atol, msg=f"tile {bq, bkv} {kw}")


def test_flash_refuses_tiles_it_does_not_build(cuda):
    q = torch.randn(1, 2, 64, 128, device=cuda)
    before = flash_attention.launches
    for kw in (dict(bq=128, bkv=64), dict(bq=64, bkv=128), dict(bq=32, bkv=64)):  # over 227 KiB, or not built
        with pytest.raises(ValueError, match="built for tiles"):
            flash_attention(q, q, q, **kw)
    with pytest.raises(ValueError, match="built for tiles"):  # bf16 v1 is built at the default alone
        flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(), variant="v1", bq=128, bkv=64)
    with pytest.raises(ValueError, match="built for tiles"):  # mma has no 32-key tile
        flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(), bq=64, bkv=32)
    assert flash_attention.launches == before


@pytest.mark.parametrize("dtype,m,k,n", [
    (torch.bfloat16, 4, 576, 1536), (torch.bfloat16, 4, 8192, 4096), (torch.bfloat16, 512, 576, 192),
    (torch.bfloat16, 1024, 1536, 576), (torch.float32, 4, 576, 1536), (torch.float32, 512, 576, 192),
    (torch.float32, 100, 1536, 576),
])
def test_masked_matmul_every_split_count_of_the_lattice_matches_plain(cuda, empty_cache, dtype, m, k, n):
    """Every K split the tuner may pick, at decode and prefill shapes, held
    to the plain version; the forced count is the one launched."""
    from repro_torch.kernels.masked_matmul.ops import gemm_plan, max_splits, pick_variant, sm_count
    from repro_torch.tune.search import pow2_lattice

    x, w, ok = _gemm_inputs(cuda, m, k, n, False) if dtype == torch.bfloat16 else _f32_gemm(cuda, m, k, n, False)
    kind = pick_variant(dtype, m)
    ref = masked_matmul_ref(x, w, ok).float()
    rtol, atol = (2e-2, 2e-2) if dtype == torch.bfloat16 else F32_TOL
    for splits in pow2_lattice(max_splits(kind, m, k), lo=1):
        got = masked_matmul(x, w, ok, splits=splits)
        torch.cuda.synchronize()
        want = gemm_plan(kind, m, n, k, sm_count(cuda), splits=splits).splits
        assert masked_matmul.last_splits == want
        torch.testing.assert_close(got.float(), ref, rtol=rtol, atol=atol, msg=f"splits {splits}")
    with pytest.raises(ValueError, match="K slices"):
        masked_matmul(x, w, ok, splits=max_splits(kind, m, k) + 1)


@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [4, 16, 64])
def test_selective_scan_every_legal_lane_count_matches_plain(cuda, empty_cache, u_dtype, n):
    from repro_torch.kernels.mamba_scan.ops import lane_choices

    args = _scan_inputs(cuda, 2, 50, 300, n, u_dtype, seed=n)
    ref_y, ref_h = selective_scan_ref(*args)
    rtol, atol = SCAN_TOL[u_dtype]
    for lanes in lane_choices(n):
        y, h = selective_scan(*args, lanes=lanes)
        torch.cuda.synchronize()
        assert selective_scan.last_plan.lanes == lanes
        torch.testing.assert_close(y.float(), ref_y.float(), rtol=rtol, atol=atol)
        torch.testing.assert_close(h, ref_h, rtol=2e-5, atol=1e-4)
    with pytest.raises(ValueError, match="no scan kernel"):
        selective_scan(*args, lanes=min(lane_choices(n)) // 2 or 64)


def test_an_empty_cache_gives_the_bits_of_the_explicit_heuristic(cuda, empty_cache):
    """Each of the three wrappers with no blocks and an empty cache launches
    its heuristic, bit for bit."""
    from repro_torch.kernels.flash_attention.ops import DEFAULT_TILE, pick_variant
    from repro_torch.kernels.mamba_scan.ops import scan_plan, sm_count
    from repro_torch.kernels.masked_matmul.ops import gemm_plan

    for m, dtype in ((4, torch.bfloat16), (512, torch.bfloat16), (4, torch.float32), (512, torch.float32)):
        x, w, ok = _gemm_inputs(cuda, m, 576, 1536, False) if dtype == torch.bfloat16 else \
            _f32_gemm(cuda, m, 576, 1536, False)
        plan = gemm_plan("v1" if dtype == torch.float32 else "decode" if m <= 16 else "mma", m, 1536, 576,
                         sm_count(cuda))
        got = masked_matmul(x, w, ok)
        assert masked_matmul.last_splits == plan.splits
        assert torch.equal(got, masked_matmul(x, w, ok, splits=plan.splits))
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(2, 9, 300, 64, device=cuda).to(dtype)
        k = torch.randn(2, 3, 300, 64, device=cuda).to(dtype)
        got = flash_attention(q, k, k)
        tile = DEFAULT_TILE[pick_variant(dtype)]  # mma (128, 128), v1 (64, 64)
        assert flash_attention.last_blocks == dict(bq=tile[0], bkv=tile[1])
        assert torch.equal(got, flash_attention(q, k, k, bq=tile[0], bkv=tile[1]))
        args = _scan_inputs(cuda, 2, 64, 800, 16, dtype)
        y, h = selective_scan(*args)
        lanes = scan_plan(2, 800, 16, sm_count(cuda)).lanes
        assert selective_scan.last_plan.lanes == lanes
        y2, h2 = selective_scan(*args, lanes=lanes)
        assert torch.equal(y, y2) and torch.equal(h, h2)


def test_the_cache_steers_each_wrapper_on_the_card(cuda, empty_cache):
    """A table entry reaches the launch (read off ``last_*``), a caller's
    value beats it, and a tuned entry the wrapper refuses raises."""
    from repro_torch.kernels.mamba_scan.ops import scan_plan, sm_count
    from repro_torch.tune.cache import cache_key, get_tuning_cache

    table = get_tuning_cache()
    x, w, ok = _gemm_inputs(cuda, 4, 576, 1536, False)
    table.put(cache_key("masked_matmul", dict(m=4, k=576, n=1536, r=256, c=256), "bfloat16", "cuda"),
              dict(blocks=dict(splits=2)))
    masked_matmul(x, w, ok)
    assert masked_matmul.last_splits == 2
    masked_matmul(x, w, ok, splits=3)
    assert masked_matmul.last_splits == 3
    masked_matmul(x, w.T.contiguous().T, ok)  # k-contiguous w keeps the plan
    assert masked_matmul.last_splits != 2
    q = torch.randn(1, 4, 256, 64, device=cuda).to(torch.bfloat16)
    key = cache_key("flash_attention", dict(b=1, hq=4, hkv=4, sq=256, skv=256, d=64, causal=1), "bfloat16", "cuda")
    table.put(key, dict(blocks=dict(bq=128, bkv=64)))
    flash_attention(q, q, q)
    assert flash_attention.last_blocks == dict(bq=128, bkv=64)
    table.put(key, dict(blocks=dict(bq=256, bkv=32)))
    with pytest.raises(ValueError, match="built for tiles"):
        flash_attention(q, q, q)
    args = _scan_inputs(cuda, 2, 40, 300, 16, torch.float32)
    table.put(cache_key("mamba_scan", dict(b=2, l=40, d=300, n=16), "float32", "cuda"), dict(blocks=dict(lanes=4)))
    selective_scan(*args)
    assert selective_scan.last_plan.lanes == 4
    u, dt, a, bm, cm, d_skip = args  # the same key's rows as 2 chips: the plan, not the entry
    selective_scan(u, dt, a.expand(2, *a.shape), bm, cm, d_skip.expand(2, *d_skip.shape))
    assert selective_scan.last_plan == scan_plan(2, 300, 16, sm_count(cuda))
    table.put(cache_key("mamba_scan", dict(b=2, l=40, d=300, n=16), "float32", "cuda"), dict(blocks=dict(lanes=1)))
    with pytest.raises(ValueError, match="no scan kernel"):
        selective_scan(*args)


def test_every_committed_default_entry_passes_the_lint(cuda):
    from repro_torch.tune.cache import DEFAULT_CACHE_PATH, TuningCache, parse_key
    from repro_torch.tune.tuner import SHAPE_FIELDS, lint_candidate

    table = TuningCache.load(DEFAULT_CACHE_PATH)
    assert len(table) > 0
    for key, entry in table.entries.items():
        kernel, shape, dtype, backend = parse_key(key)
        assert backend == "cuda" and set(shape) == set(SHAPE_FIELDS[kernel])
        findings, smem = lint_candidate(kernel, shape, getattr(torch, dtype), entry["blocks"])
        assert findings == [] and smem == entry["smem_bytes"], key
        assert entry["speedup"] >= 1.05, key


# ---------------------------------------------------------------------------
# fault-aware training of paper-mlp, and its deployment through the kernel
# ---------------------------------------------------------------------------

MLP = get_arch("paper-mlp")
FAT_RATES = [0.02, 0.08, 0.12, 0.18, 0.22]


def _fat(device, kind, base=None, **engine_kw):
    """An engine, its base params (pretrained 100 steps on the CPU unless
    given), the FAT stream and the 5-rate fleet's contexts, on ``device``."""
    data = make_classification_task(MLP, seed=0, device=device)
    kw = dict(loss_fn=lambda p, b, ctx: classifier_loss(p, b, MLP, ctx),
              opt_cfg=AdamWConfig(learning_rate=3e-3, weight_decay=0.0, grad_clip_norm=1.0),
              eval_batches=data.eval_batches(2), eval_every=5)
    engine = make_fat_engine(kind, **kw, **engine_kw)
    if base is None:
        base = engine.fit_batch(init_classifier(MLP, 0, data.dim, device), [healthy()], [100],
                                lambda s: data.batch_at(s, 256))[0]
    rng = np.random.default_rng(0)
    fleet = [random_fault_map(rng, 32, 32, r) for r in FAT_RATES]
    ctxs = [from_fault_map(fm, device=device) for fm in fleet]
    return engine, {k: v.to(device) for k, v in base.items()}, (lambda s: data.batch_at(s + 1_000_003, 256)), ctxs


@pytest.mark.parametrize("kind", ["population", "serial"])
def test_fat_engines_on_the_card_match_the_cpu(cuda, kind):
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_engine, base, cpu_fn, cpu_ctxs = _fat(torch.device("cpu"), kind)
    engine, base_c, fn, ctxs = _fat(cuda, kind, base)
    want = cpu_engine.fit_batch(base, cpu_ctxs[:3], [25, 40, 10], cpu_fn)
    got = engine.fit_batch(base_c, ctxs[:3], [25, 40, 10], fn)
    for g, w in zip(got, want):
        assert g["w0"].device.type == cuda.type
        for k in w:
            assert_close(g[k], w[k], torch.float32, atol_scale=100)
    assert engine.evaluate_batch(got, ctxs[:3]) == pytest.approx(
        cpu_engine.evaluate_batch(want, cpu_ctxs[:3]), abs=2e-3)


def test_population_matches_serial_on_the_card(cuda):
    """The reference's pin, on the card: equal steps-to-constraint."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pop = ClassifierFATTrainer(MLP, pretrain_steps=300, eval_batches=2)
    assert pop.device.type == "cuda"  # the card is the default
    ser = ClassifierFATTrainer(MLP, pretrain_steps=0, eval_batches=2, engine="serial")
    ser.base_params = pop.base_params
    rng = np.random.default_rng(0)
    fleet = [random_fault_map(rng, 32, 32, r) for r in FAT_RATES]
    constraint = pop.baseline_accuracy - 0.05
    assert pop.steps_to_constraint_batch(fleet, constraint, 200) == (
        ser.steps_to_constraint_batch(fleet, constraint, 200))


def test_kernel_mode_deployment_matches_fap_on_the_card(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    engine, base, fn, ctxs = _fat(cuda, "population")
    params = engine.fit_batch(base, ctxs[2:3], [20], fn)[0]
    fm = random_fault_map(2, 32, 32, 0.12)
    x = torch.randn(512, 32, device=cuda)
    before = masked_matmul.launches_by_variant["v1"]
    got = classifier_forward(params, x, MLP, from_fault_map(fm, "kernel", device=cuda))
    torch.cuda.synchronize()
    assert masked_matmul.launches_by_variant["v1"] == before + MLP.num_layers
    assert_close(got, classifier_forward(params, x, MLP, from_fault_map(fm, "fap", device=cuda)), torch.float32)


def test_kernel_mode_population_on_the_card_raises(cuda):
    engine, base, fn, ctxs = _fat(cuda, "population", base=init_classifier(MLP, 0, 32, "cpu"))
    kctxs = [from_fault_map(random_fault_map(i, 32, 32, 0.1), "kernel", device=cuda) for i in range(3)]
    with pytest.raises(NotImplementedError, match="no masked-GEMM backward"):
        engine.fit_batch(base, kctxs, [1, 1, 1], fn)
    with pytest.raises(NotImplementedError, match="no masked-GEMM backward"):
        engine.steps_to_constraint_batch(base, kctxs, 0.5, 5, fn)
    serial = _fat(cuda, "serial", base=base)[0]
    with pytest.raises(NotImplementedError, match="no masked-GEMM backward"):
        serial.fit_batch(base, kctxs[:1], [1], fn)
    # one chip's forward in kernel mode is the deployment path, and runs
    assert 0.0 <= serial.evaluate_one(base, kctxs[0]) <= 1.0


@pytest.mark.parametrize("chips,width", [(3, 16), (5, 2)])
def test_kernel_mode_population_evaluation_is_chip_batched_on_the_card(cuda, chips, width):
    """``evaluate_batch`` in ``kernel`` mode on the card: each masked GEMM of
    a chunk's forward is ONE chip-batched v1 launch (layers x eval batches
    x chunks in all), and the metrics equal the one-chip-at-a-time loop's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    engine, base, fn, _ = _fat(cuda, "population", base=init_classifier(MLP, 0, 32, "cpu"), population_size=width)
    kctxs = [from_fault_map(random_fault_map(i, 32, 32, 0.1), "kernel", device=cuda) for i in range(chips)]
    params = [{k: v + 0.01 * i for k, v in base.items()} for i in range(chips)]
    before = dict(masked_matmul.launches_by_variant), dict(masked_matmul.fleet_launches_by_variant)
    got = engine.evaluate_batch(params, kctxs)
    torch.cuda.synchronize()
    want_launches = MLP.num_layers * len(engine.eval_batches) * -(-chips // width)
    assert masked_matmul.launches_by_variant["v1"] - before[0]["v1"] == want_launches
    assert masked_matmul.fleet_launches_by_variant["v1"] - before[1]["v1"] == want_launches
    assert got == pytest.approx([evaluate_metric(engine, p, c) for p, c in zip(params, kctxs)], abs=1e-6)


def test_sharded_engine_on_one_card_repeated_matches_the_vmap_engine(cuda):
    """The sharded engine over the card repeated (a pop mesh of 4, a 2 x 2
    fleet mesh storing member params split two ways): steps to the
    constraint equal, params at the pin, kernel-mode metrics those of the
    vmap engine within 1e-6."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pop, base, fn, ctxs = _fat(cuda, "population")
    constraint = pop.evaluate_one(base, healthy()) - 0.05
    want_steps = pop.steps_to_constraint_batch(base, ctxs, constraint, 60, fn)
    want = pop.fit_batch(base, ctxs[:3], [25, 40, 10], fn)
    kctxs = [from_fault_map(random_fault_map(i, 32, 32, 0.1), "kernel", device=cuda) for i in range(3)]
    want_k = pop.evaluate_batch(want, kctxs)
    for mesh in (make_pop_mesh(devices=["cuda"] * 4), make_fleet_mesh(2, 2, devices=["cuda"] * 4)):
        shd = _fat(cuda, "sharded", base=base, mesh=mesh, cfg=MLP, param_axes=classifier_param_axes(MLP))[0]
        assert shd.steps_to_constraint_batch(base, ctxs, constraint, 60, fn) == want_steps
        got = shd.fit_batch(base, ctxs[:3], [25, 40, 10], fn)
        for g, w in zip(got, want):
            assert g["w0"].device == base["w0"].device
            for k in w:
                assert_close(g[k], w[k], torch.float32, atol_scale=100)
        assert shd.evaluate_batch(got, kctxs) == pytest.approx(want_k, abs=1e-6)
        stats = shd.last_fit_stats
        assert stats["model_extent"] == shd.model_size
        assert stats["per_member_resident_bytes"] <= stats["per_member_total_bytes"] / shd.model_size * 1.05 + 1024


def test_tensor_parallel_kernel_mode_forward_on_the_card(cuda):
    """compute="sharded" on a 2 x 2 mesh over the card repeated: a
    kernel-mode ``evaluate_batch`` launches ONE chip-batched v1 a weight
    piece (every layer split two ways) and its metrics are the
    one-chip-at-a-time loop's; each piece's launch equals
    ``masked_matmul_ref`` on the map rolled to its origin, and the pieces
    joined equal the whole weight's product under the whole map."""
    from repro_torch.core.mapping import rolled_map

    torch.backends.cuda.matmul.allow_tf32 = False
    base = init_classifier(MLP, 0, 32, "cpu")
    shd = _fat(cuda, "sharded", base=base, mesh=make_fleet_mesh(2, 2, devices=["cuda"] * 4), cfg=MLP,
               param_axes=classifier_param_axes(MLP), compute="sharded", population_size=4)[0]
    kctxs = [from_fault_map(random_fault_map(i, 32, 32, 0.1), "kernel", device=cuda) for i in range(4)]
    params = [{k: v.to(cuda) + 0.01 * i for k, v in base.items()} for i in range(4)]
    before = dict(masked_matmul.launches_by_variant), dict(masked_matmul.fleet_launches_by_variant)
    got = shd.evaluate_batch(params, kctxs)
    torch.cuda.synchronize()
    want_launches = MLP.num_layers * 2 * len(shd.eval_batches) * shd.num_shards
    assert masked_matmul.launches_by_variant["v1"] - before[0]["v1"] == want_launches
    assert masked_matmul.fleet_launches_by_variant["v1"] - before[1]["v1"] == want_launches
    assert got == pytest.approx([evaluate_metric(shd, p, c) for p, c in zip(params, kctxs)], abs=1e-6)
    ok = torch.stack([c.ok for c in kctxs[:2]])
    g = torch.Generator(device=cuda).manual_seed(0)
    for i in range(MLP.num_layers):
        w = torch.stack([p[f"w{i}"] for p in params[:2]])
        x = torch.randn(2, 512, w.shape[1], generator=g, device=cuda)
        half = w.shape[-1] // 2
        pieces = []
        for c0 in (0, half):
            piece, rolled = w[..., c0:c0 + half].contiguous(), rolled_map(ok, 0, c0)
            assert c0 % 32 != 0 or c0 == 0  # the second piece starts off the map's grid
            y = masked_matmul(x, piece, rolled)
            assert_close(y, masked_matmul_ref(x, piece, rolled), torch.float32)
            pieces.append(y)
        assert_close(torch.cat(pieces, -1), masked_matmul_ref(x, w, ok), torch.float32)


# ---------------------------------------------------------------------------
# LM training and its deployment through the kernels
# ---------------------------------------------------------------------------

SMOLLM = get_arch("smollm-135m")


def _rel_l2(got, ref):
    return float((got.float() - ref.float()).norm() / ref.float().norm())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("width", ["reduced", "full"])
def test_lm_loss_in_kernel_mode_matches_fap_on_the_card(cuda, width, dtype):
    """Every masked GEMM of a forward through the kernel (7 a layer and the
    tied unembed), against the plain ``fap`` path: float32 logits at
    ``atol_scale=50``; bf16 anchored to the plain float32 path (at most 1.5x
    the plain bf16 path's relative L2 error), the loss within bf16's rtol."""
    torch.backends.cuda.matmul.allow_tf32 = False
    base = reduce_config(SMOLLM) if width == "reduced" else SMOLLM
    cfg, cfg32 = dataclasses.replace(base, dtype=dtype), dataclasses.replace(base, dtype="float32")
    params = M.param_dict(M.init_params(cfg, 0, device=cuda))
    fm = random_fault_map(0, cfg.array_rows, cfg.array_cols, 0.1)
    ctx_k, ctx_f = from_fault_map(fm, "kernel", device=cuda), from_fault_map(fm, "fap", device=cuda)
    batch = TokenStream(cfg.vocab_size, 64, 8, seed=0, device=cuda).batch_at(1)
    before = dict(masked_matmul.launches_by_variant)
    with torch.no_grad():
        got = M.forward(params, batch, cfg, ctx_k)[0]
        torch.cuda.synchronize()
        variant = "mma" if dtype == "bfloat16" else "v1"
        assert masked_matmul.launches_by_variant[variant] - before[variant] == sum(u for _, _, u in cfg.gemm_shapes())
        ref = M.forward(params, batch, cfg, ctx_f)[0]
        loss_k, _ = M.loss_fn(params, batch, cfg, ctx_k)
        loss_f, _ = M.loss_fn(params, batch, cfg, ctx_f)
        if dtype == "float32":
            assert_close(got, ref, torch.float32, atol_scale=50)
            assert_close(loss_k, loss_f, torch.float32)
        else:
            anchor = M.forward(params, batch, cfg32, ctx_f)[0]
            assert _rel_l2(got, anchor) <= 1.5 * _rel_l2(ref, anchor)
            assert float(loss_k) == pytest.approx(float(loss_f), rel=2e-2)


def test_lm_population_step_on_the_card_matches_the_cpu(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduce_config(SMOLLM)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        params = M.param_dict(M.init_params(cfg, 0, device="cpu"))
        params = {k: v.to(dev) for k, v in params.items()}
        stream = TokenStream(cfg.vocab_size, 16, 4, seed=0, device=dev)
        engine = PopulationFATEngine(
            loss_fn=lambda p, b, ctx: M.loss_fn(p, b, cfg, ctx, remat="none"),
            opt_cfg=AdamWConfig(learning_rate=1e-3, weight_decay=0.0), eval_batches=[stream.batch_at(99)],
        )
        ctxs = [from_fault_map(random_fault_map(i, 16, 16, 0.1 * (i + 1)), device=dev) for i in range(3)]
        out[dev.type] = engine.fit_batch(params, ctxs, [2, 3, 1], stream.batch_at)
    for g, w in zip(out["cuda"], out["cpu"]):
        assert g["embed"].device.type == "cuda"
        for k in w:
            assert_close(g[k], w[k], torch.float32, atol_scale=100)


def test_lm_kernel_mode_fit_on_the_card_raises_and_kernel_eval_runs(cuda):
    cfg = reduce_config(SMOLLM)
    tr = LMFATTrainer(cfg, pretrain_steps=2, batch_size=2, seq_len=16, eval_batches=1)
    assert tr.device.type == "cuda"  # the card is the default
    fleet = [random_fault_map(i, 16, 16, 0.1) for i in range(2)]
    kctxs = [from_fault_map(fm, "kernel", device=cuda) for fm in fleet]
    with pytest.raises(NotImplementedError, match="no masked-GEMM backward"):
        tr.engine.fit_batch(tr.base_params, kctxs, [1, 1], tr._train_batch_fn)
    before = masked_matmul.launches_by_variant["v1"], masked_matmul.fleet_launches_by_variant["v1"]
    got = tr.evaluate_batch([tr.base_params] * 2, fleet, mode="kernel")
    torch.cuda.synchronize()
    # both chips in one chunk: one chip-batched launch a GEMM a forward
    per_forward = sum(u for _, _, u in cfg.gemm_shapes())
    assert masked_matmul.launches_by_variant["v1"] - before[0] == len(tr._evals) * per_forward
    assert masked_matmul.fleet_launches_by_variant["v1"] - before[1] == len(tr._evals) * per_forward
    assert got == pytest.approx(tr.evaluate_batch([tr.base_params] * 2, fleet), abs=2e-3)


# ---------------------------------------------------------------------------
# FAT of the MoE, SSM and hybrid families: the scan's training route, the
# split experts and channels
# ---------------------------------------------------------------------------


# (B, L, D, N): falcon-mamba's FAT step (one chip's rows), a ragged D and L (not a multiple of the
# backward's 8-step chunks), one state, odd and wide states, a single step; L at a chunk less one, a
# chunk and two chunks and one (no checkpoint, none, one); D of 100, three blocks of 32 channels and 4;
# and each (lanes, states) instance the plan builds (N = 1 and 2 at one lane, 4 states a lane from N =
# 4 to 128 at 1-32 lanes, 8 at 256) at a ragged L of three chunks and a D of two blocks and some
SCAN_BWD_CASES = [(8, 64, 8192, 16), (2, 37, 300, 16), (3, 20, 96, 1), (2, 19, 64, 5), (2, 24, 48, 17),
                  (1, 9, 40, 64), (2, 1, 33, 8), (2, BWD_CHUNK - 1, 96, 16), (2, BWD_CHUNK, 96, 16),
                  (2, 2 * BWD_CHUNK + 1, 96, 16), (3, 29, 100, 16)] + [
    (2, 3 * BWD_CHUNK - 3, 2 * (128 // bwd_plan(n)[0]) + 3, n) for n in (1, 2, 4, 8, 16, 32, 64, 128, 256)]


@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,d,n", SCAN_BWD_CASES)
def test_selective_scan_bwd_kernel_matches_plain_on_card(cuda, b, l, d, n, u_dtype):
    """The backward kernel against its plain version on the same inputs
    (B and C strided slices of one tensor, gh given): one launch, every
    gradient within the scan's float32 tolerance in units of its largest
    plain value (gB, gC and gA sum over D or over B x L), bf16 at the
    table's."""
    args = _scan_inputs(cuda, b, l, d, n, u_dtype, seed=b + l)
    g = torch.Generator(device=cuda).manual_seed(7)
    gy = torch.randn(b, l, d, generator=g, device=cuda).to(u_dtype)
    gh = torch.randn(b, d, n, generator=g, device=cuda)
    before = selective_scan_bwd.launches
    got = selective_scan_bwd(*args, gy, gh)
    torch.cuda.synchronize()
    assert selective_scan_bwd.launches == before + 1
    want = selective_scan_bwd_ref(*args, gy, gh)
    rtol, atol = (2e-5, 1e-4) if u_dtype == torch.float32 else dtype_tol(torch.bfloat16)
    for name, x, w, t in zip(("gu", "gdt", "ga", "gb", "gc", "gd"), got, want, args):
        assert x.shape == t.shape and x.dtype == t.dtype, name
        scale = max(float(w.float().abs().max()), 1.0)
        torch.testing.assert_close(x.float() / scale, w.float() / scale, rtol=rtol, atol=atol, msg=name)


@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_bwd_takes_unaligned_slices(cuda, u_dtype):
    """u a slice of a wider tensor, B and C slices starting at an odd
    element (2-byte copies in bf16), and no gh."""
    g = torch.Generator(device=cuda).manual_seed(6)
    b, l, d, n = 2, 27, 96, 16
    xz = torch.randn(b, l, 2 * d, generator=g, device=cuda).to(u_dtype)
    u = xz[..., :d]
    dt = torch.nn.functional.softplus(torch.randn(b, l, d, generator=g, device=cuda) - 3.0)
    a = -torch.exp(torch.randn(d, n, generator=g, device=cuda))
    dbc = torch.randn(b, l, 3 + 2 * n, generator=g, device=cuda).to(u_dtype)
    _, bm, cm = torch.split(dbc, [3, n, n], dim=-1)
    assert bm.storage_offset() % 2 == 1 and cm.storage_offset() % 2 == 1
    d_skip = torch.randn(d, generator=g, device=cuda)
    gy = torch.randn(b, l, d, generator=g, device=cuda).to(u_dtype)
    got = selective_scan_bwd(u, dt, a, bm, cm, d_skip, gy, None)
    torch.cuda.synchronize()
    want = selective_scan_bwd_ref(u, dt, a, bm, cm, d_skip, gy, None)
    rtol, atol = (2e-5, 1e-4) if u_dtype == torch.float32 else dtype_tol(torch.bfloat16)
    for name, x, w in zip(("gu", "gdt", "ga", "gb", "gc", "gd"), got, want):
        scale = max(float(w.float().abs().max()), 1.0)
        torch.testing.assert_close(x.float() / scale, w.float() / scale, rtol=rtol, atol=atol, msg=name)


@pytest.mark.parametrize("chip_axis", [False, True])
def test_selective_scan_bwd_is_deterministic(cuda, chip_axis):
    """Two launches give the same bits: every sum over channels, blocks,
    steps and rows is taken in a fixed order, with no atomics."""
    u, dt, a, bm, cm, d_skip = _scan_inputs(cuda, 8, 64, 8192, 16, torch.float32, seed=9)
    if chip_axis:  # 2 chips x 4 rows, each chip's own A and D
        a, d_skip = torch.stack([a, 1.1 * a]), torch.stack([d_skip, d_skip + 0.1])
    g = torch.Generator(device=cuda).manual_seed(10)
    gy = torch.randn(8, 64, 8192, generator=g, device=cuda)
    gh = torch.randn(8, 8192, 16, generator=g, device=cuda)
    first = selective_scan_bwd(u, dt, a, bm, cm, d_skip, gy, gh)
    second = selective_scan_bwd(u, dt, a, bm, cm, d_skip, gy, gh)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("shared", [False, True])
def test_selective_scan_bwd_kernel_takes_a_chip_axis(cuda, shared):
    """A chip axis (3 chips x 2 rows; each chip's own A and D, or one for
    every chip through chip stride 0): one launch, counted as a fleet
    launch, against the plain version; gA and gD come out one a chip."""
    u, dt, a, bm, cm, d_skip = _scan_inputs(cuda, 6, 21, 80, 16, torch.float32, seed=3)
    if shared:
        a3, d3 = a.expand(3, *a.shape), d_skip.expand(3, *d_skip.shape)
    else:
        scale = 1 + 0.1 * torch.arange(3, device=cuda, dtype=torch.float32)
        a3, d3 = (a[None] * scale[:, None, None]).contiguous(), (d_skip[None] + scale[:, None]).contiguous()
    gy = torch.randn(6, 21, 80, generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    before = selective_scan_bwd.fleet_launches
    got = selective_scan_bwd(u, dt, a3, bm, cm, d3, gy, None)
    torch.cuda.synchronize()
    assert selective_scan_bwd.fleet_launches == before + 1
    want = selective_scan_bwd_ref(u, dt, a3, bm, cm, d3, gy, None)
    assert got[2].shape == (3, 80, 16) and got[5].shape == (3, 80)
    for x, w in zip(got, want):
        scale = max(float(w.abs().max()), 1.0)
        torch.testing.assert_close(x / scale, w / scale, rtol=2e-5, atol=1e-4)


def test_differentiated_scan_launches_the_backward_kernel_on_the_card(cuda):
    """A scan that asks for a gradient on the card (plain autograd,
    ``torch.func.grad``, and ``vmap`` of ``grad`` over two members) launches
    the forward kernel and the backward kernel once each (chip-batched
    under ``vmap``), and gives the CPU plain version's gradients for every
    input. On the parent tree plain autograd left every input but C without
    a gradient and ``torch.func.grad`` raised (no data pointer)."""
    ins = _scan_inputs(cuda, 2, 40, 96, 16, torch.float32, seed=4)
    cpu_ins = [t.cpu() for t in ins]

    def loss(*ts):
        y, h = selective_scan(*ts)
        return y.square().sum() + h.sum()

    def plain_grads(ts):
        leaves = [t.clone().requires_grad_() for t in ts]
        return torch.autograd.grad(loss(*leaves), leaves)

    def counts():
        torch.cuda.synchronize()
        return (selective_scan.launches, selective_scan_bwd.launches, selective_scan.fleet_launches,
                selective_scan_bwd.fleet_launches)

    want = plain_grads(cpu_ins)
    start = counts()
    got = plain_grads(ins)
    got_func = torch.func.grad(loss, argnums=tuple(range(6)))(*ins)
    assert [x - y for x, y in zip(counts(), start)] == [2, 2, 0, 0]
    for g, gf, w in zip(got, got_func, want):
        scale = max(float(w.abs().max()), 1.0)
        torch.testing.assert_close(g.cpu() / scale, w / scale, rtol=2e-5, atol=1e-4)
        torch.testing.assert_close(gf.cpu() / scale, w / scale, rtol=2e-5, atol=1e-4)
    us = torch.stack([ins[0], 0.5 * ins[0]])
    a2 = torch.stack([ins[2], 1.1 * ins[2]])
    start = counts()
    got_v = torch.func.vmap(torch.func.grad(lambda u, a: loss(u, ins[1], a, *ins[3:]), argnums=(0, 1)))(us, a2)
    assert [x - y for x, y in zip(counts(), start)] == [1, 1, 1, 1]
    for i in range(2):
        w = plain_grads([us[i].cpu(), cpu_ins[1], a2[i].cpu(), *cpu_ins[3:]])
        for g, wi in zip(got_v, (w[0], w[2])):
            scale = max(float(wi.abs().max()), 1.0)
            torch.testing.assert_close(g[i].cpu() / scale, wi / scale, rtol=2e-5, atol=1e-4)


def _split_leaf(w, axis, pieces):
    from repro_torch.fleet.tensor_parallel import SplitTensor

    size = w.shape[axis] // pieces
    offsets = list(range(0, w.shape[axis], size))
    return SplitTensor([w.narrow(axis, o, size).contiguous() for o in offsets], axis, offsets)


@pytest.mark.parametrize("m", [2, 4])
def test_channel_split_ssm_block_runs_a_chip_batched_scan_a_piece(cuda, m):
    """The reduced falcon-mamba block with every ``"inner"`` leaf split m
    ways (a 24 x 40 map: the pieces start off its grid), in ``kernel`` mode
    under ``vmap`` over two chips (member-stacked params, as the sharded
    engine hands them over): one chip-batched scan launch a channel piece
    and one chip-batched GEMM launch a weight piece, against each chip's
    whole block in ``fap`` mode on the CPU."""
    from types import SimpleNamespace

    from repro_torch.core import FaultContext
    from repro_torch.models.ssm import ssm_block

    cfg = reduce_config(get_arch("falcon-mamba-7b"))
    flat = M.param_dict(M.init_params(cfg, 3, device="cpu"))
    p = {k.rsplit(".", 1)[-1]: v for k, v in flat.items() if k.startswith("layers.0.ssm.")}
    axes = {"in_proj": -1, "conv_w": -1, "conv_b": -1, "x_proj": -2, "dt_w": -1, "dt_b": -1, "a_log": -2,
            "d_skip": -1, "out_proj": -2}
    members = {k: torch.stack([v, v * 1.1]).to(cuda) for k, v in p.items()}  # chip 1's leaves set apart
    split = {k: _split_leaf(v, axes[k], m) for k, v in members.items()}
    oks = [torch.from_numpy(random_fault_map(c, 24, 40, 0.15).ok_mask) for c in range(2)]
    x = torch.randn(2, 4, 16, cfg.d_model, generator=torch.Generator().manual_seed(0))
    scans, fleet_scans, gemms = selective_scan.launches, selective_scan.fleet_launches, masked_matmul.launches

    def member(q, xm, ok):
        return ssm_block(SimpleNamespace(**q), xm, cfg, FaultContext(ok=ok, mode="kernel"))[0]

    with torch.no_grad():
        got = torch.func.vmap(member)(split, x.to(cuda), torch.stack(oks).to(cuda))
    torch.cuda.synchronize()
    assert selective_scan.launches - scans == selective_scan.fleet_launches - fleet_scans == m
    assert masked_matmul.launches - gemms == 4 * m  # in_proj, x_proj, dt_w, out_proj: m pieces each
    for c in range(2):
        q = {k: v[c].cpu() for k, v in members.items()}
        want = ssm_block(SimpleNamespace(**q), x[c], cfg, FaultContext(ok=oks[c], mode="fap"))[0]
        assert_close(got[c], want, torch.float32)


@pytest.mark.parametrize("spec", ["ecd,edf->ecf", "ecf,efd->ecd"])
def test_chips_x_experts_launch_on_an_expert_piece_matches_plain(cuda, spec):
    """A stack split over its experts (2 of 8 a piece) for 3 chips in
    ``kernel`` mode under ``vmap``: one chips x experts launch a piece, each
    under its chip's whole map, joined against the whole stack's launch and
    each piece against its plain version."""
    from repro_torch.core import FaultContext, fault_einsum

    x, w, ok = _chips_x_experts(cuda, 3, 8, 40, False, torch.float32, torch.float32, seed=5)
    if spec == "ecf,efd->ecd":
        w = w.transpose(-1, -2).contiguous()
        x = torch.randn(3, 8, 40, 288, generator=torch.Generator(device=cuda).manual_seed(6), device=cuda)
    split = _split_leaf(w, -3, 4)

    def member(x_, w_, ok_):
        return fault_einsum(spec, x_, w_, FaultContext(ok_, "kernel"))

    launches = masked_matmul.launches
    both = sum(masked_matmul.fleet_expert_launches_by_variant.values())
    got = torch.func.vmap(member)(x, split, ok)
    torch.cuda.synchronize()
    assert masked_matmul.launches - launches == sum(masked_matmul.fleet_expert_launches_by_variant.values()) - both == 4
    assert_close(got, torch.func.vmap(member)(x, w, ok), torch.float32)
    for piece, o in zip(split.pieces, split.offsets):
        xs = x[:, o:o + 2].contiguous()
        assert_close(masked_matmul(xs, piece, ok), masked_matmul_ref(xs, piece, ok), torch.float32)


@pytest.mark.parametrize("engine", ["population", "sharded-tp"])
@pytest.mark.parametrize("name", ["mixtral-8x22b", "llama4-maverick-400b-a17b", "falcon-mamba-7b", "hymba-1.5b"])
def test_family_fat_on_the_card_matches_the_cpu(cuda, name, engine):
    """The reduced family's FAT on the card (the population engine, or
    ``compute="sharded"`` on 2 x 4 over the card repeated) against the
    population engine on the CPU from the same params and batches: params
    within ``dtype_tol(float32, atol_scale=100)``; in the fit as many
    backward scan launches as forward ones (some for the SSM families,
    none for the MoE), then ``kernel``-mode evaluation within 2e-3 of
    ``fap``."""
    cfg = reduce_config(get_arch(name))
    fleet = [random_fault_map(c, 24, 40, 0.1 * (c + 1)) for c in range(4)]
    kw = {} if engine == "population" else dict(engine="sharded", engine_kwargs=dict(
        mesh=make_fleet_mesh(2, 4, devices=["cuda"] * 8), compute="sharded"))
    host = LMFATTrainer(cfg, pretrain_steps=3, batch_size=4, seq_len=16, device="cpu")
    card = LMFATTrainer(cfg, pretrain_steps=0, batch_size=4, seq_len=16, **kw)
    card.base_params = {k: v.to(cuda) for k, v in host.base_params.items()}
    scans, bwds = selective_scan.launches, selective_scan_bwd.launches
    got = card.train_batch(fleet, [3, 1, 2, 2])
    torch.cuda.synchronize()
    ran = selective_scan.launches - scans
    assert ran == selective_scan_bwd.launches - bwds and (ran > 0) == cfg.has_ssm
    want = host.train_batch(fleet, [3, 1, 2, 2])
    for g, w in zip(got, want):
        for k in w:
            assert_close(g[k], w[k], torch.float32, atol_scale=100)
    fap = card.evaluate_batch(got, fleet)
    assert card.evaluate_batch(got, fleet, mode="kernel") == pytest.approx(fap, abs=2e-3)
    assert fap == pytest.approx(host.evaluate_batch(want, fleet), abs=2e-3)


# ---------------------------------------------------------------------------
# Continuous serving: the ABFT probe GEMM, the paged decode, the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,m", [(torch.bfloat16, 4), (torch.bfloat16, 256), (torch.float32, 4)])
def test_checksummed_gemm_repeats_its_bits_and_matches_plain(cuda, dtype, m):
    """The probe GEMMs at SmolLM-135M's probe weight (``wd``, 1536 x 576, the
    fp32 master): the canary (M = 4 + 1, ``decode``) and the structured
    probe (M = 256 + 1, ``mma``) in bf16, ``v1`` in float32. Two launches
    give the same bits (the canary compares bits), and both outputs match
    the plain version at ``dtype_tol``."""
    gen = torch.Generator().manual_seed(m)
    x = torch.randn(m, 1536, generator=gen).to(cuda, dtype)
    w = (torch.randn(1536, 576, generator=gen) / 1536**0.5).to(cuda)
    ok = from_fault_map(random_fault_map(0, 256, 256, 0.1), "kernel", device=cuda).ok
    y, chk = masked_matmul_checksummed(x, w, ok)
    y2, chk2 = masked_matmul_checksummed(x, w, ok)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(chk, chk2)
    assert torch.equal(y, masked_matmul(x, w, ok))
    ry, rchk = masked_matmul_checksummed(x.cpu(), w.cpu(), ok.cpu())
    assert_close(y, ry, dtype)
    assert_close(chk, rchk, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_step_in_kernel_mode_matches_fap_on_the_card(cuda, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduce_config(SMOLLM), dtype=dtype)
    params = M.init_params(cfg, 0, device=cuda)
    fm = random_fault_map(1, 16, 16, 0.1)
    gen = torch.Generator().manual_seed(2)
    L, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    pool = torch.randn(2, L, 24, hkv, 4, hd, generator=gen).to(cuda, getattr(torch, dtype))
    tables = torch.tensor([[3, 7, 9, 0], [4, 0, 0, 0], [11, 2, 5, 6], [8, 10, 0, 0]], dtype=torch.int32)
    active = torch.tensor([True, False, True, True], device=cuda)
    outs = {}
    for mode in ("kernel", "fap"):
        cache = dict(k_pages=pool[0].clone(), v_pages=pool[1].clone(), block_tables=tables.to(cuda),
                     seq_lens=torch.tensor([6, 1, 12, 0], dtype=torch.int32, device=cuda))
        toks = torch.randint(0, cfg.vocab_size, (4, 1), generator=torch.Generator().manual_seed(3)).to(cuda)
        outs[mode] = M.decode_step(params, toks, cache, cfg, from_fault_map(fm, mode, device=cuda), active=active)
    (got, gc), (ref, rc) = outs["kernel"], outs["fap"]
    assert_close(got, ref, getattr(torch, dtype))
    assert torch.equal(gc["seq_lens"], rc["seq_lens"]) and gc["seq_lens"].tolist() == [7, 1, 13, 1]
    for key in ("k_pages", "v_pages"):
        assert_close(gc[key][:, 1:], rc[key][:, 1:], getattr(torch, dtype))


def test_continuous_engine_on_the_card_pinned_to_the_static_engine(cuda):
    """Reduced SmolLM in float32 ``kernel`` mode: packed, chunked and
    mid-flight admissions give the static engine's tokens, and every
    masked GEMM runs ``v1``."""
    from repro_torch.serve import ContinuousBatchingEngine, Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduce_config(SMOLLM)
    params = M.init_params(cfg, 0, device=cuda)
    ctx = from_fault_map(random_fault_map(0, 16, 16, 0.1), "kernel", device=cuda)
    rng = np.random.default_rng(0)
    spec = [(6, 5, 0), (13, 4, 0), (40, 6, 0), (3, 5, 2), (5, 4, 0), (21, 7, 3), (9, 3, 5)]
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n), b, a) for i, (n, b, a) in enumerate(spec)]
    eng = ContinuousBatchingEngine(cfg, params, ctx, num_slots=2, page_size=4, num_pages=64,
                                   prefill_buckets=(8, 16), chunk_size=8, max_pack=2, probe_every=2)
    assert eng.warmup() == 4
    before = dict(masked_matmul.launches_by_variant)
    outs, stats = eng.serve(reqs)
    torch.cuda.synchronize()
    grew = {k: masked_matmul.launches_by_variant[k] - before[k] for k in before}
    assert grew["decode"] == grew["mma"] == 0 and grew["v1"] > 0
    assert eng.compile_counts()["jit_fallback"] == 0 and stats.chunk_dispatches == 8
    assert eng.health.detections == 0
    static = ServeEngine(cfg, params, ctx, max_len=None, page_size=4)
    for r in reqs:
        res = static.generate(torch.as_tensor(r.tokens, device=cuda)[None].long(), max_new_tokens=r.max_new_tokens)
        assert np.array_equal(outs[r.rid].tokens, res.tokens[0, len(r.tokens):].cpu().numpy()), r.rid


# ---------------------------------------------------------------------------
# fleets of every family, and the examples, on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "hymba-1.5b", "mixtral-8x22b", "internvl2-26b"])
def test_fleet_of_every_family_on_the_card_matches_its_chips_engines(cuda, name):
    """Reduced configs in float32 ``kernel`` mode, 3 chips (chip 0 healthy):
    each chip's tokens and logprobs are its own ``ServeEngine``'s; every
    masked GEMM is one chip-batched launch (an MoE layer's expert GEMMs one
    chips x experts launch each) and every prefill scan one chip-batched
    launch."""
    from repro_torch.fleet import FleetServeEngine
    from repro_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduce_config(get_arch(name))
    params = [M.init_params(cfg, i, device=cuda) for i in range(3)]
    ctxs = [healthy()] + [from_fault_map(random_fault_map(i, 16, 16, 0.2 * i), "kernel", device=cuda) for i in (1, 2)]
    prompts = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)), device=cuda)
    eng = FleetServeEngine(cfg, params, ctxs, max_len=24)
    launches, scans = masked_matmul.launches, selective_scan.fleet_launches
    fleet = sum(masked_matmul.fleet_launches_by_variant.values())
    both = sum(masked_matmul.fleet_expert_launches_by_variant.values())
    out = eng.generate(prompts, max_new_tokens=6)
    torch.cuda.synchronize()
    # a text prompt runs no frontend (the vision patches' GEMM, first in gemm_shapes)
    per_step = sum(u for _, _, u in cfg.gemm_shapes()[cfg.modality in FRONTEND_DIMS:])
    experts = 3 * cfg.num_layers * 7 if cfg.has_moe else 0
    assert masked_matmul.launches - launches == per_step * 7
    assert sum(masked_matmul.fleet_expert_launches_by_variant.values()) - both == experts
    assert sum(masked_matmul.fleet_launches_by_variant.values()) - fleet == per_step * 7 - experts
    assert selective_scan.fleet_launches - scans == (cfg.num_layers if cfg.has_ssm else 0)
    for i in range(3):
        ref = ServeEngine(cfg, params[i], ctxs[i], max_len=24, prefill_buckets=None).generate(prompts, max_new_tokens=6)
        toks, lps = out.chip(i)
        assert torch.equal(toks, ref.tokens), i
        assert_close(lps, ref.logprobs, torch.float32, atol_scale=50.0)


def test_quickstart_example_runs_on_the_card(cuda):
    from repro_torch.examples import quickstart

    launches = masked_matmul.launches
    out = quickstart.run(cuda, "kernel", log=lambda *a: None)
    assert masked_matmul.launches > launches  # the faulty chip's evaluations ran the kernel
    assert len(out["pretrain"]) == quickstart.PRETRAIN_STEPS and len(out["fat"]) == quickstart.FAT_STEPS
    assert out["acc_faulty"] < out["acc0"] and out["acc_fat"] > out["acc_faulty"]


def test_serve_faulty_chip_example_runs_on_the_card(cuda):
    from repro_torch.examples import serve_faulty_chip

    launches = masked_matmul.launches
    out = serve_faulty_chip.run(cuda, "kernel", log=lambda *a: None)
    assert masked_matmul.launches > launches
    assert out["stats"].decode_dispatches < out["static_dispatches"]
    assert len(out["ties"]) <= 1  # a near-tie may fall the other way on the card, not many


def test_fleet_retraining_example_runs_on_the_card(cuda, capsys):
    from repro_torch.examples import fleet_retraining

    assert fleet_retraining.main(["--chips", "8"]) == 0
    out = capsys.readouterr().out
    assert "on cuda" in out and "eFAT " in out and "individual " in out
