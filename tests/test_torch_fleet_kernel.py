"""The masked GEMM with a chip axis, on the CPU: its plain version for a
stack of chips against one chip at a time and against the reference's Pallas
kernel under ``jax.vmap`` (interpret mode, whose batching rule adds the chip
axis to the kernel's grid); the custom op's vmap rule that the fleet engines
reach it through; a plain emulation of the chip-batched launch's split-K
layout (every chip's own counters and scratch); and the mask packing that
repacks only the chip whose mask changed.

The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``).
Tolerances: ``dtype_tol`` of the dtype (bf16 rtol 2e-2 / atol 2e-1,
float32 rtol 2e-5 / atol 2e-4); the emulated split-K merge bit for bit
across block orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.masked_matmul.ops import masked_matmul as jax_masked_matmul
from repro_torch.core import random_fault_map
from repro_torch.core.mapping import periodic_mask
from repro_torch.core.masking import FaultContext, fault_linear
from repro_torch.kernels.common import assert_close
from repro_torch.kernels.masked_matmul import ops
from repro_torch.kernels.masked_matmul.ops import (
    _split_plan,
    _v1_tiles,
    masked_matmul,
    masked_matmul_ref,
    packed_mask,
)

CHIPS = 3
K, N, R, C = 48, 40, 16, 16


def _inputs(m, dtype, seed=0):
    """x (chips, m, K), fp32 w (chips, K, N), masks (chips, R, C): chip 0
    healthy, the others faulty."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((CHIPS, m, K)).astype(np.float32)
    w = rng.standard_normal((CHIPS, K, N)).astype(np.float32)
    ok = np.stack([random_fault_map(c, R, C, 0.2 * c).ok_mask for c in range(CHIPS)]).astype(np.float32)
    return torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype), torch.from_numpy(ok)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 17, 64])
def test_chip_batched_plain_version_matches_one_chip_at_a_time_and_the_vmapped_reference(m, dtype):
    x, w, ok = _inputs(m, dtype, seed=m)
    got = masked_matmul_ref(x, w, ok)
    assert got.shape == (CHIPS, m, N) and got.dtype == dtype
    for c in range(CHIPS):
        assert_close(got[c], masked_matmul_ref(x[c], w[c], ok[c]), dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx, jw = (jnp.asarray(t.float().numpy(), dtype=jdt) for t in (x, w))
    kern = jax.vmap(lambda a, b, o: jax_masked_matmul(a, b, o, interpret=True))(jx, jw, jnp.asarray(ok.numpy()))
    assert_close(got, np.asarray(kern.astype(jnp.float32)), dtype)


def test_chip_batched_plain_version_takes_a_shared_weight_and_leading_dims():
    x, w, ok = _inputs(4, torch.float32)
    shared = w[0].expand(CHIPS, K, N)  # chip stride 0, as the kernel reads it
    assert_close(masked_matmul_ref(x, shared, ok), torch.stack([masked_matmul_ref(x[c], w[0], ok[c])
                                                                for c in range(CHIPS)]), torch.float32)
    x4 = x.reshape(CHIPS, 2, 2, K)
    assert masked_matmul(x4, w, ok).shape == (CHIPS, 2, 2, N)
    assert_close(masked_matmul(x4, w, ok).reshape(CHIPS, 4, N), masked_matmul_ref(x, w, ok), torch.float32)


def test_periodic_mask_of_a_stack_is_each_chips_mask():
    _, w, ok = _inputs(1, torch.float32)
    stacked = periodic_mask(w.shape, ok)
    for c in range(CHIPS):
        assert torch.equal(stacked[c], periodic_mask(w.shape[1:], ok[c]))


@pytest.mark.parametrize("in_dims", [(0, 0, 0), (0, None, None), (0, None, 0), (None, 0, 0), (1, 2, 0)])
def test_vmap_rule_makes_one_chip_batched_call(in_dims, monkeypatch):
    """``torch.func.vmap`` of the wrapper reaches the plain version once,
    with the mapped axis as the chip axis (a weight and mask shared by every
    member fold the members into M instead), and matches the member-wise
    products."""
    x, w, ok = _inputs(4, torch.float32, seed=3)
    args = [x, w, ok]
    for i, d in enumerate(in_dims):
        if d is None:
            args[i] = args[i][0]
        elif d:
            args[i] = args[i].movedim(0, d).contiguous() if i == 2 else args[i].movedim(0, d)
    calls = []
    ref = ops.masked_matmul_ref

    def spy(a, b, o):
        calls.append((a.dim(), b.dim(), o.dim()))
        return ref(a, b, o)

    monkeypatch.setattr(ops, "masked_matmul_ref", spy)
    got = torch.func.vmap(masked_matmul, in_dims=in_dims)(*args)
    assert len(calls) == 1
    member = lambda t, d, c: t if d is None else t.movedim(d, 0)[c]
    for c in range(CHIPS):
        want = ref(*(member(t, d, c) for t, d in zip(args, in_dims)))
        assert_close(got[c], want, torch.float32)


def test_kernel_mode_fault_linear_under_vmap_reaches_the_custom_op(monkeypatch):
    x, w, ok = _inputs(4, torch.float32, seed=4)
    seen = []
    real = torch.ops.repro_torch.masked_matmul

    class Spy:
        def __call__(self, *a):
            seen.append(tuple(t.shape for t in a[:3]))
            return real(*a)

    monkeypatch.setattr(torch.ops.repro_torch, "masked_matmul", Spy())
    got = torch.func.vmap(lambda a, b, o: fault_linear(a, b, FaultContext(ok=o, mode="kernel")))(x, w, ok)
    assert len(seen) == 1
    for c in range(CHIPS):
        assert_close(got[c], masked_matmul_ref(x[c], w[c], ok[c]), torch.float32)
    # outside vmap a stacked context is still refused
    with pytest.raises(ValueError, match="vmap"):
        fault_linear(x[0], w[0], FaultContext(ok=ok, mode="kernel"))


# ---------------------------------------------------------------------------
# A plain emulation of the chip-batched launch's split-K layout
# ---------------------------------------------------------------------------


def _emulate_launch(x, wm, bm, bn, bk, splits, order_seed):
    """v1's tiled kernel's grid for a stack of chips, run block by block in
    a random order, with csrc/masked_matmul.cu's layout: grid (output tiles,
    chips, splits); block (bx, by, bz) is chip by; its counter is
    counters[by * grid.x + bx] and its partial sits at
    part[((chip * splits + bz) * M + m) * N + n]. The last block of a tile to
    arrive sums the slices in slice order. Returns (y, counters, scratch
    slots each chip wrote)."""
    chips, m, k = x.shape
    n = wm.shape[2]
    mt, nt = -(-m // bm), -(-n // bn)
    tiles_k = -(-k // bk)
    per = -(-tiles_k // splits)
    counters = np.zeros(chips * mt * nt, np.int64)
    tiles = mt * nt
    part = np.full(chips * splits * m * n, np.nan, np.float32)
    writers = [set() for _ in range(chips)]
    y = np.zeros((chips, m, n), np.float32)
    blocks = [(bx, by, bz) for bx in range(tiles) for by in range(chips) for bz in range(splits)]
    for i in np.random.default_rng(order_seed).permutation(len(blocks)):
        bx, by, bz = blocks[i]
        chip, m0, n0 = by, (bx % mt) * bm, bx // mt * bn
        k0, k1 = bz * per * bk, min(k, (bz + 1) * per * bk)
        rows, cols = slice(m0, min(m, m0 + bm)), slice(n0, min(n, n0 + bn))
        acc = x[chip, rows, k0:k1] @ wm[chip, k0:k1, cols] if k1 > k0 else 0.0
        base = (chip * splits + bz) * m * n
        for mi in range(rows.start, rows.stop):
            for ni in range(cols.start, cols.stop):
                slot = base + mi * n + ni
                part[slot] = acc[mi - m0, ni - n0] if k1 > k0 else 0.0
                writers[chip].add(slot)
        tile = by * tiles + bx
        counters[tile] += 1
        if counters[tile] == splits:  # the last slice of this tile: merge in slice order
            for mi in range(rows.start, rows.stop):
                for ni in range(cols.start, cols.stop):
                    s = np.float32(0)
                    for z in range(splits):
                        s = np.float32(s + part[((chip * splits + z) * m + mi) * n + ni])
                    y[chip, mi, ni] = s
            counters[tile] = 0  # left zeroed for the next launch
    return y, counters, writers


@pytest.mark.parametrize("m", [1, 17])
@pytest.mark.parametrize("splits", [1, 2, 3])
def test_emulated_chip_batched_split_k_keeps_each_chips_counters_and_scratch(m, splits):
    x, w, ok = _inputs(m, torch.float32, seed=10 + m)
    wm = (w * periodic_mask(w.shape, ok)).numpy()
    bm, bn, bk = _v1_tiles(m, N)
    bk = 8  # short K tiles, so three slices exist at K = 48
    y1, counters, writers = _emulate_launch(x.numpy(), wm, bm, bn, bk, splits, order_seed=1)
    y2, _, _ = _emulate_launch(x.numpy(), wm, bm, bn, bk, splits, order_seed=2)
    assert np.array_equal(y1, y2)  # slice order, whatever order the blocks finish in
    assert not counters.any()
    span = splits * m * N
    for c in range(CHIPS):  # each chip's partials in its own span of the scratch
        assert writers[c] and min(writers[c]) >= c * span and max(writers[c]) < (c + 1) * span
    assert_close(torch.from_numpy(y1), masked_matmul_ref(x, w, ok), torch.float32)


@pytest.mark.parametrize("m,k,n", [(4, 576, 576), (4, 576, 49152), (512, 576, 1536), (8, 1536, 576)])
@pytest.mark.parametrize("chips", [1, 3, 8])
def test_v1_split_plan_counts_every_chips_tiles(m, k, n, chips):
    """v1's plan for a stack counts one split-K counter per tile of every
    chip (from the shared buffer), and the scratch holds every chip's
    slices' partials. At M <= 16 the K split fills about two blocks per SM
    over all chips' tiles, so more chips get no more slices; above it the
    tiles of the last, partly filled wave are cut only where that ends the
    launch sooner (``ops._waves``, in tile-waves of two blocks per SM, each
    slice costing ``_SLICE_COST``)."""
    sms = 132
    splits, scratch, tiles_out, split_tiles = _split_plan(m, n, k, sms, chips)
    bm, bn, bk = _v1_tiles(m, n)
    tiles = chips * -(-m // bm) * -(-n // bn)
    tiles_k = -(-k // bk)
    assert tiles_out == tiles
    assert 1 <= splits <= tiles_k
    if splits == 1:
        assert scratch == 0
    else:  # every chip's split tiles (all of them below one wave) hold their slices' partials
        assert split_tiles == (tiles // chips if tiles < 2 * sms else -(-(tiles % (2 * sms)) // chips))
        assert scratch == 4 * splits * chips * (m * n if m <= 16 else split_tiles * bm * bn)
    if m <= 16:
        assert splits == 1 or chips * split_tiles * (splits - 1) < 2 * sms  # only while the card is not full
        assert splits <= _split_plan(m, n, k, sms, 1)[0]  # more chips, no more slices
    else:
        cut = chips * -(-(tiles % (2 * sms)) // chips)
        sooner = ops._waves(cut * splits, 2 * sms, splits) + ops._SLICE_COST * splits
        assert sooner <= ops._waves(cut, 2 * sms, 1) + ops._SLICE_COST if cut else splits == 1
        assert splits == 1 or tiles_k // splits >= 8


# ---------------------------------------------------------------------------
# Mask packing for a stack
# ---------------------------------------------------------------------------


def test_packed_mask_of_a_stack_repacks_only_the_changed_chip():
    ok = torch.stack([torch.from_numpy(random_fault_map(c, 256, 256, 0.1).ok_mask) for c in range(4)])
    before = packed_mask.chips_packed
    bits, bits_t = packed_mask(ok)
    assert packed_mask.chips_packed == before + 4
    assert bits.shape == (4, 256, 32) and bits_t.shape == (4, 256, 32)
    for c in range(4):
        assert torch.equal(bits[c], ops._pack_bits(ok[c])) and torch.equal(bits_t[c], ops._pack_bits(ok[c].T))
    assert packed_mask(ok)[0] is bits  # cached while unchanged
    new = torch.from_numpy(random_fault_map(9, 256, 256, 0.3).ok_mask)
    ok[2].copy_(new)  # set_silicon on chip 2
    again, again_t = packed_mask(ok)
    assert packed_mask.chips_packed == before + 5
    assert again is not bits
    assert torch.equal(again[2], ops._pack_bits(new)) and torch.equal(again_t[2], ops._pack_bits(new.T))
    for c in (0, 1, 3):
        assert torch.equal(again[c], bits[c]) and torch.equal(again_t[c], bits_t[c])
    assert packed_mask(ok)[0] is again
    ok[1, 0, 0] = 0.5
    with pytest.raises(ValueError, match="0/1"):
        packed_mask(ok)
