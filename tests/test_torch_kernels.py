"""The port's masked GEMM and flash attention against the reference package.

The same numpy inputs go through the reference's oracle, its Pallas kernel
in interpret mode, and the port's wrapper on a CPU tensor (its plain
PyTorch version). The CUDA kernels themselves are held to the plain versions
on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.faults import random_fault_map as jax_random_fault_map
from repro.core.masking import FaultContext as JaxFaultContext
from repro.core.masking import fault_linear as jax_fault_linear
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.masked_matmul.ops import masked_matmul as jax_masked_matmul
from repro.kernels.masked_matmul.ref import masked_matmul_ref as jax_masked_matmul_ref
from repro_torch.convert import context_from_ok
from repro_torch.core.masking import fault_linear
from repro_torch.kernels.common import assert_close
from repro_torch.kernels.flash_attention.ops import attention_ref, flash_attention
from repro_torch.kernels.masked_matmul.ops import (
    _pack_bits,
    _split_plan,
    masked_matmul,
    masked_matmul_ref,
    pick_variant,
)

F32 = torch.float32
BF16 = torch.bfloat16


def _ok(seed, rate=0.3, r=16, c=16):
    return jax_random_fault_map(seed, r, c, rate).ok_mask


# ---------------------------------------------------------------------------
# masked GEMM
# ---------------------------------------------------------------------------

MM_CASES = [  # (M, K, N, w given as a transposed view)
    (5, 48, 40, False),
    (5, 48, 97, False),  # vocab-like ragged N
    (3, 33, 16, False),  # K not a multiple of the period
    (5, 48, 97, True),  # tied-unembed layout: w = embed.T
]


@pytest.mark.parametrize("m,k,n,transposed", MM_CASES)
def test_masked_matmul_plain_matches_reference_and_pallas(m, k, n, transposed):
    rng = np.random.default_rng(m * 1000 + n)
    x = rng.standard_normal((m, k), np.float32)
    w = rng.standard_normal((k, n), np.float32)
    ok = _ok(n)
    w_t = torch.from_numpy(np.ascontiguousarray(w.T)).T if transposed else torch.from_numpy(w)
    assert w_t.is_contiguous() != transposed
    got = masked_matmul(torch.from_numpy(x), w_t, torch.from_numpy(ok))
    assert got.shape == (m, n) and got.dtype == F32
    ref = jax_masked_matmul_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ok))
    kern = jax_masked_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ok), interpret=True)
    assert_close(got, np.asarray(ref), F32)
    assert_close(got, np.asarray(kern), F32)


@pytest.mark.parametrize("m,k,n", [(4, 576, 576), (4, 1536, 576), (4, 576, 49152), (512, 576, 192),
                                   (8192, 576, 576), (3, 33, 16)])
def test_split_k_plan_fills_the_card_without_empty_slices(m, k, n):
    splits, scratch_bytes = _split_plan(m, n, k, 132)
    bm, bk = (16, 32) if m <= 16 else (64, 16)
    tiles_out, tiles_k = -(-m // bm) * -(-n // 64), -(-k // bk)
    per = -(-tiles_k // splits)
    assert 1 <= splits <= tiles_k and (splits - 1) * per < tiles_k
    if splits == 1:
        assert scratch_bytes == 0 and (tiles_out >= 264 or tiles_k == 1)
    else:
        assert tiles_out * splits >= min(264, tiles_out * tiles_k) // 2
        assert scratch_bytes >= 4 * tiles_out + 4 * splits * m * n


def test_masked_matmul_leading_dims_and_healthy_mask():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 3, 48), np.float32))
    w = torch.from_numpy(rng.standard_normal((48, 40), np.float32))
    y = masked_matmul(x, w, torch.ones(16, 16))
    assert y.shape == (2, 3, 40)
    assert_close(y, x @ w, F32)


@pytest.mark.parametrize("mode", ["none", "fap", "pallas"])
def test_fault_linear_matches_reference_per_mode(mode):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 48), np.float32)
    w = rng.standard_normal((48, 97), np.float32)
    ok = _ok(11)
    jctx = JaxFaultContext(ok=None if mode == "none" else jnp.asarray(ok), mode=mode)
    ref = jax_fault_linear(jnp.asarray(x), jnp.asarray(w), jctx)
    ctx = context_from_ok(ok, mode, device="cpu")
    assert ctx.mode == {"none": "none", "fap": "fap", "pallas": "kernel"}[mode]
    got = fault_linear(torch.from_numpy(x), torch.from_numpy(w), ctx)
    assert_close(got, np.asarray(ref), F32)


# the fp32 master read in place by kernel mode: bf16 x, fp32 w

MIXED_CASES = [  # (M, K, N, w given as a transposed view)
    (4, 48, 40, False),
    (4, 48, 97, True),  # tied-unembed layout: w = embed.T
    (17, 100, 132, False),  # hymba's dt_w and x_proj widths
    (3, 33, 16, False),
]


def _mixed(m, k, n, transposed, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k), np.float32)
    w = (rng.standard_normal((k, n), np.float32) / np.sqrt(k)).astype(np.float32)
    w_t = torch.from_numpy(np.ascontiguousarray(w.T)).T if transposed else torch.from_numpy(w)
    return x, w, w_t, torch.from_numpy(x).to(BF16)


@pytest.mark.parametrize("m,k,n,transposed", MIXED_CASES)
def test_fp32_w_with_bf16_x_is_the_cast_first_product_exactly(m, k, n, transposed):
    x, w, w_t, xb = _mixed(m, k, n, transposed, m * 100 + n)
    ok = torch.from_numpy(_ok(n))
    got = masked_matmul_ref(xb, w_t, ok)
    assert got.dtype == BF16 and got.shape == (m, n)
    assert torch.equal(got, masked_matmul_ref(xb, w_t.to(BF16), ok))
    ctx = context_from_ok(_ok(n), "pallas", device="cpu")
    via_path = fault_linear(xb, w_t, ctx)  # kernel mode hands the fp32 master over, uncast
    assert torch.equal(via_path, got)
    assert torch.equal(masked_matmul(xb, w_t, ok), got)


@pytest.mark.parametrize("mode", ["fap", "pallas"])
@pytest.mark.parametrize("m,k,n,transposed", MIXED_CASES)
def test_fp32_w_with_bf16_x_matches_reference_fault_linear(m, k, n, transposed, mode):
    x, w, w_t, xb = _mixed(m, k, n, transposed, m * 100 + n + 1)
    ok = _ok(k + n)
    jx = jnp.asarray(x, dtype=jnp.bfloat16)
    ref = jax_fault_linear(jx, jnp.asarray(w), JaxFaultContext(ok=jnp.asarray(ok), mode=mode))
    got = fault_linear(xb, w_t, context_from_ok(ok, mode, device="cpu"))
    assert got.dtype == BF16
    assert_close(got, np.asarray(ref.astype(jnp.float32)), BF16)


def test_float32_x_with_bf16_w_is_refused():
    x = torch.randn(4, 48)
    w = torch.randn(48, 40).to(BF16)
    ok = torch.from_numpy(_ok(1))
    with pytest.raises(TypeError, match="float32 w with a bfloat16 x"):
        masked_matmul_ref(x, w, ok)
    with pytest.raises(TypeError, match="float32 w with a bfloat16 x"):
        masked_matmul(x, w, ok)
    # fault_linear casts such a w first in kernel mode, as the plain modes do
    got = fault_linear(x, w, context_from_ok(_ok(1), "pallas", device="cpu"))
    assert got.dtype == F32
    assert torch.equal(got, fault_linear(x, w, context_from_ok(_ok(1), "fap", device="cpu")))


@pytest.mark.parametrize("w_dtype", [BF16, torch.float16])
@pytest.mark.parametrize("m,k,n,transposed", MIXED_CASES)
def test_kernel_mode_casts_a_w_the_kernels_do_not_take(m, k, n, transposed, w_dtype):
    """A bf16 param_dtype with a float32 dtype: kernel mode gives the fap
    result, and the reference's fault_linear at float32 tolerance."""
    x, w, w_t, _ = _mixed(m, k, n, transposed, m * 100 + n + 2)
    ok = _ok(k * n)
    xf, wl = torch.from_numpy(x), w_t.to(w_dtype)
    got = fault_linear(xf, wl, context_from_ok(ok, "pallas", device="cpu"))
    assert got.dtype == F32
    assert torch.equal(got, fault_linear(xf, wl, context_from_ok(ok, "fap", device="cpu")))
    jw = jnp.asarray(wl.float().numpy(), dtype=jnp.bfloat16 if w_dtype == BF16 else jnp.float16)
    ref = jax_fault_linear(jnp.asarray(x), jw, JaxFaultContext(ok=jnp.asarray(ok), mode="pallas"))
    assert_close(got, np.asarray(ref), F32)


@pytest.mark.parametrize("r,c", [(16, 16), (256, 256), (5, 13)])
def test_packed_mask_bits_hold_the_mask(r, c):
    ok = torch.from_numpy(jax_random_fault_map(r * c, r, c, 0.3).ok_mask)
    for mat in (ok, ok.T):
        bits = _pack_bits(mat)
        assert bits.dtype == torch.uint8 and bits.shape == (mat.shape[0], -(-mat.shape[1] // 8))
        assert bits.is_contiguous()
        cols = torch.arange(mat.shape[1])
        unpacked = (bits[:, cols // 8].int() >> (cols % 8)) & 1
        assert torch.equal(unpacked.float(), mat)


@pytest.mark.parametrize("m,variant,dtype,want", [
    (1, "auto", BF16, "decode"), (16, "auto", BF16, "decode"), (17, "auto", BF16, "mma"),
    (8192, "auto", BF16, "mma"), (4, "auto", F32, "v1"), (512, "auto", F32, "v1"), (4, "v1", BF16, "v1"),
])
def test_the_dtype_and_m_pick_the_kernel(m, variant, dtype, want):
    assert pick_variant(dtype, m, variant) == want


def test_wrapper_refuses_devices_it_has_no_kernel_for():
    x = torch.empty(4, 48, device="meta")
    w = torch.empty(48, 40, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        masked_matmul(x, w, torch.empty(16, 16, device="meta"))
    q = torch.empty(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention(q, q, q)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FA_CASES = [  # (Hq, Hkv, Sq, Skv, causal, window, q_offset)
    (4, 2, 40, 40, True, None, 0),
    (4, 2, 40, 40, True, 8, 0),
    (4, 2, 8, 40, True, None, 32),  # decode-like: queries at the end of the kv
    (4, 4, 32, 32, False, None, 0),
    (4, 2, 17, 17, True, 5, 0),  # ragged length, window
]


def _qkv(hq, hkv, sq, skv, seed, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, hq, sq, d), np.float32)
    k = rng.standard_normal((2, hkv, skv, d), np.float32)
    v = rng.standard_normal((2, hkv, skv, d), np.float32)
    return q, k, v


@pytest.mark.parametrize("hq,hkv,sq,skv,causal,window,q_offset", FA_CASES)
def test_flash_attention_plain_matches_reference_and_pallas(
    hq, hkv, sq, skv, causal, window, q_offset
):
    q, k, v = _qkv(hq, hkv, sq, skv, sq + skv)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    assert got.shape == q.shape
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    assert_close(got, np.asarray(jax_attention_ref(jq, jk, jv, **kw)), F32)
    assert_close(got, np.asarray(jax_flash_attention(jq, jk, jv, interpret=True, **kw)), F32)


def test_flash_attention_zero_mass_rows_return_zero():
    """Rows that keep no key return 0, as the reference kernel does (its
    oracle divides 0 by 0 there)."""
    q, k, v = _qkv(4, 2, 8, 40, 5)
    kw = dict(causal=False, window=4, q_offset=100)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    kern = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True, **kw)
    assert not got.abs().any()
    assert_close(got, np.asarray(kern), F32)
