"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the file
imports neither JAX nor the reference package, so it runs where only the port
is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core import random_fault_map
from repro_torch.kernels.common import assert_close, dtype_tol
from repro_torch.kernels.flash_attention.ops import attention_ref, flash_attention
from repro_torch.kernels.masked_matmul.ops import masked_matmul, masked_matmul_ref

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
]


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
