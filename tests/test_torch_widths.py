"""The widths the card kernels take, against the reference package: the scan
at any state count up to its cap, flash attention at head dims 80, 96 and
128, and int8 decode attention, dense and paged, at head dim 96.

The same numpy inputs go through the reference's oracle, its Pallas kernel
in interpret mode (through its wrapper, which pads ragged L and D),
and the port's wrapper on a CPU tensor (its plain
PyTorch version). The scan's launch plan and an emulation of its kernel's
schedule (states split over lanes, y reduced by the kernel's
reduce-scatter, steps past L read as zeros) are checked here too; the CUDA
kernels themselves are held to the plain versions on the card by
``tests/test_torch_cuda.py``.

Tolerances: the scan's h_last and float32 y at rtol 2e-5 / atol 1e-4 (the
reference's kernel tests); flash and decode attention in float32 at
``dtype_tol`` (rtol 2e-5, atol 2e-4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode_attention
from repro.kernels.decode_attention.ops import paged_decode_attention as jax_paged_decode_attention
from repro.kernels.decode_attention.ops import quantize_kv as jax_quantize_kv
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_attention_ref
from repro.kernels.decode_attention.ref import (
    paged_decode_attention_ref as jax_paged_decode_attention_ref,
)
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.mamba_scan.ops import selective_scan as jax_selective_scan
from repro.kernels.mamba_scan.ref import selective_scan_ref as jax_selective_scan_ref
from repro_torch.kernels.common import SMEM_LIMIT_BYTES, assert_close
from repro_torch.kernels.decode_attention.ops import HEAD_DIMS as DECODE_HEAD_DIMS
from repro_torch.kernels.decode_attention.ops import decode_attention, paged_decode_attention
from repro_torch.kernels.decode_attention.ops import smem_bytes as decode_smem_bytes
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS as FLASH_HEAD_DIMS
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mamba_scan.ops import (
    MAX_STATE,
    FLOOR_WARPS_PER_SM,
    MAX_STATES_PER_LANE,
    TARGET_WARPS_PER_SM,
    THREADS,
    scan_plan,
    selective_scan,
    selective_scan_ref,
)

F32 = torch.float32
SCAN_TOL = dict(rtol=2e-5, atol=1e-4)
H100_SMS = 132  # the plans below are the H100's


def _scan_inputs(b, l, d, n, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, l, d), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, d), np.float32) - 1.0))  # softplus
    a = -np.exp(rng.standard_normal((d, n), np.float32))
    bb = rng.standard_normal((b, l, n), np.float32)
    c = rng.standard_normal((b, l, n), np.float32)
    dd = rng.standard_normal((d,), np.float32)
    return u, dt, a, bb, c, dd


def _t(*arrays):
    return [torch.from_numpy(np.array(x)) for x in arrays]


# ---------------------------------------------------------------------------
# the scan: its plan, its kernel's schedule, and the state counts it takes
# ---------------------------------------------------------------------------

MAIN_SCAN_SHAPES = [(4, 128, 8192, 16), (4, 128, 3200, 16), (4, 2048, 3200, 16), (4, 2048, 8192, 16)]


@pytest.mark.parametrize("b,l,d,n", MAIN_SCAN_SHAPES + [
    (2, 37, 11, 4), (2, 256, 1024, 64), (2, 100, 300, 17), (1, 5, 3, 1), (1, 9, 7, 256), (64, 8, 4096, 16),
])
def test_scan_plan_divides_a_warp_covers_n_and_fills_the_card(b, l, d, n):
    plan = scan_plan(b, d, n, H100_SMS)
    assert plan.lanes in (1, 2, 4, 8, 16, 32) and 32 % plan.lanes == 0
    assert plan.states in (1, 2, 4, 8) and plan.states <= MAX_STATES_PER_LANE
    assert plan.lanes * plan.states >= n  # every state has a lane
    assert plan.lanes * plan.states < 2 * max(n, plan.lanes)  # and not twice what it needs
    assert plan.channels == THREADS // plan.lanes
    assert plan.blocks == b * -(-d // plan.channels)
    warps_per_sm = b * d * plan.lanes / 32 / H100_SMS
    if plan.lanes < min(32, n):  # it stopped short of the most lanes only because the card is full enough
        assert warps_per_sm >= FLOOR_WARPS_PER_SM
        assert warps_per_sm >= TARGET_WARPS_PER_SM or plan.states <= 4
    else:
        assert plan.lanes == 32 or plan.lanes >= n
    if plan.lanes > 1 and plan.lanes * plan.states // 2 >= n:  # fewer lanes would have held N too
        assert b * d * plan.lanes // 2 / 32 / H100_SMS < TARGET_WARPS_PER_SM
    assert scan_plan(b, d, n, H100_SMS) == plan  # a pure function of host shapes and the SM count
    # a card of twice the SMs takes at least as many lanes a channel to fill it
    assert scan_plan(b, d, n, 2 * H100_SMS).lanes >= plan.lanes


def test_scan_plan_at_the_main_shapes():
    """On the H100's 132 SMs, falcon-mamba's 4 x 8192 channels take 2
    lanes of 8 states (about 16 warps an SM), hymba's 4 x 3200 take 4 of 4
    (about 12)."""
    falcon = scan_plan(4, 8192, 16, H100_SMS)
    assert (falcon.lanes, falcon.states, falcon.channels, falcon.blocks) == (2, 8, 64, 512)
    hymba = scan_plan(4, 3200, 16, H100_SMS)
    assert (hymba.lanes, hymba.states, hymba.channels, hymba.blocks) == (4, 4, 32, 400)


def test_scan_refuses_state_counts_past_its_cap():
    assert MAX_STATE == 256
    for n in (0, MAX_STATE + 1):
        with pytest.raises(ValueError, match=f"1 to {MAX_STATE} states"):
            scan_plan(2, 16, n, H100_SMS)
    # the largest state count takes every lane of a warp, 8 states a lane
    p = scan_plan(1, 16, MAX_STATE, H100_SMS)
    assert (p.lanes, p.states, p.channels) == (32, 8, 4)


def _reduce_scatter(v, lanes):
    """The kernel's y reduction over a channel's lanes, in its order: v[r][j]
    is lane r's partial of step j of a group of ``lanes`` steps; returns the
    sum each lane ends with (lane r: step r)."""
    v = [list(x) for x in v]
    h = lanes // 2
    while h >= 1:  # as the kernel: each lane sends one half and keeps the other
        send = [[v[r][i] if r & h else v[r][i + h] for i in range(h)] for r in range(lanes)]
        keep = [[v[r][i + h] if r & h else v[r][i] for i in range(h)] for r in range(lanes)]
        v = [[keep[r][i] + send[r ^ h][i] for i in range(h)] for r in range(lanes)]
        h //= 2
    return [x[0] for x in v]


def _scan_emulation(u, dt, a, b, c, d, lanes, states):
    """The kernel's schedule in fp32 torch: each channel's states split over
    ``lanes`` lanes, ``states`` a lane (states past N with A = B = C = 0),
    steps past L padded with zeros to whole passes of max(lanes, 8) steps,
    exp(dt * A) by exp, a lane's part of y in two chains (its even and its
    odd states) added at the end, y reduced by the reduce-scatter, then y +
    D * u."""
    bsz, length, dim = u.shape
    n = a.shape[1]
    p, s = lanes, states
    np_ = p * s
    pass_len = max(p, 8)
    pad_l = -(-max(length, 1) // pass_len) * pass_len
    u32, dt32 = (torch.zeros(bsz, pad_l, dim) for _ in range(2))
    u32[:, :length], dt32[:, :length] = u.float(), dt.float()
    bp, cp = (torch.zeros(bsz, pad_l, np_) for _ in range(2))
    bp[:, :length, :n], cp[:, :length, :n] = b.float(), c.float()
    a2 = torch.zeros(dim, np_)
    a2[:, :n] = a.float()
    h = torch.zeros(bsz, dim, np_)
    ysum = torch.zeros(bsz, pad_l, dim)
    for g0 in range(0, pad_l, p):
        parts = torch.zeros(p, p, bsz, dim)  # (lane, step of the group)
        for j in range(p):
            t = g0 + j
            x, du = dt32[:, t], dt32[:, t] * u32[:, t]
            h = torch.exp(x[..., None] * a2) * h + du[..., None] * bp[:, t, None, :]
            prod = (h * cp[:, t, None, :]).reshape(bsz, dim, p, s)
            chains = torch.zeros(2, bsz, dim, p)
            for st in range(s):  # the lane's two FMA chains: even states, odd states
                chains[st % 2] = chains[st % 2] + prod[..., st]
            parts[:, j] = (chains[0] + chains[1]).permute(2, 0, 1)
        sums = _reduce_scatter([[parts[r, j] for j in range(p)] for r in range(p)], p)
        for r in range(p):
            ysum[:, g0 + r] = sums[r]
    y = ysum[:, :length] + d.float() * u.float()
    return y, h[..., :n]


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_reduce_scatter_leaves_lane_r_the_sum_of_step_r(lanes):
    rng = np.random.default_rng(lanes)
    v = rng.integers(-50, 50, (lanes, lanes)).astype(np.float64)  # exact in any order
    got = _reduce_scatter(v.tolist(), lanes)
    np.testing.assert_array_equal(got, v.sum(axis=0))


@pytest.mark.parametrize("b,l,d,n,lanes,states", [
    (2, 37, 11, 4, 4, 1), (1, 40, 6, 16, 4, 4), (1, 21, 5, 16, 16, 1), (1, 33, 3, 17, 8, 4),
    (1, 18, 2, 64, 32, 2), (2, 7, 3, 1, 1, 1),
])
def test_scan_emulation_of_the_kernel_matches_plain_reference_and_pallas(b, l, d, n, lanes, states):
    u, dt, a, bb, c, dd = _scan_inputs(b, l, d, n, seed=n + l)
    y, h = _scan_emulation(*_t(u, dt, a, bb, c, dd), lanes, states)
    ref_y, ref_h = selective_scan_ref(*_t(u, dt, a, bb, c, dd))
    ker_y, ker_h = jax_selective_scan(*(jnp.asarray(x) for x in (u, dt, a, bb, c, dd)),
                                      bd=8, bl=16, interpret=True)
    for want_y, want_h in ((ref_y, ref_h), (ker_y, ker_h)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y, np.float32), **SCAN_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h, np.float32), **SCAN_TOL)


@pytest.mark.parametrize("u_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 17, 64])
def test_plain_scan_matches_reference_and_pallas_at_any_state_count(n, u_dtype):
    b, l, d = 2, 24, 12
    u, dt, a, bb, c, dd = _scan_inputs(b, l, d, n, seed=n)
    ju = jnp.asarray(u).astype(u_dtype)
    jargs = (jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bb), jnp.asarray(c), jnp.asarray(dd))
    ref_y, ref_h = jax_selective_scan_ref(ju, *jargs)
    ker_y, ker_h = jax_selective_scan(ju, *jargs, bd=8, bl=16, interpret=True)
    tu = torch.from_numpy(u).to(getattr(torch, u_dtype))
    got_y, got_h = selective_scan(tu, *_t(dt, a, bb, c, dd))
    assert got_h.shape == (b, d, n) and got_y.dtype == tu.dtype
    y_tol = SCAN_TOL if u_dtype == "float32" else dict(rtol=2e-2, atol=1e-2)
    for want_y, want_h in ((ref_y, ref_h), (ker_y, ker_h)):
        np.testing.assert_allclose(got_y.float().numpy(), np.asarray(want_y, np.float32), **y_tol)
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **SCAN_TOL)


# ---------------------------------------------------------------------------
# flash attention at the head dims of the reference's model zoo
# ---------------------------------------------------------------------------

FLASH_WIDTH_CASES = [  # (Hq, Hkv, Sq, Skv, causal, window, q_offset)
    (4, 2, 40, 40, True, None, 0),
    (6, 2, 33, 33, True, 8, 0),  # windowed, GQA, ragged
    (4, 1, 8, 40, True, 16, 32),  # queries at the end of the keys, windowed
]


@pytest.mark.parametrize("d", [80, 96, 128])
@pytest.mark.parametrize("hq,hkv,sq,skv,causal,window,q_offset", FLASH_WIDTH_CASES)
def test_plain_flash_matches_reference_and_pallas_at_wide_head_dims(d, hq, hkv, sq, skv, causal, window, q_offset):
    rng = np.random.default_rng(d + sq)
    q = rng.standard_normal((2, hq, sq, d), np.float32)
    k = rng.standard_normal((2, hkv, skv, d), np.float32)
    v = rng.standard_normal((2, hkv, skv, d), np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = flash_attention(*_t(q, k, v), **kw)
    assert got.shape == q.shape and got.dtype == F32
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    assert_close(got, np.asarray(jax_attention_ref(jq, jk, jv, **kw)), F32)
    assert_close(got, np.asarray(jax_flash_attention(jq, jk, jv, bq=16, bkv=16, interpret=True, **kw)), F32)


# ---------------------------------------------------------------------------
# int8 decode attention at head dim 96, dense and paged
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,hq,hkv,skv,valid", [(2, 32, 32, 96, 70), (2, 6, 2, 160, 160), (1, 8, 1, 64, 1)])
def test_plain_decode_attention_matches_pallas_and_oracle_at_d96(b, hq, hkv, skv, valid):
    d = 96
    rng = np.random.default_rng(skv + valid)
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    ki, ks = jax_quantize_kv(jnp.asarray(rng.standard_normal((b, hkv, skv, d)), jnp.float32))
    vi, vs = jax_quantize_kv(jnp.asarray(rng.standard_normal((b, hkv, skv, d)), jnp.float32))
    got = decode_attention(torch.from_numpy(q), *_t(ki, ks, vi, vs), valid)
    assert got.shape == (b, hq, 1, d)
    jq = jnp.asarray(q)
    kern = jax_decode_attention(jq, ki, ks, vi, vs, valid, bkv=32, interpret=True)
    oracle = jax_decode_attention_ref(jq, ki, ks, vi, vs, kv_valid_len=valid)
    assert_close(got, np.asarray(kern), F32)
    assert_close(got, np.asarray(oracle), F32)


def test_plain_paged_decode_attention_matches_pallas_and_oracle_at_d96():
    d, hq, hkv, page, pool, maxp = 96, 32, 8, 8, 24, 5
    rng = np.random.default_rng(96)
    lens = np.array([33, 8, 17], np.int32)
    tables = rng.permutation(np.arange(1, pool))[: 3 * maxp].reshape(3, maxp).astype(np.int32)
    ki, ks = jax_quantize_kv(jnp.asarray(rng.standard_normal((hkv, pool, page, d)), jnp.float32))
    vi, vs = jax_quantize_kv(jnp.asarray(rng.standard_normal((hkv, pool, page, d)), jnp.float32))
    q = rng.standard_normal((3, hq, 1, d)).astype(np.float32)
    got = paged_decode_attention(torch.from_numpy(q), *_t(ki, ks, vi, vs, tables, lens))
    args = (jnp.asarray(q), ki, ks, vi, vs, jnp.asarray(tables), jnp.asarray(lens))
    assert_close(got, np.asarray(jax_paged_decode_attention(*args, interpret=True)), F32)
    assert_close(got, np.asarray(jax_paged_decode_attention_ref(*args)), F32)


# ---------------------------------------------------------------------------
# the sizes the card kernels take, as the wrappers state them and the C sources build them
# ---------------------------------------------------------------------------


def _source(name):
    from repro_torch.kernels.common import CSRC_DIR

    return (CSRC_DIR / f"{name}.cu").read_text()


def test_wrappers_state_the_sizes_the_c_sources_build():
    import re

    assert FLASH_HEAD_DIMS == (64, 80, 96, 128)
    assert DECODE_HEAD_DIMS == (32, 64, 96, 128)
    flash = _source("flash_attention")
    assert tuple(int(x) for x in re.findall(r"launch_mma<(\d+)>\(", flash)) == FLASH_HEAD_DIMS
    assert tuple(int(x) for x in re.findall(r"v1::launch<T, (\d+)>\(", flash)) == FLASH_HEAD_DIMS
    decode = _source("decode_attention")
    assert tuple(sorted(int(x) for x in re.findall(r"launch_d<(\d+)>\(a", decode))) == DECODE_HEAD_DIMS
    scan = _source("selective_scan")
    assert tuple(int(x) for x in re.findall(r"launch_p<(\d+)>\(args", scan)) == (1, 2, 4, 8, 16, 32)
    assert tuple(int(x) for x in re.findall(r"launch_ps<P, (\d+)>\(a", scan)) == (1, 2, 4, 8)
    assert f"constexpr int NMAX = {MAX_STATE};" in scan
    # every built decode head dim fits the default tile's ring at any group size
    for d in DECODE_HEAD_DIMS:
        for group in range(1, 9):
            assert decode_smem_bytes(128, d, group) <= SMEM_LIMIT_BYTES


def test_scan_backward_plan_is_an_instance_its_c_source_builds():
    """``bwd_plan`` gives, for every N the kernels take, the (lanes, states)
    that ``selective_scan_bwd.cu`` computes and accepts (it refuses any
    other), and the C source builds that instance; the wrapper's checkpoint
    chunk and block size are the source's."""
    import re

    from repro_torch.kernels.mamba_scan.ops import BWD_CHUNK, THREADS, bwd_plan

    src = _source("selective_scan_bwd")
    built = {(int(p), int(s)) for p, s in re.findall(r"launch_ps<(\d+), (\d+)>\(args", src)}
    assert f"constexpr int CT = {BWD_CHUNK};" in src and f"constexpr int NT = {THREADS};" in src
    assert f"constexpr int NMAX = {MAX_STATE};" in src
    assert "while (want_states < N && want_states < 4) want_states *= 2;" in src
    assert "if (N > 128) want_states = 8;" in src
    plans = set()
    for n in range(1, MAX_STATE + 1):
        states = 1
        while states < n and states < 4:  # the C entry point's rule
            states *= 2
        if n > 128:
            states = 8
        lanes = 1
        while lanes * states < n:
            lanes *= 2
        assert bwd_plan(n) == (lanes, states) and (lanes, states) in built, n
        plans.add((lanes, states))
    assert plans == built == {(1, 1), (1, 2), (1, 4), (2, 4), (4, 4), (8, 4), (16, 4), (32, 4), (32, 8)}


def test_scan_backward_shared_memory_fits_a_block_at_every_state_count():
    """``bwd_smem_bytes``, the Python mirror of ``selective_scan_bwd.cu``'s
    ``layout``, fits a block's 232,448 bytes at every N from 1 to 256 in
    both dtypes for the plan's instance, and four blocks an SM at the
    models' N = 16; the mirror's regions are the C layout's, in its order."""
    import re

    from repro_torch.kernels.mamba_scan.ops import BWD_CHUNK, bwd_scratch, bwd_smem_bytes

    src = _source("selective_scan_bwd")
    assert "  o = 2 * y.stage;" in src  # two ring stages
    body = src.split("__host__ __device__ inline Layout layout(", 1)[1].split("\n}\n", 1)[0]
    regions = ["u", "dt", "gy", "b", "c", "stage", "x", "bc", "h", "g", "red", "total"]
    assert re.findall(r"y\.(\w+) = o;", body) == regions
    assert f"constexpr long long SMEM_LIMIT = {SMEM_LIMIT_BYTES};" in src
    for dtype in (torch.float32, torch.bfloat16):
        for n in range(1, MAX_STATE + 1):
            assert bwd_smem_bytes(n, dtype) <= SMEM_LIMIT_BYTES, (n, dtype)
        # an SM's 228 KiB holds four blocks, each with its 1 KiB reserve
        assert 4 * (bwd_smem_bytes(16, dtype) + 1024) <= 233472, dtype
    # the population fit's launch, 16 rows x 64 steps x 8192 channels x 16 states: 256 blocks a row,
    # checkpoints before chunks 1-6 of 8
    got = bwd_scratch(16, 64, 8192, 16)
    assert (got["lanes"], got["states"], got["parts"], got["slots"]) == (4, 4, 256, 64 // BWD_CHUNK - 2)
    assert got["pbc"] == (16, 64, 256, 32) and got["ckpt"] == (16, 256, 6, THREADS * 4)
    assert bwd_scratch(2, 9, 40, 5)["slots"] == 0 and bwd_scratch(2, 17, 40, 5)["slots"] == 1


def test_scan_probe_counts_the_loop_that_holds_the_exponentials():
    """``tools/selective_scan_probe.py`` reads the inner loop off
    ``cuobjdump -sass``: the backward branch's range that holds the
    MUFU.EX2s, counted by opcode, per (step, state) of one lane's pass."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "selective_scan_probe.py"
    spec = importlib.util.spec_from_file_location("selective_scan_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    sass = """
        Function : _ZN4_GLOBAL__N_121selective_scan_kernelILi4ELi1EEEvNS_4ArgsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        Function : _ZN4_GLOBAL__N_121selective_scan_kernelILi2ELi8EEEvNS_4ArgsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_3:
        /*0010*/                   LDS.64 R2, [R4] ;
        /*0020*/                   FMUL R5, R2, R6 ;
        /*0030*/                   MUFU.EX2 R7, R5 ;
        /*0040*/                   FFMA R8, R7, R8, R9 ;
        /*0050*/              @P0 BRA `(.L_x_3) ;
        /*0060*/                   EXIT ;
"""
    got = probe.sass_loop_counts(sass, 2, 8)
    assert got["instructions"] == 5 and got["exps"] == 1
    assert got["pairs_per_pass"] == 8 * 8  # an 8-step pass of 8 states
    assert got["by_opcode"] == {"LDS": 1, "FMUL": 1, "MUFU.EX2": 1, "FFMA": 1, "BRA": 1}
    assert probe.sass_loop_counts(sass, 4, 1) == {}  # no loop with an exponential there
    assert probe.sass_loop_counts(sass, 8, 2) == {}  # no such instance


def test_scan_probe_variants_patch_the_kernel_source_once():
    """The probe builds its ``ex2.approx`` and no-exponential variants from
    patched copies of the kernel's source: each text it replaces is there
    exactly once, so a variant differs from the kernel as built only there."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "selective_scan_probe.py"
    spec = importlib.util.spec_from_file_location("selective_scan_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    scan = _source("selective_scan")
    assert set(probe.VARIANTS) == {"ex2.approx", "no exp"}
    for patches in probe.VARIANTS.values():
        for old, new in patches:
            assert scan.count(old) == 1 and old != new
    assert "#if" not in scan  # the kernel as built has no compile-time variants


def _tool(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scan_backward_probe_patches_the_source_as_it_counts():
    """``tools/selective_scan_bwd_probe.py`` times the backward's launches
    apart and its diagnostic copies from patched copies of the source: the
    entry cut after the main kernel, an appended entry to ``launch_sum``,
    and each diagnostic's text found as many times as it lists, in the
    tree's source (and the parent's set only in the parent's)."""
    probe = _tool("selective_scan_bwd_probe")
    src = _source("selective_scan_bwd")
    assert src.count(probe.MAIN_ONLY[0]) == 1
    assert ("int launch_sum(const float* in, float* out, long long outer, int K, long long inner, "
            "cudaStream_t st)") in src
    assert probe.diagnostics_for(src) is probe.DIAGNOSTICS["tree"]
    split = probe.patch(src, [(*probe.MAIN_ONLY, 1)]) + probe.PROBE_SUM
    for patches in probe.DIAGNOSTICS["tree"].values():
        assert probe.patch(split, patches) != split
    with pytest.raises(RuntimeError, match="times, not"):
        probe.patch(src, probe.DIAGNOSTICS["parent"]["no expf"])
    # the parent's wrapper, 77fb41a: per-warp partials, a checkpoint every 8 steps
    assert probe.parent_scratch(16, 64, 8192, 16)["pbc"] == (16, 64, 512, 2, 16)


def test_scan_backward_probe_reads_ptxas():
    probe = _tool("selective_scan_bwd_probe")
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125selective_scan_bwd_kernelILi4ELi4EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125selective_scan_bwd_kernelILi4ELi4EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110sum_middleEPKfPfxi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110sum_middleEPKfPfxi
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 18 registers, used 1 barriers, 384 bytes cmem[0]
"""
    assert probe.ptxas_table(log) == {
        "4x4": dict(stack=0, spill_stores=0, spill_loads=0, registers=96),
        "sum_middle": dict(stack=8, spill_stores=4, spill_loads=4, registers=18),
    }


def test_planted_faults_patch_the_tree_once():
    """Each fault of ``tools/planted_faults.py`` replaces a text found once
    in the tree (``bwd``: the backward's read of h_{t-1}), as does each
    serving gate it turns into a log line."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    faults = _tool("planted_faults")
    for fault, (_, subs, gates) in faults.FAULTS.items():
        for path, old, new in subs:
            assert (root / path).read_text().count(old) == 1 and old != new, fault
        for g in gates:
            assert (root / "chip_smoke.py").read_text().count(faults.GATES[g][0]) == 1, (fault, g)
    assert "h_{t-1}" in faults.FAULTS["bwd"][1][0][1]


def test_scan_backward_probe_counts_each_loop_of_the_instance():
    """The probe reads every loop (a backward branch) of one instance off
    ``cuobjdump -sass`` and counts its exponentials, shuffles, shared and
    device memory instructions and barriers."""
    probe = _tool("selective_scan_bwd_probe")
    sass = """
        Function : _ZN4_GLOBAL__N_125selective_scan_bwd_kernelILi4ELi4EEEvNS_4ArgsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_1:
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   MUFU.EX2 R7, R5 ;
        /*0030*/              @P0 BRA `(.L_x_1) ;
.L_x_2:
        /*0040*/                   SHFL.BFLY PT, R8, R9, 0x10, 0x1f ;
        /*0050*/                   STS [R3], R8 ;
        /*0060*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0070*/              @!P1 BRA `(.L_x_2) ;
        /*0080*/                   EXIT ;
        Function : _ZN4_GLOBAL__N_110sum_middleEPKfPfxii
        /*0000*/                   EXIT ;
"""
    loops = probe.sass_loops(sass, 4, 4)
    assert [(l["start"], l["end"], l["instructions"]) for l in loops] == [(0x10, 0x30, 3), (0x40, 0x70, 4)]
    assert (loops[0]["MUFU"], loops[0]["LDS"], loops[1]["SHFL"], loops[1]["STS"], loops[1]["BAR"]) == (1, 1, 1, 1, 1)
    assert probe.sass_loops(sass, 2, 8) == []
