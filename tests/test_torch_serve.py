"""The port's serving engine and fault maps against the reference package.

Greedy generation must give identical tokens to the reference engine on the
same weights and fault context, and logprobs within ``dtype_tol(float32)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_config as jax_reduce_config
from repro.core import faults as jax_faults
from repro.core.masking import FaultContext as JaxFaultContext
from repro.models import model as JM
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.engine import make_sample_decode as jax_make_sample_decode
from repro_torch.configs import get_arch, reduce_config
from repro_torch.convert import context_from_ok, params_from_jax
from repro_torch.core import faults
from repro_torch.kernels.common import assert_close
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as M
from repro_torch.serve import ServeEngine, make_sample_decode
from repro_torch.serve.bucketing import ladder_rung, validate_buckets
from repro_torch.serve.kvcache import dense_kv_bytes, round_up_to_page

F32 = torch.float32


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduce_config(jax_get_arch("smollm-135m"))
    cfg = reduce_config(get_arch("smollm-135m"))
    jparams, _ = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    ok = faults.random_fault_map(0, cfg.array_rows, cfg.array_cols, 0.3).ok_mask
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    return jcfg, cfg, jparams, params, ok, prompts


def _both(setup, mode, **engine_kw):
    jcfg, cfg, jparams, params, ok, _ = setup
    jctx = JaxFaultContext(ok=None if mode == "none" else jnp.asarray(ok), mode=mode)
    return (
        JaxServeEngine(jcfg, jparams, jctx, **engine_kw),
        ServeEngine(cfg, params, context_from_ok(ok, mode, device="cpu"), **engine_kw),
    )


def _check_same(ref, got):
    assert np.array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    assert_close(got.logprobs, np.asarray(ref.logprobs), F32)


@pytest.mark.parametrize("buckets", ["default", None])
@pytest.mark.parametrize("mode", ["none", "fap", "pallas"])
def test_greedy_generate_matches_reference(setup, mode, buckets):
    kw = dict(max_len=48) if buckets == "default" else dict(max_len=48, prefill_buckets=None)
    jeng, eng = _both(setup, mode, **kw)
    prompts = setup[5]
    ref = jeng.generate(jnp.asarray(prompts), max_new_tokens=6)
    got = eng.generate(torch.from_numpy(prompts).long(), max_new_tokens=6)
    assert got.tokens.shape == (2, 14)
    _check_same(ref, got)


def test_capacity_from_budget_and_eos_match_reference(setup):
    jeng, eng = _both(setup, "pallas", max_len=None)
    prompts = setup[5]
    assert eng.cache_len_for(8, 6) == jeng.cache_len_for(8, 6) == 32
    ref = jeng.generate(jnp.asarray(prompts), max_new_tokens=6)
    got = eng.generate(torch.from_numpy(prompts).long(), max_new_tokens=6)
    _check_same(ref, got)
    # an EOS that the first sequence emits mid-way: it pads out after it
    eos = int(np.asarray(ref.tokens)[0, 10])
    ref = jeng.generate(jnp.asarray(prompts), max_new_tokens=6, eos_id=eos)
    got = eng.generate(torch.from_numpy(prompts).long(), max_new_tokens=6, eos_id=eos)
    _check_same(ref, got)
    assert (got.tokens[0, 11:] == 0).all() and (got.logprobs[0, 3:] == 0).all()


def test_masked_sample_decode_matches_reference(setup):
    """The per-slot form: slots retire on EOS or on their budget and then
    emit pad with logprob 0."""
    jcfg, cfg, jparams, params, ok, prompts = setup
    jctx = JaxFaultContext(ok=jnp.asarray(ok), mode="fap")
    ctx = context_from_ok(ok, "fap", device="cpu")
    jl, jc = JM.prefill(jparams, {"tokens": jnp.asarray(prompts)}, jcfg, jctx, cache_len=16)
    pl, pc = M.prefill(params, {"tokens": torch.from_numpy(prompts).long()}, cfg, ctx, cache_len=16)
    jstep, step = jax_make_sample_decode(jcfg, pad_id=5), make_sample_decode(cfg, pad_id=5)
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    jact, act = jnp.ones(2, bool), torch.ones(2, dtype=torch.bool)
    jrem, rem = jnp.asarray([2, 5], jnp.int32), torch.tensor([2, 5], dtype=torch.int32)
    eos = int(jnp.argmax(jl[1]))  # the second slot retires on its first token
    for _ in range(4):
        jt, jlp, jl, jc, key, jact, jrem = jstep(
            jparams, jl, jc, key, jctx, jnp.float32(0.0), jact, jnp.int32(eos), jrem
        )
        t, lp, pl, pc, act, rem = step(params, pl, pc, gen, ctx, 0.0, act, eos, rem)
        assert np.array_equal(t.numpy(), np.asarray(jt))
        assert np.array_equal(act.numpy(), np.asarray(jact))
        assert np.array_equal(rem.numpy(), np.asarray(jrem))
        assert_close(lp, np.asarray(jlp), F32)
    assert not act.any() and t[1] == 5 and lp[1] == 0


def test_temperature_sampling_is_seeded(setup):
    _, cfg, _, params, ok, prompts = setup
    eng = ServeEngine(cfg, params, context_from_ok(ok, "fap", device="cpu"), max_len=48)
    p = torch.from_numpy(prompts).long()
    a = eng.generate(p, max_new_tokens=8, temperature=1.0, seed=1)
    b = eng.generate(p, max_new_tokens=8, temperature=1.0, seed=1)
    c = eng.generate(p, max_new_tokens=8, temperature=1.0, seed=2)
    assert torch.equal(a.tokens, b.tokens)
    assert not torch.equal(a.tokens, c.tokens)
    assert torch.isfinite(a.logprobs).all() and (a.logprobs <= 0).all()


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_fault_maps_bitwise_equal_to_reference(seed):
    for rate in (0.0, 0.05, 0.3):
        a = faults.random_fault_map(seed, 32, 24, rate)
        b = jax_faults.random_fault_map(seed, 32, 24, rate)
        assert np.array_equal(a.faulty, b.faulty) and np.array_equal(a.ok_mask, b.ok_mask)
        a = faults.random_fault_map(seed, 32, 24, rate, exact=False)
        assert np.array_equal(a.faulty, jax_faults.random_fault_map(seed, 32, 24, rate, exact=False).faulty)
    a = faults.clustered_fault_map(seed, 64, 64, 0.1, cluster_sigma=4.0)
    b = jax_faults.clustered_fault_map(seed, 64, 64, 0.1, cluster_sigma=4.0)
    assert np.array_equal(a.faulty, b.faulty)
    ms = [faults.random_fault_map(seed + i, 16, 16, 0.1, chip_id=f"c{i}") for i in range(3)]
    js = [jax_faults.random_fault_map(seed + i, 16, 16, 0.1, chip_id=f"c{i}") for i in range(3)]
    m, j = faults.merge_fault_maps(ms), jax_faults.merge_fault_maps(js)
    assert np.array_equal(m.faulty, j.faulty) and m.chip_id == j.chip_id
    assert m.fault_rate == j.fault_rate and m.num_faults == j.num_faults


def test_bucketing_and_kv_sizing(setup):
    _, cfg, *_ = setup
    assert validate_buckets([8, 16]) == (8, 16)
    with pytest.raises(ValueError):
        validate_buckets([16, 8])
    assert ladder_rung(5, (8, 16)) == 8 and ladder_rung(40, (8, 16)) == 64
    assert round_up_to_page(9, 8) == 16
    assert dense_kv_bytes(cfg, 2, 48) == 2 * 2 * 2 * 16 * 4 * 2 * 48


def test_serve_cli_runs_on_cpu(capsys):
    serve_cli.main([
        "--arch", "smollm-135m", "--reduced", "--device", "cpu", "--fault-rate", "0.1",
        "--fault-mode", "kernel", "--batch", "2", "--prompt-len", "8", "--new-tokens", "4",
    ])
    out = capsys.readouterr().out
    assert "mode=kernel" in out and "2x4 tokens" in out and "seq1:" in out
