"""LM training in the port against the reference package, on the CPU: the
loss and its gradients, the train step with microbatches, the token stream,
checkpoints (and a reference checkpoint loaded through ``convert``), the
fault-tolerant loop, the training CLI, and learning itself.

The reference initializes a reduced SmolLM, ``repro_torch.convert`` hands
the numpy parameters over, and the reference's ``TokenStream`` batches go
to both packages. Tolerances: the loss within ``dtype_tol(float32)`` (rtol
2e-5, atol 2e-4), each gradient leaf within ``dtype_tol(float32,
atol_scale=10)`` (the same), params after 5 steps within
``dtype_tol(float32, atol_scale=100)`` (atol 2e-3).
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_config as jax_reduce_config
from repro.core.masking import FaultContext as JaxFaultContext
from repro.data.synthetic import TokenStream as JaxTokenStream
from repro.models import model as JM
from repro.train import checkpoint as JC
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_arch, reduce_config
from repro_torch.convert import (
    checkpoint_from_jax,
    context_from_ok,
    opt_state_from_jax,
    param_dict_from_jax,
)
from repro_torch.core import from_fault_map, healthy, random_fault_map
from repro_torch.data import TokenStream
from repro_torch.kernels.common import assert_close, dtype_tol
from repro_torch.launch import train as train_cli
from repro_torch.models import model as M
from repro_torch.train import checkpoint as C
from repro_torch.train import step as step_lib
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.step import make_eval_step, make_train_step

F32 = torch.float32
JCFG = jax_reduce_config(jax_get_arch("smollm-135m"))
CFG = reduce_config(get_arch("smollm-135m"))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast, and
    keeps parallel test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_batch(jbatch) -> dict:
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64 if v.dtype.kind == "i" else np.float32))
            for k, v in jbatch.items()}


@pytest.fixture(scope="module")
def setup():
    jparams, _ = JM.init_params(JCFG, jax.random.PRNGKey(0))
    params = param_dict_from_jax(CFG, jax.tree.map(np.asarray, jparams), device="cpu")
    ok = random_fault_map(0, CFG.array_rows, CFG.array_cols, 0.2).ok_mask
    jstream = JaxTokenStream(JCFG.vocab_size, 16, 4, seed=0)
    return jparams, params, ok, jstream


def _ctxs(ok, mode):
    jctx = JaxFaultContext(ok=None if mode == "none" else jnp.asarray(ok), mode=mode)
    return jctx, context_from_ok(ok, mode, device="cpu")


def _assert_tree_close(got: dict, want: dict, atol_scale: float):
    """``want`` is the reference's param tree, layers stacked."""
    want = param_dict_from_jax(CFG, jax.tree.map(np.asarray, want), device="cpu")
    assert set(got) == set(want)
    for k in got:
        assert_close(got[k], want[k], F32, atol_scale=atol_scale)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

CASES = [("none", "per_use"), ("fap", "per_use"), ("fap", "per_step")]


@pytest.mark.parametrize("with_mask", [False, True], ids=["all-tokens", "loss-mask"])
@pytest.mark.parametrize("mode,fault_apply", CASES, ids=["healthy", "fap", "per-step"])
def test_loss_and_gradients_match_reference(setup, mode, fault_apply, with_mask):
    jparams, params, ok, jstream = setup
    jbatch = dict(jstream.batch_at(3))
    if with_mask:
        mask = (np.random.default_rng(1).random(jbatch["labels"].shape) < 0.6).astype(np.float32)
        jbatch["loss_mask"] = jnp.asarray(mask)
    jctx, ctx = _ctxs(ok, mode)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jbatch, JCFG, jctx, remat="none", fault_apply=fault_apply), has_aux=True
    )(jparams)
    leaves = {k: p.clone().requires_grad_() for k, p in params.items()}
    loss, met = M.loss_fn(leaves, _torch_batch(jbatch), CFG, ctx, remat="none", fault_apply=fault_apply)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert_close(loss.detach(), np.asarray(jloss), F32)
    for key in ("ce", "aux", "accuracy"):
        assert_close(met[key].detach(), np.asarray(jmet[key]), F32)
    _assert_tree_close(grads, jgrads, atol_scale=10)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_gives_the_same_numbers(setup, remat):
    """A checkpointed layer recomputes its forward in the backward pass;
    the loss and every gradient are the same bits as without."""
    _, params, ok, jstream = setup
    batch = _torch_batch(jstream.batch_at(5))
    ctx = context_from_ok(ok, "fap", device="cpu")
    out = {}
    for r in ("none", remat):
        leaves = {k: p.clone().requires_grad_() for k, p in params.items()}
        loss, _ = M.loss_fn(leaves, batch, CFG, ctx, remat=r)
        out[r] = (loss.detach(), torch.autograd.grad(loss, list(leaves.values())))
    assert torch.equal(out["none"][0], out[remat][0])
    for a, b in zip(out["none"][1], out[remat][1]):
        assert torch.equal(a, b)


def test_module_and_flat_dict_give_the_same_forward(setup):
    """The serving code's ``Model`` and the trainers' flat dict run one path."""
    _, params, ok, jstream = setup
    model = M.Model(CFG, device="cpu")
    model.load_state_dict(params)
    batch = _torch_batch(jstream.batch_at(2))
    ctx = context_from_ok(ok, "fap", device="cpu")
    with torch.no_grad():
        a, aux = M.forward(model, batch, CFG, ctx)
        b, _ = M.forward(params, batch, CFG, ctx)
    assert torch.equal(a, b) and float(aux) == 0.0
    with pytest.raises(ValueError):
        M.forward(params, batch, CFG, ctx, remat="sometimes")


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches,accum_dtype", [(1, "float32"), (2, "float32"), (2, "bfloat16")])
def test_train_step_matches_reference(setup, microbatches, accum_dtype):
    jparams, params, ok, jstream = setup
    jctx, ctx = _ctxs(ok, "fap")
    jocfg, ocfg = JaxAdamWConfig(learning_rate=1e-3), AdamWConfig(learning_rate=1e-3)
    kw = dict(remat="none", microbatches=microbatches, accum_dtype=accum_dtype)
    jstep = jax.jit(jax_make_train_step(JCFG, jocfg, **kw))
    step = make_train_step(CFG, ocfg, **kw)
    jp, jo = jparams, jax_adamw_init(jparams, jocfg)
    p, o = params, adamw_init(params, ocfg)
    for i in range(5):
        jbatch = jstream.batch_at(i)
        jp, jo, jm = jstep(jp, jo, jbatch, jctx)
        p, o, m = step(p, o, _torch_batch(jbatch), ctx)
        assert_close(m["loss"], np.asarray(jm["loss"]), F32)
    _assert_tree_close(p, jp, atol_scale=100)
    assert int(o["count"]) == int(jo["count"]) == 5
    assert not any(t.requires_grad for t in p.values())


# ---------------------------------------------------------------------------
# the port's own token stream
# ---------------------------------------------------------------------------


def test_token_stream_perm_is_the_references_and_stream_is_seekable():
    for vocab, seed in ((97, 0), (49152, 3)):
        assert np.array_equal(TokenStream(vocab, 8, 2, seed=seed, device="cpu").perm,
                              np.asarray(JaxTokenStream(vocab, 8, 2, seed=seed).perm))
    s1 = TokenStream(97, 32, 4, seed=3, device="cpu")
    s2 = TokenStream(97, 32, 4, seed=3, device="cpu")
    b5 = s1.batch_at(5)
    assert torch.equal(b5["tokens"], s2.batch_at(5)["tokens"])
    for _ in range(3):
        s1.batch_at(6)  # drawing other steps leaves step 5 as it was
    assert torch.equal(b5["tokens"], s1.batch_at(5)["tokens"])
    assert not torch.equal(b5["tokens"], s1.batch_at(6)["tokens"])
    assert b5["tokens"].dtype == torch.int64 and b5["tokens"].shape == (4, 32)
    assert torch.equal(b5["labels"][:, :-1], b5["tokens"][:, 1:])
    # with no noise every token is perm of the one before
    clean = TokenStream(97, 32, 4, seed=3, noise=0.0, device="cpu").batch_at(7)
    perm = torch.from_numpy(s1.perm)
    assert torch.equal(perm[clean["tokens"]], clean["labels"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_gc(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    for step in (10, 20, 30, 40):
        C.save_checkpoint(str(tmp_path), step, tree, keep=2)
    assert C.latest_step(str(tmp_path)) == 40
    on_disk = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert on_disk == [30, 40]  # gc kept the last 2
    step, flat, meta = C.load_checkpoint(str(tmp_path))
    assert step == 40 and meta["keys"] == ["a", "b/c"]
    restored = C.restore_sharded(tree, flat)
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    with pytest.raises(KeyError):
        C.restore_sharded({"missing": torch.zeros(1)}, flat)


def test_reference_checkpoint_loads_into_the_port(setup, tmp_path):
    """A checkpoint the reference's loop writes (params and AdamW state,
    layers stacked) restores into the port's flat template through
    ``convert``; a port checkpoint of the same state holds the same bits."""
    jparams, params, ok, jstream = setup
    jocfg = JaxAdamWConfig(learning_rate=1e-3)
    jp, jo, _ = jax.jit(jax_make_train_step(JCFG, jocfg, remat="none"))(
        jparams, jax_adamw_init(jparams, jocfg), jstream.batch_at(0), _ctxs(ok, "none")[0]
    )
    JC.save_checkpoint(str(tmp_path / "ref"), 1, {"params": jp, "opt": jo})
    step, flat, _ = C.load_checkpoint(str(tmp_path / "ref"))
    template = {"params": params, "opt": adamw_init(params, AdamWConfig())}
    got = C.restore_sharded(template, checkpoint_from_jax(CFG, flat))
    want_p = param_dict_from_jax(CFG, jax.tree.map(np.asarray, jp), device="cpu")
    want_o = opt_state_from_jax(CFG, jax.tree.map(np.asarray, jo), device="cpu")
    assert step == 1 and int(got["opt"]["count"]) == 1
    for k in want_p:
        assert torch.equal(got["params"][k], want_p[k])
        assert torch.equal(got["opt"]["m"][k], want_o["m"][k])
        assert torch.equal(got["opt"]["v"][k], want_o["v"][k])
    C.save_checkpoint(str(tmp_path / "port"), 1, got)
    again = C.restore_sharded(template, C.load_checkpoint(str(tmp_path / "port"))[1])
    assert all(torch.equal(again["params"][k], want_p[k]) for k in want_p)


def test_async_checkpointer_copies_before_it_returns(tmp_path):
    saver = C.AsyncCheckpointer(str(tmp_path))
    x = torch.ones(1 << 16)
    saver.save(7, {"x": x})
    x.fill_(2.0)  # the next step's update must not reach the checkpoint
    saver.wait()
    assert C.latest_step(str(tmp_path)) == 7
    assert np.all(C.load_checkpoint(str(tmp_path))[1]["x"] == 1.0)


# ---------------------------------------------------------------------------
# loop: resume after crash, resume from disk
# ---------------------------------------------------------------------------


def _loop_setup():
    params = M.param_dict(M.init_params(CFG, 0, device="cpu"))
    ocfg = AdamWConfig(learning_rate=1e-3)
    stream = TokenStream(CFG.vocab_size, 16, 2, seed=0, device="cpu")
    return params, ocfg, adamw_init(params, ocfg), stream, make_train_step(CFG, ocfg, remat="none")


def test_loop_crash_recovery(tmp_path):
    params, ocfg, opt, stream, base_step = _loop_setup()
    crashes = {"armed": True}

    def flaky_step(p, o, b, ctx):
        if crashes["armed"] and int(o["count"]) == 7:
            crashes["armed"] = False
            raise RuntimeError("simulated node failure")
        return base_step(p, o, b, ctx)

    lc = LoopConfig(total_steps=12, ckpt_dir=str(tmp_path), ckpt_every=5, eval_every=100,
                    log_every=100, max_restarts=2)
    params2, opt2, state = run_training(lc, train_step=flaky_step, batch_at=stream.batch_at,
                                        params=params, opt_state=opt, ctx=healthy())
    assert state.restarts == 1
    assert state.step == 12
    assert int(opt2["count"]) == 12  # optimizer state restored + continued
    # the recovered run is the run that never failed
    clean_params, _, clean = run_training(LoopConfig(total_steps=12), train_step=base_step,
                                          batch_at=stream.batch_at, params=params, opt_state=opt,
                                          ctx=healthy())
    assert clean.restarts == 0 and len(clean.step_times) == 12
    for k in clean_params:
        assert torch.equal(params2[k], clean_params[k])


def test_loop_resume_from_disk(tmp_path):
    params, ocfg, opt, stream, step = _loop_setup()
    lc = LoopConfig(total_steps=6, ckpt_dir=str(tmp_path), ckpt_every=3, eval_every=100, log_every=100)
    run_training(lc, train_step=step, batch_at=stream.batch_at, params=params, opt_state=opt, ctx=healthy())
    # a second invocation picks up at 6 and continues to 9
    lc2 = LoopConfig(total_steps=9, ckpt_dir=str(tmp_path), ckpt_every=3, eval_every=100, log_every=100)
    p2, opt2, state = run_training(lc2, train_step=step, batch_at=stream.batch_at, params=params,
                                   opt_state=opt, ctx=healthy())
    assert state.step == 9
    assert int(opt2["count"]) == 9
    straight, _, _ = run_training(LoopConfig(total_steps=9), train_step=step, batch_at=stream.batch_at,
                                  params=params, opt_state=opt, ctx=healthy())
    for k in straight:
        assert torch.equal(p2[k], straight[k])


def test_loop_interrupt_lets_the_pending_checkpoint_land(tmp_path, monkeypatch):
    """An interrupt stops the run only after the checkpoint being written
    has landed, so running again resumes from it."""
    params, ocfg, opt, stream, step = _loop_setup()
    save = C.save_checkpoint

    def slow_save(*args, **kw):
        time.sleep(0.5)
        return save(*args, **kw)

    monkeypatch.setattr(C, "save_checkpoint", slow_save)

    def interrupted(p, o, b, ctx):
        if int(o["count"]) == 3:
            raise KeyboardInterrupt
        return step(p, o, b, ctx)

    lc = LoopConfig(total_steps=6, ckpt_dir=str(tmp_path), ckpt_every=3, eval_every=100, log_every=100)
    with pytest.raises(KeyboardInterrupt):
        run_training(lc, train_step=interrupted, batch_at=stream.batch_at, params=params, opt_state=opt,
                     ctx=healthy())
    assert C.latest_step(str(tmp_path)) == 3


def test_loop_raises_when_the_budget_is_spent(tmp_path):
    params, ocfg, opt, stream, _ = _loop_setup()

    def broken(p, o, b, ctx):
        raise RuntimeError("always fails")

    with pytest.raises(RuntimeError, match="always fails"):
        run_training(LoopConfig(total_steps=3), train_step=broken, batch_at=stream.batch_at,
                     params=params, opt_state=opt, ctx=healthy())


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli(tmp_path, ckpt=True):
    argv = ["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--steps", "30",
            "--batch", "4", "--seq", "16", "--fault-rate", "0.1", "--eval-every", "5"]
    if ckpt:
        argv += ["--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "5"]
    return train_cli.main(argv)


def _stop_at(monkeypatch, n):
    """Make the CLI's train step interrupt the run, as a preemption would,
    once the optimizer has taken ``n`` steps."""
    make = step_lib.make_jit_train_step

    def make_stoppable(*args, **kw):
        step = make(*args, **kw)

        def stoppable(p, o, b, ctx):
            if int(o["count"]) == n:
                raise KeyboardInterrupt
            return step(p, o, b, ctx)

        return stoppable

    monkeypatch.setattr(step_lib, "make_jit_train_step", make_stoppable)


def test_train_cli_runs_resumes_and_prints_the_reference_lines(tmp_path, capsys, monkeypatch):
    """Interrupted at 25 of 30 steps (past the 20 warmup steps, so the
    cosine decay runs), the same command run again resumes from the step-25
    checkpoint and follows the straight run."""
    with monkeypatch.context() as m:
        _stop_at(m, 25)
        with pytest.raises(KeyboardInterrupt):
            _cli(tmp_path)
    out = capsys.readouterr().out
    assert out.startswith("arch=smollm-135m layers=2 d=64 params=")
    assert "fault map: rate=" in out and "step 10: loss=" in out and "eval_accuracy=" in out
    assert C.latest_step(str(tmp_path / "ckpt")) == 25
    params, opt, state = _cli(tmp_path)
    assert state.step == 30 and int(opt["count"]) == 30 and len(state.step_times) == 5
    assert "restarts=0" in capsys.readouterr().out and state.restarts == 0
    straight, _, _ = _cli(tmp_path, ckpt=False)
    rtol, atol = dtype_tol(F32, atol_scale=100)
    for k in straight:
        np.testing.assert_allclose(params[k].numpy(), straight[k].numpy(), rtol=rtol, atol=atol)


def test_training_entry_points_refuse_the_host_unless_asked(monkeypatch):
    from repro_torch.train.fat_trainer import LMFATTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: train_cli.main(["--arch", "smollm-135m", "--reduced"]),
                 lambda: TokenStream(97, 8, 2),
                 lambda: LMFATTrainer(CFG, pretrain_steps=0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# FAT actually recovers accuracy (end-to-end learning check)
# ---------------------------------------------------------------------------


def test_lm_fat_recovers_accuracy():
    params = M.param_dict(M.init_params(CFG, 0, device="cpu"))
    ocfg = AdamWConfig(learning_rate=3e-3)
    stream = TokenStream(CFG.vocab_size, 32, 8, seed=1, noise=0.02, device="cpu")
    step = make_train_step(CFG, ocfg, remat="none")
    ev = make_eval_step(CFG, remat="none")
    opt = adamw_init(params, ocfg)
    for i in range(120):
        params, opt, m = step(params, opt, stream.batch_at(i), healthy())
    healthy_acc = float(ev(params, stream.batch_at(10_000), healthy())["accuracy"])
    assert healthy_acc > 0.5, f"healthy model failed to learn: {healthy_acc}"
    fm = random_fault_map(5, CFG.array_rows, CFG.array_cols, 0.25)
    ctx = from_fault_map(fm, device="cpu")
    faulty_acc = float(ev(params, stream.batch_at(10_000), ctx)["accuracy"])
    opt = adamw_init(params, ocfg)
    for i in range(60):
        params, opt, m = step(params, opt, stream.batch_at(1000 + i), ctx)
    fat_acc = float(ev(params, stream.batch_at(10_000), ctx)["accuracy"])
    assert fat_acc > faulty_acc + 0.02, (healthy_acc, faulty_acc, fat_acc)
