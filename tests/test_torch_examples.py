"""The port's three examples of the reference's ``examples/`` (quickstart,
serve_faulty_chip, fleet_retraining) against the reference package, on the
CPU at reduced step counts.

Each example's data and initial parameters are monkeypatched to the
reference's (its ``TokenStream`` batches or ``ClusterData``, handed over as
numpy; its ``init_params`` or ``init_classifier``, converted), as
``tests/test_torch_lm_fat.py`` and ``tests/test_torch_efat.py`` hold the
trainers. Tolerances: losses, accuracies and metrics within 2e-3 (the
trainers' tests' ``METRIC_TOL``: the two packages sum in other orders over
a few AdamW steps); counts and printed tables for equality. Each test takes
well under 20 s on one worker.
"""
import re
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_config as jax_reduce_config
from repro.core import from_fault_map as jax_from_fault_map
from repro.core import healthy as jax_healthy
from repro.core import random_fault_map as jax_random_fault_map
from repro.core.masking import mask_params as jax_mask_params
from repro.data.synthetic import TokenStream as JaxTokenStream
from repro.data.synthetic import make_classification_task as jax_make_classification_task
from repro.models import model as JM
from repro.models.classifier import init_classifier as jax_init_classifier
from repro.serve import ContinuousBatchingEngine as JaxContinuousBatchingEngine
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import dense_kv_bytes as jax_dense_kv_bytes
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.step import make_eval_step as jax_make_eval_step
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.convert import classifier_params_from_jax, params_from_jax
from repro_torch.examples import fleet_retraining, quickstart, serve_faulty_chip
from repro_torch.models import model as M
from repro_torch.train import fat_trainer as T

ROOT = Path(__file__).resolve().parents[1]
METRIC_TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast, and
    keeps parallel test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _RefStream:
    """The reference's TokenStream behind the port's interface; each batch
    converted once."""

    def __init__(self, vocab_size, seq_len, batch_size, seed=0, noise=0.1, device=None):
        self.jstream, self.cache = JaxTokenStream(vocab_size, seq_len, batch_size, seed=seed, noise=noise), {}

    def batch_at(self, step):
        if step not in self.cache:
            self.cache[step] = {k: torch.from_numpy(np.asarray(v).astype(np.int64))
                                for k, v in self.jstream.batch_at(step).items()}
        return self.cache[step]


def _ref_lm(monkeypatch, module, arch):
    """The example's stream and initial params are the reference's; returns
    the reference's reduced config and its params at seed 0."""
    jcfg = jax_reduce_config(jax_get_arch(arch))
    jparams, _ = JM.init_params(jcfg, jax.random.PRNGKey(0))
    monkeypatch.setattr(module, "TokenStream", _RefStream)
    monkeypatch.setattr(M, "init_params", lambda cfg, seed=0, device=None: params_from_jax(
        cfg, jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(seed))[0]), device=device))
    return jcfg, jparams


def _ref_train(jcfg, jparams, stream, steps, start, ctx):
    """The reference's AdamW steps as its examples take them: (params,
    per-step metrics)."""
    ocfg = JaxAdamWConfig(learning_rate=3e-3)
    train = jax.jit(jax_make_train_step(jcfg, ocfg, remat="none"))
    opt, out = jax_adamw_init(jparams, ocfg), []
    for i in range(steps):
        jparams, opt, m = train(jparams, opt, stream.batch_at(start + i), ctx)
        out.append({k: float(v) for k, v in m.items()})
    return jparams, out


def _close(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("loss", "accuracy"):
            assert g[k] == pytest.approx(w[k], abs=METRIC_TOL), k


def test_quickstart_matches_the_reference_steps(monkeypatch):
    """A few pretraining and FAT steps of the quickstart, its evaluations in
    kernel mode (the plain version on the host), against the reference's
    quickstart sequence with as many steps."""
    jcfg, jparams = _ref_lm(monkeypatch, quickstart, "smollm-135m")
    got = quickstart.run("cpu", "kernel", pretrain_steps=6, fat_steps=4, log=lambda *a: None)
    stream = JaxTokenStream(jcfg.vocab_size, seq_len=32, batch_size=8, seed=1, noise=0.02)
    evaluate = jax.jit(jax_make_eval_step(jcfg, remat="none"))
    eval_batch = stream.batch_at(10_000_000)
    jparams, pre = _ref_train(jcfg, jparams, stream, 6, 0, jax_healthy())
    acc0 = float(evaluate(jparams, eval_batch, jax_healthy())["accuracy"])
    fm = jax_random_fault_map(7, jcfg.array_rows, jcfg.array_cols, fault_rate=0.25, chip_id="chip-7")
    ctx = jax_from_fault_map(fm)
    acc_f = float(evaluate(jparams, eval_batch, ctx)["accuracy"])
    jparams, fat = _ref_train(jcfg, jparams, stream, 4, 1000, ctx)
    acc_fat = float(evaluate(jparams, eval_batch, ctx)["accuracy"])
    _close(got["pretrain"], pre)
    _close(got["fat"], fat)
    for key, want in (("acc0", acc0), ("acc_faulty", acc_f), ("acc_fat", acc_fat)):
        assert got[key] == pytest.approx(want, abs=METRIC_TOL), key
    assert got["acc_faulty"] < got["acc0"]


def test_serve_faulty_chip_pins_continuous_to_static_and_counts_as_the_reference(monkeypatch):
    """The continuous engine's tokens are the static engine's (the example
    checks, with no near-tie allowed on the host), and its dispatches and KV
    bytes, and the static engine's, are the reference's on the same
    requests and converted weights."""
    jcfg, jparams = _ref_lm(monkeypatch, serve_faulty_chip, "qwen3-0.6b")
    got = serve_faulty_chip.run("cpu", "kernel", pretrain_steps=4, fat_steps=3, log=lambda *a: None)
    assert got["ties"] == []
    for rid, toks in got["static_tokens"].items():
        assert np.array_equal(got["outputs"][rid].tokens, toks), rid

    stream = JaxTokenStream(jcfg.vocab_size, 32, 8, seed=2, noise=0.02)
    jparams, _ = _ref_train(jcfg, jparams, stream, 4, 0, jax_healthy())
    fm = jax_random_fault_map(3, jcfg.array_rows, jcfg.array_cols, 0.2, chip_id="edge-3")
    ctx = jax_from_fault_map(fm)
    jparams, _ = _ref_train(jcfg, jparams, stream, 3, 500, ctx)
    shipped = jax_mask_params(jparams, ctx)
    tok = lambda i, n: np.asarray(stream.batch_at(40 + i)["tokens"][0, :n])
    requests = [JaxRequest(0, tok(0, 16), max_new_tokens=4), JaxRequest(1, tok(1, 12), max_new_tokens=24),
                JaxRequest(2, tok(2, 8), max_new_tokens=6, arrival=2), JaxRequest(3, tok(3, 20), max_new_tokens=8, arrival=4),
                JaxRequest(4, tok(4, 6), max_new_tokens=16, arrival=4),
                JaxRequest(5, tok(5, 10), max_new_tokens=5, arrival=9)]
    _, stats = JaxContinuousBatchingEngine(jcfg, shipped, ctx, num_slots=2, page_size=8, num_pages=64).serve(requests)
    static = JaxServeEngine(jcfg, shipped, ctx, max_len=None, page_size=8)
    kv = max(jax_dense_kv_bytes(jcfg, 1, static.cache_len_for(len(r.tokens), r.max_new_tokens)) for r in requests)
    assert got["stats"].as_dict() == stats.as_dict()
    assert got["static_dispatches"] == sum(r.max_new_tokens for r in requests)
    assert got["static_peak_kv_bytes"] == kv
    assert got["stats"].decode_dispatches < got["static_dispatches"]


class _RefData:
    """The reference's ClusterData behind the port's interface; each batch
    drawn once."""

    def __init__(self, jdata):
        self.jdata, self.dim, self.cache = jdata, jdata.dim, {}

    def batch_at(self, step, batch_size=256, split="train"):
        key = (step, batch_size, split)
        if key not in self.cache:
            self.cache[key] = self._torch(self.jdata.batch_at(step, batch_size, split))
        return self.cache[key]

    def eval_batches(self, n=4, batch_size=512):
        return [self._torch(b) for b in self.jdata.eval_batches(n, batch_size)]

    @staticmethod
    def _torch(jbatch):
        return {"x": torch.from_numpy(np.array(jbatch["x"])),
                "labels": torch.from_numpy(np.asarray(jbatch["labels"]).astype(np.int64))}


def _table(out: str) -> list:
    """The printed results without the wall times and the device."""
    lines = [re.sub(r" *\(\d+s( on \w+)?\)| *\[\d+s\]| on \w+\)", "", line) for line in out.splitlines()]
    return [line for line in lines if line.strip()]


def test_fleet_retraining_cli_prints_the_reference_table(monkeypatch, capsys):
    """``python -m repro_torch.examples.fleet_retraining --chips 8`` on the
    reference's data and initial params prints the reference example's
    lines at ``--chips 8``: the pretrained accuracy, the fleet, the
    resilience map, the four methods' jobs, steps and satisfied fractions,
    and the scheduler's packing."""
    jcfg = jax_get_arch("paper-mlp")
    monkeypatch.setattr(T, "make_classification_task",
                        lambda cfg, seed=0, device=None: _RefData(jax_make_classification_task(jcfg, seed=seed)))
    monkeypatch.setattr(T, "init_classifier", lambda cfg, seed, in_dim, device=None: classifier_params_from_jax(
        jax.tree.map(np.asarray, jax_init_classifier(jcfg, jax.random.PRNGKey(seed), in_dim)), device=device))
    assert fleet_retraining.main(["--chips", "8", "--device", "cpu"]) == 0
    got = _table(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["fleet_retraining.py", "--chips", "8"])
    runpy.run_path(str(ROOT / "examples" / "fleet_retraining.py"), run_name="__main__")
    want = _table(capsys.readouterr().out)
    assert got == want
    assert any(line.startswith("eFAT ") for line in got) and any(line.startswith("scheduler") for line in got)
