"""FATTrainer implementations — the bridge between the eFAT orchestrator
(``repro_torch.core.efat``) and the training substrate.

``ClassifierFATTrainer`` — the paper-faithful trainer: a pre-trained MLP on
the Gaussian-cluster task; steps-to-constraint at a given fault rate is
measurable in seconds, so the full Step-1 resilience sweep (rates x
repeats) runs in minutes like the paper's CIFAR runs.

Both trainers delegate every training loop to a FAT *engine*
(``repro_torch.train.population``): ``engine="population"`` (default)
trains a whole batch of fault maps as one vmapped step;
``engine="serial"`` is the one-map-at-a-time reference the population path
is proven equivalent to. On top of the single-map ``FATTrainerFull``
protocol they expose the batch protocol (``steps_to_constraint_batch`` /
``train_batch`` / ``evaluate_batch``) that the Step-1 sweep and Step-4 plan
execution use to submit entire populations.

It runs on the card unless ``device="cpu"`` is asked for: with no card and
no device named, it raises.

``LMFATTrainer`` — the same protocol over a language model with the
``TokenStream`` data pipeline: a reduced arch in the CPU tests, SmolLM-135M
at full width on the card.

Evaluation takes ``mode="kernel"`` for the deployment check: the engine's
batched evaluation, in which each masked GEMM is one chip-batched kernel
launch for a chunk's chips (``evaluate_metric`` runs one chip at a time).
Training always runs the plain masked product: a ``kernel``-mode fit on the
card raises in the engines.

``engine="sharded"`` builds ``repro_torch.fleet.sharding.
ShardedPopulationEngine`` over a pop mesh (``engine_kwargs=dict(mesh=...)``),
with the trainer's param axes and config for a 2-D fleet mesh.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

from torch.func import grad_and_value

from repro_torch.core.faults import FaultMap
from repro_torch.core.masking import from_fault_map, healthy, mask_params, mask_selected_params
from repro_torch.data.synthetic import TokenStream, make_classification_task
from repro_torch.device import resolve_device
from repro_torch.fleet.scheduler import FleetScheduler
from repro_torch.models.classifier import classifier_loss, classifier_param_axes, init_classifier
from repro_torch.models.model import init_params, loss_fn, param_dict, param_specs
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.population import make_fat_engine

__all__ = ["ClassifierFATTrainer", "LMFATTrainer"]


class _EngineBackedTrainer:
    """Shared protocol plumbing: single-map methods are the batch methods
    with a population of one; the engine decides how batches execute.

    Every batch submission routes through one :class:`FleetScheduler`: jobs
    are packed into population chunks by cost — the prescribed step budget
    for ``train_batch`` (Step 4), the fault rate as cost proxy for
    ``steps_to_constraint_batch`` (Step 1) — then results are mapped back to
    caller order. Per-member results are chunk-invariant, so scheduling
    changes only wall-clock/wasted lanes, never the math."""

    # subclasses set: device, engine (FAT engine), scheduler, base_params,
    # and the batch fns
    #   _probe_batch_fn  — steps_to_constraint stream (batch_fn(1..max))
    #   _train_batch_fn  — consolidated-FAT stream (batch_fn(0..steps-1))

    def _make_scheduler(self, policy: str) -> FleetScheduler:
        # a sharded engine's chunks tile its pop extent; waste accounting
        # counts the same padding lanes the chunk runs
        return FleetScheduler.for_engine(self.engine, policy=policy)

    @staticmethod
    def _engine_kwargs(engine: str, cfg, param_axes, engine_kwargs: Optional[dict]) -> dict:
        """The arch and param layout for the engine: every engine takes
        ``param_axes`` (vmap and serial ignore it); the sharded engine also
        takes ``cfg`` for its 2-D meshes' rules."""
        kw = dict(engine_kwargs or {})
        kw.setdefault("param_axes", param_axes)
        if engine == "sharded":
            kw.setdefault("cfg", cfg)
        return kw

    def _context(self, fm: FaultMap, mode: str = "fap"):
        return from_fault_map(fm, mode, device=self.device)

    def evaluate_params(self, params, ctx) -> float:
        return self.engine.evaluate_one(params, ctx)

    @property
    def grad_fn(self):
        """``(params, batch, ctx) -> ((loss, metrics), grads)`` over this
        trainer's objective, the reference's ``value_and_grad`` order — for
        custom loops that step outside the engine."""
        fn = getattr(self, "_grad_fn_cache", None)
        if fn is None:
            inner = grad_and_value(self.engine.loss_fn, has_aux=True)

            def fn(params, batch, ctx):
                grads, value = inner(params, batch, ctx)
                return value, grads

            self._grad_fn_cache = fn
        return fn

    def _obs_schedule(self, what: str, sched) -> None:
        """Scheduling decisions are host-side and cheap — surface each one
        as an instant on the engine's recorder (no-op when obs is off)."""
        rec = getattr(self.engine, "obs", None)
        if rec:
            rec.instant(
                "schedule", proc="train", track="scheduler",
                args=dict(what=what, policy=sched.policy, jobs=len(sched.order),
                          chunks=len(sched.chunks),
                          wasted_steps=sched.wasted_steps,
                          span_steps=sched.span_steps),
            )

    # ---- FATTrainerFull protocol (single map + batched) -----------------
    def steps_to_constraint(
        self, fault_map: FaultMap, constraint: float, max_steps: int
    ) -> Optional[int]:
        return self.steps_to_constraint_batch([fault_map], constraint, max_steps)[0]

    def steps_to_constraint_batch(
        self, fault_maps: Sequence[FaultMap], constraint: float, max_steps: int
    ) -> list[Optional[int]]:
        ctxs = [self._context(fm) for fm in fault_maps]
        # required steps are what we're measuring — pack by fault rate, the
        # best prior (chunks run until their slowest member crosses)
        sched = self.scheduler.schedule([fm.fault_rate for fm in fault_maps])
        self._obs_schedule("probe", sched)
        out = self.engine.steps_to_constraint_batch(
            self.base_params, sched.permute(ctxs), constraint, max_steps,
            self._probe_batch_fn,
        )
        return sched.unpermute(out)

    def train(self, fault_map: FaultMap, steps: int):
        return self.train_batch([fault_map], [steps])[0]

    def train_batch(self, fault_maps: Sequence[FaultMap], steps: Sequence[int]) -> list:
        ctxs = [self._context(fm) for fm in fault_maps]
        budgets = [int(s) for s in steps]
        sched = self.scheduler.schedule(budgets)
        self._obs_schedule("train", sched)
        trained = self.engine.fit_batch(
            self.base_params, sched.permute(ctxs), sched.permute(budgets),
            self._train_batch_fn,
        )
        trained = sched.unpermute(trained)
        # ship FAP'd weights: weights on faulty PEs are zero in the artifact
        return [self._ship(p, ctx) for p, ctx in zip(trained, ctxs)]

    @staticmethod
    def _ship(params: dict, ctx) -> dict:
        return mask_params(params, ctx)

    def evaluate(self, params, fault_map: FaultMap, mode: str = "fap") -> float:
        return self.evaluate_batch([params], [fault_map], mode)[0]

    def evaluate_batch(
        self, params_list: Sequence[Any], fault_maps: Sequence[FaultMap], mode: str = "fap"
    ) -> list[float]:
        """Each chip's metric with its params under its own map, through the
        engine's batched evaluation. ``mode`` is the fault context's: ``fap``
        or ``kernel`` (the deployment path: each masked GEMM one chip-batched
        kernel launch for a chunk's chips)."""
        ctxs = [self._context(fm, mode) for fm in fault_maps]
        return self.engine.evaluate_batch(list(params_list), ctxs)


class ClassifierFATTrainer(_EngineBackedTrainer):
    """Paper SIV setup: pre-trained classifier + FAT per fault map."""

    def __init__(
        self,
        cfg,
        *,
        seed: int = 0,
        batch_size: int = 256,
        lr: float = 3e-3,
        pretrain_steps: int = 400,
        eval_every: int = 5,
        eval_batches: int = 2,
        engine: str = "population",
        population_size: int = 16,
        schedule: str = "lpt",
        engine_kwargs: Optional[dict] = None,
        device=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.data = make_classification_task(cfg, seed=seed, device=self.device)
        self.batch_size = batch_size
        self.eval_every = eval_every
        self.opt_cfg = AdamWConfig(learning_rate=lr, weight_decay=0.0, grad_clip_norm=1.0)
        self._evals = self.data.eval_batches(n=eval_batches)

        # stable batch fns; salts match the reference's trainer
        def probe_batch(s):
            return self.data.batch_at(s, batch_size)

        def fat_batch(s):
            return self.data.batch_at(s + 1_000_003, batch_size)

        self._probe_batch_fn = probe_batch
        self._pretrain_batch_fn = probe_batch  # pretrain salt is 0
        self._train_batch_fn = fat_batch

        self.engine = make_fat_engine(
            engine,
            loss_fn=lambda p, b, ctx: classifier_loss(p, b, cfg, ctx),
            opt_cfg=self.opt_cfg,
            eval_batches=self._evals,
            metric="accuracy",
            higher_is_better=True,
            eval_every=eval_every,
            population_size=population_size,
            **self._engine_kwargs(engine, cfg, classifier_param_axes(cfg), engine_kwargs),
        )
        self.scheduler = self._make_scheduler(schedule)
        self.base_params = init_classifier(cfg, seed, in_dim=self.data.dim, device=self.device)
        # pre-train the healthy model (the user-provided pre-trained DNN)
        self.base_params = self.engine.fit_batch(
            self.base_params, [healthy()], [pretrain_steps], self._pretrain_batch_fn
        )[0]
        self.baseline_accuracy = self.evaluate_params(self.base_params, healthy())


class LMFATTrainer(_EngineBackedTrainer):
    """The same protocol over a language model (a reduced arch for CPU
    tests), with the reference's batch salts and defaults.

    It ships FAP on the array-mapped GEMM weights only
    (``mask_selected_params``): the embedding stays whole (the lookup reads
    unmasked rows; the tied unembed masks at use) and so do the norm
    scales, so a shipped model evaluates as it was trained. The reference
    ships ``mask_params``, which on its layer-stacked tree also zeroes
    embedding entries and norm scales (ROADMAP.md §3)."""

    def __init__(
        self,
        cfg,
        *,
        seed: int = 0,
        batch_size: int = 8,
        seq_len: int = 64,
        lr: float = 1e-3,
        pretrain_steps: int = 150,
        eval_every: int = 10,
        eval_batches: int = 2,
        metric: str = "accuracy",
        engine: str = "population",
        population_size: int = 4,
        schedule: str = "lpt",
        engine_kwargs: Optional[dict] = None,
        device=None,
    ):
        self.cfg = cfg
        self.metric = metric
        self.device = resolve_device(device)
        self.stream = TokenStream(cfg.vocab_size, seq_len, batch_size, seed=seed, device=self.device)
        self.eval_every = eval_every
        self.opt_cfg = AdamWConfig(learning_rate=lr, weight_decay=0.0)

        def probe_batch(s):
            return self.stream.batch_at(s)

        def fat_batch(s):
            return self.stream.batch_at(s + 999_983)

        def pretrain_batch(s):
            return self.stream.batch_at(s + 999_983 * 7)

        self._probe_batch_fn = probe_batch
        self._train_batch_fn = fat_batch
        self._pretrain_batch_fn = pretrain_batch

        self.base_params = param_dict(init_params(cfg, seed, device=self.device))
        self._evals = [self.stream.batch_at(10_000_000 + i) for i in range(eval_batches)]
        self.engine = make_fat_engine(
            engine,
            loss_fn=lambda p, b, ctx: loss_fn(p, b, cfg, ctx, remat="none"),
            opt_cfg=self.opt_cfg,
            eval_batches=self._evals,
            metric=metric,
            higher_is_better=metric != "loss",  # higher-is-better protocol
            eval_every=eval_every,
            population_size=population_size,
            **self._engine_kwargs(engine, cfg, param_specs(cfg), engine_kwargs),
        )
        self.scheduler = self._make_scheduler(schedule)
        self.base_params = self.engine.fit_batch(
            self.base_params, [healthy()], [pretrain_steps], self._pretrain_batch_fn
        )[0]
        self.baseline_metric = self.evaluate_params(self.base_params, healthy())

    @staticmethod
    def _ship(params: dict, ctx) -> dict:
        return mask_selected_params(params, ctx)
