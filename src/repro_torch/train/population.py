"""Population FAT engines — train a fleet of fault maps as one batched step.

The whole point of eFAT is amortizing retraining over many faulty chips,
yet a naive pipeline trains one fault map at a time: the Step-1 resilience
sweep, Step-4 plan execution and every SIV-C baseline differ per job only
in a tiny (R, C) mask. So a population of N jobs is a batched context
(leading population axis on ``ok``, one shared mode) plus per-member
``(params, opt_state)`` stacked on a leading axis, and ``torch.func.vmap``
turns one member's step into one batched step for all of them:

* :class:`PopulationFATEngine` — one member's step is
  ``torch.func.grad_and_value`` of the loss followed by ``adamw_update``;
  the population's step is ``vmap`` of that, the mask on ``in_dims=0`` and
  the batch shared. ``fit_batch`` runs ``max(budgets)`` steps and, once a
  member's budget is spent, copies its old state back over its slot of the
  update's output (in place: the step holds no third copy of the state),
  so a member stops exactly at its own budget, as if it had been trained
  alone.
  ``steps_to_constraint_batch`` runs eval-period chunks and latches each
  member's first constraint crossing on the device; the host reads one
  boolean per eval period (has every member crossed?), which is the
  reference's ``while_loop`` condition and the loop's only sync.
* :class:`SerialFATEngine` — the reference implementation (one Python loop
  per member), kept behind ``engine="serial"`` to prove the population
  engine equivalent.

This is the reference's ``train/population.py``: the same interface,
chunking, padding and recorder spans, counts and instants. A third engine,
``repro_torch.fleet.sharding.ShardedPopulationEngine`` (``engine="sharded"``),
subclasses the population engine and runs the same run bodies on
sub-populations, one per slice of a "pop" mesh axis, with member state
stored split over a "model" axis through the layout hooks below. Training
always runs the plain masked product under autograd, as the reference's
does: its masked-GEMM kernel is forward only, and neither package has a
masked-GEMM backward. So a ``kernel``-mode fit or steps-to-constraint on a
CUDA device raises ``NotImplementedError`` instead of running another mode
quietly; on the CPU, ``kernel`` mode runs the kernel's plain version
(``masked_matmul_ref``) under vmap and grad, as the reference's ``pallas``
mode runs ``fap`` math off the TPU. Evaluation is forward only: a
``kernel``-mode ``evaluate_batch`` on the card runs the population's
``vmap``, and each masked GEMM in it is one chip-batched launch of the
kernel (the custom op's vmap rule), the counterpart of the reference's
``pallas`` mode under ``jit(vmap)``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
from torch.func import grad_and_value, vmap
from torch.utils import _pytree as pytree

from repro_torch.core.masking import FaultContext, healthy, stack_contexts
from repro_torch.obs.recorder import NULL_RECORDER, Recorder
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["PopulationFATEngine", "SerialFATEngine", "evaluate_metric", "make_fat_engine"]

# steps-to-constraint bucket ladder (training steps, not seconds)
STEPS_BUCKETS = (0.0, 5.0, 10.0, 20.0, 40.0, 80.0, 160.0, 320.0, 640.0, 1280.0)

# batch_fn(step) -> batch dict of tensors on the engine's device
BatchFn = Callable[[int], dict]


def _tree_map(fn, *trees):
    """``fn`` over the tensors of pytrees of one structure: nested dicts,
    and the pieces of a split leaf (the sharded engine's tensor-parallel
    layout, a registered pytree node)."""
    return pytree.tree_map(fn, trees[0], *trees[1:])


def _stack_trees(trees: Sequence[Any]):
    return _tree_map(lambda *xs: torch.stack(xs), *trees)


def _member_slice(tree, i: int):
    return _tree_map(lambda x: x[i], tree)


def _device_of(params: dict) -> torch.device:
    return pytree.tree_leaves(params)[0].device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _refuse_kernel_on_card(ctx: Optional[FaultContext], what: str) -> None:
    """Off the CPU a ``kernel`` context reaches the card kernel, which has
    no backward: training refuses it (``evaluate_batch``, forward only,
    runs it chip-batched); only the CPU trains on its plain version."""
    if ctx is not None and ctx.active and ctx.mode == "kernel" and ctx.ok.device.type != "cpu":
        raise NotImplementedError(
            f"{what} in 'kernel' mode on a {ctx.ok.device.type} device: training runs the plain masked "
            "product with autograd, as the reference does (its masked-GEMM kernel is "
            "forward only), and no masked-GEMM backward exists in either package; "
            "train in 'fap' mode and deploy the shipped weights through 'kernel' mode "
            "(evaluate_batch, a serving engine, or the fleet engines for many chips at once)"
        )


def _drain(run):
    """Run a run body (a generator that yields after each issued step) to
    its end, and return what it returns."""
    while True:
        try:
            next(run)
        except StopIteration as stop:
            return stop.value


class PopulationFATEngine:
    """vmap FAT over a population of fault maps.

    Parameters
    ----------
    loss_fn : ``(params, batch, ctx) -> (loss, metrics)`` — the per-member
        training objective; ``metrics[metric]`` is the constraint metric.
    opt_cfg : AdamW settings shared by every member.
    eval_batches : the fixed eval batches, evaluated for every member.
    metric / higher_is_better : constraint metric key and its direction
        (``loss`` style metrics are negated so 'metric >= constraint' is
        uniform, matching the serial engine's protocol).
    eval_every : periodic-eval interval inside ``steps_to_constraint_batch``.
    population_size : max members per batched step; larger batches are
        chunked (memory trade-off).
    param_axes : optional logical-axes tree mirroring the params
        (``repro_torch.launch.sharding`` names, e.g.
        ``models.model.param_specs(cfg)``). Ignored by this engine and the
        serial one; the sharded engine stores member state split over the
        "model" axis of a 2-D ``("pop", "model")`` mesh by it.
    recorder : optional :class:`repro_torch.obs.recorder.Recorder`. Per-lane
        telemetry is collected on the host at chunk boundaries — chunk spans
        with lane widths and wasted lane-steps, per-member
        constraint-crossing instants, steps-consumed-vs-budget counters.
    """

    kind = "population"

    def __init__(
        self,
        *,
        loss_fn,
        opt_cfg: AdamWConfig,
        eval_batches: Sequence[dict],
        metric: str = "accuracy",
        higher_is_better: bool = True,
        eval_every: int = 5,
        population_size: int = 16,
        param_axes: Optional[Any] = None,
        recorder: Optional[Recorder] = None,
    ):
        self.loss_fn = loss_fn
        self.opt_cfg = opt_cfg
        self.metric = metric
        self.higher_is_better = higher_is_better
        self.eval_every = int(eval_every)
        self.population_size = max(1, int(population_size))
        self.param_axes = param_axes
        self.obs = recorder if recorder is not None else NULL_RECORDER
        self.eval_batches = list(eval_batches)
        self._grad = grad_and_value(loss_fn, has_aux=True)

    # -- per-member building blocks (always run under vmap) ---------------

    @staticmethod
    def _ctx(ok, mode: str) -> FaultContext:
        """A member's context from its map, or from a dict of its map rolled
        to each split-weight origin (``_constrain_masks``; key (0, 0) is the
        map itself)."""
        if ok is None:
            return healthy()
        if isinstance(ok, dict):
            return FaultContext(ok=ok[(0, 0)], mode=mode, rolled=ok)
        return FaultContext(ok=ok, mode=mode)

    def _member_eval(self, params, ok, mode: str, batches: Sequence[dict]):
        ctx = self._ctx(ok, mode)
        vals = [self.loss_fn(params, b, ctx)[1][self.metric] for b in batches]
        v = torch.stack(vals).mean()
        return v if self.higher_is_better else -v

    def _member_update(self, params, opt, ok, batch, mode: str):
        grads, _ = self._grad(params, batch, self._ctx(ok, mode))
        params, opt, _ = adamw_update(grads, opt, params, self.opt_cfg)
        return params, opt

    def _update(self, mode: str, ok_pop):
        """The population's step: ``(params, opt, ok, batch) -> (params, opt)``."""
        return vmap(
            lambda p, o, ok, b: self._member_update(p, o, ok, b, mode),
            in_dims=(0, 0, None if ok_pop is None else 0, None),
        )

    def _broadcast_members(self, params0: dict, n: int):
        def bcast(x):
            return x.unsqueeze(0).expand(n, *x.shape)

        return _tree_map(bcast, params0), _tree_map(bcast, adamw_init(params0, self.opt_cfg))

    # -- member-state layout hooks ------------------------------------------
    # The run bodies pass member (params, opt) through these at every step
    # boundary (the stored layout) and before every update and evaluation
    # (the compute layout). They are identity here. The sharded engine keeps
    # member state split over a 2-D mesh's "model" axis between steps; with
    # compute="gathered" it gathers it to full shape for the math, on its
    # pop slice's device, and with compute="sharded" the math runs on the
    # stored pieces themselves.

    def _constrain_member_state(self, params_pop, opt_pop):
        """The stored layout of member state between steps: as given here;
        split over the model positions in the sharded engine (a leaf already
        split, compute="sharded", is kept as it is)."""
        return params_pop, opt_pop

    def _gather_member_state(self, params_pop, opt_pop):
        """Member state laid out for an update step: full shape here and
        under compute="gathered"; the stored pieces under
        compute="sharded"."""
        return params_pop, opt_pop

    def _gather_member_params(self, params_pop):
        """Member params laid out for an evaluation: full shape here and
        under compute="gathered"; split (full params split, split ones kept)
        under compute="sharded"."""
        return params_pop

    def _constrain_batch(self, tree):
        """Non-member data entering the math (batches, the eval batches,
        params0): identity here; the sharded engine moves it to its pop
        slice's device."""
        return tree

    def _constrain_masks(self, ok_pop, params_pop):
        """The stacked masks entering the math, given the member params in
        their compute layout: the ``(n, R, C)`` stack here and under
        compute="gathered"; under compute="sharded" a dict of the stack
        rolled to each origin of ``params_pop``'s split leaves, keyed by the
        origin mod (R, C) (``_ctx`` reads it). A dict passes as it is."""
        return self._constrain_batch(ok_pop)

    @torch.no_grad()
    def _eval_pop(self, params_pop, ok_pop, mode: str) -> torch.Tensor:
        params_pop = self._gather_member_params(params_pop)
        ok_pop = None if ok_pop is None else self._constrain_masks(ok_pop, params_pop)
        batches = self._constrain_batch(self.eval_batches)
        return vmap(
            lambda p, ok: self._member_eval(p, ok, mode, batches),
            in_dims=(0, None if ok_pop is None else 0),
        )(params_pop, ok_pop)

    # -- the run bodies, one population chunk each ---------------------------
    # Each is a generator that yields after it has issued a step (an eval
    # period, in ``_steps_run``) and before any host read, and returns its
    # result: this engine drains one (``_drain``); the sharded engine
    # advances one per pop slice in lockstep.

    def _fit_run(self, params0, ok_pop, mode: str, budgets: list[int], batch_fn: BatchFn):
        """Every member trained to its own step budget: updates are computed
        for the whole population and overwritten with the old state once a
        member's budget is spent — the same trajectory as training each member alone
        for ``budgets[i]`` steps on the same batch schedule. Returns the
        params in the stored layout."""
        n = len(budgets)
        params, opt = self._constrain_member_state(*self._broadcast_members(params0, n))
        ok_pop = None if ok_pop is None else self._constrain_masks(ok_pop, params)
        update = self._update(mode, ok_pop)
        for i in range(max(budgets)):
            p, o = self._gather_member_state(params, opt)
            new_params, new_opt = update(p, o, ok_pop, self._constrain_batch(batch_fn(i)))
            spent = [j for j in range(n) if i >= budgets[j]]
            if spent:  # members whose budget is spent keep their state: one copy a leaf, in place
                idx = torch.tensor(spent, device=_device_of(params0))

                def keep(new, old):
                    at = idx.to(new.device)
                    new.index_copy_(0, at, old.index_select(0, at))

                _tree_map(keep, new_params, p)
                _tree_map(keep, new_opt, o)
            params, opt = self._constrain_member_state(new_params, new_opt)
            # drop the old state before the next step's forward: held, it would add a copy of the
            # members' state to that step's peak
            del new_params, new_opt, p, o
            yield
        return params

    def _steps_run(self, params0, ok_pop, mode: str, constraint: float, max_steps: int,
                   batch_fn: BatchFn):
        """Steps-to-constraint for a whole chunk in eval-period chunks.
        ``crossed[i]`` latches the first step at which member i's metric
        reached the constraint (sentinel max_steps + 1 when never); the loop
        ends as soon as every member has crossed, or at max_steps. Returns
        ``crossed`` as numpy."""
        ee = self.eval_every
        params, opt = self._constrain_member_state(*self._broadcast_members(params0, ok_pop.shape[0]))
        ok_pop = self._constrain_masks(ok_pop, params)
        update = self._update(mode, ok_pop)
        base = self._eval_pop(params, ok_pop, mode)
        crossed = torch.where(base >= constraint, 0, max_steps + 1)
        step = 0
        yield
        # the reference's while_loop condition; the one host read per period
        while step < max_steps and bool((crossed > max_steps).any()):
            p, o = self._gather_member_state(params, opt)
            for i in range(ee):
                p, o = update(p, o, ok_pop, self._constrain_batch(batch_fn(step + i + 1)))
            step += ee
            # a chunk overshooting max_steps is a step the serial reference
            # never evaluated, so it cannot cross
            if step <= max_steps:
                metric = self._eval_pop(p, ok_pop, mode)
                hit = (metric >= constraint) & (crossed > max_steps)
                crossed = torch.where(hit, step, crossed)
            params, opt = self._constrain_member_state(p, o)
            yield
        return crossed.cpu().numpy()

    # -- one chunk's run; the sharded engine splits it over its pop slices ---

    def _fit_chunk(self, params0, ok_pop, mode: str, budgets: list[int], batch_fn: BatchFn, keep: int):
        trained = _drain(self._fit_run(params0, ok_pop, mode, budgets, batch_fn))
        self._record_fit_output(trained, keep, len(budgets))
        return trained

    def _steps_chunk(self, params0, ok_pop, mode: str, constraint: float, max_steps: int,
                     batch_fn: BatchFn) -> np.ndarray:
        return _drain(self._steps_run(params0, ok_pop, mode, constraint, max_steps, batch_fn))

    def _eval_chunk(self, params_pop, ok_pop, mode: str) -> torch.Tensor:
        return self._eval_pop(params_pop, ok_pop, mode)

    def _record_fit_output(self, trained, keep: int, width: int) -> None:
        """Hook on each raw (still member-stacked, stored-layout) fit output
        before padding lanes are sliced off — the sharded engine records
        resident-byte stats here; no-op otherwise."""

    # -- chunking ---------------------------------------------------------

    def _chunks(self, n: int):
        size = max(1, min(self.population_size, n))
        for lo in range(0, n, size):
            keep = min(size, n - lo)
            yield lo, keep, size

    # -- engine interface -------------------------------------------------

    def fit_batch(
        self,
        params0: dict,
        contexts: Sequence[Optional[FaultContext]],
        budgets: Sequence[int],
        batch_fn: BatchFn,
    ) -> list:
        """Train one member per context from ``params0`` for its own budget
        of steps (batches ``batch_fn(0..budget-1)``); returns per-member
        params (NOT FAP-masked — shipping policy belongs to the trainer)."""
        if len(contexts) != len(budgets):
            raise ValueError("contexts and budgets must align")
        out: list = []
        for lo, keep, size in self._chunks(len(contexts)):
            chunk = list(contexts[lo : lo + keep])
            chunk_budgets = [int(b) for b in budgets[lo : lo + keep]]
            # pad with zero-budget copies: they ride along untouched
            chunk += [chunk[-1]] * (size - keep)
            chunk_budgets += [0] * (size - keep)
            stacked = stack_contexts([c or healthy() for c in chunk])
            _refuse_kernel_on_card(stacked, f"{type(self).__name__}.fit_batch")
            t0 = self.obs.now() if self.obs else 0.0
            trained = self._fit_chunk(params0, stacked.ok, stacked.mode, chunk_budgets, batch_fn, keep)
            if self.obs:
                _sync(_device_of(params0))
                maxb = max(chunk_budgets) if chunk_budgets else 0
                lane_steps = size * maxb  # padding lanes occupy real width
                wasted = lane_steps - sum(chunk_budgets)
                self.obs.span(
                    "fit_chunk", proc="train", track="engine", t0=t0,
                    args=dict(members=keep, width=size, max_budget=maxb,
                              budget_steps=sum(chunk_budgets),
                              wasted_lane_steps=wasted),
                )
                self.obs.count("train.members_trained", keep)
                self.obs.count("train.lane_steps", lane_steps)
                self.obs.count("train.budget_steps", sum(chunk_budgets))
                self.obs.count("train.wasted_lane_steps", wasted)
            out.extend(_member_slice(trained, i) for i in range(keep))
        return out

    def steps_to_constraint_batch(
        self,
        params0: dict,
        contexts: Sequence[FaultContext],
        constraint: float,
        max_steps: int,
        batch_fn: BatchFn,
    ) -> list[Optional[int]]:
        """Per-member steps until metric >= constraint (eval every
        ``eval_every`` steps, batches ``batch_fn(1..max_steps)``), or None
        when not reached within ``max_steps`` — one batched loop per chunk
        instead of per-member Python loops."""
        max_steps = int(max_steps)
        out: list[Optional[int]] = []
        for lo, keep, size in self._chunks(len(contexts)):
            chunk = list(contexts[lo : lo + keep])
            chunk += [chunk[-1]] * (size - keep)
            stacked = stack_contexts(chunk)
            if stacked.ok is None:
                raise ValueError("steps_to_constraint needs fault contexts")
            _refuse_kernel_on_card(stacked, f"{type(self).__name__}.steps_to_constraint_batch")
            t0 = self.obs.now() if self.obs else 0.0
            crossed = self._steps_chunk(params0, stacked.ok, stacked.mode, constraint, max_steps, batch_fn)
            if self.obs:
                # Every lane runs until the slowest member crosses (or
                # max_steps): realized lane-steps = width * max(realized).
                realized = [min(int(c), max_steps) for c in crossed[:keep]]
                worst = max(realized) if realized else 0
                lane_steps = size * worst
                wasted = lane_steps - sum(realized)
                self.obs.span(
                    "probe_chunk", proc="train", track="engine", t0=t0,
                    args=dict(members=keep, width=size, max_steps=max_steps,
                              realized_steps=worst, wasted_lane_steps=wasted),
                )
                self.obs.count("train.probe_lane_steps", lane_steps)
                self.obs.count("train.probe_wasted_lane_steps", wasted)
                for i, c in enumerate(crossed[:keep]):
                    if int(c) > max_steps:
                        self.obs.count("train.members_never_crossed")
                    else:
                        self.obs.observe(
                            "train.steps_to_constraint", float(c),
                            buckets=STEPS_BUCKETS,
                        )
                        self.obs.instant(
                            "constraint_crossed", proc="train", track="engine",
                            args=dict(member=lo + i, steps=int(c)),
                        )
            out.extend(None if int(c) > max_steps else int(c) for c in crossed[:keep])
        return out

    def evaluate_batch(
        self, params_list: Sequence[Any], contexts: Sequence[Optional[FaultContext]]
    ) -> list[float]:
        """Signed constraint metric of params_list[i] under contexts[i],
        vmapped across the population (chunked like training). In
        ``kernel`` mode on the card each masked GEMM of a chunk's forward is
        one chip-batched kernel launch."""
        if len(params_list) != len(contexts):
            raise ValueError("params and contexts must align")
        out: list[float] = []
        for lo, keep, size in self._chunks(len(contexts)):
            chunk_params = list(params_list[lo : lo + keep])
            chunk_ctx = list(contexts[lo : lo + keep])
            chunk_params += [chunk_params[-1]] * (size - keep)
            chunk_ctx += [chunk_ctx[-1]] * (size - keep)
            stacked = stack_contexts([c or healthy() for c in chunk_ctx])
            vals = self._eval_chunk(_stack_trees(chunk_params), stacked.ok, stacked.mode)
            out.extend(float(v) for v in vals[:keep].cpu())
        return out

    def evaluate_one(self, params, ctx: Optional[FaultContext]) -> float:
        return self.evaluate_batch([params], [ctx])[0]


class SerialFATEngine:
    """Reference serial implementation of the engine interface — one map at
    a time (``torch.func`` grad, eager optimizer, host-side periodic eval).
    Kept behind ``engine="serial"`` for equivalence tests and timing."""

    kind = "serial"

    def __init__(
        self,
        *,
        loss_fn,
        opt_cfg: AdamWConfig,
        eval_batches: Sequence[dict],
        metric: str = "accuracy",
        higher_is_better: bool = True,
        eval_every: int = 5,
        population_size: int = 16,  # interface parity; serial chunks are 1-wide
        param_axes: Optional[Any] = None,  # interface parity; serial never shards
        recorder: Optional[Recorder] = None,  # interface parity with population
    ):
        self.population_size = 1  # one member at a time — schedulers see no packing
        self.param_axes = param_axes
        self.obs = recorder if recorder is not None else NULL_RECORDER
        self.loss_fn = loss_fn
        self.opt_cfg = opt_cfg
        self.metric = metric
        self.higher_is_better = higher_is_better
        self.eval_every = int(eval_every)
        self.eval_batches = list(eval_batches)
        self._grad = grad_and_value(loss_fn, has_aux=True)

    def evaluate_one(self, params, ctx: Optional[FaultContext]) -> float:
        return evaluate_metric(self, params, ctx)

    def _step(self, params, opt, ctx: FaultContext, batch: dict):
        grads, _ = self._grad(params, batch, ctx)
        params, opt, _ = adamw_update(grads, opt, params, self.opt_cfg)
        return params, opt

    def _fit_one(self, params0, ctx: FaultContext, steps: int, batch_fn: BatchFn):
        _refuse_kernel_on_card(ctx, "SerialFATEngine.fit_batch")
        params, opt = params0, adamw_init(params0, self.opt_cfg)
        for s in range(int(steps)):
            params, opt = self._step(params, opt, ctx, batch_fn(s))
        return params

    def fit_batch(self, params0, contexts, budgets, batch_fn: BatchFn) -> list:
        if len(contexts) != len(budgets):
            raise ValueError("contexts and budgets must align")
        return [
            self._fit_one(params0, ctx or healthy(), steps, batch_fn)
            for ctx, steps in zip(contexts, budgets)
        ]

    def steps_to_constraint_batch(
        self, params0, contexts, constraint, max_steps, batch_fn: BatchFn
    ) -> list[Optional[int]]:
        out: list[Optional[int]] = []
        for ctx in contexts:
            _refuse_kernel_on_card(ctx, "SerialFATEngine.steps_to_constraint_batch")
            if self.evaluate_one(params0, ctx) >= constraint:
                out.append(0)  # paper Fig. 3: relaxed constraints may need no retraining
                continue
            params, opt = params0, adamw_init(params0, self.opt_cfg)
            found: Optional[int] = None
            for s in range(1, int(max_steps) + 1):
                params, opt = self._step(params, opt, ctx, batch_fn(s))
                if s % self.eval_every == 0 and self.evaluate_one(params, ctx) >= constraint:
                    found = s
                    break
            out.append(found)
        return out

    def evaluate_batch(self, params_list, contexts) -> list[float]:
        if len(params_list) != len(contexts):
            raise ValueError("params and contexts must align")
        return [self.evaluate_one(p, c) for p, c in zip(params_list, contexts)]


@torch.no_grad()
def evaluate_metric(engine, params, ctx: Optional[FaultContext]) -> float:
    """One member's signed constraint metric under ``ctx``, averaged over
    ``engine``'s eval batches outside any vmap: the serial engine's
    evaluation, and the one-chip-at-a-time deployment check (each masked
    GEMM a single-chip kernel launch in ``kernel`` mode on the card)."""
    ctx = ctx or healthy()
    vals = [float(engine.loss_fn(params, b, ctx)[1][engine.metric]) for b in engine.eval_batches]
    v = float(np.mean(vals))
    return v if engine.higher_is_better else -v


def make_fat_engine(kind: str, **kwargs):
    if kind == "population":
        return PopulationFATEngine(**kwargs)
    if kind == "serial":
        return SerialFATEngine(**kwargs)
    if kind == "sharded":
        # imported here: repro_torch.fleet.sharding imports this module
        from repro_torch.fleet.sharding import ShardedPopulationEngine

        return ShardedPopulationEngine(**kwargs)
    raise ValueError(
        f"unknown FAT engine {kind!r} (use 'population', 'serial', or 'sharded')"
    )
