"""The program registry: the stack's entry points, declared once.

``build_stack`` assembles everything the four analysis passes need for one
architecture, the port's counterpart of the reference's
``analysis/programs.py``:

* donation specs (:class:`~repro_torch.analysis.donation.ProgramSpec`) for
  the serve, continuous, train and population entry points, on the
  *reduced* config and live tensors on ``device``: the pass runs each once
  (``analysis/donation.py``). They are built on first use of
  ``StackPrograms.donation_specs``, so the other three passes touch no
  device;
* trace models (:class:`~repro_torch.analysis.recompile.EntryTraceModel`)
  whose signature functions mirror each entry's own boundary: the static
  engine's prefill width (``serve/engine.py::ServeEngine.generate``) and
  the continuous engine's program keys (``serve/continuous.py``: ``_run``
  and the closed set ``warmup`` runs);
* sharding entries on the **full** config from meta-device parameters, for
  the reference's train mesh and the fleet pop x model mesh;
* kernel launches at production-representative shapes
  (``kernel_launches``, the reference's ``_kernel_launches``), built by the
  launch builders in :mod:`repro_torch.analysis.kernelgeom`.

The carried sets are load-bearing: they name which operands each host loop
takes from the previous dispatch. A refactor that makes one of them come
back in new storage turns into a DON001 the moment it lands here.
``fleet_kernel_launches(cfg, chips)`` adds the launches only a fleet makes:
the reference gets them from ``jax.vmap`` of its kernels and lints none of
them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.analysis.donation import ProgramSpec
from repro_torch.analysis.kernelgeom import (
    KernelLaunch,
    decode_attention_launch,
    flash_attention_launch,
    mamba_scan_launch,
    masked_matmul_launch,
)
from repro_torch.analysis.recompile import EntryTraceModel, TraceRequest
from repro_torch.analysis.shardlint import FakeMesh, ShardingEntry
from repro_torch.models.moe import capacity

__all__ = [
    "StackPrograms",
    "build_stack",
    "continuous_specs",
    "fleet_kernel_launches",
    "kernel_launches",
    "population_spec",
    "sample_decode_spec",
    "train_step_spec",
]

# reduced-config dispatch shapes, the reference's
_SERVE_BATCH = 2
_SERVE_MAX_LEN = 64
_SLOTS = 4
_PAGE_SIZE = 8
_NUM_PAGES = 32
_MAX_PAGES_PER_SEQ = 8
_ADMIT_BUCKET = 16  # reduced-config bucket of the packed admission
_ADMIT_CHUNK = 16  # reduced-config chunked-prefill width
_MAX_PACK = 4
_TRAIN_BATCH = 2
_TRAIN_SEQ = 16
_POP = 4


@dataclass
class StackPrograms:
    """Everything the analyzer lints for one arch, grouped by pass. The
    donation specs hold live tensors: ``build_donation`` makes them on the
    first read of ``donation_specs``."""

    arch: str
    trace_models: list = field(default_factory=list)
    sharding_entries: list = field(default_factory=list)
    kernel_launches: list = field(default_factory=list)
    build_donation: Optional[Callable[[], list]] = None
    _donation: Optional[list] = None

    @property
    def donation_specs(self) -> list:
        if self._donation is None:
            self._donation = self.build_donation() if self.build_donation else []
        return self._donation


def _ctx(cfg, device):
    from repro_torch.core import from_fault_map, random_fault_map

    fm = random_fault_map(0, cfg.array_rows, cfg.array_cols, 0.1)
    return from_fault_map(fm, "fap", device=device)


def _serve_specs(cfg_r, params, ctx, device) -> list:
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg_r, params, ctx, max_len=_SERVE_MAX_LEN)
    dtype = getattr(torch, cfg_r.dtype)

    def cur():
        return torch.zeros((_SERVE_BATCH, cfg_r.vocab_size), dtype=dtype, device=device)

    def cache():
        return M.init_cache(cfg_r, _SERVE_BATCH, _SERVE_MAX_LEN, device=device)

    tokens = torch.zeros((_SERVE_BATCH, 1), dtype=torch.int64, device=device)
    return [
        sample_decode_spec(eng, cur(), cache()),
        # the reference's ServeEngine._decode, the unfused step: the port's
        # is models/model.py::decode_step, which the sample-decode calls
        ProgramSpec(
            name="serve.decode",
            fn=lambda p, t, c, x: M.decode_step(p, t, c, cfg_r, x),
            args=(params, tokens, cache(), ctx),
            carried=frozenset({2}),
            arg_names=("params", "tokens", "cache", "ctx"),
            returns={2: 1},
        ),
    ]


def sample_decode_spec(eng, cur: torch.Tensor, cache: dict) -> ProgramSpec:
    """A ``ServeEngine``'s fused sample + decode step as a donation spec,
    on the engine's params and context, greedy: the logits and the cache
    are carried (the generator too, which holds no tensor)."""
    gen = torch.Generator(device=cur.device).manual_seed(0)
    return ProgramSpec(
        name="serve.sample_decode",
        fn=eng._sample_decode,
        args=(eng.params, cur, cache, gen, eng.ctx, 0.0),
        carried=frozenset({1, 2, 3}),
        arg_names=("params", "cur_logits", "cache", "key", "ctx", "temperature"),
        returns={1: 2, 2: 3},
    )


def _continuous_specs(cfg_r, params, ctx, device) -> list:
    from repro_torch.serve.continuous import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(
        cfg_r, params, ctx, num_slots=_SLOTS, page_size=_PAGE_SIZE, num_pages=_NUM_PAGES,
        max_pages_per_seq=_MAX_PAGES_PER_SEQ, prefill_buckets=(_ADMIT_BUCKET, 2 * _ADMIT_BUCKET),
        chunk_size=_ADMIT_CHUNK, max_pack=_MAX_PACK,
    )
    return continuous_specs(eng)


def continuous_specs(eng) -> list:
    """The continuous engine's three programs as donation specs, each on a
    fresh slot state of ``eng`` (``_State``: its leaves are the carried
    set, read back from the state object after the call): the masked
    sample-decode, a packed admission of one request at the smallest
    bucket, and one final chunk. ``chip_smoke.py`` lints its full-width
    engine with these."""
    from repro_torch.serve.bucketing import PackItem, PrefillStep, build_pack

    chain = tuple(range(1, 1 + -(-2 * eng.chunk_size // eng.page_size)))
    item = PackItem(np.ones((eng.prefill_buckets[0] // 2,), np.int32), 0, chain, 1)
    arrays = build_pack(
        [item], bucket=eng.prefill_buckets[0], max_pack=eng.max_pack, page_size=eng.page_size,
        max_pages_per_seq=eng.max_pages_per_seq, num_slots=eng.num_slots, pad_id=eng.pad_id,
    )
    row = np.zeros((eng.max_pages_per_seq,), np.int32)
    row[: len(chain)] = chain
    c = eng.chunk_size
    step = PrefillStep(0, c, c, True)
    gen = torch.Generator(device=eng.device).manual_seed(0)
    return [
        ProgramSpec(
            name="continuous.sample_decode",
            fn=eng._decode,
            args=(eng._state(), gen, 0.0, None),
            carried=frozenset({0, 1}),
            arg_names=("state", "key", "temperature", "eos_id"),
        ),
        ProgramSpec(
            name="continuous.prefill_admit",
            fn=eng._packed_admit,
            args=(eng._state(), arrays, 1),
            carried=frozenset({0}),
            arg_names=("state", "maps", "n"),
        ),
        ProgramSpec(
            name="continuous.prefill_chunk",
            fn=eng._prefill_chunk,
            args=(eng._state(), 0, np.ones((c,), np.int32), row, step, chain, 1),
            carried=frozenset({0}),
            arg_names=("state", "slot", "tokens", "row", "step", "pages", "budget"),
        ),
    ]


def _train_specs(cfg_r, params, ctx, device) -> list:
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.step import make_jit_train_step

    ocfg = AdamWConfig()
    gen = torch.Generator(device="cpu").manual_seed(0)
    tokens = torch.randint(0, cfg_r.vocab_size, (_TRAIN_BATCH, _TRAIN_SEQ + 1), generator=gen).to(device)
    batch = dict(tokens=tokens[:, :-1], labels=tokens[:, 1:])
    step = make_jit_train_step(cfg_r, ocfg, remat="none")
    return [train_step_spec(step, params, adamw_init(params, ocfg), batch, ctx)]


def train_step_spec(step, params: dict, opt_state: dict, batch: dict, ctx) -> ProgramSpec:
    """A train step ``(params, opt_state, batch, ctx) -> (params',
    opt_state', metrics)`` as a donation spec: params and moments carried."""
    return ProgramSpec(
        name="train.step",
        fn=step,
        args=(params, opt_state, batch, ctx),
        carried=frozenset({0, 1}),
        arg_names=("params", "opt_state", "batch", "ctx"),
        returns={0: 0, 1: 1},
    )


def population_spec(engine, params0: dict, ok_pop: torch.Tensor, budgets: list, batch_fn,
                    mode: str = "fap") -> ProgramSpec:
    """A population engine's fit as a donation spec: nothing is carried (the
    sweep fans every member out from ONE ``params0`` the caller keeps for
    the next sweep), and ``params0`` is reused: its storage and values must
    come through the fit unchanged."""
    from repro_torch.train.population import _drain

    def fit_run(p0, ok, b):
        return _drain(engine._fit_run(p0, ok, mode, b, batch_fn))

    return ProgramSpec(
        name="population.fit_run",
        fn=fit_run,
        args=(params0, ok_pop, budgets),
        carried=frozenset(),
        arg_names=("params0", "ok_pop", "budgets"),
        reused=frozenset({0}),
    )


def _population_specs(cfg_r, params, ctx, device) -> list:
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.population import PopulationFATEngine
    from repro_torch.train.step import make_loss_fn

    stream = TokenStream(cfg_r.vocab_size, _TRAIN_SEQ, _TRAIN_BATCH, seed=0, device=device)
    engine = PopulationFATEngine(
        loss_fn=make_loss_fn(cfg_r, remat="none"),
        opt_cfg=AdamWConfig(),
        eval_batches=[stream.batch_at(10_000_000)],
        population_size=_POP,
        eval_every=2,
    )
    ok_pop = torch.stack([ctx.ok] * _POP)
    return [population_spec(engine, params, ok_pop, [2, 1, 2, 1], stream.batch_at)]


def _donation_entries(cfg_r, device=None) -> list:
    """Every donation entry of the stack on ``cfg_r``, on live tensors on
    ``device`` (default: the card). Each entry gets its own parameters."""
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M

    dev = resolve_device(device)
    ctx = _ctx(cfg_r, dev)
    model = M.init_params(cfg_r, 0, device=dev)
    specs = _serve_specs(cfg_r, model, ctx, dev) + _continuous_specs(cfg_r, model, ctx, dev)
    specs += _train_specs(cfg_r, M.param_dict(M.init_params(cfg_r, 0, device=dev)), ctx, dev)
    specs += _population_specs(cfg_r, M.param_dict(M.init_params(cfg_r, 0, device=dev)), ctx, dev)
    return specs


def _trace_models() -> list:
    """Analytic program signatures, mirroring the entries' own boundaries.

    serve/continuous entries sweep only the request dimensions their
    boundary can see (prompt_len, max_new_tokens): ``batch`` is an engine
    constant (slot count / rectangular batch), not per-request traffic.
    train.step is launch-configured: its shapes never vary with a request.
    The continuous engine's signatures are its program keys.
    """
    from repro_torch.serve.bucketing import DEFAULT_PREFILL_BUCKETS, bucket_of, ladder_rung

    def serve_prefill_sig(r: TraceRequest) -> tuple:
        # ServeEngine.generate pads the prompt up the bucket ladder (never
        # past the default max_len=4096 capacity) and prefills at that width
        rung = min(ladder_rung(r.prompt_len, DEFAULT_PREFILL_BUCKETS), 4096)
        return ("serve.prefill", rung, 4096)

    def serve_decode_sig(r: TraceRequest) -> tuple:
        # the fused sample + decode: (B, V) logits and a fixed-capacity cache
        return ("serve.sample_decode", 4096)

    def cont_decode_sig(r: TraceRequest) -> tuple:
        return ("decode",)

    def cont_admit_sig(r: TraceRequest) -> tuple:
        # a prompt admits at its bucket's packed admission or, past the top
        # bucket, through the one chunk program (chunk size: the top bucket)
        b = bucket_of(r.prompt_len, DEFAULT_PREFILL_BUCKETS)
        if b is None:
            return ("prefill_chunk", DEFAULT_PREFILL_BUCKETS[-1])
        return ("prefill_admit", b)

    def train_sig(r: TraceRequest) -> tuple:
        return ("train.step", _TRAIN_BATCH, _TRAIN_SEQ)

    serve_dims = ("prompt_len", "max_new_tokens")
    return [
        EntryTraceModel("serve.prefill", serve_prefill_sig, dims=serve_dims),
        EntryTraceModel("serve.sample_decode", serve_decode_sig, dims=serve_dims),
        EntryTraceModel("continuous.sample_decode", cont_decode_sig, dims=serve_dims),
        EntryTraceModel("continuous.prefill_admit", cont_admit_sig, dims=serve_dims),
        EntryTraceModel("train.step", train_sig, dims=("prompt_len", "batch")),
    ]


def _sharding_entries(cfg) -> list:
    from repro_torch.launch.sharding import make_rules_for_mesh
    from repro_torch.launch.specs import param_struct

    params_s, axes = param_struct(cfg)
    train_mesh = FakeMesh.of(data=2, model=4)
    fleet_mesh = FakeMesh.of(pop=4, model=2)
    return [
        ShardingEntry(name="train.params", mctx=make_rules_for_mesh(cfg, train_mesh), axes=axes,
                      structs=params_s),
        ShardingEntry(name="fleet.params", mctx=make_rules_for_mesh(cfg, fleet_mesh, reserved_axes=("pop",)),
                      axes=axes, structs=params_s, engine_axes=("pop",)),
    ]


def kernel_launches(cfg) -> list[KernelLaunch]:
    """Production-representative launches of every kernel for ``cfg``: the
    masked GEMM at a full-sequence MLP shape (2048 tokens x d_model -> d_ff),
    flash attention at 8 x 2048^2, dense decode attention over 4096 keys,
    paged decode attention over the reference's pool, and the SSM scan,
    which ships whatever the family."""
    hq = cfg.num_heads or 8
    hkv = cfg.num_kv_heads or hq
    hd = cfg.resolved_head_dim or 64
    return [
        masked_matmul_launch(2048, cfg.d_model, cfg.d_ff or 4 * cfg.d_model,
                             (cfg.array_rows, cfg.array_cols), dtype=cfg.dtype),
        flash_attention_launch(8, hq, hkv, 2048, 2048, hd, dtype=cfg.dtype),
        decode_attention_launch(8, hq, hkv, 4096, hd),
        decode_attention_launch(_SLOTS, hq, hkv, 4096, hd, paged=True, page_size=_PAGE_SIZE),
        mamba_scan_launch(8, 2048, 1536, 16),
    ]


def fleet_kernel_launches(cfg, chips: int, *, batch: int = 4, prompt: int = 2048) -> list[KernelLaunch]:
    """The chip-batched launches a ``FleetServeEngine`` of ``chips`` chips
    makes for ``cfg`` with ``batch`` prompts of ``prompt`` tokens: a decode
    step's MLP GEMM (one launch over the chips), an MoE layer's expert
    GEMMs at decode (one launch over chips x experts, each expert's rows the
    batch's capacity slots) and the prefill's selective scan (one launch
    over chips x batch rows), as the family has them. Encoders have no
    decode path, and the fleet engines refuse them: none."""
    if cfg.is_encoder:
        return []
    d, f, mask = cfg.d_model, cfg.d_ff or 4 * cfg.d_model, (cfg.array_rows, cfg.array_cols)
    out = [masked_matmul_launch(batch, d, f, mask, dtype=cfg.dtype, chips=chips)]
    if cfg.has_moe:
        m = batch * capacity(batch, 1, cfg, 1.25)
        kw = dict(dtype=cfg.dtype, chips=chips, experts=cfg.num_experts)
        out += [masked_matmul_launch(m, d, f, mask, **kw), masked_matmul_launch(m, f, d, mask, **kw)]
    if cfg.has_ssm:
        out.append(mamba_scan_launch(batch, prompt, cfg.d_inner, cfg.ssm_state, chips=chips))
    return out


def build_stack(arch: str = "smollm-135m", cfg=None, cfg_reduced=None, device=None) -> StackPrograms:
    """Assemble the lintable stack for ``arch``.

    ``cfg``/``cfg_reduced`` override the registry lookup (tests inject tiny
    configs); by default the sharding and kernel passes see the full config
    and the donation pass ``reduce_config`` of it, on ``device`` (default:
    the card) when its specs are first read. Raises ``ValueError`` for the
    families the stack's continuous engine refuses, as the reference's
    registry does: SSM and hybrid (unpaged state) and encoders (no decode).
    """
    from repro_torch.configs import get_arch, reduce_config
    from repro_torch.serve.continuous import check_family

    cfg = cfg if cfg is not None else get_arch(arch)
    cfg_r = cfg_reduced if cfg_reduced is not None else reduce_config(cfg)
    check_family(cfg_r)

    return StackPrograms(
        arch=arch,
        trace_models=_trace_models(),
        sharding_entries=_sharding_entries(cfg),
        kernel_launches=kernel_launches(cfg),
        build_donation=lambda: _donation_entries(cfg_r, device),
    )
