"""Multi-chip serving: one program advances a whole fleet of faulty chips.

The deployment half of eFAT ships one fault-aware artifact per retraining
job, each deployed on chips with their own fault maps. Serving them with
per-chip engines costs N Python loops of one dispatch per token each. The
engines differ only in (params, FaultContext), so, as the training side's
population engines do, ``FleetServeEngine`` stacks N chips' parameters and
masks and maps the decode step over the chip axis with ``torch.func.vmap``:
the *entire fleet* advances one token per dispatch. Under that map every
masked GEMM is ONE chip-batched launch of the masked-GEMM kernel (the
custom op's vmap rule, ``kernels/masked_matmul/ops.py``), the counterpart
of JAX's batching rule for ``pallas_call``, which adds the chip axis to the
TPU kernel's grid. Sampling runs over the stacked ``(chips, slots)`` logits
outside the map.

Semantics match per-chip serving: greedy decoding is argmax per chip, so
temperature 0 reproduces each chip's own ``ServeEngine`` token for token;
with temperature > 0 each chip samples from its own ``torch.Generator``,
seeded from the fleet seed, so runs are reproducible per chip and chips'
samples are independent (a torch generator cannot replay the reference's
threefry keys, so the sampled bits are the port's own).

``FleetServeEngine`` shares one prompt batch across chips: "run the same
prompt set through every deployed model and compare". ``ShardedFleetServeEngine``
is the production-shaped tier: every chip consumes its *own* ragged request
stream through its own continuous-batch slot table over its own paged KV
cache; admission (packed per bucket, chunked past the top bucket) runs per
chip, and one fused masked decode dispatch advances every chip's in-flight
slots. Chips map onto a list of devices (the reference's "pop" mesh): the
chip count must tile it, and the chips of one device run as one batched
group. On one card the whole fleet is one group. The fleet prefills use
dense attention and the paged read is a gather, as the reference's
continuous path does.

The port's copy of the reference's ``fleet/serve.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn
from torch.func import vmap

from repro_torch.core.masking import FaultContext, healthy, stack_contexts
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.obs.alerts import AlertEngine, AlertRule
from repro_torch.obs.health import HealthConfig, HealthTracker
from repro_torch.obs.hooks import PoolMonitor, RequestTracer
from repro_torch.obs.recorder import NULL_RECORDER, Recorder
from repro_torch.serve.bucketing import DEFAULT_PREFILL_BUCKETS, chunk_step_maps
from repro_torch.serve.continuous import (
    Request,
    RequestOutput,
    ServeStats,
    _SlotTable,
    _State,
    admission_round,
    admission_settings,
    admit_chunk,
    admit_pack,
    record_decode,
    run_probe,
    upload,
)
from repro_torch.serve.engine import make_sample_decode
from repro_torch.serve.kvcache import DEFAULT_PAGE_SIZE, PageAllocator, page_bytes

__all__ = ["FleetGenerateResult", "FleetServeEngine", "ShardedFleetServeEngine", "chip_generators"]


def _flat(params: Union[nn.Module, dict]) -> dict:
    return M.param_dict(params) if isinstance(params, nn.Module) else dict(params)


def _stack(flats: Sequence[dict]) -> dict:
    return {k: torch.stack([f[k] for f in flats]) for k in flats[0]}


def chip_generators(seed: int, n: int, device) -> list[torch.Generator]:
    """One sample stream per chip, seeded from the fleet seed: distinct
    seeds from ``numpy.random.SeedSequence(seed)``, so chips draw
    independently and the same seed replays the same fleet."""
    seeds = np.random.SeedSequence(seed).generate_state(n, dtype=np.uint64)
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


def _ctx_of(ok: Optional[torch.Tensor], mode: str) -> FaultContext:
    return healthy() if ok is None else FaultContext(ok=ok, mode=mode)


def _fleet_decode(cfg):
    """``decode(params, tokens, cache, ctx, active)`` for
    ``make_sample_decode``, mapped over the chip axis: ``params`` are the
    chip-stacked flat dict, ``ctx`` the stacked context (``ok`` of shape
    (chips, R, C), or a healthy one), ``cache`` a chip-stacked dense cache
    (``k``/``v`` and the shared ``index``) or paged cache. The KV writes land
    in place, each in its own chip's slice."""

    def decode(p, tokens, cache, ctx, active):
        ok, mode = ctx.ok, ctx.mode
        okd = None if ok is None else 0
        if "k_pages" in cache:

            def one(p_c, tok_c, ok_c, act_c, kp, vp, bt, sl):
                c = dict(k_pages=kp, v_pages=vp, block_tables=bt, seq_lens=sl)
                logits, c = M.decode_step(p_c, tok_c, c, cfg, _ctx_of(ok_c, mode), active=act_c)
                return logits, c["seq_lens"]

            logits, cache["seq_lens"] = vmap(
                one, in_dims=(0, 0, okd, None if active is None else 0, 0, 0, 0, 0)
            )(p, tokens, ok, active, cache["k_pages"], cache["v_pages"], cache["block_tables"],
              cache["seq_lens"])
            return logits, cache
        index = cache["index"]

        def one(p_c, tok_c, ok_c, k, v):
            logits, _ = M.decode_step(p_c, tok_c, dict(k=k, v=v, index=index), cfg, _ctx_of(ok_c, mode))
            return logits

        logits = vmap(one, in_dims=(0, 0, okd, 0, 0))(p, tokens, ok, cache["k"], cache["v"])
        cache["index"] = index + tokens.shape[-1]
        return logits, cache

    return decode


@dataclass
class FleetGenerateResult:
    tokens: torch.Tensor  # (N, B, prompt + generated)
    logprobs: torch.Tensor  # (N, B, generated)

    def chip(self, i: int):
        """Per-chip view (tokens, logprobs), shaped like ServeEngine output."""
        return self.tokens[i], self.logprobs[i]


def _check_fleet(cfg, params_list, ctxs, what: str) -> list[FaultContext]:
    if cfg.has_moe or cfg.is_encoder or cfg.modality != "text":
        # the expert axis and the frontends have not been put under the
        # fleet's chip map: the masked GEMM takes one batch axis a launch
        raise ValueError(
            f"{what} runs the causal text families without experts; {cfg.name!r} is "
            f"{'an MoE' if cfg.has_moe else 'an encoder' if cfg.is_encoder else 'a ' + cfg.modality} model"
        )
    n = len(params_list)
    if n == 0:
        raise ValueError(f"{what} needs at least one chip")
    ctxs = list(ctxs) if ctxs is not None else [healthy()] * n
    if len(ctxs) != n:
        raise ValueError(f"{n} params sets but {len(ctxs)} fault contexts")
    return [c or healthy() for c in ctxs]


class FleetServeEngine:
    """Serve N chips' (params, FaultContext) pairs as one batched program.

    ``params_list[i]`` are chip i's shipped (FAP-masked) weights, a
    ``Model`` or its flat dict, and ``ctxs[i]`` its fault context
    (None/healthy for a fault-free chip: mixed fleets are fine,
    ``stack_contexts`` upcasts healthy members). All chips share one model
    config and prompt batch, and run on the device of their parameters.
    Attention families only: the selective scan has no chip axis.
    """

    def __init__(
        self,
        cfg,
        params_list: Sequence,
        ctxs: Optional[Sequence[Optional[FaultContext]]] = None,
        *,
        max_len: int = 4096,
    ):
        ctxs = _check_fleet(cfg, params_list, ctxs, "FleetServeEngine")
        if cfg.has_ssm:
            raise ValueError(
                f"fleet serving runs attention families; {cfg.family!r} carries SSM state, "
                "and the selective scan has no chip axis"
            )
        self.cfg = cfg
        self.max_len = max_len
        self.num_chips = len(params_list)
        self.params = _stack([_flat(p) for p in params_list])
        self.device = next(iter(self.params.values())).device
        self.ctx = stack_contexts(ctxs)
        if self.ctx.ok is not None:
            self.ctx = FaultContext(ok=self.ctx.ok.to(self.device), mode=self.ctx.mode)
        self._sample_decode = make_sample_decode(cfg, decode=_fleet_decode(cfg))

    @torch.no_grad()
    def generate(
        self,
        prompts,  # (B, S) token ids (tensor or numpy), shared by every chip
        *,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        seed: int = 0,
    ) -> FleetGenerateResult:
        cfg, n = self.cfg, self.num_chips
        prompts = torch.as_tensor(prompts, device=self.device)
        ok, mode = self.ctx.ok, self.ctx.mode

        def one(p_c, ok_c):
            logits, cache = M.prefill(
                p_c, {"tokens": prompts}, cfg, _ctx_of(ok_c, mode), cache_len=self.max_len,
                attn_impl="dense",
            )
            return logits, cache["k"], cache["v"]

        cur, k, v = vmap(one, in_dims=(0, None if ok is None else 0))(self.params, ok)
        cache = {"k": k, "v": v, "index": prompts.shape[1]}
        gens = chip_generators(seed, n, self.device) if temperature > 0 else None
        toks = [prompts.expand(n, *prompts.shape)]
        lps = []
        for _ in range(max_new_tokens):
            nxt, tok_lp, cur, cache = self._sample_decode(
                self.params, cur, cache, gens, self.ctx, temperature
            )
            lps.append(tok_lp)
            toks.append(nxt[..., None])
        return FleetGenerateResult(tokens=torch.cat(toks, dim=2), logprobs=torch.stack(lps, dim=2))


@dataclass
class _Group:
    """The chips one device serves as one batched group."""

    device: torch.device
    chips: range
    params: dict  # flat dict, each leaf (len(chips), ...)
    ctx: FaultContext  # ok (len(chips), R, C), or healthy for an all-healthy fleet


class ShardedFleetServeEngine:
    """Ragged fleet serving: chips -> devices, streams -> slot tables.

    Each chip ``c`` runs its own continuous-batch slot table (paged KV
    cache, admission on arrival, retirement on EOS or budget: the loop of
    ``serve/continuous.py::ContinuousBatchingEngine``) over its own request
    stream; ONE dispatch per device group advances every chip's in-flight
    slots a token. ``devices`` stands for the reference's pop mesh: the
    chip count must be a multiple of its length, and consecutive chips
    share a device. By default the fleet runs on the one card, every chip
    in one group. Each chip's parameters and mask are copied to its
    device.

    Greedy decoding is argmax per slot, so every chip's outputs reproduce a
    per-chip ``ContinuousBatchingEngine`` on the same stream; with
    temperature > 0 each chip draws from its own generator, seeded from the
    fleet seed.
    """

    def __init__(
        self,
        cfg,
        params_list: Sequence,
        ctxs: Optional[Sequence[Optional[FaultContext]]] = None,
        *,
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
        num_slots: int = 4,
        page_size: int = DEFAULT_PAGE_SIZE,
        num_pages: int = 128,
        max_pages_per_seq: Optional[int] = None,
        pad_id: int = 0,
        prefill_buckets=DEFAULT_PREFILL_BUCKETS,
        chunk_size: Optional[int] = None,
        max_pack: int = 4,
        recorder: Optional[Recorder] = None,
        probe_every: Optional[int] = None,
        health_config: Optional[HealthConfig] = None,
        alert_rules: Optional[Sequence[AlertRule]] = None,
    ):
        ctxs = _check_fleet(cfg, params_list, ctxs, "ShardedFleetServeEngine")
        n = len(params_list)
        if cfg.has_ssm:
            raise ValueError(
                f"continuous fleet serving supports attention families only; "
                f"{cfg.family!r} carries unpaged SSM state"
            )
        if cfg.is_encoder:
            raise ValueError("encoder-only arch has no decode path")
        devices = [resolve_device(d) for d in (devices if devices is not None else [None])]
        if not devices:
            raise ValueError("devices is empty; pass at least one device")
        extent = len(devices)
        if n % extent != 0:
            raise ValueError(
                f"{n} chips don't tile the {extent} devices; pad the fleet or "
                "pass a device list whose length divides it"
            )
        modes = {c.mode for c in ctxs if c.active}
        if len(modes) > 1:
            raise ValueError(f"cannot serve a fleet with mixed modes {sorted(modes)}")
        self.cfg = cfg
        self.devices = devices
        self.num_chips = n
        self.num_slots = num_slots
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages_per_seq = max_pages_per_seq or (num_pages - 1)
        self.pad_id = pad_id
        self.prefill_buckets, self.chunk_size, self.max_pack = admission_settings(
            prefill_buckets, chunk_size, max_pack, page_size
        )
        # host-side observability; one track per chip (chip{c}/slot{s},
        # chip{c}/pages) so Perfetto draws the fleet as per-chip swimlanes
        self.obs = recorder if recorder is not None else NULL_RECORDER
        self._page_bytes = page_bytes(cfg, page_size)

        per = n // extent
        self.ctxs: list[FaultContext] = []
        self.groups: list[_Group] = []
        self._where: list[tuple[int, int]] = []  # chip -> (group, index in group)
        self._chip_params: list = []  # chip -> its slice of the group's params, as a view
        fleet_active = bool(modes)
        mode = modes.pop() if modes else "none"
        rows, cols = cfg.array_rows, cfg.array_cols
        for g, dev in enumerate(devices):
            chips = range(g * per, (g + 1) * per)
            flats = [{k: v.to(dev) for k, v in _flat(params_list[c]).items()} for c in chips]
            gctx = [ctxs[c] if not ctxs[c].active else FaultContext(ctxs[c].ok.to(dev), mode) for c in chips]
            stacked = stack_contexts(gctx)
            if fleet_active and stacked.ok is None:
                # an all-healthy group of an active fleet still carries a mask,
                # so set_silicon can change any chip's
                stacked = FaultContext(ok=torch.ones((per, rows, cols), device=dev), mode=mode)
            group = _Group(dev, chips, _stack(flats), stacked)
            self.groups.append(group)
            for j, c in enumerate(chips):
                self.ctxs.append(gctx[j])
                self._where.append((g, j))
                self._chip_params.append(M.as_params({k: v[j] for k, v in group.params.items()}))
        self._sample_decode = make_sample_decode(cfg, pad_id=pad_id, decode=_fleet_decode(cfg))
        # fault detection: one ABFT prober per chip, all dispatched every
        # probe_every fused decode dispatches. Probes are SEPARATE launches
        # and never touch the serve loop's state or generators, so enabling
        # them changes no sampled token on any chip.
        if probe_every is not None and probe_every < 1:
            raise ValueError(f"probe_every must be >= 1, got {probe_every}")
        self.probe_every = int(probe_every) if probe_every else None
        self._probers: Optional[list] = None
        self.health: Optional[HealthTracker] = None
        self.alerts = AlertEngine(self.obs, alert_rules) if alert_rules else None
        if self.probe_every:
            self._init_probers(health_config)

    def _init_probers(self, health_config: Optional[HealthConfig]) -> None:
        from repro_torch.kernels.masked_matmul.ops import masked_matmul_checksummed
        from repro_torch.obs.abft import ChipProber, select_probe_weight

        cfg = self.cfg
        rows, cols = cfg.array_rows, cfg.array_cols
        dtype = getattr(torch, cfg.dtype)

        def make_dispatch(c, w):
            dev = self.groups[self._where[c][0]].device
            ones = torch.ones((rows, cols), dtype=torch.float32, device=dev)

            @torch.no_grad()
            def dispatch(x):
                # chip c's LIVE mask: re-read self.ctxs so a set_silicon()
                # change is what the next probe computes through
                ok = self.ctxs[c].ok
                y, chk = masked_matmul_checksummed(
                    torch.from_numpy(x).to(dev, dtype), w, ok if ok is not None else ones
                )
                return y.float().cpu().numpy(), chk.float().cpu().numpy()

            return dispatch

        self._probers = []
        for c in range(self.num_chips):
            g, j = self._where[c]
            _, w = select_probe_weight({k: v[j] for k, v in self.groups[g].params.items()})
            self._probers.append(
                ChipProber(make_dispatch(c, w), array_shape=(rows, cols), k_dim=int(w.shape[0]), chip=c)
            )
        self.health = HealthTracker(self.num_chips, self.obs, config=health_config, proc="fleet")

    def set_silicon(self, chip: int, ctx: FaultContext) -> None:
        """Simulate a mid-flight silicon change on one chip: swap the LIVE
        fault context chip ``chip``'s subsequent dispatches compute through,
        WITHOUT rebasing that chip's prober goldens, so its next probe sees
        the divergence and the other chips' don't. The fleet must have been
        built with ACTIVE contexts (possibly zero-fault FaultMaps), as the
        reference's compiled programs require. The new map is copied into
        the stacked mask in place: the masked-GEMM kernel repacks that
        chip's bits alone."""
        if not 0 <= chip < self.num_chips:
            raise ValueError(f"chip {chip} out of range [0, {self.num_chips})")
        g, j = self._where[chip]
        stacked = self.groups[g].ctx
        if stacked.ok is None:
            raise ValueError(
                "set_silicon needs an ACTIVE fleet: construct every chip "
                "with an explicit (possibly zero-fault) FaultMap context so "
                "the stacked mask is a live program input"
            )
        if ctx is None or ctx.ok is None:
            raise ValueError(
                "set_silicon needs an ACTIVE context; pass a zero-fault "
                "FaultMap context to model pristine silicon"
            )
        if ctx.mode != stacked.mode:
            raise ValueError(f"mode mismatch: fleet {stacked.mode!r} vs new {ctx.mode!r}")
        if tuple(ctx.ok.shape) != tuple(stacked.ok.shape[1:]):
            raise ValueError(
                f"ok shape mismatch: chip expects "
                f"{tuple(stacked.ok.shape[1:])}, got {tuple(ctx.ok.shape)}"
            )
        ok = ctx.ok.to(stacked.ok.device, stacked.ok.dtype)
        self.ctxs[chip] = FaultContext(ok=ok, mode=ctx.mode)
        stacked.ok[j].copy_(ok)

    # -- state ----------------------------------------------------------------

    def _group_state(self, group: _Group) -> _State:
        cfg, per, dev = self.cfg, len(group.chips), group.device
        one = M.init_paged_cache(
            cfg, self.num_pages, self.page_size, self.num_slots, self.max_pages_per_seq, device=dev
        )
        return _State(
            cache={k: v.expand(per, *v.shape).clone() for k, v in one.items()},
            cur=torch.zeros((per, self.num_slots, cfg.vocab_size), dtype=getattr(torch, cfg.dtype), device=dev),
            active=torch.zeros((per, self.num_slots), dtype=torch.bool, device=dev),
            remaining=torch.zeros((per, self.num_slots), dtype=torch.int32, device=dev),
        )

    @staticmethod
    def _chip_view(st: _State, j: int) -> _State:
        """Chip ``j``'s slice of a group's stacked state, as views: the
        per-chip admission programs write through them in place."""
        return _State(
            cache={k: v[j] for k, v in st.cache.items()}, cur=st.cur[j], active=st.active[j],
            remaining=st.remaining[j],
        )

    def _sync(self) -> None:
        for g in self.groups:
            if g.device.type == "cuda":
                torch.cuda.synchronize(g.device)

    # -- the fleet serve loop -------------------------------------------------

    @torch.no_grad()
    def serve(
        self,
        streams: Sequence[Sequence[Request]],
        *,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        seed: int = 0,
        on_step: Optional[Callable[[int], None]] = None,
    ) -> tuple[list[dict[int, RequestOutput]], ServeStats]:
        """Serve one ragged request stream per chip to completion.

        Returns (per-chip outputs by rid, fleet-level stats). Stats count
        fused dispatches: the whole fleet advances per dispatch, so the
        total is driven by the busiest chip, not the sum over chips.
        ``on_step(clock)`` runs at the top of every scheduler round: the
        hook that flips one chip's silicon mid-serve (``set_silicon``)."""
        if len(streams) != self.num_chips:
            raise ValueError(f"{self.num_chips} chips but {len(streams)} request streams")
        n = self.num_chips
        stats = ServeStats(num_slots=n * self.num_slots, page_size=self.page_size)
        allocs = [PageAllocator(self.num_pages, self.page_size) for _ in range(n)]
        tables = [
            _SlotTable(list(s), self.num_slots, allocs[c], self.max_pages_per_seq)
            for c, s in enumerate(streams)
        ]
        rec = self.obs
        tracers = [RequestTracer(rec, proc="fleet", track_prefix=f"chip{c}/") for c in range(n)]
        fleet_tracer = RequestTracer(rec, proc="fleet")
        pools = [
            PoolMonitor(rec, allocs[c], proc="fleet", track=f"chip{c}/pages", name_prefix=f"kv.chip{c}.")
            for c in range(n)
        ]
        states = [self._group_state(g) for g in self.groups]
        gens = [
            [chip_generators(seed, n, g.device)[c] for c in g.chips] if temperature > 0 else None
            for g in self.groups
        ]

        def dispatchers(c):
            """Chip ``c``'s packed admission and chunk, on its own slice of
            its group's state."""
            g, j = self._where[c]
            st, dev = self._chip_view(states[g], j), self.groups[g].device

            def pack(arrays, n, width):
                admit_pack(self.cfg, self._chip_params[c], self.ctxs[c], st, upload(arrays, dev), n)

            def chunk(slot, tokens, row, step, pages, budget):
                maps = chunk_step_maps(step, pages, page_size=self.page_size)
                a = upload(dict(tokens=tokens[None], row=row, **maps), dev)
                admit_chunk(self.cfg, self._chip_params[c], self.ctxs[c], st, slot, a, step, budget)

            return pack, chunk

        clock = 0
        while not all(t.done for t in tables):
            if on_step is not None:
                on_step(clock)
            for c, table in enumerate(tables):
                admission_round(self, table, clock, stats, tracers[c], *dispatchers(c), chip=c)
            pages_in_use = sum(a.pages_in_use for a in allocs)
            stats.peak_resident_kv_bytes = max(stats.peak_resident_kv_bytes, pages_in_use * self._page_bytes)
            for p in pools:
                p.sample()
            if not any(t.active.any() for t in tables):
                arrivals = [t.next_arrival() for t in tables if t.next_arrival() is not None]
                assert arrivals, "no active slots and no pending arrivals"
                clock = max(clock + 1, min(arrivals))
                continue

            n_active = int(sum(t.active.sum() for t in tables))
            t0 = rec.now() if rec else 0.0
            outs = []
            for g, st, gen in zip(self.groups, states, gens):
                emitted, tok_lp, st.cur, st.cache, st.active, st.remaining = self._sample_decode(
                    g.params, st.cur, st.cache, gen, g.ctx, temperature, st.active, eos_id,
                    st.remaining,
                )
                outs.append((emitted, tok_lp, st.active))
            clock += 1
            stats.decode_dispatches += 1
            stats.emitted_tokens += n_active
            stats.active_slot_steps += n_active
            stats.kv_byte_steps += pages_in_use * self._page_bytes
            # the copies wait for every group's dispatch to complete
            em = torch.cat([o[0].cpu() for o in outs]).numpy()
            lp = torch.cat([o[1].cpu() for o in outs]).numpy()
            ac = torch.cat([o[2].cpu() for o in outs]).numpy()
            if rec:
                fleet_tracer.decode_dispatch(t0, rec.now(), n_active=n_active, clock=clock)
            for c, table in enumerate(tables):
                record_decode(table, c, em[c], lp[c], ac[c], clock, eos_id, rec, tracers[c], pools[c],
                              self.health)
            if self._probers is not None and clock % self.probe_every == 0:
                for c, prober in enumerate(self._probers):
                    run_probe(prober, c, clock, stats, rec, self.health, proc="fleet", track=f"chip{c}/health")
                if self.alerts:
                    self.alerts.evaluate(clock=clock)
        for p in pools:
            p.flush()  # close every chip's counter series at the final ts
        if self.health is not None:
            self.health.finalize()
        if self.alerts:
            self.alerts.evaluate(clock=clock)
        if rec:
            rec.instant("serve.end", proc="fleet", track="engine",
                        args=dict(chips=self.num_chips, **stats.as_dict()))
        return [t.outputs for t in tables], stats
