"""Continuous-batching serving engine over the paged KV cache.

The static engine (``serve/engine.py::ServeEngine``) runs one rectangular
prompt batch to the longest request's horizon: a request that finishes at
token 5 burns a dispatch per token until the batch's longest request
finishes, and every sequence owns a dense ``max_len`` KV buffer for the
whole run. This module replaces that with the standard serving loop:

* a **request queue** of :class:`Request`\\ s (own prompt, own
  ``max_new_tokens``, own arrival step);
* a **slot table** of ``num_slots`` decode lanes; requests admit into free
  slots (prefill on arrival), retire on EOS or their own budget, and free
  their pages immediately so a waiting request refills the slot mid-flight;
* ONE decode step for the whole slot table — the masked form of
  ``make_sample_decode`` (per-slot ``active`` masking, per-slot
  ``remaining`` budgets) over the paged cache of
  ``models/model.py::decode_step``.

Admission runs over a CLOSED set of prefill shapes (``serve/bucketing.py``):
prompts pad up to a small bucket ladder, several short waiting prompts pack
into one bucket dispatch as segment-masked rows of a single packed
sequence, and prompts longer than the top bucket stream into their page
chain in fixed-size chunks (``models/model.py::prefill_chunk``). So the
programs serving runs are one packed admission per bucket, the chunk and
the decode step, whatever the traffic's prompt lengths, and
:meth:`ContinuousBatchingEngine.warmup` runs each of them once before
traffic arrives: the kernels are built and their launch plans cached. This
closed set is also what a CUDA graph of each program would capture.

Decode math per request is the same prefill + masked-attention math the
static engine runs, so greedy outputs are pinned token-for-token against
``ServeEngine`` on the same prompt with the same budget — including
requests admitted mid-flight and packed or chunked admissions.

Host/device split: sampling, masking and the paged read/write all run on
the device; the host loop reads back three tiny per-slot tensors a decode
dispatch (emitted tokens, their logprobs, the active mask) to run
admission and retirement between dispatches, and uploads the int32
pack/chunk index maps built by ``serve/bucketing.py`` in one copy a
dispatch. The pool, the block tables and the per-slot state live on the
device and are updated in place: the counterpart of the reference donating
them. The port's copy of the reference's ``serve/continuous.py``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.masking import FaultContext, healthy
from repro_torch.models import model as M
from repro_torch.obs.alerts import AlertEngine, AlertRule
from repro_torch.obs.health import HealthConfig, HealthTracker
from repro_torch.obs.hooks import PoolMonitor, RequestTracer
from repro_torch.obs.recorder import NULL_RECORDER, Recorder
from repro_torch.serve.bucketing import (
    DEFAULT_PREFILL_BUCKETS,
    PackItem,
    PrefillStep,
    bucket_of,
    build_pack,
    chunk_step_maps,
    plan_prefill,
    validate_buckets,
)
from repro_torch.serve.engine import make_sample_decode
from repro_torch.serve.kvcache import (
    DEFAULT_PAGE_SIZE,
    PageAllocator,
    page_bytes,
    pages_needed,
)

__all__ = [
    "Request",
    "RequestOutput",
    "ServeStats",
    "ContinuousBatchingEngine",
    "check_family",
]


@dataclass(frozen=True)
class Request:
    """One generation request in a stream.

    ``arrival`` is the decode-dispatch index at (or after) which the request
    may be admitted — 0 means it is waiting before serving starts."""

    rid: int
    tokens: np.ndarray  # (prompt_len,) int token ids
    max_new_tokens: int
    arrival: int = 0

    def __post_init__(self):
        object.__setattr__(self, "tokens", np.asarray(self.tokens))
        if self.tokens.ndim != 1 or self.tokens.shape[0] < 1:
            raise ValueError(f"request {self.rid}: prompt must be a non-empty 1-D array")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must be >= 1")


@dataclass
class RequestOutput:
    rid: int
    prompt: np.ndarray
    tokens: np.ndarray  # (generated,) — includes the EOS token if hit
    logprobs: np.ndarray
    admitted_step: int  # dispatch index at admission (prefill time)
    finished_step: int  # dispatch index after the final token
    finish_reason: str  # "eos" | "length"
    queue_wait_steps: int = 0  # admitted_step - arrival (admission backpressure)
    ttft_wall_s: float = float("nan")  # arrival seen -> first token, wall clock

    @property
    def ttft(self) -> int:
        """Decode dispatches from serve start until this request's first
        token (its prefill emits no token; the next dispatch does)."""
        return self.admitted_step + 1


@dataclass
class ServeStats:
    decode_dispatches: int = 0
    prefill_dispatches: int = 0  # packed-bucket + chunk dispatches
    chunk_dispatches: int = 0  # chunked-prefill subset of the above
    probe_dispatches: int = 0  # ABFT canary/structured probe GEMMs
    emitted_tokens: int = 0
    admitted: int = 0
    num_slots: int = 0
    page_size: int = 0
    active_slot_steps: int = 0  # sum over dispatches of active slots
    peak_resident_kv_bytes: int = 0
    kv_byte_steps: int = 0  # sum over dispatches of resident kv bytes

    @property
    def slot_utilization(self) -> float:
        if not self.decode_dispatches:
            return 0.0
        return self.active_slot_steps / (self.decode_dispatches * self.num_slots)

    def as_dict(self) -> dict:
        return dict(
            decode_dispatches=self.decode_dispatches,
            prefill_dispatches=self.prefill_dispatches,
            chunk_dispatches=self.chunk_dispatches,
            probe_dispatches=self.probe_dispatches,
            emitted_tokens=self.emitted_tokens,
            admitted=self.admitted,
            num_slots=self.num_slots,
            page_size=self.page_size,
            slot_utilization=self.slot_utilization,
            peak_resident_kv_bytes=self.peak_resident_kv_bytes,
            kv_byte_steps=self.kv_byte_steps,
        )


class _SlotTable:
    """Host-side slot bookkeeping for one chip's continuous-batch state.

    Owns the page allocator, the pending queue (arrival order, stable), the
    per-slot request records and the accumulating outputs. The device-side
    arrays live with the engine; this class only decides who sits where."""

    def __init__(self, requests: Sequence[Request], num_slots: int, allocator: PageAllocator,
                 max_pages_per_seq: int):
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError(f"duplicate request ids in stream: {sorted(rids)}")
        self.pending: list[Request] = sorted(
            requests, key=lambda r: (r.arrival, r.rid)
        )
        self.alloc = allocator
        self.max_pages_per_seq = max_pages_per_seq
        self.slots: list[Optional[Request]] = [None] * num_slots
        self.slot_pages: list[list[int]] = [[] for _ in range(num_slots)]
        self.active = np.zeros(num_slots, bool)
        self.outputs: dict[int, RequestOutput] = {}
        self.outputs_admitted: dict[int, int] = {}  # rid -> admission clock
        self._tok: dict[int, list] = {}
        self._lp: dict[int, list] = {}
        self._arrival_wall: dict[int, float] = {}  # rid -> wall time first eligible
        self._first_tok_wall: dict[int, float] = {}
        for r in self.pending:
            need = pages_needed(len(r.tokens) + r.max_new_tokens, allocator.page_size)
            if need > max_pages_per_seq:
                raise ValueError(
                    f"request {r.rid} needs {need} pages "
                    f"(prompt {len(r.tokens)} + budget {r.max_new_tokens}) but "
                    f"max_pages_per_seq={max_pages_per_seq}"
                )

    @property
    def done(self) -> bool:
        return not self.pending and not self.active.any()

    def next_arrival(self) -> Optional[int]:
        return self.pending[0].arrival if self.pending else None

    def stamp_arrivals(self, clock: int) -> None:
        """Record the wall time each pending request first became eligible
        (its arrival clock was reached) — the start of its queue wait."""
        now = time.perf_counter()
        for r in self.pending:
            if r.arrival > clock:
                break  # pending is arrival-sorted
            self._arrival_wall.setdefault(r.rid, now)

    def pop_admission(self, clock: int) -> Optional[tuple[int, Request, list[int]]]:
        """Admit the next arrived request into a free slot, allocating its
        full page chain. None when no slot/request/pages are available."""
        if not self.pending or self.pending[0].arrival > clock:
            return None
        free = [s for s, r in enumerate(self.slots) if r is None]
        if not free:
            return None
        r = self.pending[0]
        need = pages_needed(len(r.tokens) + r.max_new_tokens, self.alloc.page_size)
        if not self.alloc.can_alloc(need):
            if not self.active.any():
                raise MemoryError(
                    f"request {r.rid} needs {need} pages but only "
                    f"{self.alloc.free_pages} are free and no request is in "
                    "flight to retire — grow num_pages"
                )
            return None  # wait for a retirement to free pages
        self.pending.pop(0)
        slot = free[0]
        pages = self.alloc.alloc(need)
        self.slots[slot] = r
        self.slot_pages[slot] = pages
        self.active[slot] = True
        self._tok[r.rid] = []
        self._lp[r.rid] = []
        return slot, r, pages

    def record_step(
        self,
        emitted: np.ndarray,
        lps: np.ndarray,
        new_active: np.ndarray,
        clock: int,
        eos_id: Optional[int] = None,
    ) -> list[int]:
        """Record one dispatch's per-slot emissions; retire newly-finished
        slots (freeing their pages). Returns the retired rids."""
        retired = []
        now = time.perf_counter()
        for s, r in enumerate(self.slots):
            if r is None or not self.active[s]:
                continue
            self._tok[r.rid].append(int(emitted[s]))
            self._lp[r.rid].append(float(lps[s]))
            if len(self._tok[r.rid]) == 1:
                self._first_tok_wall[r.rid] = now
            if not new_active[s]:
                toks = np.asarray(self._tok.pop(r.rid))
                # the EOS check wins even on the last budgeted token — it is
                # what actually cleared the slot's mask on the device
                reason = (
                    "eos"
                    if eos_id is not None and toks.size and toks[-1] == eos_id
                    else "length"
                )
                admitted = self.outputs_admitted[r.rid]
                t0 = self._arrival_wall.get(r.rid)
                t1 = self._first_tok_wall.get(r.rid)
                self.outputs[r.rid] = RequestOutput(
                    rid=r.rid,
                    prompt=np.asarray(r.tokens),
                    tokens=toks,
                    logprobs=np.asarray(self._lp.pop(r.rid)),
                    admitted_step=admitted,
                    finished_step=clock,
                    finish_reason=reason,
                    queue_wait_steps=admitted - r.arrival,
                    ttft_wall_s=(t1 - t0) if t0 is not None and t1 is not None else float("nan"),
                )
                self.alloc.free(self.slot_pages[s])
                self.slot_pages[s] = []
                self.slots[s] = None
                retired.append(r.rid)
        self.active = np.array(new_active, bool) & np.array(
            [r is not None for r in self.slots]
        )
        return retired


@dataclass
class _State:
    """The device-side serving state, updated in place by every dispatch."""

    cache: dict  # init_paged_cache: k_pages, v_pages, block_tables, seq_lens
    cur: torch.Tensor  # (S, V) each slot's next-token logits, compute dtype
    active: torch.Tensor  # (S,) bool
    remaining: torch.Tensor  # (S,) int32 budgets left


def upload(arrays: dict, device: torch.device) -> dict:
    """Host int32 index maps -> device int64 tensors, in one copy that does
    not wait for the card (pinned memory, ``non_blocking``): the host goes
    on enqueuing, as the reference's dispatch does."""
    flat = torch.from_numpy(np.concatenate([np.asarray(a, np.int64).ravel() for a in arrays.values()]))
    if device.type == "cuda":
        flat = flat.pin_memory()
    buf = flat.to(device, non_blocking=True)
    out, off = {}, 0
    for k, a in arrays.items():
        n = int(np.size(a))
        out[k] = buf[off : off + n].view(np.shape(a))
        off += n
    return out


def admit_pack(cfg, params, ctx: FaultContext, st: _State, a: dict, n: int) -> None:
    """Admit a PACK of ``n`` requests in one bucket-shaped dispatch: run
    the segment-masked prefill over the packed row (``a``: the uploaded
    ``build_pack`` maps), write every token's KV into its request's page
    chain (pad tokens hit the scratch page 0), gather each segment's
    last-token hidden state for its first logits (the unembed runs at the
    pack's full width, ``max_pack``), and set the ``n`` used lanes' slot
    state. ``st`` may hold views of one chip's slice of a fleet's stacked
    state: every write lands in place."""
    hidden, dense = M.prefill(
        params, {"tokens": a["tokens"], "positions": a["positions"]}, cfg, ctx,
        full_kv=True, return_hidden=True, segments=a["segments"], attn_impl="dense",
    )
    pool = st.cache
    # (L, 1, Hkv, W, hd) -> (W, L, Hkv, hd): the two indices around the
    # Hkv slice put the token dim first
    pool["k_pages"][:, a["page_ix"], :, a["page_off"]] = dense["k"][:, 0].permute(2, 0, 1, 3)
    pool["v_pages"][:, a["page_ix"], :, a["page_off"]] = dense["v"][:, 0].permute(2, 0, 1, 3)
    h = hidden[0, a["gather_pos"]]  # (max_pack, d): one last-token row per segment
    logits = M.unembed(cfg, params, h[None], ctx)[0]  # (max_pack, V)
    slots = a["slots"][:n]
    pool["block_tables"][slots] = a["rows"][:n].to(torch.int32)
    pool["seq_lens"][slots] = a["seq_lens"][:n].to(torch.int32)
    st.cur[slots] = logits[:n].to(st.cur.dtype)
    st.active[slots] = True
    st.remaining[slots] = a["budgets"][:n].to(torch.int32)


def admit_chunk(
    cfg, params, ctx: FaultContext, st: _State, slot: int, a: dict, step: PrefillStep, budget: int
) -> None:
    """One chunk of a long prompt (``a``: the uploaded chunk tokens, chain
    row and ``chunk_step_maps``): continue against the slot's paged prefix
    (``models/model.py::prefill_chunk``), write the chunk's KV into the
    chain, and — on the final chunk — seed the slot's logits and budget and
    flip it live."""
    logits, kc, vc = M.prefill_chunk(
        params, a["tokens"], cfg, ctx, k_pages=st.cache["k_pages"],
        v_pages=st.cache["v_pages"], row=a["row"], prefix_len=step.start,
        valid_len=step.valid,
    )
    pool = st.cache
    pool["k_pages"][:, a["page_ix"], :, a["page_off"]] = kc[:, 0].permute(2, 0, 1, 3)
    pool["v_pages"][:, a["page_ix"], :, a["page_off"]] = vc[:, 0].permute(2, 0, 1, 3)
    pool["block_tables"][slot] = a["row"].to(torch.int32)
    if step.final:
        pool["seq_lens"][slot] = step.start + step.valid
        st.cur[slot] = logits[0].to(st.cur.dtype)
        st.active[slot] = True
        st.remaining[slot] = budget


def admission_settings(prefill_buckets, chunk_size, max_pack, page_size) -> tuple:
    """The validated (buckets, chunk size, pack limit) of an engine's
    planner; ``prefill_buckets=None`` disables it: exact-length admissions,
    one request each, no chunks."""
    if prefill_buckets is None:
        return None, None, 1
    buckets = validate_buckets(prefill_buckets)
    chunk = int(chunk_size) if chunk_size else buckets[-1]
    if chunk < page_size or chunk % page_size:
        raise ValueError(
            f"chunk_size {chunk} must be a positive multiple "
            f"of page_size {page_size} (chunk starts must be page-aligned)"
        )
    if max_pack < 1:
        raise ValueError(f"max_pack must be >= 1, got {max_pack}")
    return buckets, chunk, int(max_pack)


def admission_round(
    eng, table: _SlotTable, clock: int, stats: ServeStats, tracer: RequestTracer,
    dispatch_pack: Callable[[dict, int, int], None],
    dispatch_chunk: Callable[[int, np.ndarray, np.ndarray, PrefillStep, Sequence[int], int], None],
    **trace_args,
) -> None:
    """One chip's admission round at ``clock``, the policy both the
    continuous and the fleet engines run: fill free slots with every
    arrived request that fits, packing short prompts into shared bucket
    dispatches (a pack is flushed at ``eng.max_pack`` requests, or when the
    next prompt would overflow the top bucket) and streaming prompts longer
    than the top bucket in chunks. ``eng`` supplies the planner settings,
    the recorder and ``_sync``; ``dispatch_pack(arrays, n, width)`` runs
    one packed admission of the host ``build_pack`` maps and
    ``dispatch_chunk(slot, tokens, row, step, pages, budget)`` one chunk.
    ``trace_args`` join each admission span's arguments."""
    rec = eng.obs
    buckets = eng.prefill_buckets
    top = buckets[-1] if buckets else None
    pack: list[PackItem] = []

    def flush():
        if not pack:
            return
        total = sum(len(it.tokens) for it in pack)
        width = total if buckets is None else bucket_of(total, buckets)
        arrays = build_pack(
            pack, bucket=width, max_pack=eng.max_pack, page_size=eng.page_size,
            max_pages_per_seq=eng.max_pages_per_seq, num_slots=eng.num_slots, pad_id=eng.pad_id,
        )
        t0 = rec.now() if rec else 0.0
        dispatch_pack(arrays, len(pack), width)
        stats.prefill_dispatches += 1
        if rec:
            eng._sync()
            t1 = rec.now()
            for it in pack:
                tracer.admitted(
                    it.rid, it.slot, t0, t1,
                    args=dict(bucket=width, packed=len(pack), **trace_args, prompt_len=len(it.tokens)),
                )
        pack.clear()

    def chunks(slot, r, pages):
        steps = plan_prefill(len(r.tokens), buckets=buckets, chunk_size=eng.chunk_size)
        toks = np.asarray(r.tokens, np.int32)
        row = np.zeros((eng.max_pages_per_seq,), np.int32)
        row[: len(pages)] = pages
        for step in steps:
            ct = np.full((step.size,), eng.pad_id, np.int32)
            ct[: step.valid] = toks[step.start : step.start + step.valid]
            t0 = rec.now() if rec else 0.0
            dispatch_chunk(slot, ct, row, step, pages, r.max_new_tokens)
            stats.prefill_dispatches += 1
            stats.chunk_dispatches += 1
            if rec:
                eng._sync()
                tracer.chunk(
                    r.rid, slot, t0, rec.now(), final=step.final,
                    args=dict(size=step.size, start=step.start, valid=step.valid),
                )

    table.stamp_arrivals(clock)
    while True:
        adm = table.pop_admission(clock)
        if adm is None:
            break
        slot, r, pages = adm
        table.outputs_admitted[r.rid] = clock
        stats.admitted += 1
        plen = len(r.tokens)
        if top is not None and plen > top:
            flush()
            chunks(slot, r, pages)
            continue
        if pack and (
            len(pack) >= eng.max_pack
            or (top is not None and sum(len(i.tokens) for i in pack) + plen > top)
        ):
            flush()
        pack.append(
            PackItem(np.asarray(r.tokens, np.int32), slot, tuple(pages), r.max_new_tokens, rid=r.rid)
        )
    flush()


def record_decode(
    table: _SlotTable, chip: int, em: np.ndarray, lp: np.ndarray, ac: np.ndarray, clock: int,
    eos_id: Optional[int], rec, tracer: RequestTracer, pool: PoolMonitor,
    health: Optional[HealthTracker],
) -> None:
    """One chip's bookkeeping after a decode dispatch, shared by the
    continuous and the fleet engines: score the step's mean logprob for
    health, record every slot's token, retire the finished requests and
    trace them."""
    if rec:
        slot_of = {r.rid: s for s, r in enumerate(table.slots) if r is not None}
    if health is not None:
        msk = table.active  # the mask this dispatch computed under
        health.observe_decode(
            chip, clock=clock,
            mean_logprob=float(lp[msk].mean()) if msk.any() else None,
            alloc_failures=table.alloc.alloc_failures,
        )
    retired = table.record_step(em, lp, ac, clock, eos_id=eos_id)
    if rec and retired:
        t1 = rec.now()
        for rid in retired:
            tracer.retired(table.outputs[rid], slot_of[rid], t1)
        pool.sample()


def run_probe(prober, chip: int, clock: int, stats: ServeStats, rec, health: HealthTracker,
              *, proc: str, track: str) -> None:
    """One ABFT probe of one chip, traced and scored."""
    t0 = rec.now() if rec else 0.0
    res = prober.probe(clock=clock)
    stats.probe_dispatches += res.dispatches
    if rec:
        rec.span("probe", proc=proc, track=track, t0=t0, t1=rec.now(), args=res.as_dict())
        rec.count("probe.dispatches", res.dispatches)
    health.observe_probe(chip, res, clock=clock)


def check_family(cfg) -> None:
    """Raise ``ValueError`` for a family continuous batching does not take:
    SSM state is not paged, and an encoder has no decode path."""
    if cfg.has_ssm:
        raise ValueError(
            f"continuous batching supports attention families only; "
            f"{cfg.family!r} carries unpaged SSM state"
        )
    if cfg.is_encoder:
        raise ValueError("encoder-only arch has no decode path")


class ContinuousBatchingEngine:
    """Continuous batching on one chip: paged KV + slot table + one masked
    decode step per token across all in-flight requests, admitted through
    the bucketed/packed/chunked planner (``serve/bucketing.py``).

    ``prefill_buckets=None`` disables the planner (one exact-length
    admission program per distinct prompt length, the unbucketed baseline).

    The engine runs on the device of ``params`` (a ``Model`` or its flat
    dict). Program keys:
    ``("prefill_admit", width)``, ``("prefill_chunk", chunk_size)`` and
    ``("decode",)``; :meth:`compile_counts` reports the ones :meth:`warmup`
    ran and the ones first run during traffic.
    """

    def __init__(
        self,
        cfg,
        params: M.Model,
        ctx: Optional[FaultContext] = None,
        *,
        num_slots: int = 4,
        page_size: int = DEFAULT_PAGE_SIZE,
        num_pages: int = 128,
        max_pages_per_seq: Optional[int] = None,
        pad_id: int = 0,
        prefill_buckets: Optional[Sequence[int]] = DEFAULT_PREFILL_BUCKETS,
        chunk_size: Optional[int] = None,
        max_pack: int = 4,
        recorder: Optional[Recorder] = None,
        probe_every: Optional[int] = None,
        health_config: Optional[HealthConfig] = None,
        alert_rules: Optional[Sequence[AlertRule]] = None,
    ):
        check_family(cfg)
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.cfg = cfg
        self.params = params
        self.device = M.as_params(params).embed.device
        self.ctx = ctx or healthy()
        self.num_slots = num_slots
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages_per_seq = max_pages_per_seq or (num_pages - 1)
        self.pad_id = pad_id
        # observability: every hook below is host-side and gated on the
        # recorder's truthiness, so an absent/disabled recorder costs one
        # check per dispatch and recording cannot touch the served tensors
        self.obs = recorder if recorder is not None else NULL_RECORDER
        self._page_bytes = page_bytes(cfg, page_size)
        self.prefill_buckets, self.chunk_size, self.max_pack = admission_settings(
            prefill_buckets, chunk_size, max_pack, page_size
        )
        self._sample_decode = make_sample_decode(cfg, pad_id=pad_id)
        # program keys run by warmup(), and keys first run during traffic
        # without a warmup: the counterparts of the reference's AOT
        # executables and of its traffic-time jit compiles
        self._warm: set = set()
        self._fallback: set = set()
        self.used_programs: set = set()
        # fault detection: an ABFT prober run every probe_every decode
        # dispatches, feeding the health state machine and the alert
        # engine. Probes are SEPARATE launches of the masked GEMM (outside
        # compile_counts()/used_programs) and never touch the serve loop's
        # state or its generator, so enabling them changes no sampled token.
        if probe_every is not None and probe_every < 1:
            raise ValueError(f"probe_every must be >= 1, got {probe_every}")
        self.probe_every = int(probe_every) if probe_every else None
        self.prober = None
        self.health: Optional[HealthTracker] = None
        self.alerts = AlertEngine(self.obs, alert_rules) if alert_rules else None
        if self.probe_every:
            self._init_prober(health_config)

    def _init_prober(self, health_config: Optional[HealthConfig]) -> None:
        from repro_torch.kernels.masked_matmul.ops import masked_matmul_checksummed
        from repro_torch.obs.abft import ChipProber, select_probe_weight

        cfg = self.cfg
        rows, cols = cfg.array_rows, cfg.array_cols
        name, w = select_probe_weight(self.params)
        ones = torch.ones((rows, cols), dtype=torch.float32, device=self.device)
        dtype = getattr(torch, cfg.dtype)

        @torch.no_grad()
        def dispatch(x):
            # the LIVE mask: re-read self.ctx so a set_silicon() change is
            # what the next probe computes through
            ok = self.ctx.ok if self.ctx.ok is not None else ones
            y, chk = masked_matmul_checksummed(torch.from_numpy(x).to(self.device, dtype), w, ok)
            # float32 holds every bf16 value exactly: the bitwise canary
            # comparison is unchanged
            return y.float().cpu().numpy(), chk.float().cpu().numpy()

        self._probe_weight = name
        # the snapshot runs the probe GEMMs and records goldens under the
        # believed map, before traffic
        self.prober = ChipProber(dispatch, array_shape=(rows, cols), k_dim=int(w.shape[0]))
        self.health = HealthTracker(1, self.obs, config=health_config, proc="serve")

    def set_silicon(self, ctx: FaultContext) -> None:
        """Simulate a mid-flight silicon change: swap the LIVE fault context
        every subsequent dispatch (decode, prefill, probes) computes
        through, WITHOUT rebasing the prober's golden snapshots — so the
        next probe sees the divergence. The engine must have been built
        with an ACTIVE context of the same mask shape (a zero-fault
        ``FaultMap`` context models pristine silicon), as the reference's
        compiled programs require; the port keeps the rule so that both
        engines take the same calls."""
        cur = self.ctx
        if cur.ok is None or ctx is None or ctx.ok is None:
            raise ValueError(
                "set_silicon needs ACTIVE fault contexts on both sides; "
                "construct the engine with an explicit (possibly zero-fault)"
                " FaultMap context so the mask is a live program input"
            )
        if cur.mode != ctx.mode or tuple(cur.ok.shape) != tuple(ctx.ok.shape):
            raise ValueError(
                f"silicon change must keep mode/shape: have "
                f"{cur.mode}/{tuple(cur.ok.shape)}, "
                f"got {ctx.mode}/{tuple(ctx.ok.shape)}"
            )
        self.ctx = ctx

    # -- the programs -------------------------------------------------------

    def _packed_admit(self, st: _State, arrays: dict, n: int) -> None:
        admit_pack(self.cfg, self.params, self.ctx, st, upload(arrays, self.device), n)

    def _prefill_chunk(
        self, st: _State, slot: int, tokens: np.ndarray, row: np.ndarray, step: PrefillStep,
        pages: Sequence[int], budget: int,
    ) -> None:
        maps = chunk_step_maps(step, pages, page_size=self.page_size)
        a = upload(dict(tokens=tokens[None], row=row, **maps), self.device)
        admit_chunk(self.cfg, self.params, self.ctx, st, slot, a, step, budget)

    def _decode(self, st: _State, gen, temperature: float, eos_id: Optional[int]):
        """The masked sampling + decode step over every slot; returns the
        emitted tokens and their logprobs, and rebinds the slot state."""
        emitted, tok_lp, st.cur, st.cache, st.active, st.remaining = self._sample_decode(
            self.params, st.cur, st.cache, gen, self.ctx, temperature, st.active, eos_id,
            st.remaining,
        )
        return emitted, tok_lp

    def _run(self, key: tuple, program, *args):
        """Dispatch one program of the closed set during traffic."""
        if key not in self._warm:
            self._fallback.add(key)
        self.used_programs.add(key)
        return program(*args)

    def _state(self) -> _State:
        cfg = self.cfg
        cache = M.init_paged_cache(
            cfg, self.num_pages, self.page_size, self.num_slots, self.max_pages_per_seq,
            device=self.device,
        )
        dev = self.device
        return _State(
            cache=cache,
            cur=torch.zeros((self.num_slots, cfg.vocab_size), dtype=getattr(torch, cfg.dtype), device=dev),
            active=torch.zeros((self.num_slots,), dtype=torch.bool, device=dev),
            remaining=torch.zeros((self.num_slots,), dtype=torch.int32, device=dev),
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- warmup -------------------------------------------------------------

    @torch.no_grad()
    def warmup(self) -> int:
        """Run the closed program set once before traffic arrives, on
        throwaway state: one packed admission per bucket, the chunk program
        and the decode step. Their kernels are built and their launch plans
        cached, and traffic then runs no program for the first time
        (``compile_counts()``'s ``jit_fallback`` stays 0). Returns the
        number of programs warmed."""
        if self.prefill_buckets is None:
            raise ValueError("warmup() needs bucketed prefill; prefill_buckets is None")
        st = self._state()
        item = PackItem(np.zeros((1,), np.int32), 0, (1,), 1)
        for w in self.prefill_buckets:
            arrays = build_pack(
                [item], bucket=w, max_pack=self.max_pack, page_size=self.page_size,
                max_pages_per_seq=self.max_pages_per_seq, num_slots=self.num_slots,
                pad_id=self.pad_id,
            )
            self._packed_admit(st, arrays, 1)
            self._warm.add(("prefill_admit", w))
        c = self.chunk_size
        row = np.zeros((self.max_pages_per_seq,), np.int32)
        row[0] = 1
        self._prefill_chunk(
            st, 0, np.full((c,), self.pad_id, np.int32), row, PrefillStep(0, c, 1, True), (1,), 1
        )
        self._warm.add(("prefill_chunk", c))
        gen = torch.Generator(device=self.device).manual_seed(0)
        self._decode(st, gen, 0.0, None)
        self._warm.add(("decode",))
        self._sync()
        return len(self._warm)

    def compile_counts(self) -> dict:
        """Program accounting: programs warmed (``aot``), program keys first
        run during traffic without a warmup (``jit_fallback``), their sum,
        and the program keys dispatched during traffic (``used``)."""
        return dict(
            aot=len(self._warm),
            jit_fallback=len(self._fallback),
            total=len(self._warm) + len(self._fallback),
            used=sorted(map(str, self.used_programs)),
        )

    # -- the serve loop -----------------------------------------------------

    @torch.no_grad()
    def serve(
        self,
        requests: Sequence[Request],
        *,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        seed: int = 0,
        on_step: Optional[Callable[[int], None]] = None,
    ) -> tuple[dict[int, RequestOutput], ServeStats]:
        """Serve a request stream to completion. Returns (outputs by rid,
        stats). Outputs include per-request TTFT, queue wait and finish
        reason. Temperature sampling draws from a ``torch.Generator`` seeded
        by ``seed``. ``on_step(clock)`` runs at the top of every scheduler
        round — the hook that flips silicon mid-serve (``set_silicon``)."""
        if not requests:
            return {}, ServeStats(num_slots=self.num_slots, page_size=self.page_size)
        alloc = PageAllocator(self.num_pages, self.page_size)
        table = _SlotTable(requests, self.num_slots, alloc, self.max_pages_per_seq)
        stats = ServeStats(num_slots=self.num_slots, page_size=self.page_size)
        rec = self.obs
        tracer = RequestTracer(rec, proc="serve")
        pool = PoolMonitor(rec, alloc, proc="serve")
        enqueued: set = set()

        st = self._state()
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def dispatch_pack(arrays, n, width):
            self._run(("prefill_admit", width), self._packed_admit, st, arrays, n)

        def dispatch_chunk(slot, tokens, row, step, pages, budget):
            self._run(("prefill_chunk", step.size), self._prefill_chunk, st, slot, tokens, row, step,
                      pages, budget)

        clock = 0  # decode-dispatch index
        while not table.done:
            if on_step is not None:
                on_step(clock)
            if rec:
                for r in table.pending:
                    if r.arrival > clock:
                        break  # pending is arrival-sorted
                    if r.rid not in enqueued:
                        enqueued.add(r.rid)
                        rec.instant("enqueue", proc="serve", track="engine",
                                    args=dict(rid=r.rid, arrival=r.arrival, clock=clock))
            # admissions: fill free slots with every arrived request we can,
            # packing short prompts into shared bucket dispatches
            admission_round(self, table, clock, stats, tracer, dispatch_pack, dispatch_chunk)
            stats.peak_resident_kv_bytes = max(
                stats.peak_resident_kv_bytes, alloc.pages_in_use * self._page_bytes
            )
            pool.sample()
            if not table.active.any():
                # idle: jump the clock to the next arrival (no dispatches)
                nxt = table.next_arrival()
                assert nxt is not None and nxt > clock
                clock = nxt
                continue

            n_active = int(table.active.sum())
            t0 = rec.now() if rec else 0.0
            emitted, tok_lp = self._run(("decode",), self._decode, st, gen, temperature, eos_id)
            clock += 1
            stats.decode_dispatches += 1
            stats.emitted_tokens += n_active
            stats.active_slot_steps += n_active
            stats.kv_byte_steps += alloc.pages_in_use * self._page_bytes
            em = emitted.cpu().numpy()  # waits for the dispatch to complete
            lp = tok_lp.cpu().numpy()
            ac = st.active.cpu().numpy()
            if rec:
                tracer.decode_dispatch(t0, rec.now(), n_active=n_active, clock=clock)
            record_decode(table, 0, em, lp, ac, clock, eos_id, rec, tracer, pool, self.health)
            if self.prober is not None and clock % self.probe_every == 0:
                run_probe(self.prober, 0, clock, stats, rec, self.health, proc="serve", track="health")
                if self.alerts:
                    self.alerts.evaluate(clock=clock)
        stats.peak_resident_kv_bytes = max(
            stats.peak_resident_kv_bytes, alloc.peak_pages * self._page_bytes
        )
        pool.flush()  # close the counter series at the final timestamp
        if self.health is not None:
            self.health.finalize()
        if self.alerts:
            self.alerts.evaluate(clock=clock)
        if rec:
            cc = self.compile_counts()
            rec.gauge_set("serve.compiles.aot", cc["aot"])
            rec.gauge_set("serve.compiles.jit_fallback", cc["jit_fallback"])
            rec.gauge_set("serve.compiles.total", cc["total"])
            rec.instant("serve.end", proc="serve", track="engine", args=stats.as_dict())
        return table.outputs, stats
