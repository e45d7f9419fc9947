"""Bucketed / chunked / packed prefill planning (host side).

Admission runs over a CLOSED set of prefill shapes, so the programs that
serving runs (and that ``ContinuousBatchingEngine.warmup`` runs first) are
O(|buckets|), not O(|distinct prompt lengths|). Three mechanisms:

* **bucketing** — a prompt of length ``p <= buckets[-1]`` is padded up to
  the smallest bucket that holds it; the pad tail is its own segment so it
  cannot attend into (or be attended from) real tokens; past the top bucket
  the static engine's ladder extends by doubling (:func:`ladder_rung`);
* **chunking** — a prompt longer than the top bucket is split into
  fixed-size ``chunk_size`` steps that stream into the slot's page chain
  (``repro_torch.models.model.prefill_chunk``), all of one shape;
* **packing** — several short waiting prompts ride one bucket dispatch as
  consecutive *segments* of a single packed row: per-token restarting
  positions keep RoPE exact, a per-token page map scatters each prompt's KV
  into its own chain, and per-segment last-token gathers produce every
  packed request's first logits.

This module is pure host-side numpy: it decides shapes and builds the int32
index arrays the admission programs of ``repro_torch.serve.continuous``
consume. The port's copy of the reference's ``serve/bucketing.py``; the
arrays are the same.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "DEFAULT_PREFILL_BUCKETS",
    "validate_buckets",
    "bucket_of",
    "ladder_rung",
    "PrefillStep",
    "plan_prefill",
    "PackItem",
    "build_pack",
    "chunk_step_maps",
]

DEFAULT_PREFILL_BUCKETS = (32, 64, 128, 256)


def validate_buckets(buckets: Sequence[int]) -> tuple[int, ...]:
    """Normalize + validate a bucket ladder: ints, strictly increasing."""
    out = tuple(int(b) for b in buckets)
    if not out:
        raise ValueError("prefill_buckets must be non-empty (or None to disable)")
    if any(b < 1 for b in out):
        raise ValueError(f"buckets must be positive, got {out}")
    if any(b >= c for b, c in zip(out, out[1:])):
        raise ValueError(f"buckets must be strictly increasing, got {out}")
    return out


def bucket_of(n: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket holding ``n`` tokens; None past the top bucket."""
    for b in buckets:
        if n <= b:
            return int(b)
    return None


def ladder_rung(n: int, buckets: Sequence[int]) -> int:
    """Like :func:`bucket_of` but on the ladder extended past the top bucket
    by doubling — always resolves."""
    b = bucket_of(n, buckets)
    if b is not None:
        return b
    r = int(buckets[-1])
    while r < n:
        r *= 2
    return r


@dataclass(frozen=True)
class PrefillStep:
    """One prefill dispatch for a request: tokens ``[start, start+valid)``
    run at width ``size`` (pad tail past ``valid``). ``final`` marks the
    step that produces the request's first logits and activates its slot."""

    start: int
    size: int
    valid: int
    final: bool


def plan_prefill(
    plen: int, *, buckets: Optional[Sequence[int]], chunk_size: int
) -> list[PrefillStep]:
    """Admission plan for one prompt: a single bucket step when the prompt
    fits the ladder, else ``ceil(plen / chunk_size)`` equal-width chunk
    steps. With ``buckets=None`` (unbucketed baseline) the single step runs
    at the exact prompt length — one admission program per distinct length,
    the hazard this module exists to remove."""
    if plen < 1:
        raise ValueError(f"prompt length must be >= 1, got {plen}")
    if buckets is None:
        return [PrefillStep(0, plen, plen, True)]
    b = bucket_of(plen, buckets)
    if b is not None:
        return [PrefillStep(0, b, plen, True)]
    n = -(-plen // chunk_size)
    return [
        PrefillStep(i * chunk_size, chunk_size, min(chunk_size, plen - i * chunk_size), i == n - 1)
        for i in range(n)
    ]


@dataclass(frozen=True)
class PackItem:
    """One request's share of a packed bucket dispatch."""

    tokens: np.ndarray  # (plen,) int token ids
    slot: int
    pages: tuple  # full allocated page chain (prompt + decode budget)
    budget: int  # max_new_tokens
    rid: int = -1  # request id, observability only (never enters a program)


def build_pack(
    items: Sequence[PackItem],
    *,
    bucket: int,
    max_pack: int,
    page_size: int,
    max_pages_per_seq: int,
    num_slots: int,
    pad_id: int = 0,
) -> dict:
    """Lay ``items`` out as ONE packed (1, bucket) prefill row.

    Returns int32 numpy arrays keyed for the packed-admit program:

    * ``tokens``/``positions``/``segments`` ``(1, bucket)`` — prompts
      concatenated; positions restart at 0 per segment (RoPE-exact), real
      segments are 1-based, the pad tail is segment 0;
    * ``page_ix``/``page_off`` ``(bucket,)`` — per-token KV scatter targets
      into the page pool (pad tokens land on the reserved scratch page 0);
    * ``gather_pos`` ``(max_pack,)`` — packed-row index of each segment's
      last real token (first-logits gather);
    * ``slots``/``seq_lens``/``budgets`` ``(max_pack,)`` and ``rows``
      ``(max_pack, max_pages_per_seq)`` — per-slot state scatters; unused
      lanes carry ``slot == num_slots`` (out of bounds: the admit program
      scatters only the lanes below ``num_slots``), so one program serves
      every pack occupancy.
    """
    if not 1 <= len(items) <= max_pack:
        raise ValueError(f"pack holds 1..{max_pack} items, got {len(items)}")
    total = sum(len(it.tokens) for it in items)
    if total > bucket:
        raise ValueError(f"{total} packed tokens exceed bucket {bucket}")
    tokens = np.full((bucket,), pad_id, np.int32)
    positions = np.zeros((bucket,), np.int32)
    segments = np.zeros((bucket,), np.int32)
    page_ix = np.zeros((bucket,), np.int32)
    page_off = np.zeros((bucket,), np.int32)
    gather_pos = np.zeros((max_pack,), np.int32)
    slots = np.full((max_pack,), num_slots, np.int32)
    rows = np.zeros((max_pack, max_pages_per_seq), np.int32)
    seq_lens = np.zeros((max_pack,), np.int32)
    budgets = np.zeros((max_pack,), np.int32)
    off = 0
    for i, it in enumerate(items):
        n = len(it.tokens)
        t = np.arange(n)
        tokens[off : off + n] = np.asarray(it.tokens, np.int32)
        positions[off : off + n] = t
        segments[off : off + n] = i + 1
        page_ix[off : off + n] = np.asarray(it.pages, np.int32)[t // page_size]
        page_off[off : off + n] = t % page_size
        gather_pos[i] = off + n - 1
        slots[i] = it.slot
        rows[i, : len(it.pages)] = it.pages
        seq_lens[i] = n
        budgets[i] = it.budget
        off += n
    if off < bucket:  # pad tail: own segment, scratch page, benign positions
        positions[off:] = np.arange(bucket - off)
        page_off[off:] = np.arange(bucket - off) % page_size
    return dict(
        tokens=tokens[None],
        positions=positions[None],
        segments=segments[None],
        page_ix=page_ix,
        page_off=page_off,
        gather_pos=gather_pos,
        slots=slots,
        rows=rows,
        seq_lens=seq_lens,
        budgets=budgets,
    )


def chunk_step_maps(step: PrefillStep, pages: Sequence[int], *, page_size: int) -> dict:
    """Per-token page scatter maps for one chunk step. Chunk starts are
    multiples of ``chunk_size``; with ``chunk_size % page_size == 0`` every
    chunk begins page-aligned, so token ``t`` of the step lands on page
    ``pages[(start + t) // page_size]`` at offset ``t % page_size``. Pad
    tokens past ``valid`` go to the scratch page 0."""
    t = np.arange(step.size)
    g = step.start + t
    chain = np.asarray(pages, np.int32)
    ix = np.minimum(g // page_size, len(chain) - 1)  # pad tokens clamp, then mask
    page_ix = np.where(t < step.valid, chain[ix], 0).astype(np.int32)
    page_off = (g % page_size).astype(np.int32)
    return dict(page_ix=page_ix, page_off=page_off)
