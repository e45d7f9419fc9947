"""Static-batch serving engine over the model's prefill/decode steps.

The engine runs a generate loop (prefill once, decode N) with the chip's
FaultContext applied — serving a fault-aware model ON the faulty chip it was
tuned for. Greedy or temperature sampling.

``make_sample_decode`` builds the step each token takes: log_softmax, the
greedy/categorical choice, the chosen-token logprob gather and the next
``decode_step``. Greedy choice is exactly ``argmax``; temperature sampling
draws from a ``torch.Generator`` seeded by the ``generate`` call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.masking import FaultContext, healthy
from repro_torch.models import model as M
from repro_torch.serve.bucketing import DEFAULT_PREFILL_BUCKETS, ladder_rung, validate_buckets
from repro_torch.serve.kvcache import DEFAULT_PAGE_SIZE, round_up_to_page

__all__ = ["GenerateResult", "ServeEngine", "make_sample_decode"]


@dataclass
class GenerateResult:
    tokens: torch.Tensor  # (B, prompt + generated)
    logprobs: torch.Tensor  # (B, generated)


def make_sample_decode(cfg, *, pad_id: int = 0):
    """Build the sampling + decode step for one chip.

    ``(params, cur_logits, cache, generator, ctx, temperature) ->
    (next_token, token_logprob, next_logits, cache)``.

    With ``active`` (a per-slot bool mask) the step runs in *masked* form
    and returns ``(emitted, token_logprob, next_logits, cache, new_active,
    new_remaining)``: inactive slots emit ``pad_id`` with logprob 0, and a
    slot retires when it samples ``eos_id`` or exhausts its per-slot
    ``remaining`` budget. The dense cache still advances every slot.
    """

    def sample_decode(
        p, cur, cache, gen, ctx, temperature, active=None, eos_id=None, remaining=None
    ):
        lp = torch.log_softmax(cur.float(), dim=-1)
        if temperature > 0:
            nxt = torch.multinomial(torch.softmax(lp / temperature, dim=-1), 1, generator=gen)[:, 0]
        else:
            nxt = torch.argmax(lp, dim=-1)
        tok_lp = lp.gather(-1, nxt[:, None])[:, 0]
        if active is None:
            step_logits, cache = M.decode_step(p, nxt[:, None], cache, cfg, ctx)
            return nxt, tok_lp, step_logits[:, 0], cache
        emitted = torch.where(active, nxt, torch.full_like(nxt, pad_id))
        tok_lp = torch.where(active, tok_lp, torch.zeros_like(tok_lp))
        new_active = active
        if eos_id is not None:
            new_active = new_active & (nxt != eos_id)
        new_remaining = remaining
        if remaining is not None:
            new_remaining = remaining - active.to(remaining.dtype)
            new_active = new_active & (new_remaining > 0)
        step_logits, cache = M.decode_step(p, emitted[:, None], cache, cfg, ctx)
        return emitted, tok_lp, step_logits[:, 0], cache, new_active, new_remaining

    return sample_decode


class ServeEngine:
    """Static-batch serving: one rectangular prompt batch, N decode steps.

    ``max_len`` is the KV capacity. ``max_len=None`` derives it per
    ``generate`` call as ``prompt_len + max_new_tokens`` rounded up the
    bucket ladder (or to the page without buckets).

    Prompt widths are bucketed (``serve/bucketing.py``): ``generate`` pads
    the prompt up to the smallest ladder rung that holds it and runs
    prefill with the real ``valid_len``. ``prefill_buckets=None`` runs
    prefill at the exact prompt length.

    The engine runs on the device of ``params``.
    """

    def __init__(
        self,
        cfg,
        params: M.Model,
        ctx: Optional[FaultContext] = None,
        *,
        max_len: Optional[int] = 4096,
        page_size: int = DEFAULT_PAGE_SIZE,
        pad_id: int = 0,
        prefill_buckets=DEFAULT_PREFILL_BUCKETS,
    ):
        self.cfg = cfg
        self.params = params
        self.ctx = ctx or healthy()
        self.max_len = max_len
        self.page_size = page_size
        self.pad_id = pad_id
        self.prefill_buckets = (
            None if prefill_buckets is None else validate_buckets(prefill_buckets)
        )
        self._sample_decode = make_sample_decode(cfg, pad_id=pad_id)

    def cache_len_for(self, prompt_len: int, max_new_tokens: int) -> int:
        """KV capacity one generate call needs."""
        if self.max_len is not None:
            return self.max_len
        need = prompt_len + max_new_tokens
        if self.prefill_buckets is not None:
            return ladder_rung(need, self.prefill_buckets)
        return round_up_to_page(need, self.page_size)

    @torch.no_grad()
    def generate(
        self,
        prompts: torch.Tensor,  # (B, S) token ids
        *,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        seed: int = 0,
        eos_id: Optional[int] = None,
    ) -> GenerateResult:
        plen = prompts.shape[1]
        cache_len = self.cache_len_for(plen, max_new_tokens)
        if self.prefill_buckets is not None:
            # pad the prompt up to its ladder rung (never past capacity)
            width = min(ladder_rung(plen, self.prefill_buckets), cache_len)
            pad = prompts.new_full((prompts.shape[0], width - plen), self.pad_id)
            logits, cache = M.prefill(
                self.params, {"tokens": torch.cat([prompts, pad], dim=1)}, self.cfg, self.ctx,
                cache_len=cache_len, valid_len=plen,
            )
        else:
            logits, cache = M.prefill(
                self.params, {"tokens": prompts}, self.cfg, self.ctx, cache_len=cache_len
            )
        gen = torch.Generator(device=prompts.device).manual_seed(seed)
        toks, lps, cur = [prompts], [], logits
        if eos_id is None:
            for _ in range(max_new_tokens):
                nxt, tok_lp, cur, cache = self._sample_decode(
                    self.params, cur, cache, gen, self.ctx, temperature
                )
                lps.append(tok_lp)
                toks.append(nxt[:, None])
        else:
            # EOS masking: a finished sequence emits pad_id with logprob 0
            # for the rest of the batch
            active = torch.ones(prompts.shape[0], dtype=torch.bool, device=prompts.device)
            for _ in range(max_new_tokens):
                nxt, tok_lp, cur, cache, active, _ = self._sample_decode(
                    self.params, cur, cache, gen, self.ctx, temperature, active, eos_id
                )
                lps.append(tok_lp)
                toks.append(nxt[:, None])
        return GenerateResult(tokens=torch.cat(toks, dim=1), logprobs=torch.stack(lps, dim=1))
