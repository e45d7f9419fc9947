"""train_step / eval_step builders over flat parameter dicts.

Gradients come from autograd over detached leaves of the parameters, so a
step never mutates its inputs: it returns new params and optimizer state,
as the reference's pure step does. Microbatch gradient accumulation runs as
a loop over microbatches with a configurable accumulator dtype —
``bfloat16`` accumulation is the gradient-compression knob (halves
accumulator memory)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.masking import FaultContext
from repro_torch.models import model as M
from repro_torch.train.optimizer import AdamWConfig, adamw_update

__all__ = ["make_loss_fn", "make_train_step", "make_jit_train_step", "make_eval_step"]


def make_loss_fn(cfg, *, attn_impl="auto", moe_impl="einsum", moe_cf=1.25, remat="dots", fault_apply="per_use"):
    def loss(params, batch, ctx):
        return M.loss_fn(
            params, batch, cfg, ctx, attn_impl=attn_impl, moe_impl=moe_impl, moe_cf=moe_cf, remat=remat,
            fault_apply=fault_apply,
        )

    return loss


def _metrics_and_grads(loss, params: dict, batch: dict, ctx) -> tuple[dict, dict]:
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    with torch.enable_grad():
        value, metrics = loss(leaves, batch, ctx)
        grads = torch.autograd.grad(value, list(leaves.values()), allow_unused=True)
    grads = {
        k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(leaves.items(), grads)
    }
    return {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(
    cfg,
    opt_cfg: AdamWConfig,
    *,
    attn_impl: str = "auto",
    moe_impl: str = "einsum",
    moe_cf: float = 1.25,
    remat: str = "dots",
    microbatches: int = 1,
    accum_dtype: str = "float32",
    fault_apply: str = "per_use",
) -> Callable:
    """Returns train_step(params, opt_state, batch, ctx) -> (params', opt', metrics)."""
    loss = make_loss_fn(
        cfg, attn_impl=attn_impl, moe_impl=moe_impl, moe_cf=moe_cf, remat=remat, fault_apply=fault_apply
    )
    adt = getattr(torch, accum_dtype)

    def train_step(params: dict, opt_state: dict, batch: dict, ctx: FaultContext):
        if microbatches == 1:
            metrics, grads = _metrics_and_grads(loss, params, batch, ctx)
        else:
            acc = {k: torch.zeros(p.shape, dtype=adt, device=p.device) for k, p in params.items()}
            msum = None
            for i in range(microbatches):
                mb = {}
                for k, x in batch.items():
                    n = x.shape[0] // microbatches
                    mb[k] = x[i * n : (i + 1) * n]
                met, g = _metrics_and_grads(loss, params, mb, ctx)
                acc = {k: acc[k] + g[k].to(adt) for k in acc}
                msum = met if msum is None else {k: msum[k] + met[k] for k in msum}
            grads = {k: (a / microbatches).float() for k, a in acc.items()}
            metrics = {k: v / microbatches for k, v in msum.items()}
        with torch.no_grad():
            params, opt_state, info = adamw_update(grads, opt_state, params, opt_cfg)
        metrics = dict(metrics)
        metrics.update(info)
        return params, opt_state, metrics

    return train_step


def make_jit_train_step(cfg, opt_cfg: AdamWConfig, **kw) -> Callable:
    """The reference's canonical launcher step: ``make_train_step`` under
    ``jax.jit`` with ``(params, opt_state)`` donated. PyTorch has no
    donation and the port compiles nothing here, so this is the plain step;
    the loop re-binds both from each step's outputs, so the old buffers are
    freed as the new ones arrive. A CUDA graph of it is later work."""
    return make_train_step(cfg, opt_cfg, **kw)


def make_eval_step(cfg, **kw) -> Callable:
    loss = make_loss_fn(cfg, **kw)

    @torch.no_grad()
    def eval_step(params: dict, batch: dict, ctx: FaultContext) -> dict:
        _, metrics = loss(params, batch, ctx)
        return metrics

    return eval_step
