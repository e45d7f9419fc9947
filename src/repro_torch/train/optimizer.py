"""AdamW on dicts of tensors, written by hand (not ``torch.optim.AdamW``)
so that every step is the reference's ``train/optimizer.py`` step:

* gradients are clipped by ``grad_clip_norm / (gnorm + 1e-9)``, capped at 1;
* weight decay sits *inside* the step:
  ``p -= lr * (mhat / (sqrt(vhat) + eps) + wd * p)``;
* the bias correction raises b1 and b2 to ``count`` as float32;
* ``moment_dtype`` sets the dtype m and v are kept in (the math is float32);
* a callable learning rate is called with the new count.

The update is a pure function of its inputs, so ``torch.func.vmap`` runs it
for a whole population of members at once. A leaf may be a pytree of
pieces (``repro_torch.fleet.tensor_parallel.SplitTensor``, a leaf split
over model positions): the update is elementwise on each piece, where it
lies, and the grad norm sums each piece's squares once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "opt_state_specs", "cosine_schedule", "constant_schedule"]

Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    learning_rate: Union[float, Schedule] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"  # 'bfloat16' halves optimizer memory


def adamw_init(params: dict, cfg: AdamWConfig) -> dict:
    mdt = getattr(torch, cfg.moment_dtype)
    return dict(
        m={k: tree_map(lambda x: torch.zeros_like(x, dtype=mdt), p) for k, p in params.items()},
        v={k: tree_map(lambda x: torch.zeros_like(x, dtype=mdt), p) for k, p in params.items()},
        count=torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device),
    )


def _sum_squares(leaf) -> torch.Tensor:
    """A leaf's sum of squares in float32; a split leaf's pieces each once,
    summed on the first piece's device (a leaf left whole is one piece)."""
    pieces = tree_leaves(leaf)
    if len(pieces) == 1:
        return torch.sum(torch.square(pieces[0].float()))
    dev = pieces[0].device
    return sum(torch.sum(torch.square(p.float())).to(dev) for p in pieces)


def _global_norm(tree: dict) -> torch.Tensor:
    # summed in sorted-key order, the order of the reference's tree leaves
    return torch.sqrt(sum(_sum_squares(tree[k]) for k in sorted(tree)))


def adamw_update(grads: dict, state: dict, params: dict, cfg: AdamWConfig):
    """Returns (new_params, new_state, info dict)."""
    count = state["count"] + 1
    lr = cfg.learning_rate(count) if callable(cfg.learning_rate) else cfg.learning_rate
    gnorm = _global_norm(grads)
    scale = None
    if cfg.grad_clip_norm is not None:
        scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    mdt = getattr(torch, cfg.moment_dtype)
    c32 = count.float()
    bc1 = 1 - cfg.b1**c32
    bc2 = 1 - cfg.b2**c32
    on_device: dict = {}  # the step's scalars on each piece's device (a no-op where it repeats)

    def scalars(dev):
        if dev not in on_device:
            on_device[dev] = tuple(None if t is None else t.to(dev) if torch.is_tensor(t) else t
                                   for t in (scale, bc1, bc2, lr))
        return on_device[dev]

    new_params, new_m, new_v = {}, {}, {}
    for k, leaf in params.items():
        pieces, spec = tree_flatten(leaf)
        outs = []
        for p, g, m, v in zip(pieces, tree_leaves(grads[k]), tree_leaves(state["m"][k]), tree_leaves(state["v"][k])):
            sc, b1c, b2c, lr_p = scalars(p.device)
            if sc is not None:
                g = g * sc
            g32 = g.float()
            m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
            v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32
            mhat = m32 / b1c
            vhat = v32 / b2c
            step = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
            outs.append(((p.float() - lr_p * step).to(p.dtype), m32.to(mdt), v32.to(mdt)))
        new_params[k], new_m[k], new_v[k] = (tree_unflatten([o[i] for o in outs], spec) for i in range(3))
    info = dict(grad_norm=gnorm, lr=lr if torch.is_tensor(lr) else torch.tensor(lr, dtype=torch.float32))
    return new_params, dict(m=new_m, v=new_v, count=count), info


def opt_state_specs(param_specs: dict) -> dict:
    """Logical axes of ``adamw_init``'s state: m and v take each param's
    axes, the step count none."""
    return dict(m=param_specs, v=param_specs, count=())


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1) -> Schedule:
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak * step / max(1, warmup)
        prog = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, peak * cos)

    return fn


def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)
