"""The paper-faithful MLP classifier (stands in for VGG11/ResNet18/
MobileNetV2; every hidden matmul runs through the systolic fault mapping
exactly like the LM archs).

Params are a flat dict ``{"w0", "b0", ..., "w{n-1}", "b{n-1}"}`` of tensors,
so ``torch.func.grad`` and ``torch.func.vmap`` take them as they are. Every
weight keeps its ``(d_in, d_out)`` layout, on which the fault mask is
defined.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.masking import FaultContext, fault_linear, healthy
from repro_torch.device import resolve_device

__all__ = ["init_classifier", "classifier_param_axes", "classifier_forward", "classifier_loss"]


def init_classifier(cfg, seed: int, in_dim: int, device=None) -> dict:
    """N(0, 1/a) weights and zero biases. They are drawn on the CPU from one
    ``torch.Generator`` seeded with ``seed`` and then moved, so the card and
    the CPU start from the same bits."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    dims = [in_dim] + [cfg.d_ff] * (cfg.num_layers - 1) + [cfg.vocab_size]
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = (torch.randn(a, b, generator=gen) * (1.0 / math.sqrt(a))).to(dev)
        params[f"b{i}"] = torch.zeros(b, device=dev)
    return params


def classifier_param_axes(cfg) -> dict:
    """Logical axes of ``init_classifier``'s params (``repro_torch.launch.
    sharding`` names): each weight's output dim carries the splittable name
    ('mlp', 'vocab' on the logits layer), the contraction dim stays
    replicated; the layout the fleet engine's 2-D meshes resolve per pop
    slice."""
    n = cfg.num_layers
    axes: dict = {}
    for i in range(n):
        out_ax = "vocab" if i == n - 1 else "mlp"
        axes[f"w{i}"] = ("embed", out_ax)
        axes[f"b{i}"] = (out_ax,)
    return axes


def classifier_forward(
    params: dict, x: torch.Tensor, cfg, ctx: Optional[FaultContext] = None
) -> torch.Tensor:
    ctx = ctx or healthy()
    n = cfg.num_layers
    for i in range(n):
        # a split layer (the sharded engine's compute="sharded") adds each
        # bias piece to its column block before the blocks are joined
        x = fault_linear(x, params[f"w{i}"], ctx, bias=params[f"b{i}"])
        if i < n - 1:
            # jax.nn.gelu, which the reference calls, is the tanh approximation
            x = F.gelu(x, approximate="tanh")
    return x


def classifier_loss(params: dict, batch: dict, cfg, ctx: Optional[FaultContext] = None):
    """``(loss, {"loss", "accuracy"})``: mean cross-entropy
    (logsumexp - gold logit) and argmax accuracy, in float32."""
    logits = classifier_forward(params, batch["x"], cfg, ctx).float()
    labels = batch["labels"]
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[:, None])[:, 0]
    loss = (logz - gold).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, dict(loss=loss, accuracy=acc)
