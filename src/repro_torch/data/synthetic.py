"""Deterministic synthetic data: the classification task of the
paper-faithful eFAT experiments (stands in for CIFAR; steps-to-accuracy is
measurable in seconds).

Everything is derived from (seed, step): there is no state to checkpoint
beyond the step counter, and a batch can be drawn again at any step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["ClusterData", "make_classification_task"]

EVAL_SALT = 10_000_019


@dataclass
class ClusterData:
    """Gaussian-cluster classification (paper-faithful experiment substrate).

    ``num_classes`` unit-norm cluster centers in ``dim`` dims; a small MLP
    reaches >95% accuracy in a few hundred steps.

    ``centers`` are drawn from ``np.random.default_rng(seed)`` as the
    reference draws them, and rounded to float32 as the reference keeps
    them: the two packages' centers are bit-equal. The batches are not the
    reference's: its ``jax.random`` (threefry) stream cannot be replayed
    here. ``batch_at`` draws labels and noise from
    ``np.random.default_rng((seed + salt, step))`` instead, so the stream is
    deterministic, seekable by step, and the same on the CPU and the card;
    the batch is then moved to ``device`` (the card unless asked otherwise).
    """

    dim: int = 32
    num_classes: int = 16
    seed: int = 0
    spread: float = 0.3
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        centers = rng.normal(size=(self.num_classes, self.dim))
        self.centers = (centers / np.linalg.norm(centers, axis=1, keepdims=True)).astype(np.float32)

    def batch_at(self, step: int, batch_size: int = 256, split: str = "train") -> dict:
        salt = 0 if split == "train" else EVAL_SALT
        rng = np.random.default_rng((self.seed + salt, int(step)))
        y = rng.integers(0, self.num_classes, size=batch_size)
        noise = rng.standard_normal((batch_size, self.dim), dtype=np.float32)
        x = self.centers[y] + np.float32(self.spread) * noise
        return {
            "x": torch.from_numpy(x).to(self.device),
            "labels": torch.from_numpy(y).to(self.device),
        }

    def eval_batches(self, n: int = 4, batch_size: int = 512) -> list[dict]:
        return [self.batch_at(i, batch_size, split="eval") for i in range(n)]


def make_classification_task(cfg, seed: int = 0, device=None) -> ClusterData:
    """Dataset sized to the paper_mlp config (vocab_size == num classes)."""
    return ClusterData(dim=cfg.d_model // 4, num_classes=cfg.vocab_size, seed=seed, device=device)
