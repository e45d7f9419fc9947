"""Deterministic synthetic data pipelines.

Two streams:
  * ``TokenStream`` — LM batches with a learnable structure (a noisy copy
    through a fixed permutation) so cross-entropy and accuracy improve with
    training;
  * ``ClusterData`` — the classification task of the paper-faithful eFAT
    experiments (stands in for CIFAR; steps-to-accuracy is measurable in
    seconds).

Everything is derived from (seed, step): there is no state to checkpoint
beyond the step counter, and a batch can be drawn again at any step, which
is what makes a resumed run see the batches it would have seen.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["TokenStream", "ClusterData", "make_classification_task"]

EVAL_SALT = 10_000_019


@dataclass
class TokenStream:
    """Seekable LM batch stream.

    Sequences follow a 'noisy copy' law: token[t] is ``perm[token[t-1]]``,
    replaced with probability ``noise`` by a uniform token — a next-token
    task a small LM learns quickly, so FAT dynamics are visible. ``labels``
    are the next tokens (the last one ``perm`` of the last token).

    ``perm`` is ``np.random.default_rng(seed).permutation(vocab_size)``, as
    the reference draws it: the two packages' permutations are bit-equal.
    The batches are not the reference's: its ``jax.random`` (threefry)
    stream cannot be replayed here. ``batch_at`` draws the first tokens, the
    noise positions and the noise tokens from
    ``np.random.default_rng((seed, step))`` instead, so the stream is
    deterministic, seekable by step, and the same on the CPU and the card;
    the int64 batch is then moved to ``device`` (the card unless asked
    otherwise).
    """

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    noise: float = 0.1
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.perm = np.random.default_rng(self.seed).permutation(self.vocab_size)

    def batch_at(self, step: int) -> dict:
        b, s, v = self.batch_size, self.seq_len, self.vocab_size
        rng = np.random.default_rng((self.seed, int(step)))
        tok = rng.integers(0, v, size=b)
        noise_mask = rng.random((b, s)) < self.noise
        noise_tok = rng.integers(0, v, size=(b, s))
        tokens = np.empty((b, s), dtype=np.int64)
        for i in range(s):
            tok = np.where(noise_mask[:, i], noise_tok[:, i], self.perm[tok])
            tokens[:, i] = tok
        labels = np.concatenate([tokens[:, 1:], self.perm[tokens[:, -1:]]], axis=1)
        return {
            "tokens": torch.from_numpy(tokens).to(self.device),
            "labels": torch.from_numpy(labels).to(self.device),
        }


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
