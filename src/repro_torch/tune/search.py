"""Candidate lattice and greedy neighbourhood search for the kernel autotuner.

The search space per kernel is the powers-of-two block lattice; every raw
point is normalized through the rules the ``ops.py`` wrapper applies (read
off the ``analysis.kernelgeom`` launch builders), so raw points that collapse
to the same launch are timed once.

:func:`hillclimb`: score a start point, walk one-parameter neighbours, move
on the first improvement, stop when no neighbour improves. The lint gate
lives in the tuner's score function, so a rejected config is never scored
and never launched.
"""
from __future__ import annotations

from typing import Callable, Iterable, Mapping, Optional, Sequence

__all__ = ["pow2_lattice", "lattice_neighbors", "hillclimb"]


def pow2_lattice(dim: int, *, lo: int = 8, hi: int = 4096) -> list[int]:
    """Powers of two in [lo, min(hi, next_pow2(dim))], plus ``dim`` itself:
    the whole-axis block is always a candidate."""
    dim = int(dim)
    out = []
    b = 1
    while b <= min(hi, 2 * dim):
        if lo <= b <= dim:
            out.append(b)
        b *= 2
    if dim not in out and dim >= 1:
        out.append(dim)
    return sorted(set(out))


def lattice_neighbors(
    blocks: Mapping[str, int], lattices: Mapping[str, Sequence[int]]
) -> Iterable[dict[str, int]]:
    """One-parameter moves: each block parameter steps to the adjacent
    lattice value (up first: larger blocks mean fewer steps)."""
    for name, lattice in lattices.items():
        cur = blocks[name]
        # position of the closest lattice point (cur itself when present)
        idx = min(range(len(lattice)), key=lambda i: (abs(lattice[i] - cur), i))
        for j in (idx + 1, idx - 1):
            if 0 <= j < len(lattice) and lattice[j] != cur:
                yield {**blocks, name: lattice[j]}


def hillclimb(
    start,
    neighbors: Callable[[dict], Iterable[dict]],
    score: Callable[[dict], Optional[float]],
    *,
    key: Callable[[dict], tuple] = lambda c: tuple(sorted(c.items())),
    max_evals: int = 32,
):
    """Greedy first-improvement neighbourhood search.

    ``score`` returns a float (lower is better) or ``None`` for a candidate
    that must not be evaluated (the tuner's lint-rejected configs). Returns
    ``(best, best_score, evals)``, where ``evals`` counts the scored
    candidates, the start included.
    """
    seen = {key(start)}
    best_score = score(start)
    if best_score is None:
        raise ValueError(f"hillclimb start {start!r} is not scoreable")
    best = start
    evals = 1
    improved = True
    while improved and evals < max_evals:
        improved = False
        for cand in neighbors(best):
            k = key(cand)
            if k in seen:
                continue
            seen.add(k)
            s = score(cand)
            if s is None:
                continue
            evals += 1
            if s < best_score:
                best, best_score = cand, s
                improved = True
                break
            if evals >= max_evals:
                break
    return best, best_score, evals
