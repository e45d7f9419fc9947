"""ABFT checksum probes: the fault sensor of online detection.

Every serving path assumes a chip's :class:`~repro_torch.core.faults.FaultMap`
is known before traffic starts, but permanent faults appear in the field.
Zhang et al. (arxiv 1802.04657) observe that a permanent systolic-array
fault corrupts masked-GEMM outputs in a *structured* way, and the
weight-stationary mapping here (``core/mapping.py::periodic_mask``) makes
the structure exact:

    y[m, b] = sum_a x[m, a] * W[a, b] * ok[a % R, b % C]

so a fault at PE ``(rho, c)`` perturbs ONLY output columns ``b`` with
``b % C == c``, through ONLY the weight rows ``a`` with ``a % R == rho``.
That gives two complementary probes, both dispatched through the live
masked path (``kernels/masked_matmul/ops.py::masked_matmul_checksummed``)
between decode steps:

* **canary probe** — a fixed pseudorandom input batch whose output is
  snapshotted at attach time. Healthy re-launches of the SAME kernel on
  the SAME inputs are bitwise identical, so any nonzero difference is hard
  evidence of a silicon change (structurally zero false positives) and
  the appended checksum row localizes the faulty PE *columns* by folding
  the per-column syndrome mod C.
* **structured row probe** — R inputs, row ``rho`` carrying pseudorandom
  values on exactly the ``a % R == rho`` coordinates. Its syndrome
  factorizes per PE row, so thresholding the folded per-(row, col)
  syndrome reconstructs a candidate *delta* ``FaultMap`` — the newly
  faulty PEs relative to the believed map.

Everything in this module is host-side numpy but
:func:`select_probe_weight`, which picks the GEMM the engine probes
through. :class:`ChipProber` takes an opaque ``dispatch`` callable, so the
same detector runs under the card kernel, its plain version on the host or
a pure-numpy silicon model. The port's copy of the reference's
``obs/abft.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

__all__ = [
    "ProbeResult",
    "ChipProber",
    "make_canary",
    "make_structured_probe",
    "periodic_mask_np",
    "fold_syndrome",
    "reconstruct_delta",
    "select_probe_weight",
]

# relative threshold on folded syndromes: healthy probes are bitwise
# identical to their golden snapshot (exact zero syndrome), so this only
# rejects float noise in the *reconstruction* after a real divergence
DEFAULT_REL_TOL = 1e-5


def periodic_mask_np(weight_shape: tuple[int, int], ok: np.ndarray) -> np.ndarray:
    """Numpy twin of ``core/mapping.py::periodic_mask`` for a 2-D weight:
    mask[a, b] = ok[a % R, b % C]. The detector's silicon model."""
    kdim, n = weight_shape
    r, c = ok.shape
    rows = np.arange(kdim) % r
    cols = np.arange(n) % c
    return np.asarray(ok, np.float32)[np.ix_(rows, cols)]


def make_canary(batch: int, k_dim: int, seed: int = 0) -> np.ndarray:
    """Fixed pseudorandom canary inputs (batch, K), float32 in [-1, 1)."""
    rng = np.random.default_rng(seed)
    return (rng.random((batch, k_dim), dtype=np.float32) * 2.0 - 1.0)


def make_structured_probe(k_dim: int, rows: int, seed: int = 0) -> np.ndarray:
    """Row-separating probe (R, K): probe row ``rho`` is nonzero exactly on
    the weight rows PE row ``rho`` serves (``a % R == rho``), with
    pseudorandom magnitudes in [0.5, 1.5) so no weight-row contribution
    cancels by construction."""
    rng = np.random.default_rng(seed)
    g = rng.random(k_dim, dtype=np.float32) + 0.5
    x = np.zeros((rows, k_dim), np.float32)
    rho = np.arange(k_dim) % rows
    x[rho, np.arange(k_dim)] = g
    return x


def fold_syndrome(syndrome: np.ndarray, cols: int) -> np.ndarray:
    """Fold an absolute per-output-column syndrome (..., N) onto the PE
    columns (..., C) by max over ``b % C == c`` — the mapping's period
    makes the fold exact, padding short tails with zero."""
    s = np.abs(np.asarray(syndrome, np.float64))
    n = s.shape[-1]
    pad = (-n) % cols
    if pad:
        s = np.concatenate(
            [s, np.zeros(s.shape[:-1] + (pad,), s.dtype)], axis=-1
        )
    return s.reshape(s.shape[:-1] + (-1, cols)).max(axis=-2)


def reconstruct_delta(
    expected: np.ndarray, actual: np.ndarray, cols: int,
    tol: float,
) -> np.ndarray:
    """Candidate newly-faulty PEs from a structured-probe divergence.

    ``expected``/``actual`` are the golden and live (R, N) probe outputs;
    the row-``rho`` syndrome lives only in columns served by PE row
    ``rho``, so folding each probe row's |syndrome| mod C and thresholding
    yields a bool (R, C) delta grid aligned with ``FaultMap.faulty``."""
    syn = np.asarray(actual, np.float64) - np.asarray(expected, np.float64)
    return fold_syndrome(syn, cols) > tol


def select_probe_weight(params) -> tuple[str, "torch.Tensor"]:
    """Pick the probe GEMM target: the largest weight under a fault-maskable
    name (``core/masking.py::MASKABLE_KEYS``) — the matmul a silicon fault
    is guaranteed to corrupt. ``params`` is a ``Model`` or a flat dict of
    its ``named_parameters``. Layer ``i``'s ``layers.i.mlp.wd`` stands for
    the reference's layer-stacked leaf ``['layers']['mlp']['wd']``, of
    which the reference probes the first layer's (K, N) matrix: the
    periodic mask repeats per GEMM, so one representative slice exercises
    every PE; so does the first expert of an MoE layer's ``(E, K, N)``
    stack. Candidates are walked in the reference's order (sorted keys,
    the first of equal sizes wins), so both packages pick the same matrix.
    Returns (path, weight) with the reference's path string."""
    from repro_torch.core.masking import MASKABLE_KEYS

    named = params.items() if isinstance(params, dict) else params.named_parameters()
    cands = []
    for name, leaf in named:
        parts = name.split(".")
        if parts[0] == "layers":
            if parts[1] != "0":
                continue
            parts = ["layers", *parts[2:]]
        if not (set(parts) & MASKABLE_KEYS) or leaf.ndim < 2:
            continue
        # an MoE layer's stacked experts (E, K, N): the first expert's matrix
        cands.append((tuple(parts), leaf[(0,) * (leaf.ndim - 2)]))
    best = None
    for path, mat in sorted(cands, key=lambda c: c[0]):
        if best is None or mat.numel() > best[1].numel():
            best = ("".join(f"[{k!r}]" for k in path), mat.detach())
    if best is None:
        raise ValueError("params hold no fault-maskable weight matrix to probe")
    return best


@dataclass(frozen=True)
class ProbeResult:
    """One probe tick's verdict for one chip."""

    canary_mismatches: int  # elements of the canary output differing bitwise
    syndrome_cols: np.ndarray  # (C,) folded |checksum-row syndrome| per PE col
    detected: bool
    dispatches: int  # probe GEMM dispatches spent (1 clean, 2 on divergence)
    delta: Optional[np.ndarray] = None  # bool (R, C) candidate new faults
    clock: Optional[int] = None  # decode-dispatch index of the probe
    chip: int = 0

    @property
    def delta_faults(self) -> int:
        return int(self.delta.sum()) if self.delta is not None else 0

    def as_dict(self) -> dict:
        return dict(
            chip=self.chip,
            clock=self.clock,
            detected=bool(self.detected),
            canary_mismatches=int(self.canary_mismatches),
            syndrome_max=float(self.syndrome_cols.max())
            if self.syndrome_cols.size else 0.0,
            delta_faults=self.delta_faults,
            dispatches=self.dispatches,
        )


@dataclass
class ChipProber:
    """Golden-snapshot ABFT prober for one chip's masked-GEMM path.

    ``dispatch(x: (B, K) float32) -> (y: (B, N), check_row: (N,))`` must
    push ``x`` through the chip's LIVE checksummed masked matmul
    (``masked_matmul_checksummed``) and return host numpy arrays.
    :meth:`snapshot` records golden outputs under the *believed* fault
    map at attach time; every later :meth:`probe` re-dispatches the same
    inputs through the same kernel, so a healthy chip's probe
    is bitwise identical to its golden (zero false positives by
    construction) and any divergence is localized via the syndrome math
    above. After a recovery action rebases the believed map, call
    :meth:`rebase` to re-snapshot.
    """

    dispatch: Callable[[np.ndarray], tuple[np.ndarray, np.ndarray]]
    array_shape: tuple[int, int]  # (R, C) — the PE grid / FaultMap shape
    k_dim: int  # contraction dim of the probed GEMM
    canary_batch: int = 4
    seed: int = 0
    rel_tol: float = DEFAULT_REL_TOL
    chip: int = 0
    canary_x: np.ndarray = field(init=False)
    probe_x: np.ndarray = field(init=False)

    def __post_init__(self):
        r, c = self.array_shape
        if r < 1 or c < 1:
            raise ValueError(f"bad PE array shape {self.array_shape}")
        self.canary_x = make_canary(self.canary_batch, self.k_dim, self.seed)
        self.probe_x = make_structured_probe(self.k_dim, r, self.seed + 1)
        self._gold_canary_y: Optional[np.ndarray] = None
        self._gold_canary_check: Optional[np.ndarray] = None
        self._gold_probe_y: Optional[np.ndarray] = None
        self._tol = 0.0
        self.snapshot()

    def snapshot(self) -> None:
        """(Re)record golden outputs under the currently-believed map."""
        y, chk = self.dispatch(self.canary_x)
        self._gold_canary_y = np.asarray(y).copy()
        self._gold_canary_check = np.asarray(chk, np.float64).copy()
        py, _ = self.dispatch(self.probe_x)
        self._gold_probe_y = np.asarray(py, np.float64).copy()
        self._tol = self.rel_tol * max(
            1.0, float(np.abs(self._gold_probe_y).max(initial=0.0)),
            float(np.abs(self._gold_canary_check).max(initial=0.0)),
        )

    rebase = snapshot  # recovery PRs re-baseline after adopting a new map

    def probe(self, *, clock: Optional[int] = None) -> ProbeResult:
        """One detection tick: canary first (cheap, bitwise-exact), then —
        only on divergence — the structured probe to reconstruct which PEs
        newly died."""
        _, c = self.array_shape
        y, chk = self.dispatch(self.canary_x)
        mism = int((np.asarray(y) != self._gold_canary_y).sum())
        syn = np.asarray(chk, np.float64) - self._gold_canary_check
        syndrome_cols = fold_syndrome(syn, c)
        detected = mism > 0 or bool((syndrome_cols > self._tol).any())
        delta = None
        dispatches = 1
        if detected:
            py, _ = self.dispatch(self.probe_x)
            delta = reconstruct_delta(self._gold_probe_y, py, c, self._tol)
            dispatches = 2
        return ProbeResult(
            canary_mismatches=mism, syndrome_cols=syndrome_cols,
            detected=detected, dispatches=dispatches, delta=delta,
            clock=clock, chip=self.chip,
        )
