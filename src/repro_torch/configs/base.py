"""Architecture and shape configuration: the frozen ``ArchConfig``, the
registry that maps ``--arch <id>`` strings to configs, the input-shape cells
(``ShapeConfig``, ``SHAPES``) and which (arch x shape) pairs are runnable
(``cell_skip_reason``, ``valid_cells``), and ``reduce_config`` for CPU tests.

The port's own copy of the reference's ``configs/base.py``: the dataclass
fields are identical, so a config built on either side describes the same
model. Every architecture of the reference is registered.
"""
from __future__ import annotations

import importlib
import math
from dataclasses import dataclass, replace
from typing import Optional

# the stub frontends' input widths (the reference's model.py): wav2vec2-style
# audio frames and InternViT patch embeddings, projected to d_model by the
# ``frontend`` GEMM
FRONTEND_DIMS = {"audio": 512, "vision": 1024}

# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell.

    kind: 'train' runs the train step; 'prefill' runs prefill; 'decode'
    runs one decode step (one new token against a KV cache of ``seq_len``).
    """

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ArchConfig:
    """A complete model architecture description (all families' fields;
    family-specific ones are zero/None when unused)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | classifier
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads
    qk_norm: bool = False
    sliding_window: Optional[int] = None  # SWA window size (tokens)
    rope_theta: float = 10_000.0

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0

    # --- SSM (Mamba-1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    # --- structure ---
    is_encoder: bool = False
    modality: str = "text"
    frontend_tokens: int = 0
    activation: str = "swiglu"  # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- fault/accelerator model (paper SIV-A: 256x256 systolic array) ---
    array_rows: int = 256
    array_cols: int = 256

    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def resolved_dt_rank(self) -> int:
        if self.ssm_dt_rank:
            return self.ssm_dt_rank
        return math.ceil(self.d_model / 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def sub_quadratic(self) -> bool:
        """True when a 500k-token decode has bounded state (SSM / SWA)."""
        if self.family == "ssm":
            return True
        return self.sliding_window is not None

    @property
    def has_attention(self) -> bool:
        return self.family in ("dense", "moe", "vlm", "audio", "hybrid")

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_moe(self) -> bool:
        return self.num_experts > 0

    def gemm_shapes(self) -> list[tuple[int, int, int]]:
        """``(d_in, d_out, uses)`` of every masked GEMM launch of one forward
        or decode step: the frontend where the modality has one (audio
        frames, vision patches; a forward or prefill only, first); per
        layer the attention projections (q, k and v, o), the MLP (swiglu:
        gate and up, down; gelu: in, down), an MoE layer's router and its
        three expert GEMMs (gate, up, down), each ONE launch for all E
        experts (the masked GEMM's expert axis), and the SSM's four
        (in_proj, x_proj, dt_w, out_proj), as the family has them; then the
        unembed, last."""
        d, f, L = self.d_model, self.d_ff, self.num_layers
        shapes = []
        if self.modality in FRONTEND_DIMS:
            shapes.append((FRONTEND_DIMS[self.modality], d, 1))
        if self.has_attention:
            hd = self.resolved_head_dim
            q, kv = self.num_heads * hd, self.num_kv_heads * hd
            shapes += [(d, q, L), (d, kv, 2 * L), (q, d, L)]
        if self.has_moe:
            shapes.append((d, self.num_experts, L))
        if f:
            shapes += [(d, f, (2 if self.activation == "swiglu" else 1) * L), (f, d, L)]
        if self.has_ssm:
            di, r, n = self.d_inner, self.resolved_dt_rank, self.ssm_state
            shapes += [(d, 2 * di, L), (di, r + 2 * n, L), (r, di, L), (di, d, L)]
        return shapes + [(d, self.vocab_size, 1)]

    def param_count(self) -> int:
        """Analytic parameter count, the reference's formula (the fleet
        capacity planner sizes members with it)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.resolved_head_dim
        per_layer = 0
        if self.has_attention:
            per_layer += d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        if self.has_ssm:
            di, n, r = self.d_inner, self.ssm_state, self.resolved_dt_rank
            per_layer += d * 2 * di + di * self.ssm_conv + di * (r + 2 * n) + r * di + di + di * n + di + di * d
        if self.has_moe:
            per_layer += d * self.num_experts + self.num_experts * 3 * d * f
        elif f > 0:
            per_layer += (3 if self.activation == "swiglu" else 2) * d * f
        per_layer += 2 * d  # two norms
        head = 0 if self.tie_embeddings else v * d
        return L * per_layer + v * d + head + d  # embedding, head, final norm


_ARCH_MODULES = [
    "falcon_mamba_7b",
    "phi3_mini_3_8b",
    "qwen3_0_6b",
    "llama3_405b",
    "smollm_135m",
    "llama4_maverick_400b_a17b",
    "mixtral_8x22b",
    "internvl2_26b",
    "hubert_xlarge",
    "hymba_1_5b",
    "paper_mlp",
]


def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_").lower()


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[_norm(cfg.name)] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    key = _norm(name)
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def list_archs(include_paper: bool = False) -> list[str]:
    _ensure_loaded()
    return [a for a in sorted(_REGISTRY) if include_paper or a != "paper_mlp"]


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def cell_skip_reason(cfg: ArchConfig, shape: ShapeConfig) -> Optional[str]:
    """None if the (arch, shape) cell is runnable, else why not."""
    if cfg.is_encoder and shape.kind == "decode":
        return "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "full-attention arch: 500k decode needs sub-quadratic attention"
    return None


def valid_cells(arch_names: Optional[list[str]] = None) -> list[tuple[str, str]]:
    """Every runnable (arch, shape) cell, in registry then ``SHAPES`` order."""
    _ensure_loaded()
    names = arch_names or list_archs()
    cells = []
    for a in names:
        cfg = get_arch(a)
        for s in SHAPES.values():
            if cell_skip_reason(cfg, s) is None:
                cells.append((a, s.name))
    return cells


def reduce_config(cfg: ArchConfig) -> ArchConfig:
    """Family-preserving tiny version of ``cfg`` for CPU tests (the same
    cut as the reference's ``reduce_config``)."""
    changes: dict = dict(
        num_layers=2,
        d_model=64,
        vocab_size=97 if cfg.vocab_size else 0,
        norm_eps=cfg.norm_eps,
        array_rows=16,
        array_cols=16,
        dtype="float32",
        param_dtype="float32",
        frontend_tokens=min(cfg.frontend_tokens, 4) if cfg.frontend_tokens else 0,
    )
    if cfg.has_attention and cfg.num_heads:
        ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
        kv = min(2, cfg.num_kv_heads)
        changes.update(num_heads=kv * min(ratio, 2), num_kv_heads=kv, head_dim=16)
    if cfg.d_ff:
        changes["d_ff"] = 128
    if cfg.has_moe:
        changes.update(num_experts=4, experts_per_token=min(cfg.experts_per_token, 2))
    if cfg.has_ssm:
        changes.update(ssm_state=8, ssm_conv=4, ssm_expand=2, ssm_dt_rank=8)
    if cfg.sliding_window:
        changes["sliding_window"] = 32
    return replace(cfg, **changes)


__all__ = [
    "ArchConfig",
    "FRONTEND_DIMS",
    "SHAPES",
    "ShapeConfig",
    "cell_skip_reason",
    "get_arch",
    "list_archs",
    "reduce_config",
    "register",
    "valid_cells",
]
