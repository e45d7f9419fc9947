"""Architecture configuration: the frozen ``ArchConfig``, the registry that
maps ``--arch <id>`` strings to configs, and ``reduce_config`` for CPU tests.

The port's own copy of the reference's ``configs/base.py``: the dataclass
fields are identical, so a config built on either side describes the same
model. Only the architectures the port can run are registered.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ArchConfig:
    """A complete model architecture description (all families' fields;
    family-specific ones are zero/None when unused)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
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
    def has_attention(self) -> bool:
        return self.family in ("dense", "moe", "vlm", "audio", "hybrid")

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_moe(self) -> bool:
        return self.num_experts > 0

    def gemm_shapes(self) -> list[tuple[int, int, int]]:
        """``(d_in, d_out, uses)`` of every masked GEMM one step of the dense
        swiglu family runs: the seven per-layer projections, then the unembed."""
        d, f, hd = self.d_model, self.d_ff, self.resolved_head_dim
        q, kv, L = self.num_heads * hd, self.num_kv_heads * hd, self.num_layers
        return [(d, q, L), (d, kv, 2 * L), (q, d, L), (d, f, 2 * L), (f, d, L), (d, self.vocab_size, 1)]


_ARCH_MODULES = ["smollm_135m"]


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


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


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


__all__ = ["ArchConfig", "register", "get_arch", "reduce_config"]
