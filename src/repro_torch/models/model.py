"""Model assembly for every family of the reference (dense, moe, ssm,
hybrid, vlm, audio): parameters, forward, loss, prefill, decode.

Parameters are ``nn.Module``s; the layers are an ``nn.ModuleList`` walked by
a Python loop (the reference stacks them on a leading axis and scans). Every
GEMM weight keeps the reference's ``(d_in, d_out)`` layout, because the
chip's fault mask is defined on that view; ``nn.Linear``'s ``(out, in)``
would mask other weights. Every parameterized GEMM goes through
``fault_linear``.

``forward`` and ``loss_fn`` also take the parameters as a flat dict of
tensors named as ``Model.named_parameters()`` names them (``embed``,
``layers.3.attn.wq``, ...; :func:`param_dict`): the functional form the
optimizer, the FAT engines and ``torch.func.vmap`` work on. The dict is read
through a view with the module's attribute names, so both forms run one
code path.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import FRONTEND_DIMS
from repro_torch.core.masking import FaultContext, fault_linear, healthy, mask_selected_params
from repro_torch.device import resolve_device
from repro_torch.models.layers import (
    KVCache,
    PagedKVView,
    apply_norm,
    attention_block,
    mlp_block,
    rope_tables,
)
from repro_torch.models.moe import moe_block
from repro_torch.models.ssm import SSMCache, ssm_block

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _empty(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class Norm(nn.Module):
    """RMSNorm's ``scale``; the audio family's LayerNorm also has a
    ``bias`` (the reference's hubert)."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        self.scale = _empty(cfg.d_model, device=device, dtype=dtype)
        if cfg.family == "audio":
            self.bias = _empty(cfg.d_model, device=device, dtype=dtype)


class Attention(nn.Module):
    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
        self.wq = _empty(d, q, device=device, dtype=dtype)
        self.wk = _empty(d, kv, device=device, dtype=dtype)
        self.wv = _empty(d, kv, device=device, dtype=dtype)
        self.wo = _empty(q, d, device=device, dtype=dtype)
        if cfg.qk_norm:
            self.q_norm = _empty(hd, device=device, dtype=dtype)
            self.k_norm = _empty(hd, device=device, dtype=dtype)


class MLP(nn.Module):
    """SwiGLU (``wg``, ``wu``, ``wd``) or gelu (``wi``, ``wd``)."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        if cfg.activation == "swiglu":
            self.wg = _empty(d, f, device=device, dtype=dtype)
            self.wu = _empty(d, f, device=device, dtype=dtype)
        else:
            self.wi = _empty(d, f, device=device, dtype=dtype)
        self.wd = _empty(f, d, device=device, dtype=dtype)


class MoE(nn.Module):
    """The router ``(d, E)`` and the experts' stacked ``wg``, ``wu`` ``(E,
    d, f)`` and ``wd`` ``(E, f, d)``, as the reference initializes them."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.router = _empty(d, e, device=device, dtype=dtype)
        self.wg = _empty(e, d, f, device=device, dtype=dtype)
        self.wu = _empty(e, d, f, device=device, dtype=dtype)
        self.wd = _empty(e, f, d, device=device, dtype=dtype)


class SSM(nn.Module):
    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        d, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.resolved_dt_rank
        self.in_proj = _empty(d, 2 * di, device=device, dtype=dtype)
        self.conv_w = _empty(cfg.ssm_conv, di, device=device, dtype=dtype)
        self.conv_b = _empty(di, device=device, dtype=dtype)
        self.x_proj = _empty(di, r + 2 * n, device=device, dtype=dtype)
        self.dt_w = _empty(r, di, device=device, dtype=dtype)
        self.dt_b = _empty(di, device=device, dtype=dtype)
        self.a_log = _empty(di, n, device=device, dtype=dtype)
        self.d_skip = _empty(di, device=device, dtype=dtype)
        self.out_proj = _empty(di, d, device=device, dtype=dtype)


class Layer(nn.Module):
    """One layer, with the reference's parameter names: ``attn`` for the
    attention families, ``ssm`` for ssm and hybrid, the hybrid's branch
    weights ``alpha_attn`` and ``alpha_ssm``, ``ln2`` and ``moe`` for the
    moe family and ``ln2`` and ``mlp`` for the others but ssm."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = Norm(cfg, **kw)
        if cfg.has_attention:
            self.attn = Attention(cfg, **kw)
        if cfg.has_ssm:
            self.ssm = SSM(cfg, **kw)
        if cfg.family == "hybrid":
            self.alpha_attn = _empty(cfg.d_model, **kw)
            self.alpha_ssm = _empty(cfg.d_model, **kw)
        if cfg.family != "ssm":
            self.ln2 = Norm(cfg, **kw)
            if cfg.family == "moe":
                self.moe = MoE(cfg, **kw)
            else:
                self.mlp = MLP(cfg, **kw)


class Model(nn.Module):
    """The parameters of one model, uninitialized; fill them with
    :func:`init_params` or ``repro_torch.convert.params_from_jax``. The
    audio and vision modalities add the stub frontend ``(512, d)`` or
    ``(1024, d)`` (``FRONTEND_DIMS``) that projects frame or patch
    embeddings to the model's width."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        if cfg.family == "classifier":
            raise NotImplementedError(f"{cfg.name}: the classifier has its own module, models/classifier.py")
        kw = dict(device=resolve_device(device), dtype=getattr(torch, cfg.param_dtype))
        self.embed = _empty(cfg.vocab_size, cfg.d_model, **kw)
        self.layers = nn.ModuleList(Layer(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_ln = Norm(cfg, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = _empty(cfg.d_model, cfg.vocab_size, **kw)
        if cfg.modality in FRONTEND_DIMS:
            self.frontend = _empty(FRONTEND_DIMS[cfg.modality], cfg.d_model, **kw)


# logical axes of each parameter (``repro_torch.launch.sharding`` names), the
# reference's tables; the fleet engine lays member state out by them


def _norm_specs(cfg) -> dict:
    return {"scale": (None,), "bias": (None,)} if cfg.family == "audio" else {"scale": (None,)}


def layer_specs(cfg) -> dict:
    """Logical axes of one layer's parameters, by module and leaf."""
    s: dict = {"ln1": _norm_specs(cfg)}
    if cfg.has_attention:
        s["attn"] = dict(wq=("embed", "qkv"), wk=("embed", "kv"), wv=("embed", "kv"), wo=("qkv", "embed"))
        if cfg.qk_norm:
            s["attn"].update(q_norm=(None,), k_norm=(None,))
    if cfg.has_ssm:
        s["ssm"] = dict(
            in_proj=("embed", "inner"), conv_w=(None, "inner"), conv_b=("inner",), x_proj=("inner", None),
            dt_w=(None, "inner"), dt_b=("inner",), a_log=("inner", None), d_skip=("inner",),
            out_proj=("inner", "embed"),
        )
    if cfg.family == "hybrid":
        s["alpha_attn"] = (None,)
        s["alpha_ssm"] = (None,)
    if cfg.family != "ssm":
        s["ln2"] = _norm_specs(cfg)
        if cfg.family == "moe":
            s["moe"] = dict(router=("embed", None), wg=("expert", "embed", "mlp"),
                            wu=("expert", "embed", "mlp"), wd=("expert", "mlp", "embed"))
        elif cfg.activation == "swiglu":
            s["mlp"] = dict(wg=("embed", "mlp"), wu=("embed", "mlp"), wd=("mlp", "embed"))
        else:
            s["mlp"] = dict(wi=("embed", "mlp"), wd=("mlp", "embed"))
    return s


def param_specs(cfg) -> dict[str, tuple]:
    """Logical axes of every parameter, keyed by :func:`param_dict`'s names;
    no allocation. The reference's tree with its layer stacks unrolled: a
    layer leaf here has no leading ``"layers"`` axis."""
    if cfg.family == "classifier":
        raise NotImplementedError(f"{cfg.name}: see models/classifier.py::classifier_param_axes")
    specs: dict = {"embed": ("vocab", "embed")}
    layer = layer_specs(cfg)
    for i in range(cfg.num_layers):
        for mod, leaves in layer.items():
            if isinstance(leaves, dict):
                specs.update({f"layers.{i}.{mod}.{k}": ax for k, ax in leaves.items()})
            else:
                specs[f"layers.{i}.{mod}"] = leaves
    specs.update({f"final_ln.{k}": ax for k, ax in _norm_specs(cfg).items()})
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("embed", "vocab")
    if cfg.modality in FRONTEND_DIMS:
        specs["frontend"] = ("frame", "embed")
    return specs


@torch.no_grad()
def init_params(cfg, seed: int = 0, *, device=None) -> Model:
    """Random parameters from the port's own seeded generator, with the
    reference's distributions: embeddings N(0, 0.02^2), GEMM weights (the
    experts' too, fan_in their d_in axis) and the conv taps N(0, 1/fan_in),
    norm scales, qk-norm scales, branch weights and the SSM's skip 1, the
    conv and norm biases 0, ``a_log = log(1..N)`` and ``dt_b`` the inverse
    softplus of a log-uniform dt in [1e-3, 1e-1]. (``jax.random`` streams
    cannot be replayed here, so parity tests hand weights over with
    ``convert``.)"""
    model = Model(cfg, device=device)
    dev = model.embed.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "a_log":
            p.copy_(torch.log(torch.arange(1, p.shape[1] + 1, device=dev, dtype=p.dtype)).expand(p.shape))
        elif leaf == "dt_b":
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt = torch.exp(torch.rand(p.shape, generator=gen, device=dev, dtype=p.dtype) * (hi - lo) + lo)
            p.copy_(dt + torch.log(-torch.expm1(-dt)))
        elif leaf in ("conv_b", "bias"):
            p.zero_()
        elif p.ndim == 1:
            p.fill_(1.0)
        else:
            std = 0.02 if name == "embed" else 1.0 / math.sqrt(p.shape[-2])
            p.copy_(torch.randn(p.shape, generator=gen, device=dev, dtype=p.dtype) * std)
    return model


def param_dict(model: Model) -> dict[str, Tensor]:
    """The model's parameters as a flat dict of plain tensors (no autograd
    leaves), keyed by their ``named_parameters`` names."""
    return {name: p.detach() for name, p in model.named_parameters()}


def _view(flat: dict[str, Tensor]) -> SimpleNamespace:
    """A flat parameter dict seen with the ``Model``'s attribute names:
    ``view.layers[3].attn.wq`` is ``flat["layers.3.attn.wq"]``."""
    root: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t

    def build(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [build(node[k]) for k in sorted(node, key=int)]
        return SimpleNamespace(**{k: build(v) for k, v in node.items()})

    return build(root)


Params = Union[Model, dict]


def as_params(params: Params):
    """A ``Model``, a namespace view, or a flat dict seen through its view:
    the serving steps take all three, so ``torch.func.vmap`` can map them
    over a dict of chip-stacked parameters (the fleet engines)."""
    return _view(params) if isinstance(params, dict) else params


# ---------------------------------------------------------------------------
# Blocks, embedding, unembedding
# ---------------------------------------------------------------------------


def _block(
    lp: Layer, x, cfg, ctx, *, rope, attn_impl, cache=(None, None), build_cache=False, segments=None,
    moe_impl="einsum", moe_cf=1.25,
):
    """One layer. ``cache`` is the layer's (KVCache or PagedKVView, SSMCache)
    decode state, each None where the family has no such branch. Returns
    (x, pieces): with ``build_cache`` (prefill) ``pieces["kv"]`` holds the
    raw (k, v) and ``pieces["ssm"]`` the SSMCache the layer leaves behind;
    an MoE layer's routing loss is ``pieces["aux"]``. ``segments`` masks
    packed prefill rows (``dense_attention``)."""
    kv_cache, ssm_cache = cache
    pieces = {}
    h = apply_norm(x, lp.ln1, cfg.norm_eps)
    if cfg.has_attention:
        a, pieces["kv"] = attention_block(
            lp.attn, h, cfg, ctx, rope=rope, impl=attn_impl, cache=kv_cache, return_kv=build_cache,
            segments=segments,
        )
    if cfg.has_ssm:
        s, pieces["ssm"] = ssm_block(lp.ssm, h, cfg, ctx, cache=ssm_cache, build_cache=build_cache)
    if cfg.family == "ssm":
        return x + s, pieces
    if cfg.family == "hybrid":
        # attention and the SSM read the same input in parallel
        a = 0.5 * (a * lp.alpha_attn.to(a.dtype) + s * lp.alpha_ssm.to(a.dtype))
    x = x + a
    h2 = apply_norm(x, lp.ln2, cfg.norm_eps)
    if cfg.family == "moe":
        y, pieces["aux"] = moe_block(lp.moe, h2, cfg, ctx, impl=moe_impl, capacity_factor=moe_cf)
        return x + y, pieces
    return x + mlp_block(lp.mlp, h2, cfg, ctx), pieces


def embed_inputs(cfg, params, batch: dict, ctx: FaultContext) -> tuple[Tensor, Tensor]:
    """Returns (x (B, S, d) in compute dtype, positions (B, S)).

    Audio takes ``batch["embeds"]`` (frame embeddings) through the
    ``frontend`` GEMM; vision puts the patch embeddings' projection, where
    the batch has ``embeds``, before the token embeddings."""
    dtype = getattr(torch, cfg.dtype)
    parts = []
    if cfg.modality == "audio":
        parts.append(fault_linear(batch["embeds"].to(dtype), params.frontend, ctx))
    else:
        if cfg.modality == "vision" and "embeds" in batch:
            parts.append(fault_linear(batch["embeds"].to(dtype), params.frontend, ctx))
        if "tokens" in batch:
            parts.append(params.embed[batch["tokens"]].to(dtype))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    b, s = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    return x, positions


def unembed(cfg, params, x: Tensor, ctx: FaultContext) -> Tensor:
    # tied: a transposed view; the masked-GEMM kernel reads it in place
    params = as_params(params)
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    return fault_linear(x, w, ctx)


def _rope(cfg, positions: Tensor):
    if not cfg.has_attention or cfg.is_encoder:  # encoders take no RoPE
        return None
    return rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)


# ---------------------------------------------------------------------------
# Forward (train / eval / prefill-without-cache)
# ---------------------------------------------------------------------------


REMAT = ("none", "dots", "full")


def forward(
    params: Params,
    batch: dict,
    cfg,
    ctx: Optional[FaultContext] = None,
    *,
    attn_impl: str = "auto",
    moe_impl: str = "einsum",
    moe_cf: float = 1.25,
    remat: str = "dots",
    fault_apply: str = "per_use",
) -> tuple[Tensor, Tensor]:
    """Full-sequence forward. Returns (logits (B, S, V), aux_loss): the sum
    of the MoE layers' routing losses, 0 for the other families.
    ``moe_impl`` ('einsum' or 'scatter') and ``moe_cf`` (the capacity
    factor) pick the MoE dispatch (``models/moe.py``).

    ``params`` is a ``Model`` or a flat dict of tensors (:func:`param_dict`).

    fault_apply: 'per_use' masks inside every matmul (paper-faithful);
    'per_step' masks the array-mapped params once (identical math, one
    weight-sized pass per step instead of per use). The tied unembed keeps
    its use-site mask: the lookup needs the unmasked rows.

    remat: 'none', or 'dots' / 'full' (the reference's two policies), which
    here both recompute each layer in the backward pass
    (``torch.utils.checkpoint``); the numbers are the same. It applies only
    where autograd records: ``torch.func`` transforms take no checkpoints,
    so the FAT engines pass 'none', as the reference's trainer does.
    """
    if remat not in REMAT:
        raise ValueError(f"unknown remat {remat!r}; expected one of {REMAT}")
    if fault_apply not in ("per_use", "per_step"):
        raise ValueError(f"unknown fault_apply {fault_apply!r}")
    ctx = ctx or healthy()
    ctx_unembed = ctx
    if fault_apply == "per_step" and ctx.active:
        flat = params if isinstance(params, dict) else dict(params.named_parameters())
        params = mask_selected_params(flat, ctx)
        ctx = healthy()
    params = as_params(params)
    x, positions = embed_inputs(cfg, params, batch, ctx)
    rope = _rope(cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(lp, h):
        h, pieces = _block(lp, h, cfg, ctx, rope=rope, attn_impl=attn_impl, moe_impl=moe_impl, moe_cf=moe_cf)
        return h, pieces.get("aux")

    for lp in params.layers:
        if remat != "none" and torch.is_grad_enabled():
            x, a = checkpoint(layer, lp, x, use_reentrant=False)
        else:
            x, a = layer(lp, x)
        if a is not None:
            aux = aux + a
    x = apply_norm(x, params.final_ln, cfg.norm_eps)
    logits = unembed(cfg, params, x, ctx_unembed if cfg.tie_embeddings else ctx)
    return logits, aux


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def loss_fn(
    params: Params,
    batch: dict,
    cfg,
    ctx: Optional[FaultContext] = None,
    *,
    attn_impl: str = "auto",
    moe_impl: str = "einsum",
    moe_cf: float = 1.25,
    remat: str = "dots",
    aux_weight: float = 0.01,
    fault_apply: str = "per_use",
) -> tuple[Tensor, dict]:
    """Next-token cross-entropy in float32 (``logsumexp``), weighted by
    ``batch["loss_mask"]`` where given. Returns (loss, dict(loss, ce, aux,
    accuracy))."""
    logits, aux = forward(
        params, batch, cfg, ctx, attn_impl=attn_impl, moe_impl=moe_impl, moe_cf=moe_cf, remat=remat,
        fault_apply=fault_apply,
    )
    labels = batch["labels"]
    # frontends may prepend non-text positions: align to the tail
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, -labels.shape[1] :]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    logits32 = logits.float()
    logz = torch.logsumexp(logits32, dim=-1)
    gold = torch.take_along_dim(logits32, labels[..., None], dim=-1)[..., 0]
    nll = (logz - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = nll.sum() / denom
    acc = (torch.argmax(logits32, dim=-1) == labels).float()
    acc = (acc * mask).sum() / denom
    loss = ce + aux_weight * aux
    return loss, dict(loss=loss, ce=ce, aux=aux, accuracy=acc)


# ---------------------------------------------------------------------------
# KV/SSM cache: init, prefill, decode
# ---------------------------------------------------------------------------


def cache_buffer_len(cfg, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache(cfg, batch: int, seq_len: int, *, device=None) -> dict:
    """Zero cache able to hold ``seq_len`` history (window-bounded for SWA)
    and the int ``index``. Attention families hold ``k``/``v`` of shape
    (L, B, Hkv, S_buf, hd); SSM families hold ``conv`` (L, B, K-1, d_inner)
    in the compute dtype and ``h`` (L, B, d_inner, N) in fp32."""
    kw = dict(dtype=getattr(torch, cfg.dtype), device=resolve_device(device))
    L, c = cfg.num_layers, {"index": 0}
    if cfg.has_attention:
        shape = (L, batch, cfg.num_kv_heads, cache_buffer_len(cfg, seq_len), cfg.resolved_head_dim)
        c["k"], c["v"] = torch.zeros(shape, **kw), torch.zeros(shape, **kw)
    if cfg.has_ssm:
        c["conv"] = torch.zeros((L, batch, cfg.ssm_conv - 1, cfg.d_inner), **kw)
        kw["dtype"] = torch.float32
        c["h"] = torch.zeros((L, batch, cfg.d_inner, cfg.ssm_state), **kw)
    return c


def _layer_cache(cfg, cache: dict, i: int, index: int):
    """Layer ``i``'s (KVCache, SSMCache) views into the stacked buffers."""
    kv = KVCache(cache["k"][i], cache["v"][i], index) if cfg.has_attention else None
    ssm = SSMCache(cache["conv"][i], cache["h"][i]) if cfg.has_ssm else None
    return kv, ssm


def _ring_perm(s_buf: int, total: int) -> np.ndarray:
    """inv_perm[slot] = index (into the last s_buf tokens) stored at slot."""
    return (np.arange(s_buf) - (total % s_buf)) % s_buf


@torch.no_grad()
def prefill(
    params: Params,
    batch: dict,
    cfg,
    ctx: Optional[FaultContext] = None,
    *,
    cache_len: Optional[int] = None,
    attn_impl: str = "auto",
    moe_impl: str = "einsum",
    moe_cf: float = 1.25,
    valid_len: Optional[int] = None,
    full_kv: bool = False,
    return_hidden: bool = False,
    segments: Optional[Tensor] = None,
) -> tuple[Tensor, dict]:
    """Full-sequence forward that also builds the decode cache.

    Returns (logits_last (B, V), cache). ``valid_len`` marks the real
    prompt length of a right-padded batch: logits come from position
    ``valid_len - 1``, the cache keeps the valid tokens (the SWA ring order
    follows ``valid_len``) and ``cache["index"] = valid_len``, so decode
    overwrites the pad. Causality alone keeps right-pad keys away from every
    real query. SSM families take none of the padded or packed options:
    right-pad tokens would advance the scan; nor do encoders, whose pad
    keys no causal mask hides.

    A vision batch's ``embeds`` prefix stays in the cache ahead of the
    tokens, and the logits are the last position's: the tail's, as
    ``loss_fn`` aligns them.

    ``full_kv`` skips the ring/tail truncation and returns the raw
    ``(L, B, Hkv, S, hd)`` KV as the cache's k/v — the paged admission,
    where window masking happens at the paged read instead.

    ``return_hidden`` returns the post-norm hidden states ``(B, S, d)`` in
    place of logits, so the caller can gather any positions (packed prefill
    gathers one last-token row per segment) and unembed itself.

    ``segments`` (``(B, S)`` int, with per-segment restarting
    ``batch["positions"]``) packs several prompts into one row; attention is
    masked to same-segment tokens (``models/layers.py``).
    """
    if (full_kv or segments is not None or valid_len is not None) and (cfg.has_ssm or cfg.is_encoder):
        raise ValueError("padded/packed prefill supports causal attention families only")
    ctx = ctx or healthy()
    params = as_params(params)
    x, positions = embed_inputs(cfg, params, batch, ctx)
    b, s = x.shape[0], x.shape[1]
    total = s if valid_len is None else int(valid_len)
    cache_len = s if full_kv else cache_len or s
    # the cache is built from the layers' keys, values and SSM states
    # without in-place writes, so that prefill maps over chips under
    # torch.func.vmap (the fleet engines)
    cache = {}
    if cfg.has_attention:
        s_buf = s if full_kv else cache_buffer_len(cfg, cache_len)
        perm = None
        if s >= s_buf and not full_kv:
            # the last s_buf VALID tokens end at total
            ring = bool(cfg.sliding_window) and s_buf == cfg.sliding_window
            start = min(max(total - s_buf, 0), s - s_buf)
            order = _ring_perm(s_buf, total) if ring and total >= s_buf else np.arange(s_buf)
            perm = torch.as_tensor(start + order, device=x.device)
    ks, vs, convs, hs = [], [], [], []
    rope = _rope(cfg, positions)
    for lp in params.layers:
        x, pieces = _block(
            lp, x, cfg, ctx, rope=rope, attn_impl=attn_impl, build_cache=True, segments=segments,
            moe_impl=moe_impl, moe_cf=moe_cf,
        )
        if cfg.has_attention:
            k, v = pieces["kv"]
            if perm is not None:
                k, v = k[:, :, perm], v[:, :, perm]
            ks.append(k)
            vs.append(v)
        if cfg.has_ssm:
            convs.append(pieces["ssm"].conv)
            hs.append(pieces["ssm"].h)
    if cfg.has_attention:
        # one pad of the stacked prompt: the peak is the cache and one copy
        # of the prompt's keys and values
        cache["k"], cache["v"] = torch.stack(ks), torch.stack(vs)
        del ks, vs
        if s < s_buf:
            tail = (0, 0, 0, s_buf - s)
            cache["k"], cache["v"] = F.pad(cache["k"], tail), F.pad(cache["v"], tail)
    if cfg.has_ssm:
        cache["conv"], cache["h"] = torch.stack(convs), torch.stack(hs)
    cache["index"] = total
    if return_hidden:
        return apply_norm(x, params.final_ln, cfg.norm_eps), cache
    last = x[:, total - 1 : total]
    logits = unembed(cfg, params, apply_norm(last, params.final_ln, cfg.norm_eps), ctx)[:, 0]
    return logits, cache


@torch.no_grad()
def prefill_chunk(
    params: Params,
    tokens: Tensor,  # (1, C) — one chunk of one request's prompt
    cfg,
    ctx: Optional[FaultContext] = None,
    *,
    k_pages: Tensor,  # (L, P, Hkv, page, hd) shared pool
    v_pages: Tensor,
    row: Tensor,  # (max_pages_per_seq,) int — this slot's page chain
    prefix_len: int,  # tokens already prefilled (a multiple of C)
    valid_len: int,  # real tokens in this chunk (C except the last)
    moe_impl: str = "einsum",
    moe_cf: float = 1.25,
) -> tuple[Tensor, Tensor, Tensor]:
    """One chunked-prefill step: continue a prompt against its paged prefix.

    Gathers the slot's page chain into a dense buffer, runs the chunk as a
    multi-token continuation (causal attention at ``q_offset=prefix_len``
    over ``prefix + chunk`` keys — sliding windows are handled by the dense
    window mask, never the ring buffer, so chunk boundaries crossing the
    window are exact), and returns
    ``(logits (1, V) at valid_len - 1, k_chunk, v_chunk (L, 1, Hkv, C, hd))``
    for the caller to write into the pool. The pool is only read. Every
    chunk of every prompt runs at the one width C over a chain of the
    engine-wide ``max_pages_per_seq``.
    """
    ctx = ctx or healthy()
    params = as_params(params)
    if cfg.has_ssm or cfg.is_encoder:
        raise ValueError("chunked prefill supports causal attention families only")
    b, s = tokens.shape
    if b != 1:
        raise ValueError(f"chunked prefill is one request per dispatch, got batch {b}")
    L, _, hkv, page, hd = k_pages.shape
    cap = row.shape[0] * page
    # the buffer must fit any chunk written at a chunk-aligned prefix, and
    # must dodge attention_block's ring-buffer branch (its causal=False
    # shortcut is for one decode token, wrong for a multi-token chunk)
    w_buf = -(-cap // s) * s
    if cfg.sliding_window and w_buf == cfg.sliding_window:
        w_buf += page
    prefix, vl = int(prefix_len), int(valid_len)
    positions = (prefix + torch.arange(s, device=tokens.device))[None]
    x = params.embed[tokens].to(getattr(torch, cfg.dtype))
    row = row.long()

    def chain_dense(pool):  # (L, P, Hkv, page, hd) -> (L, Hkv, w_buf, hd), a new buffer
        g = pool[:, row].movedim(2, 1).reshape(L, hkv, cap, hd)
        return F.pad(g, (0, 0, 0, w_buf - cap))

    k_buf, v_buf = chain_dense(k_pages), chain_dense(v_pages)
    rope = _rope(cfg, positions)
    for i, lp in enumerate(params.layers):
        kv = KVCache(k_buf[i][None], v_buf[i][None], prefix)
        x, _ = _block(
            lp, x, cfg, ctx, rope=rope, attn_impl="dense", cache=(kv, None), moe_impl=moe_impl, moe_cf=moe_cf
        )
    last = apply_norm(x[:, vl - 1 : vl], params.final_ln, cfg.norm_eps)
    logits = unembed(cfg, params, last, ctx)[:, 0]
    return logits, k_buf[:, None, :, prefix : prefix + s], v_buf[:, None, :, prefix : prefix + s]


@torch.no_grad()
def decode_step(
    params: Params,
    tokens: Tensor,
    cache: dict,
    cfg,
    ctx: Optional[FaultContext] = None,
    *,
    moe_impl: str = "einsum",
    moe_cf: float = 1.25,
    active: Optional[Tensor] = None,
) -> tuple[Tensor, dict]:
    """One autoregressive step against the cache. Returns (logits (B, s_new,
    V), cache).

    ``cache`` is either the dense cache from :func:`prefill` or
    :func:`init_cache`, or a paged cache (:func:`init_paged_cache`),
    detected by its ``k_pages`` key. The paged path reads each slot's page
    chain with a gather and puts slot ``b`` at its own ``seq_lens[b]``;
    with ``active`` (a per-slot bool mask) inactive slots neither write KV
    (their token lands on the reserved scratch page 0) nor advance their
    length. ``active`` is ignored on the dense path, whose single index
    always advances.

    The cache is updated IN PLACE (its k/v, conv and h buffers or pages, and
    its index or lengths) and the same dict is returned: the counterpart of
    the reference donating it. ``params`` may be a flat dict
    (:func:`param_dict`), so the step maps over chip-stacked parameters
    under ``torch.func.vmap``; there, every in-place write lands in the
    chip's own slice of the stacked cache."""
    ctx = ctx or healthy()
    params = as_params(params)
    if "k_pages" in cache:
        return _decode_step_paged(params, tokens, cache, cfg, ctx, moe_impl=moe_impl, moe_cf=moe_cf, active=active)
    b, s = tokens.shape
    index = cache["index"]
    positions = (index + torch.arange(s, device=tokens.device))[None].expand(b, s)
    x = params.embed[tokens].to(getattr(torch, cfg.dtype))
    rope = _rope(cfg, positions)
    for i, lp in enumerate(params.layers):
        layer_cache = _layer_cache(cfg, cache, i, index)
        x, _ = _block(
            lp, x, cfg, ctx, rope=rope, attn_impl="dense", cache=layer_cache, moe_impl=moe_impl, moe_cf=moe_cf
        )
    x = apply_norm(x, params.final_ln, cfg.norm_eps)
    logits = unembed(cfg, params, x, ctx)
    cache["index"] = index + s
    return logits, cache


def init_paged_cache(
    cfg, num_pages: int, page_size: int, num_slots: int, max_pages_per_seq: int, *, device=None
) -> dict:
    """Zero paged KV cache: a shared page pool + per-slot block tables.

    Layout: ``k_pages``/``v_pages`` are ``(L, num_pages, Hkv, page_size, hd)``
    pools in the compute dtype (page 0 reserved as the scratch page — see
    ``serve/kvcache.py::PageAllocator``), ``block_tables`` is
    ``(num_slots, max_pages_per_seq)`` int32 page ids and ``seq_lens`` the
    per-slot cached-token count. Attention families only: SSM state is O(1)
    per slot and needs no paging, and encoders have no decode.
    """
    if cfg.has_ssm:
        raise ValueError(
            f"paged KV cache supports attention families only; {cfg.family!r} "
            "carries SSM state (which is O(1) per slot and needs no paging)"
        )
    if cfg.is_encoder:
        raise ValueError("encoder-only arch has no decode path to page")
    dev = resolve_device(device)
    L, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (L, num_pages, hkv, page_size, hd)
    dtype = getattr(torch, cfg.dtype)
    return {
        "k_pages": torch.zeros(shape, dtype=dtype, device=dev),
        "v_pages": torch.zeros(shape, dtype=dtype, device=dev),
        "block_tables": torch.zeros((num_slots, max_pages_per_seq), dtype=torch.int32, device=dev),
        "seq_lens": torch.zeros((num_slots,), dtype=torch.int32, device=dev),
    }


def _decode_step_paged(
    params: Model,
    tokens: Tensor,  # (S, 1) — one token per slot
    cache: dict,
    cfg,
    ctx: FaultContext,
    *,
    moe_impl: str = "einsum",
    moe_cf: float = 1.25,
    active: Optional[Tensor] = None,
) -> tuple[Tensor, dict]:
    """Gather-based paged decode: per-slot positions, shared page pool,
    updated in place."""
    if cfg.has_ssm:
        raise ValueError(f"paged decode supports attention families only, not {cfg.family!r}")
    b, s = tokens.shape
    lens = cache["seq_lens"].long()
    bt = cache["block_tables"].long()
    positions = lens[:, None] + torch.arange(s, device=tokens.device)[None]
    x = params.embed[tokens].to(getattr(torch, cfg.dtype))
    rope = _rope(cfg, positions)
    for i, lp in enumerate(params.layers):
        view = PagedKVView(cache["k_pages"][i], cache["v_pages"][i], bt, lens, active)
        x, _ = _block(
            lp, x, cfg, ctx, rope=rope, attn_impl="dense", cache=(view, None), moe_impl=moe_impl, moe_cf=moe_cf
        )
    x = apply_norm(x, params.final_ln, cfg.norm_eps)
    logits = unembed(cfg, params, x, ctx)
    advanced = lens + s if active is None else torch.where(active, lens + s, lens)
    cache["seq_lens"] = advanced.to(cache["seq_lens"].dtype)
    return logits, cache
