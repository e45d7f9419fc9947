"""Flash attention: the CUDA kernels' wrapper, its plain PyTorch version and
its launch counts.

Kernels: ``kernels/csrc/flash_attention.cu``. They replace the TPU kernel
``repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas``.

Bound on an H100: at prefill lengths the QK^T and PV products bound it by
operations. Both kernels keep scores and softmax statistics on chip, skip
kv tiles that the causal and window masks exclude, and read each kv head
once for its whole query group. The dtype picks the kernel:

- ``mma`` (bfloat16): FlashAttention-3's forward shape. A producer warpgroup
  loads Q and a two-stage ring of K and V tiles by TMA (``mbarrier``s, no
  copy by any consumer thread); each consumer warpgroup owns 64 query rows
  and runs S = QK^T and O += PV on ``wgmma``, P fed from registers. It
  needs q, k and v 16-byte aligned with strides that are multiples of 8
  elements (the model's (B, S, H, D) projections are) and no broadcast
  (zero-stride) dim; the wrapper raises otherwise;
- ``v1`` (float32): FlashAttention-2's shape in fp32 on the SIMT cores,
  since tensor cores would round fp32 to tf32: S = QK^T and O += PV as
  register-tiled outer products over shared-memory tiles, K and V through
  a two-stage ``cp.async`` ring, one ``expf`` per score. It takes any
  stride (plain loads where a tensor is not 16-byte aligned).
  ``variant="v1"`` also forces it for bf16, to time it beside the mma
  kernel; the serving paths never ask for it.

Tiles: each kernel is built at its own ``(bq, bkv)`` instances,
``TILES[variant]`` (``tiles_built`` says which for a variant, dtype and
head dim: v1 only where its shared memory fits, and in bf16 only at its
default). The tile comes from the caller, else the tuning cache
(``kernels.common.tuned_block``, kernel ``flash_attention``, the
reference's key ``(b, hq, hkv, sq, skv, d, causal)``; read for the variant
the dtype picks, not for a forced v1), else ``DEFAULT_TILE[variant]``. A
tile that is not built, or whose shared memory (``smem_bytes``, which the
geometry lint reads too) exceeds the card's, raises before any launch.
``flash_attention.last_blocks`` is the last launch's tile.

``flash_attention`` takes the ``(B, H, S, D)`` layout. For a CUDA tensor it
launches a kernel and counts the launch in ``flash_attention.launches`` and
``flash_attention.launches_by_variant``; for a CPU tensor it runs
``attention_ref``, the plain version. There is no fallback between the two.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.common import SMEM_LIMIT_BYTES, check_launch, load_kernel, tuned_block

__all__ = [
    "flash_attention",
    "attention_ref",
    "HEAD_DIMS",
    "TILES",
    "DEFAULT_TILE",
    "pick_variant",
    "tiles_built",
    "smem_bytes",
    "threads",
    "resolve_tile",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 80, 96, 128)  # the head dims both kernels are built for
VARIANTS = {"v1": 1, "mma": 2}  # the C entry point's variant codes
# the (bq, bkv) instances csrc/flash_attention.cu builds for each variant (its header says why
# these); the first is the heuristic
TILES = {
    "mma": ((128, 128), (128, 64), (64, 128), (64, 64)),
    "v1": ((64, 64), (128, 64), (64, 32), (64, 128)),
}
DEFAULT_TILE = {kind: tiles[0] for kind, tiles in TILES.items()}
_ARGTYPES = (
    [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 12
    + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
)


def pick_variant(dtype: torch.dtype, variant: str = "auto") -> str:
    """The kernel a launch runs: ``mma`` for bf16, ``v1`` for float32 or
    where ``variant="v1"`` forces it."""
    if variant not in ("auto", "v1"):
        raise ValueError(f"variant is 'auto' or 'v1', got {variant!r}")
    return "mma" if variant == "auto" and dtype == torch.bfloat16 else "v1"


def smem_bytes(kind: str, bq: int, bkv: int, d: int) -> int:
    """Dynamic shared memory one block of ``kind`` requests at tile (bq,
    bkv) and head dim d: mma's Q tile and two-stage K and V rings, each row
    ceil(d / 64) boxes of 128 bytes, plus 1 KiB to align them; v1's fp32 Q,
    rings and P, rows padded by 4 (``FlashShape::SMEM`` and
    ``v1::smem_bytes`` in the C source)."""
    if kind == "mma":
        return 1024 + (bq + 4 * bkv) * 128 * -(-d // 64)
    return 4 * ((bq + 4 * bkv) * (d + 4) + bq * (bkv + 4))


def threads(kind: str, bq: int) -> int:
    """Threads of one block: mma a consumer warpgroup for every 64 query
    rows and the producer warpgroup (``FlashShape::THREADS``), v1 256."""
    return 128 * (max(bq, 0) // 64 + 1) if kind == "mma" else 256


def tiles_built(kind: str, dtype: torch.dtype, d: int) -> tuple:
    """The tiles the C source builds for a variant, dtype and head dim: mma
    all of ``TILES["mma"]``; v1 in float32 those of ``TILES["v1"]`` whose
    shared memory fits the card, in bf16 (a timing variant) its default
    alone."""
    if kind == "mma":
        return TILES["mma"]
    if dtype != torch.float32:
        return (DEFAULT_TILE["v1"],)
    return tuple(t for t in TILES["v1"] if smem_bytes("v1", *t, d) <= SMEM_LIMIT_BYTES)


def resolve_tile(
    b: int, hq: int, hkv: int, sq: int, skv: int, d: int, causal: bool, dtype: torch.dtype, device, *,
    bq: Optional[int] = None, bkv: Optional[int] = None, variant: str = "auto",
) -> tuple[int, int]:
    """The tile the wrapper launches for this call: the caller's, else the
    tuning cache's (for the variant the dtype picks), else that variant's
    ``DEFAULT_TILE``."""
    kind = pick_variant(dtype, variant)
    dq, dkv = DEFAULT_TILE[kind]
    if variant != "auto":
        return (dq if bq is None else int(bq), dkv if bkv is None else int(bkv))
    got = tuned_block(
        "flash_attention", dict(b=b, hq=hq, hkv=hkv, sq=sq, skv=skv, d=d, causal=int(causal)), dtype,
        device=device, defaults=dict(bq=dq, bkv=dkv), overrides=dict(bq=bq, bkv=bkv),
    )
    return got["bq"], got["bkv"]


def _strides(t: torch.Tensor) -> list[int]:
    """Batch, head and sequence strides, 0 along a dim of size 1 (never
    stepped, so its stride does not bind the alignment)."""
    return [st if size > 1 else 0 for size, st in zip(t.shape[:3], t.stride()[:3])]


def attention_ref(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version: full-materialization attention in fp32. ``q_offset`` is
    the absolute position of q[0]. A row that keeps no key returns 0, as the
    kernel's zero-mass rule says."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    group = hq // hkv
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    rows = torch.arange(sq, device=q.device)[:, None] + q_offset
    cols = torch.arange(skv, device=q.device)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        keep &= cols <= rows
    if window is not None:
        keep &= cols > rows - window
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vr) / torch.where(denom == 0, 1.0, denom)
    return o.to(q.dtype)


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
    variant: str = "auto",
    bq: Optional[int] = None,
    bkv: Optional[int] = None,
) -> torch.Tensor:
    """Blocked online-softmax attention (causal / sliding window / GQA).

    On CUDA: q, k and v share a dtype (float32 or bfloat16) and a unit
    stride on the head dim, D is one of ``HEAD_DIMS``; in bfloat16 they are 16-byte aligned
    with strides that are multiples of 8 elements. The output is a
    (B, Hq, Sq, D) view of a (B, Sq, Hq, D) buffer, so the caller's merge of
    the heads is free. ``variant="v1"`` forces the float32 kernel. ``bq``
    and ``bkv`` force the tile (``resolve_tile``)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, got {q.device}")
    b, hq, sq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    hkv, skv = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"query heads {hq} are not a multiple of kv heads {hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernels are built for head_dim in {HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v alike, got {q.dtype}")
    if not (q.stride(3) == k.stride(3) == v.stride(3) == 1):
        raise ValueError("q, k and v need a unit stride on the head dim")
    if k.device != q.device or v.device != q.device or q.device.index != torch.cuda.current_device():
        raise ValueError("q, k and v must lie on the current CUDA device")
    kind = pick_variant(q.dtype, variant)
    tile = resolve_tile(b, hq, hkv, sq, skv, d, causal, q.dtype, q.device, bq=bq, bkv=bkv, variant=variant)
    if tile not in tiles_built(kind, q.dtype, d):
        raise ValueError(f"flash {kind} in {q.dtype} at D = {d} is built for tiles "
                         f"{tiles_built(kind, q.dtype, d)}, not {tile}")
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = [_strides(t) for t in (q, k, v, o)]
    if kind == "mma":
        for name, t, st in zip("qkv", (q, k, v), strides):
            if t.data_ptr() % 16 or any(x % 8 for x in st):
                raise ValueError(
                    f"the bf16 flash kernel needs {name} 16-byte aligned with strides that are "
                    f"multiples of 8 elements, got offset {t.data_ptr() % 16} and strides {t.stride()}"
                )
            if any(x == 0 and size > 1 for x, size in zip(st, t.shape[:3])):
                raise ValueError(f"the bf16 flash kernel's TMA cannot step a broadcast dim of {name}: "
                                 f"shape {tuple(t.shape)}, strides {t.stride()}")
    if b and hq and sq:
        fn = load_kernel("flash_attention", _ARGTYPES)
        err = fn(
            VARIANTS[kind], _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, hq, hkv, sq, skv, d, *tile,
            *strides[0], *strides[1], *strides[2], *strides[3],
            scale if scale is not None else 1.0 / math.sqrt(d),
            int(causal), int(window or 0), int(q_offset),
            torch.cuda.current_stream().cuda_stream,
        )
        check_launch("flash_attention", err)
        flash_attention.launches += 1
        flash_attention.launches_by_variant[kind] += 1
        flash_attention.last_blocks = dict(bq=tile[0], bkv=tile[1])
    return o


flash_attention.launches = 0
flash_attention.last_blocks = None
flash_attention.launches_by_variant = dict.fromkeys(VARIANTS, 0)
