"""Checkpointing: atomic, async, restorable onto any device — the
reference's on-disk format.

* atomic   — write to ``<dir>/tmp.<step>`` then rename to ``step_<n>``
             (``arrays.npz`` plus ``meta.json``); ``keep`` bounds how many
             stay.
* async    — every tensor is copied to the host first, then a background
             thread writes the copy; the train loop never blocks on disk
             and never hands the thread a tensor the next step could touch.
* restore  — checkpoints store plain numpy arrays keyed by their path in
             the nested dict (keys joined by ``/``); ``load_checkpoint`` +
             ``restore_sharded`` rebuild a template's structure, dtypes and
             device (the reference restores onto a mesh; the port onto one
             device).

bfloat16 tensors are stored as float32 (npz has no bfloat16) and cast back
to the template's dtype on restore, as the reference does.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "latest_step",
    "restore_sharded",
    "AsyncCheckpointer",
]

_SEP = "/"


def _items(tree, prefix=()):
    """(path, leaf) of every leaf of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, prefix + (str(k),))
    else:
        yield _SEP.join(prefix), tree


def _host(leaf) -> np.ndarray:
    """A host copy of a tensor, sharing no memory with it; numpy arrays
    pass as they are."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {path: _host(leaf) for path, leaf in _items(tree)}


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3, extra: Optional[dict] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    meta = dict(step=step, time=time.time(), keys=sorted(flat), extra=extra or {})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    for s in sorted(_all_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"), ignore_errors=True)


def _all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
            out.append(int(m.group(1)))
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _all_steps(ckpt_dir)
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> tuple[int, dict[str, np.ndarray], dict]:
    """Returns (step, flat {path: np.ndarray}, meta)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with np.load(os.path.join(d, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    return step, flat, meta


def restore_sharded(template: Any, flat: dict[str, np.ndarray], device=None) -> Any:
    """Rebuild the ``template``-structured nested dict from flat arrays, each
    leaf in its template leaf's dtype, on ``device`` (default: the template
    leaf's device)."""

    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in node.items()}
        key = _SEP.join(prefix)
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = torch.from_numpy(np.array(flat[key]))
        if isinstance(node, torch.Tensor):
            return arr.to(device=device if device is not None else node.device, dtype=node.dtype)
        return arr

    return build(template, ())


class AsyncCheckpointer:
    """Fire-and-forget checkpoint writer (one in flight at a time)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> None:
        self.wait()
        host = _flatten(tree)  # every copy made before the thread starts

        def work():
            save_checkpoint(self.ckpt_dir, step, host, keep=self.keep, extra=extra)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
