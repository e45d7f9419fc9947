"""Tree walking for the analysis passes, without ``jax.tree_util``.

The port's trees are nested dicts, lists, tuples and dataclasses of tensors
(parameters, optimizer state, caches, an engine's slot state). The layer
stacks are unrolled: a parameter is ``layers.3.attn.wq`` where the
reference has one stacked leaf ``layers/attn/wq``. :func:`subject` maps a
path to the reference's name, the layer index dropped, so a pass reports
the L copies of a layer leaf as one subject, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

__all__ = ["flatten", "subject", "leaf_bytes", "is_struct"]


def flatten(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None,
            path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """Yield ``(path, leaf)`` over dicts (in key order), lists, tuples and
    dataclass instances; anything else, or what ``is_leaf`` accepts, is a
    leaf."""
    if is_leaf is not None and is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten(v, is_leaf, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, is_leaf, path + (str(i),))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from flatten(getattr(tree, f.name), is_leaf, path + (f.name,))
    else:
        yield path, tree


def subject(path: tuple) -> str:
    """A path as the reference names its leaf: parts joined by ``/``, the
    dotted names of the flat parameter dicts split, and the index after
    ``layers`` dropped (``("m", "layers.3.attn.wq")`` -> ``m/layers/attn/wq``)."""
    parts: list[str] = []
    for k in path:
        bits = str(k).split(".")
        for i, b in enumerate(bits):
            if i and b.isdigit() and bits[i - 1] == "layers":
                continue
            parts.append(b)
    return "/".join(parts) or "value"


def is_struct(x) -> bool:
    """A tensor, or anything with a shape and a dtype (a meta tensor)."""
    return hasattr(x, "shape") and hasattr(x, "dtype")


def leaf_bytes(x) -> int:
    n = 1
    for d in x.shape:
        n *= int(d)
    return n * x.dtype.itemsize
