"""Device meshes for the fleet engines.

A :class:`Mesh` is a named grid of ``torch.device``s, the port's
counterpart of ``jax.sharding.Mesh``: ``devices`` is a numpy object array,
``axis_names`` names its axes, and ``shape`` maps each name to its extent in
that order. Two families live here:

* :func:`make_production_mesh` / :func:`make_host_mesh`: the
  ``("data", "model")`` meshes (optionally ``("pod", ...)``) that
  :mod:`repro_torch.launch.sharding` resolves logical axes onto; the
  production mesh is the reference's pod layout over the meta device, for
  the dry run's per-device accounting (``launch/dryrun_lib.py``).
* :func:`make_fleet_mesh` / :func:`make_pop_mesh`: the fleet meshes of
  :mod:`repro_torch.fleet.sharding`. A leading ``"pop"`` axis splits the
  chips being retrained into one sub-population per pop slice, and the
  trailing ``"model"`` axis, when > 1, gives each pop slice a sub-mesh over
  which its members' state is stored split instead of replicated.
  ``make_pop_mesh`` is the ``model=1`` case, kept 1-D.

The devices default to every visible card; without a card the functions
raise, as :func:`repro_torch.device.resolve_device` does. The CPU is used
only when named. A device may repeat in an explicit list (``["cpu"] * 8``,
``["cuda"] * 4``): a mesh over one device repeated has the layout and the
accounting of a larger one, without its memory.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["Mesh", "make_fleet_mesh", "make_host_mesh", "make_pop_mesh", "make_production_mesh"]


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device``, one axis per name
    in ``axis_names``; ``devices.flat`` runs in row-major order, as JAX's."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of {self.devices.ndim} axes named {self.axis_names!r}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _device_list(devices: Optional[Sequence]) -> list[torch.device]:
    if devices is not None:
        return [torch.device(d) for d in devices]
    resolve_device(None)  # raises without a card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _grid(devs: list[torch.device], shape: tuple[int, ...]) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return arr.reshape(shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes: 16 x 16 ``("data", "model")``
    (one pod, 256 chips) or 2 x 16 x 16 ``("pod", "data", "model")`` (two
    pods, 512 chips), over the meta device repeated. Nothing runs on them:
    they carry the layout the dry run resolves and accounts per device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(_grid([torch.device("meta")] * int(np.prod(shape)), shape), axes)


def make_host_mesh(data: int = 1, model: int = 1, *, devices: Optional[Sequence] = None) -> Mesh:
    """Small ``("data", "model")`` mesh over whatever devices exist
    (tests / CPU examples), clamped to fit them."""
    devs = _device_list(devices)
    n = len(devs)
    data = min(data, n)
    model = max(1, min(model, n // data))
    return Mesh(_grid(devs[: data * model], (data, model)), ("data", "model"))


def _fleet_device_grid(pop: Optional[int], model: int, devices: Optional[Sequence]) -> np.ndarray:
    """Validated (pop, model) device grid for the fleet meshes.

    ``pop=None`` auto-sizes: the largest population extent such that
    ``pop * model`` fits the devices (the count is *clamped* down to the
    nearest clean tiling instead of failing the reshape). Explicit extents
    that don't fit raise a ValueError naming the numbers."""
    devs = _device_list(devices)
    n = len(devs)
    try:
        model = int(model)
    except (TypeError, ValueError):
        raise ValueError(f"model extent must be an integer, got {model!r}") from None
    if model < 1:
        raise ValueError(f"model extent must be >= 1, got {model}")
    if model > n:
        raise ValueError(
            f"model extent {model} exceeds the {n} visible device(s); "
            "pass devices= (a device may repeat) to build a larger mesh"
        )
    if pop is None:
        pop = n // model  # clamp: largest population extent that tiles
    try:
        pop = int(pop)
    except (TypeError, ValueError):
        raise ValueError(f"pop extent must be an integer, got {pop!r}") from None
    if pop < 1:
        raise ValueError(f"pop extent must be >= 1, got {pop}")
    need = pop * model
    if need > n:
        raise ValueError(
            f"fleet mesh {pop}x{model} needs {need} devices, have {n}; "
            "shrink the mesh or pass more devices= (a device may repeat)"
        )
    return _grid(devs[:need], (pop, model))


def make_fleet_mesh(
    pop: Optional[int] = None,
    model: int = 1,
    *,
    axis_names: tuple[str, str] = ("pop", "model"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """2-D ``("pop", "model")`` mesh: ``pop`` slices of ``model`` devices.

    ``pop=None`` takes as many pop slices as tile the devices for the given
    ``model`` extent (clamping, not failing, when the count doesn't divide
    cleanly)."""
    if len(axis_names) != 2:
        raise ValueError(f"fleet mesh needs exactly 2 axis names, got {axis_names!r}")
    return Mesh(_fleet_device_grid(pop, model, devices), tuple(axis_names))


def make_pop_mesh(num_devices: Optional[int] = None, axis: str = "pop", *,
                  devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the population axis, the ``model=1`` case of
    :func:`make_fleet_mesh`: one slice per device, each training a
    sub-population of fault maps. Defaults to every visible card; the
    validation is shared with ``make_fleet_mesh``."""
    return Mesh(_fleet_device_grid(num_devices, 1, devices).reshape(-1), (axis,))
