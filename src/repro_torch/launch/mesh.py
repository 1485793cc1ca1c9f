"""Meshes (counterpart of the JAX package's ``launch/mesh.py``).

Single pod: 16 x 16 = 256 chips, axes (data, model).  Multi pod: 2 x 16 x
16 = 512 chips, axes (pod, data, model); the pod axis is the outer data
parallel axis.  The card: one H100, axes (data, model) of size 1.

PyTorch has nothing like the reference's 512 fake CPU devices, and the port
has no partitioner, so the dry run's meshes are abstract: a shape and axis
names, no devices and no ``torch.distributed`` process group.  The sharding
rules (``launch/sharding.py``) read only ``axis_names`` and ``shape``, as
the reference's do.  A mesh that claims real devices (``devices=``) raises
when there are fewer than it needs, as the reference's does.

Functions, not module constants: importing this module touches no device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``dims`` sizes over ``axis_names``; ``devices`` the devices it spans,
    row-major over the axes, or empty for an abstract mesh."""

    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[str, ...] = ()

    def __post_init__(self):
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"mesh {self.dims} has axes {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (the reference's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def _claim(shape, axes, devices: Sequence[str] | None) -> Mesh:
    n = math.prod(shape)
    if devices is None:
        return Mesh(tuple(shape), tuple(axes))
    if len(devices) < n:
        raise RuntimeError(f"mesh {tuple(shape)} needs {n} devices, have {len(devices)}")
    return Mesh(tuple(shape), tuple(axes), tuple(str(d) for d in devices[:n]))


def make_production_mesh(*, multi_pod: bool = False, devices: Sequence[str] | None = None
                         ) -> Mesh:
    """The reference's production mesh: (16, 16) over (data, model), or
    with ``multi_pod`` (2, 16, 16) over (pod, data, model).  Abstract unless
    ``devices`` are given."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _claim(shape, axes, devices)


def make_card_mesh() -> Mesh:
    """One H100: (1, 1) over (data, model), abstract (the dry run's ``card``
    mesh; nothing is sharded)."""
    return Mesh((1, 1), ("data", "model"))


def make_host_mesh(shape: Tuple[int, ...] = (1, 1), axes=("data", "model"),
                   devices: Sequence[str] = ("cpu",)) -> Mesh:
    """A small mesh over ``devices`` (one CPU by default), for tests; raises
    when they are fewer than the shape needs."""
    return _claim(shape, axes, devices)


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes that act as data parallel (pod joins data when present)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
