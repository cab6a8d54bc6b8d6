"""Serve meshes: a grid of devices that one process drives.

A :class:`Mesh` names its axes, their sizes and one ``torch.device`` per
grid position in row-major order.  The engine shards the predicate arena
over the ``model`` axis and splits a query batch over every other axis
(``core.engine.make_sharded_serve_step``); a single Python process
launches every shard's work on its device, as the JAX package drives its
devices through ``shard_map``.

A mesh may name one device more than once: a (2, 4) mesh of ``cuda:0``
runs eight shards on one card, and one of ``cpu`` runs them on the host.
The shards of a repeated device are row views of one arena; the reduce
over the model axis is a copy to the lead device, a no-op on a repeated
device and a peer copy across cards.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# The axis the predicate arena is split over; every other axis splits the batch.
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Frozen, hashable device grid: ``devices[i]`` sits at the row-major
    position ``i`` of ``sizes`` (axis ``axis_names[k]`` of size
    ``sizes[k]``)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for {len(self.sizes)} sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis name in {self.axis_names}")
        if any(n < 1 for n in self.sizes):
            raise ValueError(f"mesh axis sizes must be >= 1, got {self.sizes}")
        if len(self.devices) != math.prod(self.sizes):
            raise ValueError(
                f"a {self.sizes} mesh needs {math.prod(self.sizes)} devices, "
                f"got {len(self.devices)}"
            )

    @property
    def shape(self) -> dict[str, int]:
        """``{axis name: size}``, in axis order."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def lead(self) -> torch.device:
        """The device at position 0: results of a sharded step land here."""
        return self.devices[0]

    def size(self, axes) -> int:
        """Product of the sizes of ``axes``."""
        shape = self.shape
        return math.prod(shape[a] for a in axes)

    def grid(self) -> tuple[tuple[int, ...], ...]:
        """Device positions by (data slice, model shard): row ``i`` lists,
        for data slice ``i`` (row-major over :func:`dp_axes`), the
        positions of model shards ``0 .. mp-1``."""
        shape = self.shape
        if MODEL_AXIS not in shape:
            raise ValueError(f"mesh axes {self.axis_names} lack {MODEL_AXIS!r}")
        data = dp_axes(self)
        strides = {}
        stride = 1
        for a, n in zip(reversed(self.axis_names), reversed(self.sizes)):
            strides[a] = stride
            stride *= n
        rows = []
        for i in range(self.size(data)):
            base, rest = 0, i
            for a in reversed(data):
                base += (rest % shape[a]) * strides[a]
                rest //= shape[a]
            rows.append(tuple(base + j * strides[MODEL_AXIS]
                              for j in range(shape[MODEL_AXIS])))
        return tuple(rows)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], devices=None) -> Mesh:
    """A :class:`Mesh` of ``shape`` over ``devices`` (row-major; repeats
    allowed).  The default is the visible CUDA cards, the first
    ``prod(shape)`` of them; too few raises."""
    from repro_torch.core.query import resolve_device

    n = math.prod(shape)
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < n:
            raise ValueError(
                f"a {tuple(shape)} mesh needs {n} CUDA cards, {visible} visible; "
                "pass devices= (a device may repeat) to build it on fewer"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(tuple(axes), tuple(int(s) for s in shape),
                tuple(resolve_device(d) for d in devices))


def dp_axes(mesh: Mesh) -> tuple[str, ...]:
    """Every mesh axis that is not 'model' (the data-parallel axes)."""
    return tuple(a for a in mesh.axis_names if a != MODEL_AXIS)


def serve_mesh_shape(n_devices: int, *, model_max: int = 4) -> tuple[int, int]:
    """Factor ``n_devices`` into a (data, model) serve-mesh shape that uses
    EVERY device: the model axis is the largest divisor of ``n_devices``
    not exceeding ``model_max``.  6 -> (2, 3), 8 -> (2, 4), 5 -> (5, 1);
    the product is always ``n_devices``."""
    if n_devices < 1:
        raise ValueError(f"need at least one device, got {n_devices}")
    mp = max(
        d for d in range(1, min(model_max, n_devices) + 1)
        if n_devices % d == 0
    )
    return n_devices // mp, mp
