"""Device mesh and sharding helpers.

Port of the JAX package's parallel/mesh.py. A `Mesh` is an array of torch
devices of shape (data, model) with JAX's axis names. Work items (image
pairs, track rows, training rows, BA observations) are padded to a
multiple of the "data" axis and split into contiguous blocks, one per
"data" row, each moved to that row's device: the blocks that JAX's
`NamedSharding(mesh, P("data"))` gives each device. Parameters and images
are replicated, one copy per distinct device. There are no compiler-made
collectives: each sharded caller launches its blocks' work on their
devices before it collects any, and reduces on the first device in block
order, so a sharded result does not depend on how the blocks were placed.

A mesh may repeat a device (`[cpu] * 4`, `[cuda:0, cuda:0]`): the CPU tests
and the one-card smoke run N shards that way. As in JAX, nothing is
partitioned over "model"; `model_axis > 1` is accepted and every device of
a "data" row but the first stays idle.

Device choice: `make_mesh()` takes every visible card, or, under an
initialised torch.distributed group, only this process's card
(`cuda:$LOCAL_RANK`, else `cuda:rank % device_count`), so that one process
per card never shards over another process's card. An entry point given
an explicit device (`device="cpu"`, `--device cuda:1`) runs on a one-entry
mesh of it (`mesh_of`); None or a bare "cuda" means the default mesh.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import os
from typing import List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices (an object array of torch.device, shape (data, model)) and
    the axis names ("data", "model")."""

    devices: np.ndarray
    axis_names: tuple = ("data", "model")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def data_devices(self) -> List[torch.device]:
        """The device of each "data" row (its first device)."""
        return list(self.devices[:, 0])

    @property
    def first(self) -> torch.device:
        """Where sharded callers reduce and keep their state."""
        return self.devices[0, 0]

    def key(self) -> tuple:
        """A hashable description (for caches keyed by mesh)."""
        return (tuple(str(d) for d in self.devices.ravel()),
                self.devices.shape)


def canonical_device(dev) -> torch.device:
    """torch.device with a CUDA index filled in (the current card)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _visible_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or a mesh of CPU "
            "devices) to run on the CPU")
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        local = os.environ.get("LOCAL_RANK")
        idx = (int(local) if local is not None
               else dist.get_rank() % torch.cuda.device_count())
        return [torch.device("cuda", idx)]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, model_axis: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ("data", "model") mesh over the first `n_devices` of `devices`
    (default: the visible cards, see the module docstring). `devices` may
    repeat a device."""
    devs = [canonical_device(d) for d in
            (_visible_devices() if devices is None else devices)]
    n = len(devs) if n_devices is None else int(n_devices)
    if n < 1 or n > len(devs):
        raise ValueError(f"make_mesh: {n} devices asked, {len(devs)} given")
    if n % model_axis:
        raise ValueError(f"make_mesh: {n} devices do not split into a "
                         f"model axis of {model_axis}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(n // model_axis, model_axis))


@functools.lru_cache(maxsize=None)
def get_mesh() -> Mesh:
    """The process's default mesh: make_mesh(), made once."""
    return make_mesh()


def mesh_of(device=None, mesh: Optional[Mesh] = None) -> Mesh:
    """The mesh an entry point runs on: `mesh` if given, else a one-entry
    mesh of an explicit `device`, else (None or a bare "cuda") the default
    mesh."""
    if mesh is not None:
        if device is not None:
            raise ValueError("pass a device or a mesh, not both")
        return mesh
    if device is None or str(device) == "cuda":
        return get_mesh()
    from ..device import resolve_device

    return make_mesh(devices=[resolve_device(device)])


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev, non_blocking=True)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev,
                                                        non_blocking=True)


def shard_leading_axis(tree, mesh: Mesh, axis_name: str = "data") -> list:
    """One tree per "data" row: each leaf's leading axis cut into
    contiguous equal blocks, block i on row i's device (tensors or numpy
    arrays in, tensors out). The leading dim must divide evenly (pad
    with pad_to_multiple beforehand), as JAX requires."""
    if axis_name != "data":
        raise ValueError(f"work shards over 'data' only, not {axis_name!r}")
    devs = mesh.data_devices
    n = len(devs)

    def block(i):
        def cut(x):
            rows = x.shape[0]
            if rows % n:
                raise ValueError(f"leading dim {rows} does not split over "
                                 f"{n} devices")
            b = rows // n
            return _to(x[i * b:(i + 1) * b], devs[i])
        return cut

    return [_tree_map(block(i), tree) for i in range(n)]


def replicate(tree, mesh: Mesh) -> list:
    """One tree per "data" row with every leaf on that row's device: one
    copy per distinct device, the same object where rows share a device
    (a leaf already on it is not copied)."""
    copies = {}
    out = []
    for dev in mesh.data_devices:
        if dev not in copies:
            copies[dev] = _tree_map(lambda x: _to(x, dev), tree)
        out.append(copies[dev])
    return out


def replicate_module(module: torch.nn.Module, mesh: Mesh) -> list:
    """`module` (on the mesh's first device), and a deep copy of it on each
    other distinct device: one entry per "data" row, the same object where
    rows share a device."""
    copies = {mesh.first: module}
    out = []
    for dev in mesh.data_devices:
        if dev not in copies:
            copies[dev] = copy.deepcopy(module).to(dev)
        out.append(copies[dev])
    return out
