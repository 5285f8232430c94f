"""Several devices: the device mesh and its sharding helpers
(parallel/mesh.py), and host-level work distribution over processes
(parallel/orchestrate.py)."""

from .mesh import (  # noqa: F401
    get_mesh,
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_leading_axis,
)
