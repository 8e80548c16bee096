"""Device mesh construction and axis conventions.

The reference is single-process/single-GPU; its only device channel is the
host->GPU SSBO upload (voxel_allocator.hpp:38-78). The multi-device story here
is built on jax.sharding over the cards of one host:

  axis "data"  — rays/pixels/views sharded (the renderer analog of DP); voxel
                 parameter gradients are psum'ed over it.
  axis "space" — the voxel grid spatially sharded along x (the analog of
                 TP/SP for the scene); rays cross shard boundaries via
                 collective exchange (parallel/spatial.py).

The same code runs on the GPUs of one host (joined all to all, so the mesh
shape follows the algorithm alone) or on a CPU-virtual-device test mesh
(xla_force_host_platform_device_count).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
SPACE_AXIS = "space"


def make_mesh(
    n_data: Optional[int] = None, n_space: int = 1, devices=None
) -> Mesh:
    """Mesh of shape (data, space). Defaults to all devices on the data axis."""
    devices = devices if devices is not None else jax.devices()
    if n_data is None:
        n_data = len(devices) // n_space
    assert n_data * n_space <= len(devices), (n_data, n_space, len(devices))
    dev = np.asarray(devices[: n_data * n_space]).reshape(n_data, n_space)
    return Mesh(dev, (DATA_AXIS, SPACE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def rays_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (ray/pixel/view) axis over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def space_sharding(mesh: Mesh, rank: int = 3) -> NamedSharding:
    """Shard a voxel field's x axis over the space axis."""
    return NamedSharding(mesh, P(SPACE_AXIS, *([None] * (rank - 1))))
