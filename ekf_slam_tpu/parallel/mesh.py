"""Device-mesh helpers.

The reference has no parallelism of any kind (single-threaded MATLAB,
SURVEY.md §2); this layer is the scaling story: covariance row-tiles
sharded over a ``map`` axis, with an optional ``data`` axis for batched
independent sessions (multi-robot / multi-world).  The cards of one host
reach each other all to all, so the mesh takes the first n devices in
order and follows the algorithm alone.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_map: Optional[int] = None, n_data: int = 1,
              axis_names: Sequence[str] = ("data", "map")) -> Mesh:
    """Build a (data, map) mesh; defaults to all devices on the map axis."""
    devs = jax.devices()
    if n_map is None:
        n_map = len(devs) // n_data
    devs = np.asarray(devs[:n_map * n_data]).reshape(n_data, n_map)
    return Mesh(devs, axis_names)


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Covariance tiles: P rows over the map axis, columns replicated."""
    return NamedSharding(mesh, P("map", None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
