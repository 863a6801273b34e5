"""Device mesh construction.

All distribution in the framework is expressed as shardings over one
``jax.sharding.Mesh`` with two axes:

  * ``data`` — batch of stereo pairs (data parallelism; the reference's
    per-scene loop, data_loader.cpp:32-46, run concurrently);
  * ``tile`` — cost-volume row tiles (the spatial/context-parallel axis;
    shards the BlockSearch hot loop's H dimension with ppermute halo
    exchange).

The reference has zero parallelism (SURVEY.md §2); this layer is the
scaling design mandated by BASELINE configs 4-5.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    data: int = 1,
    tile: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if tile is None:
        tile = n // data
    if data * tile != n:
        raise ValueError(f"data*tile = {data}*{tile} != {n} devices")
    arr = np.array(devices).reshape(data, tile)
    return Mesh(arr, axis_names=("data", "tile"))
