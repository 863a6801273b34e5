"""Grid-mesh triangulation with edge-length validity (device + host).

Equivalent of the reference ``CheckTriangularValidity``/``WriteMesh``
(``src/Reconstruction/reconstruction.cpp:46-149``): two triangles per grid
cell — upper-left (v, v+W, v+1) and lower-right (v+W, v+W+1, v+1) — kept
only if all three vertices are valid and every edge is shorter than the
threshold. The validity masks are computed as vectorized device ops; the
index-list assembly and OFF serialization are host-side (file I/O).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from stereo_reconstruction.io.mesh_io import write_off
from stereo_reconstruction.recon.backproject import VertexGrid


@jax.jit
def triangle_validity(
    positions: jnp.ndarray,      # (H, W, 3), NaN = invalid vertex
    edge_threshold: float = 1.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(H-1, W-1) masks for the upper-left and lower-right triangles."""
    p = positions
    v00 = p[:-1, :-1]
    v10 = p[1:, :-1]    # (h+1, w)
    v01 = p[:-1, 1:]    # (h, w+1)
    v11 = p[1:, 1:]

    def edge_ok(a, b):
        d = jnp.linalg.norm(a - b, axis=-1)
        return jnp.isfinite(d) & (d <= edge_threshold)

    def vert_ok(v):
        return jnp.isfinite(v).all(axis=-1)

    upper = (
        vert_ok(v00) & vert_ok(v10) & vert_ok(v01)
        & edge_ok(v00, v10) & edge_ok(v00, v01) & edge_ok(v10, v01)
    )
    lower = (
        vert_ok(v10) & vert_ok(v11) & vert_ok(v01)
        & edge_ok(v10, v11) & edge_ok(v10, v01) & edge_ok(v11, v01)
    )
    return upper, lower


def grid_mesh(grid: VertexGrid, edge_threshold: float = 1.0):
    """Host assembly: (N, 3) positions, (N, 4) colors, (M, 3) triangles."""
    pos = np.asarray(grid.positions)
    col = np.asarray(grid.colors)
    h, w = pos.shape[:2]
    upper, lower = triangle_validity(grid.positions, edge_threshold)
    upper = np.asarray(upper)
    lower = np.asarray(lower)

    idx = np.arange(h * w).reshape(h, w)
    v00 = idx[:-1, :-1]
    v10 = idx[1:, :-1]
    v01 = idx[:-1, 1:]
    v11 = idx[1:, 1:]

    # reference winding (reconstruction.cpp:97-110)
    tri_upper = np.stack([v00[upper], v10[upper], v01[upper]], axis=1)
    tri_lower = np.stack([v10[lower], v11[lower], v01[lower]], axis=1)

    # interleave per-cell in row-major order like the reference writer
    triangles = np.concatenate([tri_upper, tri_lower])
    order = np.argsort(
        np.concatenate([v00[upper] * 2, v00[lower] * 2 + 1]), kind="stable"
    )
    triangles = triangles[order]

    return pos.reshape(-1, 3), col.reshape(-1, 4), triangles


def save_mesh(path: str, grid: VertexGrid, edge_threshold: float = 1.0) -> int:
    """Write the COFF mesh (reference writes
    results/reconstruction_mesh.off). Returns the face count."""
    pos, col, tri = grid_mesh(grid, edge_threshold)
    write_off(path, pos, col, tri)
    return len(tri)
