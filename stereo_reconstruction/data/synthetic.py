"""Seeded synthetic stereo scenes with exact ground truth.

A textured, piecewise-planar scene (a background plane plus slanted
rectangular patches in front of it) seen by two pinhole cameras. The right
camera sits one baseline to the right of the left one, with a small pitch
and a small vertical offset, so the pair is *not* rectified: pose
estimation, Loop-Zhang rectification and the warps all do real work before
the matcher sees rows that correspond.

Everything is rendered here in NumPy by ray casting, independently of the
package's warps, so a pipeline run is scored against the scene itself and
not against its own code:

  * images: 2x2 supersampled multi-octave value noise evaluated in each
    plane's own coordinates (the texture moves with the surface), uint8;
  * ``disp_right_gt``: for every right pixel, ``x_left - x_right`` of the
    scene point it sees (the Right-variant convention: the left match of
    right pixel x is x + d), +inf where unknown;
  * ``mask_right_nocc``: 255 where that point is also visible in the left
    image and the disparity lies inside ``[0, max_disparity)``;
  * the true relative pose ``X_right = R @ X_left + t``.

The pitch is kept small enough that points at infinity move < 1 px
horizontally, so the rectified disparity the pipeline produces matches
this original-frame ground truth to well under the 2 px bad-pixel
threshold.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from stereo_reconstruction.data.records import StereoPair

# texture octaves: lattice cell size in pixels at the plane's depth, weight
_OCTAVES = ((3.0, 0.20), (6.0, 0.30), (12.0, 0.25), (24.0, 0.15), (48.0, 0.10))


@dataclasses.dataclass(frozen=True)
class SyntheticScene:
    """A rendered pair plus the truth it was rendered from."""

    pair: StereoPair
    rotation: np.ndarray      # (3, 3) X_right = rotation @ X_left + translation
    translation: np.ndarray   # (3,)
    baseline: float


@dataclasses.dataclass(frozen=True)
class _Plane:
    origin: np.ndarray        # (3,) a point on the plane (left-camera frame)
    normal: np.ndarray        # (3,) unit
    u: np.ndarray             # (3,) in-plane unit axes
    v: np.ndarray
    half: tuple               # (a, b) half extents along u, v; inf = unbounded
    cell: float               # world size of one texture pixel
    color: np.ndarray         # (3,) per-channel gain
    seed: int


def _rotation_x(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def _scene_planes(rng, f: float, width: int, height: int,
                  z_near: float, z_far: float) -> List[_Plane]:
    """Background plane plus a handful of slanted patches in front of it."""
    planes = [_Plane(
        origin=np.array([0.0, 0.0, z_far]), normal=np.array([0.0, 0.0, 1.0]),
        u=np.array([1.0, 0.0, 0.0]), v=np.array([0.0, 1.0, 0.0]),
        half=(np.inf, np.inf), cell=z_far / f,
        color=rng.uniform(0.7, 1.0, 3), seed=int(rng.integers(1 << 30)))]
    for _ in range(int(rng.integers(5, 8))):
        z = rng.uniform(z_near, 0.6 * z_far)
        # patch centre somewhere in the left view, size 10-30 % of the width
        px = rng.uniform(0.1, 0.9) * width
        py = rng.uniform(0.1, 0.9) * height
        center = np.array([(px - width / 2) * z / f, (py - height / 2) * z / f, z])
        tilt = rng.uniform(-0.35, 0.35, 2)                 # up to ~20 degrees
        normal = np.array([tilt[0], tilt[1], 1.0])
        normal /= np.linalg.norm(normal)
        u = np.cross([0.0, 1.0, 0.0], normal)
        u /= np.linalg.norm(u)
        v = np.cross(normal, u)
        half = tuple(rng.uniform(0.05, 0.15, 2) * width * z / f)
        planes.append(_Plane(origin=center, normal=normal, u=u, v=v, half=half,
                             cell=z / f, color=rng.uniform(0.6, 1.0, 3),
                             seed=int(rng.integers(1 << 30))))
    return planes


def _cast(planes, center, dirs):
    """Nearest plane hit along each ray: (plane id, ray parameter, s, q)."""
    n = dirs.shape[0]
    best_t = np.full(n, np.inf)
    best_id = np.full(n, -1, np.int32)
    best_s = np.zeros(n)
    best_q = np.zeros(n)
    for k, p in enumerate(planes):
        denom = dirs @ p.normal
        with np.errstate(divide="ignore", invalid="ignore"):
            t = ((p.origin - center) @ p.normal) / denom
        hit = center[None, :] + t[:, None] * dirs
        rel = hit - p.origin
        s, q = rel @ p.u, rel @ p.v
        ok = (t > 0) & (np.abs(s) <= p.half[0]) & (np.abs(q) <= p.half[1])
        take = ok & (t < best_t)
        best_t = np.where(take, t, best_t)
        best_id = np.where(take, k, best_id)
        best_s = np.where(take, s, best_s)
        best_q = np.where(take, q, best_q)
    return best_id, best_t, best_s, best_q


def _value_noise(x, y, seed: int) -> np.ndarray:
    """Smooth lattice noise in [0, 1] at continuous lattice coords (x, y)."""
    r = np.random.default_rng(seed)
    perm = r.permutation(256)
    vals = r.random(256)
    xi, yi = np.floor(x), np.floor(y)
    fx, fy = x - xi, y - yi
    xi = xi.astype(np.int64)
    yi = yi.astype(np.int64)
    sx = fx * fx * (3 - 2 * fx)
    sy = fy * fy * (3 - 2 * fy)

    def lat(i, j):
        return vals[perm[(perm[i & 255] + j) & 255]]

    top = lat(xi, yi) * (1 - sx) + lat(xi + 1, yi) * sx
    bot = lat(xi, yi + 1) * (1 - sx) + lat(xi + 1, yi + 1) * sx
    return top * (1 - sy) + bot * sy


def _shade(planes, ids, s, q) -> np.ndarray:
    """RGB in [16, 240] for every hit (ids >= 0 everywhere by construction)."""
    out = np.zeros(ids.shape + (3,))
    for k, p in enumerate(planes):
        sel = ids == k
        if not np.any(sel):
            continue
        tone = np.zeros(int(sel.sum()))
        for o, (px, w) in enumerate(_OCTAVES):
            cell = px * p.cell
            tone += w * _value_noise(s[sel] / cell, q[sel] / cell, p.seed + o)
        tone = np.clip((tone - 0.5) * 2.2 + 0.5, 0.0, 1.0)
        out[sel] = 16.0 + 224.0 * tone[:, None] * p.color[None, :]
    return out


def _pixel_rays(K, height, width, offsets):
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    rays = []
    Kinv = np.linalg.inv(K)
    for ox, oy in offsets:
        pix = np.stack([xs + ox, ys + oy, np.ones_like(xs)], -1).reshape(-1, 3)
        rays.append(pix @ Kinv.T)
    return rays


def _render(planes, K, height, width, R_cam, center) -> np.ndarray:
    """uint8 image of the camera with world->camera rotation R_cam."""
    acc = np.zeros((height * width, 3))
    offsets = ((-0.25, -0.25), (0.25, -0.25), (-0.25, 0.25), (0.25, 0.25))
    for d in _pixel_rays(K, height, width, offsets):
        dirs = d @ R_cam                                   # camera -> world
        ids, _, s, q = _cast(planes, center, dirs)
        acc += _shade(planes, ids, s, q)
    img = np.rint(acc / len(offsets)).reshape(height, width, 3)
    return np.clip(img, 16, 240).astype(np.uint8)


def make_scene(seed: int, height: int = 750, width: int = 900,
               max_disparity: int = 200,
               rectified: bool = False) -> SyntheticScene:
    """Render one seeded pair at (height, width); true disparities span
    roughly 15-85 % of ``max_disparity``. ``rectified=True`` drops the
    pitch and the vertical offset: rows then correspond exactly, which is
    what the matcher alone expects."""
    rng = np.random.default_rng(seed)
    f = 1.1 * width
    K = np.array([[f, 0.0, (width - 1) / 2], [0.0, f, (height - 1) / 2],
                  [0.0, 0.0, 1.0]])
    baseline = 1.0
    z_near = f * baseline / (0.85 * max_disparity)
    z_far = f * baseline / (0.15 * max_disparity)
    planes = _scene_planes(rng, f, width, height, z_near, z_far)

    # right camera: pitch of 0.15-0.3 degrees and a small vertical offset
    pitch = np.deg2rad(rng.uniform(0.15, 0.3)) * rng.choice([-1.0, 1.0])
    t_y = rng.uniform(-0.03, 0.03) * baseline
    if rectified:
        pitch, t_y = 0.0, 0.0
    R = _rotation_x(pitch)
    t = np.array([-baseline, t_y, 0.0])
    center_r = -R.T @ t                        # right camera centre (left frame)

    left = _render(planes, K, height, width, np.eye(3), np.zeros(3))
    right = _render(planes, K, height, width, R, center_r)

    # ground truth at right pixel centres
    (d_r,) = _pixel_rays(K, height, width, ((0.0, 0.0),))
    ids_r, t_r, _, _ = _cast(planes, center_r, d_r @ R)
    X = center_r[None, :] + t_r[:, None] * (d_r @ R)      # left frame
    xl = X @ K.T
    xl = xl[:, :2] / xl[:, 2:3]
    xs_r = np.tile(np.arange(width, dtype=np.float64), height)
    disp = xl[:, 0] - xs_r

    # visible in the left view: the left ray through the (rounded) match
    # hits the same plane at the same depth
    col = np.rint(xl[:, 0]).astype(np.int64)
    row = np.rint(xl[:, 1]).astype(np.int64)
    inside = (col >= 0) & (col < width) & (row >= 0) & (row < height)
    (d_l,) = _pixel_rays(K, height, width, ((0.0, 0.0),))
    ids_l, t_l, _, _ = _cast(planes, np.zeros(3), d_l)
    flat = np.clip(row, 0, height - 1) * width + np.clip(col, 0, width - 1)
    depth_l = t_l[flat] * d_l[flat, 2]
    visible = inside & (ids_l[flat] == ids_r) & (np.abs(depth_l - X[:, 2])
                                                 < 0.01 * X[:, 2])
    in_range = (disp >= 0) & (disp < max_disparity)
    gt = np.where(inside & in_range, disp, np.inf).astype(np.float32)
    mask = np.where(visible & in_range, 255, 0).astype(np.uint8)

    K32 = K.astype(np.float32)
    pair = StereoPair(
        image_left=left, image_right=right,
        intrinsics_left=K32, intrinsics_right=K32,
        disp_right_gt=gt.reshape(height, width),
        mask_right_nocc=mask.reshape(height, width),
        name=f"synthetic_{seed}", ndisp=int(max_disparity))
    return SyntheticScene(pair=pair, rotation=R, translation=t,
                          baseline=baseline)


def pose_errors_deg(pose: np.ndarray, rotation: np.ndarray,
                    translation: np.ndarray):
    """(rotation error, translation-direction error) in degrees between an
    estimated (4, 4) pose and the truth."""
    pose = np.asarray(pose, np.float64)
    dR = pose[:3, :3] @ rotation.T
    # angle of dR from its sine and cosine: accurate for tiny angles too
    sin2 = np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                           dR[1, 0] - dR[0, 1]])
    rot = np.degrees(np.arctan2(sin2, np.trace(dR) - 1))
    te = pose[:3, 3] / np.linalg.norm(pose[:3, 3])
    tt = translation / np.linalg.norm(translation)
    trans = np.degrees(np.arccos(np.clip(te @ tt, -1.0, 1.0)))
    return float(rot), float(trans)
