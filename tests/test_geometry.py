import jax.numpy as jnp
import numpy as np
import pytest

from stereo_reconstruction.ops import geometry as geo


def test_skew():
    v = jnp.array([1.0, 2.0, 3.0])
    S = geo.skew(v)
    expected = np.array([[0, -3, 2], [3, 0, -1], [-2, 1, 0]], dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(S), expected)
    # cross-product property
    w = jnp.array([0.5, -1.0, 2.0])
    np.testing.assert_allclose(np.asarray(S @ w), np.cross(np.asarray(v), np.asarray(w)), atol=1e-6)


def test_skew_batched():
    v = jnp.arange(12.0).reshape(4, 3)
    S = geo.skew(v)
    assert S.shape == (4, 3, 3)
    np.testing.assert_array_equal(np.asarray(S[2]), np.asarray(geo.skew(v[2])))


def test_kron_vec():
    a = jnp.array([1.0, 2.0])
    b = jnp.array([3.0, 4.0, 5.0])
    np.testing.assert_array_equal(
        np.asarray(geo.kron_vec(a, b)), np.kron(np.asarray(a), np.asarray(b))
    )


def test_homogeneous_roundtrip(rng):
    pts = jnp.asarray(rng.standard_normal((2, 7)).astype(np.float32))
    h = geo.to_homogeneous(pts)
    assert h.shape == (3, 7)
    np.testing.assert_allclose(np.asarray(geo.from_homogeneous(h)), np.asarray(pts), atol=1e-6)


def test_project_normalize_inverse(rng):
    K = jnp.array([[800.0, 0, 320], [0, 820, 240], [0, 0, 1]])
    pts3d = jnp.asarray(rng.uniform(1, 5, (3, 6)).astype(np.float32))
    pix = geo.project(K, pts3d)
    norm = geo.normalize_points(K, pix)
    # normalized points are the 3D direction with z = 1
    np.testing.assert_allclose(
        np.asarray(norm), np.asarray(pts3d / pts3d[2:3]), rtol=1e-5
    )


def test_angle_axis_roundtrip(rng):
    aa = jnp.asarray(rng.standard_normal(3).astype(np.float32))
    R = geo.angle_axis_to_rotation(aa)
    # orthonormality
    np.testing.assert_allclose(np.asarray(R @ R.mT), np.eye(3), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(np.asarray(R)), 1.0, atol=1e-5)
    back = geo.rotation_to_angle_axis(R)
    np.testing.assert_allclose(np.asarray(back), np.asarray(aa), atol=1e-4)


def test_angle_axis_small_angle():
    aa = jnp.array([1e-9, -1e-9, 1e-9])
    R = geo.angle_axis_to_rotation(aa)
    np.testing.assert_allclose(np.asarray(R), np.eye(3), atol=1e-7)


def test_average_reconstruction_error_zero_for_perfect():
    """Mirrors the perfect-cost sanity assert of the reference BA test
    (test_bundle_adjustment.cpp:49-50)."""
    K = jnp.eye(3)
    matches_left = jnp.array(
        [[0, 0, 0, 250, 250, 250, 500, 500, 500],
         [0, 250, 500, 0, 250, 500, 0, 250, 500],
         [1, 1, 1, 1, 1, 1, 1, 1, 1]],
        dtype=jnp.float32,
    )
    depth = jnp.array([10, 10, 10, 20, 20, 20, 30, 30, 30], dtype=jnp.float32)
    pts3d = matches_left * depth[None, :]
    angle = 50 * np.pi / 180
    R = jnp.array(
        [[np.cos(angle), -np.sin(angle), 0], [np.sin(angle), np.cos(angle), 0], [0, 0, 1]],
        dtype=jnp.float32,
    )
    T = jnp.array([0.0, 0.0, 10.0])
    pts_right = geo.transform(R, T, pts3d)
    matches_right = geo.project(K, pts_right)

    err = geo.average_reconstruction_error(
        matches_left, matches_right, K, K, R, T, pts3d
    )
    assert float(err) < 1e-4


def test_triangulate_depths_recovers_scene(rng):
    """Depth estimation (reference estimateDepth, eight_point.cpp:120-147)
    recovers GT depths up to the T-coefficient scale on a synthetic scene."""
    n = 10
    K = jnp.eye(3)
    depths_gt = jnp.asarray(rng.uniform(5, 15, n).astype(np.float32))
    xl = jnp.concatenate(
        [jnp.asarray(rng.uniform(-0.4, 0.4, (2, n)).astype(np.float32)), jnp.ones((1, n))]
    )
    pts3d = xl * depths_gt[None, :]
    aa = jnp.array([0.05, -0.1, 0.02])
    R = geo.angle_axis_to_rotation(aa)
    T = jnp.array([0.3, 0.05, 0.1])
    pts_right = geo.transform(R, T, pts3d)
    xr = pts_right / pts_right[2:3]

    est = geo.triangulate_depths(xl, xr, R, T)
    np.testing.assert_allclose(np.asarray(est), np.asarray(depths_gt), rtol=1e-3)
