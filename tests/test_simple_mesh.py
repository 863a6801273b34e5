"""SimpleMesh primitives, join/transform, OFF round-trip, extrinsics viz.

Covers the reference's SimpleMesh (simple_mesh.h:34-359) and
showExtrinsicsReconstruction (keypoints.cpp:35-50).
"""

import numpy as np

from stereo_reconstruction.io.mesh_io import read_off
from stereo_reconstruction.recon.simple_mesh import SimpleMesh, show_extrinsics


def test_sphere_geometry():
    m = SimpleMesh.sphere([1.0, 2.0, 3.0], scale=0.5)
    r = np.linalg.norm(m.positions - np.array([1.0, 2.0, 3.0]), axis=1)
    np.testing.assert_allclose(r, 0.5, atol=1e-12)
    assert m.num_triangles > 0
    assert (m.triangles < m.num_vertices).all()
    assert tuple(m.colors[0]) == (0, 0, 255, 255)   # reference default blue


def test_cylinder_spans_endpoints():
    p0, p1 = np.array([0.0, 0.0, 1.0]), np.array([0.0, 3.0, 1.0])
    m = SimpleMesh.cylinder(p0, p1, radius=0.25, stacks=3, slices=12)
    # every vertex is radius away from the p0->p1 axis
    axis = (p1 - p0) / np.linalg.norm(p1 - p0)
    rel = m.positions - p0
    along = rel @ axis
    perp = rel - np.outer(along, axis)
    np.testing.assert_allclose(np.linalg.norm(perp, axis=1), 0.25, atol=1e-9)
    assert along.min() > -1e-9 and along.max() < 3.0 + 1e-9


def test_camera_frustum_pose():
    # camera at pose = translation by (0,0,5): optical center maps to
    # pose^-1 @ origin = (0,0,-5) (simple_mesh.h:259 uses the inverse)
    pose = np.eye(4)
    pose[2, 3] = 5.0
    m = SimpleMesh.camera(pose, scale=0.1)
    np.testing.assert_allclose(m.positions[0], [0.0, 0.0, -5.0], atol=1e-12)
    assert m.num_vertices == 5 and m.num_triangles == 6


def test_join_and_transform():
    a = SimpleMesh.sphere([0.0, 0.0, 0.0], 1.0)
    b = SimpleMesh.sphere([10.0, 0.0, 0.0], 1.0)
    T = np.eye(4)
    T[:3, 3] = [0.0, 5.0, 0.0]
    j = SimpleMesh.join(a, b, pose1to2=T)            # a shifted by +5 in y
    assert j.num_vertices == a.num_vertices + b.num_vertices
    assert j.num_triangles == a.num_triangles + b.num_triangles
    # second mesh's triangles were re-indexed past the first mesh
    assert j.triangles[a.num_triangles:].min() >= a.num_vertices
    np.testing.assert_allclose(
        j.positions[: a.num_vertices].mean(axis=0), [0.0, 5.0, 0.0], atol=1e-9
    )


def test_off_roundtrip(tmp_path):
    m = SimpleMesh.join(
        SimpleMesh.sphere([0.0, 0.0, 0.0], 1.0),
        SimpleMesh.camera(np.eye(4), 0.5),
    )
    p = str(tmp_path / "m.off")
    m.write(p)
    back = SimpleMesh.read(p)
    assert back.num_vertices == m.num_vertices
    assert back.num_triangles == m.num_triangles
    np.testing.assert_allclose(back.positions, m.positions, atol=1e-5)
    np.testing.assert_array_equal(back.triangles, m.triangles)
    np.testing.assert_array_equal(back.colors, m.colors)


def test_show_extrinsics(tmp_path):
    pts = np.array([[0.0, 1.0, 2.0], [0.0, 0.0, 1.0], [5.0, 5.0, 6.0]])  # (3, N)
    pose = np.eye(4)
    pose[0, 3] = -1.0
    p = str(tmp_path / "extrinsics.off")
    mesh = show_extrinsics(p, pose, pts)
    verts, cols, faces = read_off(p)
    assert len(verts) == mesh.num_vertices
    # 3 point spheres + 2 cameras (5 verts each)
    sphere_verts = SimpleMesh.sphere([0, 0, 0], 1.0).num_vertices
    assert mesh.num_vertices == 3 * sphere_verts + 10
    # the two cameras carry the reference's red/green colors
    assert (cols == [255, 0, 0, 255]).all(axis=1).sum() == 5
    assert (cols == [0, 255, 0, 255]).all(axis=1).sum() == 5
