"""msd_tpu_torch's render pass against msd_tpu's: the same rasterizer source
built with the same g++ flags, so every buffer and statistic is equal bit
for bit on one host."""

import numpy as np
import pytest

import msd_tpu.render as jr
import msd_tpu_torch.render as tr
from conftest import make_sphere_mesh


def _two_shells():
    """An outer sphere hiding an inner one, both wound outward."""
    vo, fo = make_sphere_mesh(32, 64, radius=0.7)
    vi, fi = make_sphere_mesh(16, 32, radius=0.25)
    return np.concatenate([vo, vi]), np.concatenate([fo[:, ::-1], fi[:, ::-1] + len(vo)])


MESHES = {
    "sphere": lambda: make_sphere_mesh(24, 48, radius=0.6),
    "inward_sphere": lambda: make_sphere_mesh(24, 48, radius=0.6),
    "two_shells": _two_shells,
}


def _mesh(name):
    v, f = MESHES[name]()
    if name == "sphere":  # the fixture winds inward
        f = f[:, ::-1]
    return v, np.ascontiguousarray(f)


@pytest.mark.parametrize("name", list(MESHES))
def test_visibility_scan_equal(name):
    mesh = _mesh(name)
    vis_t, stats_t = tr.visibility_scan(mesh, num_views=24, resolution=(160, 120))
    vis_j, stats_j = jr.visibility_scan(mesh, num_views=24, resolution=(160, 120))
    np.testing.assert_array_equal(vis_t, vis_j)
    assert stats_t == stats_j
    assert stats_t["covered_pixels"] > 0
    np.testing.assert_array_equal(tr.visible_faces(mesh, num_views=8), jr.visible_faces(mesh, num_views=8))
    if name == "two_shells":  # the inner shell is hidden
        assert stats_t["visible_fraction"] < 0.8
    if name == "inward_sphere":  # every observed face points away
        assert stats_t["wrong_normal_fraction"] == 1.0


@pytest.mark.parametrize("eye", [(0.0, 0.0, 2.0), (1.2, 0.9, -1.1), (0.0, 2.0, 0.0)])
def test_render_view_equal(eye):
    mesh = _mesh("two_shells")
    pose_t, pose_j = tr.look_at_pose(eye), jr.look_at_pose(eye)
    np.testing.assert_array_equal(pose_t, pose_j)
    out_t = tr.render_view(mesh, pose_t, resolution=(200, 150), want_faceid=True)
    out_j = jr.render_view(mesh, pose_j, resolution=(200, 150), want_faceid=True)
    assert len(out_t) == 3
    for a, b in zip(out_t, out_j):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    depth_only = tr.render_view(mesh, pose_t, resolution=(200, 150), want_color=False)
    assert depth_only.tobytes() == out_t[1].tobytes()


def test_pyrender_helper_equal():
    mesh = _mesh("sphere")
    color_t, depth_t = tr.pyrender_helper(mesh, alpha=0.2, beta=0.3, gamma=0.1)
    color_j, depth_j = jr.pyrender_helper(mesh, alpha=0.2, beta=0.3, gamma=0.1)
    assert color_t.shape == (1000, 1000, 3) and depth_t.shape == (1000, 1000)
    assert color_t.tobytes() == color_j.tobytes()
    assert depth_t.tobytes() == depth_j.tobytes()
    hit = depth_t > 0
    assert abs(depth_t[hit].min() - 1.4) < 0.02  # camera 2 out, radius 0.6
