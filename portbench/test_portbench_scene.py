"""The benchmark's torch copy of the CSG capture agrees with the repo's
numpy original (``neus2_tpu_torch/data/synthetic.py``) at a small size."""

import numpy as np
import torch

from neus2_tpu_torch.data import synthetic
from portbench import scene


def test_poses_and_sdf_match_the_original():
    for seed in (0, 2**31 + 11):
        np.testing.assert_array_equal(scene.csg_poses(6, 1.35, seed),
                                      np.stack(synthetic.csg_poses(6, 1.35, seed)))
    x = np.random.default_rng(3).uniform(-0.2, 1.2, (4096, 3))
    got = scene.csg_sdf(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, synthetic.csg_sdf(x), rtol=0, atol=1e-12)
    np.testing.assert_allclose(scene.csg_albedo(torch.as_tensor(x)).numpy(),
                               synthetic._csg_albedo(x), rtol=0, atol=1e-12)


def test_views_match_the_original_at_a_small_size():
    res = 40
    spec = {"scene": "csg", "n_views": 4, "width": res, "height": res, "fov_y_deg": 50.0,
            "cam_distance": 1.35, "aabb_scale": 1}
    cap = scene.make_capture(spec, 5, "cpu")
    want = synthetic.make_csg_dataset(4, res, seed=5)
    np.testing.assert_allclose(cap.focal.numpy(), want.focal, rtol=1e-7)
    got, ref = cap.images.numpy(), want.images
    # The original keeps t in float32; the copy traces in float64, so a
    # silhouette pixel may land on the other side.
    close = np.abs(got - ref).max(-1) < 1e-4
    assert close.mean() > 0.995
    assert np.abs(got - ref).mean() < 2e-3
    assert (got[..., 3] > 0).mean() > 0.2


def test_a_later_frame_moves_the_scene_and_not_the_cameras():
    spec = {"scene": "csg", "n_views": 3, "width": 32, "height": 32, "fov_y_deg": 50.0,
            "cam_distance": 1.35, "aabb_scale": 1, "motion_per_frame": [0.02, 0.0, -0.01]}
    moved = scene.make_capture(spec, 9, "cpu", frame=2)
    still = scene.make_capture(spec, 9, "cpu", frame=0)
    np.testing.assert_array_equal(moved.poses.numpy(), still.poses.numpy())
    assert np.abs(moved.images.numpy() - still.images.numpy()).max() > 0.1
    # Cameras carried along with the scene see what the still cameras saw.
    carried = still.poses.clone()
    carried[:, :, 3] += torch.tensor([0.04, 0.0, -0.02])
    got = scene.trace_views(carried, 32, 32, float(still.focal[0, 0]), (0.04, 0.0, -0.02))
    close = np.abs(got.numpy() - still.images.numpy()).max(-1) < 1e-4
    assert close.mean() > 0.99
