"""``neus2_tpu_torch/tools/from_neus.py`` against ``neus2_tpu``'s
converter on a NeuS-format case the test writes: random intrinsics
(positive focal lengths, a small skew), rotations and translations, a
scale matrix, ``cameras_sphere.npz`` and PNG images.

The JAX package's converter decomposes P with ``cv2``
(``cv2.decomposeProjectionMatrix``), the port's with ``scipy.linalg.rq``;
the transforms.json values agree within 1e-5 (both decompose in float64
and round to float32).  The port's loader reads the result.
"""

import json

import numpy as np
import pytest
from PIL import Image

from neus2_tpu_torch.data.dataset import load_dataset
from neus2_tpu_torch.tools import from_neus

N_IMG, W, H = 5, 40, 30


def _rotation(rng) -> np.ndarray:
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("neus_case")
    (d / "image").mkdir()
    rng = np.random.default_rng(0)
    mats = {}
    for i in range(N_IMG):
        K = np.array([[rng.uniform(30, 60), rng.uniform(-0.5, 0.5), rng.uniform(15, 25)],
                      [0.0, rng.uniform(30, 60), rng.uniform(10, 20)],
                      [0.0, 0.0, 1.0]])
        R, t = _rotation(rng), rng.normal(size=3) * 2.0
        world = np.eye(4)
        world[:3] = K @ np.concatenate([R, t[:, None]], 1) * rng.uniform(0.5, 2.0)
        scale = np.diag([1.3, 1.3, 1.3, 1.0])
        scale[:3, 3] = rng.normal(size=3) * 0.1
        mats[f"world_mat_{i}"], mats[f"scale_mat_{i}"] = world, scale
        rgba = rng.integers(0, 256, size=(H, W, 4), dtype=np.uint8)
        Image.fromarray(rgba, "RGBA").save(d / "image" / f"{i:03d}.png")
    np.savez(d / "cameras_sphere.npz", **mats)
    return d


def test_decomposition_recovers_the_camera(case):
    cams = np.load(case / "cameras_sphere.npz")
    P = (cams["world_mat_0"] @ cams["scale_mat_0"])[:3, :4]
    K, pose = from_neus.load_K_Rt_from_P(P)
    assert np.all(np.diag(K) > 0) and K[2, 2] == 1.0 and K[1, 0] == K[2, 0] == K[2, 1] == 0.0
    np.testing.assert_allclose(pose[:3, :3].T @ pose[:3, :3], np.eye(3), atol=1e-6)
    # The camera centre projects nowhere: P @ [c, 1] = 0.
    np.testing.assert_allclose(P @ np.append(pose[:3, 3], 1.0), 0.0, atol=1e-4)
    # K R^T (x - c) reproduces P x up to its scale.
    x = np.array([0.3, -0.2, 0.5])
    proj = K @ pose[:3, :3].T @ (x - pose[:3, 3])
    ref = P @ np.append(x, 1.0)
    np.testing.assert_allclose(proj[:2] / proj[2], ref[:2] / ref[2], rtol=1e-5)


def test_convert_matches_jax_and_loads(case, tmp_path):
    pytest.importorskip("cv2")
    from neus2_tpu.tools import from_neus as jax_from_neus

    got = json.loads(from_neus.convert(case, tmp_path / "port").read_text())
    ref = json.loads(jax_from_neus.convert(case, tmp_path / "jax").read_text())
    assert got.keys() == ref.keys() and len(got["frames"]) == N_IMG
    for k in ("from_na", "w", "h", "scale", "offset", "aabb_scale"):
        assert got[k] == ref[k], k
    assert (got["w"], got["h"]) == (W, H)
    for a, b in zip(got["frames"], ref["frames"]):
        assert a["file_path"] == b["file_path"]
        for k in ("intrinsic_matrix", "transform_matrix"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5, err_msg=k)
        assert (tmp_path / "port" / a["file_path"]).read_bytes() == \
            (tmp_path / "jax" / b["file_path"]).read_bytes()
    ds = load_dataset(tmp_path / "port" / "transforms.json")
    assert ds.n_images == N_IMG and ds.resolution == (W, H)
    assert np.isfinite(ds.poses).all() and np.isfinite(ds.focal).all()
