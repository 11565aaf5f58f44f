"""Convert a NeuS-format dataset (``cameras_sphere.npz``) into a ``from_na``
transforms.json (port of ``neus2_tpu/tools/from_neus.py``; reference
tools/data_format_from_neus.py).

A NeuS case stores a projection matrix ``world_mat_{i}`` (P = K [R|t]) and
a normalization ``scale_mat_{i}`` an image; the converter decomposes
P @ scale into intrinsics and a camera-to-world pose and writes a
transforms.json with per-frame ``intrinsic_matrix`` / ``transform_matrix``
(read by ``data/dataset.py``).  The decomposition is the RQ decomposition
``cv2.decomposeProjectionMatrix`` makes, done with ``scipy.linalg.rq``;
images are copied and sized with Pillow.

Usage: python -m neus2_tpu_torch.tools.from_neus <neus_case_dir> <out_dir>
       (expects <case>/cameras_sphere.npz and <case>/image/*.png)
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np


def load_K_Rt_from_P(P: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A 3x4 projection -> (K (3, 3) with K[2, 2] = 1, camera-to-world
    (4, 4)), as ``cv2.decomposeProjectionMatrix`` gives them: M = P[:, :3] =
    K R with K upper triangular with a positive diagonal, and the camera
    centre -M^-1 P[:, 3]."""
    from scipy.linalg import rq

    P = np.asarray(P, np.float64)[:3, :4]
    K, R = rq(P[:, :3])
    signs = np.diag(np.sign(np.diag(K)))  # its own inverse
    K, R = K @ signs, signs @ R
    centre = -np.linalg.solve(P[:, :3], P[:, 3])
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T
    pose[:3, 3] = centre
    return (K / K[2, 2]).astype(np.float32), pose


def convert(case_dir: str | Path, out_dir: str | Path, image_glob="image/*.png") -> Path:
    """Write ``<out_dir>/images/%04d.png`` (copies) and
    ``<out_dir>/transforms.json``; returns the json's path."""
    from PIL import Image

    case_dir, out_dir = Path(case_dir), Path(out_dir)
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    cams = np.load(case_dir / "cameras_sphere.npz")
    images = sorted(case_dir.glob(image_glob))
    if not images:
        raise FileNotFoundError(f"no images under {case_dir}/{image_glob}")
    with Image.open(images[0]) as im:
        w, h = im.size

    frames = []
    for i, img_path in enumerate(images):
        scale_mat = cams[f"scale_mat_{i}"] if f"scale_mat_{i}" in cams else np.eye(4)
        K, pose = load_K_Rt_from_P((cams[f"world_mat_{i}"] @ scale_mat)[:3, :4])
        rel = f"images/{i:04d}.png"
        shutil.copyfile(img_path, out_dir / rel)
        frames.append({
            "file_path": rel,
            "intrinsic_matrix": [
                [float(K[0, 0]), 0.0, float(K[0, 2]), 0.0],
                [0.0, float(K[1, 1]), float(K[1, 2]), 0.0],
                [0.0, 0.0, 1.0, 0.0],
                [0.0, 0.0, 0.0, 1.0],
            ],
            "transform_matrix": [[float(v) for v in row] for row in pose],
        })

    meta = {
        "from_na": True, "w": w, "h": h,
        # NeuS's scale_mats put the object in the unit sphere; the NA
        # convention maps that into [0.25, 0.75]^3 (scale 0.5, offset 0.5).
        "scale": 0.5, "offset": [0.5, 0.5, 0.5], "aabb_scale": 1,
        "frames": frames,
    }
    out_json = out_dir / "transforms.json"
    out_json.write_text(json.dumps(meta, indent=1))
    return out_json


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print(__doc__)
        sys.exit(1)
    print(convert(sys.argv[1], sys.argv[2]))
