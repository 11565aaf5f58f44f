"""Export a ``NerfDataset`` in the NeuS2 ``from_na`` on-disk format (port of
``neus2_tpu/data/export.py``): one 8-bit RGBA PNG a frame under
``images/`` and a transforms.json with per-frame ``intrinsic_matrix`` and
``transform_matrix`` (reference README "Data Convention";
nerf_loader.cu:675-694).  The inverse of ``data/dataset.py::load_dataset``.
PNGs are written with Pillow.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from neus2_tpu_torch.data.dataset import NerfDataset, ngp_matrix_to_nerf


def _linear_to_srgb_np(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.0031308, 12.92 * c, 1.055 * np.maximum(c, 1e-7) ** (1 / 2.4) - 0.055)


def save_dataset_na(ds: NerfDataset, out_dir: str | Path, name: str = "transforms.json") -> Path:
    """Write ``<out_dir>/images/%04d.png`` (straight-alpha sRGB) and
    ``<out_dir>/<name>``; returns the json's path."""
    from PIL import Image

    out = Path(out_dir)
    (out / "images").mkdir(parents=True, exist_ok=True)
    w, h = ds.resolution
    offset = np.asarray(ds.offset, np.float32)
    frames = []
    for i in range(ds.n_images):
        img = ds.images[i]  # premultiplied-linear RGBA
        a = img[..., 3:4]
        rgb = np.where(a > 0, img[..., :3] / np.maximum(a, 1e-8), 0.0)
        srgb = np.clip(_linear_to_srgb_np(rgb), 0.0, 1.0)
        rgba8 = (np.concatenate([srgb, a], -1) * 255.0 + 0.5).astype(np.uint8)
        rel = f"images/{i:04d}.png"
        Image.fromarray(rgba8).save(out / rel, format="PNG")

        fx, fy = ds.focal[i]
        cx, cy = ds.principal[i]
        intrinsic = [
            [float(fx), 0.0, float(cx * w), 0.0],
            [0.0, float(fy), float(cy * h), 0.0],
            [0.0, 0.0, 1.0, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ]
        # The inverse of the loader's nerf_matrix_to_ngp for from_na data.
        mat = ngp_matrix_to_nerf(ds.poses[i], ds.scale, offset, from_na=True)
        mat4 = np.concatenate([mat, [[0, 0, 0, 1]]], axis=0)
        frames.append({
            "file_path": rel,
            "intrinsic_matrix": intrinsic,
            "transform_matrix": [[float(v) for v in row] for row in mat4],
        })
    meta = {
        "from_na": True,
        "w": w,
        "h": h,
        "aabb_scale": ds.aabb_scale,
        "scale": ds.scale,
        "offset": list(np.asarray(ds.offset, float)),
        "frames": frames,
    }
    with open(out / name, "w") as f:
        json.dump(meta, f, indent=1)
    return out / name
