"""Dataset layer: NeRF / NeuS2 ``transforms.json`` loading (port of
``neus2_tpu/data/dataset.py``; reference src/nerf_loader.cu:197-760,
nerf_loader.h:68-172).

Host-side numpy, with the reference's behavior contract:

  * ``from_na`` NeuS2 format: per-frame ``intrinsic_matrix`` and
    ``transform_matrix`` (camera-to-world), RGBA images whose alpha is the
    foreground mask;
  * instant-ngp format: ``camera_angle_x`` / ``fl_x`` etc.;
  * ``nerf_matrix_to_ngp``: flip the Y/Z columns, scale + offset the
    translation, and for non-na data cycle the axes; na data only scales
    and offsets;
  * default ``scale`` 0.33 and ``offset`` (0.5, 0.5, 0.5);
  * texels stored premultiplied-alpha linear RGBA.

PNG/JPEG frames decode on the native thread pool (``native.py``, the repo's
``native/image_loader.cpp``), with Pillow for any file it cannot decode or
wherever it cannot be built.  Lens distortion, FTheta,
rolling shutter, depth maps, per-pixel ray files, environment maps,
load-time sharpening, EXR frames and mixed resolutions are not ported yet:
a JSON or scene that asks for one raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import torch

from neus2_tpu_torch.engine.rays import Cameras


def _srgb_to_linear_np(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


@dataclasses.dataclass
class NerfDataset:
    """Host-side dataset (numpy); ``to_device`` gives the tensors."""

    images: np.ndarray  # (N, H, W, 4) float32, premultiplied-alpha linear RGBA
    poses: np.ndarray  # (N, 3, 4) camera-to-world, ngp coordinates
    focal: np.ndarray  # (N, 2) fx, fy pixels
    principal: np.ndarray  # (N, 2) cx, cy relative to resolution
    scale: float = 0.33
    offset: tuple[float, float, float] = (0.5, 0.5, 0.5)
    aabb_scale: int = 1
    from_na: bool = False
    paths: tuple[str, ...] = ()

    @property
    def n_images(self) -> int:
        return self.images.shape[0]

    @property
    def resolution(self) -> tuple[int, int]:
        return self.images.shape[2], self.images.shape[1]  # (W, H)

    def cameras(self, device="cpu") -> Cameras:
        return Cameras(
            poses=torch.as_tensor(self.poses, dtype=torch.float32, device=device),
            focal=torch.as_tensor(self.focal, dtype=torch.float32, device=device),
            principal=torch.as_tensor(self.principal, dtype=torch.float32, device=device),
            resolution=self.resolution,
        )

    def to_device(self, device) -> tuple[torch.Tensor, Cameras]:
        """(images (N, H, W, 4), Cameras) as tensors on ``device``."""
        return torch.as_tensor(self.images, device=device), self.cameras(device)


def nerf_matrix_to_ngp(mat: np.ndarray, scale: float, offset: np.ndarray,
                       from_na: bool) -> np.ndarray:
    """Coordinate conversion (reference nerf_loader.h:112-133)."""
    result = np.array(mat[:3, :4], np.float32)
    result[:, 1] *= -1
    result[:, 2] *= -1
    result[:, 3] = result[:, 3] * scale + offset
    if from_na:  # flip back: only the scale/offset of the translation stays
        result[:, 1] *= -1
        result[:, 2] *= -1
    else:
        result = result[[1, 2, 0], :]
    return result


def ngp_matrix_to_nerf(mat: np.ndarray, scale: float, offset: np.ndarray,
                       from_na: bool) -> np.ndarray:
    """Inverse conversion (reference nerf_loader.h:135-155)."""
    result = np.array(mat[:3, :4], np.float32)
    if from_na:
        result[:, 1] *= -1
        result[:, 2] *= -1
    else:
        result = result[[2, 0, 1], :]
    result[:, 1] *= -1
    result[:, 2] *= -1
    result[:, 3] = (result[:, 3] - offset) / scale
    return result


def _read_image(path: Path) -> np.ndarray:
    """The file's pixels through Pillow, expanded as the native decoder
    expands them (libpng's palette-to-RGB, tRNS-to-alpha and 16-bit
    paths): palette, grey+alpha and colour-keyed images become RGBA, and a
    16-bit grey PNG comes back as uint16.  Pillow reads a 16-bit colour PNG
    at 8 bits."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode in ("P", "LA") or (im.mode in ("L", "RGB")
                                            and "transparency" in im.info):
            im = im.convert("RGBA")
        elif im.mode.startswith("I"):  # 16-bit grey: "I" before Pillow 10.1
            return np.asarray(im).astype(np.uint16)
        return np.asarray(im)


def _load_image_rgba(path: Path) -> np.ndarray:
    """Decode one PNG/JPEG -> (H, W, 4) float32 premultiplied-linear RGBA."""
    if path.suffix.lower() == ".exr":
        raise NotImplementedError(f"{path}: EXR frames are not ported yet")
    img = _read_image(path)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    if img.dtype == np.uint8:
        img, srgb = img.astype(np.float32) / 255.0, True
    elif img.dtype == np.uint16:
        img, srgb = img.astype(np.float32) / 65535.0, True
    else:  # float data is linear already
        img, srgb = img.astype(np.float32), False
    if img.shape[-1] == 3:
        img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
    rgb, alpha = img[..., :3], img[..., 3:4]
    if srgb:
        rgb = _srgb_to_linear_np(rgb)
    return np.concatenate([rgb * alpha, alpha], axis=-1).astype(np.float32)


def _focal_from_json(frame: dict, meta: dict, w: int, h: int) -> tuple[float, float, float, float]:
    """(fx, fy, cx, cy) with cx/cy relative (reference nerf_loader.cu:651-694)."""

    def fov_to_focal(res: float, deg: float) -> float:
        return 0.5 * res / np.tan(0.5 * deg * np.pi / 180.0)

    def read_fl(res: float, axis: str) -> float:
        if f"{axis}_fov" in frame:
            return fov_to_focal(res, float(frame[f"{axis}_fov"]))
        if f"fl_{axis}" in meta:
            return float(meta[f"fl_{axis}"])
        if f"camera_angle_{axis}" in meta:
            return fov_to_focal(res, float(meta[f"camera_angle_{axis}"]) * 180.0 / np.pi)
        return 0.0

    cx = float(meta.get("cx", 0.5 * w)) / w
    cy = float(meta.get("cy", 0.5 * h)) / h
    fx = read_fl(w, "x")
    fy = read_fl(h, "y")
    if fx != 0.0:
        return fx, (fy if fy != 0.0 else fx), cx, cy
    if fy != 0.0:
        return fy, fy, cx, cy
    if "intrinsic_matrix" in frame:
        k = np.asarray(frame["intrinsic_matrix"], np.float32)
        return float(k[0][0]), float(k[1][1]), float(k[0][2]) / w, float(k[1][2]) / h
    raise ValueError("couldn't read fov: no fl_x/camera_angle_x/intrinsic_matrix")


def _refuse_unported(meta: dict, frames: list, basepath: Path) -> None:
    """Raise on a scene that asks for what this port does not read yet."""
    asks = []
    if any(float(meta.get(k, 0.0)) != 0.0 for k in ("k1", "k2", "p1", "p2")):
        asks.append("lens distortion (k1/k2/p1/p2)")
    if "ftheta_p0" in meta:
        asks.append("FTheta lens")
    if "rolling_shutter" in meta or any("transform_matrix_end" in f for f in frames):
        asks.append("rolling shutter / end-of-exposure poses")
    if float(meta.get("integer_depth_scale", -1.0)) > 0.0 and any(
        "depth_path" in f for f in frames
    ):
        asks.append("depth maps")
    if "envmap" in meta:
        asks.append("an environment map")
    if float(meta.get("sharpen", 0.0)) > 0.0:
        asks.append("load-time sharpening")
    for f in frames:
        stem = Path(f["file_path"]).stem
        if (basepath / Path(f["file_path"]).parent / f"rays_{stem}.dat").exists():
            asks.append("per-pixel ray files")
            break
    if asks:
        raise NotImplementedError(
            "this scene asks for " + ", ".join(asks) + ", which the port does not read yet"
        )


def load_dataset(json_path: str | os.PathLike, n_frames_cap: int | None = None) -> NerfDataset:
    """Load one transforms.json (a static scene)."""
    json_path = Path(json_path)
    with open(json_path) as f:
        meta = json.load(f)
    basepath = json_path.parent
    frames = meta["frames"]
    if n_frames_cap is not None:
        frames = frames[:n_frames_cap]
    _refuse_unported(meta, frames, basepath)

    from_na = "from_na" in meta
    scale = float(meta.get("scale", 0.33))
    offset = np.asarray(meta.get("offset", (0.5, 0.5, 0.5)), np.float32)
    if np.ndim(offset) == 0:
        offset = np.full((3,), float(offset), np.float32)

    resolved = []
    for frame in frames:
        p = basepath / frame["file_path"]
        if not p.exists() and not p.suffix:
            p = p.with_suffix(".png")
        resolved.append(p)
    decoded = [None] * len(resolved)
    native_idx = [i for i, p in enumerate(resolved)
                  if p.suffix.lower() in (".png", ".jpg", ".jpeg")]
    if native_idx:
        from neus2_tpu_torch.native import decode_images

        images = decode_images([resolved[i] for i in native_idx])
        for i, img in zip(native_idx, images):
            decoded[i] = img

    images, poses, focals, principals = [], [], [], []
    for frame, p, img in zip(frames, resolved, decoded):
        images.append(img if img is not None else _load_image_rgba(p))
        mat = np.asarray(frame.get("transform_matrix_start", frame.get("transform_matrix")),
                         np.float32)
        poses.append(nerf_matrix_to_ngp(mat, scale, offset, from_na))
        h, w = images[-1].shape[:2]
        fx, fy, cx, cy = _focal_from_json(frame, meta, w, h)
        focals.append((fx, fy))
        principals.append((cx, cy))
    if len({im.shape[:2] for im in images}) != 1:
        raise NotImplementedError("mixed image resolutions are not ported yet")
    return NerfDataset(
        images=np.stack(images),
        poses=np.stack(poses),
        focal=np.asarray(focals, np.float32),
        principal=np.asarray(principals, np.float32),
        scale=scale,
        offset=tuple(float(o) for o in offset),
        aabb_scale=int(meta.get("aabb_scale", 1)),
        from_na=from_na,
        paths=tuple(str(p) for p in resolved),
    )


def list_frame_jsons(scene_path: str | os.PathLike) -> list[Path]:
    """A dynamic scene is a directory of per-frame jsons sorted by basename
    (reference src/testbed_nerf.cu:2967-2994); a single json is static."""
    p = Path(scene_path)
    if p.is_dir():
        jsons = sorted(p.glob("*.json"), key=lambda q: q.name)
        if not jsons:
            raise FileNotFoundError(f"no .json files in {p}")
        return jsons
    return [p]
