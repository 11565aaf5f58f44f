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
  * texels stored premultiplied-alpha linear RGBA;
  * per-frame ``depth_path`` images times ``integer_depth_scale`` times
    the scene scale, in ngp units (0 = no data); a json-root ``envmap``
    image that seeds the learned envmap;
  * the lens at the json root: Brown-Conrady ``k1/k2/p1/p2``, or an FTheta
    fisheye ``ftheta_p0..4`` + ``w/h`` (which wins); ``rolling_shutter``
    with per-frame ``transform_matrix_start/_end``;
  * per-pixel ray files ``rays_<stem>.dat`` beside the images;
  * load-time unsharp-mask sharpening (json ``sharpen``);
  * mixed image sizes, zero-padded to the largest with the true (w, h)
    kept in ``sizes``.

PNG/JPEG frames decode on the native thread pool (``native.py``, the repo's
``native/image_loader.cpp``), with Pillow for any file it cannot decode or
wherever it cannot be built; depth maps and the envmap decode with Pillow
(a 16-bit grey PNG stays uint16).  EXR frames, depth maps and envmaps go
through the port's own codec (``data/exr.py``): linear, with no sRGB
decode.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import torch

from neus2_tpu_torch.data.exr import read_exr_depth, read_exr_rgba
from neus2_tpu_torch.engine.rays import Cameras
from neus2_tpu_torch.ops.image import sharpen_images


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
    # (N, H, W) float32 depth in ngp units, 0 = no data (reference
    # nerf_loader.cu:91-98, 218-220, 599-607, 736); None without depth maps.
    depths: np.ndarray | None = None
    # (H, W, 4) premultiplied-linear RGBA from the json-root "envmap" image
    # (reference nerf_loader.cu:498-511).
    envmap: np.ndarray | None = None
    # Brown-Conrady (k1, k2, p1, p2) from the json root (nerf_loader.cu:
    # 397-425), and the FTheta polynomial [p0..p4, w, h] (448-457, which
    # takes precedence: the reference assigns it last); None when absent.
    distortion: np.ndarray | None = None
    ftheta: np.ndarray | None = None
    # Rolling shutter (t0, du, dv, motionblur) and the (N, 3, 4)
    # end-of-exposure poses (nerf_loader.cu:434-445).
    rolling_shutter: np.ndarray | None = None
    poses_end: np.ndarray | None = None
    # (N, H, W, 6) per-pixel rays [o | d] in ngp coordinates from
    # "rays_<stem>.dat" (nerf_loader.cu:614-635).
    rays: np.ndarray | None = None
    # (N, 2) int32 true (w, h) when the sizes are mixed (nerf_loader.h:33-48).
    sizes: np.ndarray | None = None

    @property
    def n_images(self) -> int:
        return self.images.shape[0]

    @property
    def resolution(self) -> tuple[int, int]:
        return self.images.shape[2], self.images.shape[1]  # (W, H)

    def subset(self, sl: slice | list[int]) -> NerfDataset:
        """The dataset restricted to a slice or list of image indices.  The
        rolling-shutter vector belongs to the whole dataset and is kept."""

        def cut(a):
            return None if a is None else a[sl]

        return dataclasses.replace(
            self, images=self.images[sl], poses=self.poses[sl], focal=self.focal[sl],
            principal=self.principal[sl],
            paths=tuple(np.asarray(self.paths, object)[sl]) if self.paths else (),
            depths=cut(self.depths), poses_end=cut(self.poses_end), rays=cut(self.rays),
            sizes=cut(self.sizes),
        )

    def cameras(self, device="cpu") -> Cameras:
        """The cameras on ``device``; the Brown-Conrady lens is dropped
        under an FTheta one."""

        def opt(a, dtype=torch.float32):
            return None if a is None else torch.as_tensor(a, dtype=dtype, device=device)

        return Cameras(
            poses=opt(self.poses),
            focal=opt(self.focal),
            principal=opt(self.principal),
            resolution=self.resolution,
            distortion=opt(self.distortion) if self.ftheta is None else None,
            ftheta=opt(self.ftheta),
            poses_end=opt(self.poses_end),
            rolling_shutter=opt(self.rolling_shutter),
            rays=opt(self.rays),
            image_sizes=opt(self.sizes, torch.int32),
        )

    def to_device(self, device) -> tuple[torch.Tensor, Cameras]:
        """(images (N, H, W, 4), Cameras) as tensors on ``device``."""
        return torch.as_tensor(self.images, device=device), self.cameras(device)

    def depths_device(self, device) -> torch.Tensor | None:
        if self.depths is None:
            return None
        return torch.as_tensor(self.depths, dtype=torch.float32, device=device)


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
    """Decode one PNG/JPEG/EXR -> (H, W, 4) float32 premultiplied-linear
    RGBA.  EXR data is linear already (the reference's tinyexr path,
    nerf_loader.cu:499-510)."""
    if path.suffix.lower() == ".exr":
        img = read_exr_rgba(path)
        rgb, alpha = img[..., :3], img[..., 3:4]
        return np.concatenate([rgb * alpha, alpha], axis=-1).astype(np.float32)
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


def load_dataset(json_path: str | os.PathLike, n_frames_cap: int | None = None) -> NerfDataset:
    """Load one transforms.json (a static scene or one dynamic frame)."""
    json_path = Path(json_path)
    with open(json_path) as f:
        meta = json.load(f)
    basepath = json_path.parent
    frames = meta["frames"]
    if n_frames_cap is not None:
        frames = frames[:n_frames_cap]

    from_na = "from_na" in meta
    scale = float(meta.get("scale", 0.33))
    offset = np.asarray(meta.get("offset", (0.5, 0.5, 0.5)), np.float32)
    if np.ndim(offset) == 0:
        offset = np.full((3,), float(offset), np.float32)
    # Brown-Conrady when any of k1/k2/p1/p2 is nonzero (nerf_loader.cu:397-425).
    dist = np.array([float(meta.get(k, 0.0)) for k in ("k1", "k2", "p1", "p2")], np.float32)
    distortion = dist if np.any(dist != 0.0) else None
    ftheta = None
    if "ftheta_p0" in meta:
        ftheta = np.array([float(meta[f"ftheta_p{i}"]) for i in range(5)]
                          + [float(meta["w"]), float(meta["h"])], np.float32)
    rolling_shutter = None
    if "rolling_shutter" in meta:
        rs = [float(v) for v in meta["rolling_shutter"]]
        rolling_shutter = np.asarray((rs + [0.0])[:4], np.float32)
    sharpen_amount = float(meta.get("sharpen", 0.0))
    # uint16 depth images scale by integer_depth_scale, then by the scene
    # scale (reference set_training_image, nerf_loader.cu:736).
    depth_scale = float(meta.get("integer_depth_scale", -1.0))
    envmap = None
    if "envmap" in meta:
        envmap_path = basepath / str(meta["envmap"])
        if not envmap_path.exists():
            raise FileNotFoundError(f"Environment map path {envmap_path} does not exist.")
        envmap = _load_image_rgba(envmap_path)

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

    images, poses, poses_end, focals, principals, depth_list, ray_list = ([] for _ in range(7))
    any_end = False
    for frame, p, img in zip(frames, resolved, decoded):
        img = img if img is not None else _load_image_rgba(p)
        if sharpen_amount > 0.0:  # nerf_loader.cu:364-365, 808-830
            img = sharpen_images(img[None], sharpen_amount)[0]
        images.append(img)
        mat = np.asarray(frame.get("transform_matrix_start", frame.get("transform_matrix")),
                         np.float32)
        poses.append(nerf_matrix_to_ngp(mat, scale, offset, from_na))
        # The end-of-exposure pose defaults to the start (nerf_loader.cu:637-639).
        any_end = any_end or "transform_matrix_end" in frame
        end = np.asarray(frame.get("transform_matrix_end", mat), np.float32)
        poses_end.append(nerf_matrix_to_ngp(end, scale, offset, from_na))
        h, w = img.shape[:2]
        fx, fy, cx, cy = _focal_from_json(frame, meta, w, h)
        focals.append((fx, fy))
        principals.append((cx, cy))
        depth_list.append(_load_depth(basepath / frame["depth_path"], depth_scale * scale)
                          if depth_scale > 0.0 and "depth_path" in frame else None)
        ray_list.append(_load_rays_file(p, (h, w), scale, offset))

    shapes = {im.shape[:2] for im in images}
    sizes = None
    if len(shapes) != 1:
        # Mixed sizes: zero-pad to the largest, keep each true (w, h).
        sizes = np.asarray([(im.shape[1], im.shape[0]) for im in images], np.int32)
        h_max, w_max = max(s[0] for s in shapes), max(s[1] for s in shapes)

        def pad2(a):
            return np.pad(a, ((0, h_max - a.shape[0]), (0, w_max - a.shape[1]))
                          + ((0, 0),) * (a.ndim - 2))

        images = [pad2(im) for im in images]
        depth_list = [None if d is None else pad2(d) for d in depth_list]
        ray_list = [None if r is None else pad2(r) for r in ray_list]
    h, w = images[0].shape[:2]
    depths = None
    if any(d is not None for d in depth_list):
        depths = np.stack([np.zeros((h, w), np.float32) if d is None else d
                           for d in depth_list])
    rays = None
    if any(r is not None for r in ray_list):
        if any(r is None for r in ray_list):
            raise ValueError("per-pixel ray files must be present for all frames or none")
        rays = np.stack(ray_list)
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
        depths=depths,
        envmap=envmap,
        distortion=distortion,
        ftheta=ftheta,
        rolling_shutter=rolling_shutter,
        poses_end=np.stack(poses_end) if any_end or rolling_shutter is not None else None,
        rays=rays,
        sizes=sizes,
    )


def _load_rays_file(img_path: Path, hw: tuple[int, int], scale: float,
                    offset: np.ndarray) -> np.ndarray | None:
    """"rays_<stem>.dat" beside an image -> (H, W, 6) ngp [o | d], or None.

    H*W records of 6 float32 (origin, direction) in nerf coordinates,
    converted as nerf_ray_to_ngp (nerf_loader.h:157-172): o * scale +
    offset, then xyz <- yzx on both; the direction is not scaled."""
    rp = img_path.parent / f"rays_{img_path.stem}.dat"
    if not rp.exists():
        return None
    h, w = hw
    raw = np.fromfile(rp, np.float32)
    if raw.size < h * w * 6:
        raise ValueError(f"{rp}: expected {h * w * 6} floats, got {raw.size}")
    r = raw[: h * w * 6].reshape(h, w, 6).copy()
    r[..., :3] = r[..., :3] * scale + np.asarray(offset, np.float32)
    r[..., 0:3] = r[..., [1, 2, 0]]
    r[..., 3:6] = r[..., [4, 5, 3]]
    return r


def _load_depth(path: Path, scale: float) -> np.ndarray:
    """A depth image -> (H, W) float32 in ngp units, 0 = missing: pixels
    times ``integer_depth_scale`` times the scene scale (the reference's
    copy_depth, nerf_loader.cu:91-98, 736); the first channel of a colour
    image, the Z channel (else the first) of an EXR."""
    d = read_exr_depth(path) if path.suffix.lower() == ".exr" else _read_image(path)
    if d.ndim == 3:
        d = d[..., 0]
    return (d.astype(np.float32) * scale).astype(np.float32)


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
