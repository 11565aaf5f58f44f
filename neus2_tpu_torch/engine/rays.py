"""Camera models and pixel -> ray generation (port of
``neus2_tpu/engine/rays.py``; reference common_device.cuh:142-310).

uv in [0,1]^2; the pinhole camera-space direction is ((u - cx)*W/fx,
(v - cy)*H/fy, 1), rotated by the camera-to-world 3x3 block; the origin is
column 3.  On top of the pinhole: a Brown-Conrady lens (undistorted by
Newton iteration), an FTheta fisheye, rolling-shutter pose interpolation,
per-pixel ray files and per-image sizes.  Each applies only when its
``Cameras`` field is set, so a pinhole camera takes the pinhole path as it
was.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from neus2_tpu_torch.utils.device import constant

# Newton steps of the Brown-Conrady inversion (JAX engine/rays.py:80).
N_NEWTON = 8


class Cameras(NamedTuple):
    """Per-image cameras (N images), optionally with a lens model."""

    poses: torch.Tensor  # (N, 3, 4) camera-to-world
    focal: torch.Tensor  # (N, 2) fx, fy in pixels
    principal: torch.Tensor  # (N, 2) cx, cy relative to resolution
    resolution: tuple[int, int]  # (W, H), the max over the images
    # Brown-Conrady (k1, k2, p1, p2), shared by all images (json root,
    # nerf_loader.cu:397-425); None = pinhole.
    distortion: torch.Tensor | None = None
    # FTheta fisheye [p0..p4, w, h] (common.h:172, nerf_loader.cu:448-457);
    # excludes ``distortion``.
    ftheta: torch.Tensor | None = None
    # End-of-exposure poses (N, 3, 4) and the rolling-shutter coefficients
    # (t0, du, dv, motionblur): the pose of a pixel is start + (end - start)
    # * (t0 + du u + dv v + mb time) (common_device.cuh:226-229).
    poses_end: torch.Tensor | None = None
    rolling_shutter: torch.Tensor | None = None
    # Per-pixel ray files (N, H, W, 6) [origin | direction] in ngp
    # coordinates; they replace the camera model for training rays
    # (nerf_loader.cu:614-635, testbed_nerf.cu:1328).
    rays: torch.Tensor | None = None
    # (N, 2) int true (w, h) of each image when the sizes are mixed and the
    # images are zero-padded to ``resolution``; None = all at ``resolution``.
    image_sizes: torch.Tensor | None = None
    # Per-image sharpness grids (N, sh, sw) of the error map's sharpness
    # weighting (reference dataset.sharpness_data); None when it is off.
    sharpness: torch.Tensor | None = None

    @property
    def n_images(self) -> int:
        return self.poses.shape[0]

    def size_of(self, img_idx: torch.Tensor) -> torch.Tensor:
        """(B, 2) float (w, h) of each image in the batch."""
        if self.image_sizes is not None:
            return self.image_sizes[img_idx].to(torch.float32)
        w, h = self.resolution
        wh = constant((float(w), float(h)), torch.float32, img_idx.device)
        return wh.expand(img_idx.shape + (2,))


def apply_camera_distortion(params: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Brown-Conrady forward distortion deltas (du, dv)
    (common_device.cuh:142-159)."""
    k1, k2, p1, p2 = params[0], params[1], params[2], params[3]
    u2, v2, uv = u * u, v * v, u * v
    r2 = u2 + v2
    radial = k1 * r2 + k2 * r2 * r2
    du = u * radial + 2.0 * p1 * uv + p2 * (r2 + 2.0 * u2)
    dv = v * radial + 2.0 * p2 * uv + p1 * (r2 + 2.0 * v2)
    return du, dv


def iterative_undistortion(params: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Invert the distortion by ``N_NEWTON`` Newton steps with the analytic
    Jacobian (the reference's up to 100 steps with a numerical one and an
    early exit, common_device.cuh:162-201, reach the same point).  The
    determinant guard comes before the division, so the backward through
    the unrolled steps never sees inf * 0."""
    k1, k2, p1, p2 = params[0], params[1], params[2], params[3]
    x, y = u, v
    for _ in range(N_NEWTON):
        x2, y2, xy_ = x * x, y * y, x * y
        r2 = x2 + y2
        radial = k1 * r2 + k2 * r2 * r2
        dradial_dr2 = k1 + 2.0 * k2 * r2
        # Residual F = distort(x, y) - (u, v) and its Jacobian.
        fx = x + x * radial + 2.0 * p1 * xy_ + p2 * (r2 + 2.0 * x2) - u
        fy = y + y * radial + 2.0 * p2 * xy_ + p1 * (r2 + 2.0 * y2) - v
        j00 = 1.0 + radial + x * dradial_dr2 * 2.0 * x + 2.0 * p1 * y + 6.0 * p2 * x
        j01 = x * dradial_dr2 * 2.0 * y + 2.0 * p1 * x + 2.0 * p2 * y
        j10 = y * dradial_dr2 * 2.0 * x + 2.0 * p2 * y + 2.0 * p1 * x
        j11 = 1.0 + radial + y * dradial_dr2 * 2.0 * y + 2.0 * p2 * x + 6.0 * p1 * y
        det = j00 * j11 - j01 * j10
        det = torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)
        x, y = x - (j11 * fx - j01 * fy) / det, y - (-j10 * fx + j00 * fy) / det
    return x, y


def ftheta_undistortion(params: torch.Tensor, duv: torch.Tensor):
    """FTheta fisheye: centred uv offset -> (unnormalized camera-space
    direction (B, 3), valid (B,) bool) (common_device.cuh:231-243).  The
    pixel radius r, in the lens's own w/h scale (params[5:7]), maps to the
    polar angle alpha = p0 + r (p1 + r (p2 + r (p3 + r p4))).  Invalid rays
    (cos alpha <= 0 or r == 0) get +z; callers mask them."""
    xpix = duv[..., 0] * params[5]
    ypix = duv[..., 1] * params[6]
    norm = torch.sqrt(xpix * xpix + ypix * ypix)
    alpha = params[0] + norm * (params[1] + norm * (params[2] + norm * (params[3]
                                                                       + norm * params[4])))
    sin_a, cos_a = torch.sin(alpha), torch.cos(alpha)
    valid = (cos_a > torch.finfo(torch.float32).tiny) & (norm > 0.0)
    s = sin_a / torch.where(norm > 0.0, norm, torch.ones_like(norm))
    dir_cam = torch.stack([s * xpix, s * ypix, cos_a], -1)
    z = constant((0.0, 0.0, 1.0), torch.float32, duv.device)
    return torch.where(valid[..., None], dir_cam, z), valid


def pixel_to_ray(cameras: Cameras, img_idx: torch.Tensor, uv: torch.Tensor,
                 motionblur_time: float = 0.0):
    """(origin (B, 3), unit direction (B, 3)) for (image, uv) pairs."""
    poses = cameras.poses[img_idx]
    if cameras.poses_end is not None and cameras.rolling_shutter is not None:
        rs = cameras.rolling_shutter
        t = rs[0] + rs[1] * uv[..., 0] + rs[2] * uv[..., 1] + rs[3] * motionblur_time
        poses = poses + (cameras.poses_end[img_idx] - poses) * t[..., None, None]
    principal = cameras.principal[img_idx]
    if cameras.ftheta is not None:
        # The polynomial takes the centred uv; the focal is not used
        # (common_device.cuh:265-269).  Invalid pixels start at the
        # reference's sentinel outside the box, so they composite to the
        # background.
        dir_cam, valid = ftheta_undistortion(cameras.ftheta, uv - principal)
        direction = (poses[..., :3] * dir_cam[..., None, :]).sum(-1)
        direction = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
        sentinel = constant((1000.0, 0.0, 0.0), torch.float32, uv.device)
        return torch.where(valid[..., None], poses[..., 3], sentinel), direction
    focal = cameras.focal[img_idx]
    xy = (uv - principal) * cameras.size_of(img_idx) / focal
    if cameras.distortion is not None:
        x, y = iterative_undistortion(cameras.distortion, xy[..., 0], xy[..., 1])
        xy = torch.stack([x, y], -1)
    dir_cam = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
    direction = (poses[..., :3] * dir_cam[..., None, :]).sum(-1)
    direction = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
    return poses[..., 3], direction


def rays_from_pixels(cameras: Cameras, images: torch.Tensor,
                     img_idx: torch.Tensor, uv: torch.Tensor):
    """Rays and RGBA targets for (image, uv) picks, snapped to the centres
    of each image's true pixels; the texels are cast to fp32 after the
    gather (fp16 storage).  Returns (origins (B,3), dirs (B,3), rgba (B,4),
    uv (B,2))."""
    wh = cameras.size_of(img_idx)
    wi, hi = wh[:, 0].to(torch.int64), wh[:, 1].to(torch.int64)
    px = torch.minimum((uv[:, 0] * wh[:, 0]).to(torch.int64), wi - 1)
    py = torch.minimum((uv[:, 1] * wh[:, 1]).to(torch.int64), hi - 1)
    uv = torch.stack([(px + 0.5) / wh[:, 0], (py + 0.5) / wh[:, 1]], -1)
    rgba = images[img_idx, py, px]
    if cameras.rays is not None:
        ray = cameras.rays[img_idx, py, px]
        origins, dirs = ray[:, :3], ray[:, 3:]
        dirs = dirs / torch.clamp_min(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-9)
    else:
        origins, dirs = pixel_to_ray(cameras, img_idx, uv)
    return origins, dirs, rgba.to(torch.float32), uv


def rays_for_image(cameras: Cameras, img_idx: int):
    """All pixel-centre rays of one image at ``resolution``, (H*W, 3) each."""
    w, h = cameras.resolution
    dev = cameras.poses.device
    u = (torch.arange(w, device=dev) + 0.5) / w
    v = (torch.arange(h, device=dev) + 0.5) / h
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    uv = torch.stack([uu.reshape(-1), vv.reshape(-1)], -1)
    idx = torch.full((uv.shape[0],), int(img_idx), dtype=torch.int64, device=dev)
    return pixel_to_ray(cameras, idx, uv)
