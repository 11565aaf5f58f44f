"""Pinhole cameras and pixel -> ray generation
(port of ``neus2_tpu/engine/rays.py``, pinhole branch; reference
common_device.cuh:246-310).

uv in [0,1]^2; camera-space direction ((u - cx)*W/fx, (v - cy)*H/fy, 1)
rotated by the camera-to-world 3x3 block; the origin is column 3.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from neus2_tpu_torch.utils.device import constant


class Cameras(NamedTuple):
    poses: torch.Tensor  # (N, 3, 4) camera-to-world
    focal: torch.Tensor  # (N, 2) fx, fy in pixels
    principal: torch.Tensor  # (N, 2) cx, cy relative to resolution
    resolution: tuple[int, int]  # (W, H)

    @property
    def n_images(self) -> int:
        return self.poses.shape[0]

    def size_of(self, img_idx: torch.Tensor) -> torch.Tensor:
        """(B, 2) float (w, h) of each image in the batch."""
        w, h = self.resolution
        wh = constant((float(w), float(h)), torch.float32, img_idx.device)
        return wh.expand(img_idx.shape + (2,))


def pixel_to_ray(cameras: Cameras, img_idx: torch.Tensor, uv: torch.Tensor):
    """(origin (B, 3), unit direction (B, 3)) for (image, uv) pairs."""
    poses = cameras.poses[img_idx]
    focal = cameras.focal[img_idx]
    principal = cameras.principal[img_idx]
    xy = (uv - principal) * cameras.size_of(img_idx) / focal
    dir_cam = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
    direction = (poses[..., :3] * dir_cam[..., None, :]).sum(-1)
    direction = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
    return poses[..., 3], direction


def rays_from_pixels(cameras: Cameras, images: torch.Tensor,
                     img_idx: torch.Tensor, uv: torch.Tensor):
    """Rays and RGBA targets for (image, uv) picks, snapped to pixel centers.

    Returns (origins (B,3), dirs (B,3), rgba (B,4), uv (B,2))."""
    wh = cameras.size_of(img_idx)
    wi, hi = wh[:, 0].to(torch.int64), wh[:, 1].to(torch.int64)
    px = torch.minimum((uv[:, 0] * wh[:, 0]).to(torch.int64), wi - 1)
    py = torch.minimum((uv[:, 1] * wh[:, 1]).to(torch.int64), hi - 1)
    uv = torch.stack([(px + 0.5) / wh[:, 0], (py + 0.5) / wh[:, 1]], -1)
    rgba = images[img_idx, py, px]
    origins, dirs = pixel_to_ray(cameras, img_idx, uv)
    return origins, dirs, rgba.to(torch.float32), uv
