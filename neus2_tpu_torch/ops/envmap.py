"""The learned environment map (background) and the learned distortion grid
(port of ``neus2_tpu/ops/envmap.py``; reference read_envmap in
common_device.cuh, the envmap composite at testbed_nerf.cu:1650-1655,
configs/nerf/base.json:76 and :93).

  * envmap: a lat-long RGBA texture composited behind the scene and
    trained with the field;
  * distortion grid: a learned pixel-space uv offset grid added to the
    camera uv before ray generation.

Both are plain differentiable bilinear lookups: their gradients come from
the training loss through autograd, not from dedicated trainers.

``init_envmap`` draws from a torch generator seeded 42, where the JAX
package draws from its threefry key 42: the two draws can never agree, so
parity tests carry the JAX package's envmap across.
"""

from __future__ import annotations

import math

import torch

from neus2_tpu_torch.ops.neus_math import clip
from neus2_tpu_torch.utils.device import constant


def init_envmap(resolution=(16, 32), device="cpu") -> torch.Tensor:
    """(H, W, 4) RGBA lat-long map, near zero (transparent): U(0, 1e-4)
    from a CPU generator seeded 42, moved to ``device``."""
    h, w = resolution
    g = torch.Generator().manual_seed(42)
    return (torch.rand((h, w, 4), generator=g) * 1e-4).to(device)


def _bilinear(grid: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup in grid (H, W, C) at x in [0, W), y in [0, H);
    differentiable in the grid and in x, y."""
    h, w = grid.shape[:2]
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 1)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    fx = clip(x - x0.to(x.dtype), 0.0, 1.0)[..., None]
    fy = clip(y - y0.to(y.dtype), 0.0, 1.0)[..., None]
    return (
        grid[y0, x0] * (1 - fx) * (1 - fy)
        + grid[y0, x1] * fx * (1 - fy)
        + grid[y1, x0] * (1 - fx) * fy
        + grid[y1, x1] * fx * fy
    )


def envmap_lookup(envmap: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """RGBA from the lat-long map for world directions (..., 3)."""
    h, w = envmap.shape[:2]
    norm = torch.linalg.norm(dirs, dim=-1, keepdim=True)
    d = dirs / torch.maximum(norm, constant(1e-8, dirs.dtype, dirs.device))
    phi = torch.atan2(d[..., 1], d[..., 0])  # [-pi, pi]
    theta = torch.arccos(clip(d[..., 2], -1.0, 1.0))  # [0, pi]
    x = (phi / (2 * math.pi) + 0.5) * (w - 1)
    y = theta / math.pi * (h - 1)
    return _bilinear(envmap, x, y)


def composite_envmap_background(envmap: torch.Tensor, dirs: torch.Tensor,
                                bg: torch.Tensor) -> torch.Tensor:
    """background' = env.rgb + bg (1 - env.a) (testbed_nerf.cu:1650-1655)."""
    env = envmap_lookup(envmap, dirs)
    return env[..., :3] + bg * (1.0 - env[..., 3:4])


def init_distortion(resolution=(32, 32), device="cpu") -> torch.Tensor:
    """(H, W, 2) uv offset grid, zero (reference distortion_map)."""
    h, w = resolution
    return torch.zeros((h, w, 2), dtype=torch.float32, device=device)


def apply_distortion(grid: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """uv' = uv + bilinear(grid, uv), uv in [0, 1]^2."""
    h, w = grid.shape[:2]
    return uv + _bilinear(grid, uv[..., 0] * (w - 1), uv[..., 1] * (h - 1))
