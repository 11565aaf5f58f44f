"""Coordinate warps between world space and network-input space
(port of ``neus2_tpu/ops/warp.py``; reference testbed_nerf.cu:445-492)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from neus2_tpu_torch.constants import MAX_CONE_STEPSIZE, MIN_CONE_STEPSIZE
from neus2_tpu_torch.utils.device import constant


class AABB(NamedTuple):
    """Axis-aligned box with corners kept as Python floats, so one box serves
    tensors on any device."""

    lo: tuple[float, float, float]
    hi: tuple[float, float, float]

    @property
    def diag(self) -> tuple[float, float, float]:
        return tuple(h - l for l, h in zip(self.lo, self.hi))

    def _lo_hi(self, like: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return (constant(tuple(self.lo), like.dtype, like.device),
                constant(tuple(self.hi), like.dtype, like.device))

    def relative_pos(self, pos: torch.Tensor) -> torch.Tensor:
        lo, hi = self._lo_hi(pos)
        return (pos - lo) / (hi - lo)

    def ray_intersect(
        self, origin: torch.Tensor, direction: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Slab test -> (tmin, tmax); the ray misses iff tmin > tmax."""
        lo, hi = self._lo_hi(origin)
        inv_d = 1.0 / direction
        t0 = (lo - origin) * inv_d
        t1 = (hi - origin) * inv_d
        tmin = torch.minimum(t0, t1).amax(dim=-1)
        tmax = torch.maximum(t0, t1).amin(dim=-1)
        return tmin, tmax


def unit_aabb() -> AABB:
    return AABB((0.0,) * 3, (1.0,) * 3)


def scene_aabb(aabb_scale: float) -> AABB:
    """The reference's scene box: the unit cube inflated around (0.5,)*3."""
    half = 0.5 * float(aabb_scale)
    return AABB((0.5 - half,) * 3, (0.5 + half,) * 3)


def warp_position(pos: torch.Tensor, aabb: AABB) -> torch.Tensor:
    return aabb.relative_pos(pos)


def unwarp_position(pos: torch.Tensor, aabb: AABB) -> torch.Tensor:
    lo, hi = aabb._lo_hi(pos)
    return lo + pos * (hi - lo)


def warp_direction(direction: torch.Tensor) -> torch.Tensor:
    return (direction + 1.0) * 0.5


def unwarp_direction(direction: torch.Tensor) -> torch.Tensor:
    return direction * 2.0 - 1.0


def warp_dt(dt: torch.Tensor) -> torch.Tensor:
    """dt normalized by the cone step sizes (testbed_nerf.cu:470-492)."""
    return (dt - MIN_CONE_STEPSIZE) / (MAX_CONE_STEPSIZE - MIN_CONE_STEPSIZE)


def unwarp_dt(dt: torch.Tensor) -> torch.Tensor:
    return dt * (MAX_CONE_STEPSIZE - MIN_CONE_STEPSIZE) + MIN_CONE_STEPSIZE
