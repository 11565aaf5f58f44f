"""Fixed-shape occupancy-guided ray marching: inverse CDF over the occupied
length (port of ``neus2_tpu/engine/march.py``; reference
testbed_nerf.cu:1263-1449).

Each ray probes ``n_candidates`` coarse intervals of its AABB chord against
the occupancy bitfield, then draws exactly ``budget`` stratified samples
from the inverse CDF of its occupied length.  The random draws (probe
jitter ``u_c`` and stratified ``xi``) are arguments, so tests can inject
the JAX package's draws.

The exponential spacing's powers are taken in float64 and rounded once
(the JAX package takes them in float32), so that the card and the CPU
place the candidates alike and a step on one holds against a step on the
other (``step_agreement.py`` reads what each such form buys on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from neus2_tpu_torch.constants import MIN_CONE_STEPSIZE
from neus2_tpu_torch.engine.occupancy import OccupancyGrid, occupancy_at
from neus2_tpu_torch.ops.warp import AABB


def cone_angle_for_scene(aabb_scale: float, constant: float = 1.0 / 256.0) -> float:
    """0 for unit scenes (reference testbed_nerf.cu:3090)."""
    return constant if aabb_scale > 1 else 0.0


class MarchedSamples(NamedTuple):
    t: torch.Tensor  # (R, B) sample distance along the ray
    dt: torch.Tensor  # (R, B) step size at each sample
    positions: torch.Tensor  # (R, B, 3)
    mask: torch.Tensor  # (R, B) validity
    n_valid: torch.Tensor  # (R,)


class CandidateProbe(NamedTuple):
    t0: torch.Tensor  # (R, C) candidate interval starts
    seg: torch.Tensor  # (R, C) occupied interval lengths
    total: torch.Tensor  # (R,) total occupied length
    hit: torch.Tensor  # (R,) bool


def coarse_intervals(tmin: torch.Tensor, tmax: torch.Tensor, n_candidates: int,
                     cone_angle: float):
    """Candidate interval starts and lengths (R, C) spanning the chord:
    uniform without a cone angle, exponentially spaced with one."""
    steps = torch.arange(n_candidates, dtype=torch.float32, device=tmin.device)[None]
    if cone_angle == 0.0:
        span = torch.clamp_min(tmax - tmin, 0.0)
        dt = torch.clamp_min(span / n_candidates, MIN_CONE_STEPSIZE)[:, None]
        t0 = tmin[:, None] + steps * dt
        return t0, dt.expand_as(t0)
    t_lo = torch.clamp_min(tmin, 10.0 * MIN_CONE_STEPSIZE)
    t_hi = torch.maximum(tmax, t_lo * (1.0 + 1e-4))
    # The float32 r and r^i as the JAX package takes them, each rounded
    # once from float64: the card's float32 pow rounds r otherwise than the
    # CPU's, and r^i carries that i-fold (starts 6e-5 apart at i = 511).
    r = ((t_hi / t_lo).double() ** (1.0 / n_candidates)).float()
    t0 = t_lo[:, None] * (r.double()[:, None] ** steps.double()).float()
    return t0, t0 * (r[:, None] - 1.0)


def probe_candidates(origins: torch.Tensor, directions: torch.Tensor,
                     aabb: AABB, occupancy: OccupancyGrid | None,
                     n_candidates: int, u_c: torch.Tensor | None,
                     cone_angle: float = 0.0, near: float = 0.0) -> CandidateProbe:
    """Probe the coarse intervals at ``t0 + u_c * dt`` (``u_c`` (R, C)
    uniforms during training; None probes the midpoints)."""
    tmin, tmax = aabb.ray_intersect(origins, directions)
    tmin = torch.clamp_min(tmin, near)
    enters = tmin < tmax
    t0, dt_c = coarse_intervals(tmin, tmax, n_candidates, cone_angle)
    mid = t0 + (0.5 if u_c is None else u_c) * dt_c
    valid_c = (mid < tmax[:, None]) & enters[:, None]
    if occupancy is not None:
        pos_c = origins[:, None, :] + mid[..., None] * directions[:, None, :]
        valid_c &= occupancy_at(occupancy, pos_c)
    seg = torch.where(valid_c, dt_c, torch.zeros_like(dt_c))
    total = seg.sum(-1)
    return CandidateProbe(t0=t0, seg=seg, total=total, hit=(total > 0.0) & enters)


def march_probe(origins: torch.Tensor, directions: torch.Tensor, aabb: AABB,
                occupancy: OccupancyGrid | None, n_candidates: int,
                cone_angle: float = 0.0, near: float = 0.0) -> torch.Tensor:
    """Total occupied length per ray (R,) at the deterministic candidate
    midpoints, the march without sample draws.  A ray with 0 draws
    mask-all-False samples and composites to nothing, so the render path
    skips its field evaluation (reference alive-ray compaction,
    testbed_nerf.cu:2479-2595)."""
    return probe_candidates(origins, directions, aabb, occupancy, n_candidates,
                            None, cone_angle=cone_angle, near=near).total


def draw_from_probe(probe: CandidateProbe, origins: torch.Tensor,
                    directions: torch.Tensor, budget: int,
                    xi: torch.Tensor | None) -> MarchedSamples:
    """``budget`` stratified samples per ray from the probe's occupied-length
    inverse CDF (``xi`` (R, budget) uniforms; None takes stratum centers)."""
    R, n_candidates = probe.t0.shape
    cum = torch.cumsum(probe.seg, dim=-1)
    total = probe.total
    if xi is None:
        xi = torch.full((R, budget), 0.5, device=cum.device)
    strata = torch.arange(budget, dtype=torch.float32, device=cum.device)[None]
    frac = (strata + xi) / budget
    # Strictly below total: the top stratum must not select past the end.
    u = torch.minimum(frac * total[:, None], total[:, None] * (1.0 - 1e-7))
    # Count of cum <= u per draw (cum is non-decreasing).
    idx = torch.searchsorted(cum.contiguous(), u.contiguous(), right=True)
    idx = torch.clamp_max(idx, n_candidates - 1)
    seg_at = torch.gather(probe.seg, 1, idx)
    cum_before = torch.gather(cum, 1, idx) - seg_at
    t = torch.gather(probe.t0, 1, idx) + torch.minimum(
        torch.clamp_min(u - cum_before, 0.0), seg_at
    )
    dt = torch.clamp_min(total[:, None] / budget, 1e-10).expand_as(t)
    mask = probe.hit[:, None].expand_as(t)
    pos = origins[:, None, :] + t[..., None] * directions[:, None, :]
    return MarchedSamples(t=t, dt=dt, positions=pos, mask=mask,
                          n_valid=mask.sum(-1))


def march_rays(origins: torch.Tensor, directions: torch.Tensor, aabb: AABB,
               occupancy: OccupancyGrid | None, n_candidates: int, budget: int,
               u_c: torch.Tensor | None, xi: torch.Tensor | None,
               cone_angle: float = 0.0, near: float = 0.0) -> MarchedSamples:
    """Probe, then draw ``budget`` samples per ray."""
    probe = probe_candidates(origins, directions, aabb, occupancy, n_candidates,
                             u_c, cone_angle=cone_angle, near=near)
    return draw_from_probe(probe, origins, directions, budget, xi)
