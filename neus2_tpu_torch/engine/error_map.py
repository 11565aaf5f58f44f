"""Error-map importance sampling over training images and pixels (port of
the JAX package's ``engine/error_map.py``; reference testbed_nerf.cu:
1740-1765 the loss deposit with a bilinear footprint, 2333-2388
construct_cdf_2d / construct_cdf_1d, 3478-3484 the map reset a window,
3555-3603 the CDF rebuild at step 128 and every 1.5x after).

The reference samples in three stages: an image from a CDF mixed with a
uniform floor (MIN_PMF), a row given the image, a cell given the row (floor
MIN_PDF each).  Here the same joint distribution is one flat (image, cell)
CDF, the product of the three mixed pmfs, and a draw is one
``searchsorted``.  As in the reference, the loss is not divided by the
sampling pdf (testbed_nerf.cu:1901-1906): the sampling reweights the loss on
purpose.

Unlike the JAX package's ``rebuild_cdf``, the rebuild keeps the sharpness
grid, as the reference does (testbed_nerf.cu:3448-3459): the JAX package's
drops it at the first rebuild, which turns the sharpness weighting off.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Fallback resolution; the Testbed sizes the map with ``resolution_for``.
ERROR_MAP_RES = 32

# Uniform-mixture floors (testbed_nerf.cu:2331 MIN_PDF, 3592 MIN_PMF).
MIN_PDF = 0.01
MIN_PMF = 0.1


def resolution_for(n_rays_per_step: int, n_images: int, image_res: int) -> int:
    """Reference sizing: sqrt(sqrt(samples an image gets in the first
    128-step window)) * 3.5, at most the image side
    (testbed_nerf.cu:3479-3482)."""
    n_per_img = max(1, (128 * n_rays_per_step) // max(1, n_images))
    res = int(float(n_per_img) ** 0.25 * 3.5)
    return max(4, min(res, image_res))


class ErrorMapState(NamedTuple):
    error_map: torch.Tensor  # (N_img, R, R) loss deposited this window
    cdf: torch.Tensor  # (N_img * R * R,) inclusive prefix sums
    # Running per-cell max of the image sharpness seen at 3-D hit points
    # ((cascades * G^3,), decayed 0.95 a step); None unless
    # include_sharpness_in_error is on (reference sharpness_grid).
    sharpness_grid: torch.Tensor | None = None

    @property
    def res(self) -> int:
        return self.error_map.shape[1]


def init_error_map(n_images: int, res: int = ERROR_MAP_RES, sharpness_cells: int = 0,
                   device="cpu") -> ErrorMapState:
    """A zero map with a uniform CDF."""
    flat = n_images * res * res
    return ErrorMapState(
        error_map=torch.zeros((n_images, res, res), dtype=torch.float32, device=device),
        cdf=torch.arange(1, flat + 1, dtype=torch.float32, device=device) / flat,
        sharpness_grid=(torch.zeros(sharpness_cells, dtype=torch.float32, device=device)
                        if sharpness_cells else None),
    )


def sharpness_weight_and_update(grid: torch.Tensor, cells: torch.Tensor, sharp: torch.Tensor,
                                valid: torch.Tensor, decay: float = 0.95):
    """-> (per-ray deposit weight, the updated sharpness grid).

    The grid decays 0.95 a step (decay_sharpness_grid_nerf, testbed_nerf.cu:
    3458), each valid ray's hit cell takes the max with the ray's image
    sharpness, and the deposit is scaled by max(sharp / cell sharpness,
    0.01), the cell's sharpness including this ray's own (:1748-1756).
    Rays without a hit in the box (``valid`` false) get weight 1."""
    g = grid * decay
    old = g[cells]
    contrib = torch.where(valid, sharp, torch.zeros_like(sharp))
    g = g.scatter_reduce(0, cells, contrib, reduce="amax", include_self=True)
    grid_sharp = torch.clamp_min(torch.maximum(old, sharp), 1e-20)
    w = torch.where(valid, torch.clamp_min(sharp / grid_sharp, 0.01), torch.ones_like(sharp))
    return w, g


def deposit(state: ErrorMapState, img_idx: torch.Tensor, uv: torch.Tensor,
            loss: torch.Tensor) -> ErrorMapState:
    """Add per-ray losses over the bilinear 4-cell footprint
    (testbed_nerf.cu:1737-1763: the cell clamped to res - 2 so its +1
    neighbours exist, the fractional part as the weight).  The adds go in
    no fixed order on the card (atomics)."""
    r = state.res
    pos = uv * r - 0.5
    pos_floor = torch.floor(pos)
    w = pos - pos_floor
    cx = torch.clamp(pos_floor[:, 0].to(torch.int64), 0, r - 2)
    cy = torch.clamp(pos_floor[:, 1].to(torch.int64), 0, r - 2)
    wx, wy = w[:, 0], w[:, 1]
    img4 = img_idx.repeat(4)
    cy4 = torch.cat([cy, cy, cy + 1, cy + 1])
    cx4 = torch.cat([cx, cx + 1, cx, cx + 1])
    val4 = torch.cat([(1 - wx) * (1 - wy) * loss, wx * (1 - wy) * loss,
                      (1 - wx) * wy * loss, wx * wy * loss])
    em = state.error_map.index_put((img4, cy4, cx4), val4, accumulate=True)
    return state._replace(error_map=em)


def rebuild_cdf(state: ErrorMapState) -> ErrorMapState:
    """The CDF of the reference's three-stage mixed sampling
    (construct_cdf_2d / 1d and the image CDF):

      p(img)       = (1 - MIN_PMF) img_sum / total + MIN_PMF / N
      p(y | img)   = (1 - MIN_PDF) row_sum / img_sum + MIN_PDF / H
      p(x | y, im) = (1 - MIN_PDF) cell / row_sum + MIN_PDF / W

    then a zeroed map, so each CDF reflects one window's losses
    (testbed_nerf.cu:3484).  The sharpness grid is kept."""
    em = state.error_map + 1e-10  # construct_cdf_2d adds 1e-10 a cell
    n, h, w = em.shape
    row_sum = em.sum(2)
    img_sum = row_sum.sum(1)
    total = img_sum.sum()
    p_img = (1.0 - MIN_PMF) * img_sum / total + MIN_PMF / n
    p_y = (1.0 - MIN_PDF) * row_sum / img_sum[:, None] + MIN_PDF / h
    p_x = (1.0 - MIN_PDF) * em / row_sum[:, :, None] + MIN_PDF / w
    cdf = torch.cumsum((p_img[:, None, None] * p_y[:, :, None] * p_x).reshape(-1), 0)
    return state._replace(error_map=torch.zeros_like(state.error_map), cdf=cdf / cdf[-1])


def blocked_cumsum(x: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """The JAX package's two-level prefix sum of a 1-D tensor: cumulative
    sums within blocks of ``block``, plus each block's exclusive prefix of
    the block totals (``torch.cumsum`` up to the summation order)."""
    (n,) = x.shape
    if n <= block:
        return torch.cumsum(x, 0)
    k = -(-n // block)
    xp = torch.nn.functional.pad(x, (0, k * block - n)).reshape(k, block)
    inner = torch.cumsum(xp, 1)
    totals = inner[:, -1]
    offsets = torch.cumsum(totals, 0) - totals
    return (inner + offsets[:, None]).reshape(-1)[:n]


def sample_pixels(state: ErrorMapState, u: torch.Tensor, jitter: torch.Tensor,
                  n_images: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(img_idx (C,), uv (C, 2)) from the CDF at uniforms ``u`` (C,),
    jittered inside the cell by ``jitter`` (C, 2)."""
    r = state.res
    flat = torch.searchsorted(state.cdf, u, side="left")
    flat = torch.clamp_max(flat, n_images * r * r - 1)
    img, cell = flat // (r * r), flat % (r * r)
    cy, cx = cell // r, cell % r
    uv = torch.stack([(cx + jitter[:, 0]) / r, (cy + jitter[:, 1]) / r], dim=-1)
    return img, uv


def should_rebuild(step: int) -> bool:
    """Rebuild at step 128, then at each 1.5x (testbed_nerf.cu:3555-3603)."""
    if step < 128:
        return False
    t = 128
    while t < step:
        t = int(t * 1.5)
    return step == t
