"""Core NeuS math: SDF -> alpha, compositing, SDF -> density
(port of ``neus2_tpu/ops/neus_math.py``; reference testbed_nerf.cu:1475-1998,
common_operation.cuh:307-324).

Clipping goes through ``clip``: ``torch.minimum``/``torch.maximum`` split the
gradient evenly at exact ties, as JAX's clip does (``torch.clamp`` would
pass all of it), so both packages differentiate the same function.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from neus2_tpu_torch.constants import TRAIN_TRANSMITTANCE_EPS
from neus2_tpu_torch.utils.device import constant


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """JAX's clip with its gradient at ties: min(max(x, lo), hi)."""
    lo_t = constant(float(lo), x.dtype, x.device)
    hi_t = constant(float(hi), x.dtype, x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def cos_anneal_ratio(step: int, anneal_end: int) -> float:
    """Cosine annealing ratio (reference nerf_network.h:1119-1129)."""
    if anneal_end == 0:
        return 1.0
    return min(1.0, float(step) / float(anneal_end))


def neus_alpha(
    sdf: torch.Tensor,
    normal: torch.Tensor,
    direction: torch.Tensor,
    dt: torch.Tensor,
    inv_s: torch.Tensor,
    anneal: float,
) -> torch.Tensor:
    """NeuS SDF -> opacity (reference testbed_nerf.cu:1590-1617)."""
    true_cos = (direction * normal).sum(-1)
    iter_cos = -(
        torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - anneal)
        + torch.relu(-true_cos) * anneal
    )
    est_next_sdf = sdf + iter_cos * dt * 0.5
    est_prev_sdf = sdf - iter_cos * dt * 0.5
    next_cdf = torch.sigmoid(est_next_sdf * inv_s)
    prev_cdf = torch.sigmoid(est_prev_sdf * inv_s)
    p = prev_cdf - next_cdf
    return clip((p + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)


def variance_to_inv_s(variance_param: torch.Tensor) -> torch.Tensor:
    """inv_s = exp(10 * variance) (reference testbed_nerf.cu:1590)."""
    return torch.exp(10.0 * variance_param)


def sdf_to_logistic_density(sdf: torch.Tensor, inv_s: torch.Tensor) -> torch.Tensor:
    """density = s * sig(s*sdf) * (1 - sig(s*sdf))."""
    sig = torch.sigmoid(sdf * inv_s)
    return inv_s * sig * (1.0 - sig)


class CompositeOut(NamedTuple):
    rgb: torch.Tensor  # (R, 3) composited color (before background)
    depth: torch.Tensor  # (R,)
    weight_sum: torch.Tensor  # (R,)
    weights: torch.Tensor  # (R, S)
    trans: torch.Tensor  # (R,) transmittance after the last sample
    sample_mask: torch.Tensor  # (R, S) mask after the early-out


def composite_rays(
    rgb: torch.Tensor,  # (R, S, 3)
    alpha: torch.Tensor,  # (R, S)
    t_vals: torch.Tensor,  # (R, S)
    mask: torch.Tensor,  # (R, S) bool
    trans_eps: float = TRAIN_TRANSMITTANCE_EPS,
) -> CompositeOut:
    """Front-to-back compositing with the exclusive cumprod of (1 - alpha)
    and the early-out once transmittance drops below ``trans_eps``
    (reference testbed_nerf.cu:1572-1628)."""
    alpha = torch.where(mask, alpha, torch.zeros_like(alpha))
    one_minus = 1.0 - alpha
    t_before = torch.cumprod(
        torch.cat([torch.ones_like(one_minus[..., :1]), one_minus[..., :-1]], -1),
        dim=-1,
    )
    live = t_before >= trans_eps
    eff_mask = mask & live
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))
    weights = alpha * t_before
    rgb_ray = (weights[..., None] * rgb).sum(-2)
    depth_ray = (weights * t_vals).sum(-1)
    weight_sum = weights.sum(-1)
    trans = torch.where(live, 1.0 - alpha, torch.ones_like(alpha)).prod(-1)
    return CompositeOut(rgb_ray, depth_ray, weight_sum, weights, trans, eff_mask)
