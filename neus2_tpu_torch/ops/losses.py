"""RGB, eikonal and mask losses, the sRGB transfer functions and the
training target's compositing (port of ``neus2_tpu/ops/losses.py``;
reference testbed_nerf.cu:280-380, 1458-1473, 1669-1677, 1700-1731)."""

from __future__ import annotations

import torch

from neus2_tpu_torch.ops.neus_math import clip


def l2_loss(target: torch.Tensor, prediction: torch.Tensor) -> torch.Tensor:
    d = prediction - target
    return d * d


def l1_loss(target: torch.Tensor, prediction: torch.Tensor) -> torch.Tensor:
    return torch.abs(prediction - target)


def huber_loss(
    target: torch.Tensor, prediction: torch.Tensor, alpha: float = 1.0
) -> torch.Tensor:
    d = torch.abs(prediction - target)
    return torch.where(d > alpha, alpha * (d - 0.5 * alpha), 0.5 * d * d)


def log_l1_loss(target: torch.Tensor, prediction: torch.Tensor) -> torch.Tensor:
    return torch.log(1.0 + torch.abs(prediction - target))


def relative_l2_loss(target: torch.Tensor, prediction: torch.Tensor) -> torch.Tensor:
    d = prediction - target
    return d * d / (prediction * prediction + 1e-2)


def mape_loss(target: torch.Tensor, prediction: torch.Tensor) -> torch.Tensor:
    return torch.abs(prediction - target) / (torch.abs(target) + 1e-2)


def smape_loss(target: torch.Tensor, prediction: torch.Tensor) -> torch.Tensor:
    denom = 0.5 * (torch.abs(prediction) + torch.abs(target)) + 1e-2
    return torch.abs(prediction - target) / denom


_RGB_LOSSES = {
    "L2": l2_loss,
    "L1": l1_loss,
    # Huber with alpha=0.1 scaled by 1/5 (testbed_nerf.cu:1469).
    "Huber": lambda t, p: huber_loss(t, p, alpha=0.1) / 5.0,
    "LogL1": log_l1_loss,
    "RelativeL2": relative_l2_loss,
    "Mape": mape_loss,
    "Smape": smape_loss,
}


def rgb_loss(
    target: torch.Tensor, prediction: torch.Tensor, loss_type: str = "Huber"
) -> torch.Tensor:
    """Per-channel RGB loss, shape-preserving."""
    try:
        fn = _RGB_LOSSES[loss_type]
    except KeyError:
        raise ValueError(
            f"unknown rgb loss {loss_type!r}; one of {sorted(_RGB_LOSSES)}"
        ) from None
    return fn(target, prediction)


def eikonal_loss(normals: torch.Tensor, sample_mask: torch.Tensor) -> torch.Tensor:
    """Per ray, the mean eikonal residual (||grad sdf|| - 1)^2 over its
    valid samples (testbed_nerf.cu:1906-1962).  normals (R, S, 3),
    sample_mask (R, S) bool -> (R,)."""
    norm = torch.sqrt((normals * normals).sum(-1) + 1e-6)
    residual = torch.where(sample_mask, (norm - 1.0) ** 2, torch.zeros_like(norm))
    count = torch.clamp_min(sample_mask.sum(-1), 1)
    return residual.sum(-1) / count


def mask_bce_loss(weight_sum: torch.Tensor, mask_gt: torch.Tensor) -> torch.Tensor:
    """BCE between the clipped ray opacity and the ground-truth mask."""
    w = clip(weight_sum, 1e-4, 1.0 - 1e-4)
    return -(mask_gt * torch.log(w) + (1.0 - mask_gt) * torch.log(1.0 - w))


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(
        c <= 0.04045,
        c / 12.92,
        torch.pow((torch.clamp_min(c, 0.04045) + 0.055) / 1.055, 2.4),
    )


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    return torch.where(
        c <= 0.0031308,
        12.92 * c,
        1.055 * torch.pow(torch.clamp_min(c, 0.0031308), 1.0 / 2.4) - 0.055,
    )


def composite_background(rgb: torch.Tensor, alpha: torch.Tensor, trans: torch.Tensor,
                         background: torch.Tensor) -> torch.Tensor:
    """The remaining transmittance composited against a background colour
    (``alpha`` is unused, as in the JAX package)."""
    del alpha
    return rgb + trans[..., None] * background


def target_from_rgba(texsamp: torch.Tensor, background: torch.Tensor) -> torch.Tensor:
    """The sRGB training target of a premultiplied linear RGBA texel over a
    linear background: linear_to_srgb(rgb / a) * a + (1 - a) *
    linear_to_srgb(bg) (testbed_nerf.cu:1669-1677)."""
    a = texsamp[..., 3:4]
    bg_srgb = linear_to_srgb(background)
    safe_a = torch.where(a > 0, a, torch.ones_like(a))
    fg = linear_to_srgb(texsamp[..., :3] / safe_a) * a
    return torch.where(a > 0, fg + (1.0 - a) * bg_srgb, bg_srgb)
