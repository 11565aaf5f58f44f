"""RGB and mask losses and the sRGB transfer functions
(port of ``neus2_tpu/ops/losses.py``; reference testbed_nerf.cu:280-380,
1458-1473, 1700-1731)."""

from __future__ import annotations

import torch

from neus2_tpu_torch.ops.neus_math import clip


def huber_loss(
    target: torch.Tensor, prediction: torch.Tensor, alpha: float = 1.0
) -> torch.Tensor:
    d = torch.abs(prediction - target)
    return torch.where(d > alpha, alpha * (d - 0.5 * alpha), 0.5 * d * d)


_RGB_LOSSES = {
    "L2": lambda t, p: (p - t) * (p - t),
    "L1": lambda t, p: torch.abs(p - t),
    # Huber with alpha=0.1 scaled by 1/5 (testbed_nerf.cu:1469).
    "Huber": lambda t, p: huber_loss(t, p, alpha=0.1) / 5.0,
    "LogL1": lambda t, p: torch.log(1.0 + torch.abs(p - t)),
    "RelativeL2": lambda t, p: (p - t) * (p - t) / (p * p + 1e-2),
    "Mape": lambda t, p: torch.abs(p - t) / (torch.abs(t) + 1e-2),
    "Smape": lambda t, p: torch.abs(p - t)
    / (0.5 * (torch.abs(p) + torch.abs(t)) + 1e-2),
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
