"""Render-time exposure and tonemap curves (port of
``neus2_tpu/ops/tonemap.py``; reference render_buffer.cu:254-332).

The reference's render buffer post-processes a frame with sRGB -> linear,
x 2^exposure, a tonemap curve, linear -> sRGB (``tonemap``,
render_buffer.cu:313-332; the curves at 254-310): ACES (Narkowicz's fit),
Hable / Uncharted 2 filmic with the W = 11.2 white point folded in, and
luminance Reinhard, from their published formulas.
"""

from __future__ import annotations

import torch

from neus2_tpu_torch.ops.losses import linear_to_srgb, srgb_to_linear
from neus2_tpu_torch.ops.neus_math import clip

TONEMAP_CURVES = ("identity", "aces", "hable", "reinhard")


def tonemap_curve(x: torch.Tensor, curve: str = "identity") -> torch.Tensor:
    """A tonemap curve on linear radiance (..., 3)."""
    curve = curve.lower()
    if curve == "identity":
        return x
    x = torch.clamp_min(x, 0.0)
    if curve == "aces":
        # Narkowicz's fit x(ax + b) / (x(cx + d) + e) with the reference's
        # 0.6 exposure bias folded into the coefficients.
        a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
        s = 0.6
        return (x * x * (s * s * a) + x * (s * b)) / (x * x * (s * s * c) + x * (s * d) + e)
    if curve == "hable":
        # Uncharted 2 filmic ((x(Ax + CB) + DE) / (x(Ax + B) + DF)) - E/F,
        # normalised by the white point W = 11.2, with a 2x exposure bias:
        # a rational in the biased input.
        A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
        k0 = A * F - A * E
        k1 = C * B * F - B * E
        k3 = A * F
        k4 = B * F
        k5 = D * F * F
        W = 11.2
        white_scale = (k3 * W * W + k4 * W + k5) / (k0 * W * W + k1 * W)
        num = (4.0 * k0 * white_scale) * x * x + (2.0 * k1 * white_scale) * x
        den = (4.0 * k3) * x * x + (2.0 * k4) * x + k5
        return num / den
    if curve == "reinhard":
        y = 0.2126 * x[..., 0:1] + 0.7152 * x[..., 1:2] + 0.0722 * x[..., 2:3]
        return x / (y + 1.0)
    raise ValueError(f"unknown tonemap curve {curve!r}; one of {TONEMAP_CURVES}")


def apply_output_tonemap(rgb_srgb: torch.Tensor, exposure: float = 0.0,
                         curve: str = "identity") -> torch.Tensor:
    """The reference's output pipeline (render_buffer.cu:313-332) on an sRGB
    frame: sRGB -> linear, x 2^exposure, the curve, back to sRGB."""
    if exposure == 0.0 and curve.lower() == "identity":
        return rgb_srgb
    lin = srgb_to_linear(torch.clamp_min(rgb_srgb, 0.0)) * (2.0 ** exposure)
    return linear_to_srgb(clip(tonemap_curve(lin, curve), 0.0, 1.0))
