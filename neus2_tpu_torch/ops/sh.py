"""Real spherical-harmonics direction encoding up to degree 4, and the
other small tcnn encodings (port of ``neus2_tpu/ops/sh.py``; reference
tcnn spherical_harmonics.h, frequency.h, oneblob.h, triangle_wave.h and
the [MOD] HannWindowFrequency).

The input direction is warped into [0,1]^3 and unwarped via x = 2*in - 1.
Degrees above 4 are not used by any configuration of the port yet.
"""

from __future__ import annotations

import math

import torch


def sh_encode(dirs_warped: torch.Tensor, degree: int) -> torch.Tensor:
    """dirs_warped (..., 3) in [0,1] -> (..., degree**2)."""
    if not 1 <= degree <= 4:
        raise ValueError(f"SH degree must be in [1, 4], got {degree}")
    d = dirs_warped * 2.0 - 1.0
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z

    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if degree >= 3:
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * x2 - 0.54627421529603959 * y2,
        ]
    if degree >= 4:
        out += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    return torch.stack(out, dim=-1)


def sh_output_dim(degree: int) -> int:
    return degree * degree


def frequency_encode(x: torch.Tensor, n_frequencies: int) -> torch.Tensor:
    """NeRF positional encoding [sin, cos](2^k pi x): (..., D) -> (..., D * K * 2)."""
    freqs = 2.0 ** torch.arange(n_frequencies, dtype=x.dtype, device=x.device) * math.pi
    ang = x[..., None] * freqs  # (..., D, K)
    return torch.stack([torch.sin(ang), torch.cos(ang)], -1).reshape(*x.shape[:-1], -1)


def hann_window_frequency_encode(x: torch.Tensor, n_frequencies: int,
                                 alpha: float | torch.Tensor) -> torch.Tensor:
    """The frequency encoding with band k weighted by the Hann window
    0.5 (1 - cos(pi clip(alpha - k, 0, 1))) (coarse-to-fine annealing)."""
    k = torch.arange(n_frequencies, dtype=x.dtype, device=x.device)
    w = 0.5 * (1.0 - torch.cos(math.pi * torch.clamp(alpha - k, 0.0, 1.0)))
    ang = x[..., None] * (2.0**k * math.pi)
    out = torch.stack([torch.sin(ang), torch.cos(ang)], -1) * w[None, :, None]
    return out.reshape(*x.shape[:-1], -1)


def oneblob_encode(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """OneBlob: a Gaussian blob (sigma 1 / n_bins) a dimension over
    ``n_bins`` bin centres, divided by ``n_bins``."""
    centers = (torch.arange(n_bins, dtype=x.dtype, device=x.device) + 0.5) / n_bins
    sigma = 1.0 / n_bins
    d = x[..., None] - centers
    out = torch.exp(-0.5 * (d / sigma) ** 2) / (sigma * math.sqrt(2.0 * math.pi))
    return out.reshape(*x.shape[:-1], -1) / n_bins


def trianglewave_encode(x: torch.Tensor, n_frequencies: int) -> torch.Tensor:
    """TriangleWave: |2 (v - floor(v + 0.5))| at v = 2^k x."""
    v = x[..., None] * 2.0 ** torch.arange(n_frequencies, dtype=x.dtype, device=x.device)
    return torch.abs(2.0 * (v - torch.floor(v + 0.5))).reshape(*x.shape[:-1], -1)
