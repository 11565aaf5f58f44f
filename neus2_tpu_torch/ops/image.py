"""Image quality metrics and the eval target
(port of ``neus2_tpu/ops/image.py``:14-77 and :106; reference
scripts/common.py:46 mse2psnr, :201-266 SSIM with an 11x11 Gaussian window,
scripts/run.py:264-344), and the load-time sharpness maps of the error
map's sharpness weighting and the unsharp filter of ``nerf.sharpen``
(``neus2_tpu/ops/image.py``:80).

PSNR = -10 log10(MSE) on clipped sRGB renders; SSIM is the mean over an
(H, W, C) pair of the 11x11 Gaussian-window statistics, computed with a
depthwise valid convolution.  On the card the convolution runs in full
fp32: cuDNN would take TF32 by default, so ``ssim`` turns it off for its
own call only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from neus2_tpu_torch.ops.losses import linear_to_srgb


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a.to(torch.float32) - b.to(torch.float32)
    return (d * d).mean()


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """PSNR for images in [0, 1]."""
    return -10.0 * torch.log10(torch.clamp_min(mse(a, b), 1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device="cpu") -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2.0 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) or (H, W) image pair."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if a.dim() == 2:
        a, b = a[..., None], b[..., None]
    n_ch = a.shape[-1]
    kernel = _gaussian_kernel(device=a.device)[None, None].expand(n_ch, 1, -1, -1)

    def filt(img):  # depthwise valid convolution, (H, W, C) -> (H', W', C)
        out = F.conv2d(img.permute(2, 0, 1)[None], kernel, groups=n_ch)
        return out[0].permute(1, 2, 0)

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        mu_a, mu_b = filt(a), filt(b)
        mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
        sigma_a2 = filt(a * a) - mu_a2
        sigma_b2 = filt(b * b) - mu_b2
        sigma_ab = filt(a * b) - mu_ab
    num = (2.0 * mu_ab + c1) * (2.0 * sigma_ab + c2)
    den = (mu_a2 + mu_b2 + c1) * (sigma_a2 + sigma_b2 + c2)
    return (num / den).mean()


def srgb_eval_target(tex: torch.Tensor) -> torch.Tensor:
    """Premultiplied-linear RGBA texels -> the sRGB-on-black eval target:
    linear -> sRGB of the un-premultiplied colour, re-premultiplied over
    black (reference scripts/run.py:299-320)."""
    a = tex[..., 3:4]
    safe = torch.where(a > 0, a, torch.ones_like(a))
    return torch.where(a > 0, linear_to_srgb(tex[..., :3] / safe) * a,
                       torch.zeros_like(tex[..., :3]))


def sharpen_images(images: np.ndarray, amount: float) -> np.ndarray:
    """The reference's load-time unsharp filter on (N, H, W, C) host images
    (sharpen kernel, nerf_loader.cu:103-123, 808-825):
    max(0, (c p - left - up - right - down) / (c - 4)) with the centre
    weight c = 4 + 1 / amount (5 strong ... inf none).  Edge pixels clamp
    per axis (the reference's flat-index arithmetic wraps rows at the
    border: a quirk, not a contract)."""
    if amount <= 0.0:
        return images
    center_w = 4.0 + 1.0 / amount
    p = np.pad(images.astype(np.float32), ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    out = (center_w * images - p[:, :-2, 1:-1] - p[:, 2:, 1:-1] - p[:, 1:-1, :-2]
           - p[:, 1:-1, 2:]) * (1.0 / (center_w - 4.0))
    return np.maximum(out, 0.0).astype(images.dtype)


def sharpness_maps(images, resolution: tuple[int, int] = (128, 72)) -> np.ndarray:
    """Per-image variance-of-Laplacian sharpness grids, on the host at load
    (reference compute_sharpness, nerf_loader.cu:129-169: rec.709 luma, the
    4-neighbour Laplacian over the interior, the variance in each cell of a
    128 x 72 grid whose pixel range x*W/rw is clamped to [1, W-2]).

    ``images`` (N, H, W, C >= 3) -> (N, rh, rw) float32, (rw, rh) =
    ``resolution``; cell sums through integral images."""
    imgs = np.asarray(images, np.float32)
    n, h, w = imgs.shape[:3]
    rw, rh = resolution
    lum = imgs[..., 0] * 0.2126 + imgs[..., 1] * 0.7152 + imgs[..., 2] * 0.0722
    lap = np.zeros_like(lum)
    lap[:, 1:-1, 1:-1] = (4.0 * lum[:, 1:-1, 1:-1] - lum[:, :-2, 1:-1] - lum[:, 2:, 1:-1]
                          - lum[:, 1:-1, :-2] - lum[:, 1:-1, 2:])
    ii = np.zeros((n, h + 1, w + 1), np.float64)
    ii2 = np.zeros((n, h + 1, w + 1), np.float64)
    ii[:, 1:, 1:] = lap.cumsum(1).cumsum(2)
    ii2[:, 1:, 1:] = (lap * lap).cumsum(1).cumsum(2)
    xs = np.arange(rw + 1) * w // rw
    ys = np.arange(rh + 1) * h // rh
    x1, x2 = np.maximum(xs[:-1], 1), np.minimum(xs[1:], w - 2)
    y1, y2 = np.maximum(ys[:-1], 1), np.minimum(ys[1:], h - 2)

    def rect(a):  # (N, rh, rw) sums over [y1, y2) x [x1, x2)
        return (a[:, y2[:, None], x2[None, :]] - a[:, y1[:, None], x2[None, :]]
                - a[:, y2[:, None], x1[None, :]] + a[:, y1[:, None], x1[None, :]])

    cnt = np.maximum((y2 - y1)[:, None] * (x2 - x1)[None, :], 1).astype(np.float64)
    m = rect(ii) / cnt
    return np.maximum(rect(ii2) / cnt - m * m, 0.0).astype(np.float32)
