"""Image quality metrics and the eval target
(port of ``neus2_tpu/ops/image.py``:14-77; reference scripts/common.py:46
mse2psnr, :201-266 SSIM with an 11x11 Gaussian window, scripts/run.py:264-344).

PSNR = -10 log10(MSE) on clipped sRGB renders; SSIM is the mean over an
(H, W, C) pair of the 11x11 Gaussian-window statistics, computed with a
depthwise valid convolution.  On the card the convolution runs in full
fp32: cuDNN would take TF32 by default, so ``ssim`` turns it off for its
own call only.
"""

from __future__ import annotations

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
