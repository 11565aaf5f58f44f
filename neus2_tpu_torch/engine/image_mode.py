"""Image-fit mode: regress rgb(x, y) of one image with a 2-D hash grid and
an MLP (port of ``neus2_tpu/engine/image_mode.py``; reference
src/testbed_image.cu: train_image :220 samples uniform pixel positions,
fetches bilinear targets and fits under RelativeL2; the render evaluates
the network over the pixel grid).

``hash2d_encode`` is a ``torch.autograd.Function`` with a hand-built
backward.  The JAX package takes this gradient from plain autodiff (an XLA
scatter-add, no Pallas kernel).  Torch's own backward of a gather,
``index_put_(accumulate=True)``, adds with float atomics on the card, so
its sums change from run to run.  The backward here instead sums each
level's table gradient through the sort and the exact-fp32 segment-sum
kernel (kernel 4, ``ops/segment_tile.py::segment_sum_planar_rows``): one
launch a level, deterministic, with no capacity window, and held against
its plain version like every kernel of the port.  On the CPU the sum is
``index_add_``.

The table initialisation is the port's own seeded draw; parity tests carry
the JAX package's parameters across.  The position batch is drawn from an
explicit ``torch.Generator`` or given (``pos``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from neus2_tpu_torch.engine.sdf_mode import ADAM_EPS, fit_loss
from neus2_tpu_torch.models.mlp import apply_mlp, init_mlp
from neus2_tpu_torch.ops.image import psnr
from neus2_tpu_torch.ops.scatter import level_table_grad
from neus2_tpu_torch.utils.device import constant, resolve_device
from neus2_tpu_torch.utils.optim import plain_adam_apply, plain_adam_init, value_and_grads

_PRIMES = (1, 2654435761)  # grid.h fast_hash primes, the first two dimensions
_U32 = 0xFFFFFFFF
# (dx, dy) of the four bilinear corners, in the JAX package's summation order.
_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


@dataclasses.dataclass(frozen=True)
class Image2DConfig:
    n_levels: int = 12
    n_features_per_level: int = 2
    log2_hashmap_size: int = 18
    base_resolution: int = 16
    per_level_scale: float = 1.75
    hidden_dim: int = 64
    n_hidden: int = 2
    lr: float = 1e-2
    batch_size: int = 1 << 16

    def level_tables(self) -> list[tuple[int, int]]:
        """[(resolution, rows)] per level: the reference's sizing rule
        (grid.h constructor) in 2-D, dense while res^2 fits the table."""
        out = []
        for lvl in range(self.n_levels):
            scale = (math.exp2(lvl * math.log2(self.per_level_scale)) * self.base_resolution
                     - 1.0)
            res = int(math.ceil(scale)) + 1
            rows = min(((res * res + 7) // 8) * 8, 1 << self.log2_hashmap_size)
            out.append((res, rows))
        return out


def init_image_params(generator: torch.Generator, config: Image2DConfig, device="cpu"):
    """{"tables": per-level (rows, F) ~ U(-1e-4, 1e-4), "mlp": He-uniform}
    drawn from ``generator`` on its device, moved to ``device``."""
    tables = [
        (torch.rand((rows, config.n_features_per_level), generator=generator,
                    device=generator.device) * 2e-4 - 1e-4).to(device)
        for _, rows in config.level_tables()
    ]
    mlp = init_mlp(generator, config.n_levels * config.n_features_per_level, config.hidden_dim,
                   config.n_hidden, 3, device=device)
    return {"tables": tables, "mlp": mlp}


def _corner_index(corner: torch.Tensor, res: int, rows: int) -> torch.Tensor:
    """Table row of integer corners (N, 2), clipped to [0, res - 1]: x +
    y res on a dense level, else the uint32 XOR-prime hash mod rows, taken
    in int64 with each product masked to its low 32 bits (exact: the
    coordinates are below 2^31)."""
    if res * res <= rows:
        return corner[:, 0] + corner[:, 1] * res
    return (((corner[:, 0] * _PRIMES[0]) & _U32) ^ ((corner[:, 1] * _PRIMES[1]) & _U32)) % rows


def _level_corners(pos: torch.Tensor, res: int, rows: int):
    """[(row (N,), weight (N,))] of the four corners, in summation order."""
    scaled = pos * (res - 1)
    p0 = torch.floor(scaled).to(torch.int64)
    frac = scaled - p0
    out = []
    for dx, dy in _CORNERS:
        corner = torch.clamp(p0 + constant((dx, dy), torch.int64, pos.device), 0, res - 1)
        wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
        wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
        out.append((_corner_index(corner, res, rows), wx * wy))
    return out


class _Hash2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, config, pos, *tables):
        feats, saved = [], []
        for (res, rows), table in zip(config.level_tables(), tables):
            corners = _level_corners(pos, res, rows)
            feat = 0.0
            for idx, w in corners:
                feat = feat + w[:, None] * table[idx]
            feats.append(feat)
            saved.append(corners)
        ctx.config, ctx.saved = config, saved
        return torch.cat(feats, dim=-1)

    @staticmethod
    def backward(ctx, ct):
        f = ctx.config.n_features_per_level
        grads = []
        for lvl, ((_, rows), corners) in enumerate(zip(ctx.config.level_tables(), ctx.saved)):
            if not ctx.needs_input_grad[2 + lvl]:
                grads.append(None)
                continue
            ctf = ct[:, lvl * f:(lvl + 1) * f]
            idx = torch.cat([i for i, _ in corners])
            upd = torch.cat([w[:, None] * ctf for _, w in corners])
            grads.append(level_table_grad(idx, upd, rows))
        return (None, None, *grads)


def hash2d_encode(tables, pos: torch.Tensor, config: Image2DConfig) -> torch.Tensor:
    """(N, 2) positions in [0, 1]^2 -> (N, L * F) bilinear multiresolution
    features; differentiable in the tables (not in ``pos``)."""
    return _Hash2D.apply(config, pos, *tables)


def image_forward(params, pos: torch.Tensor, config: Image2DConfig) -> torch.Tensor:
    return apply_mlp(params["mlp"], hash2d_encode(params["tables"], pos, config))


def _bilinear_fetch(img: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Bilinear target at continuous uv (testbed_image.cu eval_image)."""
    h, w = img.shape[:2]
    x = pos[:, 0] * (w - 1)
    y = pos[:, 1] * (h - 1)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)


def image_fit_step(params, opt_state, image: torch.Tensor, config: Image2DConfig,
                   generator: torch.Generator | None = None, pos: torch.Tensor | None = None):
    """One fit step on ``config.batch_size`` positions -> (params,
    opt_state, loss): RelativeL2 against bilinear targets, Adam at
    ``config.lr`` with eps 1e-15.  The positions are ``pos``, or uniform
    draws from ``generator`` on the image's device."""
    if pos is None:
        pos = torch.rand((config.batch_size, 2), generator=generator, device=image.device)
    target = _bilinear_fetch(image, pos)
    loss, grads = value_and_grads(
        lambda p: fit_loss(image_forward(p, pos, config), target, "relative_l2"), params)
    params, opt_state = plain_adam_apply(params, opt_state, grads, config.lr, ADAM_EPS)
    return params, opt_state, loss


@torch.no_grad()
def render_image_fit(params, config: Image2DConfig, resolution, chunk: int = 1 << 16):
    """The fitted network over the (W, H) pixel centres -> (H, W, 3)."""
    w, h = resolution
    dev = params["mlp"]["layers"][0]["w"].device
    u = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    v = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    uu, vv = torch.meshgrid(u, v, indexing="xy")
    pos = torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=-1)
    out = [image_forward(params, p, config) for p in torch.split(pos, chunk)]
    return torch.cat(out).reshape(h, w, 3)


def fit_image(image: np.ndarray, n_steps: int = 1000, config: Image2DConfig | None = None,
              seed: int = 0, verbose: bool = True, device="cuda"):
    """Fit rgb(x, y) to an (H, W, >=3) float image on ``device`` ->
    (params, reconstruction PSNR in dB)."""
    dev = resolve_device(device)
    config = config or Image2DConfig()
    img = torch.as_tensor(np.asarray(image[..., :3], np.float32), device=dev)
    params = init_image_params(torch.Generator().manual_seed(seed), config, dev)
    opt_state = plain_adam_init(params)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for step in range(n_steps):
        params, opt_state, loss = image_fit_step(params, opt_state, img, config, generator=gen)
        if verbose and (step + 1) % 200 == 0:
            print(f"image-fit step {step + 1}: loss {float(loss):.3e}", flush=True)
    h, w = image.shape[:2]
    recon = render_image_fit(params, config, (w, h))
    return params, float(psnr(recon, img))
