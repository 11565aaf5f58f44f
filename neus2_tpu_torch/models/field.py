"""The NeuS composite field: hash grid + SDF MLP + SH(dir) + RGB MLP +
variance (port of ``neus2_tpu/models/field.py``; reference
nerf_network.h:49-325).

All positions and directions are in warped coordinates ([0,1] cube /
[0,1] directions).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from neus2_tpu_torch.constants import SDF_BIAS, VARIANCE_INIT
from neus2_tpu_torch.models.mlp import apply_mlp, geometric_init_sdf_mlp, init_mlp
from neus2_tpu_torch.ops.hashgrid import HashGridConfig
from neus2_tpu_torch.ops.hashgrid_fast import init_hashgrid_tables, make_encode_jac
from neus2_tpu_torch.ops.neus_math import variance_to_inv_s
from neus2_tpu_torch.ops.sh import sh_encode, sh_output_dim
from neus2_tpu_torch.utils.device import round_operand
from neus2_tpu_torch.utils.tree import tree_map

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Static field configuration (reference configs/nerf/base.json:29-75)."""

    grid: HashGridConfig = HashGridConfig()
    sdf_hidden_dim: int = 64
    sdf_n_hidden: int = 1
    # Channel 0 = sdf, the rest are geometry features for the RGB net.
    sdf_out_dim: int = 16
    rgb_hidden_dim: int = 64
    rgb_n_hidden: int = 2
    sh_degree: int = 4
    sdf_bias: float = SDF_BIAS
    geometric_init: bool = True
    init_radius: float = 0.5
    # Per-image latent codes appended to the RGB input (reference
    # n_extra_learnable_dims); the codes live in the camera group.
    latent_dim: int = 0
    # Residual hash grid for dynamic scenes: lookups read frozen base +
    # trained residual (reference DynamicGridEncoding, double_hash_grid.h:
    # 288, 2483-2514 set_base_grid).
    residual_grid: bool = False
    # torch.bfloat16: the MLPs' products and the encoder's backward
    # contractions take bf16-rounded operands with fp32 sums; the master
    # params, the encoder's forward and the compositing stay fp32.
    compute_dtype: Any = None

    @property
    def sdf_in_dim(self) -> int:
        return 3 + self.grid.output_dim

    @property
    def rgb_in_dim(self) -> int:
        # [sdf features | SH(dir) | xyz | normal | latent] (nerf_network.h:262-283)
        return self.sdf_out_dim + sh_output_dim(self.sh_degree) + 3 + 3 + self.latent_dim


class FieldOutput(NamedTuple):
    rgb: torch.Tensor  # (..., 3) in [0,1]
    sdf: torch.Tensor  # (...,) biased SDF
    normal: torch.Tensor  # (..., 3) dSDF/dpos in warped coords
    inv_s: torch.Tensor  # scalar


def init_field(generator: torch.Generator, config: FieldConfig, device="cpu") -> Params:
    """Field parameters drawn from ``generator`` (on the CPU, so the draw
    does not depend on the target device), then moved to ``device``."""
    grid = init_hashgrid_tables(generator, config.grid)
    if config.geometric_init:
        sdf_mlp = geometric_init_sdf_mlp(
            generator, config.sdf_in_dim, config.sdf_hidden_dim,
            config.sdf_n_hidden, config.sdf_out_dim,
            radius=config.init_radius, sdf_bias=config.sdf_bias,
        )
        sdf_mlp = _calibrate_sphere_init(sdf_mlp, config)
    else:
        sdf_mlp = init_mlp(
            generator, config.sdf_in_dim, config.sdf_hidden_dim,
            config.sdf_n_hidden, config.sdf_out_dim,
        )
    params = {
        "hashgrid": grid,
        "sdf_mlp": sdf_mlp,
        "rgb_mlp": init_mlp(
            generator, config.rgb_in_dim, config.rgb_hidden_dim,
            config.rgb_n_hidden, 3,
        ),
        "variance": torch.tensor(VARIANCE_INIT, dtype=torch.float32),
    }
    if config.residual_grid:
        params["hashgrid_base"] = [torch.zeros_like(t) for t in grid]
    return tree_map(lambda t: t.to(device), params)


# The sphere-init fit sums its Gram matrix over fixed chunks of this many rows.
_FIT_CHUNK = 256


def _calibrate_sphere_init(sdf_mlp: Params, config: FieldConfig) -> Params:
    """Ridge-fit the last layer's sdf column so raw_sdf(x) ~ |x-0.5| - r -
    bias on the actual hidden activations (grid features zeroed).

    The ridge system is ill-conditioned, so the order of its sums shows in
    the fitted weights (a BLAS product, which splits a sum by thread count,
    moved them by up to ~0.2 between thread counts).  The fit runs in
    float64 on numpy's elementwise products and sums, over fixed chunks of
    rows in a fixed order, with a hand-written Cholesky solve: no BLAS or
    LAPACK call, so every host draws the same init whatever its threads."""
    gen = torch.Generator().manual_seed(7)
    x = torch.rand((8192, 3), generator=gen).double().numpy()
    layers = [dict(l) for l in sdf_mlp["layers"]]
    hidden = [(l["w"].double().numpy(), l["b"].double().numpy()) for l in layers[:-1]]
    target = np.sqrt(((x - 0.5) ** 2).sum(-1)) - config.init_radius - config.sdf_bias
    n = layers[-1]["w"].shape[0] + 1  # the last layer's inputs and a bias column
    gram, rhs = np.zeros((n, n)), np.zeros(n)
    for lo in range(0, x.shape[0], _FIT_CHUNK):
        xc = x[lo:lo + _FIT_CHUNK]
        h = np.concatenate([xc, np.zeros((len(xc), config.grid.output_dim))], -1)
        for w, b in hidden:
            h = np.maximum((h[:, :, None] * w[None]).sum(1) + b, 0.0)
        design = np.concatenate([h, np.ones((len(h), 1))], -1)
        gram += (design[:, :, None] * design[:, None, :]).sum(0)
        rhs += (design * target[lo:lo + _FIT_CHUNK, None]).sum(0)
    beta = torch.from_numpy(_cholesky_solve(gram + 1e-4 * np.eye(n), rhs)).float()
    last = {"w": layers[-1]["w"].clone(), "b": layers[-1]["b"].clone()}
    last["w"][:, 0] = beta[:-1]
    last["b"][0] = beta[-1]
    layers[-1] = last
    return {"layers": layers}


def _cholesky_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """x with a x = b for a symmetric positive definite ``a``, by Cholesky
    with row sums in a fixed order."""
    n = len(b)
    low = np.zeros_like(a)
    for j in range(n):
        low[j, j] = np.sqrt(a[j, j] - (low[j, :j] * low[j, :j]).sum())
        low[j + 1:, j] = (a[j + 1:, j] - (low[j + 1:, :j] * low[j, :j]).sum(1)) / low[j, j]
    y = np.zeros(n)
    for i in range(n):
        y[i] = (b[i] - (low[i, :i] * y[:i]).sum()) / low[i, i]
    x = np.zeros(n)
    for i in reversed(range(n)):
        x[i] = (y[i] - (low[i + 1:, i] * x[i + 1:]).sum()) / low[i, i]
    return x


@functools.lru_cache(maxsize=None)
def _encoder(grid_config: HashGridConfig, compute_dtype=None):
    return make_encode_jac(grid_config, compute_dtype)


def effective_grid_tables(params: Params) -> list[torch.Tensor]:
    """The tables every lookup reads: with a residual grid, the frozen base
    (kept out of autograd) plus the trained residual (double_hash_grid.h:
    288, result = grid + base_grid)."""
    tables = params["hashgrid"]
    if "hashgrid_base" in params:
        tables = [b.detach() + t for b, t in zip(params["hashgrid_base"], tables)]
    return tables


def freeze_grid_into_base(params: Params) -> Params:
    """Fold the trained residual into the base and start a zero residual
    (the dynamic frame switch; set_base_grid, double_hash_grid.h:2483)."""
    if "hashgrid_base" not in params:
        return params
    new = dict(params)
    new["hashgrid_base"] = [b + t for b, t in zip(params["hashgrid_base"], params["hashgrid"])]
    new["hashgrid"] = [torch.zeros_like(t) for t in params["hashgrid"]]
    return new


def sdf_fn(params: Params, x: torch.Tensor, config: FieldConfig,
           valid_level=None, max_level=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(biased sdf (...,), raw SDF-MLP output (..., sdf_out_dim))."""
    enc, _ = _encoder(config.grid, config.compute_dtype)(effective_grid_tables(params), x,
                                                         valid_level, max_level)
    out = apply_mlp(params["sdf_mlp"], torch.cat([x, enc], -1), config.compute_dtype)
    return out[..., 0] + config.sdf_bias, out


def sdf_normal_features(params: Params, x: torch.Tensor, config: FieldConfig,
                        valid_level=None, max_level=None):
    """(sdf, normal = dSDF/dx, features), differentiable to second order.

    The SDF MLP is run forward-mode: the three tangent columns
    ``[e_i | jac[:, i, :]]`` ride beside the primal, multiplied by W at
    each linear layer and masked with ``pre > 0`` at each ReLU (derivative 0
    at 0, as JAX's relu).  The normal is then an ordinary differentiable
    function of the weights and of the encoder's ``jac`` output, so plain
    autograd gives the eikonal's second-order path (the JAX package uses
    forward-mode linearization).  Under ``compute_dtype`` the tangents are
    rounded where that linearization of the rounded MLP rounds them: at
    the input and after each ReLU mask."""
    dt = config.compute_dtype
    enc, jac = _encoder(config.grid, dt)(effective_grid_tables(params), x, valid_level,
                                         max_level)
    h = round_operand(torch.cat([x, enc], -1), dt)  # (N, in)
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(x.shape[0], 3, 3)
    t = round_operand(torch.cat([eye, jac], -1), dt)  # (N, 3, in)
    layers = params["sdf_mlp"]["layers"]
    for i, layer in enumerate(layers):
        w = round_operand(layer["w"], dt)
        pre = h @ w + layer["b"]
        t = t @ w
        if i < len(layers) - 1:
            h = round_operand(torch.relu(pre), dt)
            t = round_operand(t * (pre > 0).to(t.dtype)[:, None, :], dt)
        else:
            h = pre
    return h[..., 0] + config.sdf_bias, t[..., 0], h


def rgb_fn(params: Params, features: torch.Tensor, x: torch.Tensor,
           normal: torch.Tensor, dir_warped: torch.Tensor, config: FieldConfig,
           latent: torch.Tensor | None = None) -> torch.Tensor:
    """RGB head over [sdf features | SH(dir) | xyz | normal | latent],
    sigmoid out.  With ``latent_dim`` > 0 and no latent given (renders),
    the latent is zero."""
    sh = sh_encode(dir_warped, config.sh_degree)
    parts = [features, sh, x, normal]
    if config.latent_dim:
        if latent is None:
            latent = x.new_zeros(x.shape[:-1] + (config.latent_dim,))
        parts.append(latent)
    return torch.sigmoid(apply_mlp(params["rgb_mlp"], torch.cat(parts, -1),
                                   config.compute_dtype))


def field_forward(params: Params, x: torch.Tensor, dir_warped: torch.Tensor,
                  config: FieldConfig, valid_level=None, max_level=None,
                  latent: torch.Tensor | None = None) -> FieldOutput:
    sdf, normal, feat = sdf_normal_features(params, x, config, valid_level, max_level)
    rgb = rgb_fn(params, feat, x, normal, dir_warped, config, latent)
    inv_s = variance_to_inv_s(params["variance"])
    return FieldOutput(rgb=rgb, sdf=sdf, normal=normal, inv_s=inv_s)
