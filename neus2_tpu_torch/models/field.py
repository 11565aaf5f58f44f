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

import torch

from neus2_tpu_torch.constants import SDF_BIAS, VARIANCE_INIT
from neus2_tpu_torch.models.mlp import apply_mlp, geometric_init_sdf_mlp, init_mlp
from neus2_tpu_torch.ops.hashgrid import HashGridConfig
from neus2_tpu_torch.ops.hashgrid_fast import init_hashgrid_tables, make_encode_jac
from neus2_tpu_torch.ops.neus_math import variance_to_inv_s
from neus2_tpu_torch.ops.sh import sh_encode, sh_output_dim
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

    @property
    def sdf_in_dim(self) -> int:
        return 3 + self.grid.output_dim

    @property
    def rgb_in_dim(self) -> int:
        # [sdf features | SH(dir) | xyz | normal] (nerf_network.h:262-283)
        return self.sdf_out_dim + sh_output_dim(self.sh_degree) + 3 + 3


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
    return tree_map(lambda t: t.to(device), params)


def _calibrate_sphere_init(sdf_mlp: Params, config: FieldConfig) -> Params:
    """Ridge-fit the last layer's sdf column so raw_sdf(x) ~ |x-0.5| - r -
    bias on the actual hidden activations (grid features zeroed)."""
    gen = torch.Generator().manual_seed(7)
    x = torch.rand((8192, 3), generator=gen)
    h = torch.cat([x, torch.zeros((x.shape[0], config.grid.output_dim))], -1)
    layers = [dict(l) for l in sdf_mlp["layers"]]
    for layer in layers[:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    target = torch.linalg.norm(x - 0.5, dim=-1) - config.init_radius - config.sdf_bias
    design = torch.cat([h, torch.ones((h.shape[0], 1))], -1)
    gram = design.T @ design + 1e-4 * torch.eye(design.shape[1])
    beta = torch.linalg.solve(gram, design.T @ target)
    last = {"w": layers[-1]["w"].clone(), "b": layers[-1]["b"].clone()}
    last["w"][:, 0] = beta[:-1]
    last["b"][0] = beta[-1]
    layers[-1] = last
    return {"layers": layers}


@functools.lru_cache(maxsize=None)
def _encoder(grid_config: HashGridConfig):
    return make_encode_jac(grid_config)


def sdf_fn(params: Params, x: torch.Tensor, config: FieldConfig,
           valid_level=None, max_level=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(biased sdf (...,), raw SDF-MLP output (..., sdf_out_dim))."""
    enc, _ = _encoder(config.grid)(params["hashgrid"], x, valid_level, max_level)
    out = apply_mlp(params["sdf_mlp"], torch.cat([x, enc], -1))
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
    forward-mode linearization)."""
    enc, jac = _encoder(config.grid)(params["hashgrid"], x, valid_level, max_level)
    h = torch.cat([x, enc], -1)  # (N, in)
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(x.shape[0], 3, 3)
    t = torch.cat([eye, jac], -1)  # (N, 3, in)
    layers = params["sdf_mlp"]["layers"]
    for i, layer in enumerate(layers):
        pre = h @ layer["w"] + layer["b"]
        t = t @ layer["w"]
        if i < len(layers) - 1:
            h = torch.relu(pre)
            t = t * (pre > 0).to(t.dtype)[:, None, :]
        else:
            h = pre
    return h[..., 0] + config.sdf_bias, t[..., 0], h


def rgb_fn(params: Params, features: torch.Tensor, x: torch.Tensor,
           normal: torch.Tensor, dir_warped: torch.Tensor,
           config: FieldConfig) -> torch.Tensor:
    """RGB head over [sdf features | SH(dir) | xyz | normal], sigmoid out."""
    sh = sh_encode(dir_warped, config.sh_degree)
    inp = torch.cat([features, sh, x, normal], -1)
    return torch.sigmoid(apply_mlp(params["rgb_mlp"], inp))


def field_forward(params: Params, x: torch.Tensor, dir_warped: torch.Tensor,
                  config: FieldConfig, valid_level=None,
                  max_level=None) -> FieldOutput:
    sdf, normal, feat = sdf_normal_features(params, x, config, valid_level, max_level)
    rgb = rgb_fn(params, feat, x, normal, dir_warped, config)
    inv_s = variance_to_inv_s(params["variance"])
    return FieldOutput(rgb=rgb, sdf=sdf, normal=normal, inv_s=inv_s)
