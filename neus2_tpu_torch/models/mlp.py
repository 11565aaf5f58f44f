"""Small dense MLPs with geometric (sphere) initialization
(port of ``neus2_tpu/models/mlp.py``).

Parameters keep the JAX package's layout: ``{"layers": [{"w": (in, out),
"b": (out,)}]}``, so ``h @ w + b`` per layer and the trees of both
packages line up leaf for leaf.  Random draws come from an explicit
``torch.Generator`` and are moved to ``device``.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from neus2_tpu_torch.utils.device import round_operand

Params = dict[str, Any]


def init_mlp(
    generator: torch.Generator,
    in_dim: int,
    hidden_dim: int,
    n_hidden_layers: int,
    out_dim: int,
    device="cpu",
) -> Params:
    """He-uniform weights, zero biases (tcnn's default scale)."""
    dims = [in_dim] + [hidden_dim] * n_hidden_layers + [out_dim]
    layers = []
    for i in range(len(dims) - 1):
        scale = math.sqrt(6.0 / (dims[i] + dims[i + 1]))
        w = (
            torch.rand((dims[i], dims[i + 1]), generator=generator,
                       device=generator.device) * (2 * scale) - scale
        )
        layers.append(
            {"w": w.to(device), "b": torch.zeros(dims[i + 1], device=device)}
        )
    return {"layers": layers}


def apply_mlp(params: Params, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """ReLU hidden layers, linear output, fp32 out.

    ``dtype`` (bf16): the activations and weights of each product are
    rounded to it, the products sum in fp32 and the bias adds in fp32; the
    hidden activations are rounded again after the ReLU (the reference's
    fp16 MLPs over fp32 master weights, trainer.h:79-88)."""
    layers = params["layers"]
    h = round_operand(x, dtype)
    for i, layer in enumerate(layers):
        h = h @ round_operand(layer["w"], dtype) + layer["b"]
        if i < len(layers) - 1:
            h = round_operand(torch.relu(h), dtype)
    return h


def geometric_init_sdf_mlp(
    generator: torch.Generator,
    in_dim: int,
    hidden_dim: int,
    n_hidden_layers: int,
    out_dim: int,
    n_raw_pos_dims: int = 3,
    center: float = 0.5,
    radius: float = 0.5,
    sdf_bias: float = -0.1,
    device="cpu",
) -> Params:
    """SAL/IGR sphere initialization: sdf_raw(x) + sdf_bias ~ |x - c| - r.

    Input is ``[xyz | grid features]``; grid-feature columns of the first
    layer start near zero, the last layer's sdf column has mean
    sqrt(pi/fan_in) and bias -(radius + sdf_bias)."""
    dims = [in_dim] + [hidden_dim] * n_hidden_layers + [out_dim]
    layers = []
    for i in range(len(dims) - 1):
        fan_in, fan_out = dims[i], dims[i + 1]
        w = torch.randn(
            (fan_in, fan_out), generator=generator, device=generator.device
        )
        if i == len(dims) - 2:
            w = w * 1e-4
            w[:, 0] += math.sqrt(math.pi / fan_in)
            b = torch.zeros(fan_out)
            b[0] = -(radius + sdf_bias)
        elif i == 0:
            w = w * math.sqrt(2.0 / fan_out)
            w[n_raw_pos_dims:, :] *= 1e-2
            b = -w[:n_raw_pos_dims, :].sum(0) * center
        else:
            w = w * math.sqrt(2.0 / fan_out)
            b = torch.zeros(fan_out)
        layers.append({"w": w.to(device), "b": b.to(device)})
    return {"layers": layers}
