"""Operations and bytes the work needs, from the configuration's shapes,
and the card's published peaks (NVIDIA H100 SXM data sheet, dense rates
at the full 700 W).

A multiply-add counts as 2 operations.  The MLP counts cover the SDF MLP
on the primal, its three tangent columns (the normal, dSDF/dx), and the
RGB MLP; training adds their backward at twice the forward (the gradient
of the inputs and of the weights), which is the eikonal term's
second-order pass through the tangent columns.  The encoder's trilinear
interpolation, the compositing and the occupancy probes are left out, so
a share of the peak from these counts is a floor.
"""

from __future__ import annotations

from portbench.reference.nets import config_from_dict

FP32_FLOPS = 67e12  # outside the tensor cores; the port multiplies in fp32 with TF32 off
HBM_BYTES_PER_S = 3.35e12


def _mlp_flops(dims: list[int]) -> int:
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def widths(config: dict) -> tuple[list[int], list[int]]:
    """(SDF MLP dims, RGB MLP dims) of a configuration file."""
    c = config_from_dict(config)
    sdf = [c.sdf_in_dim] + [c.sdf_hidden] * c.sdf_n_hidden + [c.sdf_out_dim]
    rgb = [c.rgb_in_dim] + [c.rgb_hidden] * c.rgb_n_hidden + [3]
    return sdf, rgb


def forward_flops_per_sample(config: dict) -> int:
    """The SDF MLP with its 3 tangent columns, and the RGB MLP."""
    sdf, rgb = widths(config)
    return 4 * _mlp_flops(sdf) + _mlp_flops(rgb)


def train_flops_per_sample(config: dict) -> int:
    """Forward and backward (2x forward)."""
    return 3 * forward_flops_per_sample(config)


def samples_per_step(config: dict) -> int:
    """Every adaptive bucket trains n_rays x samples_per_ray samples."""
    a = config["assumed"]
    return int(a["n_rays"]) * int(a["samples_per_ray"])


def table_rows(config: dict) -> list[int]:
    """Rows of each level's table."""
    return [rows for _, _, rows, _ in config_from_dict(config).levels()]


def kernel1_bytes(config: dict) -> int:
    """Kernel 1 (the table-gradient segment sum) once a step: it reads the
    sorted int32 keys and the bf16 payload of samples x 8 corner updates a
    level once, and writes every fp32 row of every level once."""
    enc = config["encoding"]
    f = int(enc["n_features_per_level"])
    n_upd = int(enc["n_levels"]) * samples_per_step(config) * 8
    return n_upd * 4 + n_upd * 2 * f + sum(table_rows(config)) * f * 4


def kernel1_ops(config: dict) -> int:
    enc = config["encoding"]
    return int(enc["n_levels"]) * samples_per_step(config) * 8 * int(enc["n_features_per_level"])


def kernel1_least_s(config: dict) -> float:
    """The least time kernel 1 could take: the larger of its bytes at the
    HBM rate and its adds at the fp32 rate."""
    return max(kernel1_bytes(config) / HBM_BYTES_PER_S, kernel1_ops(config) / FP32_FLOPS)
