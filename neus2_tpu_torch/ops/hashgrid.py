"""Multiresolution hash-grid configuration, corner indexing and the plain
encoding over one flat table (port of ``neus2_tpu/ops/hashgrid.py``;
reference tcnn grid.h:118-155, 2427-2440).

Contract kept from the reference: the lookup scale is ``resolution - 1``
(the NeuS2 quirk), positions are offset by +0.5 before flooring, a level is
dense-indexed while it fits its table and spatially hashed otherwise.

The field trains through ``ops/hashgrid_fast.py`` (per-level tables, the
analytic Jacobian); ``hashgrid_encode`` is the JAX package's plain
encoding, differentiable in the table and the positions.  Its table
gradient is summed in a fixed order (``ops/scatter.py::level_table_grad``:
kernel 4 on the card), not by the atomic adds of torch's own backward of a
gather.  ``init_hashgrid`` is the port's own seeded draw.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from neus2_tpu_torch.ops.scatter import level_table_grad

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def _next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 14
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.5
    valid_level_scale: float = 0.02
    base_valid_level_scale: float = 0.2
    base_training_step: int = 100
    grid_type: str = "Hash"  # "Hash" | "Dense" | "Tiled"

    @staticmethod
    def per_level_scale_from_top(
        base_resolution: int, top_resolution: int, n_levels: int
    ) -> float:
        """exp(ln(top/base) / (L-1)) (reference testbed.cu:2183-2189)."""
        return math.exp(
            math.log(top_resolution / base_resolution) / (n_levels - 1)
        )

    def level_tables(self):
        """(resolutions, scales, offsets, sizes, use_hash) per level."""
        resolutions, scales, offsets, sizes, use_hash = [], [], [], [], []
        offset = 0
        max_params = (2**32 - 1) // 2
        for lvl in range(self.n_levels):
            raw_scale = (
                math.exp2(lvl * math.log2(self.per_level_scale))
                * self.base_resolution
                - 1.0
            )
            resolution = int(math.ceil(raw_scale)) + 1
            dense = (
                max_params if float(resolution) ** 3 > max_params else resolution**3
            )
            params_in_level = _next_multiple(dense, 8)
            if self.grid_type == "Hash":
                params_in_level = min(params_in_level, 1 << self.log2_hashmap_size)
            elif self.grid_type == "Tiled":
                params_in_level = min(params_in_level, self.base_resolution**3)
            elif self.grid_type != "Dense":
                raise ValueError(f"invalid grid type {self.grid_type!r}")
            resolutions.append(resolution)
            scales.append(float(resolution - 1))
            offsets.append(offset)
            sizes.append(params_in_level)
            use_hash.append(
                self.grid_type == "Hash" and resolution**3 > params_in_level
            )
            offset += params_in_level
        return resolutions, scales, offsets, sizes, use_hash

    @property
    def n_table_entries(self) -> int:
        _, _, offsets, sizes, _ = self.level_tables()
        return offsets[-1] + sizes[-1]

    @property
    def n_params(self) -> int:
        return self.n_table_entries * self.n_features_per_level

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    def valid_level(self, step: int) -> int:
        """Progressive level unlock (grid.h:2427-2440); step <= 0 unlocks all.

        Evaluated in float32 like the JAX package, so ``ceil`` lands on the
        same side of each integer."""
        if step <= 0:
            return self.n_levels
        raw = np.ceil(
            np.float32(self.base_valid_level_scale * self.n_levels)
            + np.float32(self.valid_level_scale)
            * np.float32(max(0, step - self.base_training_step))
        )
        return int(min(self.n_levels, int(raw)))


def _corner_indices(
    pos_grid: torch.Tensor, resolution: int, size: int, use_hash: bool
) -> torch.Tensor:
    """Flat table index of integer grid corners: int64 (..., 3) -> (...,).

    The hash is the reference's uint32 XOR of coordinate-prime products,
    done in int64 with every coordinate and product masked to 32 bits
    (an int64 product that wraps keeps its low 32 bits, so the mask is
    exact)."""
    if use_hash:
        pg = pos_grid & _U32
        idx = (
            ((pg[..., 0] * _PRIMES[0]) & _U32)
            ^ ((pg[..., 1] * _PRIMES[1]) & _U32)
            ^ ((pg[..., 2] * _PRIMES[2]) & _U32)
        )
        return idx % size
    idx = (
        pos_grid[..., 0]
        + pos_grid[..., 1] * resolution
        + pos_grid[..., 2] * resolution * resolution
    )
    return idx % size


def init_hashgrid(generator: torch.Generator, config: HashGridConfig,
                  device="cpu") -> torch.Tensor:
    """The flat (n_table_entries, F) table ~ U(-1e-4, 1e-4) (tcnn
    initialize_params), drawn on the generator's device."""
    shape = (config.n_table_entries, config.n_features_per_level)
    draw = torch.rand(shape, generator=generator, device=generator.device)
    return (draw * 2e-4 - 1e-4).to(device)


class _RowGather(torch.autograd.Function):
    """``table[idx]``, whose table gradient is summed in a fixed order."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return level_table_grad(idx, ct.to(torch.float32), ctx.rows), None


def hashgrid_encode(table: torch.Tensor, positions: torch.Tensor, config: HashGridConfig,
                    valid_level: int | None = None,
                    max_level: torch.Tensor | None = None) -> torch.Tensor:
    """Trilinear multiresolution features of (B, 3) warped positions from
    the flat (n_table_entries, F) table -> (B, L * F).

    Levels above ``valid_level`` output 0 (grid.h:198); with ``max_level``
    (B,) fractions in [0, 1], level l is 0 where l >= max_level * L
    (grid.h:217-240).  All levels' corners are gathered at once."""
    resolutions, scales, offsets, sizes, use_hash = config.level_tables()
    corners = [tuple((c >> d) & 1 for d in range(3)) for c in range(8)]
    idx, weights = [], []
    for lvl in range(config.n_levels):
        pos = positions * scales[lvl] + 0.5
        pos_floor = torch.floor(pos)
        frac = pos - pos_floor
        pos_grid = pos_floor.to(torch.int64)
        for corner in corners:
            co = torch.tensor(corner, device=positions.device)
            weights.append(torch.where(co == 1, frac, 1.0 - frac).prod(-1))
            idx.append(offsets[lvl] + _corner_indices(pos_grid + co, resolutions[lvl],
                                                      sizes[lvl], use_hash[lvl]))
    vals = _RowGather.apply(table, torch.cat(idx))
    vals = vals.view(config.n_levels, 8, positions.shape[0], table.shape[1])
    outs = []
    for lvl in range(config.n_levels):
        feat = torch.zeros_like(vals[lvl, 0])
        for c in range(8):
            feat = feat + weights[lvl * 8 + c][:, None] * vals[lvl, c]
        if valid_level is not None:
            feat = feat * (1.0 if lvl <= valid_level else 0.0)
        if max_level is not None:
            per_sample = (lvl < max_level * config.n_levels + 1e-3).to(table.dtype)
            feat = feat * per_sample[:, None]
        outs.append(feat)
    return torch.cat(outs, -1)
