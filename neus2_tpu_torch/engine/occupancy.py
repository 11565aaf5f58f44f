"""Occupancy (density) grid: cascaded 128^3 EMA grid + bitfield
(port of ``neus2_tpu/engine/occupancy.py``; reference
testbed_nerf.cu:640-800, 3293-3397).

Probing is the JAX package's deterministic round-robin permutation sweep:
every update probes the next ``n_probe`` cells of a fixed pseudo-random
permutation, so each cell is re-measured once per ``ceil(n_cells/n_probe)``
updates.  The permutation relies on uint32 wraparound; here it runs in
int64 with ``& 0xFFFFFFFF`` after each product (a wrapped int64 product
keeps its low 32 bits).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from neus2_tpu_torch.constants import (
    DENSITY_GRID_DECAY,
    NERF_GRIDSIZE,
    NERF_MIN_OPTICAL_THICKNESS,
)

_PROBE_PRIME = 2654435761
_U32 = 0xFFFFFFFF


class OccupancyGrid(NamedTuple):
    density: torch.Tensor  # (C, G, G, G) float32, -1 marks culled cells
    bitfield: torch.Tensor  # (C, G, G, G) bool
    ema_step: int  # updates merged so far (host counter)

    @property
    def n_cascades(self) -> int:
        return self.density.shape[0]

    @property
    def grid_size(self) -> int:
        return self.density.shape[1]


def init_occupancy(n_cascades: int = 1, grid_size: int = NERF_GRIDSIZE,
                   device="cpu") -> OccupancyGrid:
    shape = (n_cascades, grid_size, grid_size, grid_size)
    return OccupancyGrid(
        density=torch.zeros(shape, dtype=torch.float32, device=device),
        bitfield=torch.zeros(shape, dtype=torch.bool, device=device),
        ema_step=0,
    )


def cell_position(cell_idx: torch.Tensor, cascade: torch.Tensor,
                  jitter: torch.Tensor, grid_size: int) -> torch.Tensor:
    """pos = ((cell + u)/G - 0.5) * 2^cascade + 0.5 (testbed_nerf.cu:660-667)."""
    xyz = torch.stack(
        [
            cell_idx % grid_size,
            (cell_idx // grid_size) % grid_size,
            cell_idx // (grid_size * grid_size),
        ],
        dim=-1,
    ).to(torch.float32)
    scale = torch.exp2(cascade.to(torch.float32))[..., None]
    return ((xyz + jitter) / grid_size - 0.5) * scale + 0.5


def probe_cells(state: OccupancyGrid, n_probe: int, jitter: torch.Tensor):
    """The next ``n_probe`` cells of the sweep, probed at ``jitter``
    (n_probe, 3) uniforms inside each cell.

    Returns (flat cell indices (P,), cascades (P,), world positions (P,3))."""
    c, g = state.n_cascades, state.grid_size
    g3 = g * g * g
    dev = state.density.device
    base = (state.ema_step * n_probe) & _U32
    i = (torch.arange(n_probe, dtype=torch.int64, device=dev) + base) & _U32
    cell = (((i // c) * _PROBE_PRIME) & _U32) % g3
    cascade = i % c
    flat = cascade * g3 + cell
    return flat, cascade, cell_position(cell, cascade, jitter, g)


def merge_probes(state: OccupancyGrid, flat_idx: torch.Tensor,
                 densities: torch.Tensor,
                 decay: float = DENSITY_GRID_DECAY) -> OccupancyGrid:
    """Scatter-max the probes and EMA-merge: val' = max(val*decay, probe)."""
    tmp = torch.zeros(state.density.numel(), dtype=torch.float32,
                      device=densities.device)
    tmp.scatter_reduce_(0, flat_idx, densities, reduce="amax", include_self=True)
    prev = state.density.reshape(-1)
    merged = torch.where(prev < 0.0, prev, torch.maximum(prev * decay, tmp))
    return state._replace(
        density=merged.reshape(state.density.shape), ema_step=state.ema_step + 1
    )


def update_bitfield(state: OccupancyGrid) -> OccupancyGrid:
    """Threshold to bits + cascade max-pool (testbed_nerf.cu:748-795)."""
    g = state.grid_size
    mean0 = torch.clamp_min(state.density[0], 0.0).mean()
    thresh = torch.clamp_max(mean0, NERF_MIN_OPTICAL_THICKNESS)
    bits = state.density > thresh
    if state.n_cascades > 1:
        levels = [bits[0]]
        q = g // 4
        for k in range(1, state.n_cascades):
            pooled = levels[k - 1].reshape(g // 2, 2, g // 2, 2, g // 2, 2)
            pooled = pooled.any(dim=5).any(dim=3).any(dim=1)
            lvl = bits[k].clone()
            lvl[q : 3 * q, q : 3 * q, q : 3 * q] |= pooled
            levels.append(lvl)
        bits = torch.stack(levels)
    return state._replace(bitfield=bits)


def reset_density(state: OccupancyGrid) -> OccupancyGrid:
    """A fresh grid of the same shape (reference reset_density_grid_nerf,
    testbed_nerf.cu:3205; after a dynamic frame's pose refinement)."""
    return init_occupancy(state.n_cascades, state.grid_size, device=state.density.device)


def mip_from_pos(pos: torch.Tensor, max_cascade: int) -> torch.Tensor:
    """Smallest cascade whose box contains pos."""
    d = torch.abs(pos - 0.5).amax(dim=-1)
    mip = torch.ceil(torch.log2(torch.clamp_min(d * 2.0, 1e-10)))
    return torch.clamp(mip, 0, max_cascade).to(torch.int64)


def packed_bitfield(state: OccupancyGrid) -> torch.Tensor:
    """Bitfield packed to (C*G^3/32,) words (bit j of word w = cell 32w+j)."""
    bits = state.bitfield.reshape(-1, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, device=bits.device
    )
    return (bits * weights).sum(-1)


def _packed_lookup(words: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    return ((words[flat >> 5] >> (flat & 31)) & 1).to(torch.bool)


def occupancy_at(state: OccupancyGrid, pos: torch.Tensor) -> torch.Tensor:
    """Bitfield lookup at world positions (..., 3) with the per-point mip."""
    g = state.grid_size
    words = packed_bitfield(state)
    if state.n_cascades == 1:
        cell = torch.floor(pos * g).to(torch.int64)
        inside = ((cell >= 0) & (cell < g)).all(dim=-1)
        cell = torch.clamp(cell, 0, g - 1)
        flat = (cell[..., 2] * g + cell[..., 1]) * g + cell[..., 0]
        return _packed_lookup(words, flat) & inside
    mip = mip_from_pos(pos, state.n_cascades - 1)
    scale = torch.exp2(-mip.to(torch.float32))[..., None]
    rel = (pos - 0.5) * scale + 0.5
    cell = torch.floor(rel * g).to(torch.int64)
    inside = ((cell >= 0) & (cell < g)).all(dim=-1)
    cell = torch.clamp(cell, 0, g - 1)
    flat = ((mip * g + cell[..., 2]) * g + cell[..., 1]) * g + cell[..., 0]
    return _packed_lookup(words, flat) & inside
