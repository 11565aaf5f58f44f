"""Rigid-transform math: the 6D rotation representation (Gram-Schmidt) and
its helpers (port of the JAX package's ``ops/rotation.py``; reference
include/neural-graphics-primitives/common_operation.cuh:38-61
``rotation_6d_to_matrix``, after Zhou et al., "On the Continuity of Rotation
Representations in Neural Networks").

Every function is plain torch and differentiable; autograd replaces the
reference's hand-derived ``gradient_rotation_matrix_to_6d``.  Products with
a 3x3 matrix are written as broadcast multiply-sums, so the identity
rotation maps a vector to itself exactly.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3): the rows a1, a2 orthonormalized by
    Gram-Schmidt, the third row their cross product."""
    a1, a2 = d6[..., 0:3], d6[..., 3:6]
    b1 = a1 / torch.clamp_min(torch.linalg.norm(a1, dim=-1, keepdim=True), _EPS)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.clamp_min(torch.linalg.norm(b2, dim=-1, keepdim=True), _EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(mat: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rotation_6d_to_matrix`: the first two rows."""
    return torch.cat([mat[..., 0, :], mat[..., 1, :]], dim=-1)


def identity_6d(device="cpu") -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], dtype=torch.float32, device=device)


def apply_rotation(rotation: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """R @ v for vectors (..., 3)."""
    return (vectors[..., None, :] * rotation).sum(-1)


def apply_rigid(rotation: torch.Tensor, translation: torch.Tensor,
                points: torch.Tensor) -> torch.Tensor:
    """R @ p + t for points (..., 3)."""
    return apply_rotation(rotation, points) + translation


def compose_rigid(r_new: torch.Tensor, t_new: torch.Tensor, r_acc: torch.Tensor,
                  t_acc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The map x -> R_new (R_acc x + t_acc) + t_new as (R_new R_acc,
    R_new t_acc + t_new) (reference accumulate_global_movement,
    nerf_network.h:1163)."""
    return r_new @ r_acc, apply_rotation(r_new, t_acc) + t_new
