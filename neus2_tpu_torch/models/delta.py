"""The learned global rigid transform of dynamic scenes (port of the JAX
package's ``models/delta.py``; reference transform_network.h:23-250 and
common_operation.cuh:417-513 ``add_global_movement_with_rotation_6d``).

  * ``delta`` {"rotation6d" (6,), "transition" (3,)}: the per-frame 9-DoF
    transform, applied to warped sample positions and directions and trained
    in the pose-refinement and finetune phases;
  * ``acc`` {"rotation" (3, 3), "transition" (3,)}: the frozen product of
    every past frame's delta, applied to the rays where they are made
    (reference testbed_nerf.cu:1383-1387).

Autograd gives the per-DoF gradients the reference derives by hand.
"""

from __future__ import annotations

from typing import Any

import torch

from neus2_tpu_torch.ops.rotation import apply_rotation, identity_6d, rotation_6d_to_matrix
from neus2_tpu_torch.ops.warp import unwarp_direction, warp_direction

Params = dict[str, Any]


def init_delta(device="cpu") -> Params:
    """The identity (reference transform_network.h init)."""
    return {"rotation6d": identity_6d(device),
            "transition": torch.zeros(3, dtype=torch.float32, device=device)}


def init_accumulated(device="cpu") -> Params:
    return {"rotation": torch.eye(3, dtype=torch.float32, device=device),
            "transition": torch.zeros(3, dtype=torch.float32, device=device)}


def apply_delta(delta: Params, pos_warped: torch.Tensor,
                dir_warped: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """pos' = R (pos + t) and dir' = warp(R unwarp(dir))
    (common_operation.cuh:417-473, with the reference's first-frame offset
    at its value 0, transform_network.h:460)."""
    rot = rotation_6d_to_matrix(delta["rotation6d"])
    pos = apply_rotation(rot, pos_warped + delta["transition"])
    return pos, warp_direction(apply_rotation(rot, unwarp_direction(dir_warped)))


def apply_accumulated_to_rays(acc: Params | None, ray_o: torch.Tensor, ray_d: torch.Tensor):
    """o' = R_acc o + t_acc and d' = R_acc d (testbed_nerf.cu:1380-1387,
    194-213; the first-frame offset at 0).  ``acc`` None is the identity."""
    if acc is None:
        return ray_o, ray_d
    o = apply_rotation(acc["rotation"], ray_o) + acc["transition"]
    return o, apply_rotation(acc["rotation"], ray_d)


def accumulate_delta(acc: Params, delta: Params) -> Params:
    """Fold a converged delta into the accumulated transform
    (common_operation.cuh:551-586): R' = R_d R_acc, t' = R_d (t_acc + t_d),
    the delta map x -> R_d (x + t_d) after the ray map x -> R_acc x + t_acc."""
    rot = rotation_6d_to_matrix(delta["rotation6d"])
    return {"rotation": rot @ acc["rotation"],
            "transition": apply_rotation(rot, acc["transition"] + delta["transition"])}
