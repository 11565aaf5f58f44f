"""The reference's modified Adam with exponential lr decay, and the EMA
copy of the parameters (port of ``neus2_tpu/utils/optim.py``, written
without an optimizer library; reference tcnn adam.h:52-160, exponential_decay.h, ema.h).

  * L2 regularization on matrix (MLP weight ``"w"``) params only;
  * non-matrix params (tables, biases, variance) skip the elements whose
    gradient is exactly zero -- no moment decay, no step count -- with
    per-element step counters for the debias;
  * tcnn debias: lr * sqrt(1-b2^t)/(1-b1^t) / (sqrt(v)+eps) * m;
  * optional AdaBound clamping and per-component freezing.

``plain_adam_*`` is the textbook Adam of the dynamic scenes' delta
transform, the camera group and the SDF and image fit modes;
``value_and_grads`` takes a tree's loss and gradients as JAX does.

The state is ``{"mu", "nu", "steps", "count"}`` with the parameter tree's
structure, as in the JAX package; ``count`` is a host integer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from neus2_tpu_torch.utils.tree import (
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
    tree_unflatten_like,
)


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 1e-3
    # The learning rate of frames after the first in dynamic scenes
    # (reference Adam "after_learning_rate", testbed.cu:2698-2703).
    after_learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.99
    epsilon: float = 1e-15
    l2_reg: float = 1e-6
    decay_start: int = 20000
    decay_interval: int = 10000
    decay_base: float = 0.33
    ema_decay: float = 0.95
    # (component name, trainable) pairs from optimize_params_components.
    components: tuple = ()
    adabound: bool = False
    non_matrix_lr_factor: float = 1.0


_COMPONENT_OF_KEY = {
    "sdf_mlp": "density_network",
    "rgb_mlp": "rgb_network",
    "variance": "variance_network",
    "hashgrid": "pos_encoding",
    "hashgrid_base": "pos_encoding",
}


def exp_decay_schedule(config: OptimConfig):
    """lr at optimizer step ``count``: base before decay_start, then times
    decay_base once per started interval (first drop at decay_start)."""

    def schedule(count: int) -> float:
        past = max(count - config.decay_start, -1)
        n_drops = 0 if past < 0 else past // config.decay_interval + 1
        return float(
            torch.tensor(config.learning_rate, dtype=torch.float32)
            * torch.tensor(config.decay_base, dtype=torch.float32) ** n_drops
        )

    return schedule


def _component_trainable(path: tuple, config: OptimConfig) -> bool:
    if not config.components:
        return True
    name = _COMPONENT_OF_KEY.get(path[0], path[0])
    return dict(config.components).get(name, True)


def adam_init(params: Any) -> dict:
    return {
        "mu": tree_map(torch.zeros_like, params),
        "nu": tree_map(torch.zeros_like, params),
        "steps": tree_map(lambda p: torch.zeros_like(p, dtype=torch.int32), params),
        "count": 0,
    }


@torch.no_grad()
def adam_update(grads: Any, state: dict, params: Any, config: OptimConfig):
    """-> (updates (new_w - w), new_state); trees as ``params``."""
    count = state["count"] + 1
    lr = exp_decay_schedule(config)(count)
    if config.adabound:
        lower = 0.1 - 0.1 / ((1.0 - config.beta2) * count + 1.0)
        upper = 0.1 + 0.1 / ((1.0 - config.beta2) * count)
    else:
        lower, upper = 0.0, math.inf
    b1, b2 = config.beta1, config.beta2
    out = []
    for (path, p), g, mu, nu, st in zip(
        tree_leaves_with_path(params),
        tree_leaves(grads),
        tree_leaves(state["mu"]),
        tree_leaves(state["nu"]),
        tree_leaves(state["steps"]),
    ):
        if not _component_trainable(path, config):
            out.append((torch.zeros_like(p), mu, nu, st))
            continue
        if "w" in path:
            g = g + config.l2_reg * p
            active = torch.ones_like(g, dtype=torch.bool)
            leaf_lr = lr
        else:
            active = g != 0.0
            leaf_lr = lr * config.non_matrix_lr_factor
        new_mu = torch.where(active, b1 * mu + (1 - b1) * g, mu)
        new_nu = torch.where(active, b2 * nu + (1 - b2) * g * g, nu)
        new_st = st + active.to(torch.int32)
        t = torch.clamp_min(new_st, 1).to(torch.float32)
        debias = torch.sqrt(1.0 - torch.pow(b2, t)) / (1.0 - torch.pow(b1, t))
        eff = torch.clamp(
            leaf_lr * debias / (torch.sqrt(new_nu) + config.epsilon), lower, upper
        )
        delta = torch.where(active, -eff * new_mu, torch.zeros_like(new_mu))
        out.append((delta, new_mu, new_nu, new_st))
    new_state = {
        key: tree_unflatten_like(params, [o[i] for o in out])
        for i, key in ((1, "mu"), (2, "nu"), (3, "steps"))
    }
    new_state["count"] = count
    return tree_unflatten_like(params, [o[0] for o in out]), new_state


def plain_adam_init(params: Any) -> dict:
    return {"mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params), "count": 0}


@torch.no_grad()
def plain_adam_update(grads: Any, state: dict, lr: float, eps: float = 1e-10):
    """Textbook Adam with bias-corrected moments, update = -lr m_hat /
    (sqrt(v_hat) + eps), b1 0.9, b2 0.99: with eps 1e-10 (base.json
    "globalmove") the optimizer of the dynamic scenes' delta transform,
    with eps 1e-8 the camera group's; not the field's tcnn-style one.
    One ``count`` for the whole tree.  -> (updates, new state); trees as
    ``grads``."""
    b1, b2 = 0.9, 0.99
    count = state["count"] + 1
    one = torch.tensor(1.0)
    c1 = float(one - torch.tensor(b1) ** count)  # bias corrections in fp32
    c2 = float(one - torch.tensor(b2) ** count)
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
    nu = tree_map(lambda g, v: (1 - b2) * g * g + b2 * v, grads, state["nu"])
    updates = tree_map(lambda m, v: -lr * ((m / c1) / (torch.sqrt(v / c2) + eps)), mu, nu)
    return updates, {"mu": mu, "nu": nu, "count": count}


def plain_adam_apply(params: Any, state: dict, grads: Any, lr: float, eps: float):
    """``plain_adam_update`` added to the params -> (new params, new state)
    (the JAX package's fit modes apply their Adam so)."""
    updates, state = plain_adam_update(grads, state, lr, eps=eps)
    return tree_map(lambda p, u: p + u, params, updates), state


def value_and_grads(loss_fn, params: Any):
    """(loss, gradient tree) of ``loss_fn(params)``; a leaf the loss does
    not reach gets a zero gradient, as the JAX package's autodiff gives it."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss = loss_fn(tree_unflatten_like(params, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten_like(params, grads)


@torch.no_grad()
def ema_update(ema_params: Any, params: Any, decay: float) -> Any:
    """EMA of the parameters, used for inference (tcnn ema.h)."""
    return tree_map(lambda e, p: decay * e + (1.0 - decay) * p, ema_params, params)
