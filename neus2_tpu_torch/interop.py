"""Convert the JAX package's training state, given as numpy arrays, into
the port's tensors and back.

Both packages keep the same tree layout (per-level table tuple,
``{"layers": [{"w": (in, out), "b"}]}`` MLPs, scalar ``variance``; Adam
``{"mu", "nu", "steps", "count"}``), so conversion is a leaf-wise copy.
Counters that the port keeps on the host (Adam ``count``, occupancy
``ema_step``, ``step``, ``frame_step``) become Python integers.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

import numpy as np
import torch

from neus2_tpu_torch.engine.occupancy import OccupancyGrid
from neus2_tpu_torch.engine.train import TrainState
from neus2_tpu_torch.utils.tree import tree_map


def tree_to_torch(tree: Any, device="cpu") -> Any:
    """numpy leaves -> tensors (tuples become lists)."""
    out = tree_map(lambda a: torch.as_tensor(np.array(a), device=device), tree)
    return _lists(out)


def tree_to_numpy(tree: Any) -> Any:
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _lists(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _lists(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_lists(v) for v in tree]
    return tree


def params_from_jax(params: dict, device="cpu") -> dict:
    """{"hashgrid": (T_l, F) per level, "sdf_mlp", "rgb_mlp", "variance"}."""
    keys = ("hashgrid", "sdf_mlp", "rgb_mlp", "variance")
    return tree_to_torch({k: params[k] for k in keys}, device)


def params_to_jax(params: dict) -> dict:
    out = tree_to_numpy(params)
    out["hashgrid"] = tuple(out["hashgrid"])
    return out


def adam_from_jax(opt_state: dict, device="cpu") -> dict:
    return {
        "mu": params_from_jax(opt_state["mu"], device),
        "nu": params_from_jax(opt_state["nu"], device),
        "steps": params_from_jax(opt_state["steps"], device),
        "count": int(opt_state["count"]),
    }


def adam_to_jax(opt_state: dict) -> dict:
    return {
        "mu": params_to_jax(opt_state["mu"]),
        "nu": params_to_jax(opt_state["nu"]),
        "steps": params_to_jax(opt_state["steps"]),
        "count": np.int32(opt_state["count"]),
    }


def occupancy_from_jax(density, bitfield, ema_step, device="cpu") -> OccupancyGrid:
    return OccupancyGrid(
        density=torch.as_tensor(np.array(density), device=device),
        bitfield=torch.as_tensor(np.array(bitfield), device=device),
        ema_step=int(ema_step),
    )


def state_from_jax(params, ema_params, opt_state, occupancy, step, frame_step,
                   device="cpu", seed: int = 0) -> TrainState:
    """A port ``TrainState`` from the JAX state's parts (numpy trees;
    ``occupancy`` as a (density, bitfield, ema_step) triple).  The JAX key
    has no torch counterpart: the step generator is seeded ``seed``."""
    return TrainState(
        params=params_from_jax(params, device),
        ema_params=params_from_jax(ema_params, device),
        opt_state=adam_from_jax(opt_state, device),
        occupancy=occupancy_from_jax(*occupancy, device=device),
        step=int(step),
        frame_step=int(frame_step),
        generator=torch.Generator(device=device).manual_seed(seed),
    )


def train_state_from_jax(state, device="cpu", seed: int = 0) -> TrainState:
    """A port ``TrainState`` from a whole JAX ``TrainState`` (host copy:
    numpy leaves), of which the canonical field's parts are taken."""
    occ = state.occupancy
    return state_from_jax(state.params, state.ema_params, state.opt_state,
                          (occ.density, occ.bitfield, occ.ema_step),
                          state.step, state.frame_step, device=device, seed=seed)


def testbed_from_jax(state, hyper, config, dataset, training_step: int = 0,
                     device="cpu", seed: int = 0):
    """A port ``Testbed`` on ``dataset`` (a port ``NerfDataset``) whose
    state is the JAX Testbed's: its ``TrainState`` (host copy), its
    ``Hyperparams`` (any object with the same fields) and the port's
    ``TrainConfig`` for it.  The dataset-derived config is applied as
    ``load_training_data`` would; no fresh state is drawn."""
    from neus2_tpu_torch.api.testbed import Hyperparams, Testbed

    hp = Hyperparams(**{f.name: getattr(hyper, f.name)
                        for f in dataclasses.fields(Hyperparams)})
    tb = Testbed(config=config, hyper=hp, seed=seed, device=device)
    tb._datasets = [dataset]
    tb.frame_jsons = [Path("<memory:0>")]
    tb._load_frame(0)
    tb._derive_config()
    tb.state = train_state_from_jax(state, device=device, seed=seed)
    tb.training_step = int(training_step)
    return tb
