"""Rank body of tests/test_torch_parallel.py, run on each gloo rank that
``neus2_tpu_torch.parallel.distributed.launch`` spawns.  It imports torch
and the port only: the JAX side runs in the test process, which hands the
ranks the starting states (``pathdict-v1`` leaves) and each device's draws.

``run`` does every scenario of the module in one world, so the ranks start
once: a static ZeRO-1 Testbed that writes a snapshot and a replicated
dynamic Testbed (while the test process computes the JAX side), then the
injected-draw steps (replicated, ZeRO-1, the delta phase).  It returns
plain data: losses, aux, states as host arrays.
"""

import time
from pathlib import Path

import torch

from neus2_tpu_torch import interop
from neus2_tpu_torch.api.testbed import Hyperparams, Testbed
from neus2_tpu_torch.data.synthetic import make_moving_sphere_frames, make_sphere_dataset
from neus2_tpu_torch.engine import train as tt
from neus2_tpu_torch.parallel import train as pt

STATIC_STEPS = 30


def _start(ctx, job: dict, leaves: dict):
    """The state ``leaves`` hold, placed by rank 0 (the other ranks start
    from a fresh state, which the broadcast must overwrite)."""
    cfg = job["config"]
    like = tt.init_train_state(cfg, job["cameras"].n_images, device="cpu")
    state, missing = interop.state_from_pathdict(leaves, like)
    assert not missing, missing
    return (pt.shard_state_zero1 if job["zero1"] else pt.replicate_state)(
        like if ctx.rank else state, ctx)


def _step(ctx, job: dict, state, draws):
    return pt.parallel_train_step(state, job["images"], job["cameras"], job["config"], ctx,
                                  **job["phase"], zero1=job["zero1"], draws=draws[ctx.rank])


def _whole(ctx, job: dict, state) -> dict:
    if job["zero1"]:
        state = state._replace(opt_state=pt.gather_opt_state(state.opt_state, state.params,
                                                             ctx))
    return interop.state_to_pathdict(state)


def _steps(ctx, job: dict) -> dict:
    """The job's steps twice: each from the JAX state before it (``synced``:
    compared with JAX step by step), and all from the first (``free``)."""
    synced = []
    for leaves, draws in zip(job["starts"], job["draws"]):
        state, aux = _step(ctx, job, _start(ctx, job, leaves), draws)
        synced.append([float(a) for a in aux])
    out = {"aux": synced, "state": _whole(ctx, job, state)}
    state = _start(ctx, job, job["starts"][0])
    out["local_opt_rows"] = sum(t.shape[0] for t in state.opt_state["mu"]["hashgrid"])
    free = []
    for draws in job["draws"]:
        state, aux = _step(ctx, job, state, draws)
        free.append([float(a) for a in aux])
    out.update(free_aux=free, free_state=_whole(ctx, job, state))
    return out


def _testbed_static_zero1(ctx, cfg, path: str) -> dict:
    """The static Testbed under ZeRO-1, then its snapshot."""
    tb = Testbed(cfg, Hyperparams(first_frame_max_training_step=STATIC_STEPS), device="cpu")
    world = tb.enable_multichip(zero1=True)
    tb.load_training_data_from_datasets([make_sphere_dataset(n_views=6, resolution=32)])
    first = None
    while tb.frame():
        if first is None and tb.loss_scalar == tb.loss_scalar:
            first = tb.loss_scalar
    local_rows = [t.shape[0] for t in tb.state.opt_state["mu"]["hashgrid"]]
    tb.save_snapshot(path)
    whole = tb.state._replace(opt_state=pt.gather_opt_state(tb.state.opt_state,
                                                            tb.state.params, ctx))
    return {"world": world, "first": first, "last": tb.loss_scalar, "steps": tb.training_step,
            "local_rows": local_rows, "state": interop.state_to_pathdict(whole)}


def _testbed_dynamic(ctx, cfg) -> dict:
    """The replicated dynamic Testbed: pose refinement, finetune, frame 1."""
    hyper = Hyperparams(first_frame_max_training_step=16, next_frame_max_training_step=8,
                        predict_global_movement=True, predict_global_movement_training_step=4)
    tb = Testbed(cfg, hyper, device="cpu")
    tb.enable_multichip(world=ctx.world)
    tb.load_training_data_from_datasets(
        make_moving_sphere_frames(n_frames=2, n_views=6, resolution=32))
    while tb.frame():
        pass
    return {"frame": tb.current_training_time_frame, "last": tb.loss_scalar,
            "delta": interop.tree_to_numpy(tb.state.delta)}


def _wait_for(path: Path, timeout_s: float = 600.0) -> dict:
    end = time.monotonic() + timeout_s
    while not path.exists():
        if time.monotonic() > end:
            raise TimeoutError(f"no {path} after {timeout_s} s")
        time.sleep(0.1)
    return torch.load(path, weights_only=False)


def run(ctx, testbeds: dict, jobs_path: str) -> dict:
    """The Testbed runs first, while the test process runs JAX; then the
    injected-draw steps from the jobs it writes to ``jobs_path``."""
    torch.set_num_threads(1)
    out = {"static": _testbed_static_zero1(ctx, testbeds["static"], testbeds["snapshot"]),
           "dynamic": _testbed_dynamic(ctx, testbeds["dynamic"])}
    jobs = _wait_for(Path(jobs_path))
    if jobs is None:  # the JAX side failed
        return out
    out.update({name: _steps(ctx, job) for name, job in jobs.items()})
    return out
