"""The converged occupied chord (occ_len) at a constructed operating point,
on the functional path (port of the TPU package's ``tools_occ_char.py``).

The bench's flagship config (bf16 L14/F2, 4096 rays x 64 samples) on the
16-view 256^2 sphere: from the state drawn with ``SEED``, the prior sweep,
then WARM steps (an occupancy update before every 4th), then the variance
set to its converged 0.75, the occupancy grid reset and re-swept RESWEEP
times, and ``mean_occ_len`` read from MEASURE further steps.  Prints the
``OCCCHAR`` line (per-step values and the adaptive bucket the mean asks
for at the config's factor) and writes ``occ_char_s<SEED>_w<WARM>.json``
to ``--workdir``.

  python -m neus2_tpu_torch.tools.occ_char [SEED=0] [WARM=48] [RESWEEP=80]
      [MEASURE=8] [--workdir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

from neus2_tpu_torch.data.synthetic import make_sphere_dataset
from neus2_tpu_torch.engine import occupancy as occ
from neus2_tpu_torch.engine.train import (
    TrainConfig,
    desired_batch_bucket,
    init_train_state,
    occupancy_prior_sweep,
    occupancy_update,
    train_step,
)
from neus2_tpu_torch.tools import protocol
from neus2_tpu_torch.utils.device import resolve_device

CONVERGED_VARIANCE = 0.75
RES = 256  # the views' side


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("seed", type=int, nargs="?", default=0, help="the state's seed")
    p.add_argument("warm", type=int, nargs="?", default=48, help="warm training steps")
    p.add_argument("resweep", type=int, nargs="?", default=80,
                   help="occupancy updates after the reset")
    p.add_argument("measure", type=int, nargs="?", default=8, help="steps read")
    p.add_argument("--workdir", type=Path, default=protocol.DEFAULT_WORKDIR)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def converge(state, config: TrainConfig, resweep: int, jitters=None):
    """The variance set to ``CONVERGED_VARIANCE``, the occupancy grid reset
    and updated ``resweep`` times (:69-78); ``jitters`` (one probe jitter an
    update) are drawn from the state's generator when None."""
    variance = torch.full_like(state.params["variance"], CONVERGED_VARIANCE)
    state = state._replace(params={**state.params, "variance": variance},
                           occupancy=occ.reset_density(state.occupancy))
    for i in range(resweep):
        state = occupancy_update(state, config, jitter=None if jitters is None else jitters[i])
    return state


def measure(state, images, cameras, config: TrainConfig, n: int, draws=None):
    """(state, ``mean_occ_len`` of each of ``n`` steps) (:80-83); ``draws``
    (one ``StepDraws`` a step) are drawn from the state's generator when
    None."""
    vals = []
    for i in range(n):
        state, aux = train_step(state, images, cameras, config,
                                draws=None if draws is None else draws[i])
        vals.append(float(aux.mean_occ_len))
    return state, vals


def run(opts, config: TrainConfig | None = None) -> dict:
    """The tool's measurement; ``config`` defaults to the flagship config."""
    dev = resolve_device(opts.device)
    config = config or protocol.flagship_config()
    ds = make_sphere_dataset(n_views=16, resolution=RES)
    images, cameras = ds.to_device(dev)
    launches0 = protocol.segment_sum_rows.launches
    t0 = time.perf_counter()
    state = init_train_state(config, n_images=ds.n_images, seed=opts.seed, device=dev)
    state = occupancy_prior_sweep(state, config)
    aux = None
    for i in range(opts.warm):  # an occupancy update before every 4th step (:63-66)
        if i % 4 == 0:
            state = occupancy_update(state, config)
        state, aux = train_step(state, images, cameras, config)
    loss = float(aux.loss) if aux is not None else float("nan")
    print(f"warm {opts.warm} steps: {time.perf_counter() - t0:.0f}s loss={loss:.5f}",
          flush=True)
    state = converge(state, config, opts.resweep)
    state, vals = measure(state, images, cameras, config, opts.measure)
    mean = sum(vals) / len(vals)
    out = {"seed": opts.seed, "warm": opts.warm, "resweep": opts.resweep,
           "occ_len_mean": mean, "occ_len_min": min(vals), "occ_len_max": max(vals),
           "per_step": vals, "bucket_of_mean": desired_batch_bucket(mean, config),
           "factor": config.adaptive_samples_factor, "warm_loss": loss,
           "kernel1_launches": protocol.segment_sum_rows.launches - launches0,
           "train_steps": opts.warm + opts.measure, "wall_s": time.perf_counter() - t0,
           "card": protocol.card_name()}
    print(f"OCCCHAR seed={opts.seed} warm={opts.warm} resweep={opts.resweep} "
          f"occ_len mean={mean:.4f} min={min(vals):.4f} max={max(vals):.4f} "
          f"per_step={[round(v, 4) for v in vals]} "
          f"bucket(mean)={out['bucket_of_mean']}", flush=True)
    opts.workdir.mkdir(parents=True, exist_ok=True)
    protocol.write_json(opts.workdir / f"occ_char_s{opts.seed}_w{opts.warm}.json", out)
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
