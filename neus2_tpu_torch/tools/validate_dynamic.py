"""Dynamic-scene validation at full scale: the L14/F2 2^19 grid in fp32 on
a sphere moved by (0.03, 0, 0) a frame, 2 frames of 12 views at 128^2;
300 steps of frame 0, then frame 1's pose refinement (80 steps at delta
lr 5e-3, no finetune of the delta after it) and its 120 steps in all, and
the learned delta translation, which should come near [-0.03, 0, 0] (port
of the TPU package's ``tools_tpu_validate_dynamic.py``).

Resumable: a call stops after ``--budget-s`` seconds or ``--chunk-steps``
steps with a snapshot (whose meta block replays the frame and its phase
flags); call again until it prints DONE.  Files in ``--workdir``:
``tpu_dyn_validate.msgpack``, ``.json`` (the learned delta and
the effective transform's error against the known motion) and
``_record.json`` (each chunk's cost, kernel-1 launches by frame and
phase, the occ_len trace).

  python -m neus2_tpu_torch.tools.validate_dynamic [--budget-s S] [--workdir DIR]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from neus2_tpu_torch.api.testbed import Hyperparams, Testbed
from neus2_tpu_torch.data.synthetic import make_moving_sphere_frames
from neus2_tpu_torch.engine.train import TrainConfig
from neus2_tpu_torch.models.field import FieldConfig
from neus2_tpu_torch.ops.hashgrid import HashGridConfig
from neus2_tpu_torch.tools import protocol
from neus2_tpu_torch.utils.device import resolve_device

SHIFT = (0.03, 0.0, 0.0)
RES = 128  # the views' side


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--budget-s", type=float, default=460.0, help="seconds of training a call")
    p.add_argument("--chunk-steps", type=int, default=None, help="steps of training a call")
    p.add_argument("--workdir", type=Path, default=protocol.DEFAULT_WORKDIR)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def dynamic_config() -> TrainConfig:
    """``tools_tpu_validate_dynamic.py`` :27-36, field by field."""
    return TrainConfig(
        field=FieldConfig(
            grid=HashGridConfig(
                n_levels=14, log2_hashmap_size=19, base_resolution=16,
                per_level_scale=HashGridConfig.per_level_scale_from_top(16, 2048, 14),
            )
        ),
        n_rays=4096, samples_per_ray=64, n_candidates=256,
        ek_loss_weight=0.1, mask_loss_weight=0.1, delta_lr=5e-3,
    )


def dynamic_hyper() -> Hyperparams:
    """The tool's :37-43."""
    return Hyperparams(
        first_frame_max_training_step=300,
        next_frame_max_training_step=120,
        predict_global_movement=True,
        predict_global_movement_training_step=80,
        finetune_global_movement=False,
    )


def run(opts, config: TrainConfig | None = None) -> dict | None:
    """One call of the tool: the result once the last frame is done, else
    None (a snapshot to resume from is on disk)."""
    resolve_device(opts.device)
    opts.workdir.mkdir(parents=True, exist_ok=True)
    stem = opts.workdir / "tpu_dyn_validate"
    snap, meta = stem.with_suffix(".msgpack"), stem.with_suffix(".json")
    record_path = stem.with_name(stem.name + "_record.json")
    tb = Testbed(config=config or dynamic_config(), hyper=dynamic_hyper(), device=opts.device)
    tb.load_training_data_from_datasets(make_moving_sphere_frames(  # the tool's :44-46
        n_frames=2, translation_per_frame=SHIFT, n_views=12, resolution=RES))
    if snap.exists():
        tb.load_snapshot(snap)
        print(f"resumed frame {tb.current_training_time_frame} step {tb.training_step}",
              flush=True)

    chunk = protocol.Chunk(tb, opts.budget_s)
    launches = {}  # "<frame> <canonical|refine>" -> kernel-1 launches
    while True:
        before = protocol.segment_sum_rows.launches
        if not chunk.step(tb.frame):
            break
        key = (f"{tb.current_training_time_frame} "
               f"{'canonical' if tb.train_canonical else 'refine'}")
        launches[key] = launches.get(key, 0) + protocol.segment_sum_rows.launches - before
        if tb.training_step % 50 == 0:
            print(f"frame {tb.current_training_time_frame} step {tb.training_step} "
                  f"loss={tb.loss_scalar:.5f} [{chunk.elapsed():.0f}s]", flush=True)
        if not chunk.running() or chunk.steps == opts.chunk_steps:
            tb.save_snapshot(snap)
            protocol.record_chunk(record_path, dict(chunk.close(), launches=launches))
            print(f"paused at frame {tb.current_training_time_frame} step "
                  f"{tb.training_step} [{chunk.elapsed():.0f}s]", flush=True)
            return None
    protocol.record_chunk(record_path, dict(chunk.close(), launches=launches))
    delta = tb.state.delta["transition"].detach().cpu().numpy()
    t = tb.effective_acc["transition"].detach().cpu().numpy()
    out = {"frame": tb.current_training_time_frame, "steps": tb.training_step,
           "delta_transition": delta.tolist(), "want": [-s for s in SHIFT],
           "pose_err": float(np.linalg.norm(t + np.asarray(SHIFT)))}
    protocol.write_json(meta, out)
    snap.unlink(missing_ok=True)
    print(f"DONE: learned delta trans={np.round(delta, 4)} (want ~[-0.03, 0, 0]); "
          f"|t err| {out['pose_err']:.4f}", flush=True)
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
