"""Full-scale training validation on the synthetic sphere scene: the L14/F2
2^19 grid in fp32, 4096 rays x 64 samples, 256 candidates, eikonal and
mask loss 0.1, on 16 views at 256^2, then the mean |SDF| on 512 points of
the true sphere and the PSNR of training view 0 rendered at spp 1 (port of
the TPU package's ``tools_tpu_validate.py``).

Resumable in chunks: each call trains until the target, ``--budget-s``
seconds or ``--chunk-steps`` steps and writes a snapshot; call again
until it prints DONE.  No snapshot holds the adaptive bucket, so a
resumed chunk starts in bucket 0 and re-votes, as the TPU tool's does.
Files in ``--workdir``: ``tpu_validate[_seed<n>].msgpack``, ``.json``
(the result, the TPU tool's keys) and ``_record.json`` (each chunk's
cost and the occ_len trace).

  python -m neus2_tpu_torch.tools.validate [TARGET=1200] [--seed N]
      [--budget-s S] [--workdir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from neus2_tpu_torch.api.testbed import Hyperparams, Testbed
from neus2_tpu_torch.data.synthetic import make_sphere_dataset
from neus2_tpu_torch.engine.train import TrainConfig
from neus2_tpu_torch.models.field import FieldConfig
from neus2_tpu_torch.ops.hashgrid import HashGridConfig
from neus2_tpu_torch.ops.image import psnr, srgb_eval_target
from neus2_tpu_torch.tools import protocol
from neus2_tpu_torch.utils.device import resolve_device

RES = 256  # the views' side


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("target", type=int, nargs="?", default=1200, help="steps to train to")
    p.add_argument("--seed", type=int, default=0, help="the Testbed's seed")
    p.add_argument("--budget-s", type=float, default=480.0, help="seconds of training a call")
    p.add_argument("--chunk-steps", type=int, default=None, help="steps of training a call")
    p.add_argument("--workdir", type=Path, default=protocol.DEFAULT_WORKDIR)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def validate_config() -> TrainConfig:
    """``tools_tpu_validate.py`` :36-49, field by field."""
    return TrainConfig(
        field=FieldConfig(
            grid=HashGridConfig(
                n_levels=14, log2_hashmap_size=19, base_resolution=16,
                per_level_scale=HashGridConfig.per_level_scale_from_top(16, 2048, 14),
            )
        ),
        n_rays=4096,
        samples_per_ray=64,
        n_candidates=256,
        ek_loss_weight=0.1,
        mask_loss_weight=0.1,
    )


def run(opts, config: TrainConfig | None = None) -> dict | None:
    """One call of the tool: the result once the target is reached, else
    None (a snapshot to resume from is on disk)."""
    resolve_device(opts.device)
    config = config or validate_config()
    opts.workdir.mkdir(parents=True, exist_ok=True)
    stem = opts.workdir / ("tpu_validate" + (f"_seed{opts.seed}" if opts.seed else ""))
    snap, meta = stem.with_suffix(".msgpack"), stem.with_suffix(".json")
    record_path = stem.with_name(stem.name + "_record.json")
    tb = Testbed(config=config, hyper=Hyperparams(first_frame_max_training_step=opts.target),
                 seed=opts.seed, device=opts.device)
    tb.load_training_data_from_datasets([make_sphere_dataset(n_views=16, resolution=RES)])
    if snap.exists():
        tb.load_snapshot(snap)
        print(f"resumed at step {tb.training_step}", flush=True)

    rec = protocol.train_chunk(tb, opts.target, opts.budget_s, opts.chunk_steps)
    tb.save_snapshot(snap)
    protocol.record_chunk(record_path, rec)
    print(f"paused/finished at step {tb.training_step} [{rec['wall_s']:.0f}s]", flush=True)
    if tb.training_step < opts.target:
        return None

    shell = protocol.sphere_shell(512, float32_first=False)
    err = protocol.surface_sdf_err(tb.state.ema_params, config.field, shell)
    with torch.no_grad():  # the target of :79-85 is srgb_eval_target's
        rgb, _, _ = tb.render(0, spp=1)
        tex = tb.images[0]
        p = float(psnr(torch.as_tensor(rgb, device=tex.device), srgb_eval_target(tex)))
    out = {"steps": tb.training_step, "shell_sdf": err, "psnr": p}
    protocol.write_json(meta, out)
    print(f"DONE steps={tb.training_step} shell|sdf|={err:.4f} train-view PSNR={p:.2f}",
          flush=True)
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
