"""Bucket-geometry continuation A/B: one trained state (a 2,000-step
snapshot of the flagship config on the sphere) branched into one adaptive
bucket's geometry, (4096 << B) rays x (64 >> B) samples with the adaptive
switch off, trained EXTRA steps past the branch point (the TPU tool
trains to 2,000 + EXTRA: its branch points were at 2,000), then the
held-out PSNR / SSIM and the mean |SDF| on 2,048 points of the true
sphere (port of the TPU package's ``tools_bucket_cont.py``).  Every bucket trains the same 2^18
samples a step; bucket 3 (32768 x 8) is the finest the Testbed votes for.

``--base`` names the branch point; by default the ``compact_ab`` x1
sphere snapshot in ``--workdir`` (``tools/compact_ab.py 1``; the TPU
record's round 3 branched the factor-0.75 ``bucket_ab`` snapshot,
``bucket_ab_f0p75.msgpack``).  Resumable: later calls resume from the
branch's own snapshot.  Files in ``--workdir``:
``bucket_cont_b<B>[_<tag>].msgpack``, ``.json`` (the TPU tool's keys) and
``_record.json`` (each chunk's cost and the occ_len trace).

  python -m neus2_tpu_torch.tools.bucket_cont BUCKET [EXTRA=800]
      [--base SNAPSHOT] [--tag NAME] [--budget-s S] [--workdir DIR]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from neus2_tpu_torch.api.testbed import Testbed
from neus2_tpu_torch.engine.train import TrainConfig
from neus2_tpu_torch.tools import compact_ab, protocol
from neus2_tpu_torch.utils.device import resolve_device

RES = 256  # the views' side


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("bucket", type=int, choices=range(4), help="the fixed bucket")
    p.add_argument("extra", type=int, nargs="?", default=800, help="steps past the branch")
    p.add_argument("--base", type=Path, default=None,
                   help="the branch snapshot (default: compact_ab's x1 sphere run)")
    p.add_argument("--tag", default="", help="a suffix of the file names")
    p.add_argument("--budget-s", type=float, default=420.0, help="seconds of training a call")
    p.add_argument("--chunk-steps", type=int, default=None, help="steps of training a call")
    p.add_argument("--workdir", type=Path, default=protocol.DEFAULT_WORKDIR)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def run(opts, config: TrainConfig | None = None) -> dict | None:
    """One call of the tool: the result once the target is reached, else
    None (a snapshot to resume from is on disk).  ``config`` (default the
    flagship config) is taken into ``opts.bucket``'s geometry."""
    resolve_device(opts.device)
    config = protocol.fixed_bucket(config or protocol.flagship_config(), opts.bucket)
    opts.workdir.mkdir(parents=True, exist_ok=True)
    stem = opts.workdir / (f"bucket_cont_b{opts.bucket}" + (f"_{opts.tag}" if opts.tag else ""))
    snap, meta = stem.with_suffix(".msgpack"), stem.with_suffix(".json")
    record_path = stem.with_name(stem.name + "_record.json")
    base = opts.base or compact_ab.snapshot_path(opts.workdir)
    train_ds, eval_ds, eval_ids = protocol.ab_scene("sphere", RES, None)
    tb = Testbed(config=config, device=opts.device)
    tb.load_training_data_from_datasets([train_ds])
    src = snap if snap.exists() else base
    tb.load_snapshot(src)
    print(f"resumed from {src} at step {tb.training_step}", flush=True)
    base_step = protocol.read_json(record_path, {}).get("base_step", tb.training_step)
    target = base_step + opts.extra
    tb.hyper.first_frame_max_training_step = target

    rec = protocol.train_chunk(tb, target, opts.budget_s, opts.chunk_steps, log_every=200)
    tb.save_snapshot(snap)
    protocol.record_chunk(record_path, rec, base=str(base), base_step=base_step)
    print(f"paused/finished at step {tb.training_step}", flush=True)
    if tb.training_step < target:
        return None
    psnrs, ssims = protocol.heldout_eval(tb.state, config.field, eval_ds, eval_ids)
    shell = protocol.sphere_shell(2048, float32_first=True)
    out = {
        "bucket": opts.bucket,
        "rays": config.n_rays,
        "samples": config.samples_per_ray,
        "steps": tb.training_step,
        "held_out_psnr": float(np.mean(psnrs)),
        "held_out_ssim": float(np.mean(ssims)),
        "per_view_psnr": psnrs,
        "shell_sdf_err": protocol.surface_sdf_err(tb.state.ema_params, config.field, shell),
    }
    protocol.write_json(meta, out)
    print("DONE", json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
