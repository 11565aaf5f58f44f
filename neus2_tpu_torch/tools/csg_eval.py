"""Evaluate a finished validation snapshot again with other render
settings, to tell model quality from the eval's sampling error (port of
the TPU package's ``tools_csg_eval.py``).

The flags name the training run's protocol (views, held-out views, image
side, grid, scene); whether it sampled by the error map is read from the
snapshot.  The views come from ``--workdir``'s dataset cache when it
holds them.  Prints each held-out view's PSNR and SSIM and their means.

  python -m neus2_tpu_torch.tools.csg_eval <snapshot.msgpack> [samples=128]
      [spp=8] [--views 48] [--eval-views 2] [--res 256] [--config parity]
      [--scene csg] [--workdir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np

from neus2_tpu_torch.api import msgpack_codec
from neus2_tpu_torch.api.testbed import Hyperparams, Testbed
from neus2_tpu_torch.data.synthetic import SCENES
from neus2_tpu_torch.engine.train import TrainConfig
from neus2_tpu_torch.tools import protocol, validate_csg
from neus2_tpu_torch.utils.device import resolve_device
from neus2_tpu_torch.utils.variants import FLAGSHIP_VARIANTS


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("snapshot", type=Path)
    p.add_argument("samples", type=int, nargs="?", default=128, help="samples a ray")
    p.add_argument("spp", type=int, nargs="?", default=8, help="passes a pixel")
    p.add_argument("--views", type=int, default=48, help="training views")
    p.add_argument("--eval-views", type=int, default=2, help="held-out views after them")
    p.add_argument("--res", type=int, default=256, help="image side")
    p.add_argument("--config", choices=sorted(FLAGSHIP_VARIANTS), default="parity")
    p.add_argument("--scene", choices=sorted(SCENES), default="csg")
    p.add_argument("--workdir", type=Path, default=protocol.DEFAULT_WORKDIR)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def trained_with_error_map(snapshot: Path) -> bool:
    """Whether the run that wrote ``snapshot`` sampled its rays by the
    error map: only such a run deposits into it.  The Testbed sizes its
    map from the images only then, and a load needs the same shape."""
    leaves = msgpack_codec.unpackb(snapshot.read_bytes())["leaves"]
    return bool(np.any(np.asarray(leaves[".error_map.error_map"])))


def run(opts, config: TrainConfig | None = None) -> dict:
    """(per-view and mean PSNR / SSIM) of the snapshot's held-out views."""
    resolve_device(opts.device)  # no card: fail before rendering a view
    # The field evaluates in fp32 whatever the run trained in.
    config = dataclasses.replace(config or validate_csg.csg_config(opts.config),
                                 use_error_map=trained_with_error_map(opts.snapshot))
    n_train, n_eval = opts.views, opts.eval_views
    ds = protocol.scene_dataset(opts.scene, n_train + n_eval, opts.res, opts.workdir)
    tb = Testbed(config=config, hyper=Hyperparams(), device=opts.device)
    tb.load_training_data_from_datasets([ds.subset(slice(0, n_train))])
    tb.load_snapshot(opts.snapshot)
    print(f"snapshot at step {tb.training_step}", flush=True)
    ids = range(n_train, n_train + n_eval)
    ps, ss = protocol.heldout_eval(tb.state, config.field, ds, ids, samples=opts.samples,
                                   candidates=max(256, opts.samples * 2), spp=opts.spp)
    for k, p, s in zip(ids, ps, ss):
        print(f"view {k}: PSNR {p:.2f} SSIM {s:.4f} (samples={opts.samples}, spp={opts.spp})",
              flush=True)
    out = {"steps": tb.training_step, "per_view_psnr": ps, "per_view_ssim": ss,
           "psnr": float(np.mean(ps)), "ssim": float(np.mean(ss))}
    print(f"mean PSNR {out['psnr']:.2f} dB  SSIM {out['ssim']:.4f}", flush=True)
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
