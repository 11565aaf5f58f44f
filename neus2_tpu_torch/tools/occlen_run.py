"""The occupied chord (occ_len) and the adaptive bucket over a real run:
the bench's flagship config (bf16 L14/F2, 4096 rays x 64 samples) on the
16-view 256^2 sphere through the Testbed (adaptive buckets, hysteresis,
occupancy cadence), with [step, occ_len EMA, bucket, loss, occ_len]
every 16 steps, the trained rays/s of each bucket over stable stretches
and, at the target, the mean |SDF| on 512 points of the true sphere
(port of the TPU package's ``tools_occlen_run.py``).

Resumable in chunks; a resumed chunk starts in bucket 0 and re-votes, as
the TPU tool's does.  Files in ``--workdir``: ``occlen_<tag>.msgpack``,
``.json`` (the TPU tool's keys: steps, seed, occ_hist, final_bucket,
final_occ_ema, rates, sdf_err) and ``_record.json`` (each chunk's cost).

  python -m neus2_tpu_torch.tools.occlen_run [TARGET=2000] [--seed N]
      [--tag NAME] [--budget-s S] [--workdir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from neus2_tpu_torch.api.testbed import Hyperparams, Testbed
from neus2_tpu_torch.data.synthetic import make_sphere_dataset
from neus2_tpu_torch.engine.train import TrainConfig
from neus2_tpu_torch.tools import protocol
from neus2_tpu_torch.utils.device import resolve_device

RES = 256  # the views' side


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("target", type=int, nargs="?", default=2000, help="steps to train to")
    p.add_argument("--seed", type=int, default=0, help="the Testbed's seed")
    p.add_argument("--tag", default=None, help="the files' tag (default s<seed>)")
    p.add_argument("--budget-s", type=float, default=480.0, help="seconds of training a call")
    p.add_argument("--chunk-steps", type=int, default=None, help="steps of training a call")
    p.add_argument("--workdir", type=Path, default=protocol.DEFAULT_WORKDIR)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def run(opts, config: TrainConfig | None = None) -> dict:
    """One call of the tool: the run's record so far ("sdf_err" once the
    target is reached)."""
    resolve_device(opts.device)
    config = config or protocol.flagship_config()
    opts.workdir.mkdir(parents=True, exist_ok=True)
    stem = opts.workdir / f"occlen_{opts.tag or f's{opts.seed}'}"
    snap, meta = stem.with_suffix(".msgpack"), stem.with_suffix(".json")
    record_path = stem.with_name(stem.name + "_record.json")
    tb = Testbed(config=config, hyper=Hyperparams(first_frame_max_training_step=opts.target),
                 seed=opts.seed, device=opts.device)
    tb.load_training_data_from_datasets([make_sphere_dataset(n_views=16, resolution=RES)])
    if snap.exists():
        tb.load_snapshot(snap)
        print(f"resumed at step {tb.training_step}", flush=True)

    rec = protocol.train_chunk(tb, opts.target, opts.budget_s, opts.chunk_steps, log_every=200)
    run_rec = protocol.record_chunk(record_path, rec)
    rates = {}
    for c in run_rec["chunks"]:  # each bucket's most recent stable stretch
        rates.update(c["rates"])
    out = {
        "steps": tb.training_step,
        "seed": opts.seed,
        "occ_hist": run_rec["occ_hist"],
        "final_bucket": tb.batch_bucket,
        "final_occ_ema": float(tb._occ_len_ema or 0.0),
        "rates": rates,
    }
    if tb.training_step >= opts.target:
        shell = protocol.sphere_shell(512, float32_first=False)
        out["sdf_err"] = protocol.surface_sdf_err(tb.state.ema_params, config.field, shell)
        print("DONE", flush=True)
    else:
        tb.save_snapshot(snap)
        print(f"paused at step {tb.training_step} [{rec['wall_s']:.0f}s]", flush=True)
    protocol.write_json(meta, out)
    print(json.dumps({k: v for k, v in out.items() if k != "occ_hist"}), flush=True)
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
