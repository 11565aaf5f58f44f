"""The quality tools of ``neus2_tpu_torch/tools/`` run end to end on the
CPU at a small width: each writes a result with the keys of the TPU
package's root tool it ports (read from that tool's source), resumes from
its own files, and fails, rather than reporting a null, when the mesh
cannot be made."""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from neus2_tpu_torch.ops.hashgrid import HashGridConfig
from neus2_tpu_torch.tools import bucket_ab, csg_eval, dynamic_quality, protocol, validate_csg

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
_GRID = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=12,
             base_resolution=16, per_level_scale=2.0)


def small(cfg):
    """``cfg`` at a small width and batch."""
    return dataclasses.replace(
        cfg, field=dataclasses.replace(cfg.field, grid=HashGridConfig(**_GRID),
                                       sdf_hidden_dim=16, rgb_hidden_dim=16),
        n_rays=256, samples_per_ray=32, n_candidates=64, occ_n_probe=1 << 12)


def tool_keys(tool: str, name: str) -> set:
    """The string keys the root tool ``tool`` gives the dict ``name``: its
    dict literal's and those it assigns by subscript afterwards."""
    keys = set()
    for node in ast.walk(ast.parse((REPO / tool).read_text())):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name and isinstance(node.value, ast.Dict):
                    keys |= {k.value for k in node.value.keys}
                if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                        and t.value.id == name and isinstance(t.slice, ast.Constant)):
                    keys.add(t.slice.value)
    assert keys, (tool, name)
    return keys


VALIDATE_FLAGS = ["--views", "4", "--eval-views", "2", "--res", "24", "--error-map",
                  "--budget-s", "1e9", "--device", "cpu"]


@pytest.fixture(autouse=True)
def serial_views_small_mesh(monkeypatch):
    """The views rendered in this process, the Chamfer mesh on a 32^3
    lattice."""
    monkeypatch.setattr(protocol, "default_workers", lambda: 1)
    monkeypatch.setattr(validate_csg, "MESH_RES", 32)


def test_validate_csg_and_csg_eval_end_to_end(tmp_path, monkeypatch):
    """validate_csg's result has the root tool's keys and finite metrics;
    csg_eval on its snapshot at the same samples and spp gives the same
    held-out PSNR and SSIM (same field, same seeded passes)."""
    monkeypatch.setattr(validate_csg, "N_GT_POINTS", 2048)
    opts = validate_csg.parse_args(["20", *VALIDATE_FLAGS, "--workdir", str(tmp_path)])
    out = validate_csg.run(opts, small(validate_csg.csg_config(error_map=True)))
    assert set(out) == tool_keys("tools_tpu_validate_csg.py", "out")
    assert out["steps"] == 20 and len(out["per_view_psnr"]) == 2
    assert all(v == v for v in (out["held_out_psnr"], out["surface_sdf_err"], out["chamfer"]))
    tag = validate_csg.run_tag(opts)
    assert json.loads((tmp_path / f"{tag}.json").read_text()) == out
    rec = json.loads((tmp_path / f"{tag}_record.json").read_text())
    assert rec["card"] is None and rec["chunks"][0]["steps"] == 20
    assert rec["chunks"][0]["losses_finite"] and rec["evals"][0]["mesh_vertices"] > 0

    eopts = csg_eval.parse_args([str(tmp_path / f"{tag}.msgpack"), "--views", "4", "--res", "24",
                                 "--workdir", str(tmp_path), "--device", "cpu"])
    assert csg_eval.trained_with_error_map(eopts.snapshot)
    again = csg_eval.run(eopts, small(validate_csg.csg_config()))
    assert again["steps"] == 20
    assert again["per_view_psnr"] == out["per_view_psnr"]
    assert again["ssim"] == pytest.approx(out["held_out_ssim"], abs=1e-12)


def test_bucket_ab_restores_its_history_on_resume(tmp_path, monkeypatch):
    """At factor 0.01 the small run switches to bucket 1 at step 32 (three
    agreeing 16-step reads); paused at 40 and resumed, the tool restores the
    bucket and the occ_len EMA from the history, which no snapshot holds,
    and the result has the root tool's keys."""
    argv = ["0.01", "48", "--res", "24", "--budget-s", "1e9", "--device", "cpu",
            "--workdir", str(tmp_path)]
    opts = bucket_ab.parse_args([*argv, "--chunk-steps", "40"])
    assert bucket_ab.run(opts, small(protocol.flagship_config())) is None
    hist = json.loads((tmp_path / "bucket_ab_f0p01_24_hist.json").read_text())
    assert [h[:2] for h in hist] == [[32, 1]]
    restored = []
    restore = bucket_ab.restore_bucket

    def spy(tb, h):
        restore(tb, h)
        restored.append((tb.training_step, tb.batch_bucket, tb._occ_len_ema))

    monkeypatch.setattr(bucket_ab, "restore_bucket", spy)
    out = bucket_ab.run(bucket_ab.parse_args(argv), small(protocol.flagship_config()))
    assert restored == [(40, 1, hist[0][2])]
    assert set(out) == tool_keys("tools_bucket_ab.py", "out")
    assert out["steps"] == 48 and out["bucket_history"] == hist
    assert out["shell_sdf_err"] == out["shell_sdf_err"] and len(out["per_view_psnr"]) == 4


def test_dynamic_quality_resumes_and_keeps_earlier_frames(tmp_path):
    """Stopped in frame 1's pose refinement, the run's partial results hold
    frame 0; resumed, it ends with both frames and the root tool's keys."""
    argv = ["--frames", "2", "--views", "4", "--res", "24", "--frame0-steps", "20",
            "--refine-steps", "8", "--next-steps", "16", "--delta-lr", "1e-2", "--c2f",
            "--device", "cpu", "--workdir", str(tmp_path)]
    opts = dynamic_quality.parse_args([*argv, "--chunk-steps", "24"])
    cfg = small(dynamic_quality.make_config(opts))
    assert dynamic_quality.run(opts, cfg) is None
    partial = json.loads((tmp_path / "dynamic_quality_partial.json").read_text())
    assert len(partial["per_frame_psnr"]) == 1 and partial["pose_err"] == [0.0]
    out = dynamic_quality.run(dynamic_quality.parse_args(argv), cfg)
    assert set(out) == tool_keys("tools_dynamic_quality.py", "results")
    assert out["per_frame_psnr"][0] == partial["per_frame_psnr"][0]
    assert len(out["pose_err"]) == 2 and 0.0 < out["pose_err"][1] < 1.0
    assert not (tmp_path / "dynamic_quality.msgpack").exists()
    rec = json.loads((tmp_path / "dynamic_quality_record.json").read_text())
    assert [c["steps"] for c in rec["chunks"]] == [24, 12]


# A field whose init sphere (radius 0.9 about the centre) holds the whole
# mesh box [0.15, 0.85]^3: no zero crossing, no mesh.
EMPTY_MESH_RUN = """
import dataclasses, sys
sys.path.insert(0, {tests!r})
from test_torch_quality_runs import small
from neus2_tpu_torch.tools import protocol, validate_csg as vc
protocol.default_workers = lambda: 1
vc.MESH_RES = 32
config = vc.csg_config
def inside(*args):
    cfg = small(config(*args))
    return dataclasses.replace(cfg, field=dataclasses.replace(cfg.field, init_radius=0.9))
vc.csg_config = inside
sys.exit(vc.main(sys.argv[1:]))
"""


def test_validate_csg_exits_nonzero_when_the_mesh_fails(tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", EMPTY_MESH_RUN.format(tests=str(REPO / "tests")), "0",
         *VALIDATE_FLAGS, "--workdir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert res.returncode != 0
    assert "mesh is empty" in res.stderr
    assert "DONE" not in res.stdout and "eval view" in res.stdout
