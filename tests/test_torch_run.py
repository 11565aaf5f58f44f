"""The port's CLI on the CPU, on a static scene and on a directory of two
per-frame jsons, and a port Testbed built from a JAX Testbed's state
(``interop.testbed_from_jax``) rendering and meshing as the JAX Testbed
does.

Tolerances: the Testbed's renders at spp 1 are deterministic in both
packages, so rgb, depth and alpha agree to max |diff| <= 1e-4, with 384
candidates and 256 samples a ray, which keep out the marcher's rounding
ties (tests/test_torch_render_mesh.py, ``MARCH_TIES``), except that a
sample at the 1e-4 transmittance cut may be kept by one package and not
the other (3e-4, as there).  Mesh vertices agree to 1e-5 with equal
triangles on a grid with no SDF value within 1e-6 of the level set (the
packages' grid values differ by < 1e-6, so a value closer to it can take
either sign and change the topology).
"""

import argparse
import dataclasses
import json
import math
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from neus2_tpu.api.testbed import Hyperparams as JHyperparams
from neus2_tpu.api.testbed import Testbed as JTestbed
from neus2_tpu.data.export import save_dataset_na
from neus2_tpu.data.synthetic import make_moving_sphere_frames as jax_frames
from neus2_tpu.data.synthetic import make_sphere_dataset as jax_sphere
from neus2_tpu.engine.mesh import sdf_grid as jsdf_grid
from neus2_tpu.engine.train import TrainConfig as JTrainConfig
from neus2_tpu.models.field import FieldConfig as JFieldConfig
from neus2_tpu.ops.hashgrid import HashGridConfig as JGrid
from neus2_tpu.ops.warp import scene_aabb as jaabb
from neus2_tpu import run as jrun
from neus2_tpu.utils import camera_path as jcamera_path
from neus2_tpu_torch import interop, run
from neus2_tpu_torch.api import msgpack_codec
from neus2_tpu_torch.api.ngp_snapshot import load_reference_snapshot, save_reference_snapshot
from neus2_tpu_torch.utils import camera_path
from neus2_tpu_torch.data.export import save_dataset_na as port_save_dataset_na
from neus2_tpu_torch.data.synthetic import make_multi_sphere_dataset, make_sphere_dataset
from neus2_tpu_torch.engine.train import TrainConfig
from neus2_tpu_torch.models.field import FieldConfig
from neus2_tpu_torch.ops.hashgrid import HashGridConfig
from neus2_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

_GRID = dict(n_levels=4, log2_hashmap_size=12, base_resolution=16, per_level_scale=1.45)
_FIELD = dict(sdf_hidden_dim=16, rgb_hidden_dim=16)
_TRAIN = dict(n_rays=256, samples_per_ray=16, n_candidates=64, occ_n_probe=1 << 12)
NETWORK = {
    "encoding": {"n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 12,
                 "base_resolution": 16, "per_level_scale": 1.45},
    "network": {"n_neurons": 16, "n_hidden_layers": 1},
    "rgb_network": {"n_neurons": 16, "n_hidden_layers": 2},
    "hyperparams": {"first_frame_max_training_step": 2000, "ek_loss_weight": 0.1},
}


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    save_dataset_na(jax_sphere(n_views=6, resolution=24, seed=0), d / "train")
    test = save_dataset_na(jax_sphere(n_views=2, resolution=24, seed=1), d / "test")
    (d / "net.json").write_text(json.dumps(NETWORK))
    return d, test


def test_cli_trains_meshes_and_evaluates(scene_dir):
    d, test = scene_dir
    tb = run.main([
        "--scene", str(d / "train" / "transforms.json"), "--network", str(d / "net.json"),
        "--name", "exp", "--output_dir", str(d / "out"), "--n_steps", "12",
        "--n_rays", "256", "--samples_per_ray", "16", "--save_mesh",
        "--mesh_resolution", "32", "--test_transforms", str(test), "--eval_spp", "1",
        "--device", "cpu",
    ])
    assert tb.training_step == 12 and tb.config.n_rays == 256
    assert tb.config.field.grid.n_levels == 4 and tb.hyper.ek_loss_weight == 0.1
    out = d / "out" / "exp"
    assert (out / "mesh" / "mesh.obj").exists() and (out / "log.txt").exists()
    metrics = json.loads((out / "metrics.json").read_text())
    assert len(metrics["psnr"]) == 2 and all(np.isfinite(metrics["psnr"]))
    assert 0.0 < metrics["ssim_mean"] <= 1.0


def test_cli_dynamic_scene_writes_transforms_and_meshes(tmp_path, capsys):
    scene = tmp_path / "dyn"
    scene.mkdir()
    for k, ds in enumerate(jax_frames(n_frames=2, n_views=4, resolution=16)):
        js = Path(save_dataset_na(ds, tmp_path / f"f{k}"))
        meta = json.loads(js.read_text())
        for f in meta["frames"]:
            f["file_path"] = str(js.parent / f["file_path"])
        (scene / f"frame_{k:03d}.json").write_text(json.dumps(meta))
    net = dict(NETWORK, hyperparams={"predict_global_movement": True,
                                     "predict_global_movement_training_step": 2})
    (tmp_path / "net.json").write_text(json.dumps(net))
    tb = run.main([
        "--scene", str(scene), "--network", str(tmp_path / "net.json"), "--name", "dyn",
        "--output_dir", str(tmp_path / "out"), "--n_steps", "4", "--next_frame_steps", "4",
        "--n_rays", "64", "--samples_per_ray", "16", "--dynamic_save_mesh", "--save_mesh",
        "--mesh_resolution", "16", "--eval_per_frame", "--device", "cpu",
    ])
    assert tb.is_dynamic and tb.current_training_time_frame == 1 and tb.training_step == 4
    assert tb.train_canonical and tb.train_delta and tb.use_delta
    out = tmp_path / "out" / "dyn"
    rows = {k: np.loadtxt(out / "checkpoints" / f"transform_{k}.txt") for k in (0, 1)}
    assert all(r.shape == (3, 4) and np.isfinite(r).all() for r in rows.values())
    # Frame 0 trains no delta, but its file is written after the switch's
    # first refinement step, as the JAX package's CLI writes it: frame 1's
    # delta has moved one Adam step (lr 1e-4 a DoF).  The last frame's file
    # holds its live delta.
    np.testing.assert_allclose(rows[0], np.hstack([np.eye(3), np.zeros((3, 1))]), atol=3e-4)
    np.testing.assert_allclose(rows[1][:, :3], tb.effective_acc["rotation"].numpy(), atol=1e-7)
    assert not np.array_equal(rows[1], rows[0])
    assert (out / "mesh" / "frame_0000.obj").exists() and (out / "mesh" / "mesh.obj").exists()
    log = (out / "log.txt").read_text()
    assert "2 time frame(s)" in log and "-> time frame 1 at step 5" in log
    assert "frame 0 view-0 PSNR" in log and "frame 1 view-0 PSNR" in log
    # Frame 0's snapshot is incremental (no optimizer state) and, like its
    # transform, written after the switch's first step, as the JAX CLI
    # writes it; the final one is whole.
    frame0 = msgpack_codec.unpackb((out / "checkpoints" / "frame_0.msgpack").read_bytes())
    assert frame0["incremental"] is True
    assert (int(frame0["meta"]["frame"]), int(frame0["meta"]["training_step"])) == (1, 1)
    assert not any(k.startswith(".opt_state") for k in frame0["leaves"])
    final = msgpack_codec.unpackb((out / "checkpoints" / "final.msgpack").read_bytes())
    assert final["incremental"] is False and int(final["meta"]["frame"]) == 1
    assert int(final["meta"]["training_step"]) == 4
    assert "per-frame snapshots are skipped" not in capsys.readouterr().out
    # Resumed in frame 1, the loop writes no frame-0 files.
    tb = run.main([
        "--scene", str(scene), "--network", str(tmp_path / "net.json"), "--name", "resumed",
        "--output_dir", str(tmp_path / "out"), "--n_steps", "4", "--next_frame_steps", "4",
        "--n_rays", "64", "--samples_per_ray", "16", "--device", "cpu",
        "--snapshot", str(out / "checkpoints" / "frame_0.msgpack"),
    ])
    assert (tb.current_training_time_frame, tb.training_step) == (1, 4)
    assert sorted(p.name for p in (tmp_path / "out" / "resumed" / "checkpoints").iterdir()) == [
        "final.msgpack", "transform_1.txt"]


def test_cli_defaults_to_the_card():
    args = run.parse_args(["--scene", "s.json"])
    assert args.device == "cuda" and args.eval_spp == 8 and args.mesh_resolution == 256


def test_testbed_from_jax_renders_and_meshes_as_jax(tmp_path):
    jcfg = JTrainConfig(field=JFieldConfig(grid=JGrid(**_GRID), **_FIELD), **_TRAIN)
    jtb = JTestbed(config=jcfg, hyper=JHyperparams(first_frame_max_training_step=0))
    jtb.load_training_data_from_datasets([jax_sphere(n_views=3, resolution=20, seed=4)])
    p = dict(jtb.state.params)
    p["hashgrid"] = tuple(t * 30.0 for t in p["hashgrid"])  # some texture
    jtb.state = jtb.state._replace(ema_params=p)

    tcfg = TrainConfig(field=FieldConfig(grid=HashGridConfig(**_GRID), **_FIELD), **_TRAIN)
    tb = interop.testbed_from_jax(jax.device_get(jtb.state), jtb.hyper, tcfg,
                                  make_sphere_dataset(n_views=3, resolution=20, seed=4))
    assert tb.config == interop_config(jtb.config, tcfg)
    assert int(tb.state.occupancy.bitfield.sum()) == int(jtb.state.occupancy.bitfield.sum())

    jrc = dataclasses.replace(jtb._default_render_cfg(), samples_per_ray=256)
    trc = dataclasses.replace(tb._default_render_cfg(), samples_per_ray=256)
    assert jrc.n_candidates == trc.n_candidates == 384
    for mode in ("shade", "depth"):
        ref = jtb.render(img_idx=1, spp=1, mode=mode, render_cfg=jrc)
        got = tb.render(img_idx=1, spp=1, mode=mode, render_cfg=trc)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=0, atol=3e-4)
    assert float(got[2].max()) > 0.1

    box = jaabb(1)
    grid = jsdf_grid(jtb.state.ema_params, jcfg.field, box.lo, box.hi, box.lo, box.diag,
                     resolution=24)
    assert float(np.abs(np.asarray(grid)).min()) > 1e-6
    jv, jt = jtb.compute_and_save_marching_cubes_mesh(tmp_path / "j.obj", resolution=24)
    tv, tt = tb.compute_and_save_marching_cubes_mesh(tmp_path / "t.obj", resolution=24)
    assert len(tt) > 100
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)


def interop_config(jcfg, tcfg):
    """The port config with the JAX Testbed's dataset-derived fields."""
    return dataclasses.replace(tcfg, **{k: getattr(jcfg, k) for k in (
        "aabb_scale", "occ_cascades", "n_candidates", "occ_n_probe")})


def test_cli_snapshots_resume_and_render_outputs(scene_dir):
    """Train with periodic snapshots, then resume the final one with
    --no_train and write screenshots, a camera path and eval panels; the
    resumed state evaluates exactly as the trained one did."""
    d, test = scene_dir
    common = ["--scene", str(d / "train" / "transforms.json"), "--network", str(d / "net.json"),
              "--output_dir", str(d / "out"), "--n_rays", "256", "--samples_per_ray", "16",
              "--test_transforms", str(test), "--eval_spp", "1", "--device", "cpu"]
    tb = run.main([*common, "--name", "snap", "--n_steps", "8", "--save_snapshot_every", "4"])
    ckpt = d / "out" / "snap" / "checkpoints"
    assert sorted(p.name for p in ckpt.glob("*.msgpack")) == ["4.msgpack", "8.msgpack",
                                                              "final.msgpack"]
    trained = json.loads((d / "out" / "snap" / "metrics.json").read_text())

    shots = d / "shots"
    tb2 = run.main([*common, "--name", "resumed", "--snapshot", str(ckpt / "final.msgpack"),
                    "--no_train", "--screenshot_transforms", str(test), "--screenshot_dir",
                    str(shots), "--screenshot_spp", "1", "--screenshot_frames", "1",
                    "--render_path", "orbit", "--render_n_frames", "2", "--save_eval_images"])
    out = d / "out" / "resumed"
    assert tb2.training_step == 8 and tb2.state.step == tb.state.step
    assert not (out / "checkpoints" / "final.msgpack").exists()  # nothing trained
    assert json.loads((out / "metrics.json").read_text()) == trained
    assert [p.name for p in shots.glob("*.png")] == ["0001.png"]
    assert np.asarray(Image.open(shots / "0001.png")).shape == (24, 24, 3)
    assert sorted(p.name for p in (out / "frames").glob("*.png")) == ["frame_0000.png",
                                                                      "frame_0001.png"]
    panels = sorted((out / "evaluation").glob("*.png"))
    assert [p.name for p in panels] == ["view_000.png", "view_001.png"]
    assert np.asarray(Image.open(panels[0])).shape == (24, 72, 3)  # render | GT | 4 |diff|


@pytest.mark.parametrize("F", [4, 8])
def test_cli_trains_at_wider_rows(scene_dir, tmp_path, F):
    """``--network`` with a small JSON of tpu_opt.json's 4 or l4f8.json's
    8 features a level: the CLI trains, meshes and evaluates; its
    final.msgpack resumed with --no_train holds every leaf bitwise and
    evaluates to the same metrics; the reference-format export of its
    params reloads to the same tables up to fp16 and into a Testbed."""
    d, test = scene_dir
    net = dict(NETWORK, encoding=dict(NETWORK["encoding"], n_levels=3, n_features_per_level=F))
    (tmp_path / "net.json").write_text(json.dumps(net))
    common = ["--scene", str(d / "train" / "transforms.json"), "--network",
              str(tmp_path / "net.json"), "--output_dir", str(tmp_path / "out"), "--n_rays",
              "256", "--samples_per_ray", "16", "--test_transforms", str(test), "--eval_spp",
              "1", "--device", "cpu"]
    tb = run.main([*common, "--name", "wide", "--n_steps", "8", "--save_mesh",
                   "--mesh_resolution", "32"])
    assert tb.training_step == 8 and tb.config.field.grid.n_features_per_level == F
    assert [tuple(t.shape) for t in tb.state.params["hashgrid"]] == [
        (s, F) for s in tb.config.field.grid.level_tables()[3]]
    out = tmp_path / "out" / "wide"
    assert (out / "mesh" / "mesh.obj").exists()
    trained = json.loads((out / "metrics.json").read_text())
    assert all(np.isfinite(trained["psnr"]))

    tb2 = run.main([*common, "--name", "resumed", "--snapshot",
                    str(out / "checkpoints" / "final.msgpack"), "--no_train"])
    for a, b in zip(tree_leaves(tb.state.params), tree_leaves(tb2.state.params)):
        assert torch.equal(a, b)
    assert json.loads((tmp_path / "out" / "resumed" / "metrics.json").read_text()) == trained

    ref = tmp_path / "ref.msgpack"
    ema = interop.tree_to_numpy(tb.state.ema_params)
    save_reference_snapshot(ref, ema, tb.config.field,
                            density_grid=tb.state.occupancy.density.numpy())
    back = load_reference_snapshot(ref)
    assert back["config"].grid == tb.config.field.grid
    for ours, theirs in zip(ema["hashgrid"], back["params"]["hashgrid"]):
        np.testing.assert_array_equal(ours.astype("<f2").astype(np.float32), theirs)
    tb2.load_snapshot(ref)
    assert [tuple(t.shape) for t in tb2.state.params["hashgrid"]] == [
        tuple(t.shape) for t in tb.state.params["hashgrid"]]


def test_jax_cli_snapshot_evaluated_by_port_cli(scene_dir):
    """A JAX CLI run's final.msgpack, loaded by the port's CLI with
    --no_train: each eval view's PSNR within what the render tolerance
    (max |diff| <= 3e-4 a channel) allows around the JAX CLI's: an RMS
    error e becomes one in [e - 3e-4, e + 3e-4]."""
    d, test = scene_dir
    common = ["--scene", str(d / "train" / "transforms.json"), "--network", str(d / "net.json"),
              "--output_dir", str(d / "cross"), "--n_rays", "256", "--samples_per_ray", "16",
              "--test_transforms", str(test), "--eval_spp", "1"]
    jrun.main([*common, "--name", "jax", "--n_steps", "6"])
    final = d / "cross" / "jax" / "checkpoints" / "final.msgpack"
    tb = run.main([*common, "--name", "port", "--snapshot", str(final), "--no_train",
                   "--device", "cpu"])
    assert tb.training_step == 6
    want = json.loads((d / "cross" / "jax" / "metrics.json").read_text())["psnr"]
    got = json.loads((d / "cross" / "port" / "metrics.json").read_text())["psnr"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        rmse = 10.0 ** (-w / 20.0)
        assert -20 * math.log10(rmse + 3e-4) <= g <= -20 * math.log10(rmse - 3e-4)


def test_camera_path_matches_jax(tmp_path):
    for ours, theirs in ((camera_path.orbit_path(), jcamera_path.orbit_path()),
                         (camera_path.orbit_path(radius=2.0, n_keyframes=5, fov_deg=30.0),
                          jcamera_path.orbit_path(radius=2.0, n_keyframes=5, fov_deg=30.0))):
        assert ours.loop == theirs.loop and len(ours.keyframes) == len(theirs.keyframes)
        for u in np.linspace(0.0, 1.0, 13):
            a, b = ours.eval(float(u)), theirs.eval(float(u))
            np.testing.assert_array_equal(a.pose, b.pose)
            assert a.fov_deg == b.fov_deg
    rng = np.random.default_rng(0)
    kfs = [camera_path.Keyframe(np.hstack([np.linalg.qr(rng.normal(size=(3, 3)))[0],
                                           rng.normal(size=(3, 1))]).astype(np.float32),
                                float(rng.uniform(30, 60))) for _ in range(4)]
    camera_path.CameraPath(keyframes=kfs).save(tmp_path / "path.json")
    ours, theirs = (camera_path.CameraPath.load(tmp_path / "path.json"),
                    jcamera_path.CameraPath.load(tmp_path / "path.json"))
    for u in np.linspace(0.0, 1.0, 9):
        np.testing.assert_array_equal(ours.eval(float(u)).pose, theirs.eval(float(u)).pose)



def test_cli_trains_a_scene_larger_than_the_unit_cube(tmp_path):
    """A scene written with ``"aabb_scale": 4`` (tests/test_cascades.py's
    two spheres, one outside the unit cube) through the CLI: the Testbed
    derives 3 cascades and 512 candidates, trains, meshes over the
    aabb_scale-4 box and evaluates; final.msgpack holds the scale and the
    3-cascade grid.  The network json's ``init_radius`` reaches the field.
    (One run: its prior sweep probes 3 x 128^3 cells.)"""
    spheres = [(np.array([0.5, 0.5, 0.5], np.float32), 0.25),
               (np.array([1.25, 0.5, 0.5], np.float32), 0.3)]
    kw = dict(resolution=24, cam_distance=2.6, aabb_scale=4)
    train = port_save_dataset_na(make_multi_sphere_dataset(spheres, n_views=6, seed=0, **kw),
                                 tmp_path / "train")
    test = port_save_dataset_na(make_multi_sphere_dataset(spheres, n_views=2, seed=1, **kw),
                                tmp_path / "test")
    assert json.loads(train.read_text())["aabb_scale"] == 4
    network = {**NETWORK, "network": {**NETWORK["network"], "init_radius": 0.2}}
    (tmp_path / "net.json").write_text(json.dumps(network))
    common = ["--scene", str(train), "--network", str(tmp_path / "net.json"), "--output_dir",
              str(tmp_path / "out"), "--n_rays", "256", "--samples_per_ray", "16",
              "--test_transforms", str(test), "--eval_spp", "1", "--device", "cpu"]
    tb = run.main([*common, "--name", "a4", "--n_steps", "6", "--save_mesh",
                   "--mesh_resolution", "32"])
    assert tb.training_step == 6 and tb.config.aabb_scale == 4
    assert tb.config.field.init_radius == 0.2
    assert (tb.config.occ_cascades, tb.config.n_candidates) == (3, 512)
    assert tb.config.cone_angle == 1.0 / 256 and tb.state.occupancy.n_cascades == 3
    out = tmp_path / "out" / "a4"
    assert (out / "mesh" / "mesh.obj").read_text().count("\nf ") > 100
    trained = json.loads((out / "metrics.json").read_text())
    assert all(np.isfinite(trained["psnr"]))

    payload = msgpack_codec.unpackb((out / "checkpoints" / "final.msgpack").read_bytes())
    assert int(payload["meta"]["aabb_scale"]) == 4
    np.testing.assert_array_equal(payload["leaves"][".occupancy.bitfield"],
                                  tb.state.occupancy.bitfield.numpy())
    assert payload["leaves"][".occupancy.density"].shape == (3, 128, 128, 128)


def _parser(parse_args) -> argparse.ArgumentParser:
    """The ArgumentParser a CLI's ``parse_args`` builds."""
    seen = []
    parse = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen.append(self)
        return parse(self, args, namespace)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        parse_args(["--scene", "s.json"])
    return seen[0]


def test_cli_takes_the_jax_command_line():
    """One JAX-spelled command line carrying every option both CLIs
    define, each set away from its default, parses to the same namespace
    in both, key by key.  The port has one option more, ``--device``, and
    none fewer."""
    jax_p, port_p = _parser(jrun.parse_args), _parser(run.parse_args)

    def options(p):
        return {s: a for a in p._actions for s in a.option_strings if s not in ("-h", "--help")}

    jax_o, port_o = options(jax_p), options(port_p)
    assert set(port_o) - set(jax_o) == {"--device"}
    assert set(jax_o) - set(port_o) == set()
    argv = []
    for flag, action in jax_o.items():
        if action.nargs == 0:  # store_true
            argv.append(flag)
        elif action.choices:
            argv += [flag, next(c for c in action.choices if c != action.default)]
        elif action.nargs == "*":
            argv += [flag, "1", "2"]
        elif action.type in (int, float):
            argv += [flag, "3"]
        else:
            argv += [flag, f"value-of-{flag[2:]}"]
    ours, theirs = vars(run.parse_args(argv)), vars(jrun.parse_args(argv))
    assert ours.pop("device") == "cuda" and theirs["tensorboard"] is True
    assert ours.keys() == theirs.keys()
    for k in theirs:
        assert ours[k] == theirs[k], k
    assert ours["fp16_images"] is True
