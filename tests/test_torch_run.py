"""The port's static CLI on the CPU, and a port Testbed built from a JAX
Testbed's state (``interop.testbed_from_jax``) rendering and meshing as
the JAX Testbed does.

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

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from neus2_tpu.api.testbed import Hyperparams as JHyperparams
from neus2_tpu.api.testbed import Testbed as JTestbed
from neus2_tpu.data.export import save_dataset_na
from neus2_tpu.data.synthetic import make_sphere_dataset as jax_sphere
from neus2_tpu.engine.mesh import sdf_grid as jsdf_grid
from neus2_tpu.engine.train import TrainConfig as JTrainConfig
from neus2_tpu.models.field import FieldConfig as JFieldConfig
from neus2_tpu.ops.hashgrid import HashGridConfig as JGrid
from neus2_tpu.ops.warp import scene_aabb as jaabb
from neus2_tpu_torch import interop, run
from neus2_tpu_torch.data.synthetic import make_sphere_dataset
from neus2_tpu_torch.engine.train import TrainConfig
from neus2_tpu_torch.models.field import FieldConfig
from neus2_tpu_torch.ops.hashgrid import HashGridConfig

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


@pytest.mark.parametrize("flags", [["--mode", "sdf"], ["--snapshot", "x.msgpack"],
                                   ["--multichip", "on"]])
def test_cli_unported_paths_raise(flags, tmp_path):
    with pytest.raises(NotImplementedError):
        run.main(["--scene", "none.json", "--device", "cpu", "--output_dir", str(tmp_path),
                  *flags])


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
