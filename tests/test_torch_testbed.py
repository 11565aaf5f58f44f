"""Port parity of the static Testbed path: the dataset loader against the
JAX package's on a scene its exporter writes, the dataset-derived config
and the adaptive batch bucket against the JAX Testbed's, and a whole
150-step static Testbed on tests/test_testbed.py's tiny config with that
file's checks (the two packages draw different random numbers, so the
trained states are compared by the same bounds, not to each other).

Tolerances: decoded images to 1e-6 (both decode the same PNGs, in every
pixel format, the port through the repo's native decoder or Pillow, the
JAX package through its own build of the same decoder); poses and
intrinsics exactly.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from neus2_tpu.api import testbed as jtb
from neus2_tpu.data.dataset import load_dataset as jax_load_dataset
from neus2_tpu.data.export import save_dataset_na
from neus2_tpu.data.synthetic import make_sphere_dataset as jax_sphere
from neus2_tpu.engine import train as jtrain
from neus2_tpu.models.field import FieldConfig as JFieldConfig
from neus2_tpu.ops.hashgrid import HashGridConfig as JGrid
from neus2_tpu_torch.api import testbed as ttb
from neus2_tpu_torch.api.testbed import Hyperparams
from neus2_tpu_torch.data.dataset import (
    NerfDataset, list_frame_jsons, load_dataset, nerf_matrix_to_ngp, ngp_matrix_to_nerf,
)
from neus2_tpu_torch.data.synthetic import make_sphere_dataset
from neus2_tpu_torch.engine import train as ttrain
from neus2_tpu_torch.models.field import FieldConfig
from neus2_tpu_torch.ops.hashgrid import HashGridConfig

torch.set_num_threads(2)

_GRID = dict(n_levels=6, log2_hashmap_size=14, base_resolution=16, per_level_scale=1.45)
_TINY = dict(n_rays=384, samples_per_ray=32, n_candidates=96, ek_loss_weight=0.1,
             mask_loss_weight=0.1, occ_n_probe=1 << 12)


def tiny_config(**kw) -> ttrain.TrainConfig:
    """tests/test_testbed.py:20-37's config, in the port."""
    field = FieldConfig(grid=HashGridConfig(**_GRID), sdf_hidden_dim=32, rgb_hidden_dim=32)
    return ttrain.TrainConfig(field=field, **{**_TINY, **kw})


def jax_tiny_config(**kw) -> jtrain.TrainConfig:
    field = JFieldConfig(grid=JGrid(**_GRID), sdf_hidden_dim=32, rgb_hidden_dim=32)
    return jtrain.TrainConfig(field=field, **{**_TINY, **kw})


@pytest.fixture(scope="module")
def static_testbed():
    tb = ttb.Testbed(config=tiny_config(), hyper=Hyperparams(first_frame_max_training_step=150),
                 device="cpu")
    tb.load_training_data_from_datasets([make_sphere_dataset(10, 40)])
    while tb.frame():
        pass
    return tb


def test_static_training_runs(static_testbed):
    tb = static_testbed
    assert tb.training_step == 150 and not tb.frame()
    assert np.isfinite(tb.loss_scalar) and tb.loss_scalar < 0.05
    assert tb.last_aux is not None and tb.last_aux.n_valid_samples > 0


def test_render_surface(static_testbed):
    rgb, depth, alpha = static_testbed.render(img_idx=0, spp=1)
    assert rgb.shape == (40, 40, 3) and depth.shape == alpha.shape == (40, 40)
    assert 0.05 < float(alpha.mean()) < 0.9  # the object covers part of the view
    normals, _, _ = static_testbed.render(0, mode="normals")
    assert np.isfinite(normals).all()


def test_mesh_export(static_testbed, tmp_path):
    verts, tris = static_testbed.compute_and_save_marching_cubes_mesh(
        tmp_path / "mesh.obj", resolution=96)
    assert len(verts) > 100 and len(tris) > 100
    assert (tmp_path / "mesh.obj").exists()
    radii = np.linalg.norm(verts - 0.5, axis=-1)
    assert 0.15 < float(np.median(radii)) < 0.45
    # PLY with vertex colours and normals, and a crop box.
    v2, _ = static_testbed.compute_and_save_marching_cubes_mesh(
        tmp_path / "mesh.ply", resolution=48, aabb=((0.2, 0.2, 0.2), (0.8, 0.8, 0.5)))
    text = (tmp_path / "mesh.ply").read_text()
    assert "property uchar red" in text and "property float nx" in text
    assert len(v2) and float(v2[:, 2].max()) <= 0.5 + 1e-6


def test_zero_sample_abort():
    """Cameras that never see the box give a step with no samples: the
    Testbed warns and stops training (reference train_nerf,
    testbed_nerf.cu:3542-3548)."""
    ds = make_sphere_dataset(2, 8)
    ds.poses[:, :, 3] = 5.0  # outside the box, looking away from it
    tb = ttb.Testbed(config=tiny_config(), hyper=Hyperparams(first_frame_max_training_step=5),
                 device="cpu")
    tb._datasets = [ds]
    tb._load_frame(0)
    tb._derive_config()
    tb.state = ttrain.init_train_state(tb.config, ds.n_images, seed=0, device="cpu")
    assert tb.frame()
    assert int(tb.last_aux.n_valid_samples) == 0 and not tb.shall_train
    assert not tb.frame()


@pytest.mark.parametrize("aabb_scale", [1, 4, 16])
def test_derived_config_matches_jax(monkeypatch, aabb_scale):
    """Cascades, candidates and probe budget from aabb_scale, as the JAX
    Testbed derives them (its fresh state is not drawn here)."""
    monkeypatch.setattr(jtb, "init_train_state", lambda *a, **k: None)
    monkeypatch.setattr(jtrain, "occupancy_prior_sweep", lambda state, cfg: state)
    jds = dataclasses.replace(jax_sphere(2, 8), aabb_scale=aabb_scale)
    jt = jtb.Testbed(config=jax_tiny_config())
    jt.load_training_data_from_datasets([jds])
    tds = dataclasses.replace(make_sphere_dataset(2, 8), aabb_scale=aabb_scale)
    tb = ttb.Testbed(config=tiny_config(), device="cpu")
    tb._datasets = [tds]
    tb._load_frame(0)
    tb._derive_config()
    for name in ("aabb_scale", "occ_cascades", "n_candidates", "occ_n_probe", "n_rays",
                 "samples_per_ray", "cone_angle"):
        assert getattr(tb.config, name) == getattr(jt.config, name), name


@pytest.mark.parametrize("samples,occ_len", [
    (64, 0.0), (64, 0.05), (64, 0.1), (64, 0.3), (64, 1.5), (32, 0.02), (128, 0.01),
])
def test_desired_batch_bucket_matches_jax(samples, occ_len):
    t = ttrain.desired_batch_bucket(occ_len, dataclasses.replace(tiny_config(),
                                                                 samples_per_ray=samples))
    j = jtrain.desired_batch_bucket(occ_len, dataclasses.replace(jax_tiny_config(),
                                                                 samples_per_ray=samples))
    assert t == j


def test_error_map_raises():
    with pytest.raises(NotImplementedError):
        tiny_config(use_error_map=True)


def test_adaptive_bucket_switches_after_three_reads():
    tb = ttb.Testbed(config=tiny_config(samples_per_ray=64), device="cpu")
    want = ttrain.desired_batch_bucket(0.01, tb.config)
    assert want > 0
    for _ in range(2):
        tb._update_batch_bucket(0.01)
    assert tb.batch_bucket == 0
    tb._update_batch_bucket(0.01)
    assert tb.batch_bucket == want
    cfg = tb._frame_config()
    assert (cfg.n_rays, cfg.samples_per_ray) == (384 << want, 64 >> want)


@pytest.fixture(scope="module")
def exported_scene(tmp_path_factory):
    ds = jax_sphere(n_views=3, resolution=24, seed=2)
    ds = dataclasses.replace(ds, scale=0.5, offset=(0.5, 0.4, 0.5))
    return save_dataset_na(ds, tmp_path_factory.mktemp("scene"))


def test_load_dataset_matches_jax(exported_scene):
    j = jax_load_dataset(exported_scene)
    t = load_dataset(exported_scene)
    assert isinstance(t, NerfDataset)
    np.testing.assert_allclose(t.images, j.images, rtol=0, atol=1e-6)
    for name in ("poses", "focal", "principal"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    for name in ("scale", "offset", "aabb_scale", "from_na", "paths", "resolution"):
        assert getattr(t, name) == getattr(j, name), name
    images, cams = t.to_device("cpu")
    assert images.shape == (3, 24, 24, 4) and cams.resolution == (24, 24)
    assert list_frame_jsons(exported_scene) == [Path(exported_scene)]
    assert len(load_dataset(exported_scene, n_frames_cap=2).poses) == 2


def _rewrite_frames(scene: str, dest: Path, kind: str) -> Path:
    """A copy of ``scene`` whose frames are PNGs of another pixel format,
    drawn from a seed: "rgba" keeps the exported frames, "palette" is an
    8-entry palette with a tRNS alpha per entry, "grey_alpha" is 8-bit
    grey + alpha, "grey16" is 16-bit grey, "rgb_key" and "grey_key" carry
    a tRNS colour key (that colour is transparent)."""
    from PIL import Image

    src = Path(scene)
    dest.mkdir()
    meta = json.loads(src.read_text())
    rng = np.random.default_rng(len(kind))
    for frame in meta["frames"]:
        out = dest / frame["file_path"]
        out.parent.mkdir(parents=True, exist_ok=True)
        im = Image.open(src.parent / frame["file_path"])
        h, w = im.height, im.width
        if kind == "palette":
            im = Image.fromarray(rng.integers(0, 8, (h, w), dtype=np.uint8), "P")
            im.putpalette(rng.integers(0, 256, 24, dtype=np.uint8).tobytes())
            im.save(out, transparency=bytes([0, 40, 128, 200, 255, 255, 90, 10]))
            continue
        if kind == "grey_alpha":
            im = Image.fromarray(rng.integers(0, 256, (h, w, 2), dtype=np.uint8), "LA")
        elif kind == "grey16":
            im = Image.fromarray(rng.integers(0, 65536, (h, w), dtype=np.uint16))
        elif kind in ("rgb_key", "grey_key"):
            shape = (h, w, 3) if kind == "rgb_key" else (h, w)
            im = Image.fromarray(rng.integers(0, 2, shape, dtype=np.uint8) * 255)
            im.save(out, transparency=(0, 0, 0) if kind == "rgb_key" else 0)
            continue
        im.save(out)
    out_json = dest / src.name
    out_json.write_text(json.dumps(meta))
    return out_json


@pytest.mark.parametrize("decoder", ["native", "pillow"])
@pytest.mark.parametrize("kind", ["rgba", "palette", "grey_alpha", "grey16", "rgb_key",
                                  "grey_key"])
def test_load_dataset_pixel_formats_match_jax(exported_scene, tmp_path, monkeypatch, decoder,
                                              kind):
    """Every PNG pixel format decodes as in the JAX package, through the
    native decoder and through Pillow, which takes over where the decoder
    cannot be built."""
    from neus2_tpu_torch import native

    scene = _rewrite_frames(exported_scene, tmp_path / kind, kind)
    want = jax_load_dataset(scene).images
    if decoder == "pillow":
        monkeypatch.setattr(native, "_image_lib", lambda: None)
    got = load_dataset(scene).images
    assert got.shape == want.shape == (3, 24, 24, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if kind not in ("rgba", "grey16"):  # the file's alpha was read
        assert float(got[..., 3].min()) < 0.2


def test_decoder_build_failure_is_remembered(monkeypatch, capsys):
    """Where the native decoder cannot be built, the build is tried once a
    process and its reason printed once; every later load goes straight to
    Pillow."""
    from neus2_tpu_torch import native

    calls = []

    def no_png(name, libs=()):
        calls.append(name)
        raise RuntimeError("c++ failed for image_loader.cpp:\n\n"
                           "image_loader.cpp:9:10: fatal error: png.h: No such file")

    native._image_lib.cache_clear()
    monkeypatch.setattr(native.host_build, "load", no_png)
    try:
        assert native.decode_images(["a.png", "b.png"]) == [None, None]
        assert native.decode_images(["c.png"]) == [None]
    finally:
        native._image_lib.cache_clear()
    assert calls == ["image_loader"]
    err = capsys.readouterr().err
    assert err.count("native image decoder unavailable") == 1 and "png.h" in err


def test_unported_scene_options_raise(exported_scene, tmp_path):
    meta = json.loads(Path(exported_scene).read_text())
    meta["k1"] = 0.1
    for f in meta["frames"]:
        f["file_path"] = str(Path(exported_scene).parent / f["file_path"])
    bad = tmp_path / "distorted.json"
    bad.write_text(json.dumps(meta))
    with pytest.raises(NotImplementedError):
        load_dataset(bad)


@pytest.mark.parametrize("from_na", [True, False])
def test_pose_conversions_match_jax(from_na):
    from neus2_tpu.data import dataset as jds

    rng = np.random.default_rng(int(from_na))
    mat = rng.normal(size=(4, 4)).astype(np.float32)
    offset = np.array([0.5, 0.4, 0.6], np.float32)
    t = nerf_matrix_to_ngp(mat, 0.33, offset, from_na)
    np.testing.assert_array_equal(t, jds.nerf_matrix_to_ngp(mat, 0.33, offset, from_na))
    np.testing.assert_array_equal(ngp_matrix_to_nerf(t, 0.33, offset, from_na),
                                  jds.ngp_matrix_to_nerf(t, 0.33, offset, from_na))
