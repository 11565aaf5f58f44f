"""The port's loader extras and lens models held against ``neus2_tpu``:
the Brown-Conrady, FTheta and rolling-shutter camera functions and
``pixel_to_ray`` for each camera model, per-pixel ray files, the EXR codec
(bitwise in both directions across the two packages' codecs), every field
``load_dataset`` returns on the same files, training steps through the lens
models, the mixed-size eval, renders through the dataset's lens, the
sharpen paths, fp16 texel storage and ``save_density_grid_png`` through
the CLI.  The counterparts of tests/test_loader_extras.py and
tests/test_distortion_depth.py (the envmap, the depth loader and depth
supervision are in tests/test_torch_camera.py).

Tolerances, fp32 on the CPU: the camera functions and rays 1e-6 abs; the
loaded images 1e-6 (the two packages decode PNG with different decoders),
every other loaded field, and EXR data, bitwise; a training step's loss and
aux rtol 1e-5 and its state under tests/test_torch_dynamic_step.py's rule;
renders 1e-4 abs.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from neus2_tpu.api.testbed import Hyperparams as JHyperparams
from neus2_tpu.api.testbed import Testbed as JTestbed
from neus2_tpu.api.testbed import config_from_json as jax_config_from_json
from neus2_tpu.data import exr as jexr
from neus2_tpu.data.dataset import load_dataset as jax_load_dataset
from neus2_tpu.data.synthetic import make_sphere_dataset as jax_sphere
from neus2_tpu.engine import rays as jrays
from neus2_tpu.engine import render as jrender
from neus2_tpu.engine import train as jt
from neus2_tpu.engine.mesh import save_density_grid_png as jax_density_png
from neus2_tpu.models import delta as jdelta
from neus2_tpu.ops.warp import scene_aabb as jax_scene_aabb
from neus2_tpu_torch import interop, run
from neus2_tpu_torch.api import testbed as ttb
from neus2_tpu_torch.api.testbed import config_from_json
from neus2_tpu_torch.data import exr
from neus2_tpu_torch.data.dataset import load_dataset
from neus2_tpu_torch.data.synthetic import make_sphere_dataset
from neus2_tpu_torch.engine import rays
from neus2_tpu_torch.engine import render as trender
from neus2_tpu_torch.engine import train as tt
from neus2_tpu_torch.ops import hashgrid_fast
from test_distortion_depth import FTHETA, PARAMS
from test_distortion_depth import _write_scene as write_depth_scene
from test_loader_extras import _write_scene as write_extras_scene
from test_torch_dynamic_step import _close
from test_torch_render_mesh import scene  # noqa: F401  (the render fixture)
from test_torch_train_step import _step_draws

torch.set_num_threads(2)
LENS = np.asarray(PARAMS)  # k1 -0.12, k2 0.03, p1 0.004, p2 -0.002


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _near(got, ref, atol=1e-6):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol)


# -- camera functions -------------------------------------------------------------


@pytest.mark.parametrize("fn", ["distort", "undistort", "ftheta"])
def test_camera_functions_match_jax(fn):
    """apply_camera_distortion, iterative_undistortion (which inverts it to
    1e-5, and is the identity without a lens: test_distortion_depth.py:27,
    37) and ftheta_undistortion (the defining polynomial, :208) to 1e-6."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.6, 0.6, 256).astype(np.float32)
    y = rng.uniform(-0.6, 0.6, 256).astype(np.float32)
    if fn == "distort":
        for got, ref in zip(rays.apply_camera_distortion(_t(LENS), _t(x), _t(y)),
                            jrays.apply_camera_distortion(jnp.asarray(LENS), x, y)):
            _near(got, ref)
    elif fn == "undistort":
        du, dv = rays.apply_camera_distortion(_t(LENS), _t(x), _t(y))
        xu, yu = rays.iterative_undistortion(_t(LENS), _t(x) + du, _t(y) + dv)
        jxu, jyu = jrays.iterative_undistortion(jnp.asarray(LENS), x + du.numpy(), y + dv.numpy())
        _near(xu, jxu)
        _near(yu, jyu)
        _near(xu, x, 1e-5)
        _near(yu, y, 1e-5)
        z = torch.zeros(4)
        assert torch.equal(rays.iterative_undistortion(z, _t(x), _t(y))[0], _t(x))
    else:
        duv = rng.uniform(-0.45, 0.45, (256, 2)).astype(np.float32)
        duv[0] = 0.0  # the principal pixel: invalid, +z
        d, valid = rays.ftheta_undistortion(_t(FTHETA), _t(duv))
        jd, jvalid = jrays.ftheta_undistortion(jnp.asarray(FTHETA), jnp.asarray(duv))
        _near(d, jd)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        assert not bool(valid[0]) and int(valid.sum()) > 200
        d, ok = d.numpy(), valid.numpy()
        r = np.hypot(duv[:, 0] * FTHETA[5], duv[:, 1] * FTHETA[6])
        p = FTHETA
        alpha = p[0] + r * (p[1] + r * (p[2] + r * (p[3] + r * p[4])))
        np.testing.assert_allclose(np.arctan2(np.hypot(d[ok, 0], d[ok, 1]), d[ok, 2]),
                                   alpha[ok], atol=1e-5)


def _camera_pair(model: str):
    """(JAX Cameras, port Cameras) of 3 views at 40x30 (max) with the
    camera model ``model`` on top of the pinhole."""
    rng = np.random.default_rng(1)
    poses = np.tile(np.eye(4, dtype=np.float32)[:3], (3, 1, 1))
    poses[:, :, :3] += rng.normal(0, 0.05, (3, 3, 3)).astype(np.float32)
    poses[:, :, 3] = rng.uniform(-0.2, 0.2, (3, 3)).astype(np.float32)
    kw = {}
    if model == "brown_conrady":
        kw["distortion"] = LENS
    elif model == "ftheta":
        # alpha = 0.005 r: past 90 degrees beyond r ~ 314 lens pixels.
        kw["ftheta"] = np.array([0.0, 5e-3, 0, 0, 0, 800.0, 600.0], np.float32)
    elif model == "rolling_shutter":
        end = poses.copy()
        end[:, :, 3] += rng.normal(0, 0.1, (3, 3)).astype(np.float32)
        kw.update(poses_end=end, rolling_shutter=np.array([0.1, 0.2, 0.5, 0.0], np.float32))
    elif model == "mixed_sizes":
        kw.update(image_sizes=np.array([[40, 30], [24, 30], [40, 12]], np.int32),
                  distortion=LENS)
    jcams = jrays.Cameras(
        poses=jnp.asarray(poses), focal=jnp.asarray(rng.uniform(30, 50, (3, 2)), jnp.float32),
        principal=jnp.asarray(rng.uniform(0.4, 0.6, (3, 2)), jnp.float32), resolution=(40, 30),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    return jcams, interop.cameras_from_jax(jcams)


@pytest.mark.parametrize("model", ["pinhole", "brown_conrady", "ftheta", "rolling_shutter",
                                   "mixed_sizes"])
def test_pixel_to_ray_matches_jax(model):
    """Every camera model's rays, the FTheta sentinel origin included
    (test_distortion_depth.py:232), and the rays and texels of
    rays_from_pixels at each image's true size, to 1e-6."""
    jcams, cams = _camera_pair(model)
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 3, 512).astype(np.int32)
    uv = rng.uniform(0, 1, (512, 2)).astype(np.float32)
    idx[:4] = [0, 0, 2, 1]
    uv[:4] = [[0.95, 0.5], [0.5, 0.5], [0.0, 0.0], [0.999, 0.999]]
    o, d = rays.pixel_to_ray(cams, _t(idx).long(), _t(uv))
    jo, jd = jrays.pixel_to_ray(jcams, jnp.asarray(idx), jnp.asarray(uv))
    _near(o, jo)
    _near(d, jd)
    if model == "ftheta":
        sentinel = o[:, 0] == 1000.0
        assert bool(sentinel[0]) and not bool(sentinel[1]) and 0 < int(sentinel.sum()) < 512
    images = rng.uniform(0, 1, (3, 30, 40, 4)).astype(np.float32)
    got = rays.rays_from_pixels(cams, _t(images), _t(idx).long(), _t(uv))
    ref = jrays.rays_from_pixels(jcams, jnp.asarray(images), jnp.asarray(idx), jnp.asarray(uv))
    for a, b in zip(got, ref):
        _near(a, b)
    if model == "mixed_sizes":  # the last true pixel of view 1, never the padding
        np.testing.assert_allclose(got[3][3].numpy(), [(23 + 0.5) / 24, (29 + 0.5) / 30])
    o, d = rays.rays_for_image(cams, 1)
    jo, jd = jrays.rays_for_image(jcams, 1)
    _near(o, jo)
    _near(d, jd)


def test_pixel_to_ray_distorted_matches_ideal():
    """test_distortion_depth.py:44: the ray through the distorted pixel of
    a point passes through the point, in the port as in JAX."""
    pose = torch.cat([torch.eye(3), torch.zeros((3, 1))], 1)[None]
    w = h = 100
    cams = rays.Cameras(poses=pose, focal=torch.full((1, 2), 120.0),
                        principal=torch.full((1, 2), 0.5), resolution=(w, h),
                        distortion=_t(LENS))
    pt = torch.tensor([0.3, -0.2, 1.0])
    du, dv = rays.apply_camera_distortion(_t(LENS), pt[0], pt[1])
    uv = torch.stack([(pt[0] + du) * 120.0 / w + 0.5, (pt[1] + dv) * 120.0 / h + 0.5])[None]
    _, d = rays.pixel_to_ray(cams, torch.zeros(1, dtype=torch.int64), uv)
    _near(d[0, :2] / d[0, 2], pt[:2], 1e-4)
    _, jd = jrays.pixel_to_ray(_jax_cameras(cams), jnp.zeros((1,), jnp.int32),
                               jnp.asarray(uv.numpy()))
    _near(d, jd)


def _jax_cameras(cams):
    """A JAX Cameras from the port's (the tests' direction)."""
    return jrays.Cameras(**{k: v if v is None or k == "resolution" else jnp.asarray(v.numpy())
                            for k, v in cams._asdict().items()})


# -- EXR ------------------------------------------------------------------------


@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
@pytest.mark.parametrize("half", [False, True])
def test_exr_bitwise_across_codecs(tmp_path, compression, half):
    """Each package's writer gives the same bytes; each reads the other's
    file to the same arrays, bitwise (test_loader_extras.py:25)."""
    rng = np.random.default_rng(0)
    chans = {"R": rng.random((23, 41)).astype(np.float32),
             "G": rng.random((23, 41)).astype(np.float32) * 5,
             "B": rng.random((23, 41)).astype(np.float32)}
    exr.write_exr(tmp_path / "p.exr", chans, compression=compression, half=half)
    jexr.write_exr(tmp_path / "j.exr", chans, compression=compression, half=half)
    assert (tmp_path / "p.exr").read_bytes() == (tmp_path / "j.exr").read_bytes()
    for a, b in ((exr.read_exr(tmp_path / "j.exr"), jexr.read_exr(tmp_path / "p.exr")),
                 (exr.read_exr(tmp_path / "p.exr"), jexr.read_exr(tmp_path / "p.exr"))):
        assert a.keys() == b.keys() == chans.keys()
        for k in chans:
            np.testing.assert_array_equal(a[k], b[k])
            tol = 3e-3 * max(float(chans[k].max()), 1.0) if half else 0.0
            np.testing.assert_allclose(a[k], chans[k], rtol=0, atol=tol)
    np.testing.assert_array_equal(exr.read_exr_rgba(tmp_path / "p.exr"),
                                  jexr.read_exr_rgba(tmp_path / "p.exr"))


# -- the loader -----------------------------------------------------------------


def _scene(tmp_path: Path, kind: str) -> Path:
    """The JAX tests' scene writers, with each loader extra."""
    if kind == "lens_depth":
        return write_depth_scene(tmp_path, with_depth=True, with_distortion=True)
    if kind == "ftheta":
        path = write_extras_scene(tmp_path, [{"h": 8, "w": 8}])
        meta = json.loads(path.read_text())
        meta.update({"cx": 4.0, "cy": 4.0, "w": 8, "h": 8, "ftheta_p0": 0.0,
                     "ftheta_p1": 2e-3, "ftheta_p2": 0.0, "ftheta_p3": 0.0, "ftheta_p4": 0.0,
                     "k1": 0.1})  # FTheta wins (test_distortion_depth.py:257)
        path.write_text(json.dumps(meta))
        return path
    if kind == "rolling_shutter":
        end = np.eye(4)
        end[:3, 3] = (0.0, 0.0, 1.0)
        return write_extras_scene(tmp_path, [
            {"h": 8, "w": 8, "frame_extra": {"transform_matrix_start": np.eye(4).tolist(),
                                             "transform_matrix_end": end.tolist()},
             "meta_extra": {"rolling_shutter": [0.0, 0.0, 1.0]}},
            {"h": 8, "w": 8}])
    if kind == "rays_file":
        path = write_extras_scene(tmp_path, [{"h": 8, "w": 8}, {"h": 8, "w": 8}])
        rng = np.random.default_rng(3)
        for i in range(2):
            rng.normal(size=(8, 8, 6)).astype(np.float32).tofile(tmp_path / f"rays_im{i}.dat")
        return path
    if kind == "exr":
        z = np.random.default_rng(4).uniform(1, 3, (16, 16)).astype(np.float32)
        exr.write_exr(tmp_path / "d0.exr", {"Z": z})
        return write_extras_scene(tmp_path, [
            {"h": 16, "w": 16, "exr": True, "frame_extra": {"depth_path": "d0.exr"},
             "meta_extra": {"integer_depth_scale": 1.0}}])
    if kind == "mixed":
        return write_extras_scene(tmp_path, [{"h": 24, "w": 32}, {"h": 16, "w": 20},
                                             {"h": 24, "w": 20, "exr": True}])
    assert kind == "sharpen"
    return write_extras_scene(tmp_path, [{"h": 12, "w": 12, "meta_extra": {"sharpen": 0.5}}])


@pytest.mark.parametrize("kind", ["lens_depth", "ftheta", "rolling_shutter", "rays_file", "exr",
                                  "mixed", "sharpen"])
def test_load_dataset_matches_jax(tmp_path, kind):
    """Every NerfDataset field equal to the JAX loader's on the same files
    (the images to 1e-6, the rest bitwise), and the cameras' fields too."""
    path = _scene(tmp_path, kind)
    ds, ref = load_dataset(path), jax_load_dataset(path)
    for f in dataclasses.fields(ref):
        a, b = getattr(ds, f.name), getattr(ref, f.name)
        if f.name == "images":
            _near(a, b)
        elif isinstance(b, np.ndarray):
            assert a is not None and a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b or (a is None and b is None), f.name
    cams, jcams = ds.cameras(), ref.cameras()
    for k in rays.Cameras._fields:
        a, b = getattr(cams, k), getattr(jcams, k)
        if k == "resolution" or b is None:
            assert a == b, k
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
    expect = {"lens_depth": "distortion", "ftheta": "ftheta", "rolling_shutter": "poses_end",
              "rays_file": "rays", "exr": "depths", "mixed": "sizes"}
    if kind in expect:
        assert getattr(ds, expect[kind]) is not None
    if kind == "ftheta":
        assert cams.distortion is None and ds.distortion is not None
    if kind == "mixed":
        np.testing.assert_array_equal(ds.sizes, [[32, 24], [20, 16], [20, 24]])
        assert not ds.images[1, 16:].any() and not ds.images[1, :, 20:].any()
    if kind == "exr":  # linear, alpha 1
        assert np.all(ds.images[..., 3] == 1.0)
    sub = ds.subset([0])
    assert sub.n_images == 1 and all(
        getattr(sub, k) is None or len(getattr(sub, k)) == 1
        for k in ("poses_end", "rays", "sizes", "depths"))
    # The rolling-shutter 4-vector is per dataset, not per image: a subset
    # keeps it whole (the JAX package's subset cuts it; ROADMAP Queue 3).
    for idx in ([0], slice(0, 1)):
        sub = ds.subset(idx)
        if ds.rolling_shutter is None:
            assert sub.rolling_shutter is None
        else:
            np.testing.assert_array_equal(sub.rolling_shutter, ds.rolling_shutter)
            scam = sub.cameras()
            o, d = rays.pixel_to_ray(scam, torch.zeros(2, dtype=torch.long),
                                     torch.full((2, 2), 0.5))
            assert torch.isfinite(o).all() and torch.isfinite(d).all()


def test_sharpen_paths_agree(tmp_path):
    """A json ``sharpen`` and the ``nerf.sharpen`` setter give the same
    device images in both packages (test_loader_extras.py:154)."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    plain = write_extras_scene(tmp_path / "a", [{"h": 12, "w": 12}])
    sharp = write_extras_scene(tmp_path / "b", [{"h": 12, "w": 12,
                                                 "meta_extra": {"sharpen": 0.5}}])
    tiny = _tiny_configs()[1]
    tb_json = ttb.Testbed(tiny, device="cpu")
    tb_json.load_training_data(sharp)
    tb_set = ttb.Testbed(tiny, device="cpu")
    tb_set.load_training_data(plain)
    before = tb_set.images.clone()
    tb_set.nerf.sharpen = 0.5
    assert not torch.equal(before, tb_set.images)
    _near(tb_set.images, tb_json.images)
    _near(tb_json.images, jax_load_dataset(sharp).images)


# -- training steps through the lens models -------------------------------------

N_VIEWS, RES = 4, 32


def _tiny_configs(**kw):
    def shrink(cfg):
        grid = dataclasses.replace(cfg.field.grid, n_levels=4, log2_hashmap_size=12)
        field = dataclasses.replace(cfg.field, grid=grid, sdf_hidden_dim=16, rgb_hidden_dim=16)
        return dataclasses.replace(cfg, field=field, n_rays=64, samples_per_ray=16,
                                   n_candidates=32, occ_n_probe=1 << 15, **kw)

    return (shrink(jax_config_from_json("configs/base.json")[0]),
            shrink(config_from_json("configs/base.json")[0]))


def _lens_cameras(model: str):
    """The sphere scene's cameras (JAX) with ``model``'s lens fields, and
    its images (mixed sizes: views 1 and 3 are cut to 24 x 20, zero beyond)."""
    ds = jax_sphere(n_views=N_VIEWS, resolution=RES, seed=0)
    images = np.array(ds.images)
    kw = {}
    if model in ("lens_rs_mixed", "lens_refine"):
        end = np.array(ds.poses)
        end[:, :, 3] += np.random.default_rng(5).normal(0, 0.01, (N_VIEWS, 3))
        sizes = np.array([[RES, RES], [24, 20], [RES, RES], [24, 20]], np.int32)
        for i, (w, h) in enumerate(sizes):
            images[i, h:], images[i, :, w:] = 0.0, 0.0
        kw = dict(distortion=LENS, poses_end=end.astype(np.float32),
                  rolling_shutter=np.array([0.0, 0.1, 0.4, 0.0], np.float32), image_sizes=sizes)
    elif model == "ftheta_refine":
        kw = dict(ftheta=np.array([0.0, 2.6e-2, 0, 0, 0, RES, RES], np.float32))
    elif model == "rays":
        jcams0 = jrays.Cameras(jnp.asarray(ds.poses), jnp.asarray(ds.focal),
                               jnp.asarray(ds.principal), (RES, RES))
        o, d = zip(*(jrays.rays_for_image(jcams0, i) for i in range(N_VIEWS)))
        kw = dict(rays=np.concatenate([np.stack(o), np.stack(d)], -1).reshape(
            N_VIEWS, RES, RES, 6))
    jcams = jrays.Cameras(jnp.asarray(ds.poses), jnp.asarray(ds.focal), jnp.asarray(ds.principal),
                          (RES, RES), **{k: jnp.asarray(v) for k, v in kw.items()})
    return images, jcams


@pytest.fixture(scope="module")
def start():
    """A JAX state after its prior sweep and two pinhole steps."""
    jcfg, _ = _tiny_configs()
    ds = jax_sphere(n_views=N_VIEWS, resolution=RES, seed=0)
    jcams = jrays.Cameras(jnp.asarray(ds.poses), jnp.asarray(ds.focal), jnp.asarray(ds.principal),
                          (RES, RES))
    state = jt.init_train_state(jax.random.PRNGKey(0), jcfg, N_VIEWS)
    state = jt.occupancy_prior_sweep(state, jcfg)
    for _ in range(2):
        state = jt.occupancy_update(state, jcfg)
        state, _ = jt.train_step(state, jnp.asarray(ds.images), jcams, jcfg)
    return jax.device_get(state)


_MODELS = {"lens_rs_mixed": {}, "lens_refine": dict(optimize_extrinsics=True,
                                                     optimize_focal_length=True),
           "ftheta_refine": dict(optimize_extrinsics=True), "rays": {}}


@pytest.mark.parametrize("model", sorted(_MODELS))
def test_lens_steps_match_jax(start, model, monkeypatch):
    """Three steps through each camera model against the JAX step, with its
    draws injected: Brown-Conrady + rolling shutter + mixed sizes; the same
    with extrinsic and focal refinement through the 8 Newton steps (the
    end poses stay raw, as in the JAX package); extrinsic refinement of an
    FTheta scene (finite camera gradients); per-pixel ray files.  The
    table-gradient sum runs once a step."""
    jcfg, tcfg = _tiny_configs(**_MODELS[model])
    images, jcams = _lens_cameras(model)
    cams = interop.cameras_from_jax(jcams)
    host = start
    if tt.wants_cam_training(tcfg):
        cam = {k: np.asarray(v) for k, v in jt.init_cam_params(N_VIEWS, jcfg).items()}
        host = host._replace(cam=cam, cam_opt_state=jax.device_get(
            jt.make_cam_optimizer(jcfg).init(jax.tree_util.tree_map(jnp.asarray, cam))))
    jstate, tstate = jax.tree_util.tree_map(jnp.asarray, host), interop.train_state_from_jax(host)
    n = [0]
    real = hashgrid_fast.segment_dense_sum_multi
    monkeypatch.setattr(hashgrid_fast, "segment_dense_sum_multi",
                        lambda *a, **kw: (n.__setitem__(0, n[0] + 1), real(*a, **kw))[1])
    key = host.key
    for i in range(3):
        draws, _, key = _step_draws(key, tcfg, N_VIEWS)
        jstate, jaux = jt.train_step(jstate, jnp.asarray(images), jcams, jcfg)
        tstate, taux = tt.train_step(tstate, _t(images), cams, tcfg, draws=draws)
        for f in jt.StepAux._fields:
            np.testing.assert_allclose(float(getattr(taux, f)), float(getattr(jaux, f)),
                                       rtol=1e-5, err_msg=f"step {i} {f}")
    assert n[0] == 3
    jhost = jax.device_get(jstate)
    _close(jhost.params, tstate.params, params=True)
    _close(jhost.opt_state["mu"], tstate.opt_state["mu"])
    if tt.wants_cam_training(tcfg):
        for k in tt.cam_leaves_in_loss(tcfg):
            a, b = np.asarray(jhost.cam[k]), tstate.cam[k].numpy()
            assert np.isfinite(b).all() and not np.array_equal(b, host.cam[k]), k
            assert np.abs(b - a).max() <= 1e-5 * np.abs(a).max() + 0.03 * tcfg.cam_lr, k
        grads, _, _ = tt.loss_and_grads({"cam": {k: tstate.cam[k]
                                                 for k in tt.cam_leaves_in_loss(tcfg)}},
                                        tstate, _t(images), cams,
                                        _step_draws(key, tcfg, N_VIEWS)[0], tcfg)
        assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads["cam"].values())


# -- renders, eval and the CLI --------------------------------------------------


def _trained_pair(n_views=2, res=16):
    """A tiny JAX Testbed after a few steps and the port Testbed built from
    it and its dataset (``interop.testbed_from_jax``, ``dataset_from_jax``)."""
    jcfg, tcfg = _tiny_configs()
    jtb = JTestbed(config=jcfg, hyper=JHyperparams(first_frame_max_training_step=4))
    jtb.load_training_data_from_datasets([jax_sphere(n_views, res)])
    while jtb.frame():
        pass
    tb = interop.testbed_from_jax(jax.device_get(jtb.state), jtb.hyper, tcfg,
                                  interop.dataset_from_jax(jtb.dataset), training_step=4)
    return jtb, tb


def test_renders_carry_the_dataset_lens(scene):
    """render_image casts the lens's rays (test_distortion_depth.py:156):
    with and without the lens, to 3e-4 of JAX's render on
    tests/test_torch_render_mesh.py's scene, and the silhouette moves;
    ``render_with_camera_distortion = False`` strips the dataset's lens
    from the Testbed's renders."""
    alphas = []
    for lens in (None, LENS):
        jc = scene["jcam"]._replace(distortion=None if lens is None else jnp.asarray(lens))
        tc = scene["tcam"]._replace(distortion=None if lens is None else _t(lens))
        ref = jrender.render_image(scene["jp"], jdelta.init_accumulated(), scene["jocc"], jc,
                                   jc.poses[0],
                                   jc.focal[0], jc.principal[0], jax.random.PRNGKey(1),
                                   scene["jcfg"], background=0.0, spp=1)
        got = trender.render_image(scene["tp"], None, scene["tocc"], tc, tc.poses[0],
                                   tc.focal[0], tc.principal[0], None, scene["tcfg"],
                                   background=0.0, spp=1)
        for g, r in zip(got, ref):
            _near(g, r, 3e-4)
        alphas.append(got[2])
    assert not torch.allclose(*alphas)

    _, tb = _trained_pair()
    tb.cameras = tb.cameras._replace(distortion=_t(LENS))
    with_lens = tb.render(0)[2]
    tb.render_with_camera_distortion = False
    assert tb.render_cameras().distortion is None
    assert not np.allclose(with_lens, tb.render(0)[2])
    tb.nerf.render_with_camera_distortion = True
    np.testing.assert_array_equal(tb.render(0)[2], with_lens)


def test_evaluate_mixed_resolution_scores_true_pixels(tmp_path, monkeypatch):
    """run.evaluate renders each held-out view at its true size and scores
    its true pixels (test_loader_extras.py:258), with the PSNRs of the JAX
    CLI's evaluate on the same state to 1e-3 dB."""
    from neus2_tpu import run as jrun
    import neus2_tpu_torch.ops.image as image_mod

    path = write_extras_scene(tmp_path, [{"h": 24, "w": 32}, {"h": 16, "w": 20}])
    jtb, tb = _trained_pair()
    shapes = []
    real = image_mod.psnr

    def spy(a, b):
        assert a.shape[:2] == b.shape[:2]
        shapes.append(tuple(a.shape[:2]))
        return real(a, b)

    monkeypatch.setattr(image_mod, "psnr", spy)
    psnrs, _ = run.evaluate(tb, str(path), spp=1, log=lambda *a: None)
    jpsnrs, _ = jrun.evaluate(jtb, str(path), spp=1, log=lambda *a: None)
    assert shapes == [(24, 32), (16, 20)]
    np.testing.assert_allclose(psnrs, jpsnrs, atol=1e-3)


def test_evaluate_keeps_the_held_out_lens(tmp_path):
    """With ``render_with_camera_distortion`` off, run.evaluate still
    renders a Brown-Conrady held-out set through its lens, as the JAX
    CLI's evaluate does (the flag drops only the learned distortion grid):
    every view rendered with the file's k1-p2, and the PSNRs of both on the
    same state carried across to 1e-3 dB, SSIMs to 1e-4."""
    from neus2_tpu import run as jrun

    path = write_depth_scene(tmp_path, with_depth=False, with_distortion=True)
    jtb, tb = _trained_pair()
    jtb.render_with_camera_distortion = tb.render_with_camera_distortion = False
    lenses = []
    real = trender.render_image

    def spy(params, acc, occ, cams, *a, **kw):
        lenses.append(None if cams.distortion is None else cams.distortion.tolist())
        return real(params, acc, occ, cams, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trender, "render_image", spy)
        psnrs, ssims = run.evaluate(tb, str(path), spp=1, log=lambda *a: None)
    jpsnrs, jssims = jrun.evaluate(jtb, str(path), spp=1, log=lambda *a: None)
    k = json.loads(path.read_text())
    assert lenses == [pytest.approx([k["k1"], k["k2"], k["p1"], k["p2"]])] * 2
    np.testing.assert_allclose(psnrs, jpsnrs, atol=1e-3)
    np.testing.assert_allclose(ssims, jssims, atol=1e-4)


def test_cli_precision_flags_and_density_png(tmp_path):
    """``--fp16-images --bf16 --save_density_png`` on a distorted scene:
    fp16 texels equal to JAX's fp16 copy, the bf16 config, finite losses,
    and the density mosaic with the pixels and stats JAX's
    save_density_grid_png gives for the same params
    (test_loader_extras.py:194)."""
    path = write_depth_scene(tmp_path, with_depth=False, with_distortion=True)
    net = {"encoding": {"n_levels": 3, "n_features_per_level": 2, "log2_hashmap_size": 10,
                        "base_resolution": 8, "per_level_scale": 1.5},
           "network": {"n_neurons": 16, "n_hidden_layers": 1},
           "rgb_network": {"n_neurons": 16, "n_hidden_layers": 2}}
    (tmp_path / "net.json").write_text(json.dumps(net))
    tb = run.main(["--scene", str(path), "--network", str(tmp_path / "net.json"),
                   "--output_dir", str(tmp_path / "out"), "--n_steps", "3", "--n_rays", "64",
                   "--samples_per_ray", "8", "--fp16-images", "--bf16", "--save_density_png",
                   "--mesh_resolution", "32", "--device", "cpu"])
    assert tb.images.dtype == torch.float16 and tb.cameras.distortion is not None
    assert tb.config.field.compute_dtype == torch.bfloat16 and np.isfinite(tb.loss_scalar)
    np.testing.assert_array_equal(
        tb.images.numpy(), np.asarray(jax_load_dataset(path).images_device(jnp.float16)))
    png = tmp_path / "out" / "exp" / "mesh" / "density_grid.png"
    got = np.asarray(Image.open(png))
    jcfg = _jax_field_config(tb.config.field)
    ref_stats = jax_density_png(jax.tree_util.tree_map(jnp.asarray, interop.params_to_jax(
        tb.state.ema_params)), jcfg, tmp_path / "j.png", resolution=32,
        aabb=jax_scene_aabb(tb.config.aabb_scale))
    log = (tmp_path / "out" / "exp" / "log.txt").read_text()
    assert f"({ref_stats[0]} surface voxels, {ref_stats[1]} near-crossing" in log
    np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "j.png")))
    assert got.shape == (32 * 5, 32 * 7)


def _jax_field_config(field):
    """The JAX FieldConfig of a port one (bf16 -> jnp.bfloat16)."""
    from neus2_tpu.models.field import FieldConfig
    from neus2_tpu.ops.hashgrid import HashGridConfig

    kw = {f.name: getattr(field, f.name) for f in dataclasses.fields(field)}
    kw["grid"] = HashGridConfig(**dataclasses.asdict(field.grid))
    if kw["compute_dtype"] is not None:
        kw["compute_dtype"] = jnp.dtype(str(kw["compute_dtype"]).removeprefix("torch."))
    return FieldConfig(**kw)


def test_fp16_image_storage_trains():
    """test_testbed.py:257: fp16 texels (the reference's __half4 images) in
    the Testbed, equal to the JAX Testbed's fp16 copy, and a step on them
    equal to the JAX step on its fp16 copy; the Testbed trains."""
    jcfg, tcfg = _tiny_configs()
    ds = make_sphere_dataset(6, 24)
    tb = ttb.Testbed(tcfg, ttb.Hyperparams(first_frame_max_training_step=20), device="cpu",
                     image_dtype=torch.float16)
    tb.load_training_data_from_datasets([ds])
    assert tb.images.dtype == torch.float16
    jtb = JTestbed(config=jcfg, image_dtype=jnp.float16)
    jtb.load_training_data_from_datasets([jax_sphere(6, 24)])
    np.testing.assert_array_equal(tb.images.numpy(), np.asarray(jtb.images))
    host = jax.device_get(jtb.state)
    draws, _, _ = _step_draws(host.key, tcfg, 6)
    _, jaux = jt.train_step(jax.tree_util.tree_map(jnp.asarray, host), jtb.images, jtb.cameras,
                            jtb.config)
    _, taux = tt.train_step(interop.train_state_from_jax(host), tb.images, tb.cameras, tb.config,
                            draws=draws)
    np.testing.assert_allclose(float(taux.loss), float(jaux.loss), rtol=1e-5)
    while tb.frame():
        pass
    assert np.isfinite(tb.loss_scalar) and tb.loss_scalar < 0.5
