"""The learned camera group's modules against ``neus2_tpu``'s, and the
paths that carry it: the envmap and distortion lookups and their
gradients, the tonemap curves, ``adjusted_cameras``, the camera group's
Adam against optax, latent codes in the field, ``render_image`` with the
extras, the loader's depth maps and dataset envmap, native snapshots
carrying ``.cam`` and ``.cam_opt_state`` both ways, the ``nerf.training``
knobs, the Testbed and the CLI.  The step itself is held against JAX's in
tests/test_torch_camera_step.py.

Tolerances, fp32 on the CPU: the lookups, curves and their gradients
1e-6 (the same elementwise arithmetic), the envmap's gradient in the
direction 1e-6 of its max; ``adjusted_cameras`` 1e-6 (a
3-term product in another order); the camera Adam 1e-6 of each leaf's
magnitude over 3 steps; the field with latent codes 1e-5 (the existing
field rule, tests/test_torch_field.py); renders tests/test_torch_render_
mesh.py's 3e-4 (its marcher-tie-free configuration); loaded depth maps and
envmaps exactly (the same integer pixels times the same fp32 scale).
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from neus2_tpu.api.testbed import Hyperparams as JHyperparams
from neus2_tpu.api.testbed import Testbed as JTestbed
from neus2_tpu.data.dataset import load_dataset as jax_load_dataset
from neus2_tpu.data.synthetic import make_sphere_dataset as jax_sphere
from neus2_tpu.engine import render as jrender
from neus2_tpu.engine import train as jt
from neus2_tpu.engine.rays import Cameras as JCameras
from neus2_tpu.models import delta as jdelta
from neus2_tpu.models import field as jf
from neus2_tpu.ops import envmap as jenv
from neus2_tpu.ops import tonemap as jtone
from neus2_tpu.ops.hashgrid import HashGridConfig as JGrid
from neus2_tpu_torch import interop, run
from neus2_tpu_torch.api import testbed as ttb
from neus2_tpu_torch.data.dataset import load_dataset
from neus2_tpu_torch.data.synthetic import make_sphere_dataset
from neus2_tpu_torch.engine import occupancy as tocc
from neus2_tpu_torch.engine import render as trender
from neus2_tpu_torch.engine import train as tt
from neus2_tpu_torch.models import field as tf
from neus2_tpu_torch.ops import envmap as tenv
from neus2_tpu_torch.ops import tonemap as ttone
from neus2_tpu_torch.ops.hashgrid import HashGridConfig as TGrid
from neus2_tpu_torch.ops.losses import linear_to_srgb
from neus2_tpu_torch.utils.optim import plain_adam_init, plain_adam_update
from test_distortion_depth import _write_scene as write_depth_scene
from test_loader_extras import _write_scene as write_extras_scene
from test_torch_render_mesh import scene  # noqa: F401  (the render fixture)

torch.set_num_threads(2)

_GRID = dict(n_levels=3, log2_hashmap_size=10, base_resolution=8, per_level_scale=1.5)
_FIELD = dict(sdf_hidden_dim=16, rgb_hidden_dim=16)
_TRAIN = dict(n_rays=32, samples_per_ray=8, n_candidates=16, occ_n_probe=1 << 9)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, atol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol)


def tiny(**kw) -> tt.TrainConfig:
    return tt.TrainConfig(field=tf.FieldConfig(grid=TGrid(**_GRID), **_FIELD), **_TRAIN, **kw)


# -- ops ------------------------------------------------------------------------


def test_envmap_lookup_and_gradients_match_jax():
    rng = np.random.default_rng(0)
    env = rng.uniform(0, 1, (8, 16, 4)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs[0] = (0, 0, 1)  # the poles
    dirs[1] = (0, 0, -1)
    bg = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    coef = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(tenv.envmap_lookup(_t(env), _t(dirs)).numpy(),
                               np.asarray(jenv.envmap_lookup(env, dirs)), atol=1e-6)

    def jloss(e, d):
        return jnp.sum(jenv.composite_envmap_background(e, d, bg) * coef)

    je, jd = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(env), jnp.asarray(dirs))
    e, d = _t(env).requires_grad_(True), _t(dirs).requires_grad_(True)
    out = tenv.composite_envmap_background(e, d, _t(bg))
    _close(out, jenv.composite_envmap_background(env, dirs, bg), 1e-6)
    ge, gd = torch.autograd.grad((out * _t(coef)).sum(), (e, d))
    _close(ge, je, 1e-6)
    # Away from the poles, where arccos' slope is infinite; relative to the
    # largest, as atan2's and arccos' derivatives compose in another order.
    _close(gd[2:], jd[2:], 1e-6 * float(np.abs(jd[2:]).max()))
    assert float(ge.abs().sum()) > 0


def test_envmap_poles_and_init():
    env = torch.zeros((8, 16, 4))
    env[0, :, 0] = 1.0  # the top row red
    assert float(tenv.envmap_lookup(env, torch.tensor([[0.0, 0.0, 1.0]]))[0, 0]) > 0.9
    assert float(tenv.envmap_lookup(env, torch.tensor([[0.0, 0.0, -1.0]]))[0, 0]) < 0.1
    init = tenv.init_envmap((8, 16))
    assert init.shape == (8, 16, 4) and 0.0 <= float(init.min()) and float(init.max()) < 1e-4
    assert torch.equal(init, tenv.init_envmap((8, 16)))  # seeded


def test_distortion_and_gradients_match_jax():
    rng = np.random.default_rng(1)
    uv = rng.uniform(0, 1, (50, 2)).astype(np.float32)
    zero = tenv.init_distortion((8, 8))
    assert torch.equal(tenv.apply_distortion(zero, _t(uv)), _t(uv))
    shifted = zero + torch.tensor([0.01, -0.02])
    _close(tenv.apply_distortion(shifted, _t(uv)) - _t(uv),
           np.tile([[0.01, -0.02]], (50, 1)), 1e-6)
    grid = rng.normal(0, 0.01, (8, 8, 2)).astype(np.float32)
    coef = rng.normal(size=(50, 2)).astype(np.float32)
    jg, ju = jax.grad(lambda g, u: jnp.sum(jenv.apply_distortion(g, u) * coef),
                      argnums=(0, 1))(jnp.asarray(grid), jnp.asarray(uv))
    g, u = _t(grid).requires_grad_(True), _t(uv).requires_grad_(True)
    out = tenv.apply_distortion(g, u)
    _close(out, jenv.apply_distortion(grid, uv), 1e-6)
    gg, gu = torch.autograd.grad((out * _t(coef)).sum(), (g, u))
    _close(gg, jg, 1e-6)
    _close(gu, ju, 1e-6)


@pytest.mark.parametrize("curve", ["identity", "aces", "hable", "reinhard"])
def test_tonemap_curves_match_jax(curve):
    x = np.random.default_rng(2).uniform(-0.1, 4.0, (200, 3)).astype(np.float32)
    _close(ttone.tonemap_curve(_t(x), curve), jtone.tonemap_curve(jnp.asarray(x), curve), 1e-6)
    srgb = np.clip(x / 4.0, 0, 1)
    for exposure in (0.0, 0.5, -1.0):
        _close(ttone.apply_output_tonemap(_t(srgb), exposure, curve.upper()),
               jtone.apply_output_tonemap(jnp.asarray(srgb), exposure, curve.upper()), 1e-6)
    with pytest.raises(ValueError):
        ttone.tonemap_curve(_t(x), "filmic")


# -- the camera group --------------------------------------------------------------


def test_init_cam_params_matches_jax_layout():
    cfg = tiny(use_envmap=True, envmap_res=(4, 8), use_distortion=True, distortion_res=(6, 6))
    cfg = dataclasses.replace(cfg, field=dataclasses.replace(cfg.field, latent_dim=3))
    jcfg = jt.TrainConfig(field=jf.FieldConfig(grid=JGrid(**_GRID), **_FIELD, latent_dim=3),
                          **_TRAIN, use_envmap=True, envmap_res=(4, 8), use_distortion=True,
                          distortion_res=(6, 6))
    cam, jcam = tt.init_cam_params(5, cfg), jt.init_cam_params(5, jcfg)
    assert sorted(cam) == sorted(jcam)
    for k in cam:
        assert tuple(cam[k].shape) == jcam[k].shape and cam[k].dtype == torch.float32, k
        if k != "envmap":  # its own seeded draw
            np.testing.assert_array_equal(cam[k].numpy(), np.asarray(jcam[k]), err_msg=k)
    assert sorted(tt.init_cam_params(5, tiny())) == ["exposure", "focal_ln", "rot6d", "trans"]
    assert tt.wants_cam_training(cfg) == jt.wants_cam_training(jcfg) is True
    for knob in ("optimize_extrinsics", "optimize_exposure", "optimize_focal_length",
                 "use_envmap", "use_distortion"):
        assert tt.wants_cam_training(tiny(**{knob: True})), knob
    assert not tt.wants_cam_training(tiny(max_level_rand_training=True,
                                          depth_supervision_lambda=0.5))


def test_adjusted_cameras_identity_at_init_and_match_jax():
    """tests/test_error_map_cam.py:84 and the focal case of :113."""
    ds = jax_sphere(n_views=3, resolution=16)
    jcams = JCameras(jnp.asarray(ds.poses), jnp.asarray(ds.focal), jnp.asarray(ds.principal),
                     (16, 16))
    tcams = make_sphere_dataset(3, 16).cameras()
    cfg = tiny(optimize_extrinsics=True, optimize_focal_length=True)
    out = tt.adjusted_cameras(tt.init_cam_params(3), tcams, cfg)
    assert torch.equal(out.poses, tcams.poses) and torch.equal(out.focal, tcams.focal)
    rng = np.random.default_rng(3)
    cam = {k: np.asarray(v) for k, v in jt.init_cam_params(3).items()}
    cam["rot6d"] = cam["rot6d"] + rng.normal(0, 0.05, (3, 6)).astype(np.float32)
    cam["trans"] = rng.normal(0, 0.05, (3, 3)).astype(np.float32)
    cam["focal_ln"] = np.array([0.02, -0.01], np.float32)
    jcfg = jt.TrainConfig(optimize_extrinsics=True, optimize_focal_length=True)
    ref = jt.adjusted_cameras(cam, jcams, jcfg)
    got = tt.adjusted_cameras({k: _t(v) for k, v in cam.items()}, tcams, cfg)
    _close(got.poses, ref.poses, 1e-6)
    _close(got.focal, ref.focal, 1e-6 * float(np.abs(ref.focal).max()))


def test_camera_adam_matches_optax():
    """Adam(cam_lr, b1 0.9, b2 0.99, eps 1e-8), one count for the group; a
    leaf with zero gradient and zero moments takes a zero step."""
    rng = np.random.default_rng(4)
    cam = {"trans": rng.normal(size=(4, 3)).astype(np.float32),
           "envmap": rng.uniform(size=(4, 8, 4)).astype(np.float32),
           "focal_ln": np.zeros(2, np.float32)}
    tx = optax.adam(1e-4, b1=0.9, b2=0.99, eps=1e-8)
    jp, jstate = jax.tree_util.tree_map(jnp.asarray, cam), None
    jstate = tx.init(jp)
    tp = {k: _t(v) for k, v in cam.items()}
    tstate = plain_adam_init(tp)
    for step in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32) * 10.0 ** -(step + 2)
             for k, v in cam.items()}
        g["focal_ln"][:] = 0.0
        upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, tstate = plain_adam_update({k: _t(v) for k, v in g.items()}, tstate, 1e-4,
                                         eps=1e-8)
        tp = {k: tp[k] + tupd[k] for k in tp}
        for k in cam:
            a = np.asarray(jp[k])
            assert np.abs(tp[k].numpy() - a).max() <= 1e-6 * max(np.abs(a).max(), 1.0), k
        assert tstate["count"] == int(jstate[0].count) == step + 1
    assert torch.equal(tp["focal_ln"], torch.zeros(2))


def test_field_with_latent_matches_jax():
    jc = jf.FieldConfig(grid=JGrid(**_GRID), **_FIELD, latent_dim=4)
    tc = tf.FieldConfig(grid=TGrid(**_GRID), **_FIELD, latent_dim=4)
    assert tc.rgb_in_dim == jc.rgb_in_dim == tf.FieldConfig(**_FIELD).rgb_in_dim + 4
    p = jax.device_get(jf.init_field(jax.random.PRNGKey(0), jc))
    p["hashgrid"] = tuple(t * 30.0 for t in p["hashgrid"])
    tp = interop.params_from_jax(p)
    assert tp["rgb_mlp"]["layers"][0]["w"].shape[0] == tc.rgb_in_dim
    assert tf.init_field(torch.Generator().manual_seed(0), tc)["rgb_mlp"]["layers"][0][
        "w"].shape[0] == tc.rgb_in_dim
    rng = np.random.default_rng(5)
    x = rng.uniform(0.2, 0.8, (40, 3)).astype(np.float32)
    d = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    lat = rng.normal(size=(40, 4)).astype(np.float32)
    forward = jax.jit(lambda x, d, latent: jf.field_forward(p, x, d, jc, latent=latent).rgb)
    for latent in (lat, None):  # None: zeros, as renders take it
        ref = forward(x, d, latent)
        got = tf.field_forward(tp, _t(x), _t(d), tc, latent=None if latent is None else _t(latent))
        _close(got.rgb, ref, 1e-5)
    zeros = tf.field_forward(tp, _t(x), _t(d), tc, latent=torch.zeros(40, 4))
    assert torch.equal(zeros.rgb, tf.field_forward(tp, _t(x), _t(d), tc).rgb)


# -- render_image with the extras ---------------------------------------------------


def _render_both(s, view=0, **kw):
    jc, tc = s["jcam"], s["tcam"]
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ref = jrender.render_image(s["jp"], jdelta.init_accumulated(), s["jocc"], jc, jc.poses[view],
                               jc.focal[view], jc.principal[view], jax.random.PRNGKey(1),
                               s["jcfg"], spp=1, **jkw)
    got = trender.render_image(s["tp"], None, s["tocc"], tc, tc.poses[view], tc.focal[view],
                               tc.principal[view], None, s["tcfg"], spp=1, **tkw)
    return got, ref


def test_render_image_with_extras_matches_jax(scene):  # noqa: F811
    rng = np.random.default_rng(6)
    extras = dict(envmap=rng.uniform(0, 0.6, (8, 16, 4)).astype(np.float32),
                  distortion=rng.normal(0, 0.01, (8, 8, 2)).astype(np.float32),
                  exposure=0.5, tonemap="aces")
    got, ref = _render_both(scene, background=0.2, **extras)
    for g, r in zip(got, ref):
        _close(g, r, 3e-4)
    assert float(got[2].max()) > 0.1 and float(got[2].min()) == 0.0


def test_render_image_envmap_background(scene):  # noqa: F811
    """tests/test_render_compact.py:138: an opaque envmap backgrounds every
    miss and composites behind semi-transparent hits."""
    env = torch.zeros((8, 16, 4))
    env[..., 0], env[..., 3] = 0.5, 1.0
    tc = scene["tcam"]
    args = (scene["tp"], None, tocc.reset_density(scene["tocc"]), tc, tc.poses[0], tc.focal[0],
            tc.principal[0], torch.Generator().manual_seed(1), scene["tcfg"])
    img, _, alpha = trender.render_image(*args, background=0.2, spp=2, envmap=env)
    assert float(alpha.abs().max()) == 0.0
    expect = torch.tensor([float(linear_to_srgb(torch.tensor(0.5))), 0.0, 0.0])
    _close(img, expect.expand(img.shape), 1e-6)
    img2, _, alpha2 = trender.render_image(scene["tp"], None, scene["tocc"], *args[3:-2], None,
                                           scene["tcfg"], background=0.2, spp=1, envmap=env)
    miss = alpha2 == 0.0
    assert miss.any() and (~miss).any()
    _close(img2[miss], expect.expand(img2[miss].shape), 1e-6)


def test_render_image_learned_distortion(scene):  # noqa: F811
    """tests/test_render_compact.py:180: a zero grid is a no-op, a nonzero
    grid moves the silhouette."""
    tc = scene["tcam"]

    def alpha(dist):
        return trender.render_image(scene["tp"], None, scene["tocc"], tc, tc.poses[0],
                                    tc.focal[0], tc.principal[0], None, scene["tcfg"], spp=1,
                                    distortion=dist)[2]

    base = alpha(None)
    assert torch.equal(base, alpha(tenv.init_distortion((8, 8))))
    assert not torch.allclose(base, alpha(tenv.init_distortion((8, 8)) + torch.tensor([0.06, 0.0])))


def test_render_image_exposure_tonemap(scene):  # noqa: F811
    """tests/test_render_compact.py:203: exposure brightens, identity at 0
    is a no-op, every curve stays in [0, 1]."""
    tc = scene["tcam"]
    args = (scene["tp"], None, scene["tocc"], tc, tc.poses[0], tc.focal[0], tc.principal[0],
            None, scene["tcfg"])
    base = trender.render_image(*args, background=0.1, spp=1)[0]
    assert torch.equal(base, trender.render_image(*args, background=0.1, spp=1, exposure=0.0,
                                                  tonemap="identity")[0])
    brighter = trender.render_image(*args, background=0.1, spp=1, exposure=1.0)[0]
    assert (brighter >= base - 1e-6).all() and brighter.mean() > base.mean()
    for curve in ("aces", "hable", "reinhard"):
        t = trender.render_image(*args, background=0.1, spp=1, tonemap=curve)[0]
        assert torch.isfinite(t).all() and float(t.min()) >= 0.0 and float(t.max()) <= 1.0


# -- the Testbed, its knobs and the CLI -------------------------------------------


@pytest.fixture(scope="module")
def tb_envmap():
    tb = ttb.Testbed(tiny(use_envmap=True), ttb.Hyperparams(first_frame_max_training_step=2),
                     device="cpu")
    tb.load_training_data_from_datasets([make_sphere_dataset(2, 24)])
    tb.train()
    return tb


def test_testbed_render_honors_envmap_and_tonemap(tb_envmap):
    """tests/test_extras.py:249: Testbed.render backgrounds misses with the
    learned envmap and honours the exposure and tonemap controls."""
    tb = copy.deepcopy(tb_envmap)
    env = torch.zeros_like(tb.state.cam["envmap"])
    env[..., 1], env[..., 3] = 0.25, 1.0
    tb.state = tb.state._replace(cam={**tb.state.cam, "envmap": env},
                                 occupancy=tocc.reset_density(tb.state.occupancy))
    rgb, _, alpha = tb.render(0, spp=1, background=0.0)
    miss = alpha.ravel() == 0.0
    assert miss.all()
    g = float(linear_to_srgb(torch.tensor(0.25)))
    np.testing.assert_allclose(rgb.reshape(-1, 3)[miss], np.broadcast_to([0.0, g, 0.0],
                                                                         (miss.sum(), 3)),
                               atol=1e-6)
    tb.exposure = 2.0
    assert tb.render(0, spp=1, background=0.0)[0].mean() > rgb.mean()
    tb.exposure, tb.tonemap_curve = 0.0, "ACES"
    aces = tb.render(0, spp=1, background=0.0)[0]
    np.testing.assert_allclose(aces, ttone.apply_output_tonemap(torch.from_numpy(rgb), 0.0,
                                                                "aces").numpy(), atol=1e-6)
    rgba = tb.render(24, 24, 1)  # the pyngp form takes the same extras
    np.testing.assert_allclose(rgba[..., :3], aces, atol=1e-6)
    for name in ("color_space", "snap_to_pixel_centers"):  # stored display knobs
        assert hasattr(tb, name)


def test_nerf_training_camera_knobs(tb_envmap):
    """The five knobs replace the Testbed's config, as the JAX package's
    do, and take effect from the next step."""
    tb = copy.deepcopy(tb_envmap)
    tr = tb.nerf.training
    for name, value in (("depth_supervision_lambda", 0.25), ("optimize_extrinsics", True),
                        ("optimize_exposure", True), ("optimize_focal_length", True)):
        assert getattr(tr, name) == getattr(tt.TrainConfig(), name)
        setattr(tr, name, value)
        assert getattr(tb.config, name) == value and getattr(tr, name) == value
    trans = tb.state.cam["trans"].clone()
    tb.train()
    assert not torch.equal(tb.state.cam["trans"], trans)
    assert tb.nerf.render_with_camera_distortion is True
    tb.nerf.render_with_camera_distortion = False
    assert tb.render_with_camera_distortion is False


def test_dataset_envmap_loading(tmp_path):
    """tests/test_loader_extras.py:320, against the JAX loader on the same
    files: the json-root envmap seeds the learned envmap at its size."""
    env = (np.random.default_rng(3).uniform(0, 1, (8, 16, 4)) * 255).astype(np.uint8)
    env[..., 3] = 255
    Image.fromarray(env).save(tmp_path / "env.png")
    path = write_extras_scene(tmp_path, [{"h": 12, "w": 12, "meta_extra": {"envmap": "env.png"}}])
    ds = load_dataset(path)
    np.testing.assert_array_equal(ds.envmap, jax_load_dataset(path).envmap)
    assert ds.envmap.shape == (8, 16, 4)
    tb = ttb.Testbed(tiny(), device="cpu")
    tb.load_training_data_from_datasets([ds])
    assert tb.config.use_envmap and tb.config.envmap_res == (8, 16)
    np.testing.assert_array_equal(tb.state.cam["envmap"].numpy(), ds.envmap)
    bad = json.loads(path.read_text())
    bad["envmap"] = "missing.png"
    (tmp_path / "t2.json").write_text(json.dumps(bad))
    with pytest.raises(FileNotFoundError):
        load_dataset(tmp_path / "t2.json")


def test_loader_reads_depth(tmp_path):
    """tests/test_distortion_depth.py:124 without the lens model (the lens
    is tests/test_torch_loader_extras.py's): uint16 depth times
    integer_depth_scale times the scene scale, as the JAX loader reads it."""
    path = write_depth_scene(tmp_path, with_depth=True, with_distortion=False)
    ds, ref = load_dataset(path), jax_load_dataset(path)
    assert ds.depths.shape == (2, 32, 32) and ds.depths.dtype == np.float32
    np.testing.assert_array_equal(ds.depths, ref.depths)
    assert 0.04 < ds.depths.mean() < 1.1
    assert torch.equal(ds.depths_device("cpu"), torch.from_numpy(ref.depths))
    (tmp_path / "plain").mkdir()
    assert load_dataset(write_depth_scene(tmp_path / "plain", with_depth=False,
                                          with_distortion=False)).depths is None


def test_depth_supervision_reachable_from_testbed_and_cli(tmp_path):
    """tests/test_distortion_depth.py:146: depth maps flow from the loader
    through Testbed.train into the loss; the CLI takes the weight."""
    path = write_depth_scene(tmp_path, with_depth=True, with_distortion=False)
    net = {"encoding": {"n_levels": 3, "n_features_per_level": 2, "log2_hashmap_size": 10,
                        "base_resolution": 8, "per_level_scale": 1.5},
           "network": {"n_neurons": 16, "n_hidden_layers": 1},
           "rgb_network": {"n_neurons": 16, "n_hidden_layers": 2}}
    (tmp_path / "net.json").write_text(json.dumps(net))
    seen = []
    real = ttb.train_step

    def spy(*a, **kw):
        seen.append(kw.get("depths"))
        return real(*a, **kw)

    ttb.train_step = spy
    try:
        tb = run.main(["--scene", str(path), "--network", str(tmp_path / "net.json"),
                       "--output_dir", str(tmp_path / "out"), "--n_steps", "3",
                       "--n_rays", "64", "--samples_per_ray", "8",
                       "--depth_supervision_lambda", "0.5", "--device", "cpu"])
    finally:
        ttb.train_step = real
    assert tb.config.depth_supervision_lambda == 0.5 and tb.depths is not None
    assert len(seen) == 3 and all(d is tb.depths for d in seen)
    assert np.isfinite(tb.loss_scalar)


# -- snapshots --------------------------------------------------------------------

_SNAP_KW = dict(use_envmap=True, envmap_res=(4, 8), use_distortion=True, distortion_res=(4, 4),
                optimize_extrinsics=True, optimize_exposure=True)


def _cam_pathdict(flat):
    return {k: v for k, v in flat.items() if k.startswith((".cam", ".cam_opt_state"))}


def test_camera_group_crosses_snapshots_both_ways(tmp_path):
    """``.cam`` and ``.cam_opt_state`` under the JAX package's keys, with
    the envmap, distortion grid and latent codes: a port snapshot loads
    into a JAX Testbed and a JAX snapshot into a port one, every camera
    leaf bitwise.  (tests/test_torch_snapshot.py covers the incremental
    form, which keeps the group's Adam in both packages.)"""
    jcfg = jt.TrainConfig(field=jf.FieldConfig(grid=JGrid(**_GRID), **_FIELD, latent_dim=2),
                          **_TRAIN, **_SNAP_KW)
    cfg = tiny(**_SNAP_KW)
    cfg = dataclasses.replace(cfg, field=dataclasses.replace(cfg.field, latent_dim=2))
    jtb = JTestbed(config=jcfg, hyper=JHyperparams(first_frame_max_training_step=2))
    jtb.load_training_data_from_datasets([jax_sphere(n_views=3, resolution=16)])
    tb = ttb.Testbed(cfg, ttb.Hyperparams(first_frame_max_training_step=2), device="cpu")
    tb.load_training_data_from_datasets([make_sphere_dataset(3, 16)])
    for _ in range(2):
        tb.train()

    p_path = tmp_path / "port.msgpack"
    tb.save_snapshot(p_path)
    want = _cam_pathdict(interop.state_to_pathdict(tb.state))
    assert ".cam['envmap']" in want and ".cam_opt_state[0].mu['latent']" in want
    assert int(want[".cam_opt_state[0].count"]) == 2
    jtb.load_snapshot(p_path)
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(jtb.state))
    got = _cam_pathdict({jax.tree_util.keystr(p): np.asarray(v) for p, v in flat})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    j_path = tmp_path / "jax.msgpack"
    jtb.state = jtb.state._replace(cam={k: v + 0.125 for k, v in jtb.state.cam.items()})
    jtb.save_snapshot(j_path)
    tb2 = ttb.Testbed(cfg, ttb.Hyperparams(first_frame_max_training_step=2), device="cpu")
    tb2.load_training_data_from_datasets([make_sphere_dataset(3, 16)])
    tb2.load_snapshot(j_path)
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(jtb.state))
    want = _cam_pathdict({jax.tree_util.keystr(p): np.asarray(v) for p, v in flat})
    got = _cam_pathdict(interop.state_to_pathdict(tb2.state))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_camera_group_round_trips_through_interop():
    """train_state_from_jax / train_state_to_jax carry the group and its
    Adam both ways, where the JAX layout used to keep ``like``'s."""
    jcfg = jt.TrainConfig(field=jf.FieldConfig(grid=JGrid(**_GRID), **_FIELD), **_TRAIN,
                          **_SNAP_KW)
    host = jax.device_get(jt.init_train_state(jax.random.PRNGKey(0), jcfg, 3))
    rng = np.random.default_rng(7)
    host = host._replace(
        cam={k: rng.normal(size=np.shape(v)).astype(np.float32) for k, v in host.cam.items()},
        cam_opt_state=(host.cam_opt_state[0]._replace(count=np.int32(4)),)
        + tuple(host.cam_opt_state[1:]))
    state = interop.train_state_from_jax(host)
    assert state.cam_opt_state["count"] == 4
    back = interop.train_state_to_jax(state, jax.device_get(
        jt.init_train_state(jax.random.PRNGKey(1), jcfg, 3)))
    for field in ("cam", "cam_opt_state"):
        a, b = getattr(host, field), getattr(back, field)
        assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b), field
        for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=field)


def test_next_frame_resets_the_camera_group():
    """A dynamic scene's frame switch starts the group and its Adam afresh,
    as the JAX Testbed does."""
    from neus2_tpu_torch.data.synthetic import make_moving_sphere_frames

    tb = ttb.Testbed(tiny(optimize_exposure=True),
                     ttb.Hyperparams(first_frame_max_training_step=2,
                                     next_frame_max_training_step=2,
                                     predict_global_movement=True,
                                     predict_global_movement_training_step=1),
                     device="cpu")
    tb.load_training_data_from_datasets(make_moving_sphere_frames(2, (0.01, 0, 0), 2, 16))
    tb.frame(), tb.frame()
    assert tb.state.cam_opt_state["count"] == 2 and tb.state.cam["exposure"].abs().max() > 0
    tb.frame()  # the switch, then a refinement step: the group stays put
    assert tb.current_training_time_frame == 1 and tb.state.cam_opt_state["count"] == 0
    assert float(tb.state.cam["exposure"].abs().max()) == 0.0
    tb.frame()  # finetune trains it again
    assert tb.state.cam_opt_state["count"] == 1
