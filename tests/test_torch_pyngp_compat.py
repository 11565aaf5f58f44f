"""The port's pyngp scripting surface (reference python_api.cu:317-616):
counterparts of tests/test_pyngp_compat.py's 11 tests, and
``render(width, height, ...)`` against the JAX Testbed's at the same
virtual camera on the same state.

The port's ``nerf`` views expose only knobs the port backs, the camera
group's among them (tests/test_torch_camera.py trains through them); a knob
the port does not back raises AttributeError.

Tolerance of the render comparison: tests/test_torch_render_mesh.py's,
max |diff| <= 3e-4 at spp 1 with 256 samples a ray (which keeps out the
marcher's systematic rounding ties); the two packages' cameras exactly.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from neus2_tpu.api.compat import sharpen_images as jax_sharpen_images
from neus2_tpu.api.testbed import Hyperparams as JHyperparams
from neus2_tpu.api.testbed import Testbed as JTestbed
from neus2_tpu.data.synthetic import make_sphere_dataset as jax_sphere
from neus2_tpu.engine.train import TrainConfig as JTrainConfig
from neus2_tpu.models.field import FieldConfig as JFieldConfig
from neus2_tpu.ops.hashgrid import HashGridConfig as JGrid
from neus2_tpu_torch import interop
from neus2_tpu_torch.api import testbed as ttb
from neus2_tpu_torch.api.compat import sharpen_images
from neus2_tpu_torch.data.dataset import nerf_matrix_to_ngp, ngp_matrix_to_nerf
from neus2_tpu_torch.data.synthetic import make_sphere_dataset
from neus2_tpu_torch.engine.render import render_image
from neus2_tpu_torch.engine.train import TrainConfig
from neus2_tpu_torch.models.field import FieldConfig
from neus2_tpu_torch.ops.hashgrid import HashGridConfig
from neus2_tpu_torch.ops.losses import srgb_to_linear

torch.set_num_threads(2)

_GRID = dict(n_levels=4, log2_hashmap_size=12, base_resolution=16, per_level_scale=1.4)
_FIELD = dict(sdf_hidden_dim=16, rgb_hidden_dim=16)
_TRAIN = dict(n_rays=128, samples_per_ray=16, n_candidates=48, occ_n_probe=1 << 12)


def tiny_config(**kw) -> TrainConfig:
    return TrainConfig(field=FieldConfig(grid=HashGridConfig(**_GRID), **_FIELD), **_TRAIN, **kw)


@pytest.fixture(scope="module")
def tb():
    tb = ttb.Testbed(tiny_config(), ttb.Hyperparams(first_frame_max_training_step=5),
                     device="cpu")
    tb.load_training_data_from_datasets([make_sphere_dataset(4, 24)])
    while tb.frame():
        pass
    return tb


def test_shall_train_and_loss_scalars(tb):
    assert tb.shall_train is True
    tb.shall_train = False
    assert tb.m_train is False and tb.frame() is False
    tb.shall_train = True
    assert tb.loss == tb.loss_scalar
    assert tb.ek_loss == tb.ek_loss_scalar
    assert tb.mask_loss == tb.mask_loss_scalar


def test_hyperparam_passthrough(tb):
    tb.first_frame_max_training_step = 7
    assert tb.hyper.first_frame_max_training_step == 7
    tb.next_frame_max_training_step = 9
    assert tb.hyper.next_frame_max_training_step == 9
    tb.first_frame_max_training_step = 5


def test_nerf_training_view(tb):
    assert tb.nerf.training.n_images_for_training == 4
    tb.nerf.training.random_bg_color = False
    assert tb.config.random_bg is False
    tb.nerf.training.random_bg_color = True
    tb.nerf.training.near_distance = 0.2
    assert tb.config.near == 0.2
    tb.nerf.training.near_distance = 0.0
    for name in ("depth_supervision_lambda", "optimize_extrinsics", "optimize_exposure",
                 "optimize_focal_length"):
        assert getattr(tb.nerf.training, name) == getattr(tb.config, name)
    with pytest.raises(AttributeError):  # a knob the port does not back
        getattr(tb.nerf.training, "optimize_distortion")


def test_nerf_view(tb):
    tb.nerf.cone_angle_constant = 1.0 / 128.0
    assert tb.config.cone_angle_constant == 1.0 / 128.0
    tb.nerf.cone_angle_constant = 1.0 / 256.0
    tb.nerf.rendering_min_transmittance = 1e-3
    assert tb.rendering_min_transmittance == 1e-3
    assert tb._default_render_cfg().min_transmittance == 1e-3
    tb.nerf.rendering_min_transmittance = 1e-4
    assert tb.nerf.render_with_camera_distortion is True
    tb.nerf.render_with_camera_distortion = False
    assert tb.render_with_camera_distortion is False
    tb.nerf.render_with_camera_distortion = True
    with pytest.raises(AttributeError):  # a knob the port does not back
        tb.nerf.render_aabb


def test_sharpen_filter_math():
    # Constant images are fixed points of the reference's unsharp stencil.
    const = np.full((1, 6, 6, 4), 0.25, np.float32)
    np.testing.assert_allclose(sharpen_images(const, 0.3), const, atol=1e-6)
    # An impulse is amplified by center_w * amount = 4 s + 1.
    imp = np.zeros((1, 5, 5, 4), np.float32)
    imp[0, 2, 2] = 1.0
    out = sharpen_images(imp, 0.5)
    assert out[0, 2, 2, 0] == pytest.approx(4 * 0.5 + 1, rel=1e-5)
    assert out[0, 2, 1, 0] == 0.0  # the neighbours clamp to 0
    imgs = np.random.default_rng(0).uniform(size=(2, 7, 9, 4)).astype(np.float32)
    np.testing.assert_array_equal(sharpen_images(imgs, 0.7), jax_sharpen_images(imgs, 0.7))


def test_sharpen_setter_refreshes_images(tb):
    before = tb.images.clone()
    tb.nerf.sharpen = 0.5
    assert not torch.allclose(before, tb.images)
    np.testing.assert_array_equal(tb.images.numpy(), sharpen_images(tb.dataset.images, 0.5))
    tb.nerf.sharpen = 0.0
    assert torch.equal(tb.images, before)


def test_n_params(tb):
    assert tb.n_params > tb.n_encoding_params > 0
    assert tb.n_encoding_params == sum(t.numel() for t in tb.state.params["hashgrid"])
    assert tb.n_encoding_params == tb.config.field.grid.n_params


def test_fov_and_training_view_camera(tb):
    tb.set_camera_to_training_view(0)
    W, H = tb.dataset.resolution
    f = tb.cameras.focal[0].numpy()
    assert tb.fov_axis == 1
    assert tb.fov == pytest.approx(float(np.degrees(2 * np.arctan2(0.5 * H, f[1]))), rel=1e-5)
    np.testing.assert_allclose(tb._focal_for((W, H)), f, rtol=1e-5)
    tb.fov = 90.0  # one focal length, from the fov_axis side
    np.testing.assert_allclose(tb._focal_for((64, 32)), [16.0, 16.0], rtol=1e-5)
    tb.fov_xy = (90.0, 90.0)
    np.testing.assert_allclose(tb._focal_for((64, 32)), [32.0, 16.0], rtol=1e-5)
    tb._fov_deg = None


def test_set_nerf_camera_matrix(tb):
    mat = np.eye(4, dtype=np.float32)
    mat[:3, 3] = [0.1, -0.2, 0.3]
    tb.set_nerf_camera_matrix(mat)
    expect = nerf_matrix_to_ngp(mat, tb.dataset.scale, np.asarray(tb.dataset.offset, np.float32),
                                tb.dataset.from_na)
    np.testing.assert_allclose(tb._render_pose, expect)
    tb._render_pose = None


def test_pyngp_render_form(tb):
    tb.set_camera_to_training_view(0)
    tb.background_color = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    img = tb.render(32, 24, 2, True)  # (width, height, spp, linear)
    assert img.shape == (24, 32, 4) and np.isfinite(img).all()
    srgb = tb.render(32, 24, 2, False)
    lit = srgb[..., :3] > 0.05  # linear is darker than sRGB wherever lit
    assert lit.any()
    assert (img[..., :3][lit] <= srgb[..., :3][lit] + 1e-6).all()
    rgb, depth, alpha = tb.render(img_idx=0, spp=1)  # the img_idx form is unchanged
    assert rgb.shape[-1] == 3 and depth.ndim == 2
    # At the training view's own size, the two forms render the same rays.
    W, H = tb.dataset.resolution
    np.testing.assert_array_equal(tb._focal_for((W, H)), tb.cameras.focal[0].numpy())
    np.testing.assert_array_equal(tb.render(W, H, 2)[..., :3], tb.render(img_idx=0, spp=2)[0])


def test_change_to_frame_and_reload(tb, tmp_path):
    tb.change_to_frame(0)
    assert tb.current_training_time_frame == 0
    cfg_json = {
        "encoding": {"n_levels": 3, "log2_hashmap_size": 11, "base_resolution": 16,
                     "per_level_scale": 1.4},
        "network": {"n_neurons": 16, "n_hidden_layers": 1},
        "rgb_network": {"n_neurons": 16, "n_hidden_layers": 2},
    }
    p = tmp_path / "net.json"
    p.write_text(json.dumps(cfg_json))
    tb.reload_network_from_file(p)
    assert tb.config.field.grid.n_levels == 3
    assert tb.training_step == 0
    assert tb.state is not None and tb.n_encoding_params > 0
    assert len(tb.state.params["hashgrid"]) == 3


@pytest.fixture(scope="module")
def textured_pair():
    """A JAX Testbed with a textured field and the port Testbed built from
    its state, and their render configs at 256 samples a ray."""
    jcfg = JTrainConfig(field=JFieldConfig(grid=JGrid(**_GRID), **_FIELD), **_TRAIN)
    jtb = JTestbed(config=jcfg, hyper=JHyperparams(first_frame_max_training_step=0))
    jtb.load_training_data_from_datasets([jax_sphere(n_views=3, resolution=20, seed=4)])
    p = dict(jtb.state.params)
    p["hashgrid"] = tuple(t * 30.0 for t in p["hashgrid"])  # some texture
    jtb.state = jtb.state._replace(ema_params=p)
    tb = interop.testbed_from_jax(jax.device_get(jtb.state), jtb.hyper, tiny_config(),
                                  make_sphere_dataset(n_views=3, resolution=20, seed=4))
    jrc = dataclasses.replace(jtb._default_render_cfg(), samples_per_ray=256)
    trc = dataclasses.replace(tb._default_render_cfg(), samples_per_ray=256)
    return jtb, tb, jrc, trc


def test_pyngp_render_matches_jax(textured_pair):
    """At a training view's camera the two packages' renders agree within
    the render tolerance.  At a free camera (a json row, fov 50, shifted
    screen centre) the camera each package derives is the same to the bit,
    and the port renders exactly what its ``render_image`` gives for the
    JAX Testbed's camera.  The renders are not compared there: at one
    pixel the packages' depth differs by 2.2e-3, with all 384 candidates
    occupied in both and their totals within 2e-7, so not at a marcher
    tie: one sample lies within an ulp of a hash-grid cell face, where the
    interpolated gradient jumps (test_free_camera_depth_gap_is_a_one_ulp_
    cell_face_jump)."""
    jtb, tb, jrc, trc = textured_pair
    for t in (jtb, tb):
        t.background_color = np.array([0.2, 0.3, 0.4, 1.0], np.float32)
        t.set_camera_to_training_view(1)
    want = jtb.render(28, 22, 1, render_cfg=jrc)
    got = tb.render(28, 22, 1, render_cfg=trc)
    assert got.shape == want.shape == (22, 28, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-4)
    assert float(got[..., 3].max()) > 0.1 and float(got[..., 3].min()) < 0.01

    ds = tb.dataset  # view 2's pose, back in the nerf convention, as a json row holds it
    mat = ngp_matrix_to_nerf(ds.poses[2], ds.scale, np.asarray(ds.offset, np.float32), ds.from_na)
    for t in (jtb, tb):
        t.set_nerf_camera_matrix(mat)
        t.fov = 50.0
        t.screen_center = (0.45, 0.55)
    focal = jtb._focal_for((28, 22))
    np.testing.assert_array_equal(tb._focal_for((28, 22)), focal)
    np.testing.assert_array_equal(tb._render_pose, np.asarray(jtb._render_pose))
    assert tb.screen_center == jtb.screen_center
    got = tb.render(28, 22, 1, linear=True, render_cfg=trc)
    rgb, _, alpha = render_image(
        tb.state.ema_params, tb.effective_acc, tb.state.occupancy, tb.cameras,
        torch.as_tensor(np.asarray(jtb._render_pose)), torch.as_tensor(focal),
        torch.as_tensor(jtb.screen_center, dtype=torch.float32), None, trc,
        background=jtb.background_color[:3], spp=1, resolution=(28, 22))
    np.testing.assert_array_equal(got[..., :3], srgb_to_linear(rgb).numpy())
    np.testing.assert_array_equal(got[..., 3], alpha.numpy())
    assert float(alpha.max()) > 0.1


def test_free_camera_depth_gap_is_a_one_ulp_cell_face_jump(textured_pair):
    """The free camera of test_pyngp_render_matches_jax: where the two
    packages' renders differ most (2.2e-3 in depth at one pixel), the port
    places every sample of that ray within 2 ulp of the JAX package's (the
    inverse CDF sums its candidates in another order), and the field agrees
    at equal positions; one sample lies within an ulp of a hash-grid cell
    face, where the interpolant's gradient, so the normal and the NeuS
    alpha, jumps.  Nudging that one sample by one ulp moves the JAX
    package's own depth by as much, onto the port's render to 1e-6: the gap
    is the field's discontinuity, not a port fault."""
    import jax.numpy as jnp

    from neus2_tpu.engine import march as jmarch
    from neus2_tpu.engine import render as jrender
    from neus2_tpu.engine.rays import Cameras as JCameras
    from neus2_tpu.engine.rays import pixel_to_ray as jpixel_to_ray
    from neus2_tpu.models import field as jf
    from neus2_tpu.ops import neus_math as jn
    from neus2_tpu.ops.warp import scene_aabb, warp_direction, warp_position
    from neus2_tpu_torch.engine import march as tmarch
    from neus2_tpu_torch.ops.warp import scene_aabb as tscene_aabb

    jtb, tb, jrc, trc = textured_pair
    jcfg = jtb.config
    ds = tb.dataset
    mat = ngp_matrix_to_nerf(ds.poses[2], ds.scale, np.asarray(ds.offset, np.float32), ds.from_na)
    jtb.set_nerf_camera_matrix(mat)
    jtb.fov = 50.0
    jtb.screen_center = (0.45, 0.55)
    w, h, S = 28, 22, 256
    pose, focal = np.asarray(jtb._render_pose), jtb._focal_for((w, h))
    centre = np.asarray(jtb.screen_center, np.float32)
    want = jrender.render_image(jtb.state.ema_params, jtb.effective_acc, jtb.state.occupancy,
                                jtb.cameras, jnp.asarray(pose), jnp.asarray(focal),
                                jnp.asarray(centre), jax.random.PRNGKey(0), jrc, spp=1,
                                resolution=(w, h))[1]
    got = render_image(tb.state.ema_params, tb.effective_acc, tb.state.occupancy, tb.cameras,
                       torch.as_tensor(pose), torch.as_tensor(focal), torch.as_tensor(centre),
                       None, trc, spp=1, resolution=(w, h))[1].numpy()
    gap = np.abs(got - np.asarray(want))
    py, px = np.unravel_index(gap.argmax(), gap.shape)
    assert gap.max() > 1e-3 and np.sort(gap.ravel())[-2] < 3e-4  # one pixel

    uv = np.array([[(px + 0.5) / w, (py + 0.5) / h]], np.float32)
    cam = JCameras(jnp.asarray(pose)[None], jnp.asarray(focal)[None], jnp.asarray(centre)[None],
                   (w, h))
    o, d = jpixel_to_ray(cam, jnp.zeros((1,), jnp.int32), jnp.asarray(uv))
    box = scene_aabb(1)
    js = jmarch.march_rays(jax.random.PRNGKey(0), o, d, box, jtb.state.occupancy,
                           jrc.n_candidates, S, jitter=False, probe_jitter=False)
    ts = tmarch.march_rays(torch.as_tensor(np.array(o)), torch.as_tensor(np.array(d)),
                           tscene_aabb(1), tb.state.occupancy, trc.n_candidates, S, None, None)
    t_jax, t_port = np.asarray(js.t)[0], ts.t.numpy()[0]
    assert np.abs(t_port - t_jax).max() <= 2 * np.spacing(t_jax).max()

    @jax.jit
    def depth_of(t):  # -> (depth, normals) of the ray with samples at t
        t = t[None]
        pos = warp_position(o[:, None, :] + t[..., None] * d[:, None, :], box).reshape(S, 3)
        out = jf.field_forward(jtb.state.ema_params, pos,
                               jnp.repeat(warp_direction(d), S, 0), jcfg.field)
        alpha = jn.neus_alpha(out.sdf[None], out.normal[None], d[:, None, :], js.dt, out.inv_s,
                              1.0)
        return jn.composite_rays(out.rgb[None], alpha, t, js.mask, 1e-4).depth[0], out.normal

    depth_jax, n_jax = depth_of(jnp.asarray(t_jax))
    np.testing.assert_allclose(float(depth_jax), want[py, px], atol=1e-6)
    # The JAX field's normals at the port's sample positions: one sample's
    # jumps (a cell face crossed), the rest stay within rounding.
    jump = np.abs(np.asarray(depth_of(jnp.asarray(t_port))[1] - n_jax)).max(-1)
    s = int(jump.argmax())
    assert jump[s] > 0.1 and np.sort(jump)[-2] < 1e-4
    nudged = t_jax.copy()
    nudged[s] = np.nextafter(t_jax[s], t_port[s])  # one ulp toward the port's
    depth_nudged = float(depth_of(jnp.asarray(nudged))[0])
    assert abs(depth_nudged - float(depth_jax)) > 1e-3
    np.testing.assert_allclose(depth_nudged, got[py, px], atol=1e-6)
