"""Port parity of the render and mesh paths and the image metrics, on the
same field parameters (carried from the JAX package by ``interop``) and
the same occupancy grid, at a small width.

Tolerances: renders at spp 1 without jitter are deterministic in both
packages, so every output agrees to max |diff| <= 3e-4: fp32 sums over a
ray's samples taken in another order, and a sample whose transmittance
sits at the 1e-4 cut may be kept by one package and not the other, which
moves rgb and opacity by at most 1e-4 and depth by at most 1e-4 t (t < 2
here).  The render configurations keep out two rounding ties of the
marcher, where one ulp moves a sample by a whole candidate (``MARCH_TIES``).  The SDF grid, vertex colours and the
image metrics agree to 1e-5; the marching-cubes binding, vertex normals and
the largest component exactly (the same host C++ and numpy on the same
arrays).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neus2_tpu import native as jnative
from neus2_tpu.data.synthetic import make_sphere_dataset as jax_sphere
from neus2_tpu.engine import march as jmarch
from neus2_tpu.engine import mesh as jmesh
from neus2_tpu.engine import occupancy as jocc
from neus2_tpu.engine import render as jrender
from neus2_tpu.engine.rays import Cameras as JCameras
from neus2_tpu.engine.rays import pixel_to_ray as jpixel_to_ray
from neus2_tpu.models import delta as jdelta
from neus2_tpu.models import field as jf
from neus2_tpu.ops import image as jimage
from neus2_tpu.ops.hashgrid import HashGridConfig as JGrid
from neus2_tpu.ops.warp import scene_aabb as jaabb
from neus2_tpu_torch import interop, native
from neus2_tpu_torch.engine import march as tmarch
from neus2_tpu_torch.engine import mesh as tmesh
from neus2_tpu_torch.engine import occupancy as tocc
from neus2_tpu_torch.engine import render as trender
from neus2_tpu_torch.engine.rays import Cameras as TCameras
from neus2_tpu_torch.models import field as tf
from neus2_tpu_torch.ops import image as timage
from neus2_tpu_torch.ops.hashgrid import HashGridConfig as TGrid
from neus2_tpu_torch.ops.tonemap import apply_output_tonemap
from neus2_tpu_torch.ops.warp import scene_aabb as taabb

torch.set_num_threads(2)
G = 128
RES = 16
_GRID = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=12,
             base_resolution=16, per_level_scale=2.0)
_FIELD = dict(sdf_hidden_dim=16, rgb_hidden_dim=16)
# The marcher's two rounding ties, kept out of the render configurations:
# (1) a ray crossing the box from face to face has its C candidate
#     midpoints at (k + 1/2) / C of the way, on a face of the 128 occupancy
#     cells when C divides 64 (2k + 1); XLA's fused code and op-by-op code
#     round such a point into different cells;
# (2) the k-th of S stratified samples falls exactly on a candidate
#     boundary when 2S divides (2k + 1) n, n the ray's occupied candidates,
#     and the packages sum the n segments in different orders.
# C = 128 or 384 with S = 256 have neither.
MARCH_TIES = dict(n_candidates=G, samples_per_ray=256)
_RENDER = dict(MARCH_TIES, min_transmittance=1e-4, chunk=100)


@pytest.fixture(scope="module")
def scene():
    """Field, occupancy (a ball of radius 0.3), two cameras, both packages."""
    jc = jf.FieldConfig(grid=JGrid(**_GRID), **_FIELD)
    tc = tf.FieldConfig(grid=TGrid(**_GRID), **_FIELD)
    p = jf.init_field(jax.random.PRNGKey(0), jc)
    p["hashgrid"] = tuple(t * 30.0 for t in p["hashgrid"])  # some texture
    pj = jax.tree_util.tree_map(np.asarray, p)
    c = (np.arange(G) + 0.5) / G - 0.5
    ball = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2 < 0.3**2
    dens = np.where(ball, 0.1, 0.0).astype(np.float32)[None]
    ds = jax_sphere(n_views=2, resolution=RES, seed=3)
    return {
        "jc": jc, "tc": tc,
        "jp": jax.tree_util.tree_map(jnp.asarray, pj), "tp": interop.params_from_jax(pj),
        "jocc": jocc.OccupancyGrid(jnp.asarray(dens), jnp.asarray(dens > 0.05), jnp.int32(5)),
        "tocc": tocc.OccupancyGrid(torch.from_numpy(dens), torch.from_numpy(dens > 0.05), 5),
        "jcam": JCameras(jnp.asarray(ds.poses), jnp.asarray(ds.focal),
                         jnp.asarray(ds.principal), (RES, RES)),
        "tcam": TCameras(torch.from_numpy(ds.poses), torch.from_numpy(ds.focal),
                         torch.from_numpy(ds.principal), (RES, RES)),
        "jcfg": jrender.RenderConfig(field=jc, **_RENDER),
        "tcfg": trender.RenderConfig(field=tc, **_RENDER),
    }


def _rays(s, view=0):
    u = (np.arange(RES) + 0.5) / RES
    uu, vv = np.meshgrid(u, u)
    uv = jnp.asarray(np.stack([uu.ravel(), vv.ravel()], -1), jnp.float32)
    idx = jnp.full((uv.shape[0],), view, jnp.int32)
    o, d = jpixel_to_ray(s["jcam"], idx, uv)
    return np.array(o), np.array(d)


def _close(got, ref, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol)


def test_march_probe(scene):
    o, d = _rays(scene)
    ref = jmarch.march_probe(jnp.asarray(o), jnp.asarray(d), jaabb(1), scene["jocc"], G)
    got = tmarch.march_probe(torch.from_numpy(o), torch.from_numpy(d), taabb(1),
                             scene["tocc"], G)
    _close(got, ref, 1e-5)
    assert (got > 0).any() and not (got > 0).all()


@pytest.mark.parametrize("compact", [False, True])
def test_render_rays(scene, compact):
    o, d = _rays(scene, view=1)
    ref = jrender.render_rays(scene["jp"], jdelta.init_accumulated(), scene["jocc"],
                              jnp.asarray(o), jnp.asarray(d), jax.random.PRNGKey(0),
                              scene["jcfg"], jitter=False, compact=compact)
    got = trender.render_rays(scene["tp"], None, scene["tocc"], torch.from_numpy(o),
                              torch.from_numpy(d), None, scene["tcfg"], compact=compact)
    for g, r in zip(got, ref):
        _close(g, r, 3e-4)
    assert float(got[2].max()) > 0.1  # some rays hit the surface


@pytest.mark.parametrize("mode", ["shade", "normals", "depth", "cost"])
def test_render_image(scene, mode):
    jc, tc = scene["jcam"], scene["tcam"]
    ref = jrender.render_image(scene["jp"], jdelta.init_accumulated(), scene["jocc"], jc,
                               jc.poses[0], jc.focal[0], jc.principal[0],
                               jax.random.PRNGKey(1), scene["jcfg"], background=0.0, spp=1,
                               mode=mode)
    got = trender.render_image(scene["tp"], None, scene["tocc"], tc, tc.poses[0],
                               tc.focal[0], tc.principal[0], None, scene["tcfg"],
                               background=0.0, spp=1, mode=mode)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        _close(g, r, 3e-4)


def test_render_image_jittered_passes(scene):
    """spp > 1 averages passes drawn from the caller's generator; the hit
    set comes from one deterministic probe, so pixels that miss stay the
    background in every pass."""
    tc = scene["tcam"]
    args = (scene["tp"], None, scene["tocc"], tc, tc.poses[1], tc.focal[1], tc.principal[1])
    one = trender.render_image(*args, None, scene["tcfg"], background=0.2, spp=1)
    gen = torch.Generator().manual_seed(0)
    four = trender.render_image(*args, gen, scene["tcfg"], background=0.2, spp=4)
    again = trender.render_image(*args, torch.Generator().manual_seed(0), scene["tcfg"],
                                 background=0.2, spp=4)
    assert torch.equal(four[0], again[0])
    miss = one[2] == 0
    assert miss.any() and torch.equal(four[0][miss], one[0][miss])
    assert float((four[0] - one[0]).abs().max()) < 0.2
    # The output curve applies to the shaded frame (tests/test_torch_camera.py
    # holds it against the JAX package's).
    aces = trender.render_image(*args, None, scene["tcfg"], background=0.2, spp=1,
                                tonemap="aces")
    assert torch.equal(aces[0], torch.clamp(apply_output_tonemap(one[0], 0.0, "aces"), 0, 1))


def test_sdf_grid_and_extract_mesh(scene):
    box = jaabb(1)
    ref = jmesh.sdf_grid(scene["jp"], scene["jc"], box.lo, box.hi, box.lo, box.diag,
                         resolution=32)
    tbox = taabb(1)
    got = tmesh.sdf_grid(scene["tp"], scene["tc"], tbox.lo, tbox.hi, tbox.lo, tbox.diag,
                         resolution=32, chunk=5000)
    _close(got, ref, 1e-5)
    # No value within the packages' difference (< 1e-6) of the level set,
    # where the sign, and with it the topology, could go either way.
    assert float(np.abs(np.asarray(ref)).min()) > 1e-6
    jv, jt = jmesh.extract_mesh(scene["jp"], scene["jc"], resolution=32)
    tv, tt = tmesh.extract_mesh(scene["tp"], scene["tc"], resolution=32)
    assert len(tt) > 100
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
    ref_c = jmesh.vertex_colors(scene["jp"], scene["jc"], jnp.asarray(jv), box.lo, box.diag)
    got_c = tmesh.vertex_colors(scene["tp"], scene["tc"], torch.from_numpy(tv), tbox.lo,
                                tbox.diag, chunk=300)
    _close(got_c, ref_c, 1e-5)


def _two_spheres(shape=(30, 26, 22)):
    """An SDF grid of two disjoint balls of unequal size, unequal sides."""
    rng = np.random.default_rng(0)
    axes = [np.arange(n, dtype=np.float32) for n in shape]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    a = np.sqrt((x - 9) ** 2 + (y - 9) ** 2 + (z - 9) ** 2) - 6.3
    b = np.sqrt((x - 22) ** 2 + (y - 17) ** 2 + (z - 13) ** 2) - 3.7
    return (np.minimum(a, b) + rng.normal(0, 0.05, shape)).astype(np.float32)


def test_marching_cubes_binding_matches_jax():
    grid = _two_spheres()
    tv, tt = native.marching_cubes(grid)
    jv, jt = jnative.marching_cubes(grid)
    assert len(tt) > 500
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)
    tv, tt = native.marching_cubes(grid, thresh=0.5)
    jv, jt = jnative.marching_cubes(grid, thresh=0.5)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)


def test_vertex_normals_and_largest_component():
    verts, tris = jnative.marching_cubes(_two_spheres())
    np.testing.assert_array_equal(tmesh.vertex_normals(verts, tris),
                                  jmesh.vertex_normals(verts, tris))
    tv, tt = tmesh.largest_component(verts, tris)
    jv, jt = jmesh.largest_component(verts, tris)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)
    assert 0 < len(tt) < len(tris)  # the small ball went


def test_mesh_files_match_jax(tmp_path):
    verts, tris = jnative.marching_cubes(_two_spheres((12, 12, 12)))
    normals = jmesh.vertex_normals(verts, tris)
    colors = np.random.default_rng(1).uniform(0, 1, verts.shape).astype(np.float32)
    kw = dict(scale=0.33, offset=(0.5, 0.4, 0.5), normals=normals)
    for suffix, tsave, jsave, extra in (
        ("obj", tmesh.save_mesh_obj, jmesh.save_mesh_obj, {}),
        ("ply", tmesh.save_mesh_ply, jmesh.save_mesh_ply, {"colors": colors}),
    ):
        tsave(tmp_path / f"t.{suffix}", verts, tris, **kw, **extra)
        jsave(tmp_path / f"j.{suffix}", verts, tris, **kw, **extra)
        t_lines = (tmp_path / f"t.{suffix}").read_text().splitlines()
        j_lines = (tmp_path / f"j.{suffix}").read_text().splitlines()
        skip = 1 if suffix == "obj" else 0  # the OBJ comment names the package
        assert t_lines[skip:] == j_lines[skip:]


def test_image_metrics():
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (32, 40, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _close(timage.mse(ta, tb), jimage.mse(a, b), 1e-7)
    _close(timage.psnr(ta, tb), jimage.psnr(a, b), 1e-4)
    _close(timage.ssim(ta, tb), jimage.ssim(jnp.asarray(a), jnp.asarray(b)), 1e-5)
    _close(timage.ssim(ta[..., 0], tb[..., 0]),
           jimage.ssim(jnp.asarray(a[..., 0]), jnp.asarray(b[..., 0])), 1e-5)
    tex = rng.uniform(0, 1, (16, 16, 4)).astype(np.float32)
    tex[..., 3] = np.where(rng.uniform(size=(16, 16)) < 0.3, 0.0, tex[..., 3])
    tex[..., :3] *= tex[..., 3:]
    _close(timage.srgb_eval_target(torch.from_numpy(tex)),
           jimage.srgb_eval_target(jnp.asarray(tex)), 1e-5)


@pytest.fixture(scope="module")
def scene4(scene):
    """The field of ``scene`` over an aabb_scale-4 box: 3 cascades, a ball
    of radius 0.25 around the centre and one of 0.3 around (1.25, 0.5, 0.5),
    outside the unit cube, marked through the cascade that holds each
    cell; cameras of tests/test_cascades.py's scene (distance 2.6)."""
    from neus2_tpu.data.synthetic import make_multi_sphere_dataset

    c = (np.arange(G) + 0.5) / G
    cell = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1)[..., ::-1]  # (z, y, x) -> xyz
    dens = np.zeros((3, G, G, G), np.float32)
    for k in range(3):
        pos = (cell - 0.5) * 2.0**k + 0.5
        near = ((np.linalg.norm(pos - 0.5, axis=-1) < 0.3)
                | (np.linalg.norm(pos - [1.25, 0.5, 0.5], axis=-1) < 0.35))
        dens[k] = np.where(near, 0.1, 0.0)
    ds = make_multi_sphere_dataset([(np.array([0.5, 0.5, 0.5], np.float32), 0.25),
                                    (np.array([1.25, 0.5, 0.5], np.float32), 0.3)],
                                   n_views=2, resolution=RES, cam_distance=2.6, aabb_scale=4)
    return {
        "jocc": jocc.OccupancyGrid(jnp.asarray(dens), jnp.asarray(dens > 0.05), jnp.int32(5)),
        "tocc": tocc.OccupancyGrid(torch.from_numpy(dens), torch.from_numpy(dens > 0.05), 5),
        "jcam": JCameras(jnp.asarray(ds.poses), jnp.asarray(ds.focal),
                         jnp.asarray(ds.principal), (RES, RES)),
        "tcam": TCameras(torch.from_numpy(ds.poses), torch.from_numpy(ds.focal),
                         torch.from_numpy(ds.principal), (RES, RES)),
    }


@pytest.mark.parametrize("cone", [False, True])
def test_render_at_aabb_scale4(scene, scene4, cone):
    """``render_image`` (its ``march_probe`` compaction, the multi-cascade
    lookup, the warp-metric dt) and ``march_probe`` over the aabb_scale-4
    box, with the render's uniform candidates (the Testbed's and the eval's
    render configuration, cone angle 0) and with the cone angle's
    exponential ones; the module's tolerances."""
    cone_angle = jmarch.cone_angle_for_scene(4) if cone else 0.0
    jcfg = jrender.RenderConfig(field=scene["jc"], aabb_scale=4, cone_angle=cone_angle,
                                **_RENDER)
    tcfg = trender.RenderConfig(field=scene["tc"], aabb_scale=4, cone_angle=cone_angle,
                                **_RENDER)
    jc, tc = scene4["jcam"], scene4["tcam"]
    o, d = (np.array(a) for a in jpixel_to_ray(
        jc, jnp.zeros((RES * RES,), jnp.int32),
        jnp.asarray(np.stack(np.meshgrid((np.arange(RES) + 0.5) / RES,
                                         (np.arange(RES) + 0.5) / RES), -1).reshape(-1, 2),
                    jnp.float32)))
    ref = jmarch.march_probe(jnp.asarray(o), jnp.asarray(d), jaabb(4), scene4["jocc"],
                             jcfg.n_candidates, cone_angle=cone_angle)
    got = tmarch.march_probe(torch.from_numpy(o), torch.from_numpy(d), taabb(4),
                             scene4["tocc"], tcfg.n_candidates, cone_angle=cone_angle)
    _close(got, ref, 1e-5)
    assert (got > 0).any() and not (got > 0).all()
    for view in range(2):
        ref = jrender.render_image(scene["jp"], jdelta.init_accumulated(), scene4["jocc"], jc,
                                   jc.poses[view], jc.focal[view], jc.principal[view],
                                   jax.random.PRNGKey(1), jcfg, background=0.0, spp=1)
        got = trender.render_image(scene["tp"], None, scene4["tocc"], tc, tc.poses[view],
                                   tc.focal[view], tc.principal[view], None, tcfg,
                                   background=0.0, spp=1)
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            _close(g, r, 3e-4)
        assert float(got[2].max()) > 0.1
