"""The port's mesh tools and the CLI's remaining mesh outputs, held against
the JAX package: the z-buffer rasterizer binding (``native/mesh_raster.cpp``),
the Chamfer distance, 1-ring smoothing and vertex refinement
(``engine/mesh.py``), hash-grid introspection (``utils/introspect.py``), the
analytic scenes (``data/synthetic.py``), the ``from_na`` export
(``data/export.py``) and the static CLI with ``--shaded_mesh
--save_eval_images --ref_mesh --mesh_largest_component --grid_stats
--near_distance --hit_oversample``.

Tolerances: the rasterizer within 1e-6 (one C++ source, built with other
compiler flags, so a contracted multiply-add may move a value by an ulp),
and its coverage equal but on at most 1% of the pixels (a pixel centre
within a rounding of a triangle's edge: in the "pose" case the 17 pixel
centres on the quad's shared diagonal, which the JAX package's build,
with contracted multiply-adds, leaves uncovered and the port's covers);
Chamfer within 1e-6 (the same subsample; float32 sums in another order);
ring centroids and smoothing within 1e-6; refined vertices within 1e-5
(five Newton steps through the field, each rounding differently); the
level stats, histograms, scenes, CSG dataset and the exported files equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from neus2_tpu.data import synthetic as jsyn
from neus2_tpu.data.dataset import load_dataset as jload_dataset
from neus2_tpu.data.export import save_dataset_na as jsave_dataset_na
from neus2_tpu.engine import mesh as jmesh
from neus2_tpu.models.field import FieldConfig as JFieldConfig
from neus2_tpu.models.field import init_field as jinit_field
from neus2_tpu.native import render_mesh_image as jrender_mesh_image
from neus2_tpu.ops.hashgrid import HashGridConfig as JGrid
from neus2_tpu.utils import introspect as jintro
from neus2_tpu_torch import interop, run
from neus2_tpu_torch.data import synthetic
from neus2_tpu_torch.data.dataset import load_dataset
from neus2_tpu_torch.data.export import save_dataset_na
from neus2_tpu_torch.engine import mesh
from neus2_tpu_torch.engine.sdf_mode import load_mesh_obj
from neus2_tpu_torch.models.field import sdf_fn
from neus2_tpu_torch.native import marching_cubes, render_mesh_image
from neus2_tpu_torch.utils import introspect

torch.set_num_threads(2)

# tests/test_meshrender.py's quad facing an identity camera at z = 2.
QUAD_V = np.array([[-0.5, -0.5, 2], [0.5, -0.5, 2], [0.5, 0.5, 2], [-0.5, 0.5, 2]], np.float32)
QUAD_F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
POSE = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1).astype(np.float32)


def sphere_mesh(res=40):
    """Marching cubes of ``sphere_sdf`` in the unit cube, cell centres."""
    xs = (np.arange(res) + 0.5) / res
    grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    v, f = marching_cubes(synthetic.sphere_sdf(grid).astype(np.float32))
    return ((v + 0.5) / res).astype(np.float32), f


def _raster_cases():
    back = POSE.copy()
    back[2, 3] = -1.0
    v2 = np.concatenate([QUAD_V, QUAD_V + np.array([0, 0, 1], np.float32)])
    f2 = np.concatenate([QUAD_F, QUAD_F + 4]).astype(np.int32)
    sv, sf = sphere_mesh()
    orbit = jsyn._look_at(np.array([0.5, -0.9, 1.1], np.float32), np.full(3, 0.5, np.float32),
                          np.array([0.0, 0.0, 1.0], np.float32))
    return {
        "normal": (QUAD_V, QUAD_F, POSE, (100, 100), (0.5, 0.5), (64, 64), {}),
        "shaded": (QUAD_V, QUAD_F, POSE, (100, 100), (0.5, 0.5), (64, 64), {"shaded": True}),
        "zbuffer": (v2, f2, POSE, (100, 100), (0.5, 0.5), (64, 64), {}),
        "pose": (QUAD_V, QUAD_F, back, (100, 100), (0.5, 0.5), (64, 64), {}),
        "sphere": (sv, sf, orbit, (60.0, 62.0), (0.45, 0.55), (48, 40), {}),
        "sphere_lit": (sv, sf, orbit, (60.0, 62.0), (0.45, 0.55), (48, 40),
                       {"shaded": True, "light_dir": np.array([0.3, -0.2, 0.9], np.float32)}),
    }


@pytest.mark.parametrize("case", sorted(_raster_cases()))
def test_render_mesh_image_matches_jax(case):
    v, f, pose, focal, principal, res, kw = _raster_cases()[case]
    rgb, depth = render_mesh_image(v, f, pose, focal, principal, res, **kw)
    jrgb, jdepth = jrender_mesh_image(v, f, pose, focal, principal, res, **kw)
    assert rgb.shape == (res[1], res[0], 3) and depth.shape == (res[1], res[0])
    # A pixel centre within a rounding of a triangle's edge may be covered
    # in one build and not the other.
    same = (depth > 0) == (jdepth > 0)
    assert (~same).mean() <= 0.01, (~same).sum()
    np.testing.assert_allclose(rgb[same], jrgb[same], rtol=0, atol=1e-6)
    np.testing.assert_allclose(depth[same], jdepth[same], rtol=1e-6, atol=0)
    assert (depth > 0).any() and (depth == 0).any()
    if case == "normal":  # tests/test_meshrender.py's values
        np.testing.assert_allclose(rgb[32, 32], [0.5, 0.5, 0.0], atol=1e-5)
        np.testing.assert_allclose(depth[32, 32], 2.0, atol=1e-4)
    if case == "shaded":
        np.testing.assert_allclose(rgb[32, 32], [0.95] * 3, atol=1e-5)


def test_chamfer_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(5000, 3)).astype(np.float32)
    b = (rng.normal(size=(4000, 3)) * 1.1 + 0.05).astype(np.float32)
    got = mesh.chamfer_distance(a, b, n_sample=3000, seed=2, device="cpu", chunk=700)
    ref = jmesh.chamfer_distance(a, b, n_sample=3000, seed=2)
    assert abs(got - ref) <= 1e-6 * ref and got > 0
    assert mesh.chamfer_distance(a, a, device="cpu") == 0.0


def _fan():
    ring = np.array([[0.45, 0.5, 0.5], [0.5, 0.45, 0.5], [0.55, 0.5, 0.5], [0.5, 0.55, 0.5]],
                    np.float32)
    verts = np.concatenate([[[0.5, 0.5, 0.9]], ring, [[0.1, 0.1, 0.1]]]).astype(np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1]], np.int32)
    return ring, verts, faces


def test_ring_centroids_and_smoothing_match_jax():
    ring, verts, faces = _fan()
    cent = mesh.ring_centroids(torch.from_numpy(verts), torch.from_numpy(faces)).numpy()
    jcent = np.asarray(jmesh.ring_centroids(jnp.asarray(verts), jnp.asarray(faces)))
    np.testing.assert_allclose(cent, jcent, rtol=0, atol=1e-6)
    np.testing.assert_allclose(cent[0], ring.mean(0), atol=1e-6)
    np.testing.assert_array_equal(cent[5], verts[5])  # on no triangle: kept
    sv, sf = sphere_mesh(24)
    noisy = sv + np.random.default_rng(1).normal(0, 0.01, sv.shape).astype(np.float32)
    np.testing.assert_array_equal(mesh.smooth_vertices_1ring(noisy, sf, 0.4),
                                  jmesh.smooth_vertices_1ring(noisy, sf, 0.4))


@pytest.fixture(scope="module")
def field():
    jcfg = JFieldConfig(grid=JGrid(n_levels=4, log2_hashmap_size=12, base_resolution=8,
                                   per_level_scale=1.6), sdf_hidden_dim=32, rgb_hidden_dim=32)
    jparams = jax.device_get(jinit_field(jax.random.PRNGKey(0), jcfg))
    return jcfg, jparams, interop.config_from_jax(jcfg), interop.params_from_jax(jparams)


def test_refine_vertices_matches_jax(field):
    """tests/test_extras.py's two cases: projection onto the init sphere
    from r = 0.4, and the smoothing pull with step 0 (plus inflation)."""
    jcfg, jparams, cfg, params = field
    d = np.random.default_rng(0).normal(size=(128, 3))
    v0 = (0.5 + 0.4 * d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    v1 = mesh.refine_vertices(params, cfg, torch.from_numpy(v0), n_iters=8)
    jv1 = jmesh.refine_vertices(jparams, jcfg, jnp.asarray(v0), n_iters=8)
    np.testing.assert_allclose(v1.numpy(), np.asarray(jv1), rtol=0, atol=1e-5)
    s0, _ = sdf_fn(params, torch.from_numpy(v0), cfg)
    s1, _ = sdf_fn(params, v1, cfg)
    assert float(s1.abs().mean()) < 0.2 * float(s0.abs().mean())

    ring, verts, faces = _fan()
    kw = dict(n_iters=2, step=0.0, k_smooth=0.5, k_inflate=0.01)
    v_sm = mesh.refine_vertices(params, cfg, torch.from_numpy(verts),
                                faces=torch.from_numpy(faces), **kw).numpy()
    jv_sm = jmesh.refine_vertices(jparams, jcfg, jnp.asarray(verts), faces=jnp.asarray(faces),
                                  **kw)
    np.testing.assert_allclose(v_sm, np.asarray(jv_sm), rtol=0, atol=1e-5)
    v_raw = mesh.refine_vertices(params, cfg, torch.from_numpy(verts), n_iters=1, step=0.0)
    np.testing.assert_array_equal(v_raw.numpy(), verts)
    d_before = np.linalg.norm(verts[0] - ring.mean(0))
    assert np.linalg.norm(v_sm[0] - ring.mean(0)) < 0.6 * d_before


def test_hashgrid_introspection_matches_jax(field):
    jcfg, jparams, _, params = field
    jparams = dict(jparams, hashgrid=tuple(t * np.float32(3e3) for t in jparams["hashgrid"]))
    params = interop.params_from_jax(jparams)
    stats, jstats = introspect.hashgrid_level_stats(params), jintro.hashgrid_level_stats(jparams)
    assert stats == jstats and len(stats) == 4
    for lvl in range(4):
        for scale in (1.0, 0.25):
            h = introspect.hashgrid_level_histogram(params, lvl, histo_scale=scale)
            np.testing.assert_array_equal(h, jintro.hashgrid_level_histogram(jparams, lvl, scale))
            assert h.shape == (257,)
    assert introspect.format_level_stats(stats) == jintro.format_level_stats(jstats)
    assert introspect.ZERO_EPS == jintro.ZERO_EPS == 1e-5


def test_scenes_match_jax_bitwise():
    assert list(synthetic.SCENES) == list(jsyn.SCENES) == ["csg", "dumbbell", "bowl"]
    pts = np.random.default_rng(0).uniform(0.0, 1.0, (20000, 3)).astype(np.float32)
    for name, (sdf, albedo) in synthetic.SCENES.items():
        jsdf, jalbedo = jsyn.SCENES[name]
        np.testing.assert_array_equal(sdf(pts), jsdf(pts), err_msg=name)
        np.testing.assert_array_equal(albedo(pts), jalbedo(pts), err_msg=name)
        assert sdf(pts).min() < -0.01 and sdf(pts).max() > 0.01, name
    np.testing.assert_array_equal(synthetic.sphere_sdf(pts), jsyn.sphere_sdf(pts))
    for kw in ({}, {"sdf": synthetic.bowl_sdf, "albedo": synthetic._bowl_albedo}):
        ds = synthetic.make_csg_dataset(n_views=3, resolution=16, seed=1, **kw)
        jkw = {k: getattr(jsyn, v.__name__) for k, v in kw.items()}
        jds = jsyn.make_csg_dataset(n_views=3, resolution=16, seed=1, **jkw)
        for f in ("images", "poses", "focal", "principal"):
            np.testing.assert_array_equal(getattr(ds, f), getattr(jds, f), err_msg=f)
        assert (ds.scale, ds.offset, ds.aabb_scale, ds.from_na) == (
            jds.scale, jds.offset, jds.aabb_scale, jds.from_na)
        assert 0 < ds.images[..., 3].mean() < 1


def test_save_dataset_na_reads_back_in_both_packages(tmp_path):
    ds = synthetic.make_csg_dataset(n_views=3, resolution=20, seed=0)
    js = save_dataset_na(ds, tmp_path / "port")
    jjs = jsave_dataset_na(ds, tmp_path / "jax")
    assert json.loads(js.read_text()) == json.loads(jjs.read_text())
    for i in range(3):
        with Image.open(tmp_path / "port" / "images" / f"{i:04d}.png") as a, \
                Image.open(tmp_path / "jax" / "images" / f"{i:04d}.png") as b:
            assert a.mode == b.mode == "RGBA"
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    back, jback = load_dataset(js), jload_dataset(js)
    np.testing.assert_array_equal(back.images, jback.images)
    np.testing.assert_array_equal(back.poses, jback.poses)
    np.testing.assert_allclose(back.poses, ds.poses, rtol=0, atol=1e-6)
    np.testing.assert_allclose(back.focal, ds.focal, rtol=1e-6)
    np.testing.assert_allclose(back.images[..., 3], ds.images[..., 3], atol=0.5 / 255)


NETWORK = {
    "encoding": {"n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 12,
                 "base_resolution": 16, "per_level_scale": 1.45},
    "network": {"n_neurons": 16, "n_hidden_layers": 1},
    "rgb_network": {"n_neurons": 16, "n_hidden_layers": 2},
}


def test_cli_mesh_outputs(tmp_path):
    """The static CLI's remaining flags: the mesh panel of each eval view
    (Lambertian), the Chamfer distance to the true sphere's mesh, the
    largest component, the level stats, and the near / oversample knobs
    in the Testbed's config."""
    save_dataset_na(synthetic.make_sphere_dataset(n_views=4, resolution=24, seed=0),
                    tmp_path / "train")
    test = save_dataset_na(synthetic.make_sphere_dataset(n_views=2, resolution=24, seed=1),
                           tmp_path / "test")
    (tmp_path / "net.json").write_text(json.dumps(NETWORK))
    sv, sf = sphere_mesh(32)
    ref = tmp_path / "ref.obj"
    mesh.save_mesh_obj(ref, sv, sf, offset=(0.5, 0.5, 0.5))  # the dataset's space
    tb = run.main([
        "--scene", str(tmp_path / "train" / "transforms.json"),
        "--network", str(tmp_path / "net.json"), "--name", "m",
        "--output_dir", str(tmp_path / "out"), "--n_steps", "4", "--n_rays", "64",
        "--samples_per_ray", "16", "--device", "cpu", "--save_mesh", "--mesh_resolution", "32",
        "--test_transforms", str(test), "--eval_spp", "1", "--save_eval_images",
        "--shaded_mesh", "--ref_mesh", str(ref), "--mesh_largest_component", "--grid_stats",
        "--near_distance", "0.05", "--hit_oversample", "1",
    ])
    assert tb.config.near == 0.05 and tb.config.hit_oversample == 1
    out = tmp_path / "out" / "m"
    for i in range(2):
        assert (out / "evaluation" / f"view_{i:03d}.png").exists()
        with Image.open(out / "evaluation" / f"view_{i:03d}_mesh.png") as im:
            px = np.asarray(im)
        assert px.shape == (24, 24, 3)
        grey = px[px.max(-1) > 0]
        assert len(grey) and (grey == grey[:, :1]).all()  # shaded: grey, hits and background
        assert (px.max(-1) == 0).any()
    v, f = load_mesh_obj(out / "mesh" / "mesh.obj")
    kept, _ = mesh.largest_component(v, f)
    assert len(f) > 100 and len(kept) == len(v)
    log = (out / "log.txt").read_text()
    cd = float(log.split(f"chamfer vs {ref}: ")[1].split()[0])
    assert 0.0 < cd < 0.5
    assert "hashgrid level stats" in log and "nonzero" in log
    assert len(json.loads((out / "metrics.json").read_text())["psnr"]) == 2
