"""The last six root tools' ports (``neus2_tpu_torch/tools/``: validate,
validate_dynamic, occ_char, occlen_run, bucket_cont, compact_ab) held
against the TPU package's ``tools_*.py`` on the CPU.

Everything on the JAX side runs in one subprocess (``jax_side``): the
root tools and ``bench.py`` set or guard JAX's persistent compile cache,
so no test worker imports them.  It builds each tool's config as the tool
does (``bench.flagship_config()`` with the tool's ``replace``s; the two
validation tools' configs as their ``main`` builds them), their points
and the validation target with the tools' own expressions, and runs
``tools_occ_char.py``'s measurement (:69-83) at a small width from a
state it hands over, with the draws of every resweep and step.

Tolerances: configs equal field by field; the points bitwise (the same
numpy draws, the same casts).  The validation target within two float32
ulp: its sRGB curve takes a float32 ``pow``, which XLA's CPU backend and
torch round differently on ~0.4% of the texels (seen: 51 of 12,288 at
64^2, at most two ulp after the premultiplication).  ``mean_occ_len``: every step's within 1e-5
relative of JAX's; the occupancy bits after the resweeps exactly.  The
length is a mean over the batch's rays of the chord through occupied
cells, so it moves only if a bit or a ray's cell walk does; the field's
float32 sums, whose order differs from XLA's, move a probe's density by
~1e-7 relative, far from the bit threshold at every cell of this draw.
A chunked run equals a straight one: the same result, bit for bit,
except the wall time and what the host fetch after a resume changes (the
occ_len EMA starts again there, as in the TPU tools).
"""

import dataclasses
import functools
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neus2_tpu_torch import interop
from neus2_tpu_torch.data.synthetic import SCENES, make_sphere_dataset
from neus2_tpu_torch.ops.hashgrid import HashGridConfig
from neus2_tpu_torch.ops.image import srgb_eval_target
from neus2_tpu_torch.tools import (
    bucket_cont,
    compact_ab,
    occ_char,
    occlen_run,
    protocol,
    validate,
    validate_csg,
    validate_dynamic,
)

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
TARGET_RES = 64  # the validation target's view side
OCC = dict(views=4, res=24, warm=4, resweep=6, measure=4)
_GRID = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=12,
             base_resolution=16, per_level_scale=2.0)

JAX_SIDE = textwrap.dedent("""
    import dataclasses, os, pickle, sys
    import numpy as np
    sys.path.insert(0, os.getcwd())
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    out_path, target_res, occ = sys.argv[1], int(sys.argv[2]), eval(sys.argv[3])
    import jax
    import jax.numpy as jnp
    import bench
    from neus2_tpu.api.testbed import Hyperparams
    from neus2_tpu.data.synthetic import SCENES, make_sphere_dataset
    from neus2_tpu.engine import occupancy as jocc
    from neus2_tpu.engine import train as jt
    from neus2_tpu.engine.train import TrainConfig
    from neus2_tpu.models.field import FieldConfig
    from neus2_tpu.ops.hashgrid import HashGridConfig
    from neus2_tpu.ops.losses import linear_to_srgb
    from neus2_tpu_torch import interop
    from test_torch_train_step import _forward_draws

    grid = HashGridConfig(n_levels=14, log2_hashmap_size=19, base_resolution=16,
                          per_level_scale=HashGridConfig.per_level_scale_from_top(16, 2048, 14))
    validate = TrainConfig(field=FieldConfig(grid=grid), n_rays=4096, samples_per_ray=64,
                           n_candidates=256, ek_loss_weight=0.1, mask_loss_weight=0.1)
    dynamic = TrainConfig(field=FieldConfig(grid=grid), n_rays=4096, samples_per_ray=64,
                          n_candidates=256, ek_loss_weight=0.1, mask_loss_weight=0.1,
                          delta_lr=5e-3)
    hyper = Hyperparams(first_frame_max_training_step=300, next_frame_max_training_step=120,
                        predict_global_movement=True, predict_global_movement_training_step=80,
                        finetune_global_movement=False)
    flag = bench.flagship_config()
    rep = dataclasses.replace
    configs = {"validate": validate, "validate_dynamic": dynamic, "occ_char": flag,
               "occlen_run": flag}
    for os_ in (1, 2):
        configs[f"compact_ab_x{os_}_sphere"] = rep(flag, hit_oversample=os_)
        configs[f"compact_ab_x{os_}_csg"] = rep(rep(flag, hit_oversample=os_),
                                                mask_loss_weight=0.1)
    for b in range(4):
        configs[f"bucket_cont_b{b}"] = rep(flag, n_rays=flag.n_rays << b,
                                           samples_per_ray=flag.samples_per_ray >> b,
                                           adaptive_batch=False)
    res = {"configs": {k: interop.config_from_jax(v) for k, v in configs.items()},
           "jax_fields": {k: sorted(f.name for f in dataclasses.fields(v))
                          for k, v in configs.items()},
           "hyper": dataclasses.asdict(hyper)}

    def normal(n):
        d = np.random.default_rng(0).normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return d
    rng = np.random.default_rng(0)
    pts = rng.uniform(0.2, 0.8, size=(200000, 3)).astype(np.float32)
    res["points"] = {
        "validate": np.asarray(jnp.asarray(0.5 + 0.25 * normal(512), jnp.float32)),
        "occlen_run": np.asarray(jnp.asarray(0.5 + 0.25 * normal(512), jnp.float32)),
        "compact_ab_sphere": (0.5 + 0.25 * normal(4096)).astype(np.float32),
        "compact_ab_csg": pts[np.abs(SCENES["csg"][0](pts)) < 0.01][:4096],
        "bucket_cont": np.asarray(jnp.asarray(
            np.float32(0.5) + np.float32(0.25) * normal(2048).astype(np.float32))),
    }
    tex = make_sphere_dataset(n_views=16, resolution=target_res).images_device()[0]
    a = tex[..., 3:4]
    res["target"] = np.asarray(jnp.where(
        a > 0, linear_to_srgb(tex[..., :3] / jnp.where(a > 0, a, 1.0)) * a, 0.0))

    # tools_occ_char.py :55-83 at a small width, the state handed over
    # after the warm steps with every later draw.
    cfg = rep(flag, field=rep(flag.field, grid=rep(flag.field.grid, n_levels=4,
                                                   log2_hashmap_size=12),
                              sdf_hidden_dim=16, rgb_hidden_dim=16),
              n_rays=128, samples_per_ray=32, n_candidates=64, occ_n_probe=1 << 14)
    ds = make_sphere_dataset(n_views=occ["views"], resolution=occ["res"])
    images, cameras = ds.images_device(), ds.cameras()
    state = jt.init_train_state(jax.random.PRNGKey(0), cfg, n_images=occ["views"])
    state = jt.occupancy_prior_sweep(state, cfg)
    for i in range(occ["warm"]):
        if i % 4 == 0:
            state = jt.occupancy_update(state, cfg)
        state, aux = jt.train_step(state, images, cameras, cfg)
    carried = jax.device_get(state)
    key, jitters, draws = carried.key, [], []
    for _ in range(occ["resweep"]):
        key, k_probe = jax.random.split(key)
        jitters.append(np.array(jax.random.uniform(k_probe, (cfg.occ_n_probe, 3))))
    for _ in range(occ["measure"]):
        key, k_step = jax.random.split(key)
        draws.append(_forward_draws(k_step, cfg, occ["views"]))
    state = state._replace(
        params={**state.params, "variance": jnp.full_like(state.params["variance"], 0.75)},
        occupancy=jocc.reset_density(state.occupancy))
    for _ in range(occ["resweep"]):
        state = jt.occupancy_update(state, cfg)
    bits = np.asarray(state.occupancy.bitfield)
    vals = []
    for _ in range(occ["measure"]):
        state, aux = jt.train_step(state, images, cameras, cfg)
        vals.append(float(aux.mean_occ_len))
    res["occ_char"] = {"config": interop.config_from_jax(cfg), "state": carried,
                       "jitters": jitters, "draws": draws, "bits": bits, "vals": vals,
                       "bucket": jt.desired_batch_bucket(sum(vals) / len(vals), cfg)}
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
""")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_side") / "jax.pkl"
    res = subprocess.run([sys.executable, "-c", JAX_SIDE, str(out), str(TARGET_RES), repr(OCC)],
                         cwd=REPO, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _flag():
    return protocol.flagship_config()


# Each tool's config as the tool builds it.
PORT_CONFIGS = {
    "validate": validate.validate_config,
    "validate_dynamic": validate_dynamic.dynamic_config,
    "occ_char": _flag,
    "occlen_run": _flag,
    **{f"compact_ab_x{o}_{s}": (lambda o=o, s=s: compact_ab.tool_config(o, s))
       for o in (1, 2) for s in ("sphere", "csg")},
    **{f"bucket_cont_b{b}": (lambda b=b: protocol.fixed_bucket(_flag(), b)) for b in range(4)},
}


@pytest.mark.parametrize("name", sorted(PORT_CONFIGS))
def test_tool_config_matches_the_root_tool_field_by_field(jax_side, name):
    got, ref = PORT_CONFIGS[name](), jax_side["configs"][name]
    assert sorted(f.name for f in dataclasses.fields(got)) == jax_side["jax_fields"][name]
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(ref, f.name), (name, f.name)


def test_validate_dynamic_hyperparams_match(jax_side):
    assert dataclasses.asdict(validate_dynamic.dynamic_hyper()) == jax_side["hyper"]


PORT_POINTS = {
    "validate": lambda: protocol.sphere_shell(512, float32_first=False),
    "occlen_run": lambda: protocol.sphere_shell(512, float32_first=False),
    "compact_ab_sphere": lambda: protocol.sphere_shell(4096, float32_first=False),
    "compact_ab_csg": lambda: protocol.csg_surface_points(SCENES["csg"][0]),
    "bucket_cont": lambda: protocol.sphere_shell(2048, float32_first=True),
}


@pytest.mark.parametrize("name", sorted(PORT_POINTS))
def test_points_match_the_root_tool_bitwise(jax_side, name):
    got, ref = PORT_POINTS[name](), jax_side["points"][name]
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_validate_target_matches_the_root_tool_to_two_ulp(jax_side):
    tex = torch.from_numpy(make_sphere_dataset(n_views=16, resolution=TARGET_RES).images[0])
    got = srgb_eval_target(tex).numpy()
    assert got.dtype == np.float32 and (got > 0).any()
    np.testing.assert_array_max_ulp(got, jax_side["target"], maxulp=2)


def test_occ_char_measurement_matches_jax(jax_side):
    """From the JAX state after the warm steps: the variance set, the grid
    reset and re-swept, then the measured steps, on JAX's draws."""
    ref = jax_side["occ_char"]
    cfg = ref["config"]
    images, cams = make_sphere_dataset(n_views=OCC["views"], resolution=OCC["res"]).to_device(
        "cpu")
    state = interop.train_state_from_jax(ref["state"])
    state = occ_char.converge(state, cfg, OCC["resweep"],
                              jitters=[torch.from_numpy(j) for j in ref["jitters"]])
    assert float(state.params["variance"]) == occ_char.CONVERGED_VARIANCE
    np.testing.assert_array_equal(state.occupancy.bitfield.numpy(), ref["bits"])
    _, vals = occ_char.measure(state, images, cams, cfg, OCC["measure"], draws=ref["draws"])
    np.testing.assert_allclose(vals, ref["vals"], rtol=1e-5)
    assert 0.0 < min(vals)
    mean = sum(vals) / len(vals)
    assert occ_char.desired_batch_bucket(mean, cfg) == ref["bucket"]


class FakeTestbed:
    """What ``Chunk`` reads of a Testbed, stepped by a schedule of buckets."""

    def __init__(self, buckets):
        self.device = torch.device("cpu")
        self.training_step, self.batch_bucket, self._occ_len_ema = 0, 0, None
        self.loss_scalar, self.is_dynamic, self.current_training_time_frame = 1.0, False, 0
        self.last_aux = None
        self.config = SimpleNamespace(n_rays=4096)
        self.buckets = buckets

    def train(self):
        self.training_step += 1
        if self.training_step % 16 == 0:  # the host fetch
            self._occ_len_ema = 1.0 / self.training_step
            self.loss_scalar = 0.5 / self.training_step
            self.last_aux = SimpleNamespace(mean_occ_len=2.0 / self.training_step)
        self.batch_bucket = self.buckets(self.training_step)


def test_occ_hist_cadence_and_rates_on_a_fake_clock(monkeypatch):
    """One row every 16 steps; rays/s of a bucket once it has run 64 steps
    since the stretch began or the bucket changed, over those steps, as
    ``tools_occlen_run.py`` :71-89 keeps them.  The fake clock reads
    step^2 / 1000 s, so every stretch has its own rate."""
    tb = FakeTestbed(lambda s: 0 if s < 100 else 1)
    monkeypatch.setattr(protocol.Chunk, "clock",
                        staticmethod(lambda: tb.training_step ** 2 / 1000.0))
    tb.training_step = 8  # a resumed stretch
    chunk = protocol.Chunk(tb, 1e9)
    while tb.training_step < 200:
        chunk.step(tb.train)
    rec = chunk.close()
    assert [r[0] for r in rec["occ_hist"]] == list(range(16, 201, 16))
    assert rec["occ_hist"][0] == [16, round(1 / 16, 5), 0, 0.5 / 16, round(2 / 16, 5)]
    assert [r[2] for r in rec["occ_hist"]] == [0] * 6 + [1] * 6
    # Bucket 0's stretch from step 8, last read at 96; bucket 1's from the
    # row that first saw it (112), last read at 192.
    t = lambda s: s ** 2 / 1000.0  # noqa: E731
    assert rec["rates"] == {"0": round(4096 * (96 - 8) / (t(96) - t(8)), 1),
                            "1": round(8192 * (192 - 112) / (t(192) - t(112)), 1)}
    assert rec["steps"] == 192 and rec["from_step"] == 8


def test_record_chunk_keeps_the_occ_hist_across_chunks(tmp_path):
    path = tmp_path / "r_record.json"
    protocol.record_chunk(path, {"steps": 16, "occ_hist": [[16, 0.1, 0, 0.2, 0.1]]})
    rec = protocol.record_chunk(path, {"steps": 16, "occ_hist": [[32, 0.1, 1, 0.1, 0.1]]})
    assert rec["occ_hist"] == [[16, 0.1, 0, 0.2, 0.1], [32, 0.1, 1, 0.1, 0.1]]
    assert rec["chunks"] == [{"steps": 16}, {"steps": 16}]


def test_fixed_bucket_keeps_the_samples_a_step():
    cfg = _flag()
    for b in range(4):
        got = protocol.fixed_bucket(cfg, b)
        assert (got.n_rays, got.samples_per_ray) == (4096 << b, 64 >> b)
        assert got.n_rays * got.samples_per_ray == 1 << 18 and not got.adaptive_batch


def small(cfg):
    return dataclasses.replace(
        cfg, field=dataclasses.replace(cfg.field, grid=HashGridConfig(**_GRID),
                                       sdf_hidden_dim=16, rgb_hidden_dim=16),
        n_rays=128, samples_per_ray=32, n_candidates=64, occ_n_probe=1 << 12)


@pytest.fixture
def tiny(monkeypatch):
    """Every tool's views at 24^2, rendered in this process; the Testbed's
    prior sweep cut to 16 updates and the held-out eval to 32 samples at
    spp 1 (a CPU test's budget: the full sweep probes 2^21 cells); the
    compaction tool's valid fraction read every 16 steps, on the host
    fetch's steps; the dynamic validation's frames at 40 / 24 steps with 8
    of pose refinement."""
    from neus2_tpu_torch.api import testbed
    from neus2_tpu_torch.engine import train

    for mod in (validate, validate_dynamic, occ_char, occlen_run, compact_ab, bucket_cont):
        monkeypatch.setattr(mod, "RES", 24)
    monkeypatch.setattr(testbed, "occupancy_prior_sweep",
                        functools.partial(train.occupancy_prior_sweep, max_updates=16))
    monkeypatch.setattr(protocol, "heldout_eval",
                        functools.partial(protocol.heldout_eval, samples=32, spp=1))
    monkeypatch.setattr(compact_ab, "VALID_EVERY", 16)
    monkeypatch.setattr(protocol, "default_workers", lambda: 1)
    monkeypatch.setattr(validate_csg, "MESH_RES", 32)
    monkeypatch.setattr(validate_csg, "N_GT_POINTS", 1024)
    hyper = validate_dynamic.dynamic_hyper

    def short():
        return dataclasses.replace(hyper(), first_frame_max_training_step=40,
                                   next_frame_max_training_step=24,
                                   predict_global_movement_training_step=8)

    monkeypatch.setattr(validate_dynamic, "dynamic_hyper", short)


def _compact(work, *argv, scene="sphere"):
    opts = compact_ab.parse_args(["1", "36", "--scene", scene, "--device", "cpu",
                                  "--workdir", str(work), *argv])
    return compact_ab.run(opts, small(_flag()))


def _bucket_cont(work, *argv):
    """Branched from a compact_ab x1 run, which both arms share."""
    base = compact_ab.snapshot_path(work.parent / "base")
    if not base.exists():
        assert _compact(base.parent, "--chunk-steps", "24") is None
    opts = bucket_cont.parse_args(["2", "20", "--base", str(base), "--device", "cpu",
                                   "--workdir", str(work), *argv])
    return bucket_cont.run(opts, small(_flag()))


# tool -> (call it with extra argv in a workdir, its chunked call's argv,
# the result keys that time the run, its record file)
CASES = {
    "validate": (lambda w, *a: validate.run(validate.parse_args(
        ["36", "--device", "cpu", "--workdir", str(w), *a]), small(validate.validate_config())),
        ("--chunk-steps", "20"), (), "tpu_validate_record.json"),
    "validate_dynamic": (lambda w, *a: validate_dynamic.run(validate_dynamic.parse_args(
        ["--device", "cpu", "--workdir", str(w), *a]), small(validate_dynamic.dynamic_config())),
        ("--chunk-steps", "44"), (), "tpu_dyn_validate_record.json"),
    "occlen_run": (lambda w, *a: occlen_run.run(occlen_run.parse_args(
        ["40", "--device", "cpu", "--workdir", str(w), *a]), small(_flag())),
        ("--chunk-steps", "24"), (), "occlen_s0_record.json"),
    "compact_ab": (_compact, ("--chunk-steps", "20"), ("train_s", "ms_per_step"),
                   "compact_ab_x1_sphere_record.json"),
    "compact_ab_csg": (lambda w, *a: _compact(w, *a, scene="csg"), ("--chunk-steps", "20"),
                       ("train_s", "ms_per_step"), "compact_ab_x1_csg_record.json"),
    "bucket_cont": (_bucket_cont, ("--chunk-steps", "12"), (), "bucket_cont_b2_record.json"),
    "validate_csg_bucket": (lambda w, *a: validate_csg.run(validate_csg.parse_args(
        ["24", "--views", "4", "--eval-views", "1", "--res", "24", "--bucket", "1",
         "--device", "cpu", "--workdir", str(w), *a]), small(validate_csg.csg_config())),
        ("--chunk-steps", "12"), (), "validate_csg_4+1v_24_parity_os2_b1_record.json"),
}


@pytest.mark.parametrize("tool", sorted(CASES))
def test_chunked_run_equals_a_straight_run(tiny, tmp_path, tool):
    """Paused once and resumed in a fresh Testbed from the tool's own
    files, the run ends where the straight one does, with the same result
    (bitwise; wall times aside)."""
    call, chunked_argv, timed, record = CASES[tool]
    straight = call(tmp_path / "straight")
    assert straight is not None
    paused = call(tmp_path / "chunked", *chunked_argv)
    assert paused is None or "sdf_err" not in paused  # occlen_run reports a paused run
    chunked = call(tmp_path / "chunked")
    if tool == "occlen_run":
        # The EMA restarts at the resume's first fetch (TPU tool, the same).
        resume = int(chunked_argv[1])
        for key in ("final_occ_ema", "rates"):
            straight.pop(key), chunked.pop(key)
        a, b = straight.pop("occ_hist"), chunked.pop("occ_hist")
        assert [r[0] for r in a] == [r[0] for r in b] == [16, 32]
        assert [r for r in a if r[0] <= resume] == [r for r in b if r[0] <= resume]
        assert [r[2:] for r in a] == [r[2:] for r in b]  # bucket, loss, the step's occ_len
    for key in timed:
        straight.pop(key), chunked.pop(key)
    assert chunked == straight
    rec = json.loads((tmp_path / "chunked" / record).read_text())
    assert len(rec["chunks"]) == 2 and all(c["losses_finite"] for c in rec["chunks"])
    if tool == "validate_csg_bucket":
        assert straight["steps"] == 24 and rec["bucket_history"] == []
