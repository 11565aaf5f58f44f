"""The port's data-parallel training (``neus2_tpu_torch/parallel``) on 4 gloo
ranks, held against ``neus2_tpu``'s ``parallel_train_step`` on a 4-device
CPU mesh (the grid of tests/test_parallel.py::_setup: 4 levels, 2^12 rows,
32-wide MLPs).

The ranks start once for the module (``distributed.launch`` of
``_torch_parallel_worker.run``); the JAX side runs here and hands them its
starting states and, for each step, every device's draws: the step key
folded with the device index, split as ``_forward_loss`` splits it
(``test_torch_train_step._forward_draws``).  Each rank's own start is
thrown away but rank 0's, so ``replicate_state`` must make them agree.

Tolerances, fp32 on the CPU: losses and aux rtol 1e-5 (a 4-way mean in
another order than XLA's ``pmean``); every leaf of the params and
EMA within 1e-4 of its reference max magnitude, hash tables on all but
0.5% of their entries and their params within one Adam step
(``test_torch_dynamic_step._close``); the Adam moments (the field's and
the delta's) within 1e-3 of their max, tables on all but 0.5% of their
entries: a gradient here is the mean of 4 devices' gradients, each held
to 1e-4 of its own max by the single-device tests, and where they differ
in sign the mean's max is smaller than theirs; Adam step counts and every
cross-rank comparison exactly; the error map within 1e-4
of its max and the sharpness grid on all but 0.5% of its cells (a hit
point within rounding of a cell face lands in either cell).  ZeRO-1 against
the replicated step: atol 5e-5 on every param, as
tests/test_parallel.py::test_zero1_matches_replicated allows.
"""

import dataclasses
import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker
from neus2_tpu.api.testbed import Testbed as JTestbed
from neus2_tpu.data.synthetic import make_sphere_dataset as jax_sphere
from neus2_tpu.engine import train as jt
from neus2_tpu.engine.train import TrainConfig as JTrainConfig
from neus2_tpu.models.field import FieldConfig as JFieldConfig
from neus2_tpu.ops.hashgrid import HashGridConfig as JGrid
from neus2_tpu.ops.image import sharpness_maps
from neus2_tpu.parallel import train as jpt
from neus2_tpu_torch import interop
from neus2_tpu_torch.api import testbed as ttb
from neus2_tpu_torch.data.synthetic import make_sphere_dataset
from neus2_tpu_torch.engine import train as tt
from neus2_tpu_torch.parallel import distributed
from neus2_tpu_torch.parallel import train as pt
from neus2_tpu_torch.utils.tree import tree_leaves
from test_torch_dynamic_step import _close, _same
from test_torch_train_step import _forward_draws

torch.set_num_threads(2)
N_DEV, N_VIEWS, RES, STEPS = 4, 6, 32, 3
GRID = dict(n_levels=4, log2_hashmap_size=12, base_resolution=8, per_level_scale=1.6)
DELTA_PHASE = dict(train_canonical=False, train_delta=True, use_delta=True)


def _jcfg(n_rays, **kw):
    return JTrainConfig(field=JFieldConfig(grid=JGrid(**GRID), sdf_hidden_dim=32,
                                           rgb_hidden_dim=32),
                        n_rays=n_rays, samples_per_ray=16, n_candidates=48,
                        occ_n_probe=1 << 13, mask_loss_weight=0.1, **kw)


def _jax_run(jcfg, tcfg, scene, mesh, host, phase, zero1, steps):
    """JAX's parallel steps from ``host`` (a state on the host) -> (the state
    before each step as the port's leaves, each step's per-device draws,
    JAX's aux a step, JAX's final state on the host)."""
    jimages, jcams = scene
    state = jax.tree_util.tree_map(jnp.asarray, host)
    state = (jpt.shard_state_zero1 if zero1 else jpt.replicate_state)(state, mesh)
    dcfg = tt.phase_config(tcfg, phase.get("train_canonical", True),
                           phase.get("train_delta", False))
    starts, draws, auxes = [], [], []
    for _ in range(steps):
        starts.append(interop.state_to_pathdict(
            interop.train_state_from_jax(jax.device_get(state))))
        _, k_step = jax.random.split(state.key)
        draws.append([_forward_draws(jax.random.fold_in(k_step, d), dcfg, N_VIEWS)
                      for d in range(N_DEV)])
        state, aux = jpt.parallel_train_step(state, jimages, jcams, jcfg, mesh, **phase,
                                             zero1=zero1)
        auxes.append([float(a) for a in jax.device_get(aux)])
    return starts, draws, auxes, jax.device_get(state)


def _port_state(leaves, tcfg):
    like = tt.init_train_state(tcfg, N_VIEWS, device="cpu")
    state, missing = interop.state_from_pathdict(leaves, like)
    assert not missing, missing
    return state


def _jax_side():
    """JAX's runs on a 4-device mesh -> (their aux and final states, the
    ranks' jobs, the port's config)."""
    mesh = jpt.make_mesh(jax.devices("cpu")[:N_DEV])
    ds = jax_sphere(n_views=N_VIEWS, resolution=RES)
    sharp = sharpness_maps(ds.images)
    scene = (ds.images_device(), ds.cameras()._replace(sharpness=jnp.asarray(sharp)))
    images, cams = make_sphere_dataset(N_VIEWS, RES).to_device("cpu")
    cams = cams._replace(sharpness=torch.from_numpy(np.asarray(sharp)))
    # The compaction and error-map case of test_parallel_compaction_step,
    # with the sharpness weighting on so its grid is MAX-combined.
    jcfg = _jcfg(32, hit_oversample=2, use_error_map=True, include_sharpness_in_error=True)
    tcfg = interop.config_from_jax(jcfg)
    # A fresh state after the prior sweep (the Testbed's start), so rays hit.
    host = jax.device_get(jt.occupancy_prior_sweep(
        jt.init_train_state(jax.random.PRNGKey(0), jcfg, N_VIEWS), jcfg))
    # The learned camera group (extrinsics and exposure) in the step.
    cam_cfg = dataclasses.replace(jcfg, optimize_extrinsics=True, optimize_exposure=True)
    jax_runs, jobs = {}, {}
    for name, phase, zero1, steps in (("rep", {}, False, STEPS), ("zero1", {}, True, STEPS),
                                      ("delta", DELTA_PHASE, False, 1), ("cam", {}, False, 1)):
        jc = cam_cfg if name == "cam" else jcfg
        tcfg = interop.config_from_jax(jc)
        starts, draws, auxes, final = _jax_run(jc, tcfg, scene, mesh, host, phase, zero1,
                                               steps)
        jax_runs[name] = (auxes, final)
        jobs[name] = dict(config=tcfg, images=images, cameras=cams, starts=starts, draws=draws,
                          phase=phase, zero1=zero1)
    return jax_runs, jobs, interop.config_from_jax(jcfg)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One 4-rank launch of every port scenario; the ranks run the Testbeds
    while this process runs JAX, then the steps JAX's draws drive."""
    tmp = tmp_path_factory.mktemp("parallel")
    jobs_path, snapshot = tmp / "jobs.pt", tmp / "zero1.msgpack"
    base = interop.config_from_jax(_jcfg(512))
    testbeds = {"static": base, "snapshot": str(snapshot),
                "dynamic": dataclasses.replace(base, n_rays=384, delta_n_rays=256)}
    ranks, failed = [], []

    def launch():
        try:
            ranks.extend(distributed.launch(_torch_parallel_worker.run, N_DEV, testbeds,
                                            str(jobs_path), device="cpu"))
        except Exception as e:  # re-raised below, in the test's thread
            failed.append(e)

    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # read by the ranks as they start
    launcher = threading.Thread(target=launch)
    launcher.start()
    jobs = None  # tells the ranks to stop if the JAX side fails
    try:
        jax_runs, jobs, tcfg = _jax_side()
    finally:
        torch.save(jobs, tmp / "jobs.tmp")
        os.replace(tmp / "jobs.tmp", jobs_path)
        launcher.join(timeout=900)
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    assert not launcher.is_alive(), "the ranks did not end"
    if failed:
        raise failed[0]
    return dict(tcfg=tcfg, jax=jax_runs, ranks=ranks, snapshot=snapshot, base=base)


def _check_aux(jaux, taux):
    for i, (step_j, step_t) in enumerate(zip(jaux, taux, strict=True)):
        np.testing.assert_allclose(step_t, step_j, rtol=1e-5, err_msg=f"step {i}: {jaux} {taux}")


def _close_moments(ref, got):
    """Adam moments: every leaf within 1e-3 of its reference max, a hash
    table on all but 0.5% of its entries."""
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    for (path, a), b in zip(flat, tree_leaves(got), strict=True):
        name, a, b = jax.tree_util.keystr(path), np.asarray(a), b.numpy()
        over = np.abs(b - a) > 1e-3 * max(np.abs(a).max(), 1e-12)
        assert over.mean() <= (0.005 if "hashgrid" in name else 0.0), name


def _check_field(jnew, tnew):
    _close(jnew.params, tnew.params, params=True)
    _close(jnew.ema_params, tnew.ema_params, params=True)
    for key in ("mu", "nu"):
        _close_moments(jnew.opt_state[key], tnew.opt_state[key])
    _same(jnew.opt_state["steps"], tnew.opt_state["steps"])
    assert tnew.opt_state["count"] == int(jnew.opt_state["count"])


def _check_error_map(jnew, tnew):
    ref, got = np.asarray(jnew.error_map.error_map), tnew.error_map.error_map.numpy()
    assert ref.sum() > 0
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    jg, tg = np.asarray(jnew.error_map.sharpness_grid), tnew.error_map.sharpness_grid.numpy()
    assert (tg > 0).any()
    assert (tg != jg).mean() <= 0.005


@pytest.mark.parametrize("name", ["rep", "zero1"])
def test_steps_match_jax(world, name):
    """3 steps, replicated and ZeRO-1, with hit_oversample 2, the error map
    and its sharpness weighting (the grid's MAX over the ranks), each from
    the JAX state before it (over free steps the trajectories part, as
    tests/test_torch_testbed_loop.py explains)."""
    jaux, jnew = world["jax"][name]
    rank0 = world["ranks"][0][name]
    _check_aux(jaux, rank0["aux"])
    tnew = _port_state(rank0["state"], world["tcfg"])
    assert (tnew.step, tnew.frame_step) == (int(jnew.step), int(jnew.frame_step)) == (3, 3)
    assert min(a[4] for a in rank0["aux"]) > 0  # n_valid_samples: the field trains
    _check_field(jnew, tnew)
    _check_error_map(jnew, tnew)


def test_delta_phase_matches_jax(world):
    """Pose refinement: the delta trains, the field does not."""
    jaux, jnew = world["jax"]["delta"]
    rank0 = world["ranks"][0]["delta"]
    _check_aux(jaux, rank0["aux"])
    tnew = _port_state(rank0["state"], world["tcfg"])
    assert float(np.abs(tnew.delta["transition"].numpy()).max()) > 0
    _close(jnew.delta, tnew.delta)
    for key in ("mu", "nu"):
        _close_moments(getattr(jnew.delta_opt_state[0], key), tnew.delta_opt_state[key])
    assert tnew.delta_opt_state["count"] == int(jnew.delta_opt_state[0].count) == 1
    _same(jnew.params, tnew.params)


def test_camera_group_step_matches_jax(world):
    """Extrinsic and exposure refinement in the data-parallel step: the
    camera group's gradients are averaged over the ranks with the field's."""
    jaux, jnew = world["jax"]["cam"]
    rank0 = world["ranks"][0]["cam"]
    _check_aux(jaux, rank0["aux"])
    tcfg = dataclasses.replace(world["tcfg"], optimize_extrinsics=True, optimize_exposure=True)
    tnew = _port_state(rank0["state"], tcfg)
    _check_field(jnew, tnew)
    _close(jnew.cam, tnew.cam)
    for key in ("mu", "nu"):
        _close_moments(getattr(jnew.cam_opt_state[0], key), tnew.cam_opt_state[key])
    assert float(np.abs(tnew.cam["trans"].numpy()).max()) > 0


@pytest.mark.parametrize("name", ["rep", "zero1", "delta", "cam"])
def test_replicas_stay_bitwise_equal(world, name):
    """Every rank ends with rank 0's state, bit for bit (the ZeRO-1 Adam
    state gathered from the shards)."""
    for part in ("state", "free_state"):
        ref = world["ranks"][0][name][part]
        for rank in world["ranks"][1:]:
            got = rank[name][part]
            assert got.keys() == ref.keys()
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for rank in world["ranks"][1:]:
        assert rank[name]["free_aux"] == world["ranks"][0][name]["free_aux"]


def test_zero1_matches_replicated_and_shards_the_tables(world):
    """3 free steps of each from one start (test_zero1_matches_replicated)."""
    rep = _port_state(world["ranks"][0]["rep"]["free_state"], world["tcfg"])
    z1 = _port_state(world["ranks"][0]["zero1"]["free_state"], world["tcfg"])
    np.testing.assert_allclose(world["ranks"][0]["zero1"]["free_aux"][-1][0],
                               world["ranks"][0]["rep"]["free_aux"][-1][0], rtol=1e-4)
    for a, b in zip(tree_leaves(rep.params), tree_leaves(z1.params), strict=True):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=5e-5)
    # 4 levels of 512 / 4,096 rows: each rank keeps a quarter of the Adam rows.
    rows = sum(t.shape[0] for t in rep.opt_state["mu"]["hashgrid"])
    assert world["ranks"][0]["rep"]["local_opt_rows"] == rows
    assert all(r["zero1"]["local_opt_rows"] * N_DEV == rows for r in world["ranks"])


@pytest.mark.parametrize("n", [4, 8, 6])
def test_table_spec_tree_at_base_json_matches_jax(n):
    """Which base.json tables ZeRO-1 row-shards: those whose rows the world
    divides.  All 14 (4,096 to 524,288 rows, multiples of 8) for 4 and 8
    ranks; for 6, the dense levels of 4,096 / 39,304 / 125,000 rows stay
    replicated (shapes only: nothing is built at this size)."""
    cfg, _ = ttb.config_from_json("configs/base.json")
    sizes = cfg.field.grid.level_tables()[3]
    shapes = {"hashgrid": [types.SimpleNamespace(shape=(s, 2)) for s in sizes],
              "sdf_mlp": {"layers": [{"w": types.SimpleNamespace(shape=(32, 64))}]},
              "variance": types.SimpleNamespace(shape=())}
    got = tree_leaves(pt.table_spec_tree(shapes, n))
    want = [s == jax.sharding.PartitionSpec("data")
            for s in jax.tree_util.tree_leaves(jpt.table_spec_tree(shapes, n))]
    assert got == want
    assert got[:len(sizes)] == [s % n == 0 for s in sizes]
    assert all(got[:len(sizes)]) == (n != 6) and not any(got[len(sizes):])


def test_single_process_initialize_is_a_noop():
    assert distributed.initialize(num_processes=1, device="cpu") is False
    assert distributed.initialize(device="cpu") is False  # no launcher environment
    assert not torch.distributed.is_initialized()
    assert distributed.is_primary()
    distributed.barrier()
    tb = ttb.Testbed(device="cpu")
    assert tb.enable_multichip() == 1 and tb.parallel is None
    with pytest.raises(RuntimeError, match="process group"):
        tb.enable_multichip(world=4)


def test_testbed_multichip_static_zero1(world):
    """Testbed.enable_multichip(zero1=True) on 4 ranks: the loss falls and
    every rank ends with the same state
    (test_parallel.py::test_testbed_multichip_static)."""
    static = [r["static"] for r in world["ranks"]]
    assert static[0]["world"] == N_DEV
    assert static[0]["steps"] == _torch_parallel_worker.STATIC_STEPS
    assert np.isfinite(static[0]["last"]) and static[0]["last"] < static[0]["first"]
    for s in static[1:]:
        assert s["last"] == static[0]["last"]
        for k, v in static[0]["state"].items():
            np.testing.assert_array_equal(s["state"][k], v, err_msg=k)


def test_testbed_multichip_dynamic(world):
    """Pose refinement and finetune on 4 ranks reach frame 1 alike."""
    dyn = [r["dynamic"] for r in world["ranks"]]
    assert dyn[0]["frame"] == 1 and np.isfinite(dyn[0]["last"])
    for d in dyn[1:]:
        assert d["last"] == dyn[0]["last"]
        for k in d["delta"]:
            np.testing.assert_array_equal(d["delta"][k], dyn[0]["delta"][k])


def test_zero1_snapshot_reads_back_whole(world):
    """A ZeRO-1 Testbed's snapshot holds the whole Adam state (the file a
    single card writes): a single-process port Testbed and the JAX Testbed
    read it."""
    snap = world["ranks"][0]["static"]
    rows = world["base"].field.grid.level_tables()[3]
    assert snap["local_rows"] == [r // N_DEV for r in rows]
    tb = ttb.Testbed(world["base"], device="cpu")
    tb.load_training_data_from_datasets([make_sphere_dataset(n_views=N_VIEWS, resolution=RES)])
    tb.load_snapshot(world["snapshot"])
    assert tb.training_step == _torch_parallel_worker.STATIC_STEPS
    back = interop.state_to_pathdict(tb.state)
    for k, v in snap["state"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    jtb = JTestbed(config=_jcfg(512))
    jtb.load_training_data_from_datasets([jax_sphere(n_views=N_VIEWS, resolution=RES)])
    jtb.load_snapshot(str(world["snapshot"]))
    for (path, a) in jax.tree_util.tree_flatten_with_path(jtb.state.opt_state["mu"])[0]:
        key = ".opt_state['mu']" + jax.tree_util.keystr(path)
        np.testing.assert_array_equal(np.asarray(a), snap["state"][key], err_msg=key)
    assert int(jtb.training_step) == _torch_parallel_worker.STATIC_STEPS
