"""The port's native snapshots: its msgpack codec against ``msgpack`` and
``flax.serialization``, the JAX package's key strings, snapshots crossing
between the two packages in both directions (full and incremental), and
the port's counterparts of tests/test_testbed.py's snapshot tests, with a
resume that continues bitwise where the uninterrupted run goes.

Tolerances: none.  A snapshot carries leaves as bytes, so every leaf
crosses exactly, in its template's dtype; the SDF check keeps
tests/test_testbed.py's rtol 1e-6 and holds exactly.
"""

import copy
import dataclasses
import math

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from neus2_tpu.api.testbed import Hyperparams as JHyperparams
from neus2_tpu.api.testbed import Testbed as JTestbed
from neus2_tpu.data.synthetic import make_moving_sphere_frames as jax_frames
from neus2_tpu.engine.train import TrainConfig as JTrainConfig
from neus2_tpu.models.field import FieldConfig as JFieldConfig
from neus2_tpu.ops.hashgrid import HashGridConfig as JGrid
from neus2_tpu_torch import interop
from neus2_tpu_torch.api import msgpack_codec
from neus2_tpu_torch.api import testbed as ttb
from neus2_tpu_torch.api.testbed import Hyperparams
from neus2_tpu_torch.data.synthetic import make_moving_sphere_frames, make_sphere_dataset
from neus2_tpu_torch.engine.train import TrainConfig
from neus2_tpu_torch.models.field import FieldConfig, sdf_fn
from neus2_tpu_torch.ops.hashgrid import HashGridConfig

torch.set_num_threads(2)

_GRID = dict(n_levels=4, log2_hashmap_size=12, base_resolution=16, per_level_scale=1.45)
_FIELD = dict(sdf_hidden_dim=16, rgb_hidden_dim=16, residual_grid=True)
_TRAIN = dict(n_rays=64, samples_per_ray=16, n_candidates=32, delta_n_rays=32,
              occ_n_probe=1 << 12, use_error_map=True, include_sharpness_in_error=True)
_HYPER = dict(first_frame_max_training_step=3, next_frame_max_training_step=10,
              predict_global_movement=True, predict_global_movement_training_step=6)
_FRAMES = dict(n_frames=2, translation_per_frame=(0.03, 0.0, 0.0), n_views=4, resolution=16)
# The JAX state's leaf the port has no counterpart of (the threefry key);
# the port has its own generator state instead.
_JAX_ONLY = (".key",)


@pytest.fixture(scope="module")
def port_base():
    """A loaded dynamic port Testbed; tests take deep copies, which are
    what a fresh construction gives (its step-0 probe sweep dominates)."""
    cfg = TrainConfig(field=FieldConfig(grid=HashGridConfig(**_GRID), **_FIELD), **_TRAIN)
    tb = ttb.Testbed(cfg, Hyperparams(**_HYPER), device="cpu")
    tb.load_training_data_from_datasets(make_moving_sphere_frames(**_FRAMES))
    return tb


@pytest.fixture(scope="module")
def jtb():
    cfg = JTrainConfig(field=JFieldConfig(grid=JGrid(**_GRID), **_FIELD), **_TRAIN)
    tb = JTestbed(config=cfg, hyper=JHyperparams(**_HYPER))
    tb.load_training_data_from_datasets(jax_frames(**_FRAMES))
    return tb


def jax_pathdict(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(state))
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in flat}


def port_pathdict(state) -> dict:
    out = interop.state_to_pathdict(state)
    del out[".generator"]
    return out


def assert_same_leaves(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- the codec ----------------------------------------------------------------

_DOC = {
    "nil": None, "t": True, "f": False,
    "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
             -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
    "floats": [0.0, 1.5, -2.25e300, math.inf],
    "str": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 70000, "é中"],
    "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
    "arrays": [list(range(15)), list(range(16)), list(range(70000)), (1, 2)],
    "map16": {str(i): i for i in range(16)},
    7: "an int key",
}


def test_codec_matches_msgpack():
    data = msgpack.packb(_DOC, use_bin_type=True)
    assert msgpack_codec.packb(_DOC) == data
    want = msgpack.unpackb(data, raw=False, strict_map_key=False)
    got = msgpack_codec.unpackb(data)
    assert got == want
    assert isinstance(got["bin"][1], bytes) and isinstance(got["str"][1], str)
    # float32, which msgpack-python writes only on request, reads back.
    assert msgpack_codec.unpackb(msgpack.packb(1.25, use_single_float=True)) == 1.25


def test_codec_matches_flax_both_ways():
    rng = np.random.default_rng(0)
    leaves = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.integers(0, 2, (2, 3)).astype(bool),
              "c": np.array(5, np.int32),
              "d": rng.normal(size=(5,)).astype(np.float16),
              "e": np.arange(3, dtype=np.uint8),
              "f": rng.normal(size=(4, 3)).astype(np.float32).T}
    tree = {"format": "pathdict-v1", "incremental": False, "leaves": leaves,
            "meta": {"frame": np.int32(3), "loss": np.float32(1.5)}}
    data = serialization.msgpack_serialize(tree)
    # flax sorts map keys, as ``tree`` is sorted: the bytes agree.
    assert msgpack_codec.packb(tree) == data
    for back in (msgpack_codec.unpackb(data),
                 serialization.msgpack_restore(msgpack_codec.packb(tree))):
        for k, v in leaves.items():
            assert back["leaves"][k].dtype == v.dtype and back["leaves"][k].shape == v.shape
            np.testing.assert_array_equal(back["leaves"][k], v)
        assert type(back["meta"]["frame"]) is np.int32 and back["meta"]["frame"] == 3
        assert type(back["meta"]["loss"]) is np.float32
        assert back["format"] == "pathdict-v1" and back["incremental"] is False


@pytest.mark.parametrize("data, match", [
    (msgpack.packb({"__msgpack_chunked_array__": True, "shape": {"0": 2}}), "chunked"),
    (msgpack.packb([1, 2]) + b"\x01", "extra data"),
    (msgpack.packb(b"abc")[:-1], "truncated"),
    (msgpack.packb(msgpack.ExtType(9, b"x")), "ext type 9"),
])
def test_codec_refuses_what_it_cannot_read(data, match):
    with pytest.raises(ValueError, match=match):
        msgpack_codec.unpackb(data)


# -- across the packages ------------------------------------------------------


def test_keys_are_the_jax_keystrs(jtb):
    want = {k for k in jax_pathdict(jtb.state) if not k.startswith(_JAX_ONLY)}
    state = interop.train_state_from_jax(jax.device_get(jtb.state))
    got = interop.state_to_pathdict(state)
    assert set(got) == want | {".generator"}
    assert len(want) > 100 and ".params['hashgrid_base'][3]" in want
    assert ".error_map.sharpness_grid" in want and ".delta_opt_state[0].count" in want
    assert got[".occupancy.bitfield"].dtype == bool
    assert got[".opt_state['steps']['hashgrid'][0]"].dtype == np.int32
    for k in (".step", ".frame_step", ".opt_state['count']", ".occupancy.ema_step"):
        assert got[k].shape == () and got[k].dtype == np.int32, k


def _perturbed(state, seed: int):
    """A host copy of a JAX state with every leaf redrawn from ``seed``."""
    rng = np.random.default_rng(seed)

    def draw(x):
        x = np.asarray(x)
        if x.dtype == bool:
            return rng.integers(0, 2, x.shape).astype(bool)
        if np.issubdtype(x.dtype, np.integer):
            return rng.integers(0, 1000, x.shape).astype(x.dtype)
        return rng.normal(size=x.shape).astype(x.dtype)

    return jax.tree_util.tree_map(draw, jax.device_get(state))


@pytest.mark.parametrize("incremental", [False, True])
def test_jax_snapshot_loads_into_port(jtb, port_base, tmp_path, capsys, incremental):
    jtb.state = _perturbed(jtb.state, seed=int(incremental))
    jtb.current_training_time_frame, jtb.training_step = 1, 3  # in pose refinement
    path = tmp_path / "jax.msgpack"
    jtb.save_snapshot(path, incremental=incremental)

    tb = copy.deepcopy(port_base)
    fresh_opt = port_pathdict(tb.state)
    capsys.readouterr()
    tb.load_snapshot(path)
    out = capsys.readouterr().out
    assert out.count("no step-generator state") == 1
    assert (tb.current_training_time_frame, tb.training_step) == (1, 3)
    assert (tb.train_canonical, tb.train_delta, tb.use_delta) == (False, True, True)
    np.testing.assert_array_equal(tb.images.numpy(), make_moving_sphere_frames(**_FRAMES)[1].images)
    want = port_pathdict(interop.train_state_from_jax(jtb.state))
    if incremental:  # the optimizers keep their fresh state
        want.update({k: v for k, v in fresh_opt.items()
                     if k.startswith((".opt_state", ".delta_opt_state"))})
    assert_same_leaves(port_pathdict(tb.state), want)
    seeded = torch.Generator().manual_seed(tb.seed + 1).get_state()
    assert torch.equal(tb.state.generator.get_state(), seeded)


@pytest.mark.parametrize("incremental", [False, True])
def test_port_snapshot_loads_into_jax(jtb, port_base, tmp_path, capsys, incremental):
    tb = copy.deepcopy(port_base)
    for _ in range(3):
        tb.train()
    path = tmp_path / "port.msgpack"
    tb.save_snapshot(path, incremental=incremental)
    before = jax_pathdict(jtb.state)
    capsys.readouterr()
    jtb.load_snapshot(path)
    assert "state fields absent" in capsys.readouterr().out  # .key
    assert (jtb.current_training_time_frame, jtb.training_step) == (0, 3)
    got = jax_pathdict(jtb.state)
    want = port_pathdict(tb.state)
    if incremental:
        want = {k: v for k, v in want.items() if not k.startswith((".opt_state",
                                                                    ".delta_opt_state"))}
        for k in got:
            if k.startswith((".opt_state", ".delta_opt_state")):
                np.testing.assert_array_equal(got[k], before[k], err_msg=k)
    assert_same_leaves({k: got[k] for k in want}, want)


# -- the port's own round trips ------------------------------------------------


def test_snapshot_roundtrip(port_base, tmp_path):
    """tests/test_testbed.py::test_snapshot_roundtrip on 3 frame-0 steps."""
    tb, tb2 = copy.deepcopy(port_base), copy.deepcopy(port_base)
    for _ in range(3):
        tb.frame()
    snap = tmp_path / "snap.msgpack"
    tb.save_snapshot(snap)
    assert not (tmp_path / "snap.msgpack.tmp").exists()
    tb2.load_snapshot(snap)
    x = torch.as_tensor(np.random.default_rng(0).uniform(0.3, 0.7, (32, 3)), dtype=torch.float32)
    s1 = sdf_fn(tb.state.ema_params, x, tb.config.field)[0]
    s2 = sdf_fn(tb2.state.ema_params, x, tb2.config.field)[0]
    np.testing.assert_allclose(s2.numpy(), s1.numpy(), rtol=1e-6)
    assert tb2.training_step == tb.training_step == 3
    assert_same_leaves(interop.state_to_pathdict(tb2.state), interop.state_to_pathdict(tb.state))


def test_snapshot_resume_restores_dynamic_phase(port_base, tmp_path):
    """tests/test_testbed.py::test_snapshot_resume_restores_dynamic_phase,
    on this file's dynamic Testbed (3 frame-0 steps, refinement to step 6)."""
    frames = make_moving_sphere_frames(**_FRAMES)

    def fresh():
        return copy.deepcopy(port_base)

    tb = fresh()
    for _ in range(3 + 3):  # into frame 1's refinement (local step 3 < 6)
        assert tb.frame()
    assert tb.current_training_time_frame == 1 and tb.training_step == 3
    assert not tb.train_canonical and tb.train_delta and tb.use_delta
    tb.save_snapshot(tmp_path / "refine.msgpack")
    for _ in range(5):  # past the boundary: canonical, finetune keeps the delta
        tb.frame()
    assert tb.training_step == 8 and tb.train_canonical and tb.train_delta
    tb.save_snapshot(tmp_path / "canon.msgpack")

    t1 = fresh()
    t1.load_snapshot(tmp_path / "refine.msgpack")
    assert t1.current_training_time_frame == 1 and t1.training_step == 3
    assert not t1.train_canonical and t1.train_delta and t1.use_delta
    np.testing.assert_allclose(t1.images.numpy(), frames[1].images, atol=1e-6)

    t2 = fresh()
    t2.load_snapshot(tmp_path / "canon.msgpack")
    assert t2.train_canonical and t2.train_delta and t2.use_delta
    t2.frame()
    assert t2.training_step == 9

    t3, tb0 = fresh(), fresh()
    for _ in range(2):
        tb0.frame()
    tb0.save_snapshot(tmp_path / "frame0.msgpack")
    t3.load_snapshot(tmp_path / "frame0.msgpack")
    assert t3.current_training_time_frame == 0
    assert t3.train_canonical and not t3.train_delta and not t3.use_delta


class _Losses:
    """Records each step's loss tensor, leaving the step as it is."""

    def __init__(self):
        self.values = []

    def train_step(self, *args, **kw):
        state, aux = _TRAIN_STEP(*args, **kw)
        self.values.append(aux.loss)
        return state, aux


_TRAIN_STEP = ttb.train_step


def test_resume_continues_bitwise(port_base, tmp_path, monkeypatch):
    """Save at step k, load into a fresh Testbed, train n more: every loss
    and every leaf equal to the uninterrupted run's (the batch bucket is
    host state no snapshot holds, so it is off)."""
    k, n = 4, 4

    def fresh():
        t = copy.deepcopy(port_base)
        t.config = dataclasses.replace(t.config, adaptive_batch=False)
        t.first_frame_max_training_step = k + n  # all in frame 0
        return t

    whole, parted = _Losses(), _Losses()
    monkeypatch.setattr(ttb, "train_step", whole.train_step)
    a = fresh()
    for _ in range(k + n):
        a.frame()
    monkeypatch.setattr(ttb, "train_step", parted.train_step)
    b = fresh()
    for _ in range(k):
        b.frame()
    b.save_snapshot(tmp_path / "k.msgpack")
    c = fresh()
    c.load_snapshot(tmp_path / "k.msgpack")
    for _ in range(n):
        c.frame()
    assert c.training_step == a.training_step == k + n
    assert len(whole.values) == len(parted.values) == k + n
    for i, (x, y) in enumerate(zip(whole.values, parted.values)):
        assert torch.equal(x, y), i
    assert_same_leaves(interop.state_to_pathdict(c.state), interop.state_to_pathdict(a.state))


def _legacy_file(path, state, incremental: bool, frame: int = 1, step: int = 3) -> list:
    """``state`` written as the JAX package wrote snapshots before they were
    path-keyed: its ``tree_util.tree_leaves`` as a list, no ``format``
    (an incremental file flattens a template without the field's and the
    delta's optimizer states) -> the leaves."""
    if incremental:
        state = state._replace(opt_state=(), delta_opt_state=())
    leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(jax.device_get(state))]
    path.write_bytes(serialization.msgpack_serialize({
        "leaves": leaves, "incremental": incremental,
        "meta": {"training_step": np.int32(step), "frame": np.int32(frame)}}))
    return leaves


@pytest.mark.parametrize("incremental", [False, True])
def test_legacy_positional_snapshot_loads_into_both(jtb, port_base, tmp_path, incremental):
    """A legacy positional-list snapshot written from a JAX state loads
    into the port with every leaf equal to the JAX package's own load of
    it: the port keys the list by the JAX flatten order (NamedTuple fields
    in declaration order, dicts sorted), which is not the pathdict's sorted
    order of the occupancy and error-map fields."""
    jtb.state = _perturbed(jtb.state, seed=2 + int(incremental))
    path = tmp_path / "legacy.msgpack"
    leaves = _legacy_file(path, jtb.state, incremental)
    tb = copy.deepcopy(port_base)
    fresh_opt = port_pathdict(tb.state)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jtb.state._replace(opt_state=(), delta_opt_state=()) if incremental else jtb.state)
    order = [jax.tree_util.keystr(p) for p, _ in flat]
    assert order[-1] == ".key" and len(order) == len(leaves)
    assert interop.jax_leaf_order(tb.state, incremental) == order
    assert list(interop.legacy_leaves_to_pathdict(leaves, tb.state, incremental)) == order[:-1]

    jax_before = jax_pathdict(jtb.state)
    jtb.load_snapshot(path)
    tb.load_snapshot(path)
    assert (tb.current_training_time_frame, tb.training_step) == (1, 3)
    assert (jtb.current_training_time_frame, jtb.training_step) == (1, 3)
    want = {k: v for k, v in jax_pathdict(jtb.state).items() if not k.startswith(_JAX_ONLY)}
    if incremental:  # each package keeps its own optimizer states
        for k in want:
            if k.startswith((".opt_state", ".delta_opt_state")):
                np.testing.assert_array_equal(want[k], jax_before[k], err_msg=k)
                want[k] = fresh_opt[k]
    assert_same_leaves(port_pathdict(tb.state), want)


def test_legacy_snapshot_of_a_leaf_too_few_is_refused(jtb, port_base, tmp_path):
    path = tmp_path / "short.msgpack"
    leaves = jax.tree_util.tree_leaves(jax.device_get(jtb.state))[:-1]
    path.write_bytes(serialization.msgpack_serialize({"leaves": [np.asarray(x) for x in leaves]}))
    tb = copy.deepcopy(port_base)
    n = len(leaves)
    with pytest.raises(ValueError, match=f"holds {n} leaves; this state has {n + 1}"):
        tb.load_snapshot(path)
