"""Convert the JAX package's training state, given as numpy arrays, into
the port's tensors and back.

Both packages keep the same tree layout (per-level table tuple,
``{"layers": [{"w": (in, out), "b"}]}`` MLPs, scalar ``variance``; Adam
``{"mu", "nu", "steps", "count"}``; the delta ``{"rotation6d",
"transition"}``, the accumulated transform ``{"rotation", "transition"}``
and the camera group ``{"rot6d", "trans", "exposure", "focal_ln", ...}``),
so conversion is a leaf-wise copy.  Counters that the port
keeps on the host (Adam ``count``, occupancy ``ema_step``, ``step``,
``frame_step``) become Python integers.  The way back fills a JAX state
given as a template (``like``), so this module needs none of the JAX
package's types.

``state_to_pathdict`` / ``state_from_pathdict`` carry a state to and from
the JAX package's native snapshot format (``pathdict-v1``): host arrays
keyed by the strings JAX's ``tree_util.keystr`` gives the JAX state's
leaves, so a snapshot either package writes loads into the other.
``legacy_leaves_to_pathdict`` keys the positional leaf list of a legacy
native snapshot (``jax_leaf_order``: JAX's flatten order) the same way.

``config_from_jax``, ``dataset_from_jax`` and ``cameras_from_jax`` carry
the configs (``compute_dtype`` mapped by its name, bfloat16 to
``torch.bfloat16``), a dataset and the cameras with every lens field;
``sdf_config_from_jax``, ``image_config_from_jax`` and
``image_params_from_jax`` the SDF and image modes' configs and the image
mode's parameters (the SDF mode's are field parameters: ``params_from_jax``).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any

import numpy as np
import torch

from neus2_tpu_torch.data.dataset import NerfDataset
from neus2_tpu_torch.engine.error_map import ErrorMapState, init_error_map
from neus2_tpu_torch.engine.image_mode import Image2DConfig
from neus2_tpu_torch.engine.occupancy import OccupancyGrid
from neus2_tpu_torch.engine.rays import Cameras
from neus2_tpu_torch.engine.sdf_mode import SdfFitConfig
from neus2_tpu_torch.engine.train import TrainConfig, TrainState, init_cam_params
from neus2_tpu_torch.models.delta import init_accumulated, init_delta
from neus2_tpu_torch.models.field import FieldConfig
from neus2_tpu_torch.ops.hashgrid import HashGridConfig
from neus2_tpu_torch.utils.optim import OptimConfig, plain_adam_init
from neus2_tpu_torch.utils.tree import tree_map

_PARAM_KEYS = ("hashgrid", "hashgrid_base", "sdf_mlp", "rgb_mlp", "variance")


_OPTIMIZER_PARTS = (".opt_state", ".delta_opt_state")


def _state_parts(state: TrainState) -> list[tuple[str, Any, bool]]:
    """(key prefix, subtree, whether its top level is attribute-style) of
    each part of the state, under the names JAX's ``tree_util.keystr``
    gives the JAX ``TrainState``'s leaves: dict keys as ``['k']``, list items as
    ``[i]``, NamedTuple fields as ``.f``.  The delta's and the camera
    group's Adam are each the first of the JAX package's (ScaleByAdamState,
    EmptyState) pair, so their fields sit under ``[0]``."""
    return [
        (".params", state.params, False),
        (".ema_params", state.ema_params, False),
        (".opt_state", state.opt_state, False),
        (".delta", state.delta, False),
        (".delta_opt_state[0]", state.delta_opt_state, True),
        (".acc", state.acc, False),
        (".cam", state.cam, False),
        (".cam_opt_state[0]", state.cam_opt_state, True),
        (".occupancy", state.occupancy._asdict(), True),
        (".error_map", state.error_map._asdict(), True),
        (".step", state.step, False),
        (".frame_step", state.frame_step, False),
    ]


def _key(prefix: str, k, attr: bool) -> str:
    if isinstance(k, int):
        return f"{prefix}[{k}]"
    return f"{prefix}.{k}" if attr else f"{prefix}[{k!r}]"


def _walk(tree: Any, prefix: str, attr: bool = False):
    """(key, leaf) pairs; None leaves (an absent sharpness grid) have no key."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], _key(prefix, k, attr))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _walk(t, _key(prefix, i, attr))
    elif tree is not None:
        yield prefix, tree


def state_to_pathdict(state: TrainState, incremental: bool = False) -> dict[str, np.ndarray]:
    """The state's leaves as host arrays keyed by the JAX package's key
    strings (``.params['hashgrid'][3]``, ``.occupancy.density``, ...).
    Host counters become 0-d int32 arrays, as JAX leaves them; the step
    generator's state goes under ``.generator``, a key of the port's own
    (the JAX ``.key`` is a (2,) uint32 threefry key).  ``incremental``
    leaves out the field's and the delta's optimizer states; the camera
    group's Adam stays, as in the JAX package."""
    out = {}
    for prefix, tree, attr in _state_parts(state):
        if incremental and prefix.startswith(_OPTIMIZER_PARTS):
            continue
        for key, leaf in _walk(tree, prefix, attr):
            out[key] = (leaf.detach().cpu().numpy() if torch.is_tensor(leaf)
                        else np.array(leaf, np.int32))
    out[".generator"] = state.generator.get_state().numpy()
    return out


def _leaf_like(value, like, key: str):
    """A stored array as the template leaf's type, dtype, shape and device."""
    arr = np.asarray(value)
    if not torch.is_tensor(like):
        return int(arr)
    if arr.shape != tuple(like.shape):
        raise ValueError(f"snapshot leaf {key} has shape {arr.shape}, the state "
                         f"{tuple(like.shape)}")
    host = torch.from_numpy(arr.astype(torch.empty((), dtype=like.dtype).numpy().dtype))
    return host.to(like.device)


def _fill(tree: Any, prefix: str, flat: dict, missing: list, attr: bool = False) -> Any:
    if isinstance(tree, dict):
        return {k: _fill(v, _key(prefix, k, attr), flat, missing) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(t, _key(prefix, i, attr), flat, missing)
                          for i, t in enumerate(tree))
    if tree is None:
        return None
    if prefix not in flat:
        missing.append(prefix)
        return tree
    return _leaf_like(flat[prefix], tree, prefix)


def state_from_pathdict(flat: dict, like: TrainState,
                        incremental: bool = False) -> tuple[TrainState, list[str]]:
    """``like`` with every leaf that ``flat`` (keyed as
    ``state_to_pathdict`` keys) holds, each in ``like``'s dtype and on its
    device -> (state, the keys ``flat`` lacked, whose leaves keep ``like``'s
    values).  Keys ``like`` has no leaf for are ignored, as the JAX
    loader ignores them.  ``incremental`` keeps ``like``'s optimizer states.
    A generator state of another device type counts as missing."""
    missing: list[str] = []
    parts = {}
    for prefix, tree, attr in _state_parts(like):
        skip = incremental and prefix.startswith(_OPTIMIZER_PARTS)
        parts[prefix] = tree if skip else _fill(tree, prefix, flat, missing, attr)
    generator = like.generator
    stored = flat.get(".generator")
    if stored is not None and np.asarray(stored).size == generator.get_state().numel():
        generator = torch.Generator(device=generator.device)
        generator.set_state(torch.from_numpy(np.array(stored, np.uint8)))
    else:
        missing.append(".generator")
    state = TrainState(
        params=parts[".params"], ema_params=parts[".ema_params"],
        opt_state=parts[".opt_state"], delta=parts[".delta"],
        delta_opt_state=parts[".delta_opt_state[0]"], acc=parts[".acc"],
        cam=parts[".cam"], cam_opt_state=parts[".cam_opt_state[0]"],
        occupancy=OccupancyGrid(**parts[".occupancy"]),
        error_map=ErrorMapState(**parts[".error_map"]),
        step=parts[".step"], frame_step=parts[".frame_step"], generator=generator,
    )
    return state, missing


# The field order of each NamedTuple in the JAX ``TrainState``, by its key
# prefix: JAX flattens a NamedTuple in field order, where ``_walk`` sorts
# the dicts ``_state_parts`` makes of the occupancy and error-map states.
# The TrainState's (neus2_tpu/engine/train.py:175-188) ends with the
# threefry key, the one leaf the port has no counterpart of; the delta's
# and the camera group's Adam are (count, mu, nu) NamedTuples.
_JAX_FIELDS = {
    "": ("params", "ema_params", "opt_state", "delta", "delta_opt_state", "acc", "cam",
         "cam_opt_state", "occupancy", "error_map", "step", "frame_step", "key"),
    ".occupancy": ("density", "bitfield", "ema_step"),
    ".error_map": ("error_map", "cdf", "sharpness_grid"),
    ".delta_opt_state[0]": ("count", "mu", "nu"),
    ".cam_opt_state[0]": ("count", "mu", "nu"),
}
_KEY_PART = re.compile(r"\.(\w+)|\[(\d+)\]|\['([^']*)'\]")


def _jax_flatten_rank(key: str) -> tuple:
    """Where JAX's ``tree_util`` flattening puts the leaf of ``key``:
    NamedTuple fields in declaration order, sequence items by index, dict
    keys sorted."""
    rank, parent = [], ""
    for m in _KEY_PART.finditer(key):
        attr, index, name = m.groups()
        rank.append(_JAX_FIELDS[parent].index(attr) if attr is not None
                    else int(index) if index is not None else name)
        parent += m.group(0)
    return tuple(rank)


def jax_leaf_order(like: TrainState, incremental: bool = False) -> list[str]:
    """The keys of the leaves of the JAX state that ``like`` stands for, in
    JAX's flatten order, ending with the threefry key ``.key``: the order of a
    legacy native snapshot's positional list.  ``incremental`` leaves out
    the field's and the delta's optimizer states, as an incremental file
    does."""
    keys = [key for prefix, tree, attr in _state_parts(like)
            if not (incremental and prefix.startswith(_OPTIMIZER_PARTS))
            for key, _ in _walk(tree, prefix, attr)]
    return sorted(keys, key=_jax_flatten_rank) + [".key"]


def legacy_leaves_to_pathdict(leaves: list, like: TrainState,
                              incremental: bool = False) -> dict:
    """A legacy native snapshot's positional ``leaves`` (the JAX state's
    ``tree_util.tree_leaves``, from before path-keyed snapshots) keyed as
    ``state_to_pathdict`` keys them, ``like`` giving the structure; the
    threefry key, the last leaf, is dropped."""
    keys = jax_leaf_order(like, incremental)
    if len(leaves) != len(keys):
        raise ValueError(f"legacy snapshot holds {len(leaves)} leaves; this state has "
                         f"{len(keys)} (its JAX counterpart's, the threefry key included)")
    flat = dict(zip(keys, leaves))
    del flat[".key"]
    return flat


def tree_to_torch(tree: Any, device="cpu") -> Any:
    """numpy leaves -> tensors (tuples become lists)."""
    out = tree_map(lambda a: torch.as_tensor(np.array(a), device=device), tree)
    return _lists(out)


def tree_to_numpy(tree: Any) -> Any:
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _lists(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _lists(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_lists(v) for v in tree]
    return tree


def params_from_jax(params: dict, device="cpu") -> dict:
    """{"hashgrid": (T_l, F) per level, "sdf_mlp", "rgb_mlp", "variance"},
    and "hashgrid_base" with a residual grid."""
    return tree_to_torch({k: params[k] for k in _PARAM_KEYS if k in params}, device)


def params_to_jax(params: dict) -> dict:
    out = tree_to_numpy(params)
    for k in ("hashgrid", "hashgrid_base"):
        if k in out:
            out[k] = tuple(out[k])
    return out


def adam_from_jax(opt_state: dict, device="cpu") -> dict:
    return {
        "mu": params_from_jax(opt_state["mu"], device),
        "nu": params_from_jax(opt_state["nu"], device),
        "steps": params_from_jax(opt_state["steps"], device),
        "count": int(opt_state["count"]),
    }


def adam_to_jax(opt_state: dict) -> dict:
    return {
        "mu": params_to_jax(opt_state["mu"]),
        "nu": params_to_jax(opt_state["nu"]),
        "steps": params_to_jax(opt_state["steps"]),
        "count": np.int32(opt_state["count"]),
    }


def plain_adam_from_jax(opt_state, device="cpu") -> dict:
    """The delta's or the camera group's Adam, held in the JAX package as a
    (ScaleByAdamState, EmptyState) pair -> the port's ``{"mu", "nu",
    "count"}``."""
    s = opt_state[0]
    return {"mu": tree_to_torch(dict(s.mu), device), "nu": tree_to_torch(dict(s.nu), device),
            "count": int(s.count)}


def plain_adam_to_jax(opt_state: dict, like):
    """The port's delta or camera Adam as ``like``'s (ScaleByAdamState,
    ...) pair."""
    s = like[0]._replace(mu=tree_to_numpy(opt_state["mu"]), nu=tree_to_numpy(opt_state["nu"]),
                         count=np.int32(opt_state["count"]))
    return (s,) + tuple(like[1:])


def error_map_from_jax(em, device="cpu") -> ErrorMapState:
    """Any (error_map, cdf, sharpness_grid) triple -> ``ErrorMapState``."""
    grid = None if em.sharpness_grid is None else np.array(em.sharpness_grid)
    return ErrorMapState(*tree_to_torch([np.array(em.error_map), np.array(em.cdf)], device),
                         None if grid is None else torch.as_tensor(grid, device=device))


def error_map_to_jax(em: ErrorMapState, like):
    return like._replace(**{f: None if v is None else v.detach().cpu().numpy()
                            for f, v in zip(ErrorMapState._fields, em)})


def occupancy_from_jax(density, bitfield, ema_step, device="cpu") -> OccupancyGrid:
    return OccupancyGrid(
        density=torch.as_tensor(np.array(density), device=device),
        bitfield=torch.as_tensor(np.array(bitfield), device=device),
        ema_step=int(ema_step),
    )


def state_from_jax(params, ema_params, opt_state, occupancy, step, frame_step,
                   device="cpu", seed: int = 0, delta=None, delta_opt_state=None,
                   acc=None, error_map=None, cam=None, cam_opt_state=None) -> TrainState:
    """A port ``TrainState`` from the JAX state's parts (numpy trees;
    ``occupancy`` as a (density, bitfield, ema_step) triple).  The parts
    left as None start fresh (identity delta and accumulated transform, a
    1-image camera group at the identity, zero Adam, a 1-image 32^2 error
    map).  The JAX key has no torch counterpart: the step generator is
    seeded ``seed``."""
    delta = init_delta(device) if delta is None else tree_to_torch(dict(delta), device)
    cam = init_cam_params(1, device=device) if cam is None else tree_to_torch(dict(cam), device)
    return TrainState(
        params=params_from_jax(params, device),
        ema_params=params_from_jax(ema_params, device),
        opt_state=adam_from_jax(opt_state, device),
        delta=delta,
        delta_opt_state=(plain_adam_init(delta) if delta_opt_state is None
                         else plain_adam_from_jax(delta_opt_state, device)),
        acc=init_accumulated(device) if acc is None else tree_to_torch(dict(acc), device),
        cam=cam,
        cam_opt_state=(plain_adam_init(cam) if cam_opt_state is None
                       else plain_adam_from_jax(cam_opt_state, device)),
        occupancy=occupancy_from_jax(*occupancy, device=device),
        error_map=(init_error_map(1, device=device) if error_map is None
                   else error_map_from_jax(error_map, device)),
        step=int(step),
        frame_step=int(frame_step),
        generator=torch.Generator(device=device).manual_seed(seed),
    )


def train_state_from_jax(state, device="cpu", seed: int = 0) -> TrainState:
    """A port ``TrainState`` from a whole JAX ``TrainState`` (host copy:
    numpy leaves): the field, its Adam and EMA, the delta and its Adam, the
    accumulated transform, the camera group and its Adam, the occupancy
    grid and the error map."""
    occ = state.occupancy
    return state_from_jax(state.params, state.ema_params, state.opt_state,
                          (occ.density, occ.bitfield, occ.ema_step),
                          state.step, state.frame_step, device=device, seed=seed,
                          delta=state.delta, delta_opt_state=state.delta_opt_state,
                          acc=state.acc, error_map=state.error_map, cam=state.cam,
                          cam_opt_state=state.cam_opt_state)


def train_state_to_jax(state: TrainState, like):
    """The port's state as a JAX ``TrainState`` (numpy leaves) with
    ``like``'s structure; ``like``'s key is kept."""
    occ = state.occupancy
    return like._replace(
        params=params_to_jax(state.params),
        ema_params=params_to_jax(state.ema_params),
        opt_state=adam_to_jax(state.opt_state),
        delta=tree_to_numpy(state.delta),
        delta_opt_state=plain_adam_to_jax(state.delta_opt_state, like.delta_opt_state),
        acc=tree_to_numpy(state.acc),
        cam=tree_to_numpy(state.cam),
        cam_opt_state=plain_adam_to_jax(state.cam_opt_state, like.cam_opt_state),
        occupancy=like.occupancy._replace(density=occ.density.cpu().numpy(),
                                          bitfield=occ.bitfield.cpu().numpy(),
                                          ema_step=np.int32(occ.ema_step)),
        error_map=error_map_to_jax(state.error_map, like.error_map),
        step=np.int32(state.step),
        frame_step=np.int32(state.frame_step),
    )


_CONFIGS = {c.__name__: c for c in (TrainConfig, FieldConfig, HashGridConfig, OptimConfig)}


def config_from_jax(cfg):
    """The port's counterpart of a JAX ``TrainConfig`` / ``FieldConfig`` /
    ``HashGridConfig`` / ``OptimConfig``, field by field; ``compute_dtype``
    becomes the torch dtype of the same name (None stays None)."""
    cls = _CONFIGS[type(cfg).__name__]
    out = {}
    for f in dataclasses.fields(cls):
        v = getattr(cfg, f.name)
        if f.name == "compute_dtype" and v is not None:
            v = getattr(torch, np.dtype(v).name)
        elif dataclasses.is_dataclass(v):
            v = config_from_jax(v)
        out[f.name] = v
    return cls(**out)


def sdf_config_from_jax(cfg) -> SdfFitConfig:
    """The port's ``SdfFitConfig`` with a JAX one's fields."""
    return SdfFitConfig(**{f.name: config_from_jax(cfg.field) if f.name == "field"
                           else getattr(cfg, f.name) for f in dataclasses.fields(SdfFitConfig)})


def image_config_from_jax(cfg) -> Image2DConfig:
    """The port's ``Image2DConfig`` with a JAX one's fields."""
    return Image2DConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(Image2DConfig)})


def image_params_from_jax(params: dict, device="cpu") -> dict:
    """The image mode's {"tables": per-level (rows, F), "mlp"} (numpy
    leaves) as tensors; the table tuple becomes a list."""
    return tree_to_torch({"tables": params["tables"], "mlp": params["mlp"]}, device)


def dataset_from_jax(ds) -> NerfDataset:
    """A port ``NerfDataset`` with a JAX one's fields (its numpy arrays)."""
    return NerfDataset(**{f.name: getattr(ds, f.name) for f in dataclasses.fields(NerfDataset)})


def cameras_from_jax(cams, device="cpu") -> Cameras:
    """The port's ``Cameras`` from a JAX one (arrays or None a field)."""

    def conv(name, v):
        if v is None or name == "resolution":
            return v
        a = np.array(v)
        return torch.as_tensor(a, dtype=torch.int32 if a.dtype.kind in "iu" else torch.float32,
                               device=device)

    return Cameras(**{k: conv(k, getattr(cams, k)) for k in Cameras._fields})


_PHASE = ("current_training_time_frame", "train_canonical", "train_delta", "use_delta")


def testbed_from_jax(state, hyper, config, dataset, training_step: int = 0,
                     device="cpu", seed: int = 0, phase=None, datasets=None):
    """A port ``Testbed`` whose state is the JAX Testbed's: its
    ``TrainState`` (host copy), its ``Hyperparams`` (any object with the
    same fields) and the port's ``TrainConfig`` for it.  ``dataset`` (a port
    ``NerfDataset``) is the frame in training; a dynamic scene passes all
    its frames as ``datasets`` and the JAX Testbed itself as ``phase``,
    whose frame index and phase flags (train_canonical, train_delta,
    use_delta) are taken.  The dataset-derived config is applied as
    ``load_training_data`` would; no fresh state is drawn."""
    from neus2_tpu_torch.api.testbed import Hyperparams, Testbed

    hp = Hyperparams(**{f.name: getattr(hyper, f.name)
                        for f in dataclasses.fields(Hyperparams)})
    tb = Testbed(config=config, hyper=hp, seed=seed, device=device)
    tb._datasets = list(datasets) if datasets is not None else [dataset]
    tb.frame_jsons = [Path(f"<memory:{i}>") for i in range(len(tb._datasets))]
    if phase is not None:
        for name in _PHASE:
            setattr(tb, name, type(getattr(tb, name))(getattr(phase, name)))
    tb._load_frame(tb.current_training_time_frame)
    tb._derive_config()
    tb.state = train_state_from_jax(state, device=device, seed=seed)
    tb.training_step = int(training_step)
    return tb
