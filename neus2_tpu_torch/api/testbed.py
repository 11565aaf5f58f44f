"""The Testbed: load a static or dynamic scene, train, render, export a
mesh (port of ``neus2_tpu/api/testbed.py``; reference
src/python_api.cu:317-616, Testbed::frame / train / training_network_
next_frame, src/testbed.cu:1722, 2640-2712, 2001-2080).

A thin host-side layer over the port's functions: the state lives in a
``TrainState``; the host reads the step's scalars every 16 steps (the
reference's get_loss_scalar cadence), so the loop does not wait for the
card on every step.  A dynamic scene (one dataset a time frame) trains
frame 0's canonical field, then for each later frame refines the per-frame
rigid delta alone for ``predict_global_movement_training_step`` steps and
finetunes field and delta together; the phase flags (``train_canonical``,
``train_delta``, ``use_delta``) change only at those boundaries.

Snapshots: ``save_snapshot`` / ``load_snapshot`` write and read the JAX
package's native format (``pathdict-v1``, through the port's own msgpack
codec), so a file either package writes loads into the other;
``load_snapshot`` sends a reference-format file (a ``snapshot`` key) to
``load_reference_snapshot``.  The pyngp surface (reference python_api.cu:
317-616): the loss scalars, ``nerf`` / ``nerf.training``, the virtual
render camera and ``render(width, height, spp, linear)``, and the output
controls ``exposure`` and ``tonemap_curve``.  The learned camera group
(``TrainState.cam``) trains with the canonical field when the config turns
it on; renders use its envmap and distortion grid.  The dataset's
Brown-Conrady lens is carried into every render (FTheta, rolling shutter
and ray files are per-training-image and are not), a mixed-size view
renders at its true size, and ``image_dtype=torch.float16`` stores the
training texels in fp16.

Data-parallel training (``enable_multichip``): inside a process group (one
rank a card, ``parallel/distributed.py``) every rank holds the whole state
and trains its share of the batch through ``parallel/train.py``; with
``zero1`` each rank keeps the field's Adam state for its rows of the
shardable tables only.  Every decision the loop takes reads values that
are already reduced over the ranks, so the ranks issue their collectives
in one order.  Snapshots, meshes and transforms are written by rank 0
alone, and every rank waits for the write; a ZeRO-1 snapshot gathers the
optimizer state first, so the file is the one a single card writes.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from pathlib import Path

import numpy as np
import torch

from neus2_tpu_torch import interop
from neus2_tpu_torch.api import msgpack_codec, ngp_snapshot
from neus2_tpu_torch.api.compat import NerfView
from neus2_tpu_torch.constants import NERF_GRIDSIZE
from neus2_tpu_torch.data.dataset import (
    NerfDataset, list_frame_jsons, load_dataset, nerf_matrix_to_ngp,
)
from neus2_tpu_torch.engine import error_map as emap
from neus2_tpu_torch.engine import occupancy as occ
from neus2_tpu_torch.engine.render import RenderConfig, render_image
from neus2_tpu_torch.engine.train import (
    StepAux,
    TrainConfig,
    desired_batch_bucket,
    init_cam_params,
    init_error_map_for,
    init_train_state,
    occupancy_prior_sweep,
    occupancy_update,
    rebuild_error_cdf,
    should_update_occupancy,
    train_step,
)
from neus2_tpu_torch.models import delta as delta_mod
from neus2_tpu_torch.models.field import FieldConfig, freeze_grid_into_base, init_field
from neus2_tpu_torch.ops.hashgrid import HashGridConfig
from neus2_tpu_torch.ops.image import sharpen_images, sharpness_maps
from neus2_tpu_torch.parallel import distributed
from neus2_tpu_torch.parallel.train import (
    gather_opt_state,
    parallel_train_step,
    replicate_error_cdf,
    replicate_state,
    shard_opt_state,
    shard_state_zero1,
)
from neus2_tpu_torch.utils.device import resolve_device
from neus2_tpu_torch.utils.meters import Meters
from neus2_tpu_torch.utils.optim import OptimConfig, adam_init, plain_adam_init
from neus2_tpu_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass
class Hyperparams:
    """Scene hyperparameters (reference configs/nerf/base.json:121-134,
    defaults src/testbed.cu:2117-2139).  ``refine_coarse_to_fine`` runs pose
    refinement under the progressive unlock from the frame's first step
    (the reference's refinement sees every level, testbed.cu:2652-2657);
    ``delta_motion_prior`` starts each frame's delta at the previous
    frame's instead of the identity.  Both are the JAX package's, not the
    reference's."""

    first_frame_max_training_step: int = 2000
    next_frame_max_training_step: int = 2000
    predict_global_movement: bool = True
    predict_global_movement_training_step: int = 50
    finetune_global_movement: bool = True
    refine_coarse_to_fine: bool = True
    mask_loss_weight: float = 0.0
    ek_loss_weight: float = 0.1
    reset_density_grid_after_global_movement: bool = True
    incremental_reinit_sdf_mlp: bool = False
    incremental_reinit_sdf_mlp_iters: int = 10
    anneal_end: int = 0
    delta_motion_prior: bool = False


def _read_json(path: Path) -> dict:
    # The reference's parser allows // comments.
    with open(path) as f:
        return json.loads("\n".join(l.split("//")[0] for l in f.read().splitlines()))


def config_from_json(path: str | Path) -> tuple[TrainConfig, Hyperparams]:
    """Build (TrainConfig, Hyperparams) from a reference-style network
    config, following ``parent`` inheritance (reference load_network_config,
    src/testbed.cu:139-162)."""
    path = Path(path)
    cfg = _read_json(path)
    while "parent" in cfg:
        parent = _read_json(path.parent / cfg.pop("parent"))
        parent.update(cfg)
        cfg = parent

    enc = cfg.get("encoding", {})
    n_levels = int(enc.get("n_levels", 14))
    base_res = int(enc.get("base_resolution", 16))
    top_res = int(enc.get("top_resolution", 2048))
    grid = HashGridConfig(
        n_levels=n_levels,
        n_features_per_level=int(enc.get("n_features_per_level", 2)),
        log2_hashmap_size=int(enc.get("log2_hashmap_size", 19)),
        base_resolution=base_res,
        per_level_scale=enc.get(
            "per_level_scale",
            HashGridConfig.per_level_scale_from_top(base_res, top_res, n_levels),
        ),
        valid_level_scale=float(enc.get("valid_level_scale", 0.02)),
        base_valid_level_scale=float(enc.get("base_valid_level_scale", 0.2)),
        base_training_step=int(enc.get("base_training_step", 100)),
    )
    net = cfg.get("network", {})
    rgb_net = cfg.get("rgb_network", {})
    field = FieldConfig(
        grid=grid,
        sdf_hidden_dim=int(net.get("n_neurons", 64)),
        sdf_n_hidden=int(net.get("n_hidden_layers", 1)),
        rgb_hidden_dim=int(rgb_net.get("n_neurons", 64)),
        rgb_n_hidden=int(rgb_net.get("n_hidden_layers", 2)),
        # Not a reference key: the geometric init's sphere radius in the
        # warp frame.  A scene of several cascades wants it below the
        # default, or the init's sphere reaches past its objects.
        init_radius=float(net.get("init_radius", FieldConfig.init_radius)),
    )
    hp = cfg.get("hyperparams", {})
    hyper = Hyperparams(
        first_frame_max_training_step=int(hp.get("first_frame_max_training_step", 2000)),
        next_frame_max_training_step=int(hp.get("next_frame_max_training_step", 2000)),
        predict_global_movement=bool(hp.get("predict_global_movement", False)),
        predict_global_movement_training_step=int(
            hp.get("predict_global_movement_training_step", 50)
        ),
        # Unspecified keys default as the reference's json parsing does
        # (testbed.cu:2123-2131): finetune and grid reset default TRUE.
        finetune_global_movement=bool(hp.get("finetune_global_movement", True)),
        mask_loss_weight=float(hp.get("mask_loss_weight", 0.0)),
        ek_loss_weight=float(hp.get("ek_loss_weight", 0.1)),
        reset_density_grid_after_global_movement=bool(
            hp.get("reset_density_grid_after_global_movement", True)
        ),
        incremental_reinit_sdf_mlp=bool(hp.get("incremental_reinit_sdf_mlp", False)),
        incremental_reinit_sdf_mlp_iters=int(hp.get("incremental_reinit_sdf_mlp_iters", 10)),
        anneal_end=int(hp.get("m_anneal_end", 0)),
    )
    ema_decay = 0.95
    decay_start, decay_interval, decay_base = 20000, 10000, 0.33
    leaf = cfg.get("optimizer", {})
    while True:  # the Ema(ExponentialDecay(Adam)) nesting
        otype = str(leaf.get("otype", "")).lower()
        if otype == "ema":
            ema_decay = float(leaf.get("decay", ema_decay))
        elif otype == "exponentialdecay":
            decay_start = int(leaf.get("decay_start", decay_start))
            decay_interval = int(leaf.get("decay_interval", decay_interval))
            decay_base = float(leaf.get("decay_base", decay_base))
        if "nested" not in leaf:
            break
        leaf = leaf["nested"]
    # The delta transform's optimizer (base.json "globalmove").
    gm_leaf = cfg.get("globalmove", {}).get("optimizer", {})
    while "nested" in gm_leaf:
        gm_leaf = gm_leaf["nested"]
    optim = OptimConfig(
        learning_rate=float(leaf.get("learning_rate", 1e-3)),
        after_learning_rate=float(leaf.get("after_learning_rate",
                                           leaf.get("learning_rate", 1e-3))),
        beta1=float(leaf.get("beta1", 0.9)),
        beta2=float(leaf.get("beta2", 0.99)),
        epsilon=float(leaf.get("epsilon", 1e-15)),
        l2_reg=float(leaf.get("l2_reg", 1e-6)),
        components=tuple(
            sorted(
                (str(k), bool(v))
                for k, v in leaf.get("optimize_params_components", {}).items()
            )
        ),
        adabound=bool(leaf.get("adabound", False)),
        non_matrix_lr_factor=float(leaf.get("non_matrix_learning_rate_factor", 1.0)),
        ema_decay=ema_decay,
        decay_start=decay_start,
        decay_interval=decay_interval,
        decay_base=decay_base,
    )
    train_cfg = TrainConfig(
        field=field,
        optim=optim,
        rgb_loss_type=cfg.get("loss", {}).get("otype", "Huber"),
        ek_loss_weight=hyper.ek_loss_weight,
        mask_loss_weight=hyper.mask_loss_weight,
        anneal_end=hyper.anneal_end,
        ema_decay=ema_decay,
        delta_lr=float(gm_leaf.get("learning_rate", 1e-4)),
        distortion_res=tuple(
            int(v) for v in cfg.get("distortion_map", {}).get("resolution", (32, 32))),
    )
    return train_cfg, hyper


class Testbed:
    """NeuS2 training loop over static and dynamic scenes."""

    def __init__(self, config: TrainConfig | None = None, hyper: Hyperparams | None = None,
                 seed: int = 0, device="cuda", image_dtype: torch.dtype | None = None):
        self.device = resolve_device(device)
        # Device storage of the training texels (None = fp32); torch.float16
        # halves it at the reference's own texel precision (its images are
        # __half4), cast to fp32 right after the gather (rays_from_pixels).
        self.image_dtype = image_dtype
        self.config = config or TrainConfig()
        self.hyper = hyper or Hyperparams()
        self.seed = seed
        self.state = None
        # The data-parallel world (enable_multichip): None trains alone.
        self.parallel: distributed.ParallelContext | None = None
        self.zero1 = False
        self.dataset: NerfDataset | None = None
        self.images = None
        self.cameras = None
        self.depths = None  # (N, H, W) on the device, with the dataset's depth maps
        self._datasets: list[NerfDataset] | None = None
        self.frame_jsons: list[Path] = []
        self.current_training_time_frame = 0
        self.training_step = 0  # step within the current time frame
        self.train_canonical = True
        self.train_delta = False
        self.use_delta = False
        self.m_train = True
        self.loss_scalar = float("nan")
        self.ek_loss_scalar = float("nan")
        self.mask_loss_scalar = float("nan")
        self.last_aux: StepAux | None = None  # host copy, 16-step cadence
        # Adaptive (rays, samples) bucket (testbed_nerf.cu:3434-3435
        # analog): bucket b trains (n_rays << b) x (samples_per_ray >> b).
        self.batch_bucket = 0
        self._occ_len_ema = None
        self._bucket_votes = 0
        self._bucket_vote_target = None
        self.meters = Meters()
        # Called with (testbed, finished frame index) when a frame's step
        # budget is spent, before the switch to the next frame (per-frame
        # eval hook; reference run_dynamic.py:183-201).
        self.on_frame_complete = None
        # The pyngp namespaces (reference python_api.cu:416-487).
        self.nerf = NerfView(self)
        # Eval protocol: black background (reference m_background_color).
        self.background_color = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
        self.rendering_min_transmittance = 1e-4
        self._sharpen = 0.0
        # The virtual render camera (reference m_camera / fov /
        # screen_center): None renders through training view 0's camera.
        self._render_pose = None  # (3, 4) camera-to-world, ngp convention
        self._fov_deg = None  # ("xy", (fx, fy)) or ("iso", deg); None = dataset focal
        self.fov_axis = 1  # reference m_fov_axis default (y)
        self._screen_center = (0.5, 0.5)
        # Output controls of every shaded render (reference m_exposure /
        # m_tonemap_curve, render_buffer.cu:313-332).
        self.exposure = 0.0
        self.tonemap_curve = "Identity"
        # Renders through the dataset's lens and the learned distortion grid
        # (reference m_nerf.render_with_camera_distortion).
        self.render_with_camera_distortion = True
        # Display knobs the reference's scripts set; kept, nothing reads them.
        self.color_space = "sRGB"
        self.snap_to_pixel_centers = False

    # -- data ---------------------------------------------------------------

    def load_training_data(self, scene_path: str | Path, n_frames_cap=None):
        """A static scene (one transforms.json) or a dynamic one (a
        directory of per-frame jsons)."""
        self.frame_jsons = list_frame_jsons(scene_path)
        self._datasets = None
        self._finish_load(n_frames_cap)

    def load_training_data_from_datasets(self, datasets: list[NerfDataset]):
        """An in-memory scene, one dataset a time frame (synthetic scenes,
        tests)."""
        self._datasets = list(datasets)
        self.frame_jsons = [Path(f"<memory:{i}>") for i in range(len(datasets))]
        self._finish_load(None)

    def _finish_load(self, n_frames_cap):
        self._load_frame(0, n_frames_cap)
        self._derive_config()
        self._init_state()

    def _load_frame(self, idx: int, n_frames_cap=None):
        if self._datasets is not None:
            self.dataset = self._datasets[idx]
        else:
            self.dataset = load_dataset(self.frame_jsons[idx], n_frames_cap)
        self.cameras = self.dataset.cameras(self.device)
        self.depths = self.dataset.depths_device(self.device)
        if self.config.include_sharpness_in_error:
            # Load-time sharpness grids (reference compute_sharpness,
            # nerf_loader.cu:129-178).
            sharp = torch.as_tensor(sharpness_maps(self.dataset.images), device=self.device)
            self.cameras = self.cameras._replace(sharpness=sharp)
        self._refresh_images()

    def _refresh_images(self):
        """The device images from the dataset's host copy, through the
        unsharp filter when ``nerf.sharpen`` is set (reference
        nerf_loader.cu:808-825)."""
        if self.dataset is None:
            return
        imgs = self.dataset.images
        if self._sharpen > 0.0:
            imgs = sharpen_images(np.asarray(imgs, np.float32), self._sharpen)
        self.images = torch.as_tensor(imgs, dtype=self.image_dtype or torch.float32,
                                      device=self.device)

    def _derive_config(self):
        """Dataset-dependent config: the scene box, occupancy cascades,
        marching candidates and the occupancy probe budget."""
        cfg = self.config
        if self.dataset.aabb_scale != cfg.aabb_scale:
            cfg = dataclasses.replace(cfg, aabb_scale=self.dataset.aabb_scale)
        # Cascade k covers the box of side 2^k: a scale-S scene needs
        # 1 + ceil(log2 S) grids (reference max_cascade, testbed_nerf.cu:3293).
        want = min(1 + max(0, math.ceil(math.log2(max(1, cfg.aabb_scale)))), 8)
        if want > cfg.occ_cascades:
            cfg = dataclasses.replace(cfg, occ_cascades=want)
        # Exponential candidate spacing must stay near the cell size: a
        # scale-S scene needs ~log2(S) more intervals.
        if cfg.aabb_scale > 1:
            cand = min(512, cfg.n_candidates * (1 + math.ceil(math.log2(cfg.aabb_scale))))
            if cand > cfg.n_candidates:
                cfg = dataclasses.replace(cfg, n_candidates=cand)
        # The probe budget finishes one full sweep of the grid within the
        # first 256 updates (the reference probes every cell for its first
        # 256 steps, testbed_nerf.cu:4003-4016).
        n_cells = cfg.occ_cascades * NERF_GRIDSIZE**3
        need = 1 << max(0, (n_cells // 256 - 1)).bit_length()
        if need > cfg.occ_n_probe:
            cfg = dataclasses.replace(cfg, occ_n_probe=need)
        # The error map's resolution from the first window's sample budget
        # (testbed_nerf.cu:3479-3482), fixed at load.
        if cfg.use_error_map:
            res = emap.resolution_for(cfg.n_rays, self.dataset.n_images,
                                      min(self.dataset.resolution))
            if res != cfg.error_map_res:
                cfg = dataclasses.replace(cfg, error_map_res=res)
        # A dataset envmap turns the learned envmap on at its resolution
        # (reference nerf_loader.cu:498-511 and its m_envmap trainer).
        if self.dataset.envmap is not None:
            cfg = dataclasses.replace(cfg, use_envmap=True,
                                      envmap_res=tuple(self.dataset.envmap.shape[:2]))
        self.config = cfg

    def _init_state(self):
        """Fresh state, with the learned envmap seeded from the dataset's,
        then the step-0 whole-grid probe sweep."""
        self.state = init_train_state(self.config, self.dataset.n_images, seed=self.seed,
                                      device=self.device)
        if self.dataset.envmap is not None:
            cam = dict(self.state.cam)
            cam["envmap"] = torch.as_tensor(self.dataset.envmap, dtype=torch.float32,
                                            device=self.device)
            self.state = self.state._replace(cam=cam)
        self.state = occupancy_prior_sweep(self.state, self.config)
        self._place_state()

    # -- data parallel --------------------------------------------------------

    def enable_multichip(self, world: int | None = None, zero1: bool = False) -> int:
        """Train data-parallel over the ranks of the process group
        (``parallel/distributed.py``: ``initialize`` or ``launch``) -> the
        world size in use.

        ``config.n_rays`` stays the global batch; each rank draws
        ``n_rays // world`` of it.  ``zero1`` also shards the table
        gradients' reduction and the field's Adam state over the ranks.
        Without a process group the world is this process alone (1), as
        the JAX package's is with one device; ``world``, when given, must
        be the group's size."""
        if not torch.distributed.is_initialized():
            if world not in (None, 1):
                raise RuntimeError(f"a world of {world} needs a process group: start the "
                                   "ranks with torchrun or parallel.distributed.launch")
            self.parallel, self.zero1 = None, False
            return 1
        ctx = distributed.context(self.device)
        if world is not None and world != ctx.world:
            raise ValueError(f"world {world} asked for; the process group has {ctx.world}")
        self.parallel, self.zero1 = ctx, bool(zero1)
        self._place_state()
        return ctx.world

    @property
    def world(self) -> int:
        return 1 if self.parallel is None else self.parallel.world

    def _place_state(self):
        """Rank 0's state on every rank, with the field's Adam state cut to
        this rank's rows under ZeRO-1."""
        if self.parallel is None or self.state is None:
            return
        place = shard_state_zero1 if self.zero1 else replicate_state
        self.state = place(self.state, self.parallel)

    def _on_primary(self, write):
        """``write()`` on the primary process alone (its result, None
        elsewhere), then every rank of a data-parallel run waits for it."""
        out = write() if distributed.is_primary() else None
        if self.parallel is not None:
            distributed.barrier()
        return out

    # -- scalars --------------------------------------------------------------

    @property
    def shall_train(self) -> bool:
        return self.m_train

    @shall_train.setter
    def shall_train(self, v: bool):
        self.m_train = bool(v)

    @property
    def loss(self) -> float:
        return self.loss_scalar

    @property
    def ek_loss(self) -> float:
        return self.ek_loss_scalar

    @property
    def mask_loss(self) -> float:
        return self.mask_loss_scalar

    @property
    def n_params(self) -> int:
        """Trainable parameter count (reference python_api n_params)."""
        return sum(t.numel() for t in tree_leaves(self.state.params))

    @property
    def n_encoding_params(self) -> int:
        """Hash-table parameter count (reference n_encoding_params)."""
        return sum(t.numel() for k, v in self.state.params.items() if k.startswith("hashgrid")
                   for t in tree_leaves(v))

    @property
    def first_frame_max_training_step(self) -> int:
        return self.hyper.first_frame_max_training_step

    @first_frame_max_training_step.setter
    def first_frame_max_training_step(self, v: int):
        self.hyper.first_frame_max_training_step = int(v)

    @property
    def next_frame_max_training_step(self) -> int:
        return self.hyper.next_frame_max_training_step

    @next_frame_max_training_step.setter
    def next_frame_max_training_step(self, v: int):
        self.hyper.next_frame_max_training_step = int(v)

    @property
    def all_training_time_frame(self) -> int:
        return len(self.frame_jsons)

    @property
    def is_dynamic(self) -> bool:
        return len(self.frame_jsons) > 1

    # -- training loop ------------------------------------------------------

    def _max_steps_this_frame(self) -> int:
        if self.current_training_time_frame == 0:
            return self.hyper.first_frame_max_training_step
        return self.hyper.next_frame_max_training_step

    def frame(self) -> bool:
        """One training step and the frame bookkeeping (reference
        Testbed::frame, testbed.cu:1722-1766).  When the frame's step budget
        is spent, ``on_frame_complete`` runs and a dynamic scene moves to
        its next frame; returns False once the last frame is done."""
        if not self.m_train or self.state is None:
            return False
        if self.training_step >= self._max_steps_this_frame():
            if self.on_frame_complete is not None:
                self.on_frame_complete(self, self.current_training_time_frame)
            if not self.training_network_next_frame():
                return False
        self.train()
        return True

    def train(self):
        """One optimization step (reference Testbed::train, testbed.cu:2640)."""
        state = self.state
        # The step's config is taken before the phase switch below, so the
        # first finetune step still runs on the refinement batch.
        cfg = self._frame_config()
        if (self.current_training_time_frame >= 1
                and self.training_step == self.hyper.predict_global_movement_training_step):
            # Pose refinement ends (testbed.cu:2659-2667): the canonical field
            # trains again, and the occupancy grid the scene moved under
            # starts over.
            self.train_canonical = True
            if not self.hyper.finetune_global_movement:
                self.train_delta = False
            if self.hyper.reset_density_grid_after_global_movement:
                state = state._replace(occupancy=occ.reset_density(state.occupancy))
        with self.meters.scope("training_prep"):
            if should_update_occupancy(self.training_step):
                state = occupancy_update(state, cfg)
            if cfg.use_error_map and emap.should_rebuild(self.training_step):
                state = rebuild_error_cdf(state)
                if self.parallel is not None:
                    state = replicate_error_cdf(state, self.parallel)
        depths = self.depths if cfg.depth_supervision_lambda > 0.0 else None
        with self.meters.scope("training"):
            if self.parallel is None:
                state, aux = train_step(
                    state, self.images, self.cameras, cfg, train_canonical=self.train_canonical,
                    train_delta=self.train_delta, use_delta=self.use_delta, depths=depths)
            else:
                per_rank = dataclasses.replace(cfg, n_rays=max(1, cfg.n_rays // self.world))
                state, aux = parallel_train_step(
                    state, self.images, self.cameras, per_rank, self.parallel,
                    train_canonical=self.train_canonical, train_delta=self.train_delta,
                    use_delta=self.use_delta, depths=depths,
                    zero1=self.zero1 and self.train_canonical)
        self.state = state
        self.training_step += 1
        # 16-step fetch (reference get_loss_scalar, testbed.cu:2714), and on
        # the first step so the scalars never hold their NaN placeholder.
        if self.training_step % 16 == 0 or self.last_aux is None:
            host = torch.stack([t.to(torch.float32) for t in aux]).tolist()
            a = self.last_aux = StepAux(*host)
            self.loss_scalar = a.loss
            self.ek_loss_scalar = a.ek_loss
            self.mask_loss_scalar = a.mask_loss
            self._update_batch_bucket(a.mean_occ_len)
            # Zero-sample abort (reference train_nerf, testbed_nerf.cu:
            # 3542-3548): occupancy and cameras disagree entirely.
            if int(a.n_valid_samples) == 0:
                print("WARNING: training generated 0 samples; the scene geometry is "
                      "outside the occupancy grid or all rays miss the AABB. "
                      "Training aborted.", flush=True)
                self.m_train = False

    def _update_batch_bucket(self, occ_len: float):
        """Switch the adaptive bucket after 3 agreeing reads (hysteresis)."""
        if not self.config.adaptive_batch or not self.train_canonical:
            return
        if not (occ_len == occ_len) or occ_len <= 0.0:
            return
        ema = self._occ_len_ema
        self._occ_len_ema = occ_len if ema is None else 0.8 * ema + 0.2 * occ_len
        desired = desired_batch_bucket(self._occ_len_ema, self.config)
        if desired == self.batch_bucket:
            self._bucket_votes = 0
            return
        if desired != self._bucket_vote_target:
            self._bucket_vote_target = desired
            self._bucket_votes = 0
        self._bucket_votes += 1
        if self._bucket_votes >= 3:
            print(f"[neus2-torch] adaptive batch bucket {self.batch_bucket} -> {desired}: "
                  f"{self.config.n_rays << desired} rays x "
                  f"{self.config.samples_per_ray >> desired} samples "
                  f"(occ_len {self._occ_len_ema:.3f}, step {self.training_step})", flush=True)
            self.batch_bucket = desired
            self._bucket_votes = 0

    def _frame_config(self) -> TrainConfig:
        """The step's config: the adaptive bucket, the hyperparameter
        overrides and the dynamic phases' overrides applied."""
        cfg = self.config
        changes = {}
        if self.batch_bucket > 0 and self.train_canonical:
            changes["n_rays"] = cfg.n_rays << self.batch_bucket
            changes["samples_per_ray"] = cfg.samples_per_ray >> self.batch_bucket
        for name in ("anneal_end", "ek_loss_weight", "mask_loss_weight"):
            if getattr(self.hyper, name) != getattr(cfg, name):
                changes[name] = getattr(self.hyper, name)
        if self.train_delta and not self.train_canonical:
            # Pure pose refinement: a small batch (9 DoF), and no hit-ray
            # compaction, whose probe reads the occupancy of the stale pose
            # and so starves the rays that would pull the scene to where it
            # is now.
            changes["n_rays"] = min(cfg.n_rays, cfg.delta_n_rays)
            changes["hit_oversample"] = 1
        if (self.current_training_time_frame > 0 and self.hyper.predict_global_movement
                and not self.hyper.refine_coarse_to_fine):
            # The reference's refinement sees every level: the unlock runs on
            # the step past the refinement phase (testbed.cu:2652-2657).
            changes["valid_level_step_offset"] = self.hyper.predict_global_movement_training_step
        if (self.current_training_time_frame > 0
                and cfg.optim.after_learning_rate != cfg.optim.learning_rate):
            changes["optim"] = dataclasses.replace(
                cfg.optim, learning_rate=cfg.optim.after_learning_rate)
        return dataclasses.replace(cfg, **changes) if changes else cfg

    def training_network_next_frame(self) -> bool:
        """Move a dynamic scene to its next time frame (reference
        testbed.cu:2001-2080); False on the last frame.  The frame's delta
        is folded into the accumulated transform and starts again at the
        identity (or, with ``delta_motion_prior``, at its last value); the
        residual grid freezes into its base; the field's and the delta's
        Adam, the camera group with its Adam, and the error map start fresh;
        pose refinement comes first."""
        if self.current_training_time_frame >= self.all_training_time_frame - 1:
            return False
        self.current_training_time_frame += 1
        self._load_frame(self.current_training_time_frame)
        dev, state = self.device, self.state
        next_delta = (tree_map(torch.clone, state.delta) if self.hyper.delta_motion_prior
                      else delta_mod.init_delta(dev))
        state = state._replace(acc=delta_mod.accumulate_delta(state.acc, state.delta),
                               delta=next_delta)
        if self.config.field.residual_grid:
            state = state._replace(params=freeze_grid_into_base(state.params),
                                   ema_params=freeze_grid_into_base(state.ema_params))
        cam = init_cam_params(self.dataset.n_images, self.config, dev)
        state = state._replace(
            opt_state=adam_init(state.params),
            delta_opt_state=plain_adam_init(delta_mod.init_delta(dev)),
            cam=cam,
            cam_opt_state=plain_adam_init(cam),
            error_map=init_error_map_for(self.config, self.dataset.n_images, dev),
            frame_step=0,
        )
        if (self.hyper.incremental_reinit_sdf_mlp and self.current_training_time_frame
                % self.hyper.incremental_reinit_sdf_mlp_iters == 0):
            fresh = init_field(torch.Generator().manual_seed(1337), self.config.field, dev)
            params, ema = dict(state.params), dict(state.ema_params)
            params["sdf_mlp"] = fresh["sdf_mlp"]
            ema["sdf_mlp"] = tree_map(torch.clone, fresh["sdf_mlp"])
            state = state._replace(params=params, ema_params=ema)
        if self.zero1:
            state = state._replace(opt_state=shard_opt_state(state.opt_state, state.params,
                                                             self.parallel))
        self.state = state
        self.training_step = 0
        self.train_canonical = False
        self.train_delta = bool(self.hyper.predict_global_movement)
        self.use_delta = self.train_delta
        return True

    # -- rendering / eval ---------------------------------------------------

    def prepare_for_test(self):
        """Set the delta gate for test renders (testbed.cu:1987-1999): frames
        >= 1 of a scene with a learned delta render with it."""
        self.use_delta = (self.current_training_time_frame > 0
                          and bool(self.hyper.predict_global_movement))

    def change_to_frame(self, idx: int):
        """Make time frame ``idx`` the one rendered (reference
        change_to_frame)."""
        self.current_training_time_frame = int(idx)
        self._load_frame(int(idx))
        self.prepare_for_test()

    def reload_network_from_file(self, path: str | Path):
        """Rebuild the config from a network-config json and draw a fresh
        state, keeping the loaded training data (reference
        reload_network_from_file)."""
        self.config, self.hyper = config_from_json(path)
        if self.dataset is not None:
            self._derive_config()
            self._init_state()
            self.training_step = 0

    # -- the virtual render camera --------------------------------------------

    def set_nerf_camera_matrix(self, mat):
        """The render camera from a nerf-convention 3x4 (or 4x4) matrix, a
        row of a transforms.json (reference set_nerf_camera_matrix: the
        dataset's scale and offset applied)."""
        self._render_pose = nerf_matrix_to_ngp(
            np.asarray(mat, np.float32), self.dataset.scale,
            np.asarray(self.dataset.offset, np.float32), self.dataset.from_na)

    def set_camera_to_training_view(self, i: int):
        """Training view i's pose, field of view and principal point as the
        render camera (reference set_camera_to_training_view)."""
        i = int(i)
        self._render_pose = self.cameras.poses[i].cpu().numpy()
        # In float64, so that _focal_for gives the view's fp32 focal back to
        # the bit at the view's own size (the JAX package's fp32 arctan2
        # moves it by an ulp, which moves every ray).
        res = np.asarray(self._image_size(i), np.float64)
        f = self.cameras.focal[i].cpu().numpy().astype(np.float64)
        self._fov_deg = ("xy", tuple(float(v) for v in np.degrees(2.0 * np.arctan2(0.5 * res, f))))
        self._screen_center = tuple(float(v) for v in self.cameras.principal[i].cpu().numpy())

    @property
    def fov(self) -> float:
        """Field of view along ``fov_axis``, degrees (reference fov)."""
        return self.fov_xy[self.fov_axis]

    @fov.setter
    def fov(self, deg: float):
        # One focal length (square pixels) from the fov_axis side, as the
        # reference's relative focal length.
        self._fov_deg = ("iso", float(deg))

    @property
    def fov_xy(self) -> tuple:
        if self._fov_deg is not None and self._fov_deg[0] == "xy":
            return tuple(self._fov_deg[1])
        res = np.asarray(self.dataset.resolution, np.float32)
        if self._fov_deg is not None:
            f = 0.5 * res[self.fov_axis] / np.tan(np.radians(self._fov_deg[1]) / 2.0)
            focal = np.array([f, f], np.float32)
        else:
            focal = self.cameras.focal[0].cpu().numpy()
        return tuple(float(v) for v in np.degrees(2.0 * np.arctan2(0.5 * res, focal)))

    @fov_xy.setter
    def fov_xy(self, xy):
        self._fov_deg = ("xy", (float(xy[0]), float(xy[1])))

    @property
    def screen_center(self) -> tuple:
        return self._screen_center

    @screen_center.setter
    def screen_center(self, c):
        self._screen_center = (float(c[0]), float(c[1]))

    def _focal_for(self, resolution) -> np.ndarray:
        """The render camera's focal length in pixels at (W, H)."""
        W, H = resolution
        res = np.array([W, H], np.float32)
        if self._fov_deg is None:
            # View 0's field of view: its pixel focal scaled by the output /
            # dataset size ratio along fov_axis.
            base = self.cameras.focal[0].cpu().numpy()
            return base * (res[self.fov_axis] / float(self.dataset.resolution[self.fov_axis]))
        if self._fov_deg[0] == "iso":
            f = 0.5 * res[self.fov_axis] / np.tan(np.radians(self._fov_deg[1]) / 2.0)
            return np.array([f, f], np.float32)
        fx, fy = self._fov_deg[1]
        return np.array([0.5 * W / np.tan(np.radians(fx) / 2.0),
                         0.5 * H / np.tan(np.radians(fy) / 2.0)], np.float32)

    @property
    def effective_acc(self):
        """The rigid transform renders apply: the accumulated one, composed
        with the live per-frame delta while it is in use (it is folded into
        ``acc`` only at the next frame switch), as the training step
        applies the two."""
        if self.use_delta:
            return delta_mod.accumulate_delta(self.state.acc, self.state.delta)
        return self.state.acc

    def save_transform(self, path: str | Path):
        """Write the effective rigid transform as three rows ``R_i0 R_i1
        R_i2 t_i`` (reference save_transform, testbed.cu:3118-3141)."""
        acc = {k: v.detach().cpu().numpy() for k, v in self.effective_acc.items()}

        def write():
            with open(path, "w") as f:
                for i in range(3):
                    f.write(" ".join(f"{v:.8f}" for v in acc["rotation"][i])
                            + f" {acc['transition'][i]:.8f}\n")

        self._on_primary(write)

    def _image_size(self, i: int) -> tuple[int, int]:
        """Training view i's true (w, h)."""
        if self.dataset.sizes is not None:
            return tuple(int(v) for v in self.dataset.sizes[i])
        return self.dataset.resolution

    def render_cameras(self, cams=None):
        """``cams`` (default: the training cameras) with the lens stripped
        when ``render_with_camera_distortion`` is off (reference
        m_nerf.render_with_camera_distortion)."""
        cams = self.cameras if cams is None else cams
        if not self.render_with_camera_distortion and cams.distortion is not None:
            cams = cams._replace(distortion=None)
        return cams

    def _render_extras(self) -> dict:
        """The learned extras of every render: the envmap behind the rays,
        the distortion grid on ray generation (unless
        ``render_with_camera_distortion`` is off), and the output controls
        (render_buffer.cu:313-332)."""
        cam = self.state.cam
        return {
            "envmap": cam["envmap"] if self.config.use_envmap else None,
            "distortion": (cam["distortion"] if self.config.use_distortion
                           and self.render_with_camera_distortion else None),
            "exposure": float(self.exposure),
            "tonemap": str(self.tonemap_curve),
        }

    def _default_render_cfg(self) -> RenderConfig:
        return RenderConfig(field=self.config.field, aabb_scale=self.config.aabb_scale,
                            min_transmittance=self.rendering_min_transmittance)

    def render(self, *args, img_idx: int | None = None, spp: int = 1, background=None,
               render_cfg: RenderConfig | None = None, use_ema: bool = True,
               linear: bool = False, mode: str = "shade"):
        """Two call forms, told apart by the number of positional arguments:

        * ``render(width, height[, spp[, linear]])``: the reference's pybind
          signature (python_api.cu:317): the current render camera at that
          size over ``background_color`` -> one (H, W, 4) RGBA array
          (``linear`` turns the sRGB colour back into linear radiance);
        * ``render(i)`` / ``render(img_idx=i, ...)``: training view ``i`` at
          its true size -> (rgb (H, W, 3), depth (H, W), alpha (H, W)).

        Both draw their jitter from a generator seeded 7."""
        if len(args) >= 2:
            return self._render_current_camera(
                int(args[0]), int(args[1]), spp=int(args[2]) if len(args) > 2 else spp,
                linear=bool(args[3]) if len(args) > 3 else linear, render_cfg=render_cfg,
                use_ema=use_ema, mode=mode)
        if args:
            img_idx = int(args[0])
        img_idx = 0 if img_idx is None else img_idx
        cfg = render_cfg or self._default_render_cfg()
        params = self.state.ema_params if use_ema else self.state.params
        bg = self.background_color[:3] if background is None else background
        cams = self.render_cameras()
        with self.meters.scope("render"):
            rgb, depth, alpha = render_image(
                params, self.effective_acc, self.state.occupancy, cams,
                cams.poses[img_idx], cams.focal[img_idx], cams.principal[img_idx],
                torch.Generator(device=self.device).manual_seed(7), cfg,
                background=bg, spp=spp, mode=mode, resolution=self._image_size(img_idx),
                **self._render_extras(),
            )
        if linear:
            from neus2_tpu_torch.ops.losses import srgb_to_linear

            rgb = srgb_to_linear(rgb)
        return rgb.cpu().numpy(), depth.cpu().numpy(), alpha.cpu().numpy()

    def _render_current_camera(self, width: int, height: int, spp: int = 1,
                               linear: bool = False, render_cfg: RenderConfig | None = None,
                               use_ema: bool = True, mode: str = "shade") -> np.ndarray:
        """The pyngp render: the current camera, RGBA out."""
        cfg = render_cfg or self._default_render_cfg()
        params = self.state.ema_params if use_ema else self.state.params
        cams = self.render_cameras()
        pose = (cams.poses[0] if self._render_pose is None
                else torch.as_tensor(self._render_pose, dtype=torch.float32, device=self.device))
        f32 = dict(dtype=torch.float32, device=self.device)
        with self.meters.scope("render"):
            rgb, _, alpha = render_image(
                params, self.effective_acc, self.state.occupancy, cams, pose,
                torch.as_tensor(self._focal_for((width, height)), **f32),
                torch.as_tensor(self._screen_center, **f32),
                torch.Generator(device=self.device).manual_seed(7), cfg,
                background=self.background_color[:3], spp=int(spp) or 1, mode=mode,
                resolution=(int(width), int(height)), **self._render_extras(),
            )
        if linear:
            from neus2_tpu_torch.ops.losses import srgb_to_linear

            rgb = srgb_to_linear(rgb)
        return torch.cat([rgb, alpha[..., None]], -1).cpu().numpy()

    def compute_and_save_marching_cubes_mesh(
        self, path: str | Path, resolution: int = 256, thresh: float = 0.0,
        with_colors: bool = True, keep_largest_component: bool = False,
        with_normals: bool = True, aabb=None,
    ):
        """Marching-cubes export of the EMA field (reference python_api.cu:
        382): OBJ or, by suffix, PLY with sRGB vertex colours; 1-ring vertex
        normals; vertices in the dataset's space.  ``aabb`` ((lo3), (hi3))
        crops where the grid is sampled; the field is always queried in the
        scene's warp frame.  Returns (verts, tris) in warped coordinates
        (None on a rank other than 0 of a data-parallel run)."""
        return self._on_primary(lambda: self._save_mesh(
            path, resolution, thresh, with_colors, keep_largest_component, with_normals, aabb))

    def _save_mesh(self, path, resolution, thresh, with_colors, keep_largest_component,
                   with_normals, aabb):
        from neus2_tpu_torch.engine.mesh import (
            extract_mesh, largest_component, save_mesh_obj, save_mesh_ply,
            vertex_colors, vertex_normals,
        )
        from neus2_tpu_torch.ops.warp import AABB, scene_aabb

        scene_box = scene_aabb(self.config.aabb_scale)
        crop = scene_box if aabb is None else AABB(tuple(map(float, aabb[0])),
                                                   tuple(map(float, aabb[1])))
        verts, tris = extract_mesh(self.state.ema_params, self.config.field,
                                   resolution=resolution, box=crop, aabb=scene_box,
                                   thresh=thresh)
        if keep_largest_component and len(verts):
            verts, tris = largest_component(verts, tris)
        path = Path(path)
        normals = vertex_normals(verts, tris) if (with_normals and len(verts)) else None
        if path.suffix == ".ply":
            colors = None
            if with_colors and len(verts):
                colors = vertex_colors(
                    self.state.ema_params, self.config.field,
                    torch.as_tensor(verts, device=self.device),
                    scene_box.lo, scene_box.diag,
                ).cpu().numpy()
            save_mesh_ply(path, verts, tris, scale=self.dataset.scale,
                          offset=self.dataset.offset, colors=colors, normals=normals)
        else:
            save_mesh_obj(path, verts, tris, scale=self.dataset.scale,
                          offset=self.dataset.offset, normals=normals)
        return verts, tris

    # -- snapshots --------------------------------------------------------------

    def save_snapshot(self, path: str | Path, incremental: bool = False):
        """Write the training state in the JAX package's native format
        (``pathdict-v1``; reference save_snapshot, testbed.cu:3144-3196).
        An incremental snapshot leaves out both optimizers' states, which
        each frame starts afresh (testbed.cu:3180).  The adaptive batch
        bucket is host state no snapshot holds, in either package.  The
        file is written beside ``path`` and then renamed over it, so a
        write cut short never leaves a broken resume point.  A data-parallel
        run writes from rank 0 (every rank calls this: under ZeRO-1 the
        optimizer state is gathered first)."""
        state = self.state
        if self.zero1 and not incremental:
            state = state._replace(opt_state=gather_opt_state(state.opt_state, state.params,
                                                              self.parallel))
        path = Path(path)
        tmp = path.with_name(path.name + ".tmp")

        def write():
            payload = {
                "leaves": interop.state_to_pathdict(state, incremental),
                "format": "pathdict-v1",
                "incremental": bool(incremental),
                "meta": {
                    "training_step": np.int32(self.training_step),
                    "frame": np.int32(self.current_training_time_frame),
                    "aabb_scale": np.int32(self.config.aabb_scale),
                },
            }
            tmp.write_bytes(msgpack_codec.packb(payload))
            os.replace(tmp, path)

        self._on_primary(write)

    def load_snapshot(self, path: str | Path):
        """Restore a native snapshot, from either package: every leaf the
        file holds, in this state's dtypes and on its device; a leaf it
        lacks keeps its current value (named once).  A legacy file (a
        positional list of the JAX state's leaves, no ``format``) is keyed
        by the JAX flatten order first.  A file without the
        step generator's state (one the JAX package wrote) reseeds the
        generator from the Testbed's seed.  The counters and the dynamic
        phase flags follow the file's meta block.  A data-parallel run loads
        it on every rank and places it as ``enable_multichip`` does."""
        payload = msgpack_codec.unpackb(Path(path).read_bytes())
        if isinstance(payload, dict) and "snapshot" in payload:
            return self.load_reference_snapshot(path)
        legacy = (isinstance(payload, dict) and "format" not in payload
                  and isinstance(payload.get("leaves"), list))
        if not legacy and (not isinstance(payload, dict)
                           or payload.get("format") != "pathdict-v1"):
            raise ValueError(f"{path}: neither a path-keyed ('pathdict-v1') nor a legacy "
                             "positional-list native snapshot")
        incremental = bool(payload.get("incremental", False))
        placed = self.state is not None
        like = self._state_or_fresh()
        if self.zero1 and placed:  # the whole optimizer state, as the file holds it
            like = like._replace(opt_state=gather_opt_state(like.opt_state, like.params,
                                                            self.parallel))
        stored = payload["leaves"]
        if legacy:
            stored = interop.legacy_leaves_to_pathdict(stored, like, incremental)
        state, missing = interop.state_from_pathdict(stored, like, incremental)
        if ".generator" in missing:
            missing.remove(".generator")
            state = state._replace(
                generator=torch.Generator(device=self.device).manual_seed(self.seed + 1))
            print(f"load_snapshot: {path} holds no step-generator state for "
                  f"{self.device.type}; seeded it from the Testbed's seed", flush=True)
        if missing:
            print(f"load_snapshot: {len(missing)} state fields absent from the snapshot "
                  f"kept at current values (e.g. {missing[:3]})", flush=True)
        self.state = state
        self._place_state()
        meta = payload.get("meta", {})
        self.training_step = int(meta.get("training_step", 0))
        self.current_training_time_frame = int(meta.get("frame", 0))
        self._restore_phase_flags()

    def load_reference_snapshot(self, path: str | Path):
        """Load a reference-format snapshot (``api/ngp_snapshot.py``): its
        params, the reference's EMA'd inference values (trainer.h:281-292),
        into both ``params`` and ``ema_params``; its Morton-decoded density
        grid into the occupancy state; its accumulated transform.  Adam
        starts fresh: the file holds none of the reference's."""
        out = ngp_snapshot.load_reference_snapshot(path, self.config.field)
        st = self._state_or_fresh()

        def like(t, r):
            return torch.tensor(np.asarray(r), dtype=t.dtype, device=t.device)

        params = tree_map(like, st.params, out["params"])
        changes = {"params": params, "ema_params": params, "opt_state": adam_init(params)}
        grid = out["density_grid"]
        if grid is not None:
            if grid.shape == tuple(st.occupancy.density.shape):
                changes["occupancy"] = occ.update_bitfield(
                    st.occupancy._replace(density=torch.as_tensor(grid, device=self.device)))
            else:
                print(f"load_reference_snapshot: density grid {grid.shape} does not match "
                      f"the configured occupancy {tuple(st.occupancy.density.shape)}; "
                      "keeping the current grid", flush=True)
        if out["acc"] is not None:
            changes["acc"] = tree_map(like, st.acc, out["acc"])
        self.state = st._replace(**changes)
        self._place_state()
        self.training_step = out["training_step"]
        self.loss_scalar = out["loss"]
        self._restore_phase_flags()

    def _state_or_fresh(self):
        """The state a snapshot is loaded into: the current one, or a fresh
        one for a Testbed that has loaded no scene."""
        if self.state is None:
            self.state = init_train_state(
                self.config, self.dataset.n_images if self.dataset else 1, seed=self.seed,
                device=self.device)
        return self.state

    def _restore_phase_flags(self):
        """Replay the dynamic phase machine from the restored counters: the
        phase flags are host state the frame index and step determine (the
        reference re-derives them in train(), testbed.cu:2659-2667).  A
        frame >= 1 of a dynamic scene also needs its own dataset."""
        frame = self.current_training_time_frame
        predict = bool(self.hyper.predict_global_movement)
        if frame == 0:
            self.train_canonical, self.train_delta, self.use_delta = True, False, False
            return
        in_refine = predict and self.training_step < self.hyper.predict_global_movement_training_step
        self.train_canonical = not in_refine
        self.train_delta = predict and (in_refine or bool(self.hyper.finetune_global_movement))
        self.use_delta = predict
        if self.dataset is not None and self.is_dynamic:
            self._load_frame(frame)
