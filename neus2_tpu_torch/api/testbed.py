"""The static Testbed: load a scene, train, render, export a mesh (port of
the static path of ``neus2_tpu/api/testbed.py``; reference
src/python_api.cu:317-616 and Testbed::frame / train, src/testbed.cu:1722,
2640).

A thin host-side layer over the port's functions: the state lives in a
``TrainState``; the host reads the step's scalars every 16 steps (the
reference's get_loss_scalar cadence), so the loop does not wait for the
card on every step.  Dynamic scenes, snapshots, the error map, envmap,
multi-GPU and the pyngp camera surface are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import torch

from neus2_tpu_torch.constants import NERF_GRIDSIZE
from neus2_tpu_torch.data.dataset import NerfDataset, list_frame_jsons, load_dataset
from neus2_tpu_torch.engine.render import RenderConfig, render_image
from neus2_tpu_torch.engine.train import (
    StepAux,
    TrainConfig,
    desired_batch_bucket,
    init_train_state,
    occupancy_prior_sweep,
    occupancy_update,
    should_update_occupancy,
    train_step,
)
from neus2_tpu_torch.models.field import FieldConfig
from neus2_tpu_torch.ops.hashgrid import HashGridConfig
from neus2_tpu_torch.utils.device import resolve_device
from neus2_tpu_torch.utils.meters import Meters
from neus2_tpu_torch.utils.optim import OptimConfig


@dataclasses.dataclass
class Hyperparams:
    """Scene hyperparameters (reference configs/nerf/base.json:121-134,
    defaults src/testbed.cu:2117-2139).  The static Testbed reads
    ``first_frame_max_training_step`` and the ek / mask / anneal overrides;
    the rest belong to dynamic scenes and are carried for them."""

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
    optim = OptimConfig(
        learning_rate=float(leaf.get("learning_rate", 1e-3)),
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
    )
    return train_cfg, hyper


class Testbed:
    """Static NeuS2 training loop (one time frame)."""

    def __init__(self, config: TrainConfig | None = None, hyper: Hyperparams | None = None,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.config = config or TrainConfig()
        self.hyper = hyper or Hyperparams()
        self.seed = seed
        self.state = None
        self.dataset: NerfDataset | None = None
        self.images = None
        self.cameras = None
        self._datasets: list[NerfDataset] | None = None
        self.frame_jsons: list[Path] = []
        self.training_step = 0
        self.train_canonical = True
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
        # Eval protocol: black background (reference m_background_color).
        self.background_color = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
        self.rendering_min_transmittance = 1e-4

    # -- data ---------------------------------------------------------------

    def load_training_data(self, scene_path: str | Path, n_frames_cap=None):
        """A static scene: one transforms.json."""
        self.frame_jsons = list_frame_jsons(scene_path)
        self._datasets = None
        self._finish_load(n_frames_cap)

    def load_training_data_from_datasets(self, datasets: list[NerfDataset]):
        """An in-memory scene (synthetic scenes, tests)."""
        self._datasets = list(datasets)
        self.frame_jsons = [Path(f"<memory:{i}>") for i in range(len(datasets))]
        self._finish_load(None)

    def _finish_load(self, n_frames_cap):
        if len(self.frame_jsons) > 1:
            raise NotImplementedError("dynamic (multi-frame) scenes are not ported yet")
        self._load_frame(0, n_frames_cap)
        self._derive_config()
        self._init_state()

    def _load_frame(self, idx: int, n_frames_cap=None):
        if self._datasets is not None:
            self.dataset = self._datasets[idx]
        else:
            self.dataset = load_dataset(self.frame_jsons[idx], n_frames_cap)
        self.images, self.cameras = self.dataset.to_device(self.device)

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
        self.config = cfg

    def _init_state(self):
        """Fresh state, then the step-0 whole-grid probe sweep."""
        self.state = init_train_state(self.config, self.dataset.n_images, seed=self.seed,
                                      device=self.device)
        self.state = occupancy_prior_sweep(self.state, self.config)

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

    # -- training loop ------------------------------------------------------

    def frame(self) -> bool:
        """One training step (reference Testbed::frame, testbed.cu:1722).
        Returns False once the frame's step budget is spent."""
        if not self.m_train or self.state is None:
            return False
        if self.training_step >= self.hyper.first_frame_max_training_step:
            return False
        self.train()
        return True

    def train(self):
        """One optimization step (reference Testbed::train, testbed.cu:2640)."""
        state = self.state
        cfg = self._frame_config()
        with self.meters.scope("training_prep"):
            if should_update_occupancy(self.training_step):
                state = occupancy_update(state, cfg)
        with self.meters.scope("training"):
            state, aux = train_step(state, self.images, self.cameras, cfg)
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
        """The step's config: the adaptive bucket and the hyperparameter
        overrides applied."""
        cfg = self.config
        changes = {}
        if self.batch_bucket > 0 and self.train_canonical:
            changes["n_rays"] = cfg.n_rays << self.batch_bucket
            changes["samples_per_ray"] = cfg.samples_per_ray >> self.batch_bucket
        for hp_name, cfg_name in (("anneal_end", "anneal_end"),
                                  ("ek_loss_weight", "ek_loss_weight"),
                                  ("mask_loss_weight", "mask_loss_weight")):
            if getattr(self.hyper, hp_name) != getattr(cfg, cfg_name):
                changes[cfg_name] = getattr(self.hyper, hp_name)
        return dataclasses.replace(cfg, **changes) if changes else cfg

    # -- rendering / eval ---------------------------------------------------

    def prepare_for_test(self):
        """Set the delta gate for test renders (testbed.cu:1987-1999): a
        static scene renders without one."""
        self.use_delta = False

    @property
    def effective_acc(self):
        """The rigid transform renders apply: identity (None) for a static
        scene."""
        return None

    def _default_render_cfg(self) -> RenderConfig:
        return RenderConfig(field=self.config.field, aabb_scale=self.config.aabb_scale,
                            min_transmittance=self.rendering_min_transmittance)

    def render(self, *args, img_idx: int | None = None, spp: int = 1, background=None,
               render_cfg: RenderConfig | None = None, use_ema: bool = True,
               linear: bool = False, mode: str = "shade"):
        """Render training view ``img_idx`` at its resolution ->
        (rgb (H, W, 3), depth (H, W), alpha (H, W)) numpy arrays.  The
        pyngp form ``render(width, height, ...)`` is not ported yet."""
        if len(args) >= 2:
            raise NotImplementedError("render(width, height, ...) is not ported yet")
        if args:
            img_idx = int(args[0])
        img_idx = 0 if img_idx is None else img_idx
        cfg = render_cfg or self._default_render_cfg()
        params = self.state.ema_params if use_ema else self.state.params
        bg = self.background_color[:3] if background is None else background
        cams = self.cameras
        with self.meters.scope("render"):
            rgb, depth, alpha = render_image(
                params, self.effective_acc, self.state.occupancy, cams,
                cams.poses[img_idx], cams.focal[img_idx], cams.principal[img_idx],
                torch.Generator(device=self.device).manual_seed(7), cfg,
                background=bg, spp=spp, mode=mode,
            )
        if linear:
            from neus2_tpu_torch.ops.losses import srgb_to_linear

            rgb = srgb_to_linear(rgb)
        return rgb.cpu().numpy(), depth.cpu().numpy(), alpha.cpu().numpy()

    def compute_and_save_marching_cubes_mesh(
        self, path: str | Path, resolution: int = 256, thresh: float = 0.0,
        with_colors: bool = True, keep_largest_component: bool = False,
        with_normals: bool = True, aabb=None,
    ):
        """Marching-cubes export of the EMA field (reference python_api.cu:
        382): OBJ or, by suffix, PLY with sRGB vertex colours; 1-ring vertex
        normals; vertices in the dataset's space.  ``aabb`` ((lo3), (hi3))
        crops where the grid is sampled; the field is always queried in the
        scene's warp frame.  Returns (verts, tris) in warped coordinates."""
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
