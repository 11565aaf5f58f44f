"""The mask-loss A/B of tests/test_compaction.py (mask loss 0.1 against 0)
at a chosen field width, in the JAX package and in the port.

Run from the repo root (each arm is 300 steps):

  JAX_PLATFORMS=cpu python -u tests/test_torch_mask_ab.py --width base \
      --resolution 256 --views 16 --package jax

As a test file it holds only that both packages' drives build the same
configuration (``test_drive_configs_match_jax``); no arm trains under
pytest.

``--width e2e`` is tests/e2e_drive.py's ``small_config`` field (8 levels
of 2^15 rows up to resolution 256); ``--width base`` is
configs/base.json's (14 levels of 2^19 rows up to 2048, SDF MLP 64 x 1,
RGB MLP 64 x 2).  ``--loop e2e`` is tests/e2e_drive.py's loop: 512 rays
of 32 samples, 96 candidates, eikonal weight 0.1, ``hit_oversample`` 1.
``--loop testbed`` is the package's Testbed with the rest of
configs/base.json (4,096 rays of 64 samples, 192 candidates, eikonal
weight 0.01, the adaptive batch) and ``hit_oversample`` 1; for the port
only, ``--no_adaptive_batch`` turns the adaptive batch off and
``--e2e_batch`` takes e2e_drive's rays, samples, candidates and eikonal
weight.  ``--device cuda`` runs the port on the card.  The scene is the
sphere's, with its last view held out; the shell is 512 points of the
true sphere from ``np.random.default_rng(0)``.  Prints one JSON line an
arm: the held-out view's PSNR (64 samples, 128 candidates, black, one
pass), the shell's mean |sdf| and mean signed sdf (positive: the learned
surface lies inside the true sphere), then the pair against the test's
bars (PSNR_on > PSNR_off - 1.5 dB, |sdf|_on < 1.5 |sdf|_off + 1e-3).
"""

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import pytest

BASE_JSON = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "configs", "base.json")
N_RAYS, SAMPLES, CANDIDATES, EK_WEIGHT = 512, 32, 96, 0.1


def shell_points() -> np.ndarray:
    d = np.random.default_rng(0).normal(size=(512, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (0.5 + 0.25 * d).astype(np.float32)


def jax_configs(width: str, mask: float, loop: str, steps: int = 300):
    """The JAX drive's (TrainConfig, Hyperparams or None)."""
    from e2e_drive import small_config
    from neus2_tpu.api.testbed import config_from_json

    base, hyper = config_from_json(BASE_JSON)
    field = base.field if width == "base" else small_config().field
    if loop == "e2e":
        return dataclasses.replace(small_config(mask_loss_weight=mask), field=field), None
    return (dataclasses.replace(base, field=field, mask_loss_weight=mask, hit_oversample=1),
            dataclasses.replace(hyper, mask_loss_weight=mask,
                                first_frame_max_training_step=steps))


def torch_configs(width: str, mask: float, loop: str, steps: int = 300,
                  adaptive_batch: bool = True, e2e_batch: bool = False):
    """The port's drive's (TrainConfig, Hyperparams or None)."""
    from neus2_tpu_torch.api.testbed import config_from_json
    from neus2_tpu_torch.engine.train import TrainConfig
    from neus2_tpu_torch.models.field import FieldConfig
    from neus2_tpu_torch.ops.hashgrid import HashGridConfig

    base, hyper = config_from_json(BASE_JSON)
    if width == "base":
        field = base.field
    else:
        field = FieldConfig(grid=HashGridConfig(
            n_levels=8, n_features_per_level=2, log2_hashmap_size=15, base_resolution=16,
            per_level_scale=HashGridConfig.per_level_scale_from_top(16, 256, 8)))
    if loop == "e2e":
        return TrainConfig(field=field, n_rays=N_RAYS, samples_per_ray=SAMPLES,
                           n_candidates=CANDIDATES, ek_loss_weight=EK_WEIGHT,
                           mask_loss_weight=mask, hit_oversample=1), None
    cfg = dataclasses.replace(base, field=field, mask_loss_weight=mask, hit_oversample=1,
                              adaptive_batch=adaptive_batch)
    hyper = dataclasses.replace(hyper, mask_loss_weight=mask,
                                first_frame_max_training_step=steps)
    if e2e_batch:
        cfg = dataclasses.replace(cfg, n_rays=N_RAYS, samples_per_ray=SAMPLES,
                                  n_candidates=CANDIDATES)
        hyper = dataclasses.replace(hyper, ek_loss_weight=EK_WEIGHT)
    return cfg, hyper


def drive_jax(width: str, mask: float, steps: int, views: int, resolution: int,
              loop: str = "e2e") -> dict:
    import jax
    import jax.numpy as jnp

    from neus2_tpu.api.testbed import Testbed
    from neus2_tpu.data.synthetic import make_sphere_dataset
    from neus2_tpu.engine import train as tt
    from neus2_tpu.engine.rays import Cameras
    from neus2_tpu.engine.render import RenderConfig, render_image
    from neus2_tpu.models.field import sdf_fn
    from neus2_tpu.ops.image import psnr
    from neus2_tpu.ops.losses import linear_to_srgb

    cfg, hyper = jax_configs(width, mask, loop, steps)
    ds = make_sphere_dataset(n_views=views + 1, resolution=resolution)
    cams_all, images_all = ds.cameras(), ds.images_device()
    if loop == "e2e":
        cams = Cameras(poses=cams_all.poses[:-1], focal=cams_all.focal[:-1],
                       principal=cams_all.principal[:-1], resolution=cams_all.resolution)
        state = tt.init_train_state(jax.random.PRNGKey(0), cfg, n_images=views)
        for _ in range(steps):
            if tt.should_update_occupancy(int(state.step)):
                state = tt.occupancy_update(state, cfg)
            state, _ = tt.train_step(state, images_all[:-1], cams, cfg)
        params, acc, occupancy = state.ema_params, state.acc, state.occupancy
    else:
        tb = Testbed(config=cfg, hyper=hyper, seed=0)
        tb.load_training_data_from_datasets([dataclasses.replace(
            ds, images=ds.images[:-1], poses=ds.poses[:-1], focal=ds.focal[:-1],
            principal=ds.principal[:-1])])
        while tb.frame():
            pass
        params, acc, occupancy = tb.state.ema_params, tb.effective_acc, tb.state.occupancy
    sdf, _ = sdf_fn(params, jnp.asarray(shell_points()), cfg.field)
    rcfg = RenderConfig(field=cfg.field, samples_per_ray=64, n_candidates=128, chunk=1 << 12)
    rgb, _, _ = render_image(params, acc, occupancy, cams_all, cams_all.poses[-1],
                             cams_all.focal[-1], cams_all.principal[-1],
                             jax.random.PRNGKey(1), rcfg, background=0.0)
    tex = images_all[-1]
    a = tex[..., 3:4]
    target = jnp.where(a > 0, linear_to_srgb(tex[..., :3] / jnp.where(a > 0, a, 1.0)) * a, 0.0)
    sdf = np.asarray(sdf)
    return {"psnr": float(psnr(rgb, target)), "shell_abs_sdf": float(np.abs(sdf).mean()),
            "shell_mean_sdf": float(sdf.mean())}


def drive_torch(width: str, mask: float, steps: int, views: int, resolution: int,
                loop: str = "e2e", adaptive_batch: bool = True, e2e_batch: bool = False,
                device: str = "cpu") -> dict:
    import torch

    from neus2_tpu_torch.api.testbed import Testbed
    from neus2_tpu_torch.data.synthetic import make_sphere_dataset
    from neus2_tpu_torch.engine import train as tt
    from neus2_tpu_torch.engine.rays import Cameras
    from neus2_tpu_torch.engine.render import RenderConfig, render_image
    from neus2_tpu_torch.models.field import sdf_fn
    from neus2_tpu_torch.ops.image import psnr, srgb_eval_target

    cfg, hyper = torch_configs(width, mask, loop, steps, adaptive_batch, e2e_batch)
    field = cfg.field
    ds = make_sphere_dataset(n_views=views + 1, resolution=resolution)
    images, cams_all = ds.to_device(device)
    if loop == "e2e":
        cams = Cameras(poses=cams_all.poses[:-1], focal=cams_all.focal[:-1],
                       principal=cams_all.principal[:-1], resolution=cams_all.resolution)
        state = tt.init_train_state(cfg, views, seed=0, device=device)
        state = tt.train_static(state, images[:-1], cams, cfg, steps)
        params, acc, occupancy = state.ema_params, state.acc, state.occupancy
    else:
        tb = Testbed(config=cfg, hyper=hyper, seed=0, device=device)
        tb.load_training_data_from_datasets([dataclasses.replace(
            ds, images=ds.images[:-1], poses=ds.poses[:-1], focal=ds.focal[:-1],
            principal=ds.principal[:-1])])
        while tb.frame():
            pass
        params, acc, occupancy = tb.state.ema_params, tb.effective_acc, tb.state.occupancy
    with torch.no_grad():
        sdf, _ = sdf_fn(params, torch.from_numpy(shell_points()).to(device), field)
        rcfg = RenderConfig(field=field, samples_per_ray=64, n_candidates=128, chunk=1 << 12)
        rgb, _, _ = render_image(params, acc, occupancy, cams_all, cams_all.poses[-1],
                                 cams_all.focal[-1], cams_all.principal[-1],
                                 torch.Generator(device=device).manual_seed(1), rcfg,
                                 background=0.0)
    return {"psnr": float(psnr(rgb, srgb_eval_target(images[-1]))),
            "shell_abs_sdf": float(sdf.abs().mean()), "shell_mean_sdf": float(sdf.mean())}


_GRID_KEYS = ("n_levels", "n_features_per_level", "log2_hashmap_size", "base_resolution",
              "per_level_scale")
_FIELD_KEYS = ("sdf_hidden_dim", "sdf_n_hidden", "rgb_hidden_dim", "rgb_n_hidden",
               "init_radius")
_STEP_KEYS = ("n_rays", "samples_per_ray", "n_candidates", "ek_loss_weight",
              "mask_loss_weight", "hit_oversample", "adaptive_batch", "aabb_scale",
              "random_bg", "use_error_map")
_HYPER_KEYS = ("first_frame_max_training_step", "ek_loss_weight", "mask_loss_weight")


@pytest.mark.parametrize("loop", ["e2e", "testbed"])
@pytest.mark.parametrize("width", ["e2e", "base"])
def test_drive_configs_match_jax(width, loop):
    """Both packages' drives train the same configuration, so an arm's
    reading in one package answers for the other's."""
    (jcfg, jhyper), (tcfg, thyper) = jax_configs(width, 0.1, loop), torch_configs(width, 0.1,
                                                                                  loop)
    for keys, j, t in ((_GRID_KEYS, jcfg.field.grid, tcfg.field.grid),
                       (_FIELD_KEYS, jcfg.field, tcfg.field), (_STEP_KEYS, jcfg, tcfg)):
        for k in keys:
            assert getattr(t, k) == getattr(j, k), k
    assert (jhyper is None) == (thyper is None) == (loop == "e2e")
    for k in _HYPER_KEYS if loop == "testbed" else ():
        assert getattr(thyper, k) == getattr(jhyper, k), k


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--package", choices=("jax", "torch"), default="jax")
    p.add_argument("--width", choices=("e2e", "base"), default="base")
    p.add_argument("--views", type=int, default=8)
    p.add_argument("--resolution", type=int, default=48)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--loop", choices=("e2e", "testbed"), default="e2e")
    p.add_argument("--no_adaptive_batch", action="store_true")
    p.add_argument("--e2e_batch", action="store_true")
    p.add_argument("--device", default="cpu")
    args = p.parse_args(argv)
    if args.package == "jax" and (args.device != "cpu" or args.no_adaptive_batch
                                  or args.e2e_batch):
        p.error("the JAX package runs on the CPU, without the Testbed's options")
    arms = {}
    for mask in (0.1, 0.0):
        if args.package == "jax":
            arms[mask] = drive_jax(args.width, mask, args.steps, args.views, args.resolution,
                                   args.loop)
        else:
            arms[mask] = drive_torch(args.width, mask, args.steps, args.views, args.resolution,
                                     args.loop, not args.no_adaptive_batch, args.e2e_batch,
                                     args.device)
        print(json.dumps({**vars(args), "mask_loss_weight": mask, **arms[mask]}), flush=True)
    on, off = arms[0.1], arms[0.0]
    pair = {"psnr_diff": on["psnr"] - off["psnr"],
            "sdf_ratio": on["shell_abs_sdf"] / off["shell_abs_sdf"],
            "meets_bars": bool(on["psnr"] > off["psnr"] - 1.5
                               and on["shell_abs_sdf"] < 1.5 * off["shell_abs_sdf"] + 1e-3)}
    print("pair " + json.dumps(pair), flush=True)
    return pair


if __name__ == "__main__":
    main()
