"""The check decides: at a size the CPU holds, a whole run with the plain
reference agrees with the port (the kernels' plain versions) within the
cells' own limits; the control (TF32 products in the reference) and each
fault a cell can have, planted under the timed path, come out not
correct.  The look for a card is skipped; the rest is the run."""

import dataclasses
import json

import pytest
import torch

from portbench import harness, manifest, scene
from portbench.checks import render as render_check
from portbench.checks import train as train_check

SEED = 2**31 + 5


@pytest.fixture
def tiny(tmp_path):
    """``name``'s cell with a 6-level grid of 2^12 rows, 256 rays x 16
    samples, renders of 16 samples a ray, and 6 views of 64 x 48."""

    def make(name: str) -> manifest.Cell:
        cell = manifest.cell(name)
        cfg = json.loads(json.dumps(cell.config))
        cfg["encoding"]["log2_hashmap_size"] = 12
        cfg["encoding"]["n_levels"] = min(cfg["encoding"]["n_levels"], 6)
        cfg["assumed"].update(n_rays=256, samples_per_ray=16, n_candidates=48,
                              render_samples_per_ray=16, render_candidates=48)
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(cfg))
        traffic = dict(cell.traffic, views=[1, 3, 4]) if "views" in cell.traffic else cell.traffic
        return dataclasses.replace(cell, config_path=path, config=cfg, traffic=traffic,
                                   capture=dict(cell.capture, n_views=6, width=64, height=48))

    torch.set_num_threads(4)
    return make


def _run(cell) -> harness.Run:
    return harness.run_cell(cell, SEED, 0.5, False, "cpu")


@pytest.mark.parametrize("name", ["base.b0", "base.render"])
def test_sound_run_is_correct(tiny, name):
    run = _run(tiny(name))
    assert run.correct, run.numbers
    assert run.window["attempted"] >= 1


def test_checked_steps_take_the_windows_path(tiny, monkeypatch):
    """Set-up reads the checked steps' losses without the Testbed's scalar
    fetch, which runs on its own cadence alone (step 1, then every 16th)."""
    from neus2_tpu_torch.api.testbed import Testbed

    fetches = []
    orig = Testbed._update_batch_bucket
    monkeypatch.setattr(Testbed, "_update_batch_bucket",
                        lambda tb, occ_len: (fetches.append(tb.training_step), orig(tb, occ_len)))
    cell = tiny("base.b0")
    cap = scene.make_capture(cell.capture, SEED, "cpu")
    drive = manifest.load_module("drives", "train").Drive(cell, cap, SEED, "cpu")
    drive.setup()
    assert fetches == [1]
    assert len(drive.losses) == cell.traffic["checked_steps"] == 3
    assert drive.losses[0] == drive.tb.last_aux.loss
    ref = train_check.reference(cell, cap, SEED, 3)
    assert drive.losses == pytest.approx(ref["loss"], rel=cell.limits["loss"])


def _unchanged(monkeypatch):
    """The step returns its state as it was (its counters moved on)."""
    from neus2_tpu_torch.api import testbed

    orig = testbed.train_step

    def step(state, *args, **kw):
        new, aux = orig(state, *args, **kw)
        return state._replace(step=new.step, frame_step=new.frame_step), aux

    monkeypatch.setattr(testbed, "train_step", step)


def _half(monkeypatch):
    """The step takes half of its batch's draws, the mean over the rest."""
    from neus2_tpu_torch.api import testbed
    from neus2_tpu_torch.engine.train import sample_step_draws

    orig = testbed.train_step

    def step(state, images, cameras, config, **kw):
        d = sample_step_draws(state.generator, config, cameras.n_images)
        c, r = d.probe_u.shape[0] // 2, config.n_rays // 2
        half = d._replace(img_idx=d.img_idx[:c], uv0=d.uv0[:c], probe_u=d.probe_u[:c],
                          xi=d.xi[:r], bg=d.bg[:c], drop_u=d.drop_u[:c])
        return orig(state, images, cameras, dataclasses.replace(config, n_rays=r), draws=half,
                    **kw)

    monkeypatch.setattr(testbed, "train_step", step)


def _altered(monkeypatch):
    """A corner of every rendered image is off by 0.05."""
    from neus2_tpu_torch.api import testbed

    orig = testbed.render_image

    def render(*args, **kw):
        rgb, depth, alpha = orig(*args, **kw)
        rgb = rgb.clone()
        rgb[: rgb.shape[0] // 4, : rgb.shape[1] // 4] += 0.05
        return rgb, depth, alpha

    monkeypatch.setattr(testbed, "render_image", render)


@pytest.mark.parametrize("name, fault", [("base.b0", _unchanged), ("base.b0", _half),
                                         ("base.render", _altered)])
def test_a_fault_under_the_timed_path_is_not_correct(tiny, monkeypatch, name, fault):
    fault(monkeypatch)
    assert not _run(tiny(name)).correct


def test_the_control_is_not_correct_in_training(tiny):
    cell = tiny("base.b0")
    cap = scene.make_capture(cell.capture, SEED, "cpu")
    ref = train_check.reference(cell, cap, SEED, 3)
    numbers = train_check.gaps(train_check.reference(cell, cap, SEED, 3, tf32=True), ref)
    assert any(v > cell.limits[k] for k, v in numbers.items()), numbers


def test_the_control_is_not_correct_in_rendering(tiny):
    cell = tiny("base.render")
    cap = scene.make_capture(cell.capture, SEED, "cpu")
    ref = render_check.reference(cell, cap, SEED, [1, 3])
    ctl = render_check.reference(cell, cap, SEED, [1, 3], tf32=True)
    numbers = render_check.gaps({v: r[0] for v, r in ctl.items()}, ref)
    assert any(v > cell.limits[k] for k, v in numbers.items()), numbers
