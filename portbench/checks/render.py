"""The render check: the plain reference builds the same start from the
seed (the field's init and the occupancy sweep) and renders a sample of
the views the window rendered, drawn from the seed; the numbers are the
mean and the largest absolute gap of their sRGB pixels (channels of every
pixel of every sampled view) against the program's last image of each."""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference.nets import load_config
from portbench.reference.steps import render_view, start


def sample_views(rendered, seed: int, k: int) -> list[int]:
    views = sorted(rendered)
    rng = np.random.default_rng(seed)
    return sorted(int(v) for v in rng.choice(views, size=min(k, len(views)), replace=False))


def reference(cell, capture, seed: int, views, tf32: bool = False) -> dict:
    """{view: (image (H, W, 3) float32 numpy, rays that cross occupied space)}."""
    cfg = load_config(cell.config_path)
    if tf32:
        cfg = dataclasses.replace(cfg, tf32=True)
    params, _, occ = start(cfg, seed, capture.images.device)
    out = {}
    for v in views:
        img, hits = render_view(params, occ, capture, v, cfg)
        out[v] = (img.cpu().numpy(), hits)
    return out


def gaps(prog: dict, ref: dict) -> dict:
    d = np.concatenate([np.abs(prog[v].astype(np.float64) - ref[v][0]).reshape(-1) for v in ref])
    return {"rgb.mean": float(d.mean()), "rgb.max": float(d.max())}


def compare(cell, capture, seed: int, outputs: dict) -> tuple[dict, dict]:
    views = sample_views(outputs["images"], seed, int(cell.traffic["checked_views"]))
    ref = reference(cell, capture, seed, views)
    return gaps(outputs["images"], ref), {"hit_rays": {v: ref[v][1] for v in views},
                                          "view_s": outputs["view_s"]}
