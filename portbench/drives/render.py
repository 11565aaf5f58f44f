"""The render drive: ``neus2_tpu_torch``'s Testbed on the capture, built
from the seed (the field's init and the occupancy prior sweep, no
training), rendering the traffic's training views in turn through
``Testbed.render(img_idx=i)`` at their full size, each view back on the
host as arrays.

Every seed renders the same views, in turn from the one at ``seed mod
len(views)``.  Set-up renders the first of them once at a small size
through the same path, whose chunks have the full size's shapes, so
every kernel is loaded; the window renders views until ``seconds`` have
passed, each timed on the host clock (the call ends on the host copy,
which waits for the card).  The last image of every view rendered in the
window is kept for the check.
"""

from __future__ import annotations

import time

import torch

from portbench.drives.train import testbed
from portbench.trace import sync, traced


class Drive:
    def __init__(self, cell, capture, seed: int, device):
        from neus2_tpu_torch.engine.render import RenderConfig

        self.cell, self.device = cell, device
        self.tb = testbed(cell, capture, seed, device)
        a = cell.config["assumed"]
        self.render_cfg = RenderConfig(field=self.tb.config.field,
                                       samples_per_ray=int(a["render_samples_per_ray"]),
                                       n_candidates=int(a["render_candidates"]),
                                       aabb_scale=self.tb.config.aabb_scale,
                                       min_transmittance=float(a["render_min_transmittance"]))
        self.views = [int(v) for v in cell.traffic["views"]]
        self.turn = seed % len(self.views)
        self.images: dict = {}
        self.view_s: dict = {}

    def render(self, view: int):
        return self.tb.render(img_idx=view, spp=int(self.cell.traffic["spp"]),
                              render_cfg=self.render_cfg,
                              use_ema=bool(self.cell.traffic["use_ema"]))

    def _next(self) -> int:
        v = self.views[self.turn]
        self.turn = (self.turn + 1) % len(self.views)
        return v

    def setup(self) -> None:
        self.tb.set_camera_to_training_view(self.views[self.turn])
        self.tb.render(160, 120, int(self.cell.traffic["spp"]), render_cfg=self.render_cfg)
        sync(self.device)

    def window(self, seconds: float) -> dict:
        views = failed = 0
        sync(self.device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            v = self._next()
            t = time.perf_counter()
            rgb, _, _ = self.render(v)
            self.view_s.setdefault(v, []).append(time.perf_counter() - t)
            self.images[v] = rgb
            failed += int(not (rgb == rgb).all())
            views += 1
        window = time.perf_counter() - t0
        return {"attempted": views, "failed": failed,
                "metrics": {"render_ms": window * 1e3 / max(views, 1)}}

    def trace(self, units: int, host: bool):
        def views():
            for _ in range(units):
                with torch.profiler.record_function("portbench.render"):
                    self.render(self._next())

        return traced(views, units, host)

    def outputs(self) -> dict:
        """The views rendered in the window, their last images and host
        seconds, the Testbed released."""
        out = {"images": self.images, "view_s": self.view_s}
        self.tb = None
        return out
