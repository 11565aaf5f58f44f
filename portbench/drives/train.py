"""The training drive: ``neus2_tpu_torch``'s Testbed on the capture,
driven one ``Testbed.frame()`` at a time, in one adaptive bucket.

Set-up builds the Testbed from the seed, runs the traffic's
``checked_steps`` through ``frame()`` as the window runs it (the Testbed
fetches the scalars on its own cadence only), keeping what the check
compares, then the rest of ``warmup_steps``.  Each checked step's loss is
read back after the last of them, from the step's own output on the card.
The window goes on from there with the same object: ``frame()`` until
``seconds`` have passed, timed on the host clock between two
synchronisations of the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from portbench.reference.steps import leaves
from portbench.trace import sync, traced


def _clone(tree) -> dict:
    """The program's tree as the reference names its leaves."""
    return {n: t.detach().clone() for n, t in leaves(tree)}


@contextlib.contextmanager
def recording(auxes: list):
    """Each step's outputs as the Testbed's ``train_step`` returns them,
    appended to ``auxes`` as device tensors: nothing is fetched, and the
    step runs as it does in the window."""
    from neus2_tpu_torch.api import testbed as module

    step = module.train_step

    def recorded(*args, **kwargs):
        state, aux = step(*args, **kwargs)
        auxes.append(aux)
        return state, aux

    module.train_step = recorded
    try:
        yield
    finally:
        module.train_step = step


def dataset_of(capture):
    """The capture as the program's in-memory dataset (the images stay on
    the card: the Testbed takes them as they are)."""
    from neus2_tpu_torch.data.dataset import NerfDataset

    return NerfDataset(images=capture.images, poses=capture.poses.cpu().numpy(),
                       focal=capture.focal.cpu().numpy(),
                       principal=capture.principal.cpu().numpy(), scale=1.0,
                       offset=(0.5, 0.5, 0.5), aabb_scale=capture.aabb_scale, from_na=True)


def testbed(cell, capture, seed: int, device):
    """The Testbed of ``cell``'s configuration file, with the sizes the file
    states under ``assumed``, its frame budget from the traffic, the
    adaptive bucket pinned to the traffic's, loaded with ``capture``."""
    from neus2_tpu_torch.api.testbed import Testbed, config_from_json

    cfg, hyper = config_from_json(cell.config_path)
    a = cell.config["assumed"]
    field = dataclasses.replace(cfg.field, sdf_out_dim=int(a["sdf_out_dim"]),
                                sh_degree=int(a["sh_degree"]), sdf_bias=float(a["sdf_bias"]),
                                init_radius=float(a["init_radius"]))
    cfg = dataclasses.replace(cfg, field=field, n_rays=int(a["n_rays"]),
                              samples_per_ray=int(a["samples_per_ray"]),
                              n_candidates=int(a["n_candidates"]),
                              hit_oversample=int(a["hit_oversample"]),
                              occ_n_probe=int(a["occ_n_probe"]), random_bg=bool(a["random_bg"]),
                              adaptive_batch=False)
    hyper.first_frame_max_training_step = int(cell.traffic["max_training_steps"])
    tb = Testbed(cfg, hyper, seed=seed, device=device)
    tb.load_training_data_from_datasets([dataset_of(capture)])
    tb.batch_bucket = int(cell.traffic.get("bucket", 0))
    return tb


class Drive:
    def __init__(self, cell, capture, seed: int, device):
        self.cell, self.device = cell, device
        self.tb = testbed(cell, capture, seed, device)
        self.host_s, self.host_n = 0.0, 0

    def setup(self) -> None:
        """The checked steps, then the rest of the warm-up."""
        tb, traffic = self.tb, self.cell.traffic
        self.start = _clone(tb.state.params)
        checked, auxes = int(traffic["checked_steps"]), []
        with recording(auxes):
            for k in range(checked):
                if not tb.frame():
                    raise RuntimeError("the Testbed stopped during set-up")
                if k == 0:
                    b1 = tb.config.optim.beta1
                    self.grad = {n: m / (1.0 - b1)
                                 for n, m in _clone(tb.state.opt_state["mu"]).items()}
        self.params = _clone(tb.state.params)
        self.ema = _clone(tb.state.ema_params)
        self.losses = [float(a.loss) for a in auxes]
        for _ in range(int(traffic["warmup_steps"]) - checked):
            tb.frame()
        sync(self.device)

    def _frame(self) -> bool:
        """One ``frame()``; the host's time of a step that does not fetch
        the scalars is summed for ``host_ms.train``."""
        t0 = time.perf_counter()
        ok = self.tb.frame()
        dt = time.perf_counter() - t0
        if self.tb.training_step % 16:
            self.host_s += dt
            self.host_n += 1
        return ok

    def window(self, seconds: float) -> dict:
        steps = failed = 0
        sync(self.device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if not self._frame():
                failed += 1
                break
            steps += 1
        sync(self.device)
        window = time.perf_counter() - t0
        loss = self.tb.loss
        return {"attempted": steps, "failed": failed + (0 if loss == loss else 1),
                "metrics": {"step_ms": window * 1e3 / max(steps, 1)},
                "host_ms": self.host_s * 1e3 / max(self.host_n, 1)}

    def trace(self, units: int, host: bool):
        from neus2_tpu_torch.ops.segment_tile import segment_sum_rows

        launches = segment_sum_rows.launches

        def steps():
            for _ in range(units):
                with torch.profiler.record_function("portbench.frame"):
                    self.tb.frame()

        tr = traced(steps, units, host)
        tr.counters["kernel1_launches"] = segment_sum_rows.launches - launches
        return tr

    def outputs(self) -> dict:
        """What the check compares, the Testbed released."""
        out = {"loss": self.losses, "start": self.start, "grad": self.grad,
               "params": self.params, "ema": self.ema}
        self.tb = None
        return out
