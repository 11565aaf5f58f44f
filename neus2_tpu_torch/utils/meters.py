"""Time-based EMA meters (port of ``neus2_tpu/utils/meters.py``; reference
common.h:238-283 ``Ema`` with a time half-life, and testbed.h:833-837's
training_prep / training / render / frame ms meters fed by ScopeGuard
timers; the loss scalars' step EMA, testbed.h:880-882).  ``trace``
records a ``torch.profiler`` trace of the host and the card.

The timers read the host clock: on the card they measure how long the
host takes to enqueue a phase, not the device's time.
"""

from __future__ import annotations

import contextlib
import math
import time
from pathlib import Path


class Ema:
    """Time-based exponential moving average."""

    def __init__(self, half_life_s: float = 1.0):
        self.half_life_s = half_life_s
        self.value = 0.0
        self._last_t: float | None = None

    def update(self, sample: float, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        if self._last_t is None:
            self.value = sample
        else:
            dt = max(now - self._last_t, 0.0)
            alpha = 0.5 ** (dt / self.half_life_s) if self.half_life_s > 0 else 0.0
            self.value = alpha * self.value + (1.0 - alpha) * sample
        self._last_t = now
        return self.value


class StepEma:
    """Step-based EMA (the reference's loss scalars: one decay an update)."""

    def __init__(self, decay: float = 0.9):
        self.decay = decay
        self.value = math.nan

    def update(self, sample: float) -> float:
        if math.isnan(self.value):
            self.value = sample
        else:
            self.value = self.decay * self.value + (1.0 - self.decay) * sample
        return self.value


class Meters:
    """The reference's per-phase ms meters as a bundle."""

    def __init__(self):
        self.training_prep_ms = Ema(1.0)
        self.training_ms = Ema(1.0)
        self.render_ms = Ema(1.0)
        self.frame_ms = Ema(1.0)

    @contextlib.contextmanager
    def scope(self, name: str):
        """ScopeGuard-style timing into the named meter."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            getattr(self, f"{name}_ms").update(1000.0 * (time.monotonic() - t0))

    def summary(self) -> dict[str, float]:
        return {k: getattr(self, k).value
                for k in ("training_prep_ms", "training_ms", "render_ms", "frame_ms")}


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """A ``torch.profiler`` capture of the block (the host, and the card
    when there is one), written as a Chrome trace under ``log_dir``
    (``trace.json``) -> yields the profiler."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
