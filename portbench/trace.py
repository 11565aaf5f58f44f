"""One traced window on the card and what the per-layer readers take from
it: the device's operations (kernels, copies, sets) with their intervals,
the busy time as the union of those intervals, and the idle gaps between
them named by what the host was doing.

The trace is ``torch.profiler`` (CUPTI) over short windows that start and
end on a synchronised card: one of the device alone for the busy share,
the launches and the kernels' times, and one with the host's operations
for what the host was doing in the gaps; the benchmark's own ranges
(``portbench.<what>``) mark each call into the program.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

# A kernel's name in the breakdown is cut to its first characters: the
# template arguments of a PyTorch kernel run to a thousand.
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    window_s: float  # host clock, synchronised at both ends
    busy_s: float  # union of the device operations' intervals
    units: int  # steps or views inside the window
    device: list  # (name, start_us, end_us) of every device operation
    gaps: list  # (host activity, seconds) of the idle gaps, longest first
    counters: dict = dataclasses.field(default_factory=dict)  # the program's, over the window

    def kernels(self) -> list:
        return [e for e in self.device if not e[0].startswith(("Memcpy", "Memset"))]

    def device_time_by_name(self) -> list:
        """(name, seconds) summed by name, largest first."""
        tot: dict = {}
        for name, a, b in self.device:
            tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
        return sorted(tot.items(), key=lambda kv: kv[1], reverse=True)


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _union(intervals: np.ndarray) -> tuple[float, np.ndarray]:
    """(covered length, the (k, 2) idle gaps between covered stretches)."""
    if len(intervals) == 0:
        return 0.0, np.zeros((0, 2))
    iv = intervals[np.argsort(intervals[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    # A new stretch starts where an interval begins after every earlier end.
    new = np.concatenate([[True], iv[1:, 0] > ends[:-1]])
    starts = iv[new, 0]
    stops = np.concatenate([ends[:-1][new[1:]], [ends[-1]]])
    gaps = np.stack([stops[:-1], starts[1:]], -1)
    return float((stops - starts).sum()), gaps


def _name_gaps(gaps: np.ndarray, host: list, keep: int = 2000) -> list:
    """The ``keep`` longest gaps, each named by the innermost host operation
    (not a CUDA runtime call) that spans its midpoint, summed by name."""
    if len(gaps) == 0:
        return []
    ops = [e for e in host if not e[0].startswith("cuda")]
    if not ops:
        return [("(no host range)", float((gaps[:, 1] - gaps[:, 0]).sum() * 1e-6))]
    starts = np.array([e[1] for e in ops])
    ends = np.array([e[2] for e in ops])
    length = ends - starts
    order = np.argsort(gaps[:, 0] - gaps[:, 1])[:keep]
    tot: dict = {}
    for g in order:
        a, b = gaps[g]
        mid = 0.5 * (a + b)
        cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = ops[cover[np.argmin(length[cover])]][0] if len(cover) else "(between host ranges)"
        tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
    return sorted(tot.items(), key=lambda kv: kv[1], reverse=True)


def traced(fn, units: int, host: bool) -> Trace:
    """Run ``fn()`` under the profiler between two synchronisations.  With
    ``host`` the host's operations are recorded too, which names the idle
    gaps but slows the host by a third or more (so the window that reads
    the busy share records the device alone)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync("cuda")
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    prof = profile(activities=acts)
    prof.start()
    t0 = time.perf_counter()
    fn()
    sync("cuda")
    window = time.perf_counter() - t0
    prof.stop()
    device, host = [], []
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != DeviceType.CUDA:
            host.append(row)
        elif not (getattr(e, "is_user_annotation", False) or e.name.startswith("portbench.")):
            # The benchmark's own ranges are laid on the device's timeline
            # too; they are no device work.
            device.append(row)
    busy_us, gaps = _union(np.array([[a, b] for _, a, b in device]).reshape(-1, 2))
    return Trace(window_s=window, busy_s=busy_us * 1e-6, units=units, device=device,
                 gaps=_name_gaps(gaps, host))


def breakdown(trace: Trace) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten host activities the card waited on longest."""
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in trace.device_time_by_name()[:10]],
            "idle_gaps": [[n[:NAME_CHARS], s] for n, s in trace.gaps[:10]]}
