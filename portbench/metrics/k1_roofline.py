"""k1_roofline: kernel 1's share of its roofline, in %: the least time its
bytes (or adds) allow at the card's peaks (``counts.kernel1_least_s``),
over its device time a launch in the trace (its stream and fix-up
kernels, over the launches the program counted in the window)."""

from portbench import counts

NAMES = ("stream_sum_kernel", "stream_fixup_kernel")


def read(ctx):
    tr = ctx["trace"]
    launches = tr.counters.get("kernel1_launches", 0) if tr is not None else 0
    us = sum(b - a for name, a, b in tr.device if any(k in name for k in NAMES)) if launches else 0.0
    if us <= 0.0:
        return None
    return 100.0 * counts.kernel1_least_s(ctx["cell"].config) / (us * 1e-6 / launches)
