"""device_idle_pct.train: the share of a step in which no operation runs on
the card, in %: the device-alone trace's busy time a step (the union of
its operations' intervals) over the untraced window's time a step.  The
tracer slows the host by half or more, so the traced window's own idle
share would read the tracer."""


def read(ctx):
    tr, step_ms = ctx["trace"], ctx["window"]["metrics"].get("step_ms")
    if tr is None or tr.busy_s <= 0.0 or not step_ms:
        return None
    return 100.0 * (1.0 - (tr.busy_s / tr.units) / (step_ms * 1e-3))
