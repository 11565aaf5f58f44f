"""device_idle_pct.render: the share of the device-alone traced render
window in which no operation ran on the card, in %.  A view keeps the card
busy nearly throughout, so the tracer's cost to the host does not show
here as it does in a training step."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
