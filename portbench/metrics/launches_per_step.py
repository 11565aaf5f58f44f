"""launches_per_step: device kernels in the traced window (copies and
sets left out) over the steps traced."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.units == 0:
        return None
    return len(tr.kernels()) / tr.units
