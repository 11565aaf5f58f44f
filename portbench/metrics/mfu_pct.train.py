"""mfu_pct.train: the step's MLP operations (``counts``: forward, tangent
columns, backward) times the samples a step, over the window's step time,
as a share of the card's fp32 peak, in %."""

from portbench import counts


def read(ctx):
    step_ms = ctx["window"]["metrics"].get("step_ms")
    if not step_ms:
        return None
    cfg = ctx["cell"].config
    flops = counts.train_flops_per_sample(cfg) * counts.samples_per_step(cfg)
    return 100.0 * flops / (step_ms * 1e-3) / counts.FP32_FLOPS
