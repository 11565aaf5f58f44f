"""mfu_pct.render: the field's forward operations (``counts``: the SDF MLP
with its tangent columns, the RGB MLP) for the samples the checked views
need (the rays the reference finds crossing occupied space, times the
render budget a ray), over the host seconds the program took for those
views in the window, as a share of the card's fp32 peak, in %."""

from portbench import counts


def read(ctx):
    hits, view_s = ctx["extras"].get("hit_rays"), ctx["extras"].get("view_s")
    if not hits:
        return None
    cfg = ctx["cell"].config
    per_ray = counts.forward_flops_per_sample(cfg) * int(cfg["assumed"]["render_samples_per_ray"])
    flops = sum(hits[v] * per_ray for v in hits)
    seconds = sum(sum(view_s[v]) / len(view_s[v]) for v in hits)
    return 100.0 * flops / seconds / counts.FP32_FLOPS
