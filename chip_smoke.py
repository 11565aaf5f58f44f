#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``neus2_tpu_torch/csrc`` from source, holds
each kernel against its plain PyTorch version at the training step's
shapes, then trains the static NeuS2 step at full ``configs/base.json``
width on a seeded synthetic sphere scene and checks that the step went
through the kernels, that the loss fell, and that the field and its
gradients on the card agree with the same field evaluated on the CPU.
Then it traces a few more steps with ``torch.profiler`` to show where the
step's time goes (the ``profile_phase`` line).  Exits non-zero on any
failure; the last line of a successful run is the device JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
TRAIN_STEPS = 150
WARMUP_STEPS = 20
PROFILE_STEPS = 20


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def segment_sum_launches() -> int:
    from neus2_tpu_torch.ops.segment_tile import segment_sum_rows

    return segment_sum_rows.launches


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def segment_sum_inputs(torch, sizes, use_hash, m, f, seed):
    """Seeded indices and updates at the backward's shapes: uniform rows on
    hashed levels, concentrated on an eighth of the rows on dense ones."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    idx, upd = [], []
    for size, hashed in zip(sizes, use_hash):
        hi = size if hashed else max(1, size // 8)
        idx.append(torch.randint(0, hi, (m,), generator=g, device="cuda"))
        upd.append(torch.randn((m, f), generator=g, device="cuda"))
    return idx, upd


def kernel_phase(torch, st, cfg, f: int) -> dict:
    """Segment-sum kernel vs its plain version at the main path's shapes."""
    _, _, _, sizes, use_hash = cfg.field.grid.level_tables()
    m = cfg.n_rays * cfg.samples_per_ray * 8  # samples x corners per level
    idx, upd = segment_sum_inputs(torch, sizes, use_hash, m, f, seed=f)
    got = st.segment_sum_all_levels(idx, upd, sizes)
    again = st.segment_sum_all_levels(idx, upd, sizes)
    ref = st.segment_sum_all_levels_ref(idx, upd, sizes)
    torch.cuda.synchronize()
    err = 0.0
    for lvl, (g_, a_, r_) in enumerate(zip(got, again, ref)):
        if g_.shape != (sizes[lvl], f) or not torch.isfinite(g_).all():
            raise AssertionError(f"level {lvl}: bad output {tuple(g_.shape)}")
        if not torch.equal(g_, a_):
            raise AssertionError(f"level {lvl}: two launches differ bitwise")
        d = float((g_ - r_).abs().max())
        tol = 1e-5 * float(r_.abs().max()) + 1e-7
        if d > tol:
            raise AssertionError(f"level {lvl}: max|diff| {d} > {tol}")
        err = max(err, d)

    bounds, payload = st.sort_updates(idx, upd, sizes)
    kernel_ms = cuda_ms(torch, lambda: st.segment_sum_rows(bounds, payload))
    sort_ms = cuda_ms(torch, lambda: st.sort_updates(idx, upd, sizes))
    plain_ms = cuda_ms(torch, lambda: st.segment_sum_all_levels_ref(idx, upd, sizes), iters=5)
    quant = [u.to(torch.bfloat16).float() for u in upd]

    def library():
        for i, u, s in zip(idx, quant, sizes):
            torch.zeros((s, f), device="cuda").index_add_(0, i, u)

    library_ms = cuda_ms(torch, library)
    # The timed kernel reads the sorted bf16 payload and the int32 row
    # bounds once and writes every fp32 row once; the int32 keys are read
    # by the sort, which is timed apart (sort_ms).
    n_upd, n_rows = len(sizes) * m, sum(sizes)
    bytes_moved = n_upd * 2 * f + (n_rows + 1) * 4 + n_rows * f * 4
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, n_upd * f / FP32_OPS_PER_S) * 1e3
    bound_by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= n_upd * f / FP32_OPS_PER_S else "operations"
    out = {
        "F": f, "levels": len(sizes), "updates_per_level": m, "rows": n_rows,
        "max_abs_err": err, "kernel_ms": kernel_ms, "sort_ms": sort_ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "bytes": bytes_moved,
    }
    print("kernel_phase " + json.dumps(out), flush=True)
    return out


def field_agrees_with_cpu(torch, cfg, n: int = 16384) -> dict:
    """The field and its gradients at full width on the card (through the
    segment-sum kernel) vs the same inputs on the CPU (exact scatter):
    outputs within 1e-4 of their max, MLP and variance gradients within
    1e-3 of their max, table gradients within 1e-2 of their max (the
    kernel sums bf16-quantized updates, as the reference's fp16 atomics
    do)."""
    from neus2_tpu_torch.models.field import field_forward, init_field
    from neus2_tpu_torch.utils.tree import tree_leaves, tree_map

    g = torch.Generator().manual_seed(3)
    x = torch.rand((n, 3), generator=g) * 0.8 + 0.1
    d = torch.rand((n, 3), generator=g)
    coef = [torch.randn(shape, generator=g) for shape in ((n, 3), (n,), (n, 3))]
    params = init_field(torch.Generator().manual_seed(0), cfg.field)
    # Tables large enough that the grid features matter.
    params["hashgrid"] = [t * 1e3 for t in params["hashgrid"]]

    def run(device):
        p = tree_map(lambda t: t.to(device).requires_grad_(True), params)
        out = field_forward(p, x.to(device), d.to(device), cfg.field)
        c_rgb, c_sdf, c_nrm = (c.to(device) for c in coef)
        s = ((out.rgb * c_rgb).sum() + (out.sdf * c_sdf).sum()
             + (out.normal * c_nrm).sum() + out.inv_s)
        grads = torch.autograd.grad(s, tree_leaves(p))
        return [t.detach().cpu() for t in (*out, *grads)]

    launches = segment_sum_launches()
    on_card, on_cpu = run("cuda"), run("cpu")
    if segment_sum_launches() != launches + 1:
        raise AssertionError("the field's backward on the card skipped the kernel")
    n_out, n_tables = 4, cfg.field.grid.n_levels
    worst = {"outputs": 0.0, "tables": 0.0, "mlp": 0.0}
    for i, (a, b) in enumerate(zip(on_card, on_cpu)):
        kind = "outputs" if i < n_out else ("tables" if i < n_out + n_tables else "mlp")
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"field check: bad tensor {i} {tuple(a.shape)}")
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
        worst[kind] = max(worst[kind], rel)
    limits = {"outputs": 1e-4, "tables": 1e-2, "mlp": 1e-3}
    if any(worst[k] > limits[k] for k in worst):
        raise AssertionError(f"field on the card disagrees with the CPU: {worst}")
    print("field_vs_cpu " + json.dumps(worst), flush=True)
    return worst


def training_phase(torch, tt, st, cfg, images, cams):
    """``train_static`` at full width: every step must launch the kernel.
    Returns the phase's numbers and the trained state."""
    state = tt.init_train_state(cfg, images.shape[0], seed=0, device="cuda")
    t0 = time.perf_counter()
    state = tt.occupancy_prior_sweep(state, cfg)
    torch.cuda.synchronize()
    prior_s = time.perf_counter() - t0

    losses, counted, launches_after = [], [], []

    def log(step, aux):
        losses.append(aux.loss)
        counted.append(aux.n_rays_counted)
        launches_after.append(st.segment_sum_rows.launches)

    torch.cuda.reset_peak_memory_stats()
    st.segment_sum_rows.launches = 0  # count the main path only
    state = tt.train_static(state, images, cams, cfg, WARMUP_STEPS, log_every=1, log_fn=log)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = tt.train_static(
        state, images, cams, cfg, TRAIN_STEPS - WARMUP_STEPS, log_every=1, log_fn=log
    )
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (TRAIN_STEPS - WARMUP_STEPS)
    launches = st.segment_sum_rows.launches

    losses = [float(x) for x in losses]
    counted = [float(x) for x in counted]
    if len(losses) != TRAIN_STEPS or not all(map(lambda v: v == v and abs(v) < 1e30, losses)):
        raise AssertionError(f"non-finite or missing losses: {losses}")
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    if not last < first:
        raise AssertionError(f"loss did not fall: first-10 mean {first}, last-10 {last}")
    prev = 0
    for i, n in enumerate(launches_after):
        if n <= prev:
            raise AssertionError(f"step {i} did not launch the segment-sum kernel")
        prev = n
    for leaf in [state.params["variance"], *state.params["hashgrid"]]:
        if not torch.isfinite(leaf).all():
            raise AssertionError("non-finite parameters after training")
    rays = sum(counted[WARMUP_STEPS:]) / (TRAIN_STEPS - WARMUP_STEPS)
    out = {
        "steps": TRAIN_STEPS, "ms_per_step": step_s * 1e3,
        "trained_rays_per_s": rays / step_s, "n_rays_counted_mean": rays,
        "loss_first10": first, "loss_last10": last,
        "launches": launches, "launches_per_step": launches / TRAIN_STEPS,
        "prior_sweep_s": prior_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "occupied_cells": int(state.occupancy.bitfield.sum()),
    }
    print("training_phase " + json.dumps(out), flush=True)
    return out, state


def profile_phase(torch, tt, state, images, cams, cfg, steps: int = PROFILE_STEPS) -> dict:
    """Where the step's time goes, after the main path's counts are read:
    ``steps`` steps timed on the host clock without a log callback, then
    as many traced with ``torch.profiler``.  The busy share is the traced
    window's device time over the untraced window's step time (the
    profiler slows the host, so the traced window's own wall time would
    understate it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = tt.train_static(state, images, cams, cfg, steps)
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t0) * 1e3 / steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tt.train_static(state, images, cams, cfg, steps)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in device) / 1e3 / steps
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time in the traced window")

    def top(evs, attr, k):
        return [{"name": e.key[:80], "ms_per_step": getattr(e, attr) / 1e3 / steps,
                 "calls_per_step": e.count / steps} for e in evs[:k]]

    out = {
        "steps": steps, "ms_per_step": ms_per_step,
        "device_ms_per_step": device_ms, "device_busy_share": device_ms / ms_per_step,
        "launches_per_step": sum(e.count for e in device) / steps,
        "h2d_copies_per_step": sum(e.count for e in device if "HtoD" in e.key) / steps,
        "top_device": top(device, "self_device_time_total", 10),
        "top_host": top(host, "self_cpu_time_total", 5),
    }
    print("profile_phase " + json.dumps(out), flush=True)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("CUDA is not available")
    if not (REPO / "neus2_tpu_torch" / "csrc").is_dir():
        return fail(f"the port's package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)

    from neus2_tpu_torch.api.testbed import config_from_json
    from neus2_tpu_torch.data.synthetic import make_sphere_dataset
    from neus2_tpu_torch.engine import train as tt
    from neus2_tpu_torch.ops import segment_tile as st
    from neus2_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all(verbose=True)
    print(f"build_s {time.perf_counter() - t0:.1f}", flush=True)

    cfg = config_from_json(REPO / "configs" / "base.json")
    k2 = kernel_phase(torch, st, cfg, 2)
    kernel_phase(torch, st, cfg, 8)
    field_agrees_with_cpu(torch, cfg)
    images, cams = make_sphere_dataset(n_views=16, resolution=256, seed=0).to_device("cuda")
    train, state = training_phase(torch, tt, st, cfg, images, cams)
    profile_phase(torch, tt, state, images, cams, cfg)

    kernels = [{
        "name": "segment_sum_rows",
        "route": "cuda",
        "source": "neus2_tpu_torch/csrc/segment_sum.cu",
        "replaces": "neus2_tpu/ops/segment_tile.py:376",
        "launches": train["launches"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["kernel_ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
        "sort_ms": k2["sort_ms"],
        "launches_per_step": train["launches_per_step"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
