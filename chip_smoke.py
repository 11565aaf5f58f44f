#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``neus2_tpu_torch/csrc`` from source and holds
each of the four segment-sum kernels against its plain PyTorch version at
the shapes its path gives it (``kernel_phase`` for kernel 1,
``kernel_phase_sorted`` for kernels 2-4).  Then it drives each path that
runs them, with the launch counts set to 0 just before and read just after:

  * ``op_path_phase``: the segment-sum op layer (``segment_dense_sum`` and
    the sorted-stream entry points of ``ops/segment_tile.py``), which runs
    kernels 2, 3 and 4;
  * ``training_phase``: ``train_static`` at full ``configs/base.json``
    width on a seeded synthetic sphere scene (kernel 1 on every step),
    after a check that the field and its gradients on the card agree with
    the CPU; a ``torch.profiler`` trace of a few more steps follows
    (``profile_phase``);
  * ``testbed_phase``: the static Testbed at the same width, as a user
    runs it: load the scene, ``while tb.frame()``, render two held-out
    views at the eval protocol and score PSNR / SSIM, export the
    marching-cubes mesh.

Exits non-zero on any failure; the last line of a successful run is the
device JSON, the line before it the ``kernels`` JSON.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
TRAIN_STEPS = 150
WARMUP_STEPS = 20
PROFILE_STEPS = 20
SCENE_RES = 256  # the synthetic scenes' image side
TESTBED_STEPS = 200
EVAL_SPP = 8
MESH_RES = 256
# The batched layouts' index padding past each level's M updates, as the
# JAX package pads them (round_up(M, 128) + 2 * chunk).
STREAM_PAD = 4096


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def segment_sum_launches() -> int:
    from neus2_tpu_torch.ops.segment_tile import segment_sum_rows

    return segment_sum_rows.launches


def reset_launches(st) -> None:
    for k in st.KERNELS:
        k.launches = 0


def bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    """(least ms the card could take, what bounds it) at the data-sheet rates."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def max_level_err(torch, name: str, got, again, ref) -> float:
    """Two launches equal bitwise, and every level within 1e-5 * max|ref| +
    1e-7 of the plain version.  The results are lists of per-level
    tensors, 3-D tensors with the level first, or one level's 2-D tensor."""
    torch.cuda.synchronize()
    if torch.is_tensor(got) and got.dim() == 2:
        got, again, ref = [got], [again], [ref]
    if len(got) != len(ref):
        raise AssertionError(f"{name}: {len(got)} levels vs {len(ref)}")
    err = 0.0
    for lvl, (g, a, r) in enumerate(zip(got, again, ref)):
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name} level {lvl}: bad output {tuple(g.shape)} "
                                 f"vs {tuple(r.shape)}")
        if not torch.equal(g, a):
            raise AssertionError(f"{name} level {lvl}: two launches differ bitwise")
        d = float((g - r).abs().max())
        tol = 1e-5 * float(r.abs().max()) + 1e-7
        if d > tol:
            raise AssertionError(f"{name} level {lvl}: max|diff| {d} > {tol}")
        err = max(err, d)
    return err


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
    err = max_level_err(torch, "segment_sum_rows", st.segment_sum_all_levels(idx, upd, sizes),
                        st.segment_sum_all_levels(idx, upd, sizes),
                        st.segment_sum_all_levels_ref(idx, upd, sizes))

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
    bound_ms, bound_by = bound(bytes_moved, n_upd * f)
    out = {
        "F": f, "levels": len(sizes), "updates_per_level": m, "rows": n_rows,
        "max_abs_err": err, "kernel_ms": kernel_ms, "sort_ms": sort_ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "bytes": bytes_moved,
    }
    print("kernel_phase " + json.dumps(out), flush=True)
    return out


def sorted_streams(torch, cfg, f: int, seed: int):
    """The batched layout at the hash grid's shapes: every level's M
    updates (idx (L, M) int32, upd (L, M, F) fp32) into tables of
    n_rows = the largest level's rows."""
    _, _, _, sizes, use_hash = cfg.field.grid.level_tables()
    m = cfg.n_rays * cfg.samples_per_ray * 8
    idx, upd = segment_sum_inputs(torch, sizes, use_hash, m, f, seed)
    return torch.stack(idx).to(torch.int32), torch.stack(upd), max(sizes)


def sort_and_pad(torch, st, idx, upd):
    """Each level's stream sorted, then padded with ``PAD_IDX`` and zeros
    to Mp = M + STREAM_PAD -> (idx (L, Mp), upd (L, Mp, F))."""
    n_levels, _, f = upd.shape
    idx_s, order = torch.sort(idx, dim=-1, stable=True)
    upd_s = torch.gather(upd, 1, order[..., None].expand(-1, -1, f))
    pad_i = torch.full((n_levels, STREAM_PAD), st.PAD_IDX, dtype=idx.dtype, device=idx.device)
    pad_u = upd.new_zeros((n_levels, STREAM_PAD, f))
    return torch.cat([idx_s, pad_i], 1), torch.cat([upd_s, pad_u], 1)


def kernel_phase_sorted(torch, st, cfg, f: int, with_planar: bool) -> dict:
    """Kernels 2 and 3 (and, with ``with_planar``, kernel 4) against their
    plain versions on the same sorted inputs, with their times.  Bytes
    counted: each real update's payload read once (the padding is never
    read), the (n_rows + 1) int32 row bounds of each level, each fp32
    output row written once; operations: one fp32 add per update and
    channel.  ``library_ms``: per-level ``index_add_`` of the same
    (rounded) payload into an fp32 table."""
    idx, upd, n_rows = sorted_streams(torch, cfg, f, seed=20 + f)
    n_levels, m, _ = upd.shape
    idx_p, upd_p = sort_and_pad(torch, st, idx, upd)
    bounds = st.row_bounds(idx_p, n_rows)
    idx_real = idx_p[:, :m].long()
    out_bytes = n_levels * ((n_rows + 1) * 4 + n_rows * f * 4)
    records = {}

    def library_for(vals_planar):  # (L, F, M) fp32, the payload as summed
        def run():
            for lvl in range(n_levels):
                torch.zeros((f, n_rows), device="cuda").index_add_(1, idx_real[lvl],
                                                                  vals_planar[lvl])
        return run

    # Kernel 3: fp32 planar, rounded to bf16 on load.
    vals = upd_p.transpose(1, 2).contiguous()  # (L, F, Mp)
    err = max_level_err(torch, "segment_sum_batched_rows",
                        st.segment_sum_batched_rows(bounds, vals),
                        st.segment_sum_batched_rows(bounds, vals),
                        st.sorted_segment_sum_tiles_batched_ref(idx_p, vals, n_rows))
    rounded = vals[:, :, :m].to(torch.bfloat16).float().contiguous()
    n_bytes = n_levels * m * 4 * f + out_bytes
    records["segment_sum_batched_rows"] = (err, n_bytes,
                                           lambda: st.segment_sum_batched_rows(bounds, vals),
                                           lambda: st.sorted_segment_sum_tiles_batched_ref(
                                               idx_p, vals, n_rows),
                                           library_for(rounded))

    # Kernel 2: packed bf16 pairs.
    p = (f + 1) // 2
    packed = st.pack_bf16_pairs(upd_p.reshape(-1, f)).reshape(n_levels, -1, p)
    packed = packed.transpose(1, 2).contiguous()  # (L, P, Mp)
    err = max_level_err(torch, "segment_sum_packed_rows",
                        st.segment_sum_packed_rows(bounds, packed),
                        st.segment_sum_packed_rows(bounds, packed),
                        st.sorted_segment_sum_tiles_packed_ref(idx_p, packed, n_rows))
    n_bytes = n_levels * m * 4 * p + out_bytes
    records["segment_sum_packed_rows"] = (err, n_bytes,
                                          lambda: st.segment_sum_packed_rows(bounds, packed),
                                          lambda: st.sorted_segment_sum_tiles_packed_ref(
                                              idx_p, packed, n_rows),
                                          library_for(rounded))

    if with_planar:
        # Kernel 4: ONE hashed level, fp32 exact.
        lvl = n_levels - 1
        i4, v4 = idx_p[lvl, :m].contiguous(), vals[lvl, :, :m].contiguous()
        b4, i4_long = st.row_bounds(i4, n_rows), i4.long()
        err = max_level_err(torch, "segment_sum_planar_rows",
                            st.segment_sum_planar_rows(b4, v4),
                            st.segment_sum_planar_rows(b4, v4),
                            st.sorted_segment_sum_tiles_ref(i4, v4, n_rows))
        n_bytes = m * 4 * f + (n_rows + 1) * 4 + n_rows * f * 4
        records["segment_sum_planar_rows"] = (
            err, n_bytes, lambda: st.segment_sum_planar_rows(b4, v4),
            lambda: st.sorted_segment_sum_tiles_ref(i4, v4, n_rows),
            lambda: torch.zeros((f, n_rows), device="cuda").index_add_(1, i4_long, v4),
        )

    out = {}
    for name, (err, n_bytes, kernel, plain, library) in records.items():
        n_upd = m * (1 if name == "segment_sum_planar_rows" else n_levels)
        bound_ms, bound_by = bound(n_bytes, n_upd * f)
        out[name] = {
            "F": f, "levels": 1 if name == "segment_sum_planar_rows" else n_levels,
            "updates_per_level": m, "rows": n_rows, "max_abs_err": err,
            "kernel_ms": cuda_ms(torch, kernel), "plain_ms": cuda_ms(torch, plain, iters=3),
            "library_ms": cuda_ms(torch, library, iters=5), "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": n_bytes,
        }
        print(f"kernel_phase_sorted {name} " + json.dumps(out[name]), flush=True)
    return out


def op_path_phase(torch, st, sc, cfg) -> dict:
    """The segment-sum op layer through its entry points, at the hash
    grid's shapes (F=2): ``segment_dense_sum`` with "auto" on a hashed
    level (-> sort + kernel 4) and with "sort" (plain torch ops),
    ``segment_sum_sorttile_batched`` with and without packing (-> kernel
    3) and ``sorted_segment_sum_tiles_packed`` (-> kernel 2).  Each result
    is held against an exact float64 sum of the payload as the entry point
    rounds it (bf16 for the packed and batched paths); the "sort" method
    carries fp32 cancellation and is held to |err| < 0.05, as the JAX
    package's test of it is.  Returns the counts and the entry points'
    times beside one ``index_add_``."""
    f = 2
    idx, upd, n_rows = sorted_streams(torch, cfg, f, seed=31)
    n_levels, m, _ = upd.shape
    lvl = n_levels - 1  # a hashed level: uniform indices over 2^19 rows
    i1, u1 = idx[lvl], upd[lvl]
    i1_long = i1.long()

    def exact(i, u, rows):  # float64 sums, cast to fp32
        return torch.zeros((rows, u.shape[-1]), dtype=torch.float64, device="cuda").index_add_(
            0, i.long(), u.double()).float()

    def bf16(x):
        return x.to(torch.bfloat16).float()

    def packed_sorted():
        idx_p, upd_p = sort_and_pad(torch, st, idx, upd)
        pk = st.pack_bf16_pairs(upd_p.reshape(-1, f)).reshape(n_levels, -1, 1)
        return idx_p, pk.transpose(1, 2).contiguous()

    idx_p, pk = packed_sorted()
    torch.cuda.synchronize()
    reset_launches(st)
    got = {
        "dense_auto": sc.segment_dense_sum(i1, u1, n_rows, method="auto", uniform_hint=True),
        "dense_sort": sc.segment_dense_sum(i1, u1, n_rows, method="sort"),
        "batched_pack": st.segment_sum_sorttile_batched(idx, upd, n_rows, pack=True),
        "batched_fp32": st.segment_sum_sorttile_batched(idx, upd, n_rows, pack=False),
        "packed": st.sorted_segment_sum_tiles_packed(idx_p, pk, n_rows),
    }
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in st.KERNELS}
    for name in ("segment_sum_packed_rows", "segment_sum_batched_rows", "segment_sum_planar_rows"):
        if launches[name] == 0:
            raise AssertionError(f"the op path never launched {name}: {launches}")

    ref_levels = torch.stack([exact(idx[l], bf16(upd[l]), n_rows) for l in range(n_levels)])
    checks = {
        "dense_auto": (exact(i1, bf16(u1), n_rows), None),
        "dense_sort": (exact(i1, u1, n_rows), 0.05),
        "batched_pack": (ref_levels, None),
        "batched_fp32": (ref_levels, None),
        "packed": (ref_levels, None),
    }
    errs = {}
    for name, (ref, abs_tol) in checks.items():
        g = got[name]
        if g.shape != ref.shape or not torch.isfinite(g).all():
            raise AssertionError(f"op path {name}: bad output {tuple(g.shape)}")
        d = float((g - ref).abs().max())
        tol = abs_tol if abs_tol is not None else 1e-5 * float(ref.abs().max()) + 1e-7
        if d > tol:
            raise AssertionError(f"op path {name}: max|diff| {d} > {tol}")
        errs[name] = d

    out = {
        "launches": launches, "max_abs_err": errs,
        "dense_auto_ms": cuda_ms(torch, lambda: sc.segment_dense_sum(
            i1, u1, n_rows, method="auto", uniform_hint=True), iters=5),
        "dense_sort_ms": cuda_ms(torch, lambda: sc.segment_dense_sum(
            i1, u1, n_rows, method="sort"), iters=5),
        "dense_index_add_ms": cuda_ms(torch, lambda: torch.zeros(
            (n_rows, f), device="cuda").index_add_(0, i1_long, u1), iters=5),
        "batched_pack_ms": cuda_ms(torch, lambda: st.segment_sum_sorttile_batched(
            idx, upd, n_rows, pack=True), iters=5),
    }
    print("op_path_phase " + json.dumps(out), flush=True)
    return out


def testbed_phase(torch, st, cfg, hyper, steps: int = TESTBED_STEPS) -> dict:
    """The static Testbed at full width, as a user drives it: load a
    16-view 256^2 synthetic sphere scene, ``while tb.frame()``, render two
    held-out views at the eval protocol (spp 8, black background, min
    transmittance 1e-4) and score them, export the mesh at 256^3.

    Fails unless kernel 1 ran once per training step, the loss is finite
    and fell, each held-out PSNR beats the all-black image's, and the mesh
    is a closed surface around the sphere (> 1000 triangles, median vertex
    radius in (0.15, 0.45) of the centre)."""
    import numpy as np

    from neus2_tpu_torch.api.testbed import Testbed
    from neus2_tpu_torch.data.synthetic import make_sphere_dataset
    from neus2_tpu_torch.engine.mesh import sdf_grid
    from neus2_tpu_torch.engine.render import RenderConfig, render_image
    from neus2_tpu_torch.native import marching_cubes
    from neus2_tpu_torch.ops.image import psnr, srgb_eval_target, ssim
    from neus2_tpu_torch.ops.warp import scene_aabb

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tb = Testbed(config=cfg,
                 hyper=dataclasses.replace(hyper, first_frame_max_training_step=steps),
                 seed=0, device="cuda")
    tb.load_training_data_from_datasets([make_sphere_dataset(n_views=16, resolution=SCENE_RES, seed=0)])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    reads, launches_after = [], []
    torch.cuda.synchronize()
    reset_launches(st)
    t0 = time.perf_counter()
    while tb.frame():
        launches_after.append(st.segment_sum_rows.launches)
        if tb.training_step % 16 == 0 or tb.training_step == 1:
            reads.append((tb.loss_scalar, tb.last_aux.n_rays_counted))
        if tb.training_step == WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (steps - WARMUP_STEPS)
    launches = st.segment_sum_rows.launches

    if tb.training_step != steps or launches_after != list(range(1, steps + 1)):
        raise AssertionError(f"Testbed: {tb.training_step} steps, {launches} kernel launches")
    losses = [r[0] for r in reads]
    if not all(v == v and abs(v) < 1e30 for v in losses):
        raise AssertionError(f"Testbed: non-finite losses {losses}")
    if not sum(losses[-2:]) / 2 < losses[0]:
        raise AssertionError(f"Testbed: the loss did not fall: {losses}")

    tb.prepare_for_test()
    held = make_sphere_dataset(n_views=2, resolution=SCENE_RES, seed=1)
    images, cams = held.to_device("cuda")
    rcfg = RenderConfig(field=tb.config.field, aabb_scale=tb.config.aabb_scale,
                        min_transmittance=1e-4)
    views = []
    for i in range(held.n_images):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb, _, _ = render_image(tb.state.ema_params, tb.effective_acc, tb.state.occupancy,
                                 cams, cams.poses[i], cams.focal[i], cams.principal[i],
                                 torch.Generator(device="cuda").manual_seed(i), rcfg,
                                 background=0.0, spp=EVAL_SPP)
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        target = srgb_eval_target(images[i])
        v = {"psnr": float(psnr(rgb, target)), "ssim": float(ssim(rgb, target)),
             "black_psnr": float(psnr(torch.zeros_like(target), target)),
             "render_ms": render_s * 1e3}
        if not (torch.isfinite(rgb).all() and v["psnr"] > v["black_psnr"]):
            raise AssertionError(f"Testbed: held-out view {i} {v}")
        views.append(v)

    box = scene_aabb(tb.config.aabb_scale)
    params = tb.state.ema_params
    sdf_ms = cuda_ms(torch, lambda: sdf_grid(params, tb.config.field, box.lo, box.hi, box.lo,
                                             box.diag, resolution=MESH_RES), iters=2, warmup=1)
    grid = sdf_grid(params, tb.config.field, box.lo, box.hi, box.lo, box.diag,
                    resolution=MESH_RES).cpu().numpy()
    t0 = time.perf_counter()
    marching_cubes(grid)
    mc_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        verts, tris = tb.compute_and_save_marching_cubes_mesh(Path(d) / "mesh.ply",
                                                              resolution=MESH_RES)
        export_s = time.perf_counter() - t0
    radius = float(np.median(np.linalg.norm(verts - 0.5, axis=-1))) if len(verts) else 0.0
    if len(tris) <= 1000 or not 0.15 < radius < 0.45:
        raise AssertionError(f"Testbed mesh: {len(tris)} triangles, median radius {radius}")

    w, h = held.resolution
    rays = sum(r[1] for r in reads) / len(reads)
    out = {
        "steps": steps, "load_s": load_s, "ms_per_step": step_s * 1e3,
        "trained_rays_per_s": rays / step_s, "n_rays_counted_mean": rays,
        "loss_reads": losses, "launches": launches, "launches_per_step": launches / steps,
        "batch_bucket": tb.batch_bucket, "views": views,
        "render_ms_per_image": sum(v["render_ms"] for v in views) / len(views),
        "rendered_rays_per_s": w * h * EVAL_SPP * len(views)
        / (sum(v["render_ms"] for v in views) / 1e3),
        "sdf_grid_ms": sdf_ms, "marching_cubes_s": mc_s, "mesh_export_s": export_s,
        "mesh_triangles": int(len(tris)), "mesh_median_radius": radius,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "meters": tb.meters.summary(),
    }
    print("testbed_phase " + json.dumps(out), flush=True)
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
    reset_launches(st)  # count the main path only
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
    from neus2_tpu_torch.ops import scatter as sc
    from neus2_tpu_torch.ops import segment_tile as st
    from neus2_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all(verbose=True)
    print(f"build_s {time.perf_counter() - t0:.1f}", flush=True)

    cfg, hyper = config_from_json(REPO / "configs" / "base.json")
    k1 = kernel_phase(torch, st, cfg, 2)
    kernel_phase(torch, st, cfg, 8)
    sorted_k = kernel_phase_sorted(torch, st, cfg, 2, with_planar=True)
    kernel_phase_sorted(torch, st, cfg, 8, with_planar=False)
    ops = op_path_phase(torch, st, sc, cfg)
    field_agrees_with_cpu(torch, cfg)
    images, cams = make_sphere_dataset(n_views=16, resolution=SCENE_RES, seed=0).to_device("cuda")
    train, state = training_phase(torch, tt, st, cfg, images, cams)
    profile_phase(torch, tt, state, images, cams, cfg)
    del state, images, cams
    tb = testbed_phase(torch, st, cfg, hyper)

    def entry(name, replaces, rec, launches):
        return {
            "name": name, "route": "cuda", "source": "neus2_tpu_torch/csrc/segment_sum.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        }

    kernels = [
        {**entry("segment_sum_rows", "neus2_tpu/ops/segment_tile.py:376", k1, tb["launches"]),
         "sort_ms": k1["sort_ms"], "launches_per_step": tb["launches_per_step"],
         "train_static_launches": train["launches"]},
    ] + [
        entry(name, replaces, sorted_k[name], ops["launches"][name])
        for name, replaces in (
            ("segment_sum_packed_rows", "neus2_tpu/ops/segment_tile.py:376"),
            ("segment_sum_batched_rows", "neus2_tpu/ops/segment_tile.py:211"),
            ("segment_sum_planar_rows", "neus2_tpu/ops/segment_tile.py:75"),
        )
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
