#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``neus2_tpu_torch/csrc`` from source and holds
each of the four segment-sum kernels against its plain PyTorch version at
the shapes its path gives it, at F=2 and F=8 (``kernel_phase`` for kernel
1, ``kernel_phase_sorted`` for kernels 2-4), timed with CUDA events over
back-to-back calls (``cuda_ms``; kernel 4 and its ``index_add_`` also with
the card held until every call is queued).  Then it drives each path that
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
    marching-cubes mesh;
  * ``snapshot_phase``: on that trained Testbed, a native snapshot saved,
    loaded into a fresh Testbed (every leaf and a render bitwise) and
    resumed for 20 steps (kernel 1 once a step, losses bitwise the
    original's), a reference-format export, import and re-export (byte-equal
    blobs) with 5 steps from it, and the pyngp ``render(width, height)``;
  * ``dynamic_phase``: the dynamic Testbed at the same width with the
    error map and its sharpness weighting on, over a 3-frame scene of a
    sphere moved by a known shift a frame: per-frame pose refinement (no
    kernel-1 launch), then the finetune phase (one a step), a held-out
    view scored per frame, the canonical mesh at the end;
  * ``camera_phase``: the static Testbed at the same width with the whole
    learned camera group on (extrinsics, exposure and focal refinement,
    the envmap and distortion grid, the per-ray max level, depth
    supervision), loaded from files written with known camera errors:
    kernel 1 once a step, the errors before and after, a held-out view and
    a tonemapped render;
  * ``lens_phase``: the static Testbed at the same width with fp16 image
    storage, loaded from files traced through a Brown-Conrady lens (PNG
    and half-float EXR frames of two sizes): kernel 1 once a step, the
    held-out views scored with the lens and without it, then 20 steps each
    of a rolling-shutter, an FTheta and a per-pixel ray-file scene;
  * ``bf16_phase``: the Testbed phase's run with bf16 compute, after a
    check that the bf16 field on the card agrees with the CPU's: kernel 1
    once a step and the held-out PSNR beside the fp32 run's.

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
RESUME_STEPS = 20  # snapshot_phase: steps after a native resume
REFERENCE_STEPS = 5  # and after a reference-format import
DYNAMIC_FRAMES = 3
DYNAMIC_STEPS = 200  # first_frame_ and next_frame_max_training_step
# The known per-frame motion: base.json's delta lr (1e-4 a step and DoF)
# can cover it within a frame's 50 refinement steps.
DYNAMIC_SHIFT = (0.005, 0.0, 0.0)
# Traced windows of PROFILE_WINDOW steps from these frame-local steps: in
# frames >= 1 one in pose refinement (steps 0-49) and one in finetune.
DYNAMIC_PROFILE_AT = (10, 100)
PROFILE_WINDOW = 8
CAMERA_STEPS = 300
CAMERA_PROFILE_AT = 200  # host window, then the traced window, from this step
# The camera phase's scene errors: per-view translation offsets and
# exposure stops (both made zero-mean over the views), the stated focal.
CAMERA_TRANS_SIGMA = 0.005
CAMERA_EXPOSURE_STOPS = 0.3
CAMERA_FOCAL_FACTOR = 1.02
CAMERA_DEPTH_SCALE = 1e-4  # integer_depth_scale of the uint16 depth PNGs
CAMERA_DEPARTURES = dict(optimize_extrinsics=True, optimize_exposure=True,
                         optimize_focal_length=True, max_level_rand_training=True,
                         use_envmap=True, use_distortion=True, depth_supervision_lambda=0.1)
LENS_STEPS = 200
TESTBED_PROFILE_AT = 100
LENS_K = (-0.1, 0.02, 0.001, -0.001)  # k1, k2, p1, p2 of lens_phase's scenes
CAMERA_MODEL_STEPS = 20  # lens_phase's rolling-shutter, FTheta and ray-file runs
ROLLING_SHUTTER = (0.0, 0.0, 0.5)
ROLLING_SHIFT = (0.02, 0.0, 0.0)  # the end-of-exposure pose's translation, ngp units
FTHETA_P1 = 3.5e-3  # alpha = p1 r, r in lens pixels of a 256 x 256 lens
BF16_PSNR_MARGIN = 0.3  # dB, tests/test_train_e2e.py::test_bf16_compute_quality_parity
# The bf16 field on the card against the CPU's bf16 path, each within this
# share of its max: a hidden activation or tangent that cuBLAS's summation
# order moves across a bf16 rounding boundary moves it by one bf16 ulp
# (2^-8 of itself), so outputs move up to ~1e-3 (3.0e-4 seen on an H100)
# where bf16 itself moves them ~1e-2; the MLP gradients read 7.8e-4 on an
# H100, so 2e-3; the table gradients as field_agrees_with_cpu's fp32 bound.
BF16_FIELD_LIMITS = {"outputs": 1e-3, "tables": 1e-2, "mlp": 2e-3}
EVAL_SPP = 8
MESH_RES = 256
# The batched layouts' index padding past each level's M updates, as the
# JAX package pads them (round_up(M, 128) + 2 * chunk).
STREAM_PAD = 4096
HOLD_CYCLES = 40_000_000  # ~20 ms of spinning at the H100's clock (cuda_ms's hold)


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


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3, hold: bool = False) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.  With
    ``hold``, a spin kernel queued first holds the card until the host has
    queued every call, so a call whose host-side work outlasts its kernels
    is timed by the card alone (its device time), not by the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
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

    n_upd, n_rows = len(sizes) * m, sum(sizes)
    keys, payload = st.sort_updates(idx, upd, sizes)
    kernel_ms = cuda_ms(torch, lambda: st.segment_sum_rows(keys, payload, n_rows))
    sort_ms = cuda_ms(torch, lambda: st.sort_updates(idx, upd, sizes))
    plain_ms = cuda_ms(torch, lambda: st.segment_sum_all_levels_ref(idx, upd, sizes), iters=5)
    quant = [u.to(torch.bfloat16).float() for u in upd]

    def library():
        for i, u, s in zip(idx, quant, sizes):
            torch.zeros((s, f), device="cuda").index_add_(0, i, u)

    library_ms = cuda_ms(torch, library)
    # The timed kernel reads the sorted int32 keys and bf16 payload once and
    # writes every fp32 row once; the sort in front of it (sort, cast, cat,
    # gather) is timed apart (sort_ms).
    bytes_moved = n_upd * 4 + n_upd * 2 * f + n_rows * f * 4
    bound_ms, bound_by = bound(bytes_moved, n_upd * f)
    out = {
        "F": f, "levels": len(sizes), "updates_per_level": m, "rows": n_rows,
        "max_abs_err": err, "kernel_ms": kernel_ms,
        "sort_ms": sort_ms, "sort_plus_kernel_ms": sort_ms + kernel_ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": bytes_moved,
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


def kernel_phase_sorted(torch, st, cfg, f: int) -> dict:
    """Kernels 2, 3 and 4 against their plain versions on the same sorted
    inputs, with their times.  Bytes counted: for kernels 2 and 3 each
    level's Mp int32 keys (the padding included: the kernel reads keys to
    find where a level's updates end) and its M real updates' payload, for
    kernel 4 its M int32 keys and payload, each fp32 output row written
    once; operations: one fp32 add per update and channel.  ``library_ms``:
    per-level ``index_add_`` of the same (rounded) payload into an fp32
    table; ``entry_ms`` (kernels 2 and 3): the entry point from sorted
    inputs, whatever runs in front of its kernel."""
    idx, upd, n_rows = sorted_streams(torch, cfg, f, seed=20 + f)
    n_levels, m, _ = upd.shape
    idx_p, upd_p = sort_and_pad(torch, st, idx, upd)
    m_pad = idx_p.shape[1]
    vals = upd_p.transpose(1, 2).contiguous()  # (L, F, Mp)
    packed = st.pack_bf16_pairs(upd_p.reshape(-1, f)).reshape(n_levels, m_pad, -1)
    packed = packed.transpose(1, 2).contiguous()  # (L, P, Mp)
    entries = {
        "segment_sum_packed_rows": lambda: st.sorted_segment_sum_tiles_packed(
            idx_p, packed, n_rows),
        "segment_sum_batched_rows": lambda: st.sorted_segment_sum_tiles_batched(
            idx_p, vals, n_rows),
    }
    idx_real = idx_p[:, :m].long()
    out_bytes = n_levels * (m_pad * 4 + n_rows * f * 4)
    records = {}

    def library_for(vals_planar):  # (L, F, M) fp32, the payload as summed
        def run():
            for lvl in range(n_levels):
                torch.zeros((f, n_rows), device="cuda").index_add_(1, idx_real[lvl],
                                                                  vals_planar[lvl])
        return run

    # Kernel 3: fp32 planar, rounded to bf16 on load.
    err = max_level_err(torch, "segment_sum_batched_rows",
                        st.segment_sum_batched_rows(idx_p, vals, n_rows),
                        st.segment_sum_batched_rows(idx_p, vals, n_rows),
                        st.sorted_segment_sum_tiles_batched_ref(idx_p, vals, n_rows))
    rounded = vals[:, :, :m].to(torch.bfloat16).float().contiguous()
    n_bytes = n_levels * m * 4 * f + out_bytes
    records["segment_sum_batched_rows"] = (err, n_bytes,
                                           lambda: st.segment_sum_batched_rows(idx_p, vals, n_rows),
                                           lambda: st.sorted_segment_sum_tiles_batched_ref(
                                               idx_p, vals, n_rows),
                                           library_for(rounded))

    # Kernel 2: packed bf16 pairs.
    err = max_level_err(torch, "segment_sum_packed_rows",
                        st.segment_sum_packed_rows(idx_p, packed, n_rows),
                        st.segment_sum_packed_rows(idx_p, packed, n_rows),
                        st.sorted_segment_sum_tiles_packed_ref(idx_p, packed, n_rows))
    n_bytes = n_levels * m * 4 * packed.shape[1] + out_bytes
    records["segment_sum_packed_rows"] = (err, n_bytes,
                                          lambda: st.segment_sum_packed_rows(idx_p, packed, n_rows),
                                          lambda: st.sorted_segment_sum_tiles_packed_ref(
                                              idx_p, packed, n_rows),
                                          library_for(rounded))

    # Kernel 4: ONE hashed level, fp32 exact, from its sorted keys.
    lvl = n_levels - 1
    i4, v4 = idx_p[lvl, :m].contiguous(), vals[lvl, :, :m].contiguous()
    i4_long = i4.long()
    err = max_level_err(torch, "segment_sum_planar_rows",
                        st.segment_sum_planar_rows(i4, v4, n_rows),
                        st.segment_sum_planar_rows(i4, v4, n_rows),
                        st.sorted_segment_sum_tiles_ref(i4, v4, n_rows))
    n_bytes = m * 4 + m * 4 * f + n_rows * f * 4
    records["segment_sum_planar_rows"] = (
        err, n_bytes, lambda: st.segment_sum_planar_rows(i4, v4, n_rows),
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
        if name in entries:
            out[name]["entry_ms"] = cuda_ms(torch, entries[name])
        if name == "segment_sum_planar_rows":  # 20 us calls: their device time too
            out[name]["held_ms"] = cuda_ms(torch, kernel, hold=True)
            out[name]["library_held_ms"] = cuda_ms(torch, library, iters=5, hold=True)
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

    Host ms a step over the steps after WARMUP_STEPS; host and device ms a
    step and device launches a step over ``run_testbed``'s windows from
    TESTBED_PROFILE_AT, the baseline of lens_phase and bf16_phase.

    Fails unless kernel 1 ran once per training step, the loss is finite
    and fell, each held-out PSNR beats the all-black image's, and the mesh
    is a closed surface around the sphere (> 1000 triangles, median vertex
    radius in (0.15, 0.45) of the centre)."""
    import numpy as np

    from neus2_tpu_torch.api.testbed import Testbed
    from neus2_tpu_torch.data.synthetic import make_sphere_dataset
    from neus2_tpu_torch.engine.mesh import sdf_grid
    from neus2_tpu_torch.native import marching_cubes
    from neus2_tpu_torch.ops.warp import scene_aabb

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tb = Testbed(config=cfg,
                 hyper=dataclasses.replace(hyper, first_frame_max_training_step=steps),
                 seed=0, device="cuda")
    tb.load_training_data_from_datasets([make_sphere_dataset(n_views=16, resolution=SCENE_RES, seed=0)])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    n_rays = []

    def read_rays(tb):
        if tb.training_step % 16 == 0 or tb.training_step == 1:
            n_rays.append(tb.last_aux.n_rays_counted)

    run_out = run_testbed(torch, st, tb, TESTBED_PROFILE_AT, on_step=read_rays)
    losses = run_out["loss_reads"]
    if tb.training_step != steps:
        raise AssertionError(f"Testbed: {tb.training_step} steps of {steps}")
    if not sum(losses[-2:]) / 2 < losses[0]:
        raise AssertionError(f"Testbed: the loss did not fall: {losses}")

    tb.prepare_for_test()
    views = held_out_views(torch, tb, "Testbed")

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

    w = h = SCENE_RES
    rays = sum(n_rays) / len(n_rays)
    out = {
        **run_out, "load_s": load_s,
        "trained_rays_per_s": rays / run_out["ms_per_step"] * 1e3, "n_rays_counted_mean": rays,
        "launches_per_step": run_out["launches"] / steps, "views": views,
        "render_ms_per_image": sum(v["render_ms"] for v in views) / len(views),
        "rendered_rays_per_s": w * h * EVAL_SPP * len(views)
        / (sum(v["render_ms"] for v in views) / 1e3),
        "sdf_grid_ms": sdf_ms, "marching_cubes_s": mc_s, "mesh_export_s": export_s,
        "mesh_triangles": int(len(tris)), "mesh_median_radius": radius,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "meters": tb.meters.summary(),
    }
    print("testbed_phase " + json.dumps(out), flush=True)
    return out, tb


class LossRecorder:
    """Wraps the Testbed module's ``train_step`` to keep each step's loss
    tensor (no host sync), leaving the step as it is."""

    def __init__(self, testbed_module):
        self.module, self.step, self.losses = testbed_module, testbed_module.train_step, []

    def __enter__(self):
        def recorded(*args, **kw):
            state, aux = self.step(*args, **kw)
            self.losses.append(aux.loss)
            return state, aux

        self.module.train_step = recorded
        return self

    def __exit__(self, *exc):
        self.module.train_step = self.step


def snapshot_phase(torch, st, tb) -> dict:
    """Snapshots and the pyngp surface on ``testbed_phase``'s trained
    Testbed, as a user saves, resumes and renders a model:

      * a full and an incremental native snapshot, the full one loaded
        into a fresh card Testbed: every leaf (the step generator's state
        too) and ``render(img_idx=0)`` bitwise the original's;
      * RESUME_STEPS more steps on the original and on the resumed
        Testbed, counts reset before each: kernel 1 once a step, finite
        losses, the losses and the final states bitwise equal;
      * a reference-format export loaded into a third Testbed and exported
        again: ``n_params`` as ``ngp_n_params`` says, both blobs byte-equal,
        then REFERENCE_STEPS steps from it, kernel 1 once a step;
      * ``render(256, 256, 4)`` at training view 1's camera (the views are
        SCENE_RES^2) within 1e-5 of
        ``render(img_idx=1, spp=4)``, and one ``render(512, 512, 1)`` from
        an orbit pose, timed with CUDA events and on the host clock."""
    import numpy as np

    from neus2_tpu_torch import interop
    from neus2_tpu_torch.api import msgpack_codec
    from neus2_tpu_torch.api import testbed as testbed_mod
    from neus2_tpu_torch.api.ngp_snapshot import ngp_n_params, save_reference_snapshot
    from neus2_tpu_torch.data.dataset import ngp_matrix_to_nerf
    from neus2_tpu_torch.data.synthetic import make_sphere_dataset
    from neus2_tpu_torch.utils.camera_path import orbit_path

    # The bucket is host state no snapshot holds, in either package.
    bucket_fields = ("batch_bucket", "_occ_len_ema", "_bucket_votes", "_bucket_vote_target",
                     "last_aux")
    print("snapshot_phase departures: the resumed Testbed takes the original's host-only "
          f"batch-bucket state {list(bucket_fields)} before the resumed steps", flush=True)

    def fresh():
        t = testbed_mod.Testbed(config=tb.config, hyper=dataclasses.replace(tb.hyper),
                                seed=tb.seed, device="cuda")
        t.load_training_data_from_datasets(
            [make_sphere_dataset(n_views=16, resolution=SCENE_RES, seed=0)])
        return t

    def same_leaves(a, b, what):
        x, y = interop.state_to_pathdict(a.state), interop.state_to_pathdict(b.state)
        if x.keys() != y.keys():
            raise AssertionError(f"{what}: the leaf keys differ")
        for k in x:
            if x[k].dtype != y[k].dtype or not np.array_equal(x[k], y[k]):
                raise AssertionError(f"{what}: leaf {k} differs")
        return len(x)

    def train_on(t, steps):
        t.first_frame_max_training_step = t.training_step + steps
        torch.cuda.synchronize()
        reset_launches(st)
        with LossRecorder(testbed_mod) as rec:
            while t.frame():
                pass
        torch.cuda.synchronize()
        launches = st.segment_sum_rows.launches
        if launches != steps or len(rec.losses) != steps:
            raise AssertionError(f"{steps} steps: {len(rec.losses)} trained, {launches} "
                                 "kernel-1 launches")
        if not all(bool(torch.isfinite(v)) for v in rec.losses):
            raise AssertionError("non-finite resumed losses")
        return rec.losses, launches

    out = {}
    with tempfile.TemporaryDirectory() as d:
        full, inc = Path(d) / "full.msgpack", Path(d) / "incremental.msgpack"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tb.save_snapshot(full)
        out["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tb.save_snapshot(inc, incremental=True)
        out["save_incremental_s"] = time.perf_counter() - t0
        out["full_mb"], out["incremental_mb"] = full.stat().st_size / 1e6, inc.stat().st_size / 1e6
        resumed = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed.load_snapshot(full)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        out["leaves"] = same_leaves(tb, resumed, "native round trip")
        resumed.prepare_for_test()
        for a, b in zip(tb.render(img_idx=0), resumed.render(img_idx=0)):
            if not np.array_equal(a, b):
                raise AssertionError("native round trip: render(img_idx=0) differs")

        for name in bucket_fields:
            setattr(resumed, name, getattr(tb, name))
        out["batch_bucket"] = tb.batch_bucket
        original, n_orig = train_on(tb, RESUME_STEPS)
        again, n_res = train_on(resumed, RESUME_STEPS)
        if not all(torch.equal(a, b) for a, b in zip(original, again)):
            raise AssertionError("resume: the losses differ from the original's")
        same_leaves(tb, resumed, "resume")
        out["resume"] = {"steps": RESUME_STEPS, "launches_original": n_orig,
                         "launches_resumed": n_res, "losses": [float(v) for v in again]}
        del resumed

        ref, ref2 = Path(d) / "ref.msgpack", Path(d) / "ref2.msgpack"

        def export(t, path):
            save_reference_snapshot(
                path, interop.tree_to_numpy(t.state.ema_params), t.config.field,
                density_grid=t.state.occupancy.density.cpu().numpy(),
                acc=interop.tree_to_numpy(t.state.acc), aabb_scale=t.config.aabb_scale,
                training_step=t.training_step, loss=t.loss)
            return msgpack_codec.unpackb(path.read_bytes())["snapshot"]

        t0 = time.perf_counter()
        doc = export(tb, ref)
        out["reference_save_s"] = time.perf_counter() - t0
        out["reference_mb"] = ref.stat().st_size / 1e6
        imported = fresh()
        t0 = time.perf_counter()
        imported.load_snapshot(ref)
        torch.cuda.synchronize()
        out["reference_load_s"] = time.perf_counter() - t0
        doc2 = export(imported, ref2)
        want = ngp_n_params(tb.config.field)
        if not doc["n_params"] == doc2["n_params"] == want:
            raise AssertionError(f"reference n_params {doc['n_params']}, {doc2['n_params']}, "
                                 f"ngp_n_params {want}")
        for key in ("params_binary", "density_grid_binary"):
            if doc[key] != doc2[key]:
                raise AssertionError(f"reference re-export: {key} differs")
        losses, n_ref = train_on(imported, REFERENCE_STEPS)
        out["reference"] = {"n_params": want, "steps": REFERENCE_STEPS, "launches": n_ref,
                            "losses": [float(v) for v in losses]}
        del imported

    tb.set_camera_to_training_view(1)
    w, h = tb.dataset.resolution  # SCENE_RES^2
    img = tb.render(w, h, 4)
    rgb = tb.render(img_idx=1, spp=4)[0]
    err = float(np.abs(img[..., :3] - rgb).max())
    if img.shape != (h, w, 4) or not np.isfinite(img).all() or err > 1e-5:
        raise AssertionError(f"pyngp render {img.shape}: max|diff| {err} against render(img_idx=1)")
    kf = orbit_path().eval(0.125)
    ds = tb.dataset
    tb.set_nerf_camera_matrix(ngp_matrix_to_nerf(kf.pose, ds.scale,
                                                 np.asarray(ds.offset, np.float32), ds.from_na))
    tb.fov = kf.fov_deg
    tb.screen_center = (0.5, 0.5)
    tb.render(512, 512, 1)  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    orbit = tb.render(512, 512, 1)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    if orbit.shape != (512, 512, 4) or not np.isfinite(orbit).all() or orbit[..., 3].max() < 0.5:
        raise AssertionError(f"orbit render {orbit.shape}, max alpha {orbit[..., 3].max()}")
    out["pyngp"] = {"view1_max_abs_err": err, "render_512_ms": start.elapsed_time(end),
                    "render_512_host_ms": host_ms,
                    "orbit_alpha_mean": float(orbit[..., 3].mean())}
    print("snapshot_phase " + json.dumps(out), flush=True)
    return out


def dynamic_phase(torch, st, cfg, hyper) -> dict:
    """The dynamic Testbed at full width, as a user drives it: base.json's
    dynamic hyperparameters (pose refinement for 50 steps a frame, then
    field and delta together) with the error map and its sharpness
    weighting on, over ``DYNAMIC_FRAMES`` frames of 16 views at 256^2 in
    which the sphere moves by ``DYNAMIC_SHIFT`` a frame; ``while
    tb.frame()``, with ``on_frame_complete`` scoring one held-out view of
    the frame at the eval protocol and its pose; the canonical mesh at the
    end.  Times and kernel-1 launches per frame and phase ("frame0",
    "refine", "finetune"): host ms a step on the host clock and the span a
    step takes on the card between CUDA events around each ``frame()``
    call (both paced by the host, which is the bottleneck), and device ms
    a step, the card's busy time, from ``torch.profiler`` over windows of
    ``PROFILE_WINDOW`` steps (``DYNAMIC_PROFILE_AT``).  Traced steps, steps
    where the frame hook ran or the host fetched the scalars (every 16th),
    and the first 3 of each frame and phase are left out of the host and
    span times.

    Fails on a non-finite loss or transform, on any kernel-1 launch in a
    refinement step, on a step that trains the field without exactly one
    launch, and on a frame >= 1 whose pose error (|learned transition -
    true|) is not below the identity's (the error the frame would have if
    its delta stayed the identity)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from neus2_tpu_torch.api import testbed as testbed_mod
    from neus2_tpu_torch.data.synthetic import SPHERE_CENTER, make_moving_sphere_frames
    from neus2_tpu_torch.data.synthetic import make_sphere_dataset
    from neus2_tpu_torch.engine.render import RenderConfig, render_image
    from neus2_tpu_torch.ops.image import psnr, srgb_eval_target, ssim

    departures = {"use_error_map": True, "include_sharpness_in_error": True}
    print("dynamic_phase departures from base.json: " + json.dumps(departures), flush=True)
    cfg = dataclasses.replace(cfg, **departures)
    hyper = dataclasses.replace(hyper, first_frame_max_training_step=DYNAMIC_STEPS,
                                next_frame_max_training_step=DYNAMIC_STEPS)
    shift = np.asarray(DYNAMIC_SHIFT, np.float32)
    rebuilds = []
    real_rebuild = testbed_mod.rebuild_error_cdf

    def phase_of(tb):
        k = tb.current_training_time_frame
        return k, "frame0" if k == 0 else ("refine" if not tb.train_canonical else "finetune")

    def counted_rebuild(state):
        rebuilds.append(phase_of(tb))
        return real_rebuild(state)

    frames = []
    hook_s = [0.0]

    def on_frame_complete(tb, k):
        t0 = time.perf_counter()
        eff = tb.effective_acc
        true_t = -k * shift  # the map back to frame 0: x -> x - k * shift
        t_eff = eff["transition"].cpu().numpy()
        t_id = tb.state.acc["transition"].cpu().numpy()  # this frame's delta at identity
        rot = eff["rotation"].cpu().numpy()
        angle = float(np.degrees(np.arccos(np.clip((np.trace(rot) - 1) / 2, -1, 1))))
        held = make_sphere_dataset(n_views=2, resolution=SCENE_RES, seed=k + 1,
                                   center=SPHERE_CENTER + k * shift)
        images, cams = held.to_device("cuda")
        rcfg = RenderConfig(field=tb.config.field, aabb_scale=tb.config.aabb_scale,
                            min_transmittance=1e-4)
        rgb, _, _ = render_image(tb.state.ema_params, eff, tb.state.occupancy, cams,
                                 cams.poses[0], cams.focal[0], cams.principal[0],
                                 torch.Generator(device="cuda").manual_seed(k), rcfg,
                                 background=0.0, spp=EVAL_SPP)
        target = srgb_eval_target(images[0])
        rec = {"frame": k, "learned_transition": t_eff.tolist(),
               "true_transition": true_t.tolist(),
               "pose_error": float(np.linalg.norm(t_eff - true_t)),
               "identity_pose_error": float(np.linalg.norm(t_id - true_t)),
               "rotation_deg": angle, "psnr": float(psnr(rgb, target)),
               "ssim": float(ssim(rgb, target)),
               "black_psnr": float(psnr(torch.zeros_like(target), target)),
               "finite": bool(np.isfinite(t_eff).all() and np.isfinite(rot).all()
                              and torch.isfinite(rgb).all())}
        frames.append(rec)
        hook_s[0] += time.perf_counter() - t0

    t0 = time.perf_counter()
    tb = testbed_mod.Testbed(config=cfg, hyper=hyper, seed=0, device="cuda")
    tb.load_training_data_from_datasets(make_moving_sphere_frames(
        n_frames=DYNAMIC_FRAMES, translation_per_frame=DYNAMIC_SHIFT, n_views=16,
        resolution=SCENE_RES))
    tb.on_frame_complete = on_frame_complete
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    # (frame, phase, launches, host s, start event, end event, left out, loss)
    steps, traced, prof = [], {}, None
    testbed_mod.rebuild_error_cdf = counted_rebuild
    try:
        torch.cuda.synchronize()
        reset_launches(st)
        while True:
            if prof is None and tb.training_step in DYNAMIC_PROFILE_AT:
                prof, prof_from = profile(activities=[ProfilerActivity.CPU,
                                                      ProfilerActivity.CUDA]), len(steps)
                prof.start()
            n0, hooks0 = st.segment_sum_rows.launches, len(frames)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            if not tb.frame():
                break
            e1.record()
            k, phase = phase_of(tb)
            skip = (len(frames) != hooks0 or tb.training_step % 16 == 0
                    or prof is not None)
            steps.append((k, phase, st.segment_sum_rows.launches - n0,
                          time.perf_counter() - t0, e0, e1, skip, tb.loss_scalar))
            if prof is not None and len(steps) - prof_from == PROFILE_WINDOW:
                torch.cuda.synchronize()
                prof.stop()
                top = [{"name": e.key[:60],
                        "ms_per_step": e.self_device_time_total / 1e3 / PROFILE_WINDOW}
                       for e in device_events(prof)[:5]]
                traced.setdefault((k, phase), []).append(
                    (device_ms_per_step(prof, PROFILE_WINDOW), top))
                prof = None
    finally:
        testbed_mod.rebuild_error_cdf = real_rebuild
    torch.cuda.synchronize()
    launches = st.segment_sum_rows.launches

    if len(steps) != DYNAMIC_FRAMES * DYNAMIC_STEPS or len(frames) != DYNAMIC_FRAMES:
        raise AssertionError(f"dynamic: {len(steps)} steps, {len(frames)} frames done")
    for i, (k, phase, n, *_rest, loss) in enumerate(steps):
        if n != (0 if phase == "refine" else 1):
            raise AssertionError(f"dynamic step {i} (frame {k}, {phase}): {n} kernel-1 launches")
        if not (loss == loss and abs(loss) < 1e30):
            raise AssertionError(f"dynamic step {i}: non-finite loss {loss}")
    for rec in frames:
        if not rec["finite"]:
            raise AssertionError(f"dynamic frame {rec['frame']}: non-finite output {rec}")
        if rec["frame"] >= 1 and not rec["pose_error"] < rec["identity_pose_error"]:
            raise AssertionError(f"dynamic frame {rec['frame']}: pose error "
                                 f"{rec['pose_error']} not below the identity's "
                                 f"{rec['identity_pose_error']}")

    by = {}
    for k, phase, n, host_s, e0, e1, skip, _ in steps:
        by.setdefault((k, phase), []).append((n, host_s, e0.elapsed_time(e1), skip))
    table = []
    for (k, phase), rows in by.items():
        timed = [r for i, r in enumerate(rows) if i >= 3 and not r[3]]
        device = traced.get((k, phase), [])
        table.append({
            "frame": k, "phase": phase, "steps": len(rows),
            "kernel1_launches": sum(r[0] for r in rows),
            "host_ms_per_step": 1e3 * sum(r[1] for r in timed) / len(timed),
            "span_ms_per_step": sum(r[2] for r in timed) / len(timed),
            "device_ms_per_step": (sum(d[0] for d in device) / len(device) if device
                                   else None),
            "device_traced_steps": PROFILE_WINDOW * len(device),
            "top_device": device[0][1] if device else [],
            "error_map_rebuilds": rebuilds.count((k, phase)),
        })
    with tempfile.TemporaryDirectory() as d:
        verts, tris = tb.compute_and_save_marching_cubes_mesh(Path(d) / "mesh.obj",
                                                              resolution=MESH_RES)
    if len(tris) <= 1000:
        raise AssertionError(f"dynamic: canonical mesh of {len(tris)} triangles")
    phase_launches = {p: sum(r["kernel1_launches"] for r in table if r["phase"] == p)
                      for p in ("frame0", "refine", "finetune")}
    out = {
        "frames": DYNAMIC_FRAMES, "steps_per_frame": DYNAMIC_STEPS, "shift": DYNAMIC_SHIFT,
        "load_s": load_s, "launches": launches, "launches_by_phase": phase_launches,
        "error_map_rebuilds": len(rebuilds), "error_map_res": tb.config.error_map_res,
        "by_frame_and_phase": table, "per_frame": frames, "frame_hook_s": hook_s[0],
        "mesh_triangles": int(len(tris)),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print("dynamic_phase " + json.dumps(out), flush=True)
    return out


def write_camera_scene(out_dir: Path, n_views: int, res: int, seed: int = 0) -> dict:
    """The 16-view synthetic sphere scene as files a user would load:
    ``transforms.json`` (from_na), RGBA PNGs and uint16 depth PNGs
    (``integer_depth_scale`` CAMERA_DEPTH_SCALE, the analytic depth along
    each true pixel ray), written with what the camera group should learn
    put in: each view's translation offset by N(0, CAMERA_TRANS_SIGMA) an
    axis, each view's linear texels scaled by 2^e, e ~ U[-0.3, 0.3] stops
    (both zero-mean over the views), and the focal stated
    CAMERA_FOCAL_FACTOR too long.  -> the json path and those errors."""
    import numpy as np
    from PIL import Image

    from neus2_tpu_torch.data.dataset import ngp_matrix_to_nerf
    from neus2_tpu_torch.data.synthetic import SPHERE_CENTER, SPHERE_RADIUS, make_sphere_dataset
    from neus2_tpu_torch.data.synthetic import ray_sphere

    ds = make_sphere_dataset(n_views=n_views, resolution=res, seed=seed)
    rng = np.random.default_rng(seed)
    trans = rng.normal(0.0, CAMERA_TRANS_SIGMA, (n_views, 3)).astype(np.float32)
    trans -= trans.mean(0)
    stops = rng.uniform(-CAMERA_EXPOSURE_STOPS, CAMERA_EXPOSURE_STOPS, n_views).astype(np.float32)
    stops -= stops.mean()
    u = (np.arange(res) + 0.5) / res
    uu, vv = np.meshgrid(u, u)
    offset = np.asarray(ds.offset, np.float32)
    frames = []
    for i in range(n_views):
        pose, (fx, fy), (cx, cy) = ds.poses[i], ds.focal[i], ds.principal[i]
        xy = np.stack([(uu - cx) * res / fx, (vv - cy) * res / fy], -1)
        dirs = np.concatenate([xy, np.ones_like(xy[..., :1])], -1) @ pose[:, :3].T
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        hit, t = ray_sphere(pose[:, 3], dirs, SPHERE_CENTER, SPHERE_RADIUS)
        depth = np.where(hit, np.round(t / (CAMERA_DEPTH_SCALE * ds.scale)), 0).astype(np.uint16)
        Image.fromarray(depth).save(out_dir / f"depth_{i:03d}.png")
        img = ds.images[i]
        a = img[..., 3:4]
        lin = np.where(a > 0, img[..., :3] / np.maximum(a, 1e-8), 0.0) * 2.0 ** stops[i]
        srgb = np.where(lin <= 0.0031308, 12.92 * lin, 1.055 * np.power(
            np.maximum(lin, 0.0031308), 1.0 / 2.4) - 0.055)
        rgba = np.concatenate([np.clip(srgb, 0.0, 1.0), a], -1)
        Image.fromarray((rgba * 255.0 + 0.5).astype(np.uint8)).save(out_dir / f"rgb_{i:03d}.png")
        moved = pose.copy()
        moved[:, 3] += trans[i]
        mat = np.concatenate([ngp_matrix_to_nerf(moved, ds.scale, offset, True),
                              [[0.0, 0.0, 0.0, 1.0]]])
        f = CAMERA_FOCAL_FACTOR
        frames.append({
            "file_path": f"rgb_{i:03d}.png", "depth_path": f"depth_{i:03d}.png",
            "transform_matrix": mat.tolist(),
            "intrinsic_matrix": [[float(fx * f), 0.0, float(cx * res)],
                                 [0.0, float(fy * f), float(cy * res)], [0.0, 0.0, 1.0]],
        })
    meta = {"from_na": True, "scale": ds.scale, "offset": offset.tolist(), "aabb_scale": 1,
            "integer_depth_scale": CAMERA_DEPTH_SCALE, "frames": frames}
    path = out_dir / "transforms.json"
    path.write_text(json.dumps(meta))
    return {"path": path, "trans": trans, "stops": stops}


def camera_errors(cam: dict, truth: dict) -> dict:
    """The camera group against the errors written into the scene, each
    with its mean over the views removed (a common shift of the views, or
    of their exposure, is the field's to take): the rms translation error
    |offset + learned| and exposure error (stops + learned, the learned
    exposure's mean over its channels), and the learned focal scale."""
    import numpy as np

    def rms_centred(x):
        x = x - x.mean(0)
        return float(np.sqrt((x * x).sum(-1).mean()) if x.ndim > 1 else np.sqrt((x * x).mean()))

    trans = truth["trans"] + cam["trans"].detach().cpu().numpy()
    stops = truth["stops"] + cam["exposure"].detach().cpu().numpy().mean(-1)
    return {"translation_rms": rms_centred(trans), "exposure_rms_stops": rms_centred(stops),
            "focal_scale": np.exp(cam["focal_ln"].detach().cpu().numpy()).tolist()}


def camera_phase(torch, st, cfg, hyper, static_device_ms: float) -> dict:
    """The static Testbed at full width with the whole camera group on, as
    a user with a real capture runs it: ``write_camera_scene`` (16 views at
    256^2 with translation, exposure and focal errors and depth maps),
    ``load_training_data`` of its json, CAMERA_STEPS steps of ``while
    tb.frame()``, then the camera group's errors against the written ones,
    a held-out view at the eval protocol through the learned extras (at
    the true focal, and at the stated one with the learned correction), and
    ``render(256, 256, 1)`` with the learned envmap at exposure 0.5 and the
    ACES curve.  Host ms a step over PROFILE_WINDOW steps from
    CAMERA_PROFILE_AT, then device ms a step over as many traced.

    Fails on a non-finite loss, on kernel-1 launches other than one a step,
    on a camera group that did not move, and on a tonemapped render more
    than 1e-6 from ``apply_output_tonemap`` of the identity render."""
    import numpy as np

    from neus2_tpu_torch.api import testbed as testbed_mod
    from neus2_tpu_torch.data.synthetic import make_sphere_dataset
    from neus2_tpu_torch.engine.render import RenderConfig, render_image
    from neus2_tpu_torch.ops.image import psnr, srgb_eval_target, ssim
    from neus2_tpu_torch.ops.tonemap import apply_output_tonemap

    print("camera_phase departures from base.json: " + json.dumps(CAMERA_DEPARTURES), flush=True)
    cfg = dataclasses.replace(cfg, **CAMERA_DEPARTURES)
    hyper = dataclasses.replace(hyper, first_frame_max_training_step=CAMERA_STEPS)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        truth = write_camera_scene(Path(d), 16, SCENE_RES)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tb = testbed_mod.Testbed(config=cfg, hyper=hyper, seed=0, device="cuda")
        tb.load_training_data(truth["path"])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    if tb.depths is None or not tb.config.use_distortion:
        raise AssertionError("camera phase: the depth maps or the camera group did not load")
    cam0 = {k: v.clone() for k, v in tb.state.cam.items()}
    before = camera_errors(cam0, truth)

    torch.cuda.reset_peak_memory_stats()
    run_out = run_testbed(torch, st, tb, CAMERA_PROFILE_AT)
    if tb.training_step != CAMERA_STEPS:
        raise AssertionError(f"camera phase: {tb.training_step} steps of {CAMERA_STEPS}")
    moved = {k: float((tb.state.cam[k] - cam0[k]).abs().max()) for k in cam0}
    if not all(moved[k] > 0.0 for k in cam0 if k != "latent"):
        raise AssertionError(f"camera phase: the camera group did not move: {moved}")
    after = camera_errors(tb.state.cam, truth)

    tb.prepare_for_test()
    held = make_sphere_dataset(n_views=2, resolution=SCENE_RES, seed=1)
    images, cams = held.to_device("cuda")
    rcfg = RenderConfig(field=tb.config.field, aabb_scale=tb.config.aabb_scale,
                        min_transmittance=1e-4)
    target = srgb_eval_target(images[0])
    view = {"black_psnr": float(psnr(torch.zeros_like(target), target))}
    # At the true focal, and at the focal the rig states (CAMERA_FOCAL_FACTOR
    # long) with the learned correction: a held-out photo shares its rig's
    # calibration, and the field's scale trades against the focal.
    stated = cams.focal[0] * CAMERA_FOCAL_FACTOR * torch.exp(tb.state.cam["focal_ln"])
    for name, focal in (("true_focal", cams.focal[0]), ("stated_focal_corrected", stated)):
        rgb, _, _ = render_image(tb.state.ema_params, tb.effective_acc, tb.state.occupancy,
                                 cams, cams.poses[0], focal, cams.principal[0],
                                 torch.Generator(device="cuda").manual_seed(0), rcfg,
                                 background=0.0, spp=EVAL_SPP, **tb._render_extras())
        view[name] = {"psnr": float(psnr(rgb, target)), "ssim": float(ssim(rgb, target))}

    plain = tb.render(SCENE_RES, SCENE_RES, 1)
    tb.exposure, tb.tonemap_curve = 0.5, "ACES"
    toned = tb.render(SCENE_RES, SCENE_RES, 1)
    tb.exposure, tb.tonemap_curve = 0.0, "Identity"
    want = torch.clamp(apply_output_tonemap(torch.from_numpy(plain[..., :3]), 0.5, "aces"), 0, 1)
    tone_err = float(np.abs(toned[..., :3] - want.numpy()).max())
    if not (np.isfinite(toned).all() and tone_err <= 1e-6):
        raise AssertionError(f"camera phase: tonemapped render max|diff| {tone_err}")

    out = {
        **run_out, "write_s": write_s, "load_s": load_s,
        "launches_per_step": run_out["launches"] / CAMERA_STEPS,
        "static_device_ms_per_step": static_device_ms,
        "errors_before": before, "errors_after": after,
        "camera_moved_max_abs": moved, "held_out_view": view, "tonemap_max_abs_err": tone_err,
        "envmap_alpha_mean": float(tb.state.cam["envmap"][..., 3].mean()),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print("camera_phase " + json.dumps(out), flush=True)
    return out


def newton_undistort(k, x, y, iters: int = 20):
    """The scene writer's own Brown-Conrady inverse: float64 Newton steps
    with the analytic Jacobian of distort(x, y) = (x, y) + the deltas."""
    import numpy as np

    k1, k2, p1, p2 = k
    xu, yu = np.array(x, np.float64), np.array(y, np.float64)
    for _ in range(iters):
        r2 = xu * xu + yu * yu
        rad = k1 * r2 + k2 * r2 * r2
        drad = k1 + 2.0 * k2 * r2
        fx = xu * (1 + rad) + 2 * p1 * xu * yu + p2 * (r2 + 2 * xu * xu) - x
        fy = yu * (1 + rad) + 2 * p2 * xu * yu + p1 * (r2 + 2 * yu * yu) - y
        a = 1 + rad + 2 * xu * xu * drad + 2 * p1 * yu + 6 * p2 * xu
        b = 2 * xu * yu * drad + 2 * p1 * xu + 2 * p2 * yu
        d = 1 + rad + 2 * yu * yu * drad + 2 * p2 * xu + 6 * p1 * yu
        det = a * d - b * b
        xu, yu = xu - (d * fx - b * fy) / det, yu - (-b * fx + a * fy) / det
    return xu, yu


def write_lens_scene(out_dir: Path, model: str, n_views: int, res: int, seed: int,
                     name: str = "transforms") -> Path:
    """A synthetic sphere scene as files, every pixel traced through the
    camera ``model`` with numpy (not the port) and shaded analytically
    (``ray_sphere``, ``shade_sphere``): "lens" (Brown-Conrady LENS_K; with
    more than 2 views the second half are res x 3/4 res (256 x 192)
    half-float ZIP EXR frames, the rest sRGB PNGs), "rolling_shutter" (pinhole, the
    pose moving by ROLLING_SHIFT over ROLLING_SHUTTER), "ftheta" (a
    fisheye of alpha = FTHETA_P1 r) or "rays" (the lens's rays written to
    ``rays_<stem>.dat`` files, the json naming no lens).  -> the json."""
    import numpy as np
    from PIL import Image

    from neus2_tpu_torch.data.dataset import ngp_matrix_to_nerf
    from neus2_tpu_torch.data.exr import write_exr
    from neus2_tpu_torch.data.synthetic import (SPHERE_CENTER, SPHERE_RADIUS,
                                                make_sphere_dataset, ray_sphere, shade_sphere)

    ds = make_sphere_dataset(n_views=n_views, resolution=res, seed=seed)
    offset = np.asarray(ds.offset, np.float32)
    f = float(ds.focal[0, 0])
    meta = {"from_na": True, "scale": ds.scale, "offset": offset.tolist(), "aabb_scale": 1}
    if model == "lens":
        meta.update(zip(("k1", "k2", "p1", "p2"), LENS_K))
    elif model == "rolling_shutter":
        meta["rolling_shutter"] = list(ROLLING_SHUTTER)
    elif model == "ftheta":
        meta.update({f"ftheta_p{i}": v for i, v in enumerate((0.0, FTHETA_P1, 0.0, 0.0, 0.0))})
        meta.update(w=res, h=res)
    frames = []
    for i in range(n_views):
        exr_frame = model == "lens" and n_views > 2 and i >= n_views // 2
        w, h = res, (res * 3 // 4 if exr_frame else res)
        uu, vv = np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h)
        x, y = (uu - 0.5) * w / f, (vv - 0.5) * h / f
        pose = ds.poses[i].astype(np.float64)
        if model == "ftheta":
            xp, yp = (uu - 0.5) * res, (vv - 0.5) * res
            r = np.hypot(xp, yp)
            a = FTHETA_P1 * r
            s = np.sin(a) / np.maximum(r, 1e-12)
            cam = np.stack([s * xp, s * yp, np.cos(a)], -1)
        else:
            if model in ("lens", "rays"):
                x, y = newton_undistort(LENS_K, x, y)
            cam = np.stack([x, y, np.ones_like(x)], -1)
        poses = np.broadcast_to(pose, (h, w, 3, 4))
        end = pose.copy()
        end[:, 3] += ROLLING_SHIFT
        if model == "rolling_shutter":
            t0, du, dv = ROLLING_SHUTTER
            t = (t0 + du * uu + dv * vv)[..., None, None]
            poses = pose + (end - pose) * t
        d = np.einsum("hwij,hwj->hwi", poses[..., :3], cam)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = poses[..., 3]
        hit, t = ray_sphere(o, d, SPHERE_CENTER, SPHERE_RADIUS)
        n = (o + t[..., None] * d - SPHERE_CENTER) / SPHERE_RADIUS
        a = hit[..., None].astype(np.float32)
        lin = shade_sphere(n.astype(np.float32)) * a
        stem = f"{name}_{i:03d}"
        if exr_frame:
            write_exr(out_dir / f"{stem}.exr", {"R": lin[..., 0], "G": lin[..., 1],
                                                 "B": lin[..., 2], "A": a[..., 0]},
                      compression="zip", half=True)
            file = f"{stem}.exr"
        else:
            srgb = np.where(lin <= 0.0031308, 12.92 * lin, 1.055 * np.power(
                np.maximum(lin, 0.0031308), 1.0 / 2.4) - 0.055)
            rgba = np.concatenate([np.clip(srgb, 0.0, 1.0), a], -1)
            Image.fromarray((rgba * 255.0 + 0.5).astype(np.uint8)).save(out_dir / f"{stem}.png")
            file = f"{stem}.png"
        if model == "rays":  # nerf coordinates: the loader applies nerf_ray_to_ngp
            rays = np.concatenate([(o[..., [2, 0, 1]] - offset[[2, 0, 1]]) / ds.scale,
                                   d[..., [2, 0, 1]]], -1)
            rays.astype(np.float32).tofile(out_dir / f"rays_{stem}.dat")

        def nerf(m):
            return np.concatenate([ngp_matrix_to_nerf(m.astype(np.float32), ds.scale, offset,
                                                      True), [[0.0, 0.0, 0.0, 1.0]]]).tolist()

        frame = {"file_path": file, "transform_matrix": nerf(pose),
                 "intrinsic_matrix": [[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]]}
        if model == "rolling_shutter":
            frame["transform_matrix_end"] = nerf(end)
        frames.append(frame)
    meta["frames"] = frames
    path = out_dir / f"{name}.json"
    path.write_text(json.dumps(meta))
    return path


def run_testbed(torch, st, tb, profile_at: int | None = None, on_step=None) -> dict:
    """``while tb.frame()`` with kernel 1's launches read a step, each
    step's loss kept (no host sync) and ``on_step(tb)`` called after each
    step.  Host ms a step over the steps after WARMUP_STEPS, the traced
    ones and the trace's analysis left out; with ``profile_at``, host ms a step over PROFILE_WINDOW
    steps from that step, then device ms, device kernel launches and the
    top kernels a step over as many traced.  The loss reads are those of
    step 1 and every 16th step.  Fails unless kernel 1 ran once a step and
    every loss is finite."""
    from torch.profiler import ProfilerActivity, profile

    from neus2_tpu_torch.api import testbed as testbed_mod

    launches_after, prof, out = [], None, {}
    traced_s, t_warm = 0.0, None
    torch.cuda.synchronize()
    reset_launches(st)
    t_start = time.perf_counter()
    with LossRecorder(testbed_mod) as rec:
        while True:
            if tb.training_step == WARMUP_STEPS:
                torch.cuda.synchronize()
                t_warm = time.perf_counter()
            if tb.training_step == profile_at:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if profile_at is not None and tb.training_step == profile_at + PROFILE_WINDOW:
                torch.cuda.synchronize()
                t_trace = time.perf_counter()
                out["host_ms_per_step"] = (t_trace - t0) * 1e3 / PROFILE_WINDOW
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.start()
            if not tb.frame():
                break
            launches_after.append(st.segment_sum_rows.launches)
            if prof is not None and tb.training_step == profile_at + 2 * PROFILE_WINDOW:
                torch.cuda.synchronize()
                prof.stop()
                evs = device_events(prof)
                out["device_ms_per_step"] = device_ms_per_step(prof, PROFILE_WINDOW)
                out["device_launches_per_step"] = sum(e.count for e in evs) / PROFILE_WINDOW
                out["top_device"] = [{"name": e.key[:60], "ms_per_step":
                                      e.self_device_time_total / 1e3 / PROFILE_WINDOW}
                                     for e in evs[:8]]
                prof = None
                traced_s = time.perf_counter() - t_trace  # the trace's analysis too
            if on_step is not None:
                on_step(tb)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    out["wall_s"] = t_end - t_start
    steps = tb.training_step
    timed = steps - WARMUP_STEPS - (PROFILE_WINDOW if traced_s else 0)
    if t_warm is not None and timed > 0:
        out["ms_per_step"] = (t_end - t_warm - traced_s) * 1e3 / timed
    losses = torch.stack(rec.losses).float().cpu().tolist()
    if launches_after != list(range(1, steps + 1)) or len(losses) != steps:
        raise AssertionError(f"{steps} steps, {st.segment_sum_rows.launches} kernel-1 launches")
    if not all(v == v and abs(v) < 1e30 for v in losses):
        raise AssertionError(f"non-finite losses {losses}")
    reads = [v for i, v in enumerate(losses, 1) if i == 1 or i % 16 == 0]
    out.update(steps=steps, launches=st.segment_sum_rows.launches, loss_first=losses[0],
               loss_last=losses[-1], loss_reads=reads, batch_bucket=tb.batch_bucket)
    return out


def lens_phase(torch, st, cfg, hyper, static: dict, pinhole: dict) -> dict:
    """The static Testbed at full width through the lens models, as a user
    with a distorted capture runs it: ``write_lens_scene`` (16 views,
    Brown-Conrady, 8 PNGs at 256^2 and 8 half-float EXRs at 256 x 192),
    ``load_training_data``, LENS_STEPS steps with fp16 image storage (the
    phase's only departure from base.json), the two held-out views of
    camera seed 1 (written through the same lens) scored by ``run.evaluate``
    with the lens and with ``render_with_camera_distortion`` off; then
    CAMERA_MODEL_STEPS steps each of a rolling-shutter, an FTheta and a
    ray-file scene (16 views at 256^2, fp32 storage).  ``static`` holds
    profile_phase's numbers and ``pinhole`` testbed_phase's, whose windows
    are this run's (the same loop and steps): the "over_pinhole_testbed"
    differences are those of the lens, fp16 storage, the mixed sizes and
    the scene together.

    Fails unless kernel 1 ran once a step in every run, every loss is
    finite, the lens run's loss fell, and the lens beats its absence on
    the held-out views."""
    import numpy as np

    from neus2_tpu_torch import run
    from neus2_tpu_torch.api.testbed import Testbed

    print("lens_phase departures from base.json: image_dtype float16", flush=True)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = write_lens_scene(Path(d), "lens", 16, SCENE_RES, seed=0)
        held = write_lens_scene(Path(d), "lens", 2, SCENE_RES, seed=1, name="held_out")
        out["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tb = Testbed(config=cfg, hyper=dataclasses.replace(
            hyper, first_frame_max_training_step=LENS_STEPS), seed=0, device="cuda",
            image_dtype=torch.float16)
        tb.load_training_data(path)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        cams = tb.cameras
        if (cams.distortion is None or cams.image_sizes is None
                or tb.images.dtype != torch.float16):
            raise AssertionError("lens phase: the lens, the sizes or fp16 storage did not load")
        sizes = sorted({tuple(v) for v in cams.image_sizes.tolist()})
        run_out = run_testbed(torch, st, tb, TESTBED_PROFILE_AT)
        if not run_out["loss_last"] < run_out["loss_first"]:
            raise AssertionError(f"lens phase: the loss did not fall {run_out}")
        tb.prepare_for_test()
        held_psnr = {}
        for name, on in (("with_lens", True), ("lens_stripped", False)):
            tb.render_with_camera_distortion = on
            t0 = time.perf_counter()
            psnrs, ssims = run.evaluate(tb, str(held), EVAL_SPP, lambda *a: None)
            held_psnr[name] = {"psnr": psnrs, "ssim": ssims,
                               "eval_s": time.perf_counter() - t0}
        tb.render_with_camera_distortion = True
        gain = np.mean(held_psnr["with_lens"]["psnr"]) - np.mean(held_psnr["lens_stripped"]["psnr"])
        if not gain > 0.0:
            raise AssertionError(f"lens phase: the lens does not beat its absence {held_psnr}")
        n_texels = tb.images.numel()
        out.update({
            "steps": LENS_STEPS, "image_sizes": sizes, **run_out,
            "static_device_ms_per_step": static["device_ms_per_step"],
            "static_host_ms_per_step": static["ms_per_step"],
            "static_device_launches_per_step": static["launches_per_step"],
            **{f"pinhole_testbed_{k}": pinhole[k] for k in
               ("device_ms_per_step", "host_ms_per_step", "device_launches_per_step",
                "batch_bucket")},
            **{f"{k}_over_pinhole_testbed": run_out[k] - pinhole[k] for k in
               ("device_ms_per_step", "host_ms_per_step", "device_launches_per_step")},
            "image_bytes_fp16": n_texels * 2, "image_bytes_fp32": n_texels * 4,
            "held_out": held_psnr,
        })
        del tb
        others = {}
        for model in ("rolling_shutter", "ftheta", "rays"):
            t0 = time.perf_counter()
            mpath = write_lens_scene(Path(d), model, 16, SCENE_RES, seed=0, name=model)
            tb = Testbed(config=cfg, hyper=dataclasses.replace(
                hyper, first_frame_max_training_step=CAMERA_MODEL_STEPS), seed=0,
                device="cuda")
            tb.load_training_data(mpath)
            if getattr(tb.cameras, model) is None:  # the Cameras field of that name
                raise AssertionError(f"lens phase: the {model} scene's lens did not load")
            r = run_testbed(torch, st, tb)
            others[model] = {k: r[k] for k in ("steps", "launches", "loss_first", "loss_last",
                                               "wall_s")}
            others[model]["write_and_load_s"] = time.perf_counter() - t0 - r["wall_s"]
            del tb
    out["camera_models"] = others
    out["launches_all"] = out["launches"] + sum(o["launches"] for o in others.values())
    print("lens_phase " + json.dumps(out), flush=True)
    return out


def held_out_views(torch, tb, what: str) -> list:
    """The two held-out views of camera seed 1 (16-view 256^2 sphere
    scene) rendered at the eval protocol (spp 8, black background, min
    transmittance 1e-4) and scored -> per view {psnr, ssim, black_psnr,
    render_ms}.  Fails unless each render is finite and beats the
    all-black image."""
    from neus2_tpu_torch.data.synthetic import make_sphere_dataset
    from neus2_tpu_torch.engine.render import RenderConfig, render_image
    from neus2_tpu_torch.ops.image import psnr, srgb_eval_target, ssim

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
            raise AssertionError(f"{what}: held-out view {i} {v}")
        views.append(v)
    return views


def bf16_phase(torch, st, cfg, hyper, testbed: dict, static: dict) -> dict:
    """testbed_phase's run (TESTBED_STEPS steps on the 16-view 256^2
    sphere, the same held-out views) with bf16 compute, after the bf16
    field on the card is held against the CPU's bf16 path
    (BF16_FIELD_LIMITS): kernel 1 once a step, host and device ms a step
    over the same windows as the fp32 Testbed's and beside profile_phase's
    fp32 step, and the held-out PSNR beside the fp32 Testbed's.  Fails on
    a non-finite loss,
    on kernel-1 launches other than one a step, and on a held-out PSNR
    more than BF16_PSNR_MARGIN dB below the fp32 run's."""
    import numpy as np

    from neus2_tpu_torch.api.testbed import Testbed
    from neus2_tpu_torch.data.synthetic import make_sphere_dataset

    print("bf16_phase departures from base.json: compute_dtype bfloat16", flush=True)
    cfg = dataclasses.replace(cfg, field=dataclasses.replace(cfg.field,
                                                             compute_dtype=torch.bfloat16))
    field = field_agrees_with_cpu(torch, cfg, limits=BF16_FIELD_LIMITS)
    tb = Testbed(config=cfg, hyper=dataclasses.replace(
        hyper, first_frame_max_training_step=TESTBED_STEPS), seed=0, device="cuda")
    tb.load_training_data_from_datasets([make_sphere_dataset(n_views=16, resolution=SCENE_RES,
                                                             seed=0)])
    run_out = run_testbed(torch, st, tb, TESTBED_PROFILE_AT)
    tb.prepare_for_test()
    psnrs = [v["psnr"] for v in held_out_views(torch, tb, "bf16 phase")]
    fp32 = [v["psnr"] for v in testbed["views"]]
    if not np.mean(psnrs) >= np.mean(fp32) - BF16_PSNR_MARGIN:
        raise AssertionError(f"bf16 phase: held-out PSNR {psnrs} vs fp32 {fp32}")
    out = {**run_out, "held_out_psnr": psnrs, "fp32_held_out_psnr": fp32,
           "fp32_static_device_ms_per_step": static["device_ms_per_step"],
           **{f"fp32_testbed_{k}": testbed[k] for k in
              ("ms_per_step", "device_ms_per_step", "host_ms_per_step",
               "device_launches_per_step", "batch_bucket")},
           **{f"{k}_over_fp32_testbed": run_out[k] - testbed[k] for k in
              ("device_ms_per_step", "host_ms_per_step", "device_launches_per_step")},
           "field_vs_cpu": field}
    print("bf16_phase " + json.dumps(out), flush=True)
    return out


def field_agrees_with_cpu(torch, cfg, n: int = 16384, limits: dict | None = None) -> dict:
    """The field and its gradients at full width on the card (through the
    segment-sum kernel) vs the same inputs on the CPU (exact scatter):
    outputs within 1e-4 of their max, MLP and variance gradients within
    1e-3 of their max, table gradients within 1e-2 of their max (the
    kernel sums bf16-quantized updates, as the reference's fp16 atomics
    do); ``limits`` replaces those three bounds."""
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
    limits = limits or {"outputs": 1e-4, "tables": 1e-2, "mlp": 1e-3}
    if any(worst[k] > limits[k] for k in worst):
        raise AssertionError(f"field on the card disagrees with the CPU: {worst}")
    print("field_vs_cpu " + json.dumps({"compute_dtype": str(cfg.field.compute_dtype), **worst}),
          flush=True)
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


def device_events(prof) -> list:
    """The traced window's device-side events, largest device time first."""
    from torch.autograd import DeviceType

    return sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.self_device_time_total, reverse=True)


def device_ms_per_step(prof, steps: int) -> float:
    """The card's busy time a step over a traced window of ``steps``."""
    ms = sum(e.self_device_time_total for e in device_events(prof)) / 1e3 / steps
    if ms <= 0:
        raise AssertionError("the profiler saw no device time in the traced window")
    return ms


def profile_phase(torch, tt, state, images, cams, cfg, steps: int = PROFILE_STEPS) -> dict:
    """Where the step's time goes, after the main path's counts are read:
    ``steps`` steps timed on the host clock without a log callback, then
    as many traced with ``torch.profiler``, one kernel-1 launch in each.
    The busy share is the traced window's device time over the untraced
    window's step time (the profiler slows the host, so the traced
    window's own wall time would understate it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    launches = segment_sum_launches()
    t0 = time.perf_counter()
    state = tt.train_static(state, images, cams, cfg, steps)
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t0) * 1e3 / steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tt.train_static(state, images, cams, cfg, steps)
        torch.cuda.synchronize()
    if segment_sum_launches() - launches != 2 * steps:
        raise AssertionError(f"profile phase: {segment_sum_launches() - launches} kernel-1 "
                             f"launches in {2 * steps} steps")
    device = device_events(prof)
    host = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    device_ms = device_ms_per_step(prof, steps)

    def top(evs, attr, k):
        return [{"name": e.key[:80], "ms_per_step": getattr(e, attr) / 1e3 / steps,
                 "calls_per_step": e.count / steps} for e in evs[:k]]

    def named(part):  # device ms/step of the kernels whose name holds ``part``
        return sum(e.self_device_time_total for e in device if part in e.key) / 1e3 / steps

    out = {
        "steps": steps, "ms_per_step": ms_per_step,
        "device_ms_per_step": device_ms, "device_busy_share": device_ms / ms_per_step,
        "segment_sum_ms_per_step": named("stream_sum_kernel") + named("stream_fixup_kernel"),
        "radix_sort_ms_per_step": named("RadixSort"),
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
    k1, k1_f8 = kernel_phase(torch, st, cfg, 2), kernel_phase(torch, st, cfg, 8)
    sorted_k = kernel_phase_sorted(torch, st, cfg, 2)
    sorted_f8 = kernel_phase_sorted(torch, st, cfg, 8)
    ops = op_path_phase(torch, st, sc, cfg)
    field_agrees_with_cpu(torch, cfg)
    images, cams = make_sphere_dataset(n_views=16, resolution=SCENE_RES, seed=0).to_device("cuda")
    train, state = training_phase(torch, tt, st, cfg, images, cams)
    prof = profile_phase(torch, tt, state, images, cams, cfg)
    del state, images, cams
    tb, testbed = testbed_phase(torch, st, cfg, hyper)
    snap = snapshot_phase(torch, st, testbed)
    del testbed
    dyn = dynamic_phase(torch, st, cfg, hyper)
    camera = camera_phase(torch, st, cfg, hyper, prof["device_ms_per_step"])
    lens = lens_phase(torch, st, cfg, hyper, prof, tb)
    bf16 = bf16_phase(torch, st, cfg, hyper, tb, prof)

    def entry(name, replaces, rec, rec_f8, launches, extra=()):
        f8_keys = ("max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "library_ms", *extra)
        return {
            "name": name, "route": "cuda", "source": "neus2_tpu_torch/csrc/segment_sum.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            **{k: rec[k] for k in extra}, "f8": {k: rec_f8[k] for k in f8_keys},
        }

    kernels = [
        {**entry("segment_sum_rows", "neus2_tpu/ops/segment_tile.py:376", k1, k1_f8,
                 tb["launches"]),
         "sort_ms": k1["sort_ms"], "launches_per_step": tb["launches_per_step"],
         "train_static_launches": train["launches"],
         "dynamic_launches": dyn["launches_by_phase"],
         "camera_launches": camera["launches"],
         "lens_launches": lens["launches_all"], "bf16_launches": bf16["launches"],
         "resume_launches": {"native": snap["resume"]["launches_resumed"],
                             "reference": snap["reference"]["launches"]}},
    ] + [
        entry(name, replaces, sorted_k[name], sorted_f8[name], ops["launches"][name],
              extra=("entry_ms",))
        for name, replaces in (
            ("segment_sum_packed_rows", "neus2_tpu/ops/segment_tile.py:376"),
            ("segment_sum_batched_rows", "neus2_tpu/ops/segment_tile.py:211"),
        )
    ] + [
        entry("segment_sum_planar_rows", "neus2_tpu/ops/segment_tile.py:75",
              sorted_k["segment_sum_planar_rows"], sorted_f8["segment_sum_planar_rows"],
              ops["launches"]["segment_sum_planar_rows"], extra=("held_ms", "library_held_ms")),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
