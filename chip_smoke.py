#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``neus2_tpu_torch/csrc`` from source and holds
each of the four segment-sum kernels against its plain PyTorch version at
the shapes its path gives it, at F=2 and F=8 (base.json's levels), at F=4
(tpu_opt.json's) and kernel 1 at l4f8.json's (``kernel_phase`` for kernel
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
  * ``mesh_outputs_phase``: on the Testbed phase's trained state, its mesh
    rasterized from a held-out view (``render_mesh_image``, normal map and
    shaded), the Chamfer distance to the true sphere's mesh on the card,
    ``refine_vertices`` and the hash grid's level stats;
  * ``snapshot_phase``: on that trained Testbed, a native snapshot saved,
    loaded into a fresh Testbed (every leaf and a render bitwise) and
    resumed for 20 steps (kernel 1 once a step, losses bitwise the
    original's), a legacy positional-list snapshot of it loaded (every
    leaf bitwise) with 5 steps from it, a reference-format export, import
    and re-export (byte-equal blobs) with 5 steps from it, and the pyngp
    ``render(width, height)``;
  * ``wide_rows_phase``: once for each of the repo's wider-row
    configurations, ``configs/tpu_opt.json`` (7 levels x 4 features) and
    ``configs/l4f8.json`` (4 x 8) at their published widths: the field on
    the card against the CPU, then the Testbed phase's run (kernel 1 once
    a step, held-out views, the mesh), a native snapshot round trip
    (every leaf bitwise) and a reference-format export round trip, with
    device ms and launches a step beside base.json's;
  * ``dynamic_phase``: the dynamic Testbed at the same width with the
    error map and its sharpness weighting on, over a 3-frame scene of a
    sphere moved by a known shift a frame: per-frame pose refinement (no
    kernel-1 launch), then the finetune phase (one a step), a held-out
    view scored per frame, the canonical mesh at the end; then the CLI on
    2 frames of 100 steps with ``--tensorboard`` (``dynamic_cli``: the
    global and per-frame event files against its log);
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
    once a step and the held-out PSNR beside the fp32 run's;
  * ``sdf_phase``: ``--mode sdf`` through the CLI at full width
    (``default_sdf_field``, batch 2^16, pool 2^21) on the CSG scene's mesh
    for 2,000 steps: kernel 1 once a step (held first against its plain
    version at the mode's shape, and one step on the card against the
    CPU), the IoU, the sphere-traced render and the mesh;
  * ``image_phase``: ``--mode image`` through the CLI at
    ``Image2DConfig``'s defaults on a 512^2 PNG for 1,000 steps: kernel 4
    once a level a step (held first against its plain version at each
    level's shape, and one step's table gradients on the card against the
    CPU), the PSNR;
  * ``parallel_phase``: data-parallel training (``neus2_tpu_torch/
    parallel``) on one rank a visible card through NCCL, at the same width
    with 4,096 rays a rank: equal draws against single-card steps, the
    Testbed through ``enable_multichip`` for 200 steps with the error map
    on (kernel 1 once a step on every rank; device and NCCL ms a step,
    global rays/s), ZeRO-1 against replicated, and a ZeRO-1 snapshot
    loaded into a replicated Testbed.

  * ``cascade_phase``: scenes larger than the unit cube through the same
    paths: the static Testbed at the same width on an aabb_scale-4 scene
    of two spheres, one outside the unit cube (3 occupancy cascades,
    candidates spaced by the cone angle, the warp-metric dt), held to
    tests/test_cascades.py's bars after the prior sweep, 300 and 900 steps
    (kernel 1 once a step), with its held-out views, mesh and snapshots,
    one step on the card against the CPU, the CLI on the scene's files
    (base.json with the same init radius, held to the same mesh gate, with
    ``--tensorboard``: its event files against its log, and host and
    device ms a step over windows with and without a scalar step) and 50
    steps at aabb_scale 16 (5 cascades);
  * ``quality_ab_phase``: tests/test_compaction.py's A/Bs, 300 steps an
    arm, on held-out PSNR and the sphere's |sdf|, held to the tests' bars:
    ``hit_oversample`` 2 against 1 at the same width through the Testbed,
    and both that pair and the mask loss 0.1 against 0 at
    tests/e2e_drive.py's own size, where the tests set their bars.

Before the kernel phases, one ``provenance`` line names the machine
(library versions, NVIDIA driver, SM count, visible cards, host CPU and
threads) beside a hash of the field check's card outputs, to tell
machines apart by the last bits of a run, and the field init's hash at 1
thread and at the host's count (it fails if they differ).

Exits non-zero on any failure; the last line of a successful run is the
device JSON, the line before it the ``kernels`` JSON.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
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
WIDE_ROW_CONFIGS = ("tpu_opt.json", "l4f8.json")  # wide_rows_phase, at their published widths
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
SDF_STEPS = 2000  # --mode sdf's default
SDF_MESH_RES = 128  # sdf_phase's mesh: csg_sdf on this lattice, marching cubes
SDF_PROFILE_AT = 1000  # host window, then the traced window, from this step
SDF_IOU_BAR = 0.9  # tests/test_sdf_mode.py::test_fit_converges_iou
IMAGE_STEPS = 1000  # --mode image's default
IMAGE_RES = 512
IMAGE_PROFILE_AT = 500
IMAGE_PSNR_BAR = 26.0  # tests/test_image_mode.py::test_image_fit_converges
REFINE_ITERS = 5  # mesh_outputs_phase's refine_vertices
PARALLEL_EQUAL_STEPS = 20  # parallel_phase (a) and (c)
PARALLEL_STEPS = 200  # parallel_phase (b)
PARALLEL_PROFILE_AT = 100
PARALLEL_SNAPSHOT_STEPS = 10  # parallel_phase (d)
# cascade_phase: tests/test_cascades.py's scene (its 64^2 images at the
# other phases' SCENE_RES) and its bars.
CASCADE_SPHERES = (((0.5, 0.5, 0.5), 0.25), ((1.25, 0.5, 0.5), 0.3))
CASCADE_VIEWS = 14
CASCADE_CAM_DISTANCE = 2.6
CASCADE_INIT_RADIUS = 0.2  # the tests' documented knob for scenes of several cascades
CASCADE_STEPS = (300, 900)  # test_aabb_scale4_scene_trains, ..._outer_sphere_converges
CASCADE_OCC_BAR = 0.5
CASCADE_SDF_BARS = (0.2, 0.022)
CASCADE_SPLIT_X = 0.95  # between the spheres: the mesh has vertices on both sides
# cascade_step_vs_cpu's bounds: the loss's relative difference, and the
# table and MLP gradients within this share of their max, as
# field_agrees_with_cpu bounds the field's.
CASCADE_STEP_LIMITS = (1e-4, 1e-2, 1e-3)
# The step draws' seeds, each held to the limits: seed 5 missed them while
# the card rounded the cone spacing and the ray directions otherwise than
# the CPU (step_agreement.py reads each such form on seeds 5-8).
CASCADE_STEP_SEEDS = (5, 8)
# The CLI's run: test_aabb_scale4_scene_trains' step count.  At 100 steps
# this scene's field is still empty (PERF.md).
CASCADE_CLI_STEPS = CASCADE_STEPS[0]
CLI_LOG_EVERY = 100  # the CLI logs (and writes its scalars) every 100 steps
# cascade_cli's windows: host ms a step over PROFILE_WINDOW steps from
# CLI_PROFILE_AT, which hold step 100's scalars, then device ms a step over
# as many without; and host ms without, then device ms over steps that hold
# step 200's, CLI_LOG_EVERY_LEAD steps before it.
CLI_LOG_EVERY_LEAD = 4
CLI_PROFILE_AT = CLI_LOG_EVERY - CLI_LOG_EVERY_LEAD
DYNAMIC_CLI_STEPS = 100  # dynamic_cli: 2 frames of as many steps
LEGACY_STEPS = 5  # snapshot_phase: steps after a legacy positional-list load
CASCADE16_STEPS = 50
# quality_ab_phase: tests/test_compaction.py's arms (hit_oversample, mask
# loss weight), its 300 steps and its bars, every pair gated.  At
# base.json width through the Testbed: the compaction pair.  At
# tests/e2e_drive.py's own size (QUALITY_AB_E2E_VIEWS training views of a
# QUALITY_AB_E2E_RES^2 sphere scene, its small_config), where the tests
# set their bars: both pairs.  The mask pair at base.json width misses
# its |sdf| bar (PERF.md; ROADMAP.md Queue 3).
QUALITY_AB_ARMS = {"A": (2, 0.1), "B": (1, 0.1), "C": (1, 0.0)}
QUALITY_AB_PAIRS = {"compaction": ("A", "B"), "mask_loss": ("B", "C")}
QUALITY_AB_E2E_VIEWS, QUALITY_AB_E2E_RES = 8, 48
QUALITY_AB_STEPS = 300
QUALITY_AB_PSNR_MARGIN = 1.5
QUALITY_AB_SDF_FACTOR = 1.5
# The batched layouts' index padding past each level's M updates, as the
# JAX package pads them (round_up(M, 128) + 2 * chunk).
STREAM_PAD = 4096
HOLD_CYCLES = 40_000_000  # ~20 ms of spinning at the H100's clock (cuda_ms's hold)


def sha256_of(tensors) -> str:
    """SHA-256 of the tensors' bytes, in order, as the host reads them."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


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


def kernel_phase(torch, st, cfg, f: int, m: int | None = None,
                 label: str = "kernel_phase") -> dict:
    """Segment-sum kernel vs its plain version at the main path's shapes:
    ``cfg.field.grid``'s levels and ``m`` updates a level (default: the
    NeuS step's samples x 8 corners)."""
    _, _, _, sizes, use_hash = cfg.field.grid.level_tables()
    m = m or cfg.n_rays * cfg.samples_per_ray * 8  # samples x corners per level
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
    print(f"{label} " + json.dumps(out), flush=True)
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


def testbed_phase(torch, st, cfg, hyper, steps: int = TESTBED_STEPS,
                  label: str = "testbed_phase") -> dict:
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
    print(f"{label} " + json.dumps(out), flush=True)
    return out, tb


class LossRecorder:
    """Wraps the Testbed module's ``train_step`` and ``parallel_train_step``
    to keep each step's loss tensor (no host sync), leaving the steps as
    they are."""

    STEPS = ("train_step", "parallel_train_step")

    def __init__(self, testbed_module):
        self.module, self.losses = testbed_module, []
        self.steps = {name: getattr(testbed_module, name) for name in self.STEPS}

    def __enter__(self):
        def recorded(step):
            def run(*args, **kw):
                state, aux = step(*args, **kw)
                self.losses.append(aux.loss)
                return state, aux
            return run

        for name, step in self.steps.items():
            setattr(self.module, name, recorded(step))
        return self

    def __exit__(self, *exc):
        for name, step in self.steps.items():
            setattr(self.module, name, step)


def fresh_testbed(tb):
    """A new card Testbed of ``tb``'s config, hyperparameters and seed on
    ``tb``'s scene, untrained."""
    from neus2_tpu_torch.api.testbed import Testbed

    t = Testbed(config=tb.config, hyper=dataclasses.replace(tb.hyper), seed=tb.seed,
                device="cuda")
    t.load_training_data_from_datasets([tb.dataset])
    return t


def same_leaves(a, b, what: str, skip: tuple = ()) -> int:
    """Every leaf of two Testbeds' states (the generator's too, unless
    ``skip`` names it) bitwise equal -> the number of leaves compared."""
    import numpy as np

    from neus2_tpu_torch import interop

    x, y = interop.state_to_pathdict(a.state), interop.state_to_pathdict(b.state)
    for k in skip:
        del x[k], y[k]
    if x.keys() != y.keys():
        raise AssertionError(f"{what}: the leaf keys differ")
    for k in x:
        if x[k].dtype != y[k].dtype or not np.array_equal(x[k], y[k]):
            raise AssertionError(f"{what}: leaf {k} differs")
    return len(x)


def export_reference(t, path: Path) -> dict:
    """``t``'s EMA params, density grid and transform as a reference-format
    snapshot at ``path`` -> its "snapshot" document."""
    from neus2_tpu_torch import interop
    from neus2_tpu_torch.api import msgpack_codec
    from neus2_tpu_torch.api.ngp_snapshot import save_reference_snapshot

    save_reference_snapshot(
        path, interop.tree_to_numpy(t.state.ema_params), t.config.field,
        density_grid=t.state.occupancy.density.cpu().numpy(),
        acc=interop.tree_to_numpy(t.state.acc), aabb_scale=t.config.aabb_scale,
        training_step=t.training_step, loss=t.loss)
    return msgpack_codec.unpackb(path.read_bytes())["snapshot"]


def reference_round_trip(torch, t, d: Path) -> tuple[dict, object]:
    """``t`` exported in the reference format, imported into a fresh
    Testbed and exported again: both documents' ``n_params`` as
    ``ngp_n_params`` says and their blobs byte-equal -> ({n_params, the
    file's MB, save and load s on the host clock}, the importing Testbed)."""
    from neus2_tpu_torch.api.ngp_snapshot import ngp_n_params

    ref = d / "ref.msgpack"
    t0 = time.perf_counter()
    doc = export_reference(t, ref)
    save_s = time.perf_counter() - t0
    imported = fresh_testbed(t)
    t0 = time.perf_counter()
    imported.load_snapshot(ref)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    doc2 = export_reference(imported, d / "ref2.msgpack")
    want = ngp_n_params(t.config.field)
    if not doc["n_params"] == doc2["n_params"] == want:
        raise AssertionError(f"reference n_params {doc['n_params']}, {doc2['n_params']}, "
                             f"ngp_n_params {want}")
    for key in ("params_binary", "density_grid_binary"):
        if doc[key] != doc2[key]:
            raise AssertionError(f"reference re-export: {key} differs")
    return {"n_params": want, "mb": ref.stat().st_size / 1e6, "save_s": save_s,
            "load_s": load_s}, imported


def snapshot_phase(torch, st, tb) -> dict:
    """Snapshots and the pyngp surface on ``testbed_phase``'s trained
    Testbed, as a user saves, resumes and renders a model:

      * a full and an incremental native snapshot, the full one loaded
        into a fresh card Testbed: every leaf (the step generator's state
        too) and ``render(img_idx=0)`` bitwise the original's;
      * RESUME_STEPS more steps on the original and on the resumed
        Testbed, counts reset before each: kernel 1 once a step, finite
        losses, the losses and the final states bitwise equal;
      * the state written as a legacy positional-list snapshot (its leaves
        in the JAX package's flatten order, ``interop.jax_leaf_order``, a
        zero threefry key last) and loaded into a fresh card Testbed: every
        leaf but the generator's (reseeded: the file holds none) bitwise,
        then LEGACY_STEPS steps from it, kernel 1 once a step.  The file
        is written and read through the same ``jax_leaf_order``, so an
        error in that order cancels here: this checks the load and the
        card placement, and tests/test_torch_snapshot.py holds the order
        against JAX's own flatten;
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
    from neus2_tpu_torch.data.dataset import ngp_matrix_to_nerf
    from neus2_tpu_torch.utils.camera_path import orbit_path

    # The bucket is host state no snapshot holds, in either package.
    bucket_fields = ("batch_bucket", "_occ_len_ema", "_bucket_votes", "_bucket_vote_target",
                     "last_aux")
    print("snapshot_phase departures: the resumed Testbed takes the original's host-only "
          f"batch-bucket state {list(bucket_fields)} before the resumed steps", flush=True)

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
        resumed = fresh_testbed(tb)
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

        legacy = Path(d) / "legacy.msgpack"
        flat = interop.state_to_pathdict(tb.state)
        leaves = [flat[k] for k in interop.jax_leaf_order(tb.state)[:-1]]
        legacy.write_bytes(msgpack_codec.packb({
            "leaves": leaves + [np.zeros(2, np.uint32)], "incremental": False,
            "meta": {"training_step": np.int32(tb.training_step),
                     "frame": np.int32(tb.current_training_time_frame)}}))
        from_legacy = fresh_testbed(tb)
        t0 = time.perf_counter()
        from_legacy.load_snapshot(legacy)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        n_legacy = same_leaves(tb, from_legacy, "legacy load", skip=(".generator",))
        losses, launches = train_on(from_legacy, LEGACY_STEPS)
        out["legacy"] = {"leaves": n_legacy, "mb": legacy.stat().st_size / 1e6,
                         "load_s": load_s, "steps": LEGACY_STEPS, "launches": launches,
                         "losses": [float(v) for v in losses]}
        del from_legacy

        ref, imported = reference_round_trip(torch, tb, Path(d))
        out.update({f"reference_{k}": ref[k] for k in ("save_s", "mb", "load_s")})
        losses, n_ref = train_on(imported, REFERENCE_STEPS)
        out["reference"] = {"n_params": ref["n_params"], "steps": REFERENCE_STEPS,
                            "launches": n_ref, "losses": [float(v) for v in losses]}
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


def wide_rows_phase(torch, st, name: str, base: dict) -> dict:
    """``configs/<name>`` as the repo ships it, at its published widths
    (tpu_opt.json: 7 levels x 4 features; l4f8.json: 4 x 8; base.json's
    tables and MLPs otherwise), as testbed_phase drives base.json:

      * the field and its gradients on the card against the CPU
        (``field_agrees_with_cpu``, through kernel 1 at the config's F);
      * testbed_phase's run: TESTBED_STEPS steps on the same scene,
        kernel 1 once a step, the loss finite and falling, two held-out
        views at spp 8 that beat the all-black image, the 256^3 mesh
        passing the sphere checks; host and device ms a step and device
        launches a step over the same profile windows as ``base`` (the
        base.json Testbed's run), printed beside them;
      * a native snapshot loaded into a fresh Testbed, every leaf bitwise,
        and a reference-format export, import and re-export, byte-equal
        blobs of ``ngp_n_params`` values."""
    from neus2_tpu_torch.api.testbed import config_from_json

    cfg, hyper = config_from_json(REPO / "configs" / name)
    grid = cfg.field.grid
    print(f"wide_rows_phase {name}: {grid.n_levels} levels x {grid.n_features_per_level} "
          f"features, 2^{grid.log2_hashmap_size} rows", flush=True)
    field = field_agrees_with_cpu(torch, cfg)
    run_out, tb = testbed_phase(torch, st, cfg, hyper, label=f"wide_rows_phase {name} testbed")
    with tempfile.TemporaryDirectory() as d:
        full = Path(d) / "full.msgpack"
        tb.save_snapshot(full)
        snap_mb = full.stat().st_size / 1e6
        resumed = fresh_testbed(tb)
        resumed.load_snapshot(full)
        n_leaves = same_leaves(tb, resumed, f"{name}: native round trip")
        del resumed
        ref, imported = reference_round_trip(torch, tb, Path(d))
        del imported
    del tb
    keys = ("ms_per_step", "host_ms_per_step", "device_ms_per_step", "device_launches_per_step")
    out = {"config": name, "levels": grid.n_levels, "F": grid.n_features_per_level,
           "field_vs_cpu": field, **run_out, "snapshot_leaves": n_leaves,
           "snapshot_mb": snap_mb, "reference_n_params": ref["n_params"],
           **{f"base_json_{k}": base[k] for k in keys}}
    print(f"wide_rows_phase {name} " + json.dumps({k: out[k] for k in (
        "config", "levels", "F", "steps", "launches", "launches_per_step", "loss_first",
        "loss_last", "snapshot_leaves", "snapshot_mb", "reference_n_params", *keys,
        *(f"base_json_{k}" for k in keys))}), flush=True)
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
                prof, prof_from = profile(activities=[ProfilerActivity.CUDA]), len(steps)
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
                evs = device_events(prof)
                top = [{"name": e.key[:60],
                        "ms_per_step": e.self_device_time_total / 1e3 / PROFILE_WINDOW}
                       for e in evs[:5]]
                traced.setdefault((k, phase), []).append(
                    (device_ms_per_step(evs, PROFILE_WINDOW), top))
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


def dynamic_cli(torch, st, hyper) -> dict:
    """The CLI on a dynamic scene at full base.json width with
    ``--tensorboard``: 2 frames of DYNAMIC_CLI_STEPS steps each (16 views
    at SCENE_RES^2 a frame, the sphere moved by DYNAMIC_SHIFT), written
    with ``save_dataset_na`` as a directory of per-frame jsons.  Kernel 1
    once a step that trains the field (not in frame 1's
    ``predict_global_movement_training_step`` steps of pose refinement),
    and the event files to ``tensorboard_matches_log``: the global writer
    at steps 100 and 200, frame k's writer at its own step 100."""
    from neus2_tpu_torch import run
    from neus2_tpu_torch.data.export import save_dataset_na
    from neus2_tpu_torch.data.synthetic import make_moving_sphere_frames

    with tempfile.TemporaryDirectory() as d:
        scene = Path(d) / "dynamic"
        scene.mkdir()
        frames = make_moving_sphere_frames(n_frames=2, translation_per_frame=DYNAMIC_SHIFT,
                                           n_views=16, resolution=SCENE_RES)
        for k, ds in enumerate(frames):
            js = save_dataset_na(ds, Path(d) / f"frame{k}")
            meta = json.loads(js.read_text())
            for f in meta["frames"]:
                f["file_path"] = str(js.parent / f["file_path"])
            (scene / f"frame_{k:03d}.json").write_text(json.dumps(meta))
        torch.cuda.synchronize()
        reset_launches(st)
        t0 = time.perf_counter()
        tb = run.main(["--scene", str(scene), "--network", str(REPO / "configs" / "base.json"),
                       "--n_steps", str(DYNAMIC_CLI_STEPS), "--next_frame_steps",
                       str(DYNAMIC_CLI_STEPS), "--output_dir", d, "--name", "dyn",
                       "--tensorboard"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = st.segment_sum_rows.launches
        scalars = tensorboard_matches_log(
            Path(d) / "dyn", [DYNAMIC_CLI_STEPS, 2 * DYNAMIC_CLI_STEPS],
            {0: [DYNAMIC_CLI_STEPS], 1: [DYNAMIC_CLI_STEPS]})
    refine = hyper.predict_global_movement_training_step if hyper.predict_global_movement else 0
    out = {"frames": tb.current_training_time_frame + 1, "frame_step": tb.training_step,
           "launches": launches, "refine_steps": refine, "wall_s": wall_s,
           "tensorboard": scalars}
    print("dynamic_cli " + json.dumps(out), flush=True)
    if (out["frames"], tb.training_step, launches) != (2, DYNAMIC_CLI_STEPS,
                                                      2 * DYNAMIC_CLI_STEPS - refine):
        raise AssertionError(f"dynamic CLI: {out}")
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
    step; a Testbed trained before goes on from its step, and the steps
    counted are this run's.  Host ms a step over the steps after the
    first WARMUP_STEPS, the traced
    ones and the trace's analysis left out; with ``profile_at``, host ms a step over PROFILE_WINDOW
    steps from that step, then device ms, device kernel launches and the
    top kernels a step over as many traced.  The loss reads are those of
    step 1 and every 16th step.  Fails unless kernel 1 ran once a step and
    every loss is finite."""
    from torch.profiler import ProfilerActivity, profile

    from neus2_tpu_torch.api import testbed as testbed_mod

    launches_after, prof, out = [], None, {}
    traced_s, t_warm, first = 0.0, None, tb.training_step
    torch.cuda.synchronize()
    reset_launches(st)
    t_start = time.perf_counter()
    with LossRecorder(testbed_mod) as rec:
        while True:
            if tb.training_step == first + WARMUP_STEPS:
                torch.cuda.synchronize()
                t_warm = time.perf_counter()
            if tb.training_step == profile_at:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if profile_at is not None and tb.training_step == profile_at + PROFILE_WINDOW:
                torch.cuda.synchronize()
                t_trace = time.perf_counter()
                out["host_ms_per_step"] = (t_trace - t0) * 1e3 / PROFILE_WINDOW
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.start()
            if not tb.frame():
                break
            launches_after.append(st.segment_sum_rows.launches)
            if prof is not None and tb.training_step == profile_at + 2 * PROFILE_WINDOW:
                torch.cuda.synchronize()
                prof.stop()
                evs = device_events(prof)
                out["device_ms_per_step"] = device_ms_per_step(evs, PROFILE_WINDOW)
                out["device_launches_per_step"] = sum(e.count for e in evs) / PROFILE_WINDOW
                out["top_device"] = [{"name": e.key[:60], "ms_per_step":
                                      e.self_device_time_total / 1e3 / PROFILE_WINDOW}
                                     for e in evs[:8]]
                nccl = [e for e in evs if e.key.startswith("nccl")]
                out["nccl_ms_per_step"] = (sum(e.self_device_time_total for e in nccl)
                                           / 1e3 / PROFILE_WINDOW)
                out["nccl_kernels"] = [{"name": e.key[:60], "calls_per_step": e.count / PROFILE_WINDOW,
                                        "ms_per_step": e.self_device_time_total / 1e3 / PROFILE_WINDOW}
                                       for e in nccl]
                prof = None
                traced_s = time.perf_counter() - t_trace  # the trace's analysis too
            if on_step is not None:
                on_step(tb)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    out["wall_s"] = t_end - t_start
    steps = tb.training_step - first
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
    with the lens and, from a copy of their json without k1-p2, without
    it (``run.evaluate`` renders a held-out view through the lens its json
    names, as the JAX package's does); then
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
        meta = json.loads(held.read_text())
        for k in ("k1", "k2", "p1", "p2"):
            del meta[k]
        held_plain = held.with_name("held_out_no_lens.json")
        held_plain.write_text(json.dumps(meta))
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
        for name, views in (("with_lens", held), ("lens_stripped", held_plain)):
            t0 = time.perf_counter()
            psnrs, ssims = run.evaluate(tb, str(views), EVAL_SPP, lambda *a: None)
            held_psnr[name] = {"psnr": psnrs, "ssim": ssims,
                               "eval_s": time.perf_counter() - t0}
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


def held_out_views(torch, tb, what: str, held=None) -> list:
    """The views of ``held`` (by default the two held-out views of camera
    seed 1 of the 256^2 sphere scene) rendered at the eval protocol (spp
    8, black background, min transmittance 1e-4) and scored -> per view
    {psnr, ssim, black_psnr, render_ms}.  Fails unless each render is
    finite and beats the all-black image."""
    from neus2_tpu_torch.data.synthetic import make_sphere_dataset
    from neus2_tpu_torch.engine.render import RenderConfig, render_image
    from neus2_tpu_torch.ops.image import psnr, srgb_eval_target, ssim

    if held is None:
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



class Patched:
    """``module.name`` replaced by ``wrap(original)`` inside a with block:
    how a phase watches a step or a host call of a path it drives through
    the CLI."""

    def __init__(self, module, name: str, wrap):
        self.module, self.name, self.wrap = module, name, wrap

    def __enter__(self):
        self.original = getattr(self.module, self.name)
        setattr(self.module, self.name, self.wrap(self.original))
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.original)


def host_timer(torch, sink: list):
    """A wrapper that appends each call's seconds (the card synchronized
    before and after) to ``sink``."""
    def wrap(fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            sink.append(time.perf_counter() - t0)
            return out
        return timed
    return wrap


class StepWindows:
    """A step wrapped for one run: from step ``profile_at`` host ms a step
    over PROFILE_WINDOW steps, then device ms, device launches and the top
    kernels a step over as many traced with ``torch.profiler``."""

    def __init__(self, torch, profile_at: int):
        self.torch, self.profile_at = torch, profile_at
        self.out, self.prof, self.steps = {}, None, 0

    def seen(self, out) -> None:
        """Called with each step's result."""

    def __call__(self, fn):
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch

        def step(*args, **kw):
            if self.steps == self.profile_at:
                torch.cuda.synchronize()
                self.t0 = time.perf_counter()
            if self.steps == self.profile_at + PROFILE_WINDOW:
                torch.cuda.synchronize()
                self.out["host_ms_per_step"] = ((time.perf_counter() - self.t0) * 1e3
                                                / PROFILE_WINDOW)
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.start()
            out = fn(*args, **kw)
            self.seen(out)
            self.steps += 1
            if self.prof is not None and self.steps == self.profile_at + 2 * PROFILE_WINDOW:
                torch.cuda.synchronize()
                self.prof.stop()
                evs = device_events(self.prof)
                self.out["device_ms_per_step"] = device_ms_per_step(evs, PROFILE_WINDOW)
                self.out["device_launches_per_step"] = sum(e.count for e in evs) / PROFILE_WINDOW
                self.out["top_device"] = [{"name": e.key[:60], "ms_per_step":
                                           e.self_device_time_total / 1e3 / PROFILE_WINDOW}
                                          for e in evs[:8]]
                self.prof = None
            return out

        return step


class FitRecorder(StepWindows):
    """A fit mode's step (it returns (params, opt_state, loss)) under
    StepWindows, each step's loss kept (no host sync)."""

    def __init__(self, torch, profile_at: int):
        super().__init__(torch, profile_at)
        self.losses = []

    def seen(self, out) -> None:
        self.losses.append(out[2])

    def loss_curve(self, what: str) -> list:
        """Every loss as a float; fails unless all are finite and the last
        16 steps' mean is below the first 16's."""
        losses = self.torch.stack(self.losses).float().cpu().tolist()
        if not all(v == v and abs(v) < 1e30 for v in losses):
            raise AssertionError(f"{what}: non-finite losses")
        first, last = sum(losses[:16]) / 16, sum(losses[-16:]) / 16
        if not last < first:
            raise AssertionError(f"{what}: the loss did not fall: {first} -> {last}")
        return losses


def grads_agree(torch, card, cpu, n_tables: int, limits: tuple, what: str) -> dict:
    """Gradient trees (tables first) from the card and the CPU: the worst
    |diff| / max|cpu| of the tables and of the rest, each within its limit."""
    from neus2_tpu_torch.utils.tree import tree_leaves

    worst = {"tables": 0.0, "mlp": 0.0}
    for i, (a, b) in enumerate(zip(tree_leaves(card), tree_leaves(cpu))):
        a = a.cpu()
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{what}: bad gradient {i} {tuple(a.shape)}")
        kind = "tables" if i < n_tables else "mlp"
        worst[kind] = max(worst[kind],
                          float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12))
    if worst["tables"] > limits[0] or worst["mlp"] > limits[1]:
        raise AssertionError(f"{what}: the card disagrees with the CPU: {worst}")
    return worst


def sdf_step(torch, device: str):
    """The SDF mode's step check at full width (``default_sdf_field``,
    params of seed 0) on ``device``: the fit loss on 2^16 points of the
    CSG scene (seed 4) -> (loss, gradient tree)."""
    import numpy as np

    from neus2_tpu_torch.data.synthetic import csg_sdf
    from neus2_tpu_torch.engine import sdf_mode
    from neus2_tpu_torch.utils.tree import tree_map

    cfg = sdf_mode.SdfFitConfig()
    params, _ = sdf_mode.init_sdf_fit(cfg, seed=0, device="cpu")
    pts = torch.rand((cfg.batch_size, 3), generator=torch.Generator().manual_seed(4))
    target = torch.from_numpy(csg_sdf(pts.numpy()).astype(np.float32))
    x, y = pts.to(device), target.to(device)
    return sdf_mode.value_and_grads(
        lambda p: sdf_mode.fit_loss(sdf_mode.sdf_fn(p, x, cfg.field)[0], y, cfg.loss),
        tree_map(lambda t: t.to(device), params))


def write_csg_mesh(path: Path, res: int) -> int:
    """``csg_sdf`` on a res^3 lattice of cell centres of the unit cube,
    through the port's marching cubes, normalized and written as an OBJ;
    returns its triangle count."""
    import numpy as np

    from neus2_tpu_torch.data.synthetic import csg_sdf
    from neus2_tpu_torch.engine.mesh import save_mesh_obj
    from neus2_tpu_torch.engine.sdf_mode import normalize_mesh
    from neus2_tpu_torch.native import marching_cubes

    xs = (np.arange(res, dtype=np.float32) + 0.5) / res
    grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1)
    verts, tris = marching_cubes(csg_sdf(grid).astype(np.float32))
    verts, _, _ = normalize_mesh(((verts + 0.5) / res).astype(np.float32))
    save_mesh_obj(path, verts, tris)
    return int(len(tris))


def sdf_phase(torch, st) -> dict:
    """The SDF-from-mesh mode at full width (``default_sdf_field``: 14 x 2
    levels, 2^19 rows, SDF MLP 64 x 2; batch 2^16, pool 2^21), as a user
    runs it: ``run.main(["--mode", "sdf", ...])`` on the CSG scene's mesh
    for SDF_STEPS steps with ``--save_mesh``.

    Before it: kernel 1 against its plain version at the mode's shape
    (2^16 points x 8 corners a level), and one step's loss and gradients
    on the card against the CPU on the same params and batch (loss rtol
    1e-4, tables within 1e-2 of their max: bf16-quantized sums on the
    card; the MLP within 1e-3).  Then the run, with the counts set to 0
    just before: the BVH build and pool host seconds, the losses, host and
    device ms a step over windows from step SDF_PROFILE_AT, the 512^2
    render's ms, the mesh.  Fails unless kernel 1 ran once a step and no
    other kernel ran, the loss fell, the IoU on 200k points beats
    SDF_IOU_BAR and the mean |sdf| at surface points is below 0.01."""
    import numpy as np

    from neus2_tpu_torch import run
    from neus2_tpu_torch.engine import sdf_mode
    from neus2_tpu_torch.utils.tree import tree_leaves

    cfg = sdf_mode.SdfFitConfig()
    kernel = kernel_phase(torch, st, cfg, 2, m=cfg.batch_size * 8, label="sdf_kernel_phase")

    launches = segment_sum_launches()
    (card_loss, card), (cpu_loss, cpu) = sdf_step(torch, "cuda"), sdf_step(torch, "cpu")
    if segment_sum_launches() != launches + 1:
        raise AssertionError("sdf step check: the card's backward skipped kernel 1")
    loss_rel = abs(float(card_loss) - float(cpu_loss)) / abs(float(cpu_loss))
    if loss_rel > 1e-4:
        raise AssertionError(f"sdf step check: loss {float(card_loss)} vs {float(cpu_loss)}")
    vs_cpu = {"loss_rel": loss_rel,
              **grads_agree(torch, card, cpu, cfg.field.grid.n_levels, (1e-2, 1e-3), "sdf step"),
              "card_sha256": sha256_of([card_loss, *tree_leaves(card)])}

    # The BVH's library is built at first use: build it outside the timed
    # BVH build.
    t0 = time.perf_counter()
    sdf_mode.TriangleBVH(np.eye(3, dtype=np.float32), np.array([[0, 1, 2]], np.int32))
    bvh_lib_s = time.perf_counter() - t0
    bvh_s, pool_s, render_s = [], [], []
    rec = FitRecorder(torch, SDF_PROFILE_AT)
    with tempfile.TemporaryDirectory() as d:
        obj = Path(d) / "csg.obj"
        n_tris_in = write_csg_mesh(obj, SDF_MESH_RES)
        with Patched(sdf_mode, "TriangleBVH", host_timer(torch, bvh_s)), \
                Patched(sdf_mode, "generate_training_pool", host_timer(torch, pool_s)), \
                Patched(sdf_mode, "render_sdf_sphere_traced", host_timer(torch, render_s)), \
                Patched(sdf_mode, "sdf_fit_step", rec):
            torch.cuda.synchronize()
            reset_launches(st)
            t0 = time.perf_counter()
            res = run.main(["--mode", "sdf", "--scene", str(obj), "--save_mesh",
                            "--n_steps", str(SDF_STEPS), "--output_dir", d, "--name", "sdf"])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = {k.__name__: k.launches for k in st.KERNELS}
        ev = json.loads((Path(d) / "sdf" / "logs" / "sdf_eval.json").read_text())
        png_ok = (Path(d) / "sdf" / "sdf_render.png").exists()
        mesh_ok = (Path(d) / "sdf" / "mesh" / "sdf_mesh.obj").exists()
    losses = rec.loss_curve("sdf_phase")
    if len(losses) != SDF_STEPS or launches["segment_sum_rows"] != SDF_STEPS:
        raise AssertionError(f"sdf_phase: {len(losses)} steps, kernel launches {launches}")
    if any(n for k, n in launches.items() if k != "segment_sum_rows"):
        raise AssertionError(f"sdf_phase: another kernel ran: {launches}")
    if not (png_ok and mesh_ok and ev["iou"] == res["iou"]):
        raise AssertionError("sdf_phase: the CLI's outputs are missing")

    verts, faces = res["mesh"]
    surf, _ = sdf_mode.generate_training_pool(res["bvh"], verts, faces, 8192, seed=3)
    with torch.no_grad():
        pred, _ = sdf_mode.sdf_fn(res["params"], torch.from_numpy(surf[:4096]).to("cuda"),
                                  cfg.field)
    surface_abs = float(pred.abs().mean())
    out = {
        "steps": len(losses), "launches": launches["segment_sum_rows"],
        "mesh_triangles_in": n_tris_in, "bvh_lib_build_s": bvh_lib_s, "bvh_build_s": bvh_s[0],
        "pool_s": pool_s[0],
        "wall_s": wall_s, "loss_first": losses[0], "loss_last": losses[-1],
        **rec.out, "iou": res["iou"], "surface_abs_sdf": surface_abs,
        "render_512_ms": render_s[0] * 1e3, "mesh_triangles_out": int(len(res["sdf_mesh"][1])),
        "step_vs_cpu": vs_cpu, "kernel": kernel,
        "params_sha256": sha256_of(tree_leaves(res["params"])),
    }
    print("sdf_phase " + json.dumps(out), flush=True)
    if not (res["iou"] > SDF_IOU_BAR and surface_abs < 0.01):
        raise AssertionError(f"sdf_phase: IoU {res['iou']}, surface |sdf| {surface_abs}")
    return out


def write_target_png(path: Path, n: int) -> None:
    """tests/test_image_mode.py's kind of target at n^2: smooth x / y /
    radial gradients with a hard flip of the (+x, +y) quadrant, 8-bit."""
    import numpy as np
    from PIL import Image

    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / (n - 1)
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2)
    img = np.stack([x, y, np.clip(1.5 * r, 0, 1)], -1)
    quad = (x > 0.5) & (y > 0.5)
    img[quad] = 1.0 - img[quad]
    Image.fromarray((img * 255 + 0.5).astype(np.uint8)).save(path)


def image_kernel_phase(torch, st, cfg) -> dict:
    """Kernel 4 at the image mode's shapes: each level's 4 x batch corner
    updates of uniform positions, sorted, against the plain version (two
    launches bitwise equal, within 1e-5 max|ref| + 1e-7), with its time,
    the plain version's, ``index_add_``'s and the bytes bound, a level
    and summed over the step's levels."""
    from neus2_tpu_torch.engine import image_mode

    g = torch.Generator(device="cuda").manual_seed(6)
    pos = torch.rand((cfg.batch_size, 2), generator=g, device="cuda")
    f = cfg.n_features_per_level
    levels, err = [], 0.0
    for res, rows in cfg.level_tables():
        idx = torch.cat([i for i, _ in image_mode._level_corners(pos, res, rows)])
        upd = torch.randn((idx.shape[0], f), generator=g, device="cuda")
        idx_s, order = torch.sort(idx, stable=True)
        keys, vals = idx_s.to(torch.int32), upd[order].t().contiguous()
        err = max(err, max_level_err(torch, "segment_sum_planar_rows (image)",
                                     st.segment_sum_planar_rows(keys, vals, rows),
                                     st.segment_sum_planar_rows(keys, vals, rows),
                                     st.sorted_segment_sum_tiles_ref(keys, vals, rows)))
        m = idx.shape[0]
        bound_ms, bound_by = bound(m * 4 + m * 4 * f + rows * f * 4, m * f)
        levels.append({
            "res": res, "rows": rows, "dense": res * res <= rows, "updates": m,
            "kernel_ms": cuda_ms(torch, lambda: st.segment_sum_planar_rows(keys, vals, rows)),
            "held_ms": cuda_ms(torch, lambda: st.segment_sum_planar_rows(keys, vals, rows),
                               hold=True),
            "plain_ms": cuda_ms(torch, lambda: st.sorted_segment_sum_tiles_ref(keys, vals, rows),
                                iters=3),
            "library_ms": cuda_ms(torch, lambda: torch.zeros((f, rows), device="cuda")
                                  .index_add_(1, idx_s, vals), iters=5),
            "entry_ms": cuda_ms(torch, lambda: image_mode.level_table_grad(idx, upd, rows)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
    out = {"max_abs_err": err, "levels": levels,
           **{f"{k}_per_step": sum(lv[k] for lv in levels)
              for k in ("kernel_ms", "held_ms", "plain_ms", "library_ms", "entry_ms",
                        "bound_ms")}}
    print("image_kernel_phase " + json.dumps(out), flush=True)
    return out


def image_phase(torch, st) -> dict:
    """The image-fit mode at ``Image2DConfig``'s defaults (12 x 2 levels,
    2^18 rows, MLP 64 x 2, batch 2^16), as a user runs it:
    ``run.main(["--mode", "image", ...])`` on a 512^2 PNG for
    IMAGE_STEPS steps.

    Before it: kernel 4 at the mode's shapes (``image_kernel_phase``), and
    one step's table gradients on the card (kernel 4 once a level) against
    the CPU's ``index_add_`` on the same params and positions, within
    1e-5 max|ref| + 1e-7, two runs bitwise equal.  Then the run, with the
    counts set to 0 just before: the losses, host and device ms a step
    over windows from step IMAGE_PROFILE_AT.  Fails unless kernel 4 ran
    once a level and step and no other kernel ran, the loss fell and the
    PSNR beats IMAGE_PSNR_BAR."""
    from neus2_tpu_torch import run
    from neus2_tpu_torch.engine import image_mode
    from neus2_tpu_torch.utils.tree import tree_map

    cfg = image_mode.Image2DConfig()
    with tempfile.TemporaryDirectory() as d:
        png = Path(d) / "target.png"
        write_target_png(png, IMAGE_RES)
        image = torch.from_numpy(run._read_image(png)).to("cuda")
        kernel = image_kernel_phase(torch, st, cfg)

        params = image_mode.init_image_params(torch.Generator().manual_seed(0), cfg)
        pos = torch.rand((cfg.batch_size, 2), generator=torch.Generator().manual_seed(5))

        def grads(device):
            x, im = pos.to(device), image.to(device)
            return image_mode.value_and_grads(
                lambda p: image_mode.fit_loss(image_mode.image_forward(p, x, cfg),
                                              image_mode._bilinear_fetch(im, x), "relative_l2"),
                tree_map(lambda t: t.to(device), params))

        before = st.segment_sum_planar_rows.launches
        (_, card), (_, again), (_, cpu) = grads("cuda"), grads("cuda"), grads("cpu")
        if st.segment_sum_planar_rows.launches != before + 2 * cfg.n_levels:
            raise AssertionError("image step check: kernel 4 not once a level")
        table_err = 0.0
        for lvl, (a, b, c) in enumerate(zip(card["tables"], again["tables"], cpu["tables"])):
            if not torch.equal(a, b):
                raise AssertionError(f"image step check: level {lvl} differs between runs")
            e = float((a.cpu() - c).abs().max())
            if e > 1e-5 * float(c.abs().max()) + 1e-7:
                raise AssertionError(f"image step check: level {lvl} max|diff| {e}")
            table_err = max(table_err, e / max(float(c.abs().max()), 1e-12))
        vs_cpu = {"tables_rel": table_err,
                  "mlp": grads_agree(torch, card["mlp"], cpu["mlp"], 0, (0.0, 1e-4),
                                     "image step")["mlp"]}

        rec = FitRecorder(torch, IMAGE_PROFILE_AT)
        with Patched(image_mode, "image_fit_step", rec):
            torch.cuda.synchronize()
            reset_launches(st)
            t0 = time.perf_counter()
            res = run.main(["--mode", "image", "--scene", str(png), "--n_steps",
                            str(IMAGE_STEPS), "--output_dir", d, "--name", "image"])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = {k.__name__: k.launches for k in st.KERNELS}
        ev = json.loads((Path(d) / "image" / "logs" / "image_eval.json").read_text())
        recon_ok = (Path(d) / "image" / "image_recon.png").exists()
    losses = rec.loss_curve("image_phase")
    want = cfg.n_levels * IMAGE_STEPS
    if len(losses) != IMAGE_STEPS or launches["segment_sum_planar_rows"] != want:
        raise AssertionError(f"image_phase: {len(losses)} steps, kernel launches {launches}")
    if any(n for k, n in launches.items() if k != "segment_sum_planar_rows"):
        raise AssertionError(f"image_phase: another kernel ran: {launches}")
    if not (recon_ok and ev["psnr"] == res["psnr"]):
        raise AssertionError("image_phase: the CLI's outputs are missing")
    out = {
        "steps": len(losses), "launches": launches["segment_sum_planar_rows"],
        "wall_s": wall_s, "loss_first": losses[0], "loss_last": losses[-1], **rec.out,
        "psnr": res["psnr"], "step_vs_cpu": vs_cpu,
        "kernel": {k: v for k, v in kernel.items() if k != "levels"},
    }
    print("image_phase " + json.dumps(out), flush=True)
    if not res["psnr"] > IMAGE_PSNR_BAR:
        raise AssertionError(f"image_phase: PSNR {res['psnr']} dB")
    return out


def mesh_outputs_phase(torch, tb) -> dict:
    """The CLI's mesh outputs on the Testbed phase's trained state: its
    256^3 mesh rasterized from held-out view 0 (normal map and shaded,
    ``render_mesh_image``; the silhouette against the view's alpha), the
    Chamfer distance to the true sphere's mesh (marching cubes of
    ``sphere_sdf`` at 256^3) on the card, REFINE_ITERS iterations of
    ``refine_vertices`` with the mean |sdf| at the vertices before and
    after, and ``hashgrid_level_stats``.  Fails unless the silhouettes
    agree on 98% of the pixels, the Chamfer distance is below 0.01, the
    refinement lowers the mean |sdf| and every level has its stats."""
    import numpy as np

    from neus2_tpu_torch.data.synthetic import make_sphere_dataset, sphere_sdf
    from neus2_tpu_torch.engine.mesh import chamfer_distance, extract_mesh, refine_vertices
    from neus2_tpu_torch.models.field import sdf_fn
    from neus2_tpu_torch.native import marching_cubes, render_mesh_image
    from neus2_tpu_torch.ops.warp import scene_aabb
    from neus2_tpu_torch.utils.introspect import hashgrid_level_stats

    params, field = tb.state.ema_params, tb.config.field
    box = scene_aabb(tb.config.aabb_scale)
    verts, tris = extract_mesh(params, field, resolution=MESH_RES, box=box, aabb=box)
    held = make_sphere_dataset(n_views=2, resolution=SCENE_RES, seed=1)
    args = (verts, tris, held.poses[0], held.focal[0], held.principal[0], held.resolution)
    t0 = time.perf_counter()
    render_mesh_image(*args)  # the first call builds native/mesh_raster.cpp
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rgb, depth = render_mesh_image(*args)
    raster_s = time.perf_counter() - t0
    shaded, _ = render_mesh_image(*args, shaded=True)
    hit = depth > 0
    silhouette = float(np.mean(hit == (held.images[0, ..., 3] > 0.5)))
    grey = shaded[hit]
    if not (hit.mean() > 0.05 and (~hit).any() and (grey == grey[:, :1]).all()
            and 0.0 <= rgb.min() and rgb.max() <= 1.0 and silhouette > 0.95):
        raise AssertionError(f"mesh render: {int(hit.sum())} hits, silhouette {silhouette}")

    xs = (np.arange(MESH_RES, dtype=np.float32) + 0.5) / MESH_RES
    grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1)
    true_v, _ = marching_cubes(sphere_sdf(grid).astype(np.float32))
    true_v = ((true_v + 0.5) / MESH_RES).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chamfer = chamfer_distance(verts, true_v, device="cuda")
    chamfer_s = time.perf_counter() - t0

    v = torch.from_numpy(np.ascontiguousarray(verts)).to("cuda")
    with torch.no_grad():
        before = float(sdf_fn(params, v, field)[0].abs().mean())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refined = refine_vertices(params, field, v, n_iters=REFINE_ITERS)
        torch.cuda.synchronize()
        refine_s = time.perf_counter() - t0
        after = float(sdf_fn(params, refined, field)[0].abs().mean())

    stats = hashgrid_level_stats(tb.state.params)
    out = {
        "mesh_vertices": int(len(verts)), "mesh_triangles": int(len(tris)),
        "raster_first_ms": first_s * 1e3, "raster_ms": raster_s * 1e3,
        "raster_hits": int(hit.sum()),
        "silhouette_agreement": silhouette, "chamfer": chamfer, "chamfer_ms": chamfer_s * 1e3,
        "refine_abs_sdf_before": before, "refine_abs_sdf_after": after,
        "refine_ms": refine_s * 1e3,
        "level_fraczero": [round(s["fraczero"], 4) for s in stats],
        "level_sigma": [s["sigma"] for s in stats],
    }
    print("mesh_outputs_phase " + json.dumps(out), flush=True)
    if not (chamfer < 0.05 and after < before and len(stats) == field.grid.n_levels
            and all(s["size"] == s["count"] + s["numzero"] for s in stats)):
        raise AssertionError(f"mesh outputs: {out}")
    return out


def cascade_scene(n_views: int, seed: int, aabb_scale: int = 4):
    """tests/test_cascades.py's scene at SCENE_RES^2: a sphere in the unit
    cube and one outside it (CASCADE_SPHERES), cameras at distance 2.6."""
    import numpy as np

    from neus2_tpu_torch.data.synthetic import make_multi_sphere_dataset

    return make_multi_sphere_dataset(
        [(np.array(c, np.float32), r) for c, r in CASCADE_SPHERES], n_views=n_views,
        resolution=SCENE_RES, cam_distance=CASCADE_CAM_DISTANCE, seed=seed,
        aabb_scale=aabb_scale)


def outer_sphere_reads(torch, tb) -> dict:
    """tests/test_cascades.py's two reads of the outer sphere: the share of
    24 points on its xz great circle that ``occupancy_at`` marks occupied,
    and the EMA field's mean |sdf| over 32 points on its xy great circle."""
    import numpy as np

    from neus2_tpu_torch.engine.occupancy import occupancy_at
    from neus2_tpu_torch.models.field import sdf_fn
    from neus2_tpu_torch.ops.warp import scene_aabb, warp_position

    (centre, radius) = CASCADE_SPHERES[1]
    ring_t = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    ring = np.array(centre) + radius * np.stack(
        [np.cos(ring_t), np.zeros_like(ring_t), np.sin(ring_t)], -1)
    circle_t = np.linspace(0, 2 * np.pi, 32, endpoint=False)
    circle = np.array(centre) + radius * np.stack(
        [np.cos(circle_t), np.sin(circle_t), np.zeros_like(circle_t)], -1)
    ring, circle = (torch.tensor(a, dtype=torch.float32, device="cuda") for a in (ring, circle))
    box = scene_aabb(tb.config.aabb_scale)
    with torch.no_grad():
        sdf, _ = sdf_fn(tb.state.ema_params, warp_position(circle, box), tb.config.field)
    return {"ring_occupied": float(occupancy_at(tb.state.occupancy, ring).float().mean()),
            "outer_abs_sdf": float(sdf.abs().mean())}


def cascade_train(torch, st, cfg, hyper) -> tuple[dict, object]:
    """(a)-(c) of cascade_phase: the aabb_scale-4 Testbed's derived config,
    its prior sweep (seconds, peak memory, the outer ring's occupancy), then
    CASCADE_STEPS[0] steps with a traced window and CASCADE_STEPS[1] in
    all, the outer sphere read after each -> (numbers, the Testbed)."""
    from neus2_tpu_torch.api import testbed as testbed_mod
    from neus2_tpu_torch.api.testbed import Testbed

    first, last = CASCADE_STEPS
    tb = Testbed(config=cfg, seed=0, device="cuda",
                 hyper=dataclasses.replace(hyper, first_frame_max_training_step=first))
    sweep_s = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Patched(testbed_mod, "occupancy_prior_sweep", host_timer(torch, sweep_s)):
        tb.load_training_data_from_datasets([cascade_scene(CASCADE_VIEWS, seed=0)])
    c = tb.config
    derived = {"aabb_scale": c.aabb_scale, "occ_cascades": c.occ_cascades,
               "n_candidates": c.n_candidates, "occ_n_probe": c.occ_n_probe,
               "cone_angle": c.cone_angle}
    if (c.aabb_scale, c.occ_cascades, c.n_candidates, c.occ_n_probe) != (4, 3, 512, 1 << 17):
        raise AssertionError(f"cascade phase: derived config {derived}")
    out = {"derived": derived, "prior_sweep_s": sweep_s[0],
           "prior_sweep_updates": tb.state.occupancy.ema_step,
           "prior_sweep_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "after_sweep": outer_sphere_reads(torch, tb)}
    if not out["after_sweep"]["ring_occupied"] > CASCADE_OCC_BAR:
        raise AssertionError(f"cascade phase: the prior sweep left the outer sphere "
                             f"unoccupied {out['after_sweep']}")
    torch.cuda.reset_peak_memory_stats()
    out["first"] = run_testbed(torch, st, tb, TESTBED_PROFILE_AT)
    out["at_first"] = outer_sphere_reads(torch, tb)
    if not (out["at_first"]["ring_occupied"] > CASCADE_OCC_BAR
            and out["at_first"]["outer_abs_sdf"] < CASCADE_SDF_BARS[0]):
        raise AssertionError(f"cascade phase: after {first} steps {out['at_first']}")
    tb.first_frame_max_training_step = last
    out["rest"] = run_testbed(torch, st, tb)
    out["at_last"] = outer_sphere_reads(torch, tb)
    out["train_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print("cascade_phase train " + json.dumps(out), flush=True)
    if not out["at_last"]["outer_abs_sdf"] < CASCADE_SDF_BARS[1]:
        raise AssertionError(f"cascade phase: after {last} steps {out['at_last']}")
    return out, tb


def cascade_outputs(torch, tb) -> dict:
    """(d) of cascade_phase: the held-out views, the mesh over the
    aabb_scale-4 box with both spheres in it, a native snapshot round trip
    (every leaf bitwise, the 3 cascades restored) and a reference-format
    one (byte-equal blobs, a density grid of 3 x 128^3 cells)."""
    from neus2_tpu_torch.api import msgpack_codec
    from neus2_tpu_torch.ops.warp import scene_aabb

    tb.prepare_for_test()
    views = held_out_views(torch, tb, "cascade phase", held=cascade_scene(2, seed=1))
    box = scene_aabb(tb.config.aabb_scale)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        verts, tris = tb.compute_and_save_marching_cubes_mesh(Path(d) / "mesh.ply",
                                                              resolution=MESH_RES)
        mesh_s = time.perf_counter() - t0
        world_x = box.lo[0] + verts[:, 0] * box.diag[0]
        sides = (int((world_x < CASCADE_SPLIT_X).sum()), int((world_x > CASCADE_SPLIT_X).sum()))
        full = Path(d) / "full.msgpack"
        tb.save_snapshot(full)
        resumed = fresh_testbed(tb)
        resumed.load_snapshot(full)
        n_leaves = same_leaves(tb, resumed, "cascade phase: native round trip")
        cascades = (resumed.config.occ_cascades, resumed.state.occupancy.n_cascades)
        del resumed
        snap_mb = full.stat().st_size / 1e6
        ref, imported = reference_round_trip(torch, tb, Path(d))
        del imported
        doc = msgpack_codec.unpackb((Path(d) / "ref.msgpack").read_bytes())["snapshot"]
    grid_cells = len(doc["density_grid_binary"]) // 2  # fp16
    out = {"views": views, "mesh_triangles": int(len(tris)), "mesh_s": mesh_s,
           "mesh_vertices_by_side": sides, "snapshot_leaves": n_leaves,
           "snapshot_cascades": cascades, "snapshot_mb": snap_mb,
           "reference_n_params": ref["n_params"], "reference_density_cells": grid_cells}
    print("cascade_phase outputs " + json.dumps(out), flush=True)
    if len(tris) <= 1000 or min(sides) == 0:
        raise AssertionError(f"cascade phase: mesh {len(tris)} triangles, {sides} vertices "
                             f"on each side of x = {CASCADE_SPLIT_X}")
    if cascades != (3, 3) or grid_cells != 3 * 128**3:
        raise AssertionError(f"cascade phase: snapshot cascades {cascades}, reference "
                             f"density grid of {grid_cells} cells")
    return out


def cascade_step_vs_cpu(torch, tb) -> dict:
    """(e) of cascade_phase: for each seed of CASCADE_STEP_SEEDS, one
    step's loss and gradients on the card and on the CPU from the trained
    state and the same draws, within CASCADE_STEP_LIMITS; and where the
    step's geometry differs between the devices: ray directions, the
    exponentially spaced candidate starts, the share of candidate probes
    whose cascade (``mip_from_pos``; from each device's own positions and
    from the card's alone) or occupancy differs, and the batch's samples
    (distances and positions).  -> {seed: readings}."""
    from neus2_tpu_torch import interop
    from neus2_tpu_torch.engine import occupancy as occ
    from neus2_tpu_torch.engine import train as tt
    from neus2_tpu_torch.engine.march import (CandidateProbe, coarse_intervals, draw_from_probe,
                                              probe_candidates)
    from neus2_tpu_torch.engine.rays import rays_from_pixels
    from neus2_tpu_torch.models.delta import apply_accumulated_to_rays

    cfg = tb.config
    cpu_state, _ = interop.state_from_pathdict(
        interop.state_to_pathdict(tb.state), tt.init_train_state(cfg, tb.cameras.n_images,
                                                                 device="cpu"))
    devices = {"card": (tb.state, tb.images, tb.cameras),
               "host": (cpu_state, tb.images.cpu(), tb.cameras._replace(**{
                   k: v.cpu() for k, v in tb.cameras._asdict().items() if torch.is_tensor(v)}))}

    def geometry(state, images, cams, d):
        """The step's ray directions, candidate starts and probe positions,
        and the batch's sample distances and positions, as the step draws
        them."""
        o, dirs, _, _ = rays_from_pixels(cams, images, d.img_idx, d.uv0)
        o, dirs = apply_accumulated_to_rays(state.acc, o, dirs)
        tmin, tmax = cfg.aabb().ray_intersect(o, dirs)
        t0, dt = coarse_intervals(torch.clamp_min(tmin, cfg.near), tmax, cfg.n_candidates,
                                  cfg.cone_angle)
        probe_pos = o[:, None, :] + (t0 + d.probe_u * dt)[..., None] * dirs[:, None, :]
        probe = probe_candidates(o, dirs, cfg.aabb(), state.occupancy, cfg.n_candidates,
                                 d.probe_u, cone_angle=cfg.cone_angle, near=cfg.near)
        sel = torch.argsort((~probe.hit).to(torch.uint8), stable=True)[:cfg.n_rays]
        samples = draw_from_probe(CandidateProbe(*(x[sel] for x in probe)), o[sel], dirs[sel],
                                  cfg.samples_per_ray, d.xi)
        return dirs, t0, probe_pos, samples.t, samples.positions

    top = cfg.occ_cascades - 1
    out = {}
    for seed in CASCADE_STEP_SEEDS:
        draws = tt.sample_step_draws(torch.Generator(device="cuda").manual_seed(seed), cfg,
                                     tb.cameras.n_images)
        launches = segment_sum_launches()
        res = {}
        for where, (state, images, cams) in devices.items():
            d = draws if where == "card" else draws.to("cpu")
            grads, aux, _ = tt.loss_and_grads({"params": state.params}, state, images, cams, d,
                                              cfg)
            res[where] = (aux, grads["params"], geometry(state, images, cams, d))
        if segment_sum_launches() != launches + 1:
            raise AssertionError("cascade step check: the card's backward skipped kernel 1")
        (aux_g, grads_g, geo_g), (aux_c, grads_c, geo_c) = res["card"], res["host"]
        mip_g = occ.mip_from_pos(geo_g[2], top).cpu()
        occ_g = occ.occupancy_at(tb.state.occupancy, geo_g[2]).cpu()
        (dirs_g, t0_g, probe_g, t_g, pos_g) = (x.cpu() for x in geo_g)
        (dirs_c, t0_c, probe_c, t_c, pos_c) = geo_c
        loss_g, loss_c = float(aux_g.loss), float(aux_c.loss)
        rec = {
            "loss_rel": abs(loss_g - loss_c) / abs(loss_c),
            "valid_samples": [int(aux_g.n_valid_samples), int(aux_c.n_valid_samples)],
            "ray_dirs_differing": int((dirs_g != dirs_c).any(-1).sum()),
            "rays": dirs_c.shape[0],
            "candidate_t0_max_rel_diff": float(((t0_g - t0_c).abs() / t0_c.abs()).max()),
            "probes": probe_c.shape[0] * probe_c.shape[1],
            "cascade_differs_share": float((mip_g != occ.mip_from_pos(probe_c, top))
                                           .float().mean()),
            "cascade_differs_share_same_positions": float(
                (mip_g != occ.mip_from_pos(probe_g, top)).float().mean()),
            "occupancy_differs_share": float(
                (occ_g != occ.occupancy_at(cpu_state.occupancy, probe_c)).float().mean()),
            "probe_position_max_abs_diff": float((probe_g - probe_c).abs().max()),
            "sample_t_max_abs_diff": float((t_g - t_c).abs().max()),
            "samples_differing": int((pos_g != pos_c).any(-1).sum()),
            "sample_position_max_abs_diff": float((pos_g - pos_c).abs().max()),
        }
        try:  # the line is printed whether the gradients agree or not
            rec.update(grads_agree(torch, grads_g, grads_c, cfg.field.grid.n_levels,
                                   CASCADE_STEP_LIMITS[1:], f"cascade step, seed {seed}"))
        finally:
            print(f"cascade_phase step_vs_cpu seed {seed} " + json.dumps(rec), flush=True)
        if rec["loss_rel"] > CASCADE_STEP_LIMITS[0]:
            raise AssertionError(f"cascade step check, seed {seed}: loss {loss_g} vs {loss_c}")
        out[seed] = rec
    return out


def tensorboard_matches_log(out: Path, steps: list, frame_steps: dict) -> dict:
    """A CLI run's ``--tensorboard`` files under ``out``/logs, read with
    the port's ``read_scalars`` (the card's machine has no TensorBoard),
    against the losses its log.txt prints: loss/rgb, loss/ek and loss/mask
    in logs/ at exactly the global ``steps``, and loss/rgb in
    logs/frame_<k> at exactly ``frame_steps[k]``, each value finite and
    within 5e-6 (the printed 5 decimals) plus one float32 rounding of the
    printed loss -> {directory: {tag: [(step, value)]}}."""
    import math
    import re

    from neus2_tpu_torch.utils.event_file import read_scalars

    line = re.compile(r"^step (\d+) \(frame (\d+) local (\d+)\) loss=(\S+) ek=(\S+) "
                      r"mask=(\S+) ")
    printed = [m.groups() for m in map(line.match, (out / "log.txt").read_text().splitlines())
               if m]
    want = {".": {"loss/rgb": [], "loss/ek": [], "loss/mask": []}}
    for step, frame, local, rgb, ek, mask in printed:
        for tag, v in (("loss/rgb", rgb), ("loss/ek", ek), ("loss/mask", mask)):
            want["."][tag].append((int(step), float(v)))
        if frame_steps:
            want.setdefault(f"frame_{frame}", {"loss/rgb": []})["loss/rgb"].append(
                (int(local), float(rgb)))
    logs = out / "logs"
    got = {str(d.relative_to(logs)): read_scalars(d)
           for d in sorted({p.parent for p in logs.rglob("events.out.tfevents.*")})}
    steps_want = {".": {t: list(steps) for t in want["."]},
                  **{f"frame_{k}": {"loss/rgb": list(v)} for k, v in frame_steps.items()}}
    steps_got = {d: {t: [s for s, _ in v] for t, v in tags.items()} for d, tags in got.items()}
    steps_printed = {d: {t: [s for s, _ in v] for t, v in tags.items()} for d, tags in want.items()}
    if not steps_got == steps_printed == steps_want:
        raise AssertionError(f"tensorboard files {steps_got}, log.txt {steps_printed}, "
                             f"want {steps_want}")
    for d, tags in got.items():
        for tag, rows in tags.items():
            for (step, v), (_, w) in zip(rows, want[d][tag]):
                if not (math.isfinite(v) and abs(v - w) <= 5e-6 + abs(w) * 2**-23):
                    raise AssertionError(f"tensorboard {d} {tag} at {step}: {v}, log.txt {w}")
    return got


def cascade_cli(torch, st) -> dict:
    """(f) of cascade_phase: the scene written with ``save_dataset_na`` at
    aabb_scale 4 (and its two held-out views) and trained through the CLI
    for CASCADE_CLI_STEPS steps with ``--save_mesh``, eval and
    ``--tensorboard``, on a copy of ``configs/base.json`` whose network
    block sets the phase's ``init_radius``: kernel 1 once a step, 3
    cascades, each held-out view above the all-black image, the CLI's mesh
    held to cascade_outputs' gate (more than 1000 triangles, vertices on
    both sides of x = CASCADE_SPLIT_X), and the event files to
    ``tensorboard_matches_log``.  What the flag costs, read in the same
    run (between its scalar steps the flag runs no code): the host
    seconds of each ``add_scalar``, and two StepWindows over
    ``Testbed.frame``, the first's host window holding step 100 (the log
    line and its scalars) and its traced window none, the second's host
    window none and its traced window step 200."""
    from neus2_tpu_torch import run
    from neus2_tpu_torch.api import testbed as testbed_mod
    from neus2_tpu_torch.data.dataset import load_dataset
    from neus2_tpu_torch.data.export import save_dataset_na
    from neus2_tpu_torch.ops.image import psnr, srgb_eval_target
    from neus2_tpu_torch.ops.warp import scene_aabb
    from neus2_tpu_torch.utils.event_file import EventFileWriter

    meshes, scalar_s = [], []

    def keep_mesh(save):
        def wrapped(self, *args, **kw):
            meshes.append(save(self, *args, **kw))
            return meshes[-1]
        return wrapped

    def time_scalar(add):
        def wrapped(self, *args, **kw):
            t0 = time.perf_counter()
            add(self, *args, **kw)
            scalar_s.append(time.perf_counter() - t0)
        return wrapped

    with tempfile.TemporaryDirectory() as d:
        network = testbed_mod._read_json(REPO / "configs" / "base.json")
        network["network"]["init_radius"] = CASCADE_INIT_RADIUS
        (Path(d) / "network.json").write_text(json.dumps(network))
        train = save_dataset_na(cascade_scene(CASCADE_VIEWS, seed=0), Path(d) / "train")
        test = save_dataset_na(cascade_scene(2, seed=1), Path(d) / "test")
        torch.cuda.synchronize()
        reset_launches(st)
        t0 = time.perf_counter()
        scalar_steps = StepWindows(torch, CLI_PROFILE_AT)
        quiet_steps = StepWindows(torch, 2 * CLI_LOG_EVERY - CLI_LOG_EVERY_LEAD - PROFILE_WINDOW)
        with Patched(testbed_mod.Testbed, "compute_and_save_marching_cubes_mesh", keep_mesh), \
                Patched(testbed_mod.Testbed, "frame", lambda f: quiet_steps(scalar_steps(f))), \
                Patched(EventFileWriter, "add_scalar", time_scalar):
            tb = run.main(["--scene", str(train), "--network", str(Path(d) / "network.json"),
                           "--n_steps", str(CASCADE_CLI_STEPS), "--save_mesh",
                           "--test_transforms", str(test), "--output_dir", d,
                           "--name", "cascade", "--tensorboard"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = st.segment_sum_rows.launches
        metrics = json.loads((Path(d) / "cascade" / "metrics.json").read_text())
        mesh_ok = (Path(d) / "cascade" / "mesh" / "mesh.obj").exists()
        targets = srgb_eval_target(load_dataset(test).to_device("cuda")[0])
        black = [float(psnr(torch.zeros_like(t), t)) for t in targets]
        scalars = tensorboard_matches_log(
            Path(d) / "cascade", list(range(CLI_LOG_EVERY, CASCADE_CLI_STEPS + 1, CLI_LOG_EVERY)),
            {})
    verts, tris = meshes[0]
    box = scene_aabb(tb.config.aabb_scale)
    world_x = box.lo[0] + verts[:, 0] * box.diag[0]
    sides = (int((world_x < CASCADE_SPLIT_X).sum()), int((world_x > CASCADE_SPLIT_X).sum()))
    out = {"steps": tb.training_step, "launches": launches, "wall_s": wall_s,
           "occ_cascades": tb.config.occ_cascades, "init_radius": tb.config.field.init_radius,
           "psnr": metrics["psnr"], "black_psnr": black, "ssim_mean": metrics["ssim_mean"],
           "mesh_written": mesh_ok, "mesh_triangles": int(len(tris)),
           "mesh_vertices_by_side": sides, "tensorboard": scalars["."],
           "add_scalar_calls": len(scalar_s), "add_scalar_ms_mean": 1e3 * sum(scalar_s)
           / max(len(scalar_s), 1), "add_scalar_ms_max": 1e3 * max(scalar_s, default=0.0),
           "host_ms_per_step": {"with_scalar_step": scalar_steps.out["host_ms_per_step"],
                                "without": quiet_steps.out["host_ms_per_step"]},
           "device_ms_per_step": {"with_scalar_step": quiet_steps.out["device_ms_per_step"],
                                  "without": scalar_steps.out["device_ms_per_step"]},
           "device_launches_per_step": {
               "with_scalar_step": quiet_steps.out["device_launches_per_step"],
               "without": scalar_steps.out["device_launches_per_step"]}}
    print("cascade_phase cli " + json.dumps(out), flush=True)
    if (tb.training_step, launches, tb.config.occ_cascades) != (CASCADE_CLI_STEPS,) * 2 + (3,):
        raise AssertionError(f"cascade phase CLI: {out}")
    if not (mesh_ok and len(metrics["psnr"]) == len(black)
            and all(p > b for p, b in zip(metrics["psnr"], black))):
        raise AssertionError(f"cascade phase CLI: outputs {out}")
    if len(tris) <= 1000 or min(sides) == 0:
        raise AssertionError(f"cascade phase CLI: mesh {len(tris)} triangles, {sides} vertices "
                             f"on each side of x = {CASCADE_SPLIT_X}")
    return out


def cascade16(torch, st, cfg, hyper) -> dict:
    """(g) of cascade_phase: the scene saved at aabb_scale 16 (5 cascades,
    512 candidates) and loaded from its files: the prior sweep's seconds
    and peak memory, then CASCADE16_STEPS Testbed steps, kernel 1 once a
    step and every loss finite."""
    from neus2_tpu_torch.api import testbed as testbed_mod
    from neus2_tpu_torch.api.testbed import Testbed
    from neus2_tpu_torch.data.export import save_dataset_na
    from neus2_tpu_torch.engine import occupancy as occ

    tb = Testbed(config=cfg, hyper=dataclasses.replace(
        hyper, first_frame_max_training_step=CASCADE16_STEPS), seed=0, device="cuda")
    sweep_s = []
    with tempfile.TemporaryDirectory() as d:
        path = save_dataset_na(cascade_scene(CASCADE_VIEWS, seed=0, aabb_scale=16), Path(d))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with Patched(testbed_mod, "occupancy_prior_sweep", host_timer(torch, sweep_s)):
            tb.load_training_data(path)
    c = tb.config
    out = {"aabb_scale": c.aabb_scale, "occ_cascades": c.occ_cascades,
           "n_candidates": c.n_candidates, "occ_n_probe": c.occ_n_probe,
           "prior_sweep_s": sweep_s[0], "prior_sweep_updates": tb.state.occupancy.ema_step,
           "prior_sweep_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    if (c.aabb_scale, c.occ_cascades, c.n_candidates) != (16, 5, 512):
        raise AssertionError(f"cascade phase aabb 16: derived config {out}")
    run_out = run_testbed(torch, st, tb)
    out.update({k: run_out[k] for k in ("steps", "launches", "loss_first", "loss_last",
                                        "ms_per_step", "wall_s")})
    out["update_bitfield_ms"] = cuda_ms(
        torch, lambda: occ.update_bitfield(tb.state.occupancy), iters=10)
    print("cascade_phase aabb16 " + json.dumps(out), flush=True)
    return out


def cascade_phase(torch, st, cfg, hyper, testbed: dict) -> dict:
    """Scenes larger than the unit cube at full base.json width, with one
    departure, tests/test_cascades.py's ``init_radius`` 0.2 (the geometric
    init's sphere reaches both of the scene's spheres):

      (a)-(c) ``cascade_train``: the aabb_scale-4 Testbed (3 cascades, 512
          exponentially spaced candidates) after its prior sweep, after
          CASCADE_STEPS[0] steps (kernel 1 once a step; host and device ms
          and device launches a step over a traced window, beside the
          Testbed phase's ``testbed``) and after CASCADE_STEPS[1]: the
          outer sphere's ring occupancy and |sdf| against
          tests/test_cascades.py's bars;
      (d) ``cascade_outputs``: held-out views, mesh, snapshots;
      (e) ``cascade_step_vs_cpu``: one step on the card against the CPU,
          for each of CASCADE_STEP_SEEDS' draws;
      then ``update_bitfield`` and one ``occupancy_update`` timed at 3
      cascades;
      (f) ``cascade_cli``: the CLI on the scene's files, the init radius
          set in a copy of base.json, with ``--tensorboard``;
      (g) ``cascade16``: the scene at aabb_scale 16.

    Fails at the first gate missed."""
    from neus2_tpu_torch.engine import occupancy as occ
    from neus2_tpu_torch.engine import train as tt

    print(f"cascade_phase departures from base.json: init_radius {CASCADE_INIT_RADIUS}",
          flush=True)
    cfg = dataclasses.replace(cfg, field=dataclasses.replace(cfg.field,
                                                             init_radius=CASCADE_INIT_RADIUS))
    out, tb = cascade_train(torch, st, cfg, hyper)
    keys = ("host_ms_per_step", "device_ms_per_step", "device_launches_per_step")
    out["testbed_phase"] = {k: testbed[k] for k in keys}
    out["outputs"] = cascade_outputs(torch, tb)
    out["step_vs_cpu"] = cascade_step_vs_cpu(torch, tb)
    jitter = torch.rand((tb.config.occ_n_probe, 3), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(6))
    out["update_bitfield_ms"] = cuda_ms(torch, lambda: occ.update_bitfield(tb.state.occupancy),
                                        iters=10)
    out["occupancy_update_ms"] = cuda_ms(
        torch, lambda: tt.occupancy_update(tb.state, tb.config, jitter=jitter), iters=10)
    del tb
    out["cli"] = cascade_cli(torch, st)
    out["aabb16"] = cascade16(torch, st, cfg, hyper)
    out["launches"] = {"aabb4": out["first"]["launches"] + out["rest"]["launches"],
                       "aabb4_cli": out["cli"]["launches"], "aabb16": out["aabb16"]["launches"]}
    print("cascade_phase " + json.dumps({
        "launches": out["launches"], "prior_sweep_s": out["prior_sweep_s"],
        "prior_sweep_peak_mem_gib": out["prior_sweep_peak_mem_gib"],
        **{k: out["first"][k] for k in keys}, "testbed_phase": out["testbed_phase"],
        "update_bitfield_ms": out["update_bitfield_ms"],
        "occupancy_update_ms": out["occupancy_update_ms"],
        "at": {"sweep": out["after_sweep"], CASCADE_STEPS[0]: out["at_first"],
               CASCADE_STEPS[1]: out["at_last"]}}), flush=True)
    return out


def quality_testbed_arm(torch, st, cfg, hyper, oversample: int, mask: float,
                        shell) -> dict:
    """One arm at full base.json width: QUALITY_AB_STEPS Testbed steps on
    the 16-view SCENE_RES^2 sphere scene (kernel 1 once a step), the two
    held-out views of held_out_views and the EMA field's sdf on ``shell``."""
    import numpy as np

    from neus2_tpu_torch.api.testbed import Testbed
    from neus2_tpu_torch.data.synthetic import make_sphere_dataset
    from neus2_tpu_torch.models.field import sdf_fn

    tb = Testbed(config=dataclasses.replace(cfg, hit_oversample=oversample,
                                            mask_loss_weight=mask),
                 hyper=dataclasses.replace(hyper, mask_loss_weight=mask,
                                           first_frame_max_training_step=QUALITY_AB_STEPS),
                 seed=0, device="cuda")
    tb.load_training_data_from_datasets([make_sphere_dataset(n_views=16, resolution=SCENE_RES,
                                                             seed=0)])
    r = run_testbed(torch, st, tb)
    tb.prepare_for_test()
    views = held_out_views(torch, tb, f"quality_ab hit_oversample {oversample} mask {mask}")
    with torch.no_grad():
        sdf, _ = sdf_fn(tb.state.ema_params, shell, tb.config.field)
    return {**{k: r[k] for k in ("steps", "launches", "loss_first", "loss_last", "ms_per_step")},
            "psnr": float(np.mean([v["psnr"] for v in views])),
            "ssim": float(np.mean([v["ssim"] for v in views])),
            "shell_abs_sdf": float(sdf.abs().mean()), "shell_mean_sdf": float(sdf.mean())}


def quality_e2e_arm(torch, st, oversample: int, mask: float, shell) -> dict:
    """One arm at tests/e2e_drive.py's own size, its loop on the card: its
    ``small_config`` (8 levels of 2^15 rows up to resolution 256, 512 rays
    of 32 samples, 96 candidates, eikonal 0.1), QUALITY_AB_E2E_VIEWS views
    of the QUALITY_AB_E2E_RES^2 sphere scene and the next one held out,
    QUALITY_AB_STEPS ``train_static`` steps (kernel 1 once a step), then
    the held-out view at 64 samples and 128 candidates on black, one pass,
    and the EMA field's sdf on ``shell``."""
    from neus2_tpu_torch.data.synthetic import make_sphere_dataset
    from neus2_tpu_torch.engine import train as tt
    from neus2_tpu_torch.engine.rays import Cameras
    from neus2_tpu_torch.engine.render import RenderConfig, render_image
    from neus2_tpu_torch.models.field import FieldConfig, sdf_fn
    from neus2_tpu_torch.ops.hashgrid import HashGridConfig
    from neus2_tpu_torch.ops.image import psnr, srgb_eval_target

    grid = HashGridConfig(n_levels=8, n_features_per_level=2, log2_hashmap_size=15,
                          base_resolution=16,
                          per_level_scale=HashGridConfig.per_level_scale_from_top(16, 256, 8))
    cfg = tt.TrainConfig(field=FieldConfig(grid=grid), n_rays=512, samples_per_ray=32,
                         n_candidates=96, ek_loss_weight=0.1, mask_loss_weight=mask,
                         hit_oversample=oversample)
    images, cams = make_sphere_dataset(n_views=QUALITY_AB_E2E_VIEWS + 1,
                                       resolution=QUALITY_AB_E2E_RES).to_device("cuda")
    train_cams = Cameras(poses=cams.poses[:-1], focal=cams.focal[:-1],
                         principal=cams.principal[:-1], resolution=cams.resolution)
    state = tt.init_train_state(cfg, QUALITY_AB_E2E_VIEWS, seed=0, device="cuda")
    torch.cuda.synchronize()
    reset_launches(st)
    t0 = time.perf_counter()
    state = tt.train_static(state, images[:-1], train_cams, cfg, QUALITY_AB_STEPS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = st.segment_sum_rows.launches
    rcfg = RenderConfig(field=cfg.field, samples_per_ray=64, n_candidates=128, chunk=1 << 12)
    with torch.no_grad():
        sdf, _ = sdf_fn(state.ema_params, shell, cfg.field)
        rgb, _, _ = render_image(state.ema_params, state.acc, state.occupancy, cams,
                                 cams.poses[-1], cams.focal[-1], cams.principal[-1],
                                 torch.Generator(device="cuda").manual_seed(1), rcfg,
                                 background=0.0)
    target = srgb_eval_target(images[-1])
    out = {"steps": state.step, "launches": launches, "wall_s": wall_s,
           "psnr": float(psnr(rgb, target)),
           "black_psnr": float(psnr(torch.zeros_like(target), target)),
           "shell_abs_sdf": float(sdf.abs().mean()), "shell_mean_sdf": float(sdf.mean())}
    if not (out["steps"] == out["launches"] == QUALITY_AB_STEPS and torch.isfinite(rgb).all()
            and out["psnr"] > out["black_psnr"]):
        raise AssertionError(f"quality_ab e2e arm hit_oversample {oversample} mask {mask}: {out}")
    return out


def ab_pairs(arms: dict) -> dict:
    """Each pair of QUALITY_AB_PAIRS among ``arms``, arm X against arm Y,
    against the tests' bars: PSNR_X > PSNR_Y - QUALITY_AB_PSNR_MARGIN and
    |sdf|_X < QUALITY_AB_SDF_FACTOR |sdf|_Y + 1e-3."""
    pairs = {}
    for what, (x, y) in QUALITY_AB_PAIRS.items():
        if x in arms and y in arms:
            a, b = arms[x], arms[y]
            pairs[what] = {
                "psnr_diff": a["psnr"] - b["psnr"],
                "sdf_ratio": a["shell_abs_sdf"] / b["shell_abs_sdf"],
                "meets_bars": bool(a["psnr"] > b["psnr"] - QUALITY_AB_PSNR_MARGIN
                                   and a["shell_abs_sdf"]
                                   < QUALITY_AB_SDF_FACTOR * b["shell_abs_sdf"] + 1e-3)}
    return pairs


def quality_ab_phase(torch, st, cfg, hyper) -> dict:
    """tests/test_compaction.py's two quality A/Bs, arms QUALITY_AB_ARMS,
    each QUALITY_AB_STEPS steps from the same seed, scored on held-out PSNR
    and the EMA field's mean |sdf| on tests/e2e_drive.py's shell (512
    points of the true sphere from ``np.random.default_rng(0)``):

      * at full base.json width (``quality_testbed_arm``): arms A and B,
        the compaction pair;
      * at tests/e2e_drive.py's own size (``quality_e2e_arm``), where the
        tests set their bars: arms A, B and C, both pairs.

    Fails if any pair misses the bars (``ab_pairs``)."""
    import numpy as np

    from neus2_tpu_torch.data.synthetic import SPHERE_CENTER, SPHERE_RADIUS

    d = np.random.default_rng(0).normal(size=(512, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    shell = torch.tensor(SPHERE_CENTER + SPHERE_RADIUS * d, dtype=torch.float32, device="cuda")
    print("quality_ab_phase departures from base.json: the arms' hit_oversample and mask "
          "loss weight", flush=True)
    testbed = {n: quality_testbed_arm(torch, st, cfg, hyper, *QUALITY_AB_ARMS[n], shell)
               for n in ("A", "B")}
    e2e = {n: quality_e2e_arm(torch, st, *arm, shell) for n, arm in QUALITY_AB_ARMS.items()}
    out = {"testbed": {"arms": testbed, "pairs": ab_pairs(testbed)},
           "e2e": {"arms": e2e, "pairs": ab_pairs(e2e)},
           "launches": {"testbed": {n: a["launches"] for n, a in testbed.items()},
                        "e2e": {n: a["launches"] for n, a in e2e.items()}}}
    print("quality_ab_phase " + json.dumps(out), flush=True)
    missed = {f"{size} {what}": p for size in ("testbed", "e2e")
              for what, p in out[size]["pairs"].items() if not p["meets_bars"]}
    if missed:
        raise AssertionError(f"quality_ab_phase: pairs miss the bars: {missed}")
    return out


def cublas_version() -> str:
    """The version of the cuBLAS this process loaded (``cublasGetProperty``)
    and its path; "not loaded" before the first product on the card."""
    import ctypes

    libs = sorted({line.split()[-1] for line in Path("/proc/self/maps").read_text().splitlines()
                   if "/libcublas.so" in line})
    if not libs:
        return "not loaded"
    lib = ctypes.CDLL(libs[0])
    lib.cublasGetProperty.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.cublasGetProperty.restype = ctypes.c_int
    parts = []
    for prop in range(3):  # MAJOR_VERSION, MINOR_VERSION, PATCH_LEVEL
        v = ctypes.c_int(-1)
        lib.cublasGetProperty(prop, ctypes.byref(v))
        parts.append(str(v.value))
    return ".".join(parts) + " " + libs[0]


def init_sha256(torch, cfg, threads: int) -> str:
    """SHA-256 of the field's init (seed 0) drawn on ``threads`` CPU threads."""
    from neus2_tpu_torch.models.field import init_field
    from neus2_tpu_torch.utils.tree import tree_leaves

    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        return sha256_of(tree_leaves(init_field(torch.Generator().manual_seed(0), cfg.field)))
    finally:
        torch.set_num_threads(before)


def provenance(torch, cfg, field: dict) -> dict:
    """What the machine is, for telling machines apart by the last bits of
    a run: library versions, the NVIDIA driver, the card's SM count, the
    visible cards, the cuBLAS workspace setting, the host's CPU and
    threads, the SHA-256 of the field check's card outputs (the SDF
    mode's first step's is sdf_phase's ``step_vs_cpu.card_sha256``) and of
    the field's init drawn on 1 CPU thread and on the host's count.  Fails
    if the two inits differ: every reading after the init follows from it."""
    props = torch.cuda.get_device_properties(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.split()
    cpu = [line.split(":", 1)[1].strip() for line in
           Path("/proc/cpuinfo").read_text().splitlines() if line.startswith("model name")]
    out = {
        "torch": torch.__version__, "cuda": torch.version.cuda, "cublas": cublas_version(),
        "cudnn": torch.backends.cudnn.version(), "nvidia_driver": smi[0] if smi else None,
        "sm_count": props.multi_processor_count, "visible_cards": torch.cuda.device_count(),
        "CUBLAS_WORKSPACE_CONFIG": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
        "cpu": cpu[0] if cpu else None, "cpu_threads": os.cpu_count(),
        "torch_threads": torch.get_num_threads(),
        "field_card_sha256": field["card_sha256"],
        "init_sha256_1_thread": init_sha256(torch, cfg, 1),
        "init_sha256_host_threads": init_sha256(torch, cfg, torch.get_num_threads()),
    }
    print("provenance " + json.dumps(out), flush=True)
    if out["init_sha256_1_thread"] != out["init_sha256_host_threads"]:
        raise AssertionError("the field's init depends on the CPU thread count")
    return out


def field_agrees_with_cpu(torch, cfg, n: int = 16384, limits: dict | None = None) -> dict:
    """The field and its gradients at full width on the card (through the
    segment-sum kernel) vs the same inputs on the CPU (exact scatter):
    outputs within 1e-4 of their max, MLP and variance gradients within
    1e-3 of their max, table gradients within 1e-2 of their max (the
    kernel sums bf16-quantized updates, as the reference's fp16 atomics
    do); ``limits`` replaces those three bounds.  Returns the worst of each
    and a SHA-256 of the card's outputs and gradients."""
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
    out = {**worst, "card_sha256": sha256_of(on_card)}
    print("field_vs_cpu " + json.dumps({"compute_dtype": str(cfg.field.compute_dtype), **out}),
          flush=True)
    return out


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
    """The traced window's device-side events, largest device time first.
    The profiler also lays each collective's ``nccl:<op>`` annotation on
    the device timeline, spanning its kernel: left out, so NCCL kernels
    count once."""
    from torch.autograd import DeviceType

    return sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.key.startswith("nccl:")),
                  key=lambda e: e.self_device_time_total, reverse=True)


def device_ms_per_step(evs: list, steps: int) -> float:
    """The card's busy time a step from a traced window's ``device_events``
    over ``steps``."""
    ms = sum(e.self_device_time_total for e in evs) / 1e3 / steps
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
    device_ms = device_ms_per_step(device, steps)

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


def tree_diff(torch, a, b) -> dict:
    """Two state trees leaf by leaf -> whether every leaf is bitwise equal,
    the largest |diff| of an MLP or variance leaf over its max magnitude,
    and over the hash tables the largest share of a table's entries more
    than 1e-4 of its max apart and the largest |diff|."""
    from neus2_tpu_torch.utils.tree import tree_leaves, tree_leaves_with_path

    out = {"bitwise": True, "mlp_max_rel": 0.0, "table_max_share_over": 0.0,
           "table_max_abs": 0.0}
    for (path, x), y in zip(tree_leaves_with_path(a), tree_leaves(b), strict=True):
        if not torch.is_tensor(x):
            out["bitwise"] = out["bitwise"] and x == y
            continue
        if x.shape != y.shape:
            raise AssertionError(f"{path}: shapes {tuple(x.shape)} {tuple(y.shape)}")
        out["bitwise"] = out["bitwise"] and torch.equal(x, y)
        if not x.is_floating_point():  # counters, occupancy bits: equality alone
            continue
        d = (x.double() - y.double()).abs()
        scale = max(float(x.abs().max()), 1e-12)
        if "hashgrid" in path:
            share = float((d > 1e-4 * scale).double().mean())
            out["table_max_share_over"] = max(out["table_max_share_over"], share)
            out["table_max_abs"] = max(out["table_max_abs"], float(d.max()))
        else:
            out["mlp_max_rel"] = max(out["mlp_max_rel"], float(d.max()) / scale)
    return out


def trees_agree(torch, a, b, exact: bool, what: str) -> dict:
    """``tree_diff``, held bitwise when ``exact``; otherwise to the JAX
    parity tests' rule for one step from equal states: every MLP and
    variance leaf within 1e-4 of its max, every hash table on all but 0.5%
    of its entries (a rounding-level gradient takes an Adam step of any
    size up to the learning rate)."""
    d = tree_diff(torch, a, b)
    ok = d["bitwise"] if exact else d["mlp_max_rel"] <= 1e-4 and d["table_max_share_over"] <= 0.005
    if not ok:
        raise AssertionError(f"{what}: {d} ({'bitwise' if exact else 'the parity rule'})")
    return d


def parallel_rank(ctx, cfg, hyper, snap_dir: str) -> dict:
    """One rank of ``parallel_phase``: (a), (b), (c) and (d) on this rank's
    card, in one order on every rank (their collectives meet)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from neus2_tpu_torch.api.testbed import Testbed
    from neus2_tpu_torch.data.synthetic import make_sphere_dataset
    from neus2_tpu_torch.engine import train as tt
    from neus2_tpu_torch.ops import segment_tile as st
    from neus2_tpu_torch.parallel import train as pt
    from neus2_tpu_torch.utils.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, exact = ctx.device, ctx.world == 1
    dataset = make_sphere_dataset(n_views=16, resolution=SCENE_RES, seed=0)
    images, cams = dataset.to_device(dev)
    out = {"rank": ctx.rank, "world": ctx.world, "backend": dist.get_backend()}

    def fresh():
        return tt.occupancy_prior_sweep(tt.init_train_state(cfg, 16, seed=0, device=dev), cfg)

    def whole(state):
        return [state.params, state.ema_params, state.opt_state]

    # (a) every rank given rank 0's draws: the mean of equal gradients, so
    # the replicas follow single-card steps.
    g = torch.Generator(device=dev).manual_seed(7)
    draws = [tt.sample_step_draws(g, cfg, 16) for _ in range(PARALLEL_EQUAL_STEPS)]
    state = pt.replicate_state(fresh(), ctx)
    for d in draws:
        state, _ = pt.parallel_train_step(state, images, cams, cfg, ctx, draws=d)
    if ctx.rank == 0:
        ref = fresh()
        for d in draws:
            ref, _ = tt.train_step(ref, images, cams, cfg, draws=d)
        out["equal_draws"] = {"steps": len(draws), "held_bitwise": exact,
                              **trees_agree(torch, whole(ref), whole(state), exact, "(a)")}
        del ref
    del state, draws

    # (c) ZeRO-1 against replicated with the same per-rank draws: 20 free
    # steps of each from one start, and each step also from the replicated
    # state (equal starts, so a world > 1 is held to the one-step rule).
    g = torch.Generator(device=dev).manual_seed(11)
    rank_draws = [pt.sample_rank_draws(g, cfg, 16, ctx) for _ in range(PARALLEL_EQUAL_STEPS)]
    rep, z1 = pt.replicate_state(fresh(), ctx), pt.shard_state_zero1(fresh(), ctx)

    def opt_bytes(opt):
        return sum(t.numel() * t.element_size() for t in tree_leaves(opt) if torch.is_tensor(t))

    def gathered(s):
        return s._replace(opt_state=pt.gather_opt_state(s.opt_state, s.params, ctx))

    spec = tree_leaves(pt.table_spec_tree(rep.params, ctx.world))
    zero1 = {"opt_bytes_replicated": opt_bytes(rep.opt_state),
             "opt_bytes_zero1": opt_bytes(z1.opt_state),
             "sharded_table_leaves": sum(spec), "table_leaves": len(rep.params["hashgrid"])}
    per_step = []
    for d in rank_draws:
        same_start = rep._replace(opt_state=pt.shard_opt_state(rep.opt_state, rep.params, ctx))
        rep, rep_aux = pt.parallel_train_step(rep, images, cams, cfg, ctx, draws=d)
        one, _ = pt.parallel_train_step(same_start, images, cams, cfg, ctx, zero1=True, draws=d)
        z1, z1_aux = pt.parallel_train_step(z1, images, cams, cfg, ctx, zero1=True, draws=d)
        per_step.append(trees_agree(torch, whole(rep), whole(gathered(one)), exact,
                                    "(c) one step"))
    free = tree_diff(torch, whole(rep), whole(gathered(z1)))
    loss_rel = abs(float(rep_aux.loss) - float(z1_aux.loss)) / abs(float(rep_aux.loss))
    zero1.update(steps=len(rank_draws), held_bitwise=exact,
                 one_step_table_max_share_over=max(p["table_max_share_over"] for p in per_step),
                 one_step_mlp_max_rel=max(p["mlp_max_rel"] for p in per_step),
                 free=free, free_last_loss_rel_diff=loss_rel)
    # Free steps drift apart by flipped Adam steps: a table entry by at most
    # about one step (the learning rate), an MLP leaf by 1e-4 of its max.
    drifted = (free["table_max_abs"] > cfg.optim.learning_rate or free["mlp_max_rel"] > 1e-4
               or loss_rel > 1e-5)
    if (not free["bitwise"]) if exact else drifted:
        raise AssertionError(f"(c) after {len(rank_draws)} free steps: {free}, loss {loss_rel}")
    out["zero1_vs_replicated"] = zero1
    del rep, z1, one, same_start, rank_draws

    # (b) the main path: the Testbed through enable_multichip, each rank its
    # own draws, 4,096 rays a rank, the error map and its sharpness on.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pcfg = dataclasses.replace(cfg, n_rays=cfg.n_rays * ctx.world, use_error_map=True,
                               include_sharpness_in_error=True)
    tb = Testbed(pcfg, dataclasses.replace(hyper, first_frame_max_training_step=PARALLEL_STEPS),
                 seed=0, device=dev)
    if tb.enable_multichip() != ctx.world:
        raise AssertionError("enable_multichip: the world is not the group's")
    tb.load_training_data_from_datasets([dataset])
    n_rays = []

    def read_rays(tb):
        if tb.training_step % 16 == 0 or tb.training_step == 1:
            n_rays.append(tb.last_aux.n_rays_counted)

    run = run_testbed(torch, st, tb, PARALLEL_PROFILE_AT, on_step=read_rays)
    losses = run["loss_reads"]
    same = True
    for t in tree_leaves([tb.state.params, list(tb.state.error_map)]):
        if torch.is_tensor(t):
            ref = t.clone()
            dist.broadcast(ref, 0)
            same = same and torch.equal(ref, t)
    rays = sum(n_rays) / len(n_rays) * ctx.world  # n_rays_counted is the ranks' mean
    out["distinct_draws"] = {
        **{k: run[k] for k in ("steps", "launches", "loss_first", "loss_last", "loss_reads",
                               "ms_per_step", "host_ms_per_step", "device_ms_per_step",
                               "nccl_ms_per_step", "nccl_kernels", "device_launches_per_step",
                               "top_device")},
        "rays_per_rank": cfg.n_rays, "global_rays_counted_per_step": rays,
        "global_trained_rays_per_s": rays / run["ms_per_step"] * 1e3,
        "replicas_bitwise": same, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    if not sum(losses[-2:]) / 2 < losses[0]:
        raise AssertionError(f"(b): the loss did not fall: {losses}")
    if not same:
        raise AssertionError("(b): the replicas' params or error map differ")
    # The gradient's all-reduce alone, every rank started together: the
    # collective's own time, without the wait for the slowest rank that the
    # step's NCCL kernels include.
    flat = torch.cat([p.reshape(-1) for p in tree_leaves(tb.state.params)])
    dist.barrier()
    out["distinct_draws"].update(
        all_reduce_mb=flat.numel() * 4 / 1e6,
        all_reduce_ms=cuda_ms(torch, lambda: dist.all_reduce(flat), iters=20, warmup=3))
    del tb, flat

    # (d) a ZeRO-1 snapshot loaded into a replicated Testbed, and a render.
    dcfg = dataclasses.replace(cfg, n_rays=cfg.n_rays * ctx.world)
    dhyper = dataclasses.replace(hyper, first_frame_max_training_step=PARALLEL_SNAPSHOT_STEPS)
    tz = Testbed(dcfg, dhyper, seed=0, device=dev)
    tz.enable_multichip(zero1=True)
    tz.load_training_data_from_datasets([dataset])
    while tz.frame():
        pass
    path = Path(snap_dir) / "zero1.msgpack"
    tz.save_snapshot(path)
    tr = Testbed(dcfg, dhyper, seed=0, device=dev)
    tr.enable_multichip()
    tr.load_training_data_from_datasets([dataset])
    tr.load_snapshot(path)
    tz_whole = tz.state._replace(opt_state=pt.gather_opt_state(tz.state.opt_state,
                                                               tz.state.params, ctx))
    parts = lambda s: whole(s) + [list(s.occupancy), list(s.error_map)]  # noqa: E731
    trees_agree(torch, parts(tz_whole), parts(tr.state), True, "(d) state")
    renders = [tb_.render(img_idx=0) for tb_ in (tz, tr)]
    if not all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(*renders)):
        raise AssertionError("(d): the renders differ")
    out["snapshot"] = {"steps": tz.training_step, "bytes": path.stat().st_size,
                       "leaves_bitwise": True, "render_bitwise": True}
    return out


def parallel_phase(torch) -> dict:
    """Data-parallel training (``neus2_tpu_torch/parallel``) through
    ``distributed.launch``: one rank a visible card, NCCL, at
    ``configs/base.json`` width with 4,096 rays a rank (the global batch
    grows with the world; one card's step is host-bound, so splitting 4,096
    rays would not show the collectives' cost):

      (a) every rank given rank 0's draws for 20 steps: the params, EMA and
          Adam state against 20 single-card ``train_step``s with those
          draws, bitwise in a world of one, else under the JAX parity rule
          (``trees_agree``);
      (b) the Testbed through ``enable_multichip`` for 200 steps, each rank
          its own draws, the error map and its sharpness weighting on (the
          main path: kernel 1 once a step on every rank): the loss falls,
          the params and error map bitwise equal across the ranks, device
          and NCCL ms a step from a profiler window, the global trained
          rays/s, peak memory a rank;
      (c) ZeRO-1 against replicated with the same draws: each of 20 steps
          from the replicated state, bitwise in a world of one, else under
          the same rule; and 20 free steps of each from one start, bitwise
          in a world of one, else every table entry within the field's
          learning rate (one Adam step), every MLP leaf within 1e-4 of its
          max and the last loss within 1e-5 relative (the one-step rule is
          not held over free steps: each lets another rounding-level
          gradient flip an Adam step); the Adam state's bytes a rank for
          both, and the sharded table leaves;
      (d) a ZeRO-1 Testbed's snapshot loaded into a replicated Testbed:
          every leaf and ``render(img_idx=0)`` bitwise.

    The ranks return their results to this process, which prints them; a
    rank that fails fails the phase."""
    from neus2_tpu_torch.api.testbed import config_from_json
    from neus2_tpu_torch.parallel import distributed

    cfg, hyper = config_from_json(REPO / "configs" / "base.json")
    world = torch.cuda.device_count()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ranks = distributed.launch(parallel_rank, world, cfg, hyper, d, device="cuda")
    out = {"world": world, "wall_s": time.perf_counter() - t0, "ranks": ranks}
    print("parallel_phase " + json.dumps(out), flush=True)
    for r in ranks:
        b = r["distinct_draws"]
        if r["backend"] != "nccl" or not b["launches"] == b["steps"] == PARALLEL_STEPS:
            raise AssertionError(f"parallel_phase rank {r['rank']}: {r['backend']}, "
                                 f"{b['launches']} kernel-1 launches in {b['steps']} steps")
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
    provenance(torch, cfg, field_agrees_with_cpu(torch, cfg))
    seconds, t_last = {}, [time.perf_counter()]

    def lap(phase: str) -> None:  # the host seconds since the last lap
        now = time.perf_counter()
        seconds[phase], t_last[0] = now - t_last[0], now

    # F=4 at tpu_opt.json's levels, the shapes its Testbed gives the kernels.
    tpu_opt_cfg = config_from_json(REPO / "configs" / "tpu_opt.json")[0]
    l4f8_cfg = config_from_json(REPO / "configs" / "l4f8.json")[0]
    k1, k1_f8 = kernel_phase(torch, st, cfg, 2), kernel_phase(torch, st, cfg, 8)
    k1_f4 = kernel_phase(torch, st, tpu_opt_cfg, 4)
    k1_l4f8 = kernel_phase(torch, st, l4f8_cfg, 8, label="kernel_phase_l4f8")
    sorted_k = kernel_phase_sorted(torch, st, cfg, 2)
    sorted_f8 = kernel_phase_sorted(torch, st, cfg, 8)
    sorted_f4 = kernel_phase_sorted(torch, st, tpu_opt_cfg, 4)
    ops = op_path_phase(torch, st, sc, cfg)
    lap("kernel_and_op_phases")
    images, cams = make_sphere_dataset(n_views=16, resolution=SCENE_RES, seed=0).to_device("cuda")
    train, state = training_phase(torch, tt, st, cfg, images, cams)
    prof = profile_phase(torch, tt, state, images, cams, cfg)
    del state, images, cams
    lap("training_and_profile")
    tb, testbed = testbed_phase(torch, st, cfg, hyper)
    mesh_outputs_phase(torch, testbed)
    lap("testbed_and_mesh_outputs")
    snap = snapshot_phase(torch, st, testbed)
    del testbed
    lap("snapshot")
    wide = {name: wide_rows_phase(torch, st, name, tb) for name in WIDE_ROW_CONFIGS}
    lap("wide_rows")
    dyn = dynamic_phase(torch, st, cfg, hyper)
    dyn_cli = dynamic_cli(torch, st, hyper)
    lap("dynamic")
    camera = camera_phase(torch, st, cfg, hyper, prof["device_ms_per_step"])
    lap("camera")
    lens = lens_phase(torch, st, cfg, hyper, prof, tb)
    lap("lens")
    bf16 = bf16_phase(torch, st, cfg, hyper, tb, prof)
    lap("bf16")
    cascade = cascade_phase(torch, st, cfg, hyper, tb)
    lap("cascade")
    quality = quality_ab_phase(torch, st, cfg, hyper)
    lap("quality_ab")
    sdf = sdf_phase(torch, st)
    lap("sdf")
    image = image_phase(torch, st)
    lap("image")
    parallel = parallel_phase(torch)
    lap("parallel")

    def entry(name, replaces, rec, rec_f8, rec_f4, launches, extra=()):
        wide_keys = ("max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "library_ms", *extra)
        return {
            "name": name, "route": "cuda", "source": "neus2_tpu_torch/csrc/segment_sum.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            **{k: rec[k] for k in extra}, "f8": {k: rec_f8[k] for k in wide_keys},
            "f4": {k: rec_f4[k] for k in ("levels", "bound_by", *wide_keys)},
        }

    kernels = [
        {**entry("segment_sum_rows", "neus2_tpu/ops/segment_tile.py:376", k1, k1_f8, k1_f4,
                 tb["launches"]),
         "wide_rows_launches": {n: w["launches"] for n, w in wide.items()},
         "wide_rows_launches_per_step": {n: w["launches_per_step"] for n, w in wide.items()},
         "l4f8_shape": {k: k1_l4f8[k] for k in ("levels", "max_abs_err", "kernel_ms",
                                                "plain_ms", "library_ms", "bound_ms")},
         "sort_ms": k1["sort_ms"], "sort_ms_f4": k1_f4["sort_ms"],
         "sort_ms_f8": k1_f8["sort_ms"], "launches_per_step": tb["launches_per_step"],
         "train_static_launches": train["launches"],
         "dynamic_launches": dyn["launches_by_phase"],
         "dynamic_cli_launches": dyn_cli["launches"],
         "camera_launches": camera["launches"],
         "lens_launches": lens["launches_all"], "bf16_launches": bf16["launches"],
         "cascade_launches": cascade["launches"], "quality_ab_launches": quality["launches"],
         "parallel_launches": [r["distinct_draws"]["launches"] for r in parallel["ranks"]],
         "sdf_launches": sdf["launches"], "sdf_shape": {
             k: sdf["kernel"][k] for k in ("updates_per_level", "max_abs_err", "kernel_ms",
                                           "sort_ms", "plain_ms", "library_ms", "bound_ms")},
         "resume_launches": {"native": snap["resume"]["launches_resumed"],
                             "legacy": snap["legacy"]["launches"],
                             "reference": snap["reference"]["launches"]}},
    ] + [
        entry(name, replaces, sorted_k[name], sorted_f8[name], sorted_f4[name],
              ops["launches"][name], extra=("entry_ms",))
        for name, replaces in (
            ("segment_sum_packed_rows", "neus2_tpu/ops/segment_tile.py:376"),
            ("segment_sum_batched_rows", "neus2_tpu/ops/segment_tile.py:211"),
        )
    ] + [
        {**entry("segment_sum_planar_rows", "neus2_tpu/ops/segment_tile.py:75",
                 sorted_k["segment_sum_planar_rows"], sorted_f8["segment_sum_planar_rows"],
                 sorted_f4["segment_sum_planar_rows"], ops["launches"]["segment_sum_planar_rows"],
                 extra=("held_ms", "library_held_ms")),
         "image_launches": image["launches"], "image_shape": {
             k: image["kernel"][k] for k in ("max_abs_err", "kernel_ms_per_step",
                                             "held_ms_per_step", "plain_ms_per_step",
                                             "library_ms_per_step", "entry_ms_per_step",
                                             "bound_ms_per_step")}},
    ]
    print("phase_seconds " + json.dumps(seconds), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
