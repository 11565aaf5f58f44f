"""Segment sum of the hash-grid backward: the CUDA kernel's wrapper and its
plain PyTorch version.

For every level l and table row r this computes
``dense_l[r] = sum of upd_l[m] over idx_l[m] == r``, with updates quantized
to bf16 and sums in fp32 (the reference's fp16-atomic kernel_grid_backward
precision, tcnn grid.h:1428-1439).

On the card (``csrc/segment_sum.cu``) the work is split in two:

  1. outside the kernel, one stable ``torch.sort`` of a global row key
     (level row offset + index) over all levels' updates, a gather of the
     bf16 payload into that order, and ``torch.searchsorted`` for each
     row's segment bounds (the JAX package likewise sorts with ``lax.sort``
     outside its Pallas kernel);
  2. the kernel: one warp per table row sums the row's contiguous segment
     in a fixed order, so the result is deterministic.

It replaces ``neus2_tpu/ops/segment_tile.py::_packed_kernel`` (one-hot MXU
matmuls over 512-row tiles with double-buffered DMA windows); tiles,
padding and the planar output layout were TPU constraints and are gone:
the kernel writes one flat (sum of sizes, F) fp32 buffer and each level is
a view of it.  Bound on the H100: memory traffic (bf16 payload and int32
row bounds in, fp32 rows out; the int32 keys are read by the sort, not by
the kernel); see PERF.md for the measured time.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from neus2_tpu_torch.utils import cuda_build

_FEATURES = (2, 8)  # configs/base.json and configs/l4f8.json


def segment_sum_all_levels_ref(idx_list, upd_list, sizes) -> list[torch.Tensor]:
    """Plain version: bf16-quantized updates summed per level with
    ``index_add_`` in float64, cast to fp32."""
    outs = []
    for idx, upd, size in zip(idx_list, upd_list, sizes):
        u = upd.to(torch.bfloat16).to(torch.float64)
        acc = torch.zeros((size, u.shape[1]), dtype=torch.float64, device=u.device)
        outs.append(acc.index_add_(0, idx.long(), u).to(torch.float32))
    return outs


def sort_updates(idx_list, upd_list, sizes):
    """All levels' updates in global-row order.

    Returns (bounds (n_rows + 1,) int32, payload (n_upd, F) bf16) where the
    updates of global row r are payload[bounds[r]:bounds[r + 1]].  The sort
    is stable, so equal keys keep their input order and the kernel's sums
    are repeatable."""
    offsets, total = [], 0
    for s in sizes:
        offsets.append(total)
        total += int(s)
    keys = torch.cat(
        [idx.to(torch.int32) + off for idx, off in zip(idx_list, offsets)]
    )
    keys_sorted, perm = torch.sort(keys, stable=True)
    payload = torch.cat([u.to(torch.bfloat16) for u in upd_list])[perm]
    rows = torch.arange(total + 1, dtype=torch.int32, device=keys.device)
    bounds = torch.searchsorted(keys_sorted, rows, out_int32=True)
    return bounds, payload.contiguous()


def segment_sum_rows(bounds: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: (n_rows + 1,) int32 bounds and (n_upd, F) bf16
    sorted payload -> (n_rows, F) fp32 row sums.  Counts its launches in
    ``segment_sum_rows.launches``."""
    if bounds.device.type != "cuda" or payload.device != bounds.device:
        raise ValueError("segment_sum_rows needs both tensors on one CUDA device")
    if bounds.dtype != torch.int32 or bounds.dim() != 1 or not bounds.is_contiguous():
        raise ValueError("bounds must be a contiguous 1-D int32 tensor")
    if (
        payload.dtype != torch.bfloat16
        or payload.dim() != 2
        or not payload.is_contiguous()
    ):
        raise ValueError("payload must be a contiguous (n_upd, F) bf16 tensor")
    f = payload.shape[1]
    if f not in _FEATURES:
        raise ValueError(f"features per level must be one of {_FEATURES}, got {f}")
    n_rows = bounds.shape[0] - 1
    out = torch.empty((n_rows, f), dtype=torch.float32, device=bounds.device)
    fn = _kernel()
    rc = fn(
        bounds.data_ptr(),
        payload.data_ptr(),
        out.data_ptr(),
        n_rows,
        f,
        torch.cuda.current_stream(bounds.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"segment_sum_rows launch failed: cudaError_t {rc}")
    segment_sum_rows.launches += 1
    return out


segment_sum_rows.launches = 0


def _kernel():
    fn = cuda_build.load("segment_sum").segment_sum_rows
    fn.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_longlong,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def segment_sum_all_levels(idx_list, upd_list, sizes) -> list[torch.Tensor]:
    """Per level ``zeros((sizes[l], F)).index_add_(0, idx, bf16(upd))`` in
    fp32 -> list of (sizes[l], F) views of one flat buffer."""
    if idx_list[0].device.type == "cpu":
        return segment_sum_all_levels_ref(idx_list, upd_list, sizes)
    bounds, payload = sort_updates(idx_list, upd_list, sizes)
    flat = segment_sum_rows(bounds, payload)
    return list(torch.split(flat, [int(s) for s in sizes]))
