"""Sorted segment sums: the wrappers of the CUDA kernels in
``csrc/segment_sum.cu`` and their plain PyTorch versions (port of
``neus2_tpu/ops/segment_tile.py``).

Every function here computes, per level and row, ``dense[r] = sum of
upd[m] over idx[m] == r`` in fp32.  Four TPU kernels do that in the JAX
package; each has a counterpart here, with the JAX entry point's name and
argument order (the TPU-only knobs ``chunk``, ``elems_cap`` and
``interpret`` are gone; ``row_block`` stays only as the ``n_rows %
row_block`` check):

  kernel  JAX entry point (TPU body)                    wrapper here             payload
  1       sorted_segment_sum_tiles_packed_planar        segment_sum_rows         bf16 rows, all levels
          (_packed_kernel :376), via segment_sum_all_levels
  2       sorted_segment_sum_tiles_packed (:376)        segment_sum_packed_rows  packed bf16 pairs
  3       sorted_segment_sum_tiles_batched (:211)       segment_sum_batched_rows fp32, bf16 on load
  4       sorted_segment_sum_tiles (_tile_kernel :75)   segment_sum_planar_rows  fp32, exact

The sort stays outside the kernel, as in the JAX package (``lax.sort``
there, a stable ``torch.sort`` here); ``torch.searchsorted`` turns each
level's sorted indices into per-row bounds, and the kernel sums each row's
contiguous slice with one warp in a fixed order.  Bound on the H100:
memory traffic (payload and row bounds in, fp32 rows out); PERF.md has the
measured times.

A CPU tensor takes the plain version (``*_ref``: ``index_add_`` in float64
after the same bf16 rounding, none for kernel 4); a CUDA tensor launches
the kernel or raises.

The TPU's ``sorted_segment_sum_tiles`` silently drops the updates of a
512-row tile past its DMA window (``elems_cap``); the kernel here has no
such limit and sums them all (``debug_overflow_check`` measures the load).
"""

from __future__ import annotations

import ctypes

import torch

from neus2_tpu_torch.utils import cuda_build

_FEATURES = (2, 8)  # configs/base.json and configs/l4f8.json
_LANE = 128  # the TPU kernel's DMA alignment, for debug_overflow_check
PAD_IDX = 2**31 - 1  # index padding of the JAX package's batched layout


# --- bf16 pair packing ------------------------------------------------------


def pack_bf16_pairs(upd: torch.Tensor) -> torch.Tensor:
    """(M, F) float -> (M, ceil(F/2)) int32 of packed bf16 pairs (channel 2k
    in the low half of int32 k, 2k+1 in the high half)."""
    m, f = upd.shape
    if f % 2:
        upd = torch.cat([upd, upd.new_zeros((m, 1))], dim=1)
    b = upd.to(torch.bfloat16).reshape(m, -1, 2).contiguous()
    return b.view(torch.int32).reshape(m, -1)


def unpack_bf16_pairs(packed: torch.Tensor, f: int) -> torch.Tensor:
    """(M, P) int32 -> (M, F) fp32."""
    m = packed.shape[0]
    # Flat first: a (M, 1) view may carry any stride on its unit dimension.
    b = packed.contiguous().reshape(-1).view(torch.bfloat16).reshape(m, -1)
    return b[:, :f].to(torch.float32)


# --- plain versions ---------------------------------------------------------


def _index_add_levels(idx: torch.Tensor, vals: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(L, M) indices, (L, M, F) values -> (L, n_rows, F) fp32 sums taken in
    float64; indices outside [0, n_rows) (the padding) match no row."""
    n_levels, _, f = vals.shape
    out = torch.zeros((n_levels, n_rows, f), dtype=torch.float64, device=vals.device)
    for lvl in range(n_levels):
        i = idx[lvl].long()
        keep = (i >= 0) & (i < n_rows)
        out[lvl].index_add_(0, i[keep], vals[lvl][keep].to(torch.float64))
    return out.to(torch.float32)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def sorted_segment_sum_tiles_ref(idx_sorted, vals_planar, n_rows: int) -> torch.Tensor:
    """Kernel 4's plain version: (M,), (F, M) fp32 -> (n_rows, F), exact."""
    return _index_add_levels(idx_sorted[None], vals_planar.t()[None], n_rows)[0]


def sorted_segment_sum_tiles_batched_ref(idx_sorted, vals_planar, n_rows: int) -> torch.Tensor:
    """Kernel 3's plain version: (L, Mp), (L, F, Mp) fp32 -> (L, n_rows, F),
    values rounded to bf16 first."""
    return _index_add_levels(idx_sorted, _bf16(vals_planar.transpose(1, 2)), n_rows)


def sorted_segment_sum_tiles_packed_ref(idx_sorted, packed, n_rows: int) -> torch.Tensor:
    """Kernel 2's plain version: (L, Mp), (L, P, Mp) int32 -> (L, n_rows, 2P)."""
    n_levels, p, m_pad = packed.shape
    vals = unpack_bf16_pairs(packed.transpose(1, 2).reshape(n_levels * m_pad, p), 2 * p)
    return _index_add_levels(idx_sorted, vals.reshape(n_levels, m_pad, 2 * p), n_rows)


def segment_sum_all_levels_ref(idx_list, upd_list, sizes) -> list[torch.Tensor]:
    """Kernel 1's plain version: bf16-quantized updates summed per level with
    ``index_add_`` in float64, cast to fp32."""
    outs = []
    for idx, upd, size in zip(idx_list, upd_list, sizes):
        u = upd.to(torch.bfloat16).to(torch.float64)
        acc = torch.zeros((size, u.shape[1]), dtype=torch.float64, device=u.device)
        outs.append(acc.index_add_(0, idx.long(), u).to(torch.float32))
    return outs


# --- kernel wrappers --------------------------------------------------------

_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "segment_sum_rows": [_PTR, _PTR, _PTR, _I64, _I32, _PTR],
    "segment_sum_packed": [_PTR, _PTR, _PTR, _I64, _I64, _I64, _I32, _PTR],
    "segment_sum_batched": [_PTR, _PTR, _PTR, _I64, _I64, _I64, _I32, _PTR],
    "segment_sum_planar": [_PTR, _PTR, _PTR, _I64, _I64, _I32, _PTR],
}


def _entry(name: str):
    fn = getattr(cuda_build.load("segment_sum"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(wrapper, entry: str, bounds: torch.Tensor, payload: torch.Tensor, dtype,
            f: int, *sizes: int) -> torch.Tensor:
    """What every wrapper does: check ``bounds`` ((n_rows + 1,) for one
    stream or (L, n_rows + 1) for L) and ``payload`` (one more dimension, of
    ``dtype``), allocate the fp32 output ((L,) n_rows x f), launch the C
    entry point ``entry`` with ``[L,] n_rows, *sizes, f`` after the three
    pointers, and count the launch in ``wrapper.launches``."""
    if bounds.device.type != "cuda":
        raise ValueError("the segment-sum kernels need tensors on a CUDA device")
    if bounds.dtype != torch.int32 or bounds.dim() not in (1, 2) or not bounds.is_contiguous():
        raise ValueError("bounds must be a contiguous 1-D or 2-D int32 tensor")
    if payload.device != bounds.device:
        raise ValueError("bounds and payload must lie on one CUDA device")
    dim = bounds.dim() + 1
    if payload.dtype != dtype or payload.dim() != dim or not payload.is_contiguous():
        raise ValueError(f"the payload must be a contiguous {dim}-D {dtype} tensor")
    levels = tuple(bounds.shape[:-1])
    if tuple(payload.shape[:dim - 2]) != levels:
        raise ValueError("bounds and payload disagree on the number of levels")
    if f not in _FEATURES:
        raise ValueError(f"features per level must be one of {_FEATURES}, got {f}")
    n_rows = bounds.shape[-1] - 1
    out = torch.empty((*levels, n_rows, f), dtype=torch.float32, device=bounds.device)
    stream = torch.cuda.current_stream(bounds.device).cuda_stream
    rc = _entry(entry)(bounds.data_ptr(), payload.data_ptr(), out.data_ptr(), *levels, n_rows,
                       *sizes, f, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError_t {rc}")
    wrapper.launches += 1
    return out


def segment_sum_rows(bounds: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """Kernel 1: (n_rows + 1,) int32 bounds and (n_upd, F) bf16 sorted
    payload -> (n_rows, F) fp32 row sums.  Counts its launches in
    ``segment_sum_rows.launches``."""
    return _launch(segment_sum_rows, "segment_sum_rows", bounds, payload, torch.bfloat16,
                   payload.shape[-1])


def segment_sum_packed_rows(bounds: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Kernel 2: (L, n_rows + 1) int32 bounds and (L, P, Mp) int32 packed
    bf16 pairs -> (L, n_rows, 2P) fp32.  Counts its launches in
    ``segment_sum_packed_rows.launches``."""
    return _launch(segment_sum_packed_rows, "segment_sum_packed", bounds, packed, torch.int32,
                   2 * packed.shape[-2], packed.shape[-1])


def segment_sum_batched_rows(bounds: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Kernel 3: (L, n_rows + 1) int32 bounds and (L, F, Mp) fp32 values,
    rounded to bf16 on load -> (L, n_rows, F) fp32.  Counts its launches in
    ``segment_sum_batched_rows.launches``."""
    return _launch(segment_sum_batched_rows, "segment_sum_batched", bounds, vals, torch.float32,
                   vals.shape[-2], vals.shape[-1])


def segment_sum_planar_rows(bounds: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Kernel 4: (n_rows + 1,) int32 bounds and (F, M) fp32 values, summed
    exactly -> (n_rows, F) fp32.  Counts its launches in
    ``segment_sum_planar_rows.launches``."""
    return _launch(segment_sum_planar_rows, "segment_sum_planar", bounds, vals, torch.float32,
                   vals.shape[-2], vals.shape[-1])


for _wrapper in (segment_sum_rows, segment_sum_packed_rows, segment_sum_batched_rows,
                 segment_sum_planar_rows):
    _wrapper.launches = 0

KERNELS = (segment_sum_rows, segment_sum_packed_rows, segment_sum_batched_rows,
           segment_sum_planar_rows)


# --- entry points -----------------------------------------------------------


def row_bounds(idx_sorted: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(..., M) ascending indices -> (..., n_rows + 1) int32: row r of each
    stream is [bounds[r], bounds[r + 1]); indices >= n_rows fall past the
    last bound."""
    rows = torch.arange(n_rows + 1, dtype=idx_sorted.dtype, device=idx_sorted.device)
    rows = rows.expand(idx_sorted.shape[:-1] + (n_rows + 1,)).contiguous()
    return torch.searchsorted(idx_sorted.contiguous(), rows, out_int32=True)


def _check_row_block(n_rows: int, row_block: int) -> None:
    if n_rows % row_block:
        raise ValueError(f"n_rows {n_rows} is not a multiple of row_block {row_block}")


def sorted_segment_sum_tiles(idx_sorted: torch.Tensor, vals_planar: torch.Tensor,
                             n_rows: int, row_block: int = 512) -> torch.Tensor:
    """Per-row sums of ONE sorted stream: (M,) ascending indices, (F, M)
    fp32 values -> (n_rows, F) fp32, exact in fp32 (kernel 4)."""
    _check_row_block(n_rows, row_block)
    if idx_sorted.device.type == "cpu":
        return sorted_segment_sum_tiles_ref(idx_sorted, vals_planar, n_rows)
    return segment_sum_planar_rows(row_bounds(idx_sorted, n_rows),
                                   vals_planar.to(torch.float32).contiguous())


def segment_sum_sorttile(idx: torch.Tensor, upd: torch.Tensor, n_rows: int,
                         row_block: int = 512, pack: bool = True) -> torch.Tensor:
    """``zeros((n_rows, F)).index_add_(0, idx, upd)`` via sort + kernel 4.

    ``pack=True`` carries the values through the sort as bf16 pairs (the
    reference accumulates in fp16, grid.h:1428-1439); ``pack=False``
    carries fp32 and is exact."""
    f = upd.shape[1]
    idx_s, order = torch.sort(idx, stable=True)
    if pack:
        vals = unpack_bf16_pairs(pack_bf16_pairs(upd)[order], f)
    else:
        vals = upd.to(torch.float32)[order]
    return sorted_segment_sum_tiles(idx_s, vals.t().contiguous(), n_rows, row_block)


def sorted_segment_sum_tiles_batched(idx_sorted: torch.Tensor, vals_planar: torch.Tensor,
                                     n_rows: int, row_block: int = 512) -> torch.Tensor:
    """Per-row sums of L sorted streams: (L, Mp) ascending indices (padded
    with ``PAD_IDX``), (L, F, Mp) fp32 values -> (L, n_rows, F) fp32.  The
    values are rounded to bf16 before they are summed, whatever their
    source (kernel 3)."""
    _check_row_block(n_rows, row_block)
    if idx_sorted.device.type == "cpu":
        return sorted_segment_sum_tiles_batched_ref(idx_sorted, vals_planar, n_rows)
    return segment_sum_batched_rows(row_bounds(idx_sorted, n_rows),
                                    vals_planar.to(torch.float32).contiguous())


def segment_sum_sorttile_batched(idx: torch.Tensor, upd: torch.Tensor, n_rows: int,
                                 row_block: int = 512, pack: bool = True) -> torch.Tensor:
    """L independent ``zeros((n_rows, F)).index_add_(0, idx[l], upd[l])`` in
    one batched sort and one kernel launch -> (L, n_rows, F).

    ``pack=True`` carries the values through the sort as packed bf16 pairs,
    ``pack=False`` as fp32; either way kernel 3 sums bf16-rounded values.
    No index padding is needed: the kernel reads exactly each row's slice."""
    n_levels, m, f = upd.shape
    idx_s, order = torch.sort(idx, dim=-1, stable=True)
    if pack:
        packed = pack_bf16_pairs(upd.reshape(n_levels * m, f)).reshape(n_levels, m, -1)
        packed = torch.gather(packed, 1, order[..., None].expand(-1, -1, packed.shape[-1]))
        vals = unpack_bf16_pairs(packed.reshape(n_levels * m, -1), f).reshape(n_levels, m, f)
    else:
        vals = torch.gather(upd.to(torch.float32), 1, order[..., None].expand(-1, -1, f))
    return sorted_segment_sum_tiles_batched(
        idx_s, vals.transpose(1, 2).contiguous(), n_rows, row_block
    )


def sorted_segment_sum_tiles_packed(idx_sorted: torch.Tensor, packed: torch.Tensor,
                                    n_rows: int, row_block: int = 512) -> torch.Tensor:
    """Per-row sums of L sorted streams of packed bf16 pairs: (L, Mp)
    ascending indices (padded with ``PAD_IDX``), (L, P, Mp) int32 ->
    (L, n_rows, 2P) fp32 (kernel 2)."""
    _check_row_block(n_rows, row_block)
    if idx_sorted.device.type == "cpu":
        return sorted_segment_sum_tiles_packed_ref(idx_sorted, packed, n_rows)
    return segment_sum_packed_rows(row_bounds(idx_sorted, n_rows), packed.contiguous())


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
    return row_bounds(keys_sorted, total), payload.contiguous()


def segment_sum_all_levels(idx_list, upd_list, sizes) -> list[torch.Tensor]:
    """Per level ``zeros((sizes[l], F)).index_add_(0, idx, bf16(upd))`` in
    fp32 -> list of (sizes[l], F) views of one flat buffer (kernel 1)."""
    if idx_list[0].device.type == "cpu":
        return segment_sum_all_levels_ref(idx_list, upd_list, sizes)
    bounds, payload = sort_updates(idx_list, upd_list, sizes)
    flat = segment_sum_rows(bounds, payload)
    return list(torch.split(flat, [int(s) for s in sizes]))


def debug_overflow_check(idx: torch.Tensor, n_rows: int, row_block: int = 512) -> int:
    """Max elements any 512-row tile of the TPU's ``sorted_segment_sum_tiles``
    must cover, alignment slack included.  That TPU kernel is exact iff this
    is <= its ``elems_cap``; the kernel here has no cap."""
    idx_s = torch.sort(idx).values
    bounds = torch.arange(n_rows // row_block + 1, dtype=idx_s.dtype,
                          device=idx_s.device) * row_block
    offs = torch.searchsorted(idx_s, bounds[:-1])
    ends = torch.cat([offs[1:], offs.new_tensor([idx.shape[0]])])
    return int((ends - (offs // _LANE) * _LANE).max())
