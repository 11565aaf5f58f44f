"""Dense segment sums into a table (port of ``neus2_tpu/ops/scatter.py``).

``segment_dense_sum`` is ``zeros((n_rows, F)).index_add_(0, idx, upd)`` by
one of four methods, dispatched as in the JAX package:

  * "scatter": ``index_add_`` in fp32 (JAX's ``.at[].add``);
  * "sorttile": sort + the exact fp32 kernel 4 (``ops/segment_tile.py``);
  * "sort": the JAX package's scatter-free two-sort pipeline as torch ops
    (a merge sort of updates and row queries, per-channel cumulative sums,
    a stable compaction sort, differences), with its fp32 cancellation;
  * "auto": "scatter" on the CPU; elsewhere "sorttile" when the caller
    vouches for hash-uniform indices and the table shape allows, else "sort".

``segment_dense_sum_multi`` does all hash-grid levels at once: on the CPU
the exact scatter, elsewhere ("packed") the all-levels kernel 1.
``level_table_grad`` is the exact fp32 sum of one table (kernel 4 on the
card) that the image mode's and ``hashgrid_encode``'s backward take.
"""

from __future__ import annotations

import torch

from neus2_tpu_torch.ops.segment_tile import segment_sum_all_levels, segment_sum_sorttile


def _sort_method(idx: torch.Tensor, upd: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The JAX package's two-sort pipeline (scatter.py:76-99)."""
    m, f = upd.shape
    dev = upd.device
    keys = torch.cat([idx.to(torch.int64), torch.arange(n_rows, device=dev)])
    flags = torch.cat([torch.zeros(m, dtype=torch.int64, device=dev),
                       torch.ones(n_rows, dtype=torch.int64, device=dev)])
    # lax.sort(num_keys=2) on (keys, flags): one stable sort of a joint key.
    order = torch.sort(keys * 2 + flags, stable=True).indices
    merged_flags = flags[order]
    # Per-channel 1-D scans, as in the JAX code (a dim-0 scan of an (N, F)
    # tensor takes a slow path on the card).
    vals = torch.cat([upd.t(), upd.new_zeros((f, n_rows))], dim=1)[:, order]
    cs = torch.cumsum(vals, dim=1)
    # Stable compaction: the row queries (flag 1) first, in ascending row order.
    queries = torch.sort(1 - merged_flags, stable=True).indices[:n_rows]
    dense_cum = cs[:, queries]
    prev = torch.cat([dense_cum.new_zeros((f, 1)), dense_cum[:, :-1]], dim=1)
    return (dense_cum - prev).t().contiguous()


def segment_dense_sum(idx: torch.Tensor, upd: torch.Tensor, n_rows: int,
                      method: str = "auto", uniform_hint: bool = False) -> torch.Tensor:
    """``zeros((n_rows, F)).index_add_(0, idx, upd)`` in fp32; bf16 updates
    are accumulated in fp32.  ``uniform_hint``: the caller vouches that the
    indices are hash-uniform (hashed grid levels, not dense coarse ones)."""
    if upd.dtype == torch.bfloat16:
        upd = upd.to(torch.float32)
    if method == "auto":
        if upd.device.type == "cpu":
            method = "scatter"
        elif uniform_hint and n_rows % 512 == 0 and n_rows >= 4096:
            method = "sorttile"
        else:
            method = "sort"
    if method == "scatter":
        out = torch.zeros((n_rows, upd.shape[1]), dtype=upd.dtype, device=upd.device)
        return out.index_add_(0, idx.long(), upd)
    if method == "sorttile":
        return segment_sum_sorttile(idx, upd, n_rows)
    if method == "sort":
        return _sort_method(idx, upd, n_rows)
    raise ValueError(f"unknown segment-sum method {method!r}")


def level_table_grad(idx: torch.Tensor, upd: torch.Tensor, rows: int) -> torch.Tensor:
    """A table gradient ``zeros((rows, F)).index_add_(0, idx, upd)`` summed
    in a fixed order (``rows`` a multiple of 8): ``index_add_`` on the CPU;
    on the card the stable sort and kernel 4, exact in fp32.  (Torch's
    backward of a gather adds with float atomics on the card, so its sums
    change from run to run.)"""
    if upd.device.type == "cpu":
        return segment_dense_sum(idx, upd, rows, method="scatter")
    return segment_sum_sorttile(idx, upd, rows, row_block=8, pack=False)


def segment_dense_sum_multi(idx_list, upd_list, sizes,
                            method: str = "auto") -> list[torch.Tensor]:
    """All levels' ``zeros((sizes[l], F)).index_add_(0, idx, upd)`` ->
    list of (sizes[l], F).  ``method``: "auto" (scatter on the CPU, else
    "packed"), "packed" (kernel 1 over all levels at once), or any
    per-level method of ``segment_dense_sum``."""
    if method == "auto":
        method = "scatter" if idx_list[0].device.type == "cpu" else "packed"
    if method == "packed":
        return segment_sum_all_levels(idx_list, upd_list, list(sizes))
    return [
        segment_dense_sum(i, u, int(s), method=method)
        for i, u, s in zip(idx_list, upd_list, sizes)
    ]
