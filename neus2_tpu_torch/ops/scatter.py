"""Dense segment sums for the hash-grid backward
(port of ``neus2_tpu/ops/scatter.py::segment_dense_sum_multi``).

Dispatch as in the JAX package: on the CPU an exact fp32 scatter-add (JAX's
``.at[].add``), elsewhere the all-levels segment-sum kernel
(``ops/segment_tile.py``), with no fallback.
"""

from __future__ import annotations

import torch

from neus2_tpu_torch.ops.segment_tile import segment_sum_all_levels


def segment_dense_sum_multi(idx_list, upd_list, sizes) -> list[torch.Tensor]:
    """All levels' ``zeros((sizes[l], F)).index_add_(0, idx, upd)``."""
    if idx_list[0].device.type == "cpu":
        return [
            torch.zeros((int(s), u.shape[1]), dtype=torch.float32).index_add_(
                0, i.long(), u.to(torch.float32)
            )
            for i, u, s in zip(idx_list, upd_list, sizes)
        ]
    return segment_sum_all_levels(idx_list, upd_list, sizes)
