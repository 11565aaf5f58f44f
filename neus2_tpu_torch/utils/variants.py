"""The flagship hash-grid variants (port of ``neus2_tpu/utils/variants.py``).

``parity`` is the reference's base.json grid (L14/F2, 2^19 rows a level,
top resolution 2048: configs/base.json); ``tpu_opt`` (L7/F4) and ``l4f8``
(L4/F8) keep the total feature width (28-32) and the table capacity while
cutting the level count.  The grids are those of
configs/{base,tpu_opt,l4f8}.json; the segment-sum kernels are built for
each of the three widths (``ops/segment_tile.py``).
"""

from __future__ import annotations

from neus2_tpu_torch.ops.hashgrid import HashGridConfig

FLAGSHIP_VARIANTS = {
    "parity": (14, 2),
    "tpu_opt": (7, 4),
    "l4f8": (4, 8),
}


def flagship_grid(variant: str = "parity") -> HashGridConfig:
    """The variant's grid: its levels and features, 2^19 rows, base
    resolution 16 and the per-level scale that reaches 2048 at the top
    level (``None`` or "" is ``parity``)."""
    levels, feats = FLAGSHIP_VARIANTS[variant or "parity"]
    return HashGridConfig(
        n_levels=levels,
        n_features_per_level=feats,
        log2_hashmap_size=19,
        base_resolution=16,
        per_level_scale=HashGridConfig.per_level_scale_from_top(16, 2048, levels),
    )
