"""Hash-grid introspection: per-level weight statistics and histograms
(port of ``neus2_tpu/utils/introspect.py``; the reference GUI's encoding
diagnostics, compute_level_stats / Testbed::gather_histograms,
src/testbed.cu:3056-3117, LevelStats in testbed.h:230-244).

Per level: the count of near-zero entries and the mean / sigma / min / max
of the others; and a fixed-scale 257-bin histogram of one level's weights,
comparable across levels.  The tables are copied to the host.

    stats = hashgrid_level_stats(tb.state.params)
    hist = hashgrid_level_histogram(tb.state.params, level=5)

CLI: ``python -m neus2_tpu_torch.run ... --grid_stats`` logs the table.
"""

from __future__ import annotations

import numpy as np

from neus2_tpu_torch.models.field import effective_grid_tables

ZERO_EPS = 1e-5  # reference compute_level_stats: |v| < 0.00001 counts as zero


def _level_values(params) -> list[np.ndarray]:
    return [t.detach().cpu().numpy().astype(np.float32).ravel()
            for t in effective_grid_tables(params)]


def hashgrid_level_stats(params) -> list[dict]:
    """One dict a level of the effective tables: {level, size, count,
    numzero, fraczero, mean, sigma, min, max}, the moments over entries
    with |v| >= 1e-5 (the reference's cut keeps untouched rows from
    flattening them)."""
    out = []
    for lvl, v in enumerate(_level_values(params)):
        live = v[np.abs(v) >= ZERO_EPS]
        n = int(live.size)
        out.append({
            "level": lvl,
            "size": int(v.size),
            "count": n,
            "numzero": int(v.size - n),
            "fraczero": float((v.size - n) / max(v.size, 1)),
            "mean": float(live.mean()) if n else 0.0,
            "sigma": float(live.std()) if n else 0.0,
            "min": float(live.min()) if n else 0.0,
            "max": float(live.max()) if n else 0.0,
        })
    return out


def hashgrid_level_histogram(params, level: int, histo_scale: float = 1.0) -> np.ndarray:
    """257-bin histogram of one level's non-zero weights: bin = floor(v *
    128 / histo_scale + 128.5), bins outside [0, 256] dropped
    (testbed.cu:3100-3113)."""
    v = _level_values(params)[level]
    v = v[v != 0.0]
    bins = np.floor(v * (128.0 / histo_scale) + 128.5).astype(np.int64)
    bins = bins[(bins >= 0) & (bins <= 256)]
    return np.bincount(bins, minlength=257)


def format_level_stats(stats: list[dict]) -> str:
    """Fixed-width text table (the GUI panel's text form)."""
    lines = [f"{'lvl':>3} {'size':>9} {'nonzero':>9} {'frac0':>6} "
             f"{'mean':>9} {'sigma':>9} {'min':>9} {'max':>9}"]
    for s in stats:
        lines.append(f"{s['level']:>3} {s['size']:>9} {s['count']:>9} "
                     f"{s['fraczero']:>6.3f} {s['mean']:>9.5f} {s['sigma']:>9.5f} "
                     f"{s['min']:>9.5f} {s['max']:>9.5f}")
    return "\n".join(lines)
