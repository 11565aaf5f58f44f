"""The yardstick's counts against hand-worked values, and the trace's
interval arithmetic on intervals made up by hand."""

import numpy as np
import pytest

from portbench import counts, manifest, trace

BASE = manifest.cell("base.b0").config
# base.json with a 4 x 8 grid: kernel 1 at F = 8, as a later cell may run it.
L4F8 = dict(BASE, encoding=dict(BASE["encoding"], n_levels=4, n_features_per_level=8))


def test_mlp_flops_by_hand():
    # base: SDF 31 -> 64 -> 16, RGB 38 -> 64 -> 64 -> 3 (16 + SH 16 + xyz + normal).
    sdf = 2 * (31 * 64 + 64 * 16)  # 6,016
    rgb = 2 * (38 * 64 + 64 * 64 + 64 * 3)  # 13,440
    assert counts.forward_flops_per_sample(BASE) == 4 * sdf + rgb == 37504
    assert counts.train_flops_per_sample(BASE) == 112512
    # l4f8: 4 x 8 features, SDF input 35.
    assert counts.forward_flops_per_sample(L4F8) == 4 * 2 * (35 * 64 + 64 * 16) + rgb == 39552
    assert counts.samples_per_step(BASE) == 4096 * 64 == 262144


@pytest.mark.parametrize("config, rows, bytes_, least_ms", [
    (BASE, 5274064, 14 * 262144 * 8 * (4 + 2 * 2) + 5274064 * 2 * 4, 0.0827085182),
    (L4F8, 1576960, 4 * 262144 * 8 * (4 + 2 * 8) + 1576960 * 8 * 4, 0.0651447403),
])
def test_kernel1_bytes_by_hand(config, rows, bytes_, least_ms):
    assert sum(counts.table_rows(config)) == rows
    assert counts.kernel1_bytes(config) == bytes_
    assert counts.kernel1_least_s(config) * 1e3 == pytest.approx(least_ms, rel=1e-9)


def test_busy_union_and_gaps():
    iv = np.array([[0.0, 10.0], [5.0, 12.0], [20.0, 25.0], [24.0, 30.0], [40.0, 41.0]])
    busy, gaps = trace._union(iv)
    assert busy == 12.0 + 10.0 + 1.0
    assert gaps.tolist() == [[12.0, 20.0], [30.0, 40.0]]
    host = [("aten::mm", 11.0, 21.0), ("portbench.frame", 0.0, 50.0), ("cudaLaunchKernel", 14, 18)]
    named = trace._name_gaps(gaps, host)
    assert [n for n, _ in named] == ["portbench.frame", "aten::mm"]
    assert [s for _, s in named] == pytest.approx([10e-6, 8e-6])
