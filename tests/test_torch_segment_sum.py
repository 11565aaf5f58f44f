"""Port parity of the hash-grid backward's segment sum.

The plain version (bf16-quantized updates, float64 sums, fp32 out) is held
against the JAX package's Pallas kernel in interpret mode (relative error
< 1e-5 of max|ref|, the bound of tests/test_scatter.py); the CPU dispatch
of ``segment_dense_sum_multi`` against ``np.add.at`` (atol 1e-4).  The CUDA
kernel itself runs only on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py``)."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neus2_tpu.ops.segment_tile import segment_sum_all_levels as jax_all_levels
from neus2_tpu_torch.ops import segment_tile
from neus2_tpu_torch.ops.scatter import segment_dense_sum_multi

torch.set_num_threads(2)


def _inputs(sizes, M, F, seed, dense_levels=()):
    rng = np.random.default_rng(seed)
    idx, upd = [], []
    for l, s in enumerate(sizes):
        if l in dense_levels:  # concentrated, as on coarse dense levels
            i = rng.integers(0, max(1, s // 16), M)
        else:
            i = rng.integers(0, s, M)
        idx.append(i.astype(np.int32))
        upd.append(rng.normal(size=(M, F)).astype(np.float32))
    return idx, upd


@pytest.mark.parametrize("F", [2, 4, 8])
def test_plain_version_matches_jax_interpret_kernel(F):
    sizes = [512, 1728, 4096]
    idx, upd = _inputs(sizes, 4096, F, seed=F, dense_levels=(0,))
    ref = jax_all_levels(
        [jnp.asarray(i) for i in idx], [jnp.asarray(u) for u in upd], sizes,
        row_block=256, chunk=256, interpret=True,
    )
    got = segment_tile.segment_sum_all_levels_ref(
        [torch.from_numpy(i) for i in idx], [torch.from_numpy(u) for u in upd], sizes
    )
    for r, g, s in zip(ref, got, sizes):
        r = np.asarray(r)
        assert g.shape == (s, F) and g.dtype == torch.float32
        assert np.abs(g.numpy() - r).max() / (np.abs(r).max() + 1e-9) < 1e-5


@pytest.mark.parametrize("F", [2, 4, 8])
def test_cpu_dispatch_is_exact_scatter(F):
    sizes = [64, 300, 1024]
    idx, upd = _inputs(sizes, 2048, F, seed=10 + F)
    outs = segment_dense_sum_multi(
        [torch.from_numpy(i) for i in idx], [torch.from_numpy(u) for u in upd], sizes
    )
    for l, s in enumerate(sizes):
        ref = np.zeros((s, F), np.float32)
        np.add.at(ref, idx[l], upd[l])
        np.testing.assert_allclose(outs[l].numpy(), ref, atol=1e-4)


def test_cpu_wrapper_takes_plain_version_and_empty_rows_are_zero():
    sizes = [100, 50]
    idx = [torch.tensor([3, 3, 7], dtype=torch.int32), torch.tensor([0, 49, 49])]
    upd = [torch.ones(3, 2), torch.full((3, 2), 0.5)]
    before = segment_tile.segment_sum_rows.launches
    out = segment_tile.segment_sum_all_levels(idx, upd, sizes)
    assert segment_tile.segment_sum_rows.launches == before
    assert out[0][3].tolist() == [2.0, 2.0] and out[1][49].tolist() == [1.0, 1.0]
    assert int((out[0] != 0).any(-1).sum()) == 2


def test_sort_updates_bounds_and_order():
    """The global-row sort the kernel consumes: int32 keys (level offset +
    index) ascending, so each row's updates are one run of equal keys, and
    equal keys keep input order (stable)."""
    sizes = [4, 3]
    idx = [torch.tensor([2, 0, 2, 3]), torch.tensor([1, 1, 0, 2])]
    upd = [torch.arange(8.0).reshape(4, 2), 10 + torch.arange(8.0).reshape(4, 2)]
    keys, payload = segment_tile.sort_updates(idx, upd, sizes)
    assert keys.dtype == torch.int32 and keys.tolist() == [0, 2, 2, 3, 4, 5, 5, 6]
    assert payload.dtype == torch.bfloat16
    assert payload[:, 0].float().tolist() == [2.0, 0.0, 4.0, 6.0, 14.0, 10.0, 12.0, 16.0]


def test_kernel_module_imports_without_building():
    """Importing the port (and its kernel module) never runs nvcc."""
    code = (
        "import neus2_tpu_torch.ops.segment_tile as st, "
        "neus2_tpu_torch.utils.cuda_build as cb, subprocess\n"
        "calls = []\n"
        "subprocess.run = lambda *a, **k: calls.append(a)\n"
        "import neus2_tpu_torch.ops.hashgrid_fast, neus2_tpu_torch.engine.train\n"
        "assert not calls and not cb.load.cache_info().currsize\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_kernel_wrapper_rejects_cpu_tensors():
    before = segment_tile.segment_sum_rows.launches
    with pytest.raises(ValueError):
        segment_tile.segment_sum_rows(
            torch.zeros(1, dtype=torch.int32), torch.zeros((1, 2), dtype=torch.bfloat16), 2
        )
    assert segment_tile.segment_sum_rows.launches == before
