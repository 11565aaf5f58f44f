"""Port parity of the segment-sum op layer: kernels 2-4's plain versions
against the JAX package's Pallas kernels in interpret mode, the bf16 pair
packing bit for bit, the scatter-free "sort" method, the "auto" routing
and the capacity contract the port does not copy.

Tolerances: the plain versions sum in float64 what the TPU kernels sum in
fp32 (after the same bf16 rounding), so relative error < 1e-5 of max|ref|,
as tests/test_scatter.py holds the packed path; the "sort" method carries
fp32 cumulative-sum cancellation and is held to tests/test_scatter.py:141's
absolute bound of 0.05 at M = 2^20.  The CUDA kernels themselves run only on
the card (``chip_smoke.py`` and ``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neus2_tpu.ops import scatter as jsc
from neus2_tpu.ops import segment_tile as jst
from neus2_tpu_torch.ops import scatter, segment_tile

torch.set_num_threads(2)
ROW_BLOCK = 256  # the JAX tests' tile height, so interpret mode stays quick


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9))


def _uniform(m, n_rows, f, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_rows, m).astype(np.int32),
            rng.normal(size=(m, f)).astype(np.float32))


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("f", [2, 4, 8])
def test_sorttile_matches_jax(f, pack):
    """Kernel 4's path: sort + per-row sum, bf16 pairs through the sort when
    packed, exact fp32 otherwise (tests/test_scatter.py:64-87's sizes)."""
    n_rows = 1 << 11
    idx, upd = _uniform(1 << 13 if f == 2 else 1 << 12, n_rows, f, seed=f + 10 * pack)
    ref = jst.segment_sum_sorttile(jnp.asarray(idx), jnp.asarray(upd), n_rows,
                                   row_block=ROW_BLOCK, pack=pack, interpret=True)
    got = segment_tile.segment_sum_sorttile(torch.from_numpy(idx), torch.from_numpy(upd),
                                            n_rows, row_block=ROW_BLOCK, pack=pack)
    assert got.shape == (n_rows, f) and got.dtype == torch.float32
    assert _rel_err(got, ref) < 1e-5


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("f", [2, 4, 8])
def test_sorttile_batched_matches_jax(f, pack):
    """Kernel 3's path: the payload is rounded to bf16 inside the TPU kernel
    even with ``pack=False``, and so it is in the port."""
    n_levels, m, n_rows = 3, 4096, 2048
    rng = np.random.default_rng(20 + f)
    idx = rng.integers(0, n_rows, (n_levels, m)).astype(np.int32)
    idx[0] = rng.integers(0, 64, m)  # a concentrated, dense-level-like stream
    upd = rng.normal(size=(n_levels, m, f)).astype(np.float32)
    ref = jst.segment_sum_sorttile_batched(jnp.asarray(idx), jnp.asarray(upd), n_rows,
                                           row_block=ROW_BLOCK, chunk=256, pack=pack,
                                           interpret=True)
    got = segment_tile.segment_sum_sorttile_batched(torch.from_numpy(idx),
                                                    torch.from_numpy(upd), n_rows,
                                                    row_block=ROW_BLOCK, pack=pack)
    assert got.shape == (n_levels, n_rows, f)
    for lvl in range(n_levels):
        assert _rel_err(got[lvl], ref[lvl]) < 1e-5
    # Not the exact fp32 sum: the rounding is there without packing too.
    exact = np.zeros((n_rows, f), np.float64)
    np.add.at(exact, idx[1], upd[1].astype(np.float64))
    assert np.abs(got[1].numpy() - exact).max() > 1e-4


@pytest.mark.parametrize("f", [2, 3, 8])
def test_sorted_packed_matches_jax(f):
    """Kernel 2 on the JAX layout: sorted per level, padded with 2^31 - 1,
    (L, P, Mp) packed pairs; odd F pads a zero channel."""
    n_levels, m, pad, n_rows = 2, 4096, 512, 2048
    rng = np.random.default_rng(30 + f)
    idx = np.sort(rng.integers(0, n_rows, (n_levels, m)), axis=-1).astype(np.int32)
    idx = np.concatenate([idx, np.full((n_levels, pad), segment_tile.PAD_IDX, np.int32)], 1)
    upd = rng.normal(size=(n_levels, m + pad, f)).astype(np.float32)
    packed = np.stack([np.asarray(jst.pack_bf16_pairs(jnp.asarray(u))).T for u in upd])
    ref = jst.sorted_segment_sum_tiles_packed(jnp.asarray(idx), jnp.asarray(packed), n_rows,
                                              row_block=ROW_BLOCK, chunk=256, interpret=True)
    got = segment_tile.sorted_segment_sum_tiles_packed(
        torch.from_numpy(idx), torch.from_numpy(packed), n_rows, row_block=ROW_BLOCK)
    assert got.shape == ref.shape == (n_levels, n_rows, 2 * ((f + 1) // 2))
    for lvl in range(n_levels):
        assert _rel_err(got[lvl], ref[lvl]) < 1e-5


@pytest.mark.parametrize("f", [1, 2, 3, 8])
def test_pack_bf16_pairs_bit_for_bit(f):
    """Same int32 bits as JAX's bitcast: channel 2k in the low half."""
    _, upd = _uniform(257, 16, f, seed=f)
    upd[0, 0] = 1.0  # bf16 0x3f80 in the low half of the first int32
    ref = np.asarray(jst.pack_bf16_pairs(jnp.asarray(upd)))
    got = segment_tile.pack_bf16_pairs(torch.from_numpy(upd))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert int(got[0, 0]) & 0xFFFF == 0x3F80
    back = segment_tile.unpack_bf16_pairs(got, f)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jst.unpack_bf16_pairs(jnp.asarray(ref), f)))


def test_sort_method_accuracy_at_scale():
    """The scatter-free two-sort pipeline as torch ops, held to the JAX
    package's bound for it (tests/test_scatter.py:123-141)."""
    rng = np.random.default_rng(0)
    m, n_rows = 1 << 20, 1 << 13
    idx = rng.integers(0, n_rows, size=m).astype(np.int32)
    upd = rng.standard_normal((m, 2), dtype=np.float32)
    ref64 = np.zeros((n_rows, 2), np.float64)
    np.add.at(ref64, idx, upd.astype(np.float64))
    got = scatter.segment_dense_sum(torch.from_numpy(idx), torch.from_numpy(upd), n_rows,
                                    method="sort")
    assert np.abs(got.numpy().astype(np.float64) - ref64).max() < 0.05


@pytest.mark.parametrize("case", ["basic", "more_rows", "f5", "same_index", "edges"])
def test_sort_method_matches_jax(case):
    if case == "same_index":
        idx, upd, n_rows = np.full(256, 7, np.int32), np.ones((256, 2), np.float32), 16
    elif case == "edges":
        idx = np.array([0, 0, 15, 15, 15], np.int32)
        upd, n_rows = np.arange(10, dtype=np.float32).reshape(5, 2), 16
    else:
        m, n_rows, f = {"basic": (1024, 128, 2), "more_rows": (64, 1024, 2),
                        "f5": (512, 64, 5)}[case]
        idx, upd = _uniform(m, n_rows, f, seed=len(case))
    ref = jsc.segment_dense_sum(jnp.asarray(idx), jnp.asarray(upd), n_rows, method="sort")
    got = scatter.segment_dense_sum(torch.from_numpy(idx), torch.from_numpy(upd), n_rows,
                                    method="sort")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_auto_on_cpu_is_the_exact_scatter():
    idx, upd = _uniform(512, 4096, 2, seed=1)
    before = [k.launches for k in segment_tile.KERNELS]
    got = scatter.segment_dense_sum(torch.from_numpy(idx), torch.from_numpy(upd), 4096,
                                    method="auto", uniform_hint=True)
    ref = jsc.segment_dense_sum(jnp.asarray(idx), jnp.asarray(upd), 4096, method="auto",
                                uniform_hint=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    assert [k.launches for k in segment_tile.KERNELS] == before


@pytest.mark.parametrize("n_rows,hint,want", [
    (4096, True, "sorttile"), (8192, True, "sorttile"), (4096, False, "sort"),
    (2048, True, "sort"), (4608 + 1, True, "sort"), (5120, True, "sorttile"),
])
def test_auto_routing_off_the_cpu(monkeypatch, n_rows, hint, want):
    """JAX's rule for any device but the CPU (scatter.py:63-69), shown on
    tensors of the meta device with both methods stubbed."""
    took = []
    monkeypatch.setattr(scatter, "segment_sum_sorttile", lambda *a: took.append("sorttile"))
    monkeypatch.setattr(scatter, "_sort_method", lambda *a: took.append("sort"))
    idx = torch.zeros(64, dtype=torch.int32, device="meta")
    upd = torch.zeros((64, 2), device="meta")
    scatter.segment_dense_sum(idx, upd, n_rows, uniform_hint=hint)
    assert took == [want]


@pytest.mark.parametrize("method", ["auto", "packed", "scatter", "sort", "sorttile"])
def test_segment_dense_sum_multi_methods(method):
    """Every ``method`` of the all-levels dispatch against np.add.at: the
    exact paths to fp32 rounding, the bf16 paths ("packed", "sorttile"
    packs by default) to the bf16-rounded sum."""
    sizes = [512, 1536, 4096]
    rng = np.random.default_rng(3)
    idx = [rng.integers(0, s, 4096).astype(np.int32) for s in sizes]
    upd = [rng.normal(size=(4096, 2)).astype(np.float32) for _ in sizes]
    outs = scatter.segment_dense_sum_multi([torch.from_numpy(i) for i in idx],
                                           [torch.from_numpy(u) for u in upd], sizes,
                                           method=method)
    bf16 = method in ("packed", "sorttile")
    for out, i, u, s in zip(outs, idx, upd, sizes):
        if bf16:
            u = torch.from_numpy(u).to(torch.bfloat16).float().numpy()
        ref = np.zeros((s, 2), np.float64)
        np.add.at(ref, i, u.astype(np.float64))
        assert out.shape == (s, 2)
        assert np.abs(out.numpy() - ref).max() < (1e-5 if bf16 or method == "scatter" else 1e-4)


def test_capacity_contract_is_not_copied():
    """The TPU's ``sorted_segment_sum_tiles`` sums at most ``elems_cap``
    elements of a 512-row tile (its DMA window ends there) and silently
    drops the rest; the port sums them all.  ``debug_overflow_check``
    reports the load both ways."""
    n_rows, cap = 2048, 1024
    rng = np.random.default_rng(5)
    idx = np.sort(np.concatenate([rng.integers(0, 512, 3000),
                                  rng.integers(512, n_rows, 500)])).astype(np.int32)
    vals = rng.normal(size=(2, idx.shape[0])).astype(np.float32)
    load = segment_tile.debug_overflow_check(torch.from_numpy(idx), n_rows)
    assert load == int(jst.debug_overflow_check(jnp.asarray(idx), n_rows)) > cap

    exact = np.zeros((n_rows, 2), np.float64)
    np.add.at(exact, idx, vals.T.astype(np.float64))
    tpu = np.asarray(jst.sorted_segment_sum_tiles(jnp.asarray(idx), jnp.asarray(vals), n_rows,
                                                  elems_cap=cap, interpret=True))
    port = segment_tile.sorted_segment_sum_tiles(torch.from_numpy(idx), torch.from_numpy(vals),
                                                 n_rows).numpy()
    assert np.abs(tpu - exact).max() > 1.0  # the TPU kernel lost updates
    assert np.abs(port - exact).max() < 1e-4
    # Within capacity the two agree.
    ok = np.asarray(jst.sorted_segment_sum_tiles(jnp.asarray(idx), jnp.asarray(vals), n_rows,
                                                 elems_cap=4096, interpret=True))
    assert _rel_err(port, ok) < 1e-5


def test_row_block_must_divide_the_rows():
    idx, upd = _uniform(64, 1000, 2, seed=0)
    with pytest.raises(ValueError):
        segment_tile.segment_sum_sorttile(torch.from_numpy(idx), torch.from_numpy(upd), 1000)


@pytest.mark.parametrize("wrapper,payload", [
    ("segment_sum_packed_rows", torch.zeros((1, 1, 4), dtype=torch.int32)),
    ("segment_sum_batched_rows", torch.zeros((1, 2, 4))),
    ("segment_sum_planar_rows", torch.zeros((2, 4))),
])
def test_kernel_wrappers_reject_cpu_tensors(wrapper, payload):
    """(keys, payload, n_rows) on the CPU: (L, Mp) keys and an (L, C, Mp)
    payload for kernels 2 and 3, (M,) keys and (F, M) for kernel 4."""
    before = getattr(segment_tile, wrapper).launches
    keys = torch.zeros(payload.shape[:-2] + (4,), dtype=torch.int32)
    with pytest.raises(ValueError):
        getattr(segment_tile, wrapper)(keys, payload, 2)
    assert getattr(segment_tile, wrapper).launches == before
