"""Port parity of the hash grid: level tables, corner hashing, the encoder's
features and Jacobian, and its hand-built backward, against ``neus2_tpu``.

Tolerances (fp32): features/Jacobian rtol 1e-5; table and position
gradients 1e-5 of the reference's max magnitude (summation order differs:
the port scatters per corner, the JAX package fuses dense-level corners).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neus2_tpu.ops import hashgrid as jh
from neus2_tpu.ops.hashgrid_fast import make_encode_jac as jax_make_encode_jac
from neus2_tpu_torch.ops import hashgrid as th
from neus2_tpu_torch.ops.hashgrid_fast import make_encode_jac

torch.set_num_threads(2)

_SMALL = dict(n_levels=4, log2_hashmap_size=12, base_resolution=16,
              per_level_scale=2.0)


def _configs(F):
    kw = dict(_SMALL, n_features_per_level=F)
    return jh.HashGridConfig(**kw), th.HashGridConfig(**kw)


def test_level_tables_base_json():
    scale = jh.HashGridConfig.per_level_scale_from_top(16, 2048, 14)
    assert th.HashGridConfig.per_level_scale_from_top(16, 2048, 14) == scale
    jc = jh.HashGridConfig(per_level_scale=scale)
    tc = th.HashGridConfig(per_level_scale=scale)
    assert tc.level_tables() == jc.level_tables()
    _, _, _, sizes, use_hash = tc.level_tables()
    assert sum(sizes) == 5_274_064 and use_hash == [False] * 5 + [True] * 9
    for step in range(0, 800, 7):
        assert tc.valid_level(step) == int(jc.valid_level(jnp.int32(step)))


@pytest.mark.parametrize("use_hash", [True, False])
def test_corner_indices(use_hash):
    rng = np.random.default_rng(0)
    pg = rng.integers(0, 3200, (4096, 3)).astype(np.int32)
    size = 1 << 19 if use_hash else 4096
    ref = jh._corner_indices(jnp.asarray(pg), 17, size, use_hash)
    got = th._corner_indices(torch.from_numpy(pg).long(), 17, size, use_hash)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def _setup(F, n=96, seed=0):
    jc, tc = _configs(F)
    rng = np.random.default_rng(seed)
    _, _, _, sizes, _ = tc.level_tables()
    tables = [rng.uniform(-1, 1, (s, F)).astype(np.float32) for s in sizes]
    x = rng.uniform(0.02, 0.98, (n, 3)).astype(np.float32)
    return jc, tc, tables, x, rng


@pytest.mark.parametrize("F", [2, 4, 8])
def test_encode_jac_forward(F):
    jc, tc, tables, x, _ = _setup(F)
    jf, jj = jax_make_encode_jac(jc)([jnp.asarray(t) for t in tables], jnp.asarray(x))
    tf, tj = make_encode_jac(tc)([torch.from_numpy(t) for t in tables], torch.from_numpy(x))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize(
    "F,valid_level,with_max_level",
    [(2, None, False), (2, 1, False), (2, None, True), (8, 2, True), (4, None, False),
     (4, 2, True)],
)
def test_encode_jac_vjp(F, valid_level, with_max_level):
    jc, tc, tables, x, rng = _setup(F, seed=F)
    n = x.shape[0]
    ct_f = rng.normal(size=(n, jc.output_dim)).astype(np.float32)
    ct_j = rng.normal(size=(n, 3, jc.output_dim)).astype(np.float32)
    ml = rng.uniform(0, 1, n).astype(np.float32) if with_max_level else None

    enc = jax_make_encode_jac(jc)

    def f(tabs, pos):
        return enc(tabs, pos, valid_level, None if ml is None else jnp.asarray(ml))

    _, vjp = jax.vjp(f, tuple(jnp.asarray(t) for t in tables), jnp.asarray(x))
    d_tabs, d_x = vjp((jnp.asarray(ct_f), jnp.asarray(ct_j)))

    tt = [torch.from_numpy(t).requires_grad_(True) for t in tables]
    tx = torch.from_numpy(x).requires_grad_(True)
    feat, jac = make_encode_jac(tc)(
        tt, tx, valid_level, None if ml is None else torch.from_numpy(ml)
    )
    torch.autograd.backward([feat, jac], [torch.from_numpy(ct_f), torch.from_numpy(ct_j)])

    ref_x = np.asarray(d_x)
    assert np.abs(tx.grad.numpy() - ref_x).max() <= 1e-5 * np.abs(ref_x).max()
    for t, r in zip(tt, d_tabs):
        r = np.asarray(r)
        assert np.abs(t.grad.numpy() - r).max() <= 1e-5 * max(np.abs(r).max(), 1e-6)
        # Rows without updates stay exactly zero (the Adam lazy skip).
        np.testing.assert_array_equal(t.grad.numpy() == 0, r == 0)


def test_table_grad_skips_position_grad_when_not_needed():
    jc, tc, tables, x, _ = _setup(2)
    tt = [torch.from_numpy(t).requires_grad_(True) for t in tables]
    tx = torch.from_numpy(x)
    feat, jac = make_encode_jac(tc)(tt, tx)
    (feat.sum() + jac.sum()).backward()
    assert tx.grad is None and all(t.grad is not None for t in tt)


@pytest.mark.parametrize("F", [2, 4, 8])
def test_position_grad_skips_table_grad_when_no_table_trains(F, monkeypatch):
    """Pose refinement: only the positions need a gradient, so the backward
    makes no table gradient (no ``segment_dense_sum_multi`` call, no sort,
    no kernel) and its position gradient is bitwise the one computed
    beside the table gradient; the table gradient itself is unchanged."""
    from neus2_tpu_torch.ops import hashgrid_fast

    calls = []
    real = hashgrid_fast.segment_dense_sum_multi
    monkeypatch.setattr(hashgrid_fast, "segment_dense_sum_multi",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    jc, tc, tables, x, rng = _setup(F, seed=3)
    ct = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for s in ((x.shape[0], tc.output_dim), (x.shape[0], 3, tc.output_dim))]
    grads = {}
    for train_tables in (True, False):
        tt = [torch.from_numpy(t).requires_grad_(train_tables) for t in tables]
        tx = torch.from_numpy(x).requires_grad_(True)
        feat, jac = make_encode_jac(tc)(tt, tx, 2)
        torch.autograd.backward([feat, jac], ct)
        grads[train_tables] = (tx.grad, [t.grad for t in tt])
    assert calls == [1]
    np.testing.assert_array_equal(grads[False][0].numpy(), grads[True][0].numpy())
    assert all(g is None for g in grads[False][1])

    enc = jax_make_encode_jac(jc)
    _, vjp = jax.vjp(lambda tabs, pos: enc(tabs, pos, 2),
                     tuple(jnp.asarray(t) for t in tables), jnp.asarray(x))
    d_tabs, d_x = vjp((jnp.asarray(ct[0].numpy()), jnp.asarray(ct[1].numpy())))
    ref_x = np.asarray(d_x)
    assert np.abs(grads[False][0].numpy() - ref_x).max() <= 1e-5 * np.abs(ref_x).max()
    for g, r in zip(grads[True][1], d_tabs):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-5 * max(np.abs(r).max(), 1e-6)
