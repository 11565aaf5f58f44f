"""The port's CUDA path on the card: the four segment-sum kernels against
their plain versions, the segment-sum op layer on the card against the
CPU, and one training step on the card against the same step on the CPU.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package, so it runs where they are absent;
``--noconftest`` keeps pytest from loading ``tests/conftest.py``, which
imports JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: the kernel sums in fp32 in another order than the plain
version's float64 sum, so max |diff| <= 1e-5 * max|ref| + 1e-7.  Against
the CPU step, forward quantities agree to fp32 rounding (rtol 1e-4) and the
MLP gradients within 1e-3 of their max; table gradients within 1e-2 of
their max, because the card sums bf16-quantized updates (the reference's
fp16-atomic precision) where the CPU sums exact fp32.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from neus2_tpu_torch.api.testbed import config_from_json
from neus2_tpu_torch.data.synthetic import make_sphere_dataset
from neus2_tpu_torch.engine import train as tt
from neus2_tpu_torch.ops import scatter, segment_tile
from neus2_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda
BASE_JSON = Path(__file__).resolve().parent.parent / "configs" / "base.json"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(sizes, m, f, seed, dense_levels=()):
    rng = np.random.default_rng(seed)
    idx, upd = [], []
    for lvl, s in enumerate(sizes):
        hi = max(1, s // 16) if lvl in dense_levels else s
        idx.append(torch.from_numpy(rng.integers(0, hi, m)))
        upd.append(torch.from_numpy(rng.normal(size=(m, f)).astype(np.float32)))
    return idx, upd


@pytest.mark.parametrize("f", [2, 8])
def test_kernel_matches_plain_version(cuda, f):
    sizes = [4096, 32768, 1 << 16]
    idx, upd = _inputs(sizes, 1 << 16, f, seed=f, dense_levels=(0,))
    ti = [i.to(cuda) for i in idx]
    tu = [u.to(cuda) for u in upd]
    before = segment_tile.segment_sum_rows.launches
    got = segment_tile.segment_sum_all_levels(ti, tu, sizes)
    again = segment_tile.segment_sum_all_levels(ti, tu, sizes)
    assert segment_tile.segment_sum_rows.launches == before + 2
    ref = segment_tile.segment_sum_all_levels_ref(ti, tu, sizes)
    torch.cuda.synchronize()
    for g, a, r, s in zip(got, again, ref, sizes):
        assert g.shape == (s, f) and g.dtype == torch.float32
        assert torch.equal(g, a)
        assert (g - r).abs().max() <= 1e-5 * r.abs().max() + 1e-7


def test_kernel_writes_every_row(cuda):
    """Rows without updates come out exactly 0.0 (the optimizer's lazy skip
    keys off it), and one row taking every update of its level sums them
    all."""
    sizes = [8, 1000]
    m = 1 << 15
    idx = [torch.zeros(m, dtype=torch.int64), torch.arange(m) % 7 * 100]
    upd = [torch.ones(m, 2), torch.full((m, 2), 0.5)]
    # Fill the allocator's cache with non-zero bytes, so a row the kernel
    # skipped would not read as zero by luck.
    torch.full((1 << 22,), 7.0, device=cuda)
    out = segment_tile.segment_sum_all_levels(
        [i.to(cuda) for i in idx], [u.to(cuda) for u in upd], sizes
    )
    ref = segment_tile.segment_sum_all_levels_ref(idx, upd, sizes)
    for o, r in zip(out, ref):
        assert torch.equal(o.cpu(), r)
    assert out[0][0].tolist() == [float(m), float(m)]
    assert int((out[1] != 0).any(-1).sum()) == 7


def test_kernel_wrapper_checks_its_inputs(cuda):
    bounds = torch.zeros(3, dtype=torch.int32, device=cuda)
    payload = torch.zeros((4, 2), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        segment_tile.segment_sum_rows(bounds, payload.float())
    with pytest.raises(ValueError):
        segment_tile.segment_sum_rows(bounds.long(), payload)
    with pytest.raises(ValueError):
        segment_tile.segment_sum_rows(bounds, torch.zeros((4, 3), dtype=torch.bfloat16, device=cuda))
    with pytest.raises(ValueError):
        segment_tile.segment_sum_rows(bounds, payload.t())


def _sorted_streams(n_levels, m, n_rows, f, seed, pad=256):
    """(L, Mp) ascending indices padded with PAD_IDX, (L, Mp, F) values."""
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.integers(0, n_rows, (n_levels, m)), axis=-1)
    idx = np.concatenate([idx, np.full((n_levels, pad), segment_tile.PAD_IDX)], 1)
    vals = rng.normal(size=(n_levels, m + pad, f)).astype(np.float32)
    vals[:, m:] = 0.0
    return torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(vals)


@pytest.mark.parametrize("f", [2, 8])
@pytest.mark.parametrize("kernel", ["packed", "batched", "planar"])
def test_sorted_kernels_match_plain_versions(cuda, kernel, f):
    """Kernels 2, 3 and 4 through their entry points: bitwise repeatable,
    within 1e-5 * max|ref| + 1e-7 of the plain version on the same inputs,
    one launch per call."""
    n_rows = 1 << 14
    idx, vals = _sorted_streams(3, 1 << 16, n_rows, f, seed=f)
    if kernel == "packed":
        l, mp, _ = vals.shape
        payload = segment_tile.pack_bf16_pairs(vals.reshape(l * mp, f))
        payload = payload.reshape(l, mp, -1).transpose(1, 2).contiguous()
        entry, wrapper = segment_tile.sorted_segment_sum_tiles_packed, segment_tile.segment_sum_packed_rows
    elif kernel == "batched":
        payload = vals.transpose(1, 2).contiguous()
        entry, wrapper = segment_tile.sorted_segment_sum_tiles_batched, segment_tile.segment_sum_batched_rows
    else:
        idx, payload = idx[0], vals[0].t().contiguous()
        entry, wrapper = segment_tile.sorted_segment_sum_tiles, segment_tile.segment_sum_planar_rows
    ref = entry(idx, payload, n_rows)  # CPU tensors: the plain version
    before = wrapper.launches
    got = entry(idx.to(cuda), payload.to(cuda), n_rows)
    again = entry(idx.to(cuda), payload.to(cuda), n_rows)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert torch.equal(got, again)
    got = got.cpu()
    for g, r in zip(*((got, ref) if got.dim() == 3 else ([got], [ref]))):
        assert (g - r).abs().max() <= 1e-5 * r.abs().max() + 1e-7


def test_sorted_kernels_write_every_row(cuda):
    """Rows without updates come out exactly 0.0; the padding is never read."""
    n_rows, m = 1024, 1 << 12
    idx = torch.cat([torch.full((m,), 5), torch.full((64,), segment_tile.PAD_IDX)])
    idx = idx.to(torch.int32)[None].repeat(2, 1)
    vals = torch.ones((2, 8, m + 64))
    vals[:, :, m:] = 1e30  # would show if the padding were summed
    torch.full((1 << 22,), 7.0, device=cuda)
    out = segment_tile.sorted_segment_sum_tiles_batched(idx.to(cuda), vals.to(cuda), n_rows).cpu()
    assert out[:, 5].tolist() == [[float(m)] * 8] * 2
    assert int((out != 0).sum()) == 16


def test_sorted_wrappers_check_their_inputs(cuda):
    bounds = torch.zeros((2, 5), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # F = 4 is not built
        segment_tile.segment_sum_batched_rows(bounds, torch.zeros((2, 4, 8), device=cuda))
    with pytest.raises(ValueError):
        segment_tile.segment_sum_packed_rows(bounds, torch.zeros((2, 1, 8), device=cuda))
    with pytest.raises(ValueError):  # levels disagree
        segment_tile.segment_sum_packed_rows(
            bounds, torch.zeros((3, 1, 8), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        segment_tile.segment_sum_planar_rows(bounds, torch.zeros((2, 8), device=cuda))
    with pytest.raises(ValueError):  # CPU tensors never reach a kernel
        segment_tile.segment_sum_planar_rows(bounds[0].cpu(), torch.zeros((2, 8)))


@pytest.mark.parametrize("method", ["auto", "sorttile", "sort"])
def test_segment_dense_sum_on_card_matches_cpu(cuda, method):
    """The op layer on the card against the exact CPU scatter: "auto" with
    the uniform hint and "sorttile" go through kernel 4 on bf16-packed
    values (error within bf16 rounding of the updates), "sort" carries fp32
    cancellation (|err| < 0.05, the JAX package's bound for it)."""
    n_rows, m = 1 << 14, 1 << 17
    rng = np.random.default_rng(1)
    idx = torch.from_numpy(rng.integers(0, n_rows, m).astype(np.int32))
    upd = torch.from_numpy(rng.normal(size=(m, 2)).astype(np.float32))
    ref = scatter.segment_dense_sum(idx, upd, n_rows)  # CPU: exact scatter
    before = segment_tile.segment_sum_planar_rows.launches
    got = scatter.segment_dense_sum(idx.to(cuda), upd.to(cuda), n_rows, method=method,
                                    uniform_hint=True).cpu()
    assert segment_tile.segment_sum_planar_rows.launches == before + (method != "sort")
    assert got.shape == ref.shape
    if method == "sort":
        assert (got - ref).abs().max() < 0.05
    else:
        exact_bf16 = scatter.segment_dense_sum(idx, upd.to(torch.bfloat16).float(), n_rows)
        assert (got - exact_bf16).abs().max() <= 1e-5 * exact_bf16.abs().max() + 1e-6


def _small_config():
    cfg, _ = config_from_json(BASE_JSON)
    grid = dataclasses.replace(cfg.field.grid, n_levels=4, log2_hashmap_size=12)
    field = dataclasses.replace(cfg.field, grid=grid, sdf_hidden_dim=16, rgb_hidden_dim=16)
    return dataclasses.replace(cfg, field=field, n_rays=64, samples_per_ray=16,
                               n_candidates=32, occ_n_probe=4096)


def _state_to(state, device):
    move = lambda t: t.to(device)
    return state._replace(
        params=tree_map(move, state.params),
        ema_params=tree_map(move, state.ema_params),
        opt_state={k: v if k == "count" else tree_map(move, v)
                   for k, v in state.opt_state.items()},
        occupancy=state.occupancy._replace(
            density=move(state.occupancy.density), bitfield=move(state.occupancy.bitfield)
        ),
        generator=torch.Generator(device=device).manual_seed(0),
    )


def test_train_step_on_card_matches_cpu(cuda):
    cfg = _small_config()
    images, cams = make_sphere_dataset(n_views=4, resolution=32, seed=0).to_device("cpu")
    state = tt.init_train_state(cfg, 4, seed=0, device="cpu")
    state = tt.occupancy_prior_sweep(state, cfg)
    draws = tt.sample_step_draws(torch.Generator().manual_seed(5), cfg, 4)

    cpu_grads, cpu_aux = tt.loss_and_grads(state.params, state, images, cams, draws, cfg)
    cstate = _state_to(state, cuda)
    c_images, c_cams = make_sphere_dataset(n_views=4, resolution=32, seed=0).to_device(cuda)
    c_draws = tt.StepDraws(*(d.to(cuda) for d in draws))
    before = segment_tile.segment_sum_rows.launches
    gpu_grads, gpu_aux = tt.loss_and_grads(cstate.params, cstate, c_images, c_cams, c_draws, cfg)
    torch.cuda.synchronize()
    assert segment_tile.segment_sum_rows.launches == before + 1

    assert int(gpu_aux.n_valid_samples) == int(cpu_aux.n_valid_samples) > 0
    for name in tt.StepAux._fields:
        np.testing.assert_allclose(float(getattr(gpu_aux, name)), float(getattr(cpu_aux, name)),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    n_tables = cfg.field.grid.n_levels
    for i, (g, c) in enumerate(zip(tree_leaves(gpu_grads), tree_leaves(cpu_grads))):
        g = g.cpu()
        assert g.shape == c.shape and torch.isfinite(g).all()
        limit = 1e-2 if i < n_tables else 1e-3
        assert float((g - c).abs().max()) <= limit * max(float(c.abs().max()), 1e-12), i
