"""The port's CUDA path on the card: the four segment-sum kernels against
their plain versions and on edge streams, the segment-sum op layer on the
card against the CPU, one training step on the card against the same step
on the CPU, a dynamic step in each phase (pose refinement, finetune) and
the residual grid's freeze on the card against the CPU, the error
map's deposit, rebuild and sampling on the card against the CPU and its
deposit against itself, a native snapshot's round trip on the card, the
rays of every camera model and the fp16 texel gather on the card against
the CPU, bf16 compute (the encoder's backward, the MLP) on the card
against the CPU's bf16 path, and the SDF and image fit modes' steps on the
card against the CPU (kernel 1 in the SDF step, kernel 4 once a level in
the image step, held against its plain version at that step's shapes).

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
fp16-atomic precision) where the CPU sums exact fp32.  A dynamic step's
delta gradient within 1e-3 of its max (a sum over every sample), its new
delta within 2e-4 (a fresh Adam moves each DoF by up to the learning rate
1e-4 either way, so a rounding-level gradient may flip one step); the
freeze exactly (one float sum).  Error map: deposits add in no fixed order
on the card (atomics), so within 1e-5 of the map's max; the rebuilt CDF
within 1e-5 (a parallel scan against a sequential one); the sharpness
update and the sampled cells exactly, uv within 1e-7.
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
    keys = torch.zeros(4, dtype=torch.int32, device=cuda)
    payload = torch.zeros((4, 2), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        segment_tile.segment_sum_rows(keys, payload.float(), 3)
    with pytest.raises(ValueError):
        segment_tile.segment_sum_rows(keys.long(), payload, 3)
    with pytest.raises(ValueError):
        segment_tile.segment_sum_rows(keys, torch.zeros((4, 3), dtype=torch.bfloat16, device=cuda), 3)
    with pytest.raises(ValueError):
        segment_tile.segment_sum_rows(keys, payload.t(), 3)
    with pytest.raises(ValueError):  # a key for every update
        segment_tile.segment_sum_rows(keys[:3], payload, 3)
    with pytest.raises(ValueError):
        segment_tile.segment_sum_rows(keys, payload, -1)


_TILE = 2048  # updates per block of the stream body at F=2 (1024 at F=8)
_EDGE_STREAMS = ["one_row_many_tiles", "every_second_row_empty", "inner_keys_only",
                 "pad_and_negative", "ragged_length", "shorter_than_tile", "empty_stream",
                 "unaligned", "heavy_and_light", "gaps_wider_than_a_tile"]


def _edge_stream(case, f, seed):
    """(keys (M,) int32 ascending, values (M, F) fp32, n_rows) of one edge
    case of the stream body."""
    rng = np.random.default_rng(seed)
    n_rows, m = 3000, 20000
    if case == "one_row_many_tiles":
        n_rows, keys = 10, np.full(3 * _TILE + 100, 3)
    elif case == "every_second_row_empty":
        keys = 2 * rng.integers(0, n_rows // 2, m)
    elif case == "inner_keys_only":  # first key > 0, last key < n_rows - 1
        keys = rng.integers(100, n_rows - 100, m)
    elif case == "pad_and_negative":
        keys = np.concatenate([rng.integers(-50, 0, 300), rng.integers(0, n_rows, m),
                               np.full(700, segment_tile.PAD_IDX)])
    elif case == "ragged_length":  # M neither a multiple of 4 nor of the tile
        keys = rng.integers(0, n_rows, 3 * _TILE + 5)
    elif case == "shorter_than_tile":
        n_rows, keys = 50, rng.integers(0, 50, 100)
    elif case == "empty_stream":
        n_rows, keys = 37, np.zeros(0, np.int64)
    elif case == "unaligned":  # the card's copies start 4 (keys) and 2 or 4 bytes off 16
        keys = rng.integers(0, n_rows, 5001)
    elif case == "gaps_wider_than_a_tile":  # three clusters, 20,000 empty rows apart
        n_rows = 50000
        keys = np.concatenate([rng.integers(lo, lo + 100, m // 3) for lo in (0, 20000, 45000)])
    else:  # heavy_and_light: four rows of 3000 updates among uniform ones
        keys = np.concatenate([np.repeat([7, 8, 1500, n_rows - 1], 3000),
                               rng.integers(0, n_rows, m)])
    keys = np.sort(keys).astype(np.int32)
    return keys, rng.normal(size=(keys.shape[0], f)).astype(np.float32), n_rows


def _edge_levels(case, keys, vals, n_rows):
    """Three levels around one edge stream: the case's, one of padding
    only, and one row of three tiles and 100 updates; each padded with
    PAD_IDX, and a payload of 1e30 that would show if it were summed, to
    one Mp that is a multiple of 4 but for "ragged_length" and "unaligned"
    -> (keys (3, Mp) int32, values (3, Mp, F) fp32)."""
    f = vals.shape[1]
    long_row = np.full(3 * _TILE + 100, min(3, n_rows - 1), np.int32)
    streams = [(keys, vals), (keys[:0], vals[:0]),
               (long_row, np.random.default_rng(7).normal(size=(long_row.shape[0], f)))]
    m_pad = -(-max(k.shape[0] for k, _ in streams) // 4) * 4 + 4
    m_pad += case in ("ragged_length", "unaligned")
    out_k = np.full((3, m_pad), segment_tile.PAD_IDX, np.int32)
    out_v = np.full((3, m_pad, f), 1e30, np.float32)
    for lvl, (k, v) in enumerate(streams):
        out_k[lvl, :k.shape[0]], out_v[lvl, :k.shape[0]] = k, v
    return out_k, out_v


@pytest.mark.parametrize("case", _EDGE_STREAMS)
@pytest.mark.parametrize("f", [2, 8])
@pytest.mark.parametrize("kernel", ["rows", "planar", "packed", "batched"])
def test_stream_kernels_on_edge_streams(cuda, kernel, f, case):
    """All four kernels on the body's edge cases: every level within 1e-5
    * max|ref| + 1e-7 of a float64 sum of the same payload (bf16-rounded
    but for kernel 4) over the keys in [0, n_rows), rows without updates
    exactly 0.0, two launches bitwise equal.  Kernels 1 and 4 take the
    case's stream; kernels 2 and 3 take it as level 0 of ``_edge_levels``."""
    keys, vals, n_rows = _edge_stream(case, f, seed=f)
    if kernel in ("packed", "batched"):
        keys, vals = _edge_levels(case, keys, vals, n_rows)
    k = torch.from_numpy(keys)
    v = torch.from_numpy(vals)
    summed = (v if kernel == "planar" else v.to(torch.bfloat16)).double()
    if kernel == "rows":
        payload, wrapper = v.to(torch.bfloat16), segment_tile.segment_sum_rows  # (M, F)
    elif kernel == "planar":
        payload, wrapper = v.t().contiguous(), segment_tile.segment_sum_planar_rows  # (F, M)
    elif kernel == "packed":
        l, m_pad, _ = v.shape
        payload = segment_tile.pack_bf16_pairs(v.reshape(l * m_pad, f))
        payload = payload.reshape(l, m_pad, -1).transpose(1, 2).contiguous()  # (L, P, Mp)
        wrapper = segment_tile.segment_sum_packed_rows
    else:
        payload, wrapper = v.transpose(1, 2).contiguous(), segment_tile.segment_sum_batched_rows
    k_levels, summed = (k[None], summed[None]) if k.dim() == 1 else (k, summed)
    ref = torch.zeros((k_levels.shape[0], n_rows, f), dtype=torch.float64)
    empty = torch.ones((k_levels.shape[0], n_rows), dtype=torch.bool)
    for lvl, (kl, sl) in enumerate(zip(k_levels, summed)):
        keep = (kl >= 0) & (kl < n_rows)
        ref[lvl].index_add_(0, kl[keep].long(), sl[keep])
        empty[lvl, kl[keep].long()] = False
    ref = ref.float()

    def on_card(t):
        if case != "unaligned":
            return t.to(cuda)
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16
        return view

    ck, cp = on_card(k), on_card(payload)
    torch.full((1 << 22,), 7.0, device=cuda)  # non-zero bytes in the allocator's cache
    before = wrapper.launches
    got = wrapper(ck, cp, n_rows)
    again = wrapper(ck, cp, n_rows)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert got.shape == (*k.shape[:-1], n_rows, f) and got.dtype == torch.float32
    assert torch.equal(got, again)
    got = got.cpu().reshape(ref.shape)
    for g, r, e in zip(got, ref, empty):
        assert (g[e] == 0).all()
        assert (g - r).abs().max() <= 1e-5 * r.abs().max() + 1e-7


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
    """Kernels 2, 3 and 4 through their entry points and their wrappers'
    ``(keys_sorted, payload, n_rows)``: bitwise repeatable, within 1e-5 *
    max|ref| + 1e-7 of the plain version on the same inputs, one launch per
    call."""
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
    again = wrapper(idx.to(cuda), payload.to(cuda), n_rows)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert torch.equal(got, again)
    got = got.cpu()
    for g, r in zip(*((got, ref) if got.dim() == 3 else ([got], [ref]))):
        assert (g - r).abs().max() <= 1e-5 * r.abs().max() + 1e-7


def test_planar_entry_drops_wide_indices(cuda):
    """int64 indices outside int32 (and negative ones) reach kernel 4 as
    keys that match no row, as the plain version drops them."""
    n_rows = 1024
    idx = torch.tensor([-(2**40), -1, 0, 0, 7, 1023, 1024, 2**32 + 5, 2**40])
    vals = torch.arange(2.0 * idx.shape[0]).reshape(2, -1)
    ref = segment_tile.sorted_segment_sum_tiles(idx, vals, n_rows)
    got = segment_tile.sorted_segment_sum_tiles(idx.to(cuda), vals.to(cuda), n_rows).cpu()
    assert torch.equal(got, ref)
    assert int((got != 0).any(-1).sum()) == 3


def test_sorted_kernels_write_every_row(cuda):
    """Rows without updates come out exactly 0.0; the padding's keys and
    payload are read, but nothing of them reaches a row."""
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
    keys2 = torch.zeros((2, 8), dtype=torch.int32, device=cuda)  # (L, Mp)
    keys = torch.zeros(8, dtype=torch.int32, device=cuda)
    packed = torch.zeros((2, 1, 8), dtype=torch.int32, device=cuda)
    before = [w.launches for w in segment_tile.KERNELS]
    with pytest.raises(ValueError):  # F = 4 is not built
        segment_tile.segment_sum_batched_rows(keys2, torch.zeros((2, 4, 8), device=cuda), 4)
    with pytest.raises(ValueError):  # packed pairs are int32
        segment_tile.segment_sum_packed_rows(keys2, packed.float(), 4)
    with pytest.raises(ValueError):  # levels disagree
        segment_tile.segment_sum_packed_rows(
            keys2, torch.zeros((3, 1, 8), dtype=torch.int32, device=cuda), 4)
    with pytest.raises(ValueError):  # a key for every update of a level
        segment_tile.segment_sum_batched_rows(keys2, torch.zeros((2, 2, 7), device=cuda), 4)
    with pytest.raises(ValueError):  # keys of the wrong rank: one stream a level
        segment_tile.segment_sum_batched_rows(keys, torch.zeros((2, 2, 8), device=cuda), 4)
    with pytest.raises(ValueError):
        segment_tile.segment_sum_packed_rows(keys2[None], packed, 4)
    with pytest.raises(ValueError):  # keys are one stream
        segment_tile.segment_sum_planar_rows(keys2, torch.zeros((2, 8), device=cuda), 4)
    with pytest.raises(ValueError):  # (F, M), not (M, F)
        segment_tile.segment_sum_planar_rows(keys, torch.zeros((8, 2), device=cuda), 4)
    with pytest.raises(ValueError):  # CPU tensors never reach a kernel
        segment_tile.segment_sum_packed_rows(keys2.cpu(), packed.cpu(), 4)
    assert [w.launches for w in segment_tile.KERNELS] == before


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


def _to(x, device):
    """Every tensor of a state tree (dicts, lists, named tuples) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, device) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def _state_to(state, device):
    return _to(state, device)._replace(generator=torch.Generator(device=device).manual_seed(0))


def test_train_step_on_card_matches_cpu(cuda):
    cfg = _small_config()
    images, cams = make_sphere_dataset(n_views=4, resolution=32, seed=0).to_device("cpu")
    state = tt.init_train_state(cfg, 4, seed=0, device="cpu")
    state = tt.occupancy_prior_sweep(state, cfg)
    draws = tt.sample_step_draws(torch.Generator().manual_seed(5), cfg, 4)

    cpu_grads, cpu_aux, _ = tt.loss_and_grads({"params": state.params}, state, images, cams,
                                               draws, cfg)
    cstate = _state_to(state, cuda)
    c_images, c_cams = make_sphere_dataset(n_views=4, resolution=32, seed=0).to_device(cuda)
    c_draws = draws.to(cuda)
    before = segment_tile.segment_sum_rows.launches
    gpu_grads, gpu_aux, _ = tt.loss_and_grads({"params": cstate.params}, cstate, c_images,
                                              c_cams, c_draws, cfg)
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


def _dynamic_setup(cuda, **kw):
    """A CPU state and its copy on the card, for a frame >= 1: a folded
    transform and a live delta."""
    cfg = dataclasses.replace(_small_config(), delta_n_rays=32, use_error_map=True, **kw)
    images, cams = make_sphere_dataset(n_views=4, resolution=32, seed=0).to_device("cpu")
    state = tt.init_train_state(cfg, 4, seed=0, device="cpu")
    state = tt.occupancy_prior_sweep(state, cfg)
    c, s_ = float(np.cos(0.03)), float(np.sin(0.03))
    state = state._replace(
        acc={"rotation": torch.tensor([[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]]),
             "transition": torch.tensor([0.01, -0.02, 0.0])},
        delta={"rotation6d": torch.tensor([1.0, 0.02, 0.0, -0.02, 1.0, 0.01]),
               "transition": torch.tensor([-0.015, 0.005, 0.01])})
    c_images, c_cams = make_sphere_dataset(n_views=4, resolution=32, seed=0).to_device(cuda)
    return cfg, (images, cams), (c_images, c_cams), state, _state_to(state, cuda)


@pytest.mark.parametrize("phase", ["refine", "finetune"])
def test_dynamic_step_on_card_matches_cpu(cuda, phase):
    cfg, (images, cams), (c_images, c_cams), state, cstate = _dynamic_setup(cuda)
    if phase == "refine":
        flags = dict(train_canonical=False, train_delta=True, use_delta=True)
        cfg = dataclasses.replace(cfg, n_rays=cfg.delta_n_rays, hit_oversample=1)
    else:
        flags = dict(train_canonical=True, train_delta=True, use_delta=True)
    step_cfg = tt.phase_config(cfg, flags["train_canonical"], flags["train_delta"])
    assert step_cfg.use_error_map == (phase == "finetune")
    draws = tt.sample_step_draws(torch.Generator().manual_seed(5), step_cfg, 4)
    diff = {"delta": state.delta} if phase == "refine" else {"params": state.params,
                                                             "delta": state.delta}
    cpu_g, _, _ = tt.loss_and_grads(diff, state, images, cams, draws, step_cfg, True)
    cpu_new, cpu_aux = tt.train_step(state, images, cams, cfg, draws=draws, **flags)

    before = segment_tile.segment_sum_rows.launches
    c_diff = {k: getattr(cstate, "params" if k == "params" else "delta") for k in diff}
    gpu_g, _, _ = tt.loss_and_grads(c_diff, cstate, c_images, c_cams, draws.to(cuda),
                                    step_cfg, True)
    gpu_new, gpu_aux = tt.train_step(cstate, c_images, c_cams, cfg, draws=draws.to(cuda),
                                     **flags)
    torch.cuda.synchronize()
    # Kernel 1 runs for every step that trains the field, never in refinement.
    assert segment_tile.segment_sum_rows.launches == before + (0 if phase == "refine" else 2)

    for name in tt.StepAux._fields:
        np.testing.assert_allclose(float(getattr(gpu_aux, name)), float(getattr(cpu_aux, name)),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    for g, c in zip(tree_leaves(gpu_g["delta"]), tree_leaves(cpu_g["delta"])):
        assert float((g.cpu() - c).abs().max()) <= 1e-3 * float(c.abs().max())
    for g, c in zip(tree_leaves(gpu_new.delta), tree_leaves(cpu_new.delta)):
        assert float((g.cpu() - c).abs().max()) <= 2e-4
    assert not torch.equal(gpu_new.delta["transition"].cpu(), state.delta["transition"])
    if phase == "refine":
        for g, c in zip(tree_leaves(gpu_new.params), tree_leaves(state.params)):
            assert torch.equal(g.cpu(), c)  # the field does not train
        assert not gpu_new.error_map.error_map.any()  # and the error map is off
        return
    n_tables = cfg.field.grid.n_levels
    for i, (g, c) in enumerate(zip(tree_leaves(gpu_g["params"]), tree_leaves(cpu_g["params"]))):
        limit = 1e-2 if i < n_tables else 1e-3
        assert float((g.cpu() - c).abs().max()) <= limit * max(float(c.abs().max()), 1e-12), i
    ref = cpu_new.error_map.error_map
    assert ref.any()
    assert float((gpu_new.error_map.error_map.cpu() - ref).abs().max()) <= 1e-5 * float(ref.max())


def test_residual_grid_freeze_on_card(cuda):
    cfg, (images, cams), (c_images, c_cams), state, _ = _dynamic_setup(cuda)
    field = dataclasses.replace(cfg.field, residual_grid=True)
    cfg = dataclasses.replace(cfg, field=field, use_error_map=False)
    from neus2_tpu_torch.models.field import freeze_grid_into_base, init_field, sdf_fn

    params = init_field(torch.Generator().manual_seed(1), field, "cpu")
    rng = np.random.default_rng(1)
    params["hashgrid"] = [torch.from_numpy(rng.normal(0, 0.05, t.shape).astype(np.float32))
                          for t in params["hashgrid"]]
    params["hashgrid_base"] = [torch.from_numpy(rng.normal(0, 0.05, t.shape).astype(np.float32))
                               for t in params["hashgrid"]]
    frozen = freeze_grid_into_base(params)
    c_frozen = freeze_grid_into_base(_to(params, cuda))
    for a, b in zip(tree_leaves(c_frozen), tree_leaves(frozen)):
        assert torch.equal(a.cpu(), b)
    x = torch.from_numpy(rng.uniform(0.1, 0.9, (256, 3)).astype(np.float32))
    before, _ = sdf_fn(_to(params, cuda), x.to(cuda), field)
    after, _ = sdf_fn(c_frozen, x.to(cuda), field)
    cpu_after, _ = sdf_fn(frozen, x, field)
    np.testing.assert_allclose(after.cpu().numpy(), before.cpu().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(after.cpu().numpy(), cpu_after.numpy(), rtol=1e-4, atol=1e-6)

    # One canonical step on the frozen field: one kernel launch, base untouched.
    cstate = _state_to(state._replace(params=frozen, ema_params=tree_map(torch.clone, frozen),
                                      opt_state=tt.adam_init(frozen)), cuda)
    n = segment_tile.segment_sum_rows.launches
    new, aux = tt.train_step(cstate, c_images, c_cams, cfg)
    torch.cuda.synchronize()
    assert segment_tile.segment_sum_rows.launches == n + 1 and torch.isfinite(aux.loss)
    for a, b in zip(new.params["hashgrid_base"], frozen["hashgrid_base"]):
        assert torch.equal(a.cpu(), b)
    assert any(t.any() for t in new.params["hashgrid"])


def test_error_map_on_card_matches_cpu(cuda):
    from neus2_tpu_torch.engine import error_map as em

    rng = np.random.default_rng(2)
    n_img, res, n = 3, 48, 1 << 16
    state = em.init_error_map(n_img, res, sharpness_cells=4096)
    img = torch.from_numpy(rng.integers(0, n_img, n))
    uv = torch.from_numpy(rng.uniform(0, 1, (n, 2)).astype(np.float32))
    loss = torch.from_numpy(rng.gamma(0.5, 1.0, n).astype(np.float32))
    cpu = em.deposit(state, img, uv, loss)
    gpu = em.deposit(_to(state, cuda), img.to(cuda), uv.to(cuda), loss.to(cuda))
    ref = cpu.error_map
    assert float((gpu.error_map.cpu() - ref).abs().max()) <= 1e-5 * float(ref.max())

    cpu_r, gpu_r = em.rebuild_cdf(cpu), em.rebuild_cdf(gpu)
    assert float((gpu_r.cdf.cpu() - cpu_r.cdf).abs().max()) <= 1e-5
    assert not gpu_r.error_map.any() and gpu_r.sharpness_grid is not None

    u = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    jitter = torch.from_numpy(rng.uniform(0, 1, (n, 2)).astype(np.float32))
    c_img, c_uv = em.sample_pixels(cpu_r, u, jitter, n_img)
    g_img, g_uv = em.sample_pixels(cpu_r._replace(cdf=cpu_r.cdf.to(cuda)), u.to(cuda),
                                   jitter.to(cuda), n_img)
    assert torch.equal(g_img.cpu(), c_img)
    assert float((g_uv.cpu() - c_uv).abs().max()) <= 1e-7

    grid = torch.from_numpy(rng.uniform(0, 2, 4096).astype(np.float32))
    cells = torch.from_numpy(rng.integers(0, 512, 3000))
    sharp = torch.from_numpy(rng.uniform(0, 3, 3000).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=3000) < 0.7)
    cw, cg = em.sharpness_weight_and_update(grid, cells, sharp, valid)
    gw, gg = em.sharpness_weight_and_update(grid.to(cuda), cells.to(cuda), sharp.to(cuda),
                                            valid.to(cuda))
    assert torch.equal(gw.cpu(), cw) and torch.equal(gg.cpu(), cg)


def test_error_map_deposit_is_deterministic_on_card(cuda):
    """The same deposit twice on the card: ``index_put_(accumulate=True)``
    sums each cell's adds in a fixed order, or the two maps differ."""
    from neus2_tpu_torch.engine import error_map as em

    rng = np.random.default_rng(3)
    n_img, n = 16, 1 << 17  # base.json's 2 x 4096 candidates x 16, into 16 maps
    res = em.resolution_for(4096, n_img, 256)
    state = _to(em.init_error_map(n_img, res), cuda)
    img = torch.from_numpy(rng.integers(0, n_img, n)).to(cuda)
    uv = torch.from_numpy(rng.uniform(0, 1, (n, 2)).astype(np.float32)).to(cuda)
    loss = torch.from_numpy(rng.gamma(0.5, 1.0, n).astype(np.float32)).to(cuda)
    first = em.deposit(state, img, uv, loss).error_map
    for _ in range(3):
        assert torch.equal(em.deposit(state, img, uv, loss).error_map, first)


def test_native_snapshot_roundtrip_on_card(cuda, tmp_path):
    """A card Testbed saved and loaded into a fresh one: every leaf and the
    step generator's state bitwise, and both train on to the same bits."""
    from neus2_tpu_torch import interop
    from neus2_tpu_torch.api.testbed import Hyperparams, Testbed

    def fresh():
        tb = Testbed(dataclasses.replace(_small_config(), adaptive_batch=False),
                     Hyperparams(first_frame_max_training_step=8), device=cuda)
        tb.load_training_data_from_datasets([make_sphere_dataset(n_views=4, resolution=32)])
        return tb

    a = fresh()
    for _ in range(4):
        a.train()
    a.save_snapshot(tmp_path / "a.msgpack")
    a.save_snapshot(tmp_path / "a_inc.msgpack", incremental=True)
    b = fresh()
    b.load_snapshot(tmp_path / "a.msgpack")
    saved, got = interop.state_to_pathdict(a.state), interop.state_to_pathdict(b.state)
    assert saved.keys() == got.keys() and saved[".generator"].size == 16  # Philox seed + offset
    for k in saved:
        assert got[k].dtype == saved[k].dtype and np.array_equal(got[k], saved[k]), k
    assert b.training_step == a.training_step == 4
    assert all(t.device.type == "cuda" for t in tree_leaves(b.state.params))
    for tb in (a, b):
        while tb.frame():
            pass
    want, got = interop.state_to_pathdict(a.state), interop.state_to_pathdict(b.state)
    for k in want:
        assert np.array_equal(got[k], want[k]), k

    c = fresh()
    c.load_snapshot(tmp_path / "a_inc.msgpack")  # the optimizers stay fresh
    got = interop.state_to_pathdict(c.state)
    assert c.state.opt_state["count"] == 0 and c.training_step == 4
    for k in saved:
        if not k.startswith((".opt_state", ".delta_opt_state")):
            assert np.array_equal(got[k], saved[k]), k


_CAMERA_KNOBS = dict(optimize_extrinsics=True, optimize_exposure=True,
                     optimize_focal_length=True, max_level_rand_training=True, use_envmap=True,
                     envmap_res=(8, 16), use_distortion=True, distortion_res=(8, 8),
                     depth_supervision_lambda=0.5)


def test_camera_step_on_card_matches_cpu(cuda):
    """One step with the whole camera group on: the loss, the camera
    group's gradients (within 1e-3 of each leaf's max: sums over samples
    in another order) and its first Adam step (within 2.5e-4: a fresh Adam
    moves each element by up to cam_lr 1e-4 either way, so a rounding-level
    gradient may flip one) agree with the CPU; kernel 1 runs for the step."""
    cfg = dataclasses.replace(_small_config(), **_CAMERA_KNOBS)
    images, cams = make_sphere_dataset(n_views=4, resolution=32, seed=0).to_device("cpu")
    state = tt.init_train_state(cfg, 4, seed=0, device="cpu")
    state = tt.occupancy_prior_sweep(state, cfg)
    g = torch.Generator().manual_seed(3)
    cam = {k: v + 0.01 * torch.randn(v.shape, generator=g) for k, v in state.cam.items()}
    cam["envmap"] = state.cam["envmap"] + 0.3 * torch.rand(state.cam["envmap"].shape, generator=g)
    state = state._replace(cam=cam)
    depths = torch.rand((4, 32, 32), generator=g) * 0.5 + 0.5
    draws = tt.sample_step_draws(torch.Generator().manual_seed(5), cfg, 4)
    assert draws.max_level_u is not None
    diff = {"params": state.params, "cam": state.cam}
    cpu_g, cpu_aux, _ = tt.loss_and_grads(diff, state, images, cams, draws, cfg, depths=depths)
    cpu_new, _ = tt.train_step(state, images, cams, cfg, draws=draws, depths=depths)

    cstate = _state_to(state, cuda)
    c_images, c_cams = make_sphere_dataset(n_views=4, resolution=32, seed=0).to_device(cuda)
    before = segment_tile.segment_sum_rows.launches
    gpu_g, gpu_aux, _ = tt.loss_and_grads({"params": cstate.params, "cam": cstate.cam}, cstate,
                                          c_images, c_cams, draws.to(cuda), cfg,
                                          depths=depths.to(cuda))
    gpu_new, _ = tt.train_step(cstate, c_images, c_cams, cfg, draws=draws.to(cuda),
                               depths=depths.to(cuda))
    torch.cuda.synchronize()
    assert segment_tile.segment_sum_rows.launches == before + 2
    np.testing.assert_allclose(float(gpu_aux.loss), float(cpu_aux.loss), rtol=1e-4)
    for k in sorted(state.cam):
        c, gg = cpu_g["cam"][k], gpu_g["cam"][k].cpu()
        assert float(c.abs().max()) > 0, k
        assert float((gg - c).abs().max()) <= 1e-3 * float(c.abs().max()), k
        assert float((gpu_new.cam[k].cpu() - cpu_new.cam[k]).abs().max()) <= 2.5e-4, k
    assert gpu_new.cam_opt_state["count"] == cpu_new.cam_opt_state["count"] == 1


def test_render_image_with_extras_on_card_matches_cpu(cuda):
    """``render_image`` with a learned envmap and distortion grid, exposure
    and the ACES curve: the card's image, depth and opacity within 3e-4 of
    the CPU's (the geometric-init field, whose hash tables are near zero,
    so no sample sits at a jump of the interpolant's gradient)."""
    from neus2_tpu_torch.engine import occupancy as occ
    from neus2_tpu_torch.engine.render import RenderConfig, render_image
    from neus2_tpu_torch.models.field import init_field

    cfg = _small_config()
    params = init_field(torch.Generator().manual_seed(0), cfg.field)
    grid = occ.init_occupancy(1)
    c = (torch.arange(128) + 0.5) / 128 - 0.5
    ball = (c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2) < 0.3 ** 2
    dens = torch.where(ball, 0.1, 0.0)[None]
    grid = grid._replace(density=dens, bitfield=dens > 0.05)
    g = torch.Generator().manual_seed(1)
    env = torch.rand((8, 16, 4), generator=g) * 0.6
    dist = torch.randn((8, 8, 2), generator=g) * 0.01
    cams = make_sphere_dataset(n_views=2, resolution=24, seed=3).cameras()
    rcfg = RenderConfig(field=cfg.field, samples_per_ray=256, n_candidates=128)

    def run(device):
        p, o = _to(params, device), _to(grid, device)
        cm = _to(cams, device)
        return [t.cpu() for t in render_image(
            p, None, o, cm, cm.poses[0], cm.focal[0], cm.principal[0], None, rcfg,
            background=0.2, spp=1, envmap=env.to(device), distortion=dist.to(device),
            exposure=0.5, tonemap="aces")]

    for a, b in zip(run(cuda), run("cpu")):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 3e-4


def _lens_cameras(model: str):
    """3 views at 40 x 30 (max) with ``model``'s lens fields (the camera
    models of tests/test_torch_loader_extras.py, made here without JAX)."""
    from neus2_tpu_torch.engine import rays

    g = torch.Generator().manual_seed(1)
    poses = torch.eye(4)[:3].repeat(3, 1, 1)
    poses[:, :, :3] += 0.05 * torch.randn((3, 3, 3), generator=g)
    poses[:, :, 3] = torch.rand((3, 3), generator=g) * 0.4 - 0.2
    kw = {}
    if model == "brown_conrady":
        kw["distortion"] = torch.tensor([-0.12, 0.03, 0.004, -0.002])
    elif model == "ftheta":
        kw["ftheta"] = torch.tensor([0.0, 5e-3, 0, 0, 0, 800.0, 600.0])
    elif model == "rolling_shutter":
        kw.update(poses_end=poses + 0.1 * torch.randn((3, 3, 4), generator=g),
                  rolling_shutter=torch.tensor([0.1, 0.2, 0.5, 0.0]))
    elif model == "mixed_sizes":
        kw.update(image_sizes=torch.tensor([[40, 30], [24, 30], [40, 12]], dtype=torch.int32),
                  distortion=torch.tensor([-0.12, 0.03, 0.004, -0.002]))
    elif model == "rays":
        d = torch.randn((3, 30, 40, 3), generator=g)
        kw["rays"] = torch.cat([torch.rand((3, 30, 40, 3), generator=g), d], -1)
    return rays.Cameras(poses=poses, focal=torch.rand((3, 2), generator=g) * 20 + 30,
                        principal=torch.rand((3, 2), generator=g) * 0.2 + 0.4,
                        resolution=(40, 30), **kw)


@pytest.mark.parametrize("model", ["pinhole", "brown_conrady", "ftheta", "rolling_shutter",
                                   "mixed_sizes", "rays"])
def test_lens_rays_on_card_match_cpu(cuda, model):
    """pixel_to_ray and rays_from_pixels of every camera model on the card
    against the CPU: rays within 1e-5 (the card's sin, cos, sqrt and
    division round differently), the FTheta sentinel on the same pixels,
    the texels bitwise, from fp32 and from fp16 storage."""
    from neus2_tpu_torch.engine import rays

    cams = _lens_cameras(model)
    g = torch.Generator().manual_seed(2)
    idx = torch.randint(0, 3, (4096,), generator=g)
    uv = torch.rand((4096, 2), generator=g)
    images = torch.rand((3, 30, 40, 4), generator=g)
    c_cams = _to(cams, cuda)
    for a, b in zip(rays.pixel_to_ray(c_cams, idx.to(cuda), uv.to(cuda)),
                    rays.pixel_to_ray(cams, idx, uv)):
        assert torch.isfinite(a).all() and float((a.cpu() - b).abs().max()) <= 1e-5
    for dtype in (torch.float32, torch.float16):
        im = images.to(dtype)
        got = rays.rays_from_pixels(c_cams, im.to(cuda), idx.to(cuda), uv.to(cuda))
        ref = rays.rays_from_pixels(cams, im, idx, uv)
        assert got[2].dtype == torch.float32 and torch.equal(got[2].cpu(), ref[2])
        assert torch.equal(got[3].cpu(), ref[3])
        for a, b in zip(got[:2], ref[:2]):
            assert float((a.cpu() - b).abs().max()) <= 1e-5


def test_bf16_encoder_and_mlp_on_card_match_cpu(cuda):
    """bf16 compute on the card against the CPU's bf16 path on the same
    inputs: the encoder's table and position gradients (kernel 1 on the
    card) within 1e-2 of their max (a bf16 rounding that the card's
    summation order flips), ``apply_mlp``'s output within 1e-4 of its max
    and its gradients within 1e-2."""
    from neus2_tpu_torch.models.mlp import apply_mlp, init_mlp
    from neus2_tpu_torch.ops.hashgrid import HashGridConfig
    from neus2_tpu_torch.ops.hashgrid_fast import init_hashgrid_tables, make_encode_jac

    grid = HashGridConfig(n_levels=6, log2_hashmap_size=14, per_level_scale=1.5)
    g = torch.Generator().manual_seed(0)
    tables = [t * 1e4 for t in init_hashgrid_tables(g, grid)]
    x = torch.rand((8192, 3), generator=g)
    mlp = init_mlp(g, 19, 64, 2, 16)
    h = torch.randn((8192, 19), generator=g)
    coef = torch.randn((8192, 16), generator=g)

    def run(device):
        tb = [t.to(device).requires_grad_(True) for t in tables]
        xx = x.to(device).requires_grad_(True)
        feat, jac = make_encode_jac(grid, torch.bfloat16)(tb, xx)
        enc = torch.autograd.grad((feat**2).sum() + (jac**2).sum(), [*tb, xx])
        p = _to(mlp, device)
        leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
        hh = h.to(device).requires_grad_(True)
        out = apply_mlp(p, hh, torch.bfloat16)
        grads = torch.autograd.grad((out * coef.to(device)).sum(), [*leaves, hh])
        return [t.detach().cpu() for t in enc], out.detach().cpu(), [t.cpu() for t in grads]

    before = segment_tile.segment_sum_rows.launches
    card, cpu = run(cuda), run("cpu")
    assert segment_tile.segment_sum_rows.launches == before + 1
    for a, b in zip(card[0] + card[2], cpu[0] + cpu[2]):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-2 * float(b.abs().max())
    assert float((card[1] - cpu[1]).abs().max()) <= 1e-4 * float(cpu[1].abs().max())


def _sdf_inputs():
    """A 6-level SDF fit config, its CPU params (tables scaled so the grid
    matters), a cube-ish pool and one batch of indices."""
    from neus2_tpu_torch.engine import sdf_mode
    from neus2_tpu_torch.models.field import FieldConfig
    from neus2_tpu_torch.ops.hashgrid import HashGridConfig

    cfg = sdf_mode.SdfFitConfig(
        field=FieldConfig(grid=HashGridConfig(n_levels=6, log2_hashmap_size=14,
                                              per_level_scale=1.5), sdf_n_hidden=2),
        batch_size=8192)
    params, opt = sdf_mode.init_sdf_fit(cfg, seed=0, device="cpu")
    params["hashgrid"] = [t * 1e3 for t in params["hashgrid"]]
    g = torch.Generator().manual_seed(1)
    pts = torch.rand((1 << 15, 3), generator=g)
    dist = (pts - 0.5).abs().amax(-1) - 0.2
    idx = torch.randint(0, pts.shape[0], (cfg.batch_size,), generator=g)
    return sdf_mode, cfg, params, opt, pts, dist, idx


def test_sdf_fit_step_on_card_matches_cpu(cuda):
    """One SDF-mode step's loss and gradients on the card (kernel 1 once)
    against the CPU on the same params and indices: the loss rtol 1e-4,
    table gradients within 1e-2 of their max (bf16-quantized sums on the
    card, as in test_train_step_on_card_matches_cpu), MLP gradients within
    1e-3; the step's new params finite."""
    sdf_mode, cfg, params, opt, pts, dist, idx = _sdf_inputs()

    def grads(device):
        p = _to(params, device)
        x, d = pts.to(device)[idx.to(device)], dist.to(device)[idx.to(device)]
        return sdf_mode.value_and_grads(
            lambda q: sdf_mode.fit_loss(sdf_mode.sdf_fn(q, x, cfg.field)[0], d, cfg.loss), p)

    before = segment_tile.segment_sum_rows.launches
    card_loss, card = grads(cuda)
    torch.cuda.synchronize()
    assert segment_tile.segment_sum_rows.launches == before + 1
    cpu_loss, cpu = grads("cpu")
    np.testing.assert_allclose(float(card_loss), float(cpu_loss), rtol=1e-4)
    n_tables = cfg.field.grid.n_levels
    for i, (g, c) in enumerate(zip(tree_leaves(card), tree_leaves(cpu))):
        g = g.cpu()
        assert g.shape == c.shape and torch.isfinite(g).all()
        limit = 1e-2 if i < n_tables else 1e-3
        assert float((g - c).abs().max()) <= limit * max(float(c.abs().max()), 1e-12), i
    new, _, loss = sdf_mode.sdf_fit_step(_to(params, cuda), _to(opt, cuda), pts.to(cuda),
                                         dist.to(cuda), cfg, idx=idx.to(cuda))
    assert all(torch.isfinite(t).all() for t in tree_leaves(new)) and float(loss) > 0


def _image_inputs():
    from neus2_tpu_torch.engine import image_mode

    cfg = image_mode.Image2DConfig(n_levels=8, log2_hashmap_size=14, batch_size=1 << 14)
    params = image_mode.init_image_params(torch.Generator().manual_seed(0), cfg)
    params["tables"] = [t * 1e3 for t in params["tables"]]
    g = torch.Generator().manual_seed(2)
    y, x = torch.meshgrid(torch.linspace(0, 1, 64), torch.linspace(0, 1, 64), indexing="ij")
    img = torch.stack([x, y, (x * y).sqrt()], -1)
    pos = torch.rand((cfg.batch_size, 2), generator=g)
    return image_mode, cfg, params, img, pos


def test_image_fit_step_on_card_matches_cpu(cuda):
    """One image-mode step's table gradients on the card (kernel 4 once a
    level, dense and hashed levels) against the CPU's ``index_add_`` within
    1e-5 * max|ref| + 1e-7 (both exact fp32 sums, in other orders), MLP
    gradients within 1e-4 of their max, two runs bitwise equal."""
    image_mode, cfg, params, img, pos = _image_inputs()
    tabs = cfg.level_tables()
    assert any(r * r <= n for r, n in tabs) and any(r * r > n for r, n in tabs)

    def grads(device):
        p = _to(params, device)
        x, im = pos.to(device), img.to(device)
        return image_mode.value_and_grads(
            lambda q: image_mode.fit_loss(image_mode.image_forward(q, x, cfg),
                                          image_mode._bilinear_fetch(im, x), "relative_l2"), p)

    before = segment_tile.segment_sum_planar_rows.launches
    (loss1, card), (_, again) = grads(cuda), grads(cuda)
    torch.cuda.synchronize()
    assert segment_tile.segment_sum_planar_rows.launches == before + 2 * cfg.n_levels
    cpu_loss, cpu = grads("cpu")
    np.testing.assert_allclose(float(loss1), float(cpu_loss), rtol=1e-5)
    for lvl, (g, a, c) in enumerate(zip(card["tables"], again["tables"], cpu["tables"])):
        assert torch.equal(g, a), lvl
        assert float((g.cpu() - c).abs().max()) <= 1e-5 * float(c.abs().max()) + 1e-7, lvl
    for g, c in zip(tree_leaves(card["mlp"]), tree_leaves(cpu["mlp"])):
        assert float((g.cpu() - c).abs().max()) <= 1e-4 * max(float(c.abs().max()), 1e-12)


def test_image_table_grad_kernel_matches_plain_version(cuda):
    """``level_table_grad`` on the card (sort + kernel 4) against kernel 4's
    plain version on the same sorted stream, on a dense and a hashed level's
    shapes (4 x 2^16 updates), within 1e-5 * max|ref| + 1e-7."""
    from neus2_tpu_torch.engine.image_mode import level_table_grad

    g = torch.Generator(device=cuda).manual_seed(3)
    for rows, hi in ((7232, 7225), (1 << 18, 1 << 18)):
        idx = torch.randint(0, hi, (4 << 16,), generator=g, device=cuda)
        upd = torch.randn((4 << 16, 2), generator=g, device=cuda)
        got = level_table_grad(idx, upd, rows)
        idx_s, order = torch.sort(idx, stable=True)
        ref = segment_tile.sorted_segment_sum_tiles_ref(idx_s.cpu(), upd[order].t().cpu(), rows)
        assert got.shape == (rows, 2)
        assert float((got.cpu() - ref).abs().max()) <= 1e-5 * float(ref.abs().max()) + 1e-7


def _one_rank_parallel_steps(ctx, steps: int) -> dict:
    """In a one-rank NCCL world: ``steps`` of ``train_step``, of
    ``parallel_train_step`` and of its ZeRO-1 form from equal states, with
    the error map and hit compaction on -> whether each pair is bitwise."""
    from neus2_tpu_torch.parallel import train as pt

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(_small_config(), use_error_map=True)
    images, cams = make_sphere_dataset(n_views=4, resolution=32, seed=0).to_device(ctx.device)

    def start():
        state = tt.init_train_state(cfg, 4, seed=0, device=ctx.device)
        return tt.occupancy_prior_sweep(state, cfg)

    single, rep, z1 = start(), pt.replicate_state(start(), ctx), pt.shard_state_zero1(start(), ctx)
    for _ in range(steps):
        single, _ = tt.train_step(single, images, cams, cfg)
        rep, _ = pt.parallel_train_step(rep, images, cams, cfg, ctx)
        z1, _ = pt.parallel_train_step(z1, images, cams, cfg, ctx, zero1=True)
    z1 = z1._replace(opt_state=pt.gather_opt_state(z1.opt_state, z1.params, ctx))

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(
            tree_leaves([a.params, a.ema_params, a.opt_state, list(a.error_map)]),
            tree_leaves([b.params, b.ema_params, b.opt_state, list(b.error_map)]))
            if torch.is_tensor(x))

    return {"parallel_is_train_step": same(single, rep), "zero1_is_replicated": same(rep, z1),
            "backend": torch.distributed.get_backend()}


def test_parallel_step_in_a_one_rank_nccl_world_is_bitwise(cuda):
    """A world of one through NCCL: the data-parallel step is ``train_step``
    bit for bit (the rank's slice of the global draws is the whole batch,
    a sum over one rank is the identity), and so is ZeRO-1."""
    from neus2_tpu_torch.parallel import distributed

    out = distributed.launch(_one_rank_parallel_steps, 1, 3, device="cuda")[0]
    assert out == {"parallel_is_train_step": True, "zero1_is_replicated": True,
                   "backend": "nccl"}


def test_hashgrid_encode_on_card_matches_cpu(cuda):
    """The plain encoding on the card (its table gradient through the sort
    and kernel 4) against the CPU (``index_add_``): features and position
    gradients to fp32 rounding, the table gradient within 1e-5 of its max
    (exact fp32 sums in another order)."""
    from neus2_tpu_torch.ops import hashgrid

    cfg = _small_config().field.grid
    g = torch.Generator().manual_seed(0)
    table = hashgrid.init_hashgrid(g, cfg) * 1e3
    pos = torch.rand((4096, 3), generator=g)
    ct = torch.randn((4096, cfg.n_levels * cfg.n_features_per_level), generator=g)
    out = {}
    for dev in ("cpu", cuda):
        t = table.to(dev, copy=True).requires_grad_(True)
        p = pos.to(dev, copy=True).requires_grad_(True)
        feat = hashgrid.hashgrid_encode(t, p, cfg)
        (feat * ct.to(dev)).sum().backward()
        out[str(dev)] = [x.detach().cpu() for x in (feat, t.grad, p.grad)]
    (f0, t0, p0), (f1, t1, p1) = out["cpu"], out["cuda"]
    torch.testing.assert_close(f1, f0, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(p1, p0, rtol=1e-4, atol=1e-4 * float(p0.abs().max()))
    assert float((t1 - t0).abs().max()) <= 1e-5 * float(t0.abs().max())
