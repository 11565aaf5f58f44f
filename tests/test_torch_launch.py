"""``parallel/distributed.launch`` and the Testbed's replicated error-map
CDF, on two gloo ranks.

A rank that fails while its peer waits in a collective ends the world at
once, and ``launch`` raises with that rank's own error.  The error map's
CDF, which every rank rebuilds with ``torch.cumsum`` (no fixed summation
order on the card), is rank 0's on every rank after the rebuild; the CPU
sums in order, so the test gives each rank a CDF that differs in its last
bits, as ranks on the card may.
"""

import time

import pytest
import torch
import torch.distributed as dist

from neus2_tpu_torch.api import testbed as testbed_mod
from neus2_tpu_torch.api.testbed import Hyperparams, Testbed
from neus2_tpu_torch.data.synthetic import make_sphere_dataset
from neus2_tpu_torch.engine import error_map as emap
from neus2_tpu_torch.engine.train import TrainConfig
from neus2_tpu_torch.models.field import FieldConfig
from neus2_tpu_torch.ops.hashgrid import HashGridConfig
from neus2_tpu_torch.parallel import distributed
from neus2_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)


def _fail_on_rank_1(ctx):
    if ctx.rank == 1:
        raise ValueError("rank 1 stops before the barrier")
    dist.barrier()


def test_failed_rank_ends_launch_with_its_error(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 stops before the barrier"):
        distributed.launch(_fail_on_rank_1, 2, device="cpu")
    assert time.monotonic() - t0 < distributed.TIMEOUT.total_seconds()


def _rebuild_then_step(ctx):
    """One Testbed step that rebuilds the CDF, each rank's rebuild nudged
    by its rank -> the CDF and the whole state as every rank holds them."""
    rebuild = testbed_mod.rebuild_error_cdf

    def nudged(state):
        state = rebuild(state)
        if ctx.rank:  # one ulp up
            cdf = state.error_map.cdf
            cdf.copy_(torch.nextafter(cdf, torch.full_like(cdf, 2.0)))
        return state

    testbed_mod.rebuild_error_cdf = nudged
    grid = HashGridConfig(n_levels=2, log2_hashmap_size=10, per_level_scale=1.45)
    cfg = TrainConfig(field=FieldConfig(grid=grid, sdf_hidden_dim=16, rgb_hidden_dim=16),
                      n_rays=64, samples_per_ray=8, n_candidates=24, occ_n_probe=1 << 10,
                      use_error_map=True)
    tb = Testbed(cfg, Hyperparams(first_frame_max_training_step=200), device="cpu")
    tb.enable_multichip(world=ctx.world)
    tb.load_training_data_from_datasets([make_sphere_dataset(n_views=4, resolution=16)])
    tb.training_step = 128
    assert emap.should_rebuild(tb.training_step)
    tb.frame()
    state = tb.state
    return [t.clone() for t in tree_leaves([state.params, state.ema_params, state.opt_state,
                                            list(state.error_map), list(state.occupancy)])
            if torch.is_tensor(t)]


def test_testbed_holds_rank_0s_error_cdf(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ranks = distributed.launch(_rebuild_then_step, 2, device="cpu")
    assert len(ranks[0]) == len(ranks[1])
    for a, b in zip(*ranks, strict=True):
        assert torch.equal(a, b)
