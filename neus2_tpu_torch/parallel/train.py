"""Data-parallel training, one rank a card (port of
``neus2_tpu/parallel/train.py``).

The JAX package runs the step under ``shard_map`` over a device mesh; here
every rank is a process with the whole state (``replicate_state``) and a
``ParallelContext`` stands in for the mesh:

  * every rank draws its own rays: one global batch of ``config.n_rays *
    world`` rays is drawn from the replicated generator, and a rank takes
    its slice (``sample_rank_draws``), so the generator advances alike on
    every rank and a world of one draws what ``train_step`` draws;
  * each rank runs ``loss_and_grads`` (kernel 1 once a step);
  * gradients and the step's scalars are summed over the ranks and divided
    by the world size (the JAX package's ``pmean``); the sharpness grid is
    combined by MAX; the error map's per-ray deposits are gathered in rank
    order (the ``P("data")`` out-spec) and deposited on every rank; the
    CDF each rank rebuilds from that map is rank 0's
    (``replicate_error_cdf``), since its prefix sum has no fixed order on
    the card;
  * the update after the gradients is ``train_step``'s own
    (``engine/train.py::apply_grads``), the same on every rank, so the
    replicas stay bitwise equal.

ZeRO-1 (``zero1``, canonical phases): the gradients of the hash tables
whose rows divide by the world size are reduce-scattered, each rank keeps
the tcnn Adam state of its row shard only and updates those rows, and the
new rows are all-gathered; the other leaves take the replicated path.
``config.n_rays`` is the per-rank ray count, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from neus2_tpu_torch.engine.rays import Cameras
from neus2_tpu_torch.engine.train import (
    StepAux,
    StepDraws,
    StepExtras,
    TrainConfig,
    TrainState,
    apply_grads,
    field_adam,
    loss_and_grads,
    phase_config,
    sample_step_draws,
    step_diff,
)
from neus2_tpu_torch.parallel.distributed import ParallelContext
from neus2_tpu_torch.utils.optim import adam_update
from neus2_tpu_torch.utils.tree import (
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
    tree_unflatten_like,
)

_OPT_PARTS = ("mu", "nu", "steps")


def _is_table_path(path: tuple) -> bool:
    return "hashgrid" in path


def _shardable(x, world: int) -> bool:
    shape = getattr(x, "shape", ())
    return len(shape) >= 1 and shape[0] >= world and shape[0] % world == 0


def table_spec_tree(tree, world: int):
    """``tree``'s structure with True at the hash-table leaves that ZeRO-1
    row-shards (rows divisible by the world size) and False elsewhere (the
    JAX package's ``P("data")`` / ``P()`` spec tree)."""
    return tree_unflatten_like(tree, [_is_table_path(p) and _shardable(x, world)
                                      for p, x in tree_leaves_with_path(tree)])


def _rows(x: torch.Tensor, ctx: ParallelContext) -> torch.Tensor:
    n = x.shape[0] // ctx.world
    return x[ctx.rank * n:(ctx.rank + 1) * n]


def _shard(tree, spec, ctx: ParallelContext):
    """This rank's rows of the spec's leaves (views); the rest as they are."""
    return tree_map(lambda x, s: _rows(x, ctx) if s else x, tree, spec)


def _gather(tree, spec, ctx: ParallelContext):
    """The whole of each spec leaf from the ranks' row shards, in rank order."""
    return tree_map(lambda x, s: _all_gather_cat(x, ctx) if s else x, tree, spec)


def _opt_spec(params, world: int) -> dict:
    spec = table_spec_tree(params, world)
    return {**{k: spec for k in _OPT_PARTS}, "count": False}


def _mean_(tensors: list, ctx: ParallelContext) -> list:
    """Sum over the ranks, then divide by the world size (JAX's pmean), in
    one all-reduce of the leaves laid end to end."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=ctx.group)
    flat = flat / ctx.world
    return [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def _reduce_scatter_mean(g: torch.Tensor, ctx: ParallelContext) -> torch.Tensor:
    out = torch.empty_like(_rows(g, ctx))
    dist.reduce_scatter(out, list(g.contiguous().chunk(ctx.world)), op=dist.ReduceOp.SUM,
                        group=ctx.group)
    return out / ctx.world


def _reduce_grads(grads: dict, ctx: ParallelContext, spec=None) -> dict:
    """The ranks' mean gradient; with a ZeRO-1 ``spec`` (over
    ``grads["params"]``), the spec's table leaves reduce-scattered to this
    rank's rows."""
    paths = [p for p, _ in tree_leaves_with_path(grads)]
    leaves = tree_leaves(grads)
    sharded = [False] * len(leaves)
    if spec is not None:
        flags = iter(tree_leaves(spec))
        sharded = [p[0] == "params" and next(flags) for p in paths]
    dense = iter(_mean_([g for g, s in zip(leaves, sharded) if not s], ctx))
    out = [_reduce_scatter_mean(g, ctx) if s else next(dense) for g, s in zip(leaves, sharded)]
    return tree_unflatten_like(grads, out)


def _mean_aux(aux: StepAux, ctx: ParallelContext) -> StepAux:
    vec = torch.stack([a.to(torch.float32) for a in aux])
    return StepAux(*_mean_([vec], ctx)[0].unbind())


def _all_gather_cat(x: torch.Tensor, ctx: ParallelContext) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(ctx.world)]
    dist.all_gather(parts, x.contiguous(), group=ctx.group)
    return torch.cat(parts)


def _combine_extras(extras: StepExtras, ctx: ParallelContext) -> StepExtras:
    """Every rank's candidates, in rank order, and the sharpness grid's
    elementwise MAX over the ranks (the scatter-max over all rays)."""
    grid = extras.sharpness_grid
    if grid is not None:
        grid = grid.clone()
        dist.all_reduce(grid, op=dist.ReduceOp.MAX, group=ctx.group)
    return StepExtras(_all_gather_cat(extras.img_idx, ctx), _all_gather_cat(extras.uv, ctx),
                      _all_gather_cat(extras.ray_loss, ctx), grid)


def sample_rank_draws(generator: torch.Generator, config: TrainConfig, n_images: int,
                      ctx: ParallelContext) -> StepDraws:
    """This rank's slice of one global batch of ``config.n_rays * world``
    rays drawn from the replicated generator (every rank draws the same
    numbers, so the generator stays replicated)."""
    whole = sample_step_draws(
        generator, dataclasses.replace(config, n_rays=config.n_rays * ctx.world), n_images)
    r, c = config.n_rays, config.n_rays * config.hit_oversample
    by_rays = ("xi", "max_level_u")
    return StepDraws(*(
        None if d is None else d[ctx.rank * (r if f in by_rays else c):
                                 (ctx.rank + 1) * (r if f in by_rays else c)]
        for f, d in zip(StepDraws._fields, whole)
    ))


def _zero1_field_update(ctx: ParallelContext, spec):
    """The field's tcnn Adam on this rank's rows of the sharded tables
    (``state.opt_state`` holds only those rows), then the new rows
    gathered; the other leaves update whole, alike on every rank."""

    def update(state: TrainState, grads, config: TrainConfig):
        params_sh = _shard(state.params, spec, ctx)
        updates, new_opt = adam_update(grads, state.opt_state, params_sh, config.optim)
        new_sh = tree_map(lambda p, u: p + u, params_sh, updates)
        return _gather(new_sh, spec, ctx), new_opt

    return update


def parallel_train_step(state: TrainState, images: torch.Tensor, cameras: Cameras,
                        config: TrainConfig, ctx: ParallelContext,
                        train_canonical: bool = True, train_delta: bool = False,
                        use_delta: bool = False, depths: torch.Tensor | None = None,
                        zero1: bool = False, draws: StepDraws | None = None):
    """One data-parallel step -> (new state, the ranks' mean aux); every
    rank calls it with the same arguments but ``draws`` (this rank's, by
    default its slice of the global batch).

    ``config.n_rays`` is the per-rank ray count.  ``zero1`` shards the
    table gradients and the field's Adam over the ranks in canonical
    phases; ``state.opt_state`` must then hold this rank's rows
    (``shard_state_zero1``).  The gradients of the shardable tables are
    then reduce-scattered (half an all-reduce), the tcnn Adam runs on this
    rank's rows only and the new rows are all-gathered (the other half):
    the all-reduce's bytes, with the optimizer's memory and work divided by
    the world size."""
    spec = table_spec_tree(state.params, ctx.world) if zero1 and train_canonical else None
    config = phase_config(config, train_canonical, train_delta)
    if draws is None:
        draws = sample_rank_draws(state.generator, config, cameras.n_images, ctx)
    diff = step_diff(state, config, train_canonical, train_delta)
    grads, aux, extras = loss_and_grads(diff, state, images, cameras, draws, config,
                                        use_delta or train_delta, depths)
    grads = _reduce_grads(grads, ctx, spec)
    aux = _mean_aux(aux, ctx)
    if extras is not None:
        extras = _combine_extras(extras, ctx)
    update = field_adam if spec is None else _zero1_field_update(ctx, spec)
    return apply_grads(state, grads, extras, config, train_canonical, train_delta, update), aux


def _broadcast_(t: torch.Tensor, ctx: ParallelContext) -> None:
    dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t, 0, group=ctx.group)


def replicate_error_cdf(state: TrainState, ctx: ParallelContext) -> TrainState:
    """Rank 0's error-map CDF on every rank, after a rebuild: the CDF's
    prefix sum (``torch.cumsum`` of a 1-D tensor) has no fixed summation
    order on the card, so ranks that rebuild it from one error map may
    differ in its last bits."""
    _broadcast_(state.error_map.cdf, ctx)
    return state


def _state_tensors(state: TrainState) -> list:
    return [t for t in tree_leaves([state.params, state.ema_params, state.opt_state,
                                    state.delta, state.delta_opt_state, state.acc, state.cam,
                                    state.cam_opt_state, list(state.occupancy),
                                    list(state.error_map)])
            if torch.is_tensor(t)]


def replicate_state(state: TrainState, ctx: ParallelContext) -> TrainState:
    """Rank 0's state on every rank: each tensor broadcast in place, the
    host counters and the step generator's state too, so replicas built
    apart agree."""
    for t in _state_tensors(state):
        _broadcast_(t, ctx)
    counts = torch.tensor([state.step, state.frame_step, state.opt_state["count"],
                           state.delta_opt_state["count"], state.cam_opt_state["count"],
                           state.occupancy.ema_step], dtype=torch.int64, device=ctx.device)
    _broadcast_(counts, ctx)
    step, frame_step, n_opt, n_delta, n_cam, ema_step = counts.tolist()
    gen = state.generator.get_state().to(ctx.device)
    _broadcast_(gen, ctx)
    state.generator.set_state(gen.cpu())
    return state._replace(
        step=step, frame_step=frame_step, opt_state={**state.opt_state, "count": n_opt},
        delta_opt_state={**state.delta_opt_state, "count": n_delta},
        cam_opt_state={**state.cam_opt_state, "count": n_cam},
        occupancy=state.occupancy._replace(ema_step=ema_step))


def shard_opt_state(opt_state: dict, params, ctx: ParallelContext) -> dict:
    """A whole field Adam state cut to this rank's rows of the shardable
    tables (copies, so the whole leaves can be freed)."""
    spec = _opt_spec(params, ctx.world)
    return tree_map(lambda x, s: _rows(x, ctx).clone() if s else x, opt_state, spec)


def gather_opt_state(opt_state: dict, params, ctx: ParallelContext) -> dict:
    """The whole field Adam state from the ranks' row shards (a collective:
    every rank calls it)."""
    return _gather(opt_state, _opt_spec(params, ctx.world), ctx)


def shard_state_zero1(state: TrainState, ctx: ParallelContext) -> TrainState:
    """Rank 0's state on every rank, with the field's Adam state cut to
    this rank's table rows (the JAX package's row-sharded opt state)."""
    state = replicate_state(state, ctx)
    return state._replace(opt_state=shard_opt_state(state.opt_state, state.params, ctx))
