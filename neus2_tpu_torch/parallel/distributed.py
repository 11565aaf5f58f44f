"""Process groups for data-parallel training (port of
``neus2_tpu/parallel/distributed.py``).

The JAX package runs one controller over a device mesh; torch's idiom is
one process a rank, one card a rank.  ``initialize`` joins the world a
launcher describes (``torchrun``'s environment, or an explicit
coordinator address, process count and id); ``launch`` starts one rank a
card itself, through ``torch.multiprocessing`` and a file store in a
temporary directory, so no port is needed.  The backend follows the
device: NCCL for ``cuda``, gloo for ``cpu``.  A failed NCCL start raises;
nothing falls back to gloo.  Every collective of the group times out after
``TIMEOUT``, so a rank that never arrives fails the run instead of hanging
it.

``ParallelContext`` (rank, world size, group) stands in for the JAX
package's mesh in ``parallel/train.py`` and the Testbed.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import sys
import tempfile
import traceback
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist

from neus2_tpu_torch.utils.device import resolve_device

TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """One rank's view of the data-parallel world: its rank, the world
    size, the process group (None: the default group) and the device its
    tensors live on."""

    rank: int
    world: int
    device: torch.device
    group: Any = None


def context(device=None) -> ParallelContext:
    """The default group's context, on ``device`` (default: this rank's
    card under NCCL, the CPU under gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call distributed.initialize or launch first")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return ParallelContext(dist.get_rank(), dist.get_world_size(), torch.device(device))


def _under_launcher() -> bool:
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device="cuda") -> bool:
    """Join the data-parallel world -> whether this call started a process
    group (the caller then destroys it when done).

    Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` in the environment)
    the group comes from its environment; otherwise from the arguments
    (``coordinator_address`` "host:port", reached over TCP).  A world of
    one process (``num_processes=1``, or no arguments and no launcher) is a
    no-op, as the JAX package's ``initialize`` is.  Each rank of a CUDA
    world takes the card ``LOCAL_RANK`` names (default: rank % cards)."""
    if dist.is_initialized() or num_processes == 1:
        return False
    explicit = any(a is not None for a in (coordinator_address, num_processes, process_id))
    if not explicit and not _under_launcher():
        return False
    dev = torch.device(device)
    if _under_launcher() and not explicit:
        rank, world, init = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://"
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("a multi-process run needs the coordinator address, the "
                             "process count and this process's id")
        rank, world = int(process_id), int(num_processes)
        init = f"tcp://{coordinator_address}"
    if dev.type == "cuda":
        resolve_device(dev)
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    _init_group(dev, init, world, rank)
    return True


def _init_group(device: torch.device, init_method: str, world: int, rank: int) -> None:
    """NCCL for a CUDA device (bound to this rank's card), gloo for the CPU."""
    kw = {}
    if device.type == "cuda":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, world_size=world, rank=rank,
                            timeout=TIMEOUT, **kw)


def is_primary() -> bool:
    """True on the process that writes logs, snapshots, meshes and renders."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (a no-op without a process group)."""
    if dist.is_initialized():
        dist.barrier()


def _rank_main(rank: int, fn: Callable, world: int, store: str, device: str, result_dir: str,
               args: tuple) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    _init_group(dev, f"file://{store}", world, rank)
    try:
        out = fn(ParallelContext(rank, world, dev), *args)
    except BaseException:
        # Its peers may wait in a collective this rank never joins, and an
        # NCCL group's destroy would wait with them until the timeout: leave
        # at once, the error where ``launch`` reads it; ``launch`` then ends
        # the other ranks.
        (Path(result_dir) / f"rank{rank}.err").write_text(traceback.format_exc())
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    torch.save(out, Path(result_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def launch(fn: Callable, world: int, *args, device="cuda") -> list:
    """Run ``fn(ctx, *args)`` on ``world`` new processes, one rank each
    (rank r on card r under CUDA), in a process group initialized through
    a file store -> the ranks' return values, in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path).  A rank
    that raises ends the others at once, and ``launch`` raises with each
    failed rank's traceback."""
    if torch.device(device).type == "cuda":
        resolve_device(device)
        n = torch.cuda.device_count()
        if world > n:
            raise ValueError(f"{world} ranks need {world} cards; {n} are visible "
                             "(NCCL puts one rank on one card)")
    tmp = tempfile.mkdtemp(prefix="neus2_launch_")
    try:
        try:
            torch.multiprocessing.start_processes(
                _rank_main, args=(fn, world, os.path.join(tmp, "store"), str(device), tmp, args),
                nprocs=world, join=True, start_method="spawn")
        except (torch.multiprocessing.ProcessRaisedException,
                torch.multiprocessing.ProcessExitedException) as e:
            errs = sorted(Path(tmp).glob("rank*.err"))
            if not errs:
                raise
            raise RuntimeError("".join(f"{p.stem} failed:\n{p.read_text()}" for p in errs)) from e
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
