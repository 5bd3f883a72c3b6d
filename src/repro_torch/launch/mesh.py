"""Process groups for the pipe axis: one process per pipe rank.

Counterpart of :mod:`repro.launch.mesh` for the ``pipe`` axis only.  Where
the reference lays a device mesh out and runs every stage inside one
``shard_map`` program, the port starts one process per pipe rank and
joins them in a ``torch.distributed`` group; either executor then runs
each rank's column of the plan in its own process
(``pipeline_grad_call(..., group=...)``, ``pipeline_call(...,
group=...)``) and hops over point-to-point messages
(:mod:`repro_torch.core.p2p`).

The backend is gloo, whose messages take host tensors: a CUDA payload
crosses through pinned host memory.  That runs on one card too: every rank
takes ``cuda:rank % device_count`` (``cuda:0`` on a one-card machine,
where the ranks time-slice the card).  NCCL hops need a machine with two
cards or more (ROADMAP A4c), and data, tensor and pod parallelism are
ROADMAP A9: both raise.  Nothing falls back, neither from ``cuda`` to the
CPU nor from one backend to another.

    def rank_main(rank, size, init_method):
        group = init_pipe_group(rank, size, init_method, device="cpu")
        ...
        destroy_pipe_group(group)

    spawn(rank_main, 4)            # bounded: a rank that fails or hangs
                                   # fails the call, with its traceback
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.core.p2p import PipeGroup
from repro_torch.core.pipeline import check_single_replica
from repro_torch.devices import DeviceLike, resolve_device

__all__ = ["PipeGroup", "init_pipe_group", "destroy_pipe_group", "spawn"]

#: seconds a rendezvous, a hop or a collective may wait before it fails;
#: and the hard limit :func:`spawn` gives a group by default
TIMEOUT_S = 120.0


def rank_device(rank: int, device: DeviceLike = "cuda") -> torch.device:
    """The device pipe rank ``rank`` runs on: ``cuda:rank % count`` (every
    rank on ``cuda:0`` of a one-card machine), or the CPU when asked."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.device(device).index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_pipe_group(rank: int, size: int, init_method: str, *,
                    device: DeviceLike = "cuda", backend: str = "gloo",
                    timeout_s: float = TIMEOUT_S,
                    pcfg: Optional[ParallelConfig] = None) -> PipeGroup:
    """Join this process to the pipe group as rank ``rank`` of ``size``,
    meeting at ``init_method`` (``file://...`` or ``tcp://host:port``),
    and return its :class:`PipeGroup`.  ``timeout_s`` bounds the
    rendezvous and every later wait.  With ``pcfg``, its pipe degree must
    be ``size`` and its data, tensor and pod degrees 1."""
    if backend == "nccl":
        raise NotImplementedError(
            "backend='nccl': NCCL hops need a machine with a card per rank "
            "(ROADMAP A4c); the pipe group runs on gloo")
    if backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}; want 'gloo'")
    if pcfg is not None:
        check_single_replica(pcfg)
        if pcfg.pipe != size:
            raise ValueError(f"pipe={pcfg.pipe} needs {pcfg.pipe} ranks, "
                             f"the group has {size}")
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a group of {size}")
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    import torch.distributed as dist
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return PipeGroup(rank, size, dev, dist.group.WORLD)


def destroy_pipe_group(group: PipeGroup) -> None:
    import torch.distributed as dist
    dist.destroy_process_group()


def spawn(fn: Callable, nproc: int, args: Sequence = (), *,
          timeout_s: Optional[float] = TIMEOUT_S,
          rendezvous_dir: Optional[str] = None) -> None:
    """Run ``fn(rank, nproc, init_method, *args)`` in ``nproc`` fresh
    processes (the ``spawn`` start method: ``fn`` must be importable) and
    wait at most ``timeout_s`` seconds for all of them (``None``: no
    overall limit; a hang is still bounded by the group's own wait
    timeout, :data:`TIMEOUT_S`).  The group meets at a ``file://``
    rendezvous in ``rendezvous_dir`` (a new temporary directory by
    default).  A rank that raises fails the call with that rank's
    traceback, and the others are stopped; at the time limit every rank
    still running is killed and the call raises ``TimeoutError``."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(dir=rendezvous_dir) as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(fn, args=(nproc, init_method, *args),
                                 nprocs=nproc, join=False,
                                 start_method="spawn")
        deadline = (float("inf") if timeout_s is None
                    else time.monotonic() + timeout_s)
        try:
            while not ctx.join(timeout=max(0.0, min(
                    1.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    alive = [i for i, p in enumerate(ctx.processes)
                             if p.is_alive()]
                    raise TimeoutError(
                        f"pipe ranks {alive} of {nproc} still running after "
                        f"{timeout_s:.0f} s: killed")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
