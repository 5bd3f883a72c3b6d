"""Process groups: one process per rank of the ``(pod, data, pipe, tp)``
mesh.

Counterpart of :mod:`repro.launch.mesh`.  Where the reference lays a
device mesh out and runs one GSPMD program over it, the port starts one
process per mesh rank and joins them in ``torch.distributed`` groups, one
per axis, laid out as the reference's :func:`make_arch_mesh` lays its
devices out: ``tp`` innermost, then ``pipe``, then ``data`` (with ``dp2``
folded into it), then ``pod``, so global rank
``((pod_i * D + data_i) * P + pipe_i) * T + tp_i`` with ``D = data * dp2``.
Either executor runs each pipe rank's column of the plan in its own
process (``pipeline_grad_call(..., group=...)``, ``pipeline_call(...,
group=...)``) and hops over point-to-point messages
(:mod:`repro_torch.core.p2p`); the data, FSDP and tensor-parallel
collectives run on the other axes' groups (:class:`p2p.AxisGroup`).

The backend is gloo, whose messages take host tensors: a CUDA payload
crosses through host memory.  That runs on one card too: every rank
takes ``cuda:rank % device_count`` (``cuda:0`` on a one-card machine,
where the ranks time-slice the card).  NCCL needs a machine with two
cards or more (ROADMAP A4c) and raises.  Nothing falls back, neither from
``cuda`` to the CPU nor from one backend to another.

    def rank_main(rank, size, init_method):
        mesh = init_mesh_groups(rank, size, init_method, pcfg, device="cpu")
        ...                      # mesh.pipe is the rank's PipeGroup
        destroy_pipe_group(mesh.pipe)

    spawn(rank_main, 8)            # bounded: a rank that fails or hangs
                                   # fails the call, with its traceback
"""
from __future__ import annotations

import datetime
import itertools
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.core.p2p import AxisGroup, PipeGroup
from repro_torch.devices import DeviceLike, resolve_device

__all__ = ["AXES", "MeshView", "PipeGroup", "init_mesh_groups", "mesh_groups",
           "init_pipe_group", "destroy_pipe_group", "make_arch_mesh",
           "make_smoke_mesh", "spawn"]

#: seconds a rendezvous, a hop or a collective may wait before it fails;
#: and the hard limit :func:`spawn` gives a group by default
TIMEOUT_S = 120.0

#: the mesh axes, outermost first
AXES = ("pod", "data", "pipe", "tp")

#: the groups a rank joins: ``data``, ``pipe`` and ``tp`` (the ranks that
#: differ from it on that axis alone), ``replica`` (those that differ in
#: (pod, data): the data-parallel replicas of one model shard, in replica
#: order) and ``model`` (those that differ in (pipe, tp): one model copy)
GROUPS = {"data": ("data",), "pipe": ("pipe",), "tp": ("tp",),
          "replica": ("pod", "data"), "model": ("pipe", "tp")}


def mesh_shape(pcfg: ParallelConfig) -> Dict[str, int]:
    """The mesh's axis sizes: ``dp2`` folds into ``data``."""
    return {"pod": pcfg.pod, "data": pcfg.data * pcfg.dp2,
            "pipe": pcfg.pipe, "tp": pcfg.tp}


def make_arch_mesh(pcfg: ParallelConfig) -> np.ndarray:
    """The global rank at each ``(pod, data, pipe, tp)`` coordinate: the
    reference's production grid ``(pod, data, model)`` with ``model``
    factored as ``(dp2, pipe, tp)`` and ``dp2`` folded into ``data``."""
    n = pcfg.pod * pcfg.data * pcfg.dp2 * pcfg.pipe * pcfg.tp
    return np.arange(n).reshape(pcfg.pod, pcfg.data, pcfg.dp2, pcfg.pipe,
                                pcfg.tp).reshape(pcfg.pod,
                                                 pcfg.data * pcfg.dp2,
                                                 pcfg.pipe, pcfg.tp)


def make_smoke_mesh(pcfg: ParallelConfig) -> np.ndarray:
    """The reduced configs' grid (the reference's ``make_smoke_mesh``):
    ``pod * data * pipe * tp`` ranks, ``dp2`` left out."""
    return np.arange(pcfg.pod * pcfg.data * pcfg.pipe * pcfg.tp).reshape(
        pcfg.pod, pcfg.data, pcfg.pipe, pcfg.tp)


@dataclass
class MeshView:
    """One rank's view of the mesh: its global rank, the axis sizes, its
    coordinates, its device, an :class:`AxisGroup` per entry of
    :data:`GROUPS` and its :class:`PipeGroup` (the ``pipe`` axis, with
    every pipe peer's global rank)."""
    rank: int
    shape: Dict[str, int]
    coords: Dict[str, int]
    device: torch.device
    axes: Dict[str, AxisGroup]
    pipe: PipeGroup

    @property
    def replicas(self) -> int:
        """Data-parallel replicas: ``pod * data`` (``dp2`` included)."""
        return self.shape["pod"] * self.shape["data"]

    @property
    def replica(self) -> int:
        """This rank's replica, ``pod_i * data + data_i``: its batch
        slice."""
        return self.axes["replica"].rank

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Every collective class this rank ran, summed over its groups."""
        out: Dict[str, Dict[str, float]] = {}
        for ax in self.axes.values():
            for cls, st in ax.stats.items():
                acc = out.setdefault(cls, {"calls": 0, "bytes": 0,
                                           "wait_s": 0.0})
                for k in acc:
                    acc[k] += st[k]
        return out

    def reset_stats(self) -> None:
        for ax in self.axes.values():
            ax.stats.clear()


def rank_device(rank: int, device: DeviceLike = "cuda") -> torch.device:
    """The device rank ``rank`` runs on: ``cuda:rank % count`` (every
    rank on ``cuda:0`` of a one-card machine), or the CPU when asked."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.device(device).index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _check_backend(backend: str) -> None:
    if backend == "nccl":
        raise NotImplementedError(
            "backend='nccl': NCCL hops need a machine with a card per rank "
            "(ROADMAP A4c); the mesh runs on gloo")
    if backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}; want 'gloo'")


def init_mesh_groups(rank: int, world: int, init_method: str,
                     pcfg: ParallelConfig, *, device: DeviceLike = "cuda",
                     backend: str = "gloo",
                     timeout_s: float = TIMEOUT_S) -> MeshView:
    """Join this process to the mesh of ``pcfg`` as global rank ``rank``
    of ``world`` (``pod * data * dp2 * pipe * tp``), meeting at
    ``init_method`` (``file://...`` or ``tcp://host:port``), and return
    the rank's :class:`MeshView` (:func:`mesh_groups`).  ``timeout_s``
    bounds the rendezvous and every later wait."""
    _check_backend(backend)
    if make_arch_mesh(pcfg).size != world:
        raise ValueError(f"the mesh {mesh_shape(pcfg)} has "
                         f"{make_arch_mesh(pcfg).size} ranks, the world "
                         f"{world}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    import torch.distributed as dist
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return mesh_groups(pcfg, device=dev, timeout_s=timeout_s)


def mesh_groups(pcfg: ParallelConfig, *, device: DeviceLike = "cuda",
                timeout_s: float = TIMEOUT_S) -> MeshView:
    """The :class:`MeshView` of ``pcfg`` over the world this process has
    joined: a group per entry of :data:`GROUPS`, every rank taking part in
    building every group, in one order (``torch.distributed.new_group``
    asks it).  One world can be laid out as several meshes in turn."""
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    shape = mesh_shape(pcfg)
    grid = make_arch_mesh(pcfg)
    if grid.size != world:
        raise ValueError(f"the mesh {shape} has {grid.size} ranks, the "
                         f"world {world}")
    dev = rank_device(rank, device)
    timeout = datetime.timedelta(seconds=timeout_s)
    where = np.argwhere(grid == rank)[0]
    coords = dict(zip(AXES, (int(i) for i in where)))
    axes = {}
    for name, varying in GROUPS.items():
        vary = [AXES.index(a) for a in varying]
        fixed = [i for i in range(len(AXES)) if i not in vary]
        mine = None
        for key in itertools.product(*(range(grid.shape[i]) for i in fixed)):
            idx = [slice(None)] * len(AXES)
            for i, k in zip(fixed, key):
                idx[i] = k
            members = tuple(int(r) for r in grid[tuple(idx)].reshape(-1))
            if len(members) == world:
                g = dist.group.WORLD
            else:
                g = (dist.new_group(list(members), timeout=timeout)
                     if len(members) > 1 else None)
            if rank in members:
                mine = (g, members)
        g, members = mine
        axes[name] = AxisGroup(name, members.index(rank), len(members), dev,
                               g, members)
    pipe_ax = axes["pipe"]
    pipe = PipeGroup(pipe_ax.rank, pipe_ax.size, dev, pipe_ax.group,
                     pipe_ax.peers if pipe_ax.size < world else ())
    return MeshView(rank, shape, coords, dev, axes, pipe)


def init_pipe_group(rank: int, size: int, init_method: str, *,
                    device: DeviceLike = "cuda", backend: str = "gloo",
                    timeout_s: float = TIMEOUT_S,
                    pcfg: Optional[ParallelConfig] = None) -> MeshView:
    """Join this process to a pipe group as rank ``rank`` of ``size``: the
    mesh with every degree but ``pipe`` at 1 (:func:`init_mesh_groups`),
    whose :class:`MeshView` it returns (``.pipe`` is the
    :class:`PipeGroup`).  With ``pcfg``, its pipe degree must be ``size``
    and its data, tensor and pod degrees 1 (a wider mesh joins through
    :func:`init_mesh_groups`)."""
    _check_backend(backend)
    if pcfg is not None:
        if (pcfg.tp, pcfg.data, pcfg.pod, pcfg.dp2) != (1, 1, 1, 1):
            raise ValueError(
                f"tp={pcfg.tp}, data={pcfg.data}, pod={pcfg.pod}, "
                f"dp2={pcfg.dp2}: a pipe group holds one replica of one "
                "model shard; join the mesh with init_mesh_groups")
        if pcfg.pipe != size:
            raise ValueError(f"pipe={pcfg.pipe} needs {pcfg.pipe} ranks, "
                             f"the group has {size}")
    return init_mesh_groups(
        rank, size, init_method,
        ParallelConfig(pipe=size, tp=1, data=1, pod=1, dp2=1),
        device=device, backend=backend, timeout_s=timeout_s)


def destroy_pipe_group(group) -> None:
    """Leave the world this process joined (``group``: its
    :class:`PipeGroup` or :class:`MeshView`)."""
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
