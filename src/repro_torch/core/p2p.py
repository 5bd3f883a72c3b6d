"""Hops between pipe ranks: how a payload shipped on one rank reaches the
rank where it parks.

Counterpart of the reference's chain and route permutes (``_shift_chain``,
``_shift_chain_rev`` and ``_route_hop``, ``src/repro/core/pipeline.py``).
The fused executor (:mod:`repro_torch.core.pipeline`) ships every payload
through a hop: the forward chain's carry, the cotangent chain's, a skip
route's value or cotangent, a stream shard.  Each payload belongs to a
*stream* (``f``, ``b``, ``r:<route>``, ``g:<route>``, ``s``) and travels
as its **wire tree**, what ``_Wire.enc`` made of it (the value itself, its
bf16 cast, or int8 blocks and fp32 scales), with the *proto* its arrival
decodes to and its tag ``(micro, global stage)``, which ``_Slots`` checks
at the read.

* :class:`LocalHop`: every rank in this process (the default).  A payload
  waits in an outbox for the next tick's arrivals and moves with
  ``.to(device)``, a no-op when every stage sits on one card.
* :class:`P2PHop`: one pipe rank per process (:class:`PipeGroup`).  A
  payload for another rank is a ``torch.distributed`` message exchange on
  the stream's tag: a preamble of four int64 (micro, stage, header bytes,
  payload bytes), the layout header when its (stream, source rank, stage)
  has not sent one in this run, and the payload, every leaf's bytes packed
  in tree order.  The receiver sizes its buffer from the preamble and
  rebuilds each leaf as a fresh tensor on its device from the cached
  layout.  Gloo's point-to-point messages take CPU tensors, so a CUDA leaf
  crosses through a pinned host buffer: copied out and synchronized before
  the send, copied in after the receive.  A payload whose destination is
  this rank (a route whose ends share a rank) stays in the local outbox.

Send discipline (``executor``): ``"spmd"`` posts a payload's messages when
the task ships it, at the end of its tick, and waits for them after the
next tick's arrivals; ``"mpmd"`` latches the payload in its stream's
one-deep register and :meth:`P2PHop.post` sends it at the top of the next
tick, where the plan's ``send_slot`` / ``b_send_slot`` and the routes'
``ship`` / ``g_ship`` columns say; it waits for a send only when the
register is latched again, or at the end of the run.  Either way every
send is posted before its rank blocks on a receive, so no rank waits on
one that has not posted.

:class:`P2PHop` counts, per payload class (``chain``, ``cotangent``,
``portal``, ``stream``, and ``embed`` for the step's tied-embedding
exchange), the hops this rank sent, their payload bytes (the wire tree's
leaves: what ``core/wire.plan_wire_report`` prices) and the host-clock
seconds this rank waited on sends and receives of the class.
"""
from __future__ import annotations

import json
import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

Tag = Tuple[int, int]                 # (micro, global stage)

#: payload classes a rank counts; the first three are plan_wire_report's
CLASSES = ("chain", "cotangent", "portal", "stream", "embed")


def payload_class(stream: str) -> str:
    """The class a stream's payloads count under."""
    if stream == "f":
        return "chain"
    if stream == "b" or stream.startswith("g:"):
        return "cotangent"
    if stream.startswith("r:"):
        return "portal"
    if stream == "s":
        return "stream"
    return "embed"


@dataclass
class PipeGroup:
    """One pipe rank's view of its process group
    (:func:`repro_torch.launch.mesh.init_pipe_group`): its rank, the
    group's size (the pipe degree), the device its stages run on and the
    ``torch.distributed`` group the hops use."""
    rank: int
    size: int
    device: torch.device
    group: Any = None                 # None: the default (world) group

    @property
    def first(self) -> bool:
        return self.rank == 0

    @property
    def last(self) -> bool:
        return self.rank == self.size - 1


class LocalHop:
    """Every rank in this process: the outbox, keyed by (stream,
    destination rank), holds one payload until the next tick's arrivals."""

    def __init__(self, n_ranks: int, devices: Sequence[torch.device]):
        self.ranks = range(n_ranks)
        self.devices = devices
        self.outbox: Dict[Tuple[str, int], Any] = {}

    def put(self, stream: str, src: int, dst: int, tag: Tag, wire,
            proto) -> None:
        if (stream, dst) in self.outbox:
            raise RuntimeError(f"stream {stream}: two values reach rank "
                               f"{dst} on one tick")
        self.outbox[(stream, dst)] = (tag, wire, proto)

    def take(self, stream: str, src: int, dst: int, expect: bool):
        """The payload that arrives on ``dst`` this tick, moved to its
        tag's stage device, or None; raises where the plan and the
        shipped payloads disagree."""
        item = self.outbox.pop((stream, dst), None)
        if expect != (item is not None):
            raise RuntimeError(
                f"stream {stream}: rank {dst} "
                + ("expects an arrival nobody shipped" if expect
                   else "has no slot for the value shipped to it"))
        if item is None:
            return None
        tag, wire, proto = item
        dev = self.devices[tag[1]]
        return tag, tree_map(lambda a: a.to(dev), wire), proto

    def scatter_shards(self, split):
        """Stream shards at the start: rank ``r`` gets row ``r`` of every
        ``[R, ...]`` leaf of ``split``, on its device."""
        return {r: tree_map(lambda a: a[r].to(self.devices[r]), split)
                for r in self.ranks}

    def rotate_shards(self, shards):
        """Every stream shard moves one rank towards 0."""
        R = len(self.ranks)
        return {r: tree_map(lambda a: a.to(self.devices[r]),
                            shards[(r + 1) % R])
                for r in self.ranks}

    def finish(self) -> None:
        if self.outbox:
            raise RuntimeError(f"payloads never landed: {sorted(self.outbox)}")


# ---------------------------------------------------------------------------
# Wire layout: a tree of tensors as JSON, its leaves as one byte buffer
# ---------------------------------------------------------------------------

def _layout(tree):
    """JSON-able layout: a dict per dict, ``[dtype, shape]`` per leaf."""
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    return [str(tree.dtype).split(".")[-1], list(tree.shape)]


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r} in a wire layout")
    return dt


def _layout_leaves(layout) -> List[Tuple[torch.dtype, Tuple[int, ...]]]:
    if isinstance(layout, dict):
        return [leaf for v in layout.values() for leaf in _layout_leaves(v)]
    return [(_dtype(layout[0]), tuple(layout[1]))]


def _nbytes(dtype: torch.dtype, shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n * torch.empty((), dtype=dtype).element_size()


def _rebuild(layout, make):
    """The tree of ``layout`` with ``make(dtype, shape)`` at each leaf, in
    leaf order."""
    if isinstance(layout, dict):
        return {k: _rebuild(v, make) for k, v in layout.items()}
    return make(_dtype(layout[0]), tuple(layout[1]))


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


class P2PHop:
    """One pipe rank's hop (module docstring): the executor's ``put`` /
    ``take`` over ``torch.distributed`` messages, with the send discipline
    of ``executor`` and per-class counts in :attr:`stats`.  One instance
    serves one executor call."""

    def __init__(self, group: PipeGroup, executor: str = "spmd"):
        if executor not in ("spmd", "mpmd"):
            raise ValueError(f"unknown executor {executor!r}; want 'spmd' "
                             "or 'mpmd'")
        import torch.distributed as dist
        self.dist = dist
        self.group = group
        self.rank, self.device = group.rank, group.device
        self.ranks = (group.rank,)
        self.latch = executor == "mpmd"
        self.pin = group.device.type == "cuda"
        self.local: Dict[str, Any] = {}          # same-rank payloads
        self.latched: Dict[str, Tuple[int, Tag, Any]] = {}
        self.inflight: Dict[str, List[Any]] = {}  # stream -> (works, bufs)
        self.sent_layouts: Dict[Tuple[str, int, int], str] = {}
        self.recv_layouts: Dict[Tuple[str, int, int], Any] = {}
        self.stats = {c: {"hops": 0, "bytes": 0, "wait_s": 0.0}
                      for c in CLASSES}

    # ------------------------------------------------------------ sending
    def put(self, stream: str, src: int, dst: int, tag: Tag, wire,
            proto) -> None:
        if src != self.rank:
            raise RuntimeError(f"rank {self.rank} ships for rank {src}")
        if dst == self.rank:
            if stream in self.local:
                raise RuntimeError(f"stream {stream}: two values reach rank "
                                   f"{dst} on one tick")
            self.local[stream] = (tag, wire, proto)
            return
        if not self.latch:
            self._send(stream, dst, tag, wire, proto)
            return
        if stream in self.latched:
            raise RuntimeError(f"stream {stream}: the send register of rank "
                               f"{self.rank} is latched twice in one tick")
        self.wait(stream)                       # the register is reused
        self.latched[stream] = (dst, tag, (wire, proto))

    def post(self, stream: str) -> None:
        """mpmd: send what the stream latched on the previous tick."""
        if stream not in self.latched:
            raise RuntimeError(f"stream {stream}: the plan ships from rank "
                               f"{self.rank} but nothing was latched")
        dst, tag, (wire, proto) = self.latched.pop(stream)
        self._send(stream, dst, tag, wire, proto)

    def check_posted(self, t: int) -> None:
        if self.latched:
            raise RuntimeError(f"tick {t}: rank {self.rank} latched "
                               f"{sorted(self.latched)}, which the plan "
                               "does not ship")

    def send_tree(self, stream: str, dst: int, tree) -> None:
        """Post ``tree`` to ``dst`` outside the tick loop (a stream shard,
        a gradient); :meth:`finish` waits for it."""
        self._send(stream, dst, (-1, -1), tree, None)

    def scatter_shards(self, split):
        """Stream shards at the start: rank 0, which holds the inputs
        (``split``, ``[R, ...]`` leaves), keeps row 0 and sends rank ``r``
        row ``r``; every other rank receives its own."""
        if self.rank != 0:
            return {self.rank: self.recv_tree("s", 0)[1]}
        for r in range(1, self.group.size):
            self.send_tree("s", r, tree_map(lambda a: a[r], split))
        return {0: tree_map(lambda a: a[0].to(self.device), split)}

    def rotate_shards(self, shards):
        """This rank's stream shard goes to rank ``r - 1``, and rank
        ``r + 1``'s arrives."""
        R, me = self.group.size, self.rank
        self.send_tree("s", (me - 1) % R, shards[me])
        out = {me: self.recv_tree("s", (me + 1) % R)[1]}
        self.wait("s")
        return out

    def _send(self, stream, dst, tag, wire, proto) -> None:
        leaves = tree_leaves(wire)
        layout = json.dumps({"wire": _layout(wire),
                             "proto": None if proto is None
                             else _layout(proto)})
        key = (stream, dst, tag[1])
        header = b""
        if self.sent_layouts.get(key) != layout:
            self.sent_layouts[key] = layout
            header = layout.encode()
        nbytes = sum(leaf.numel() * leaf.element_size() for leaf in leaves)
        buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pin)
        off = 0
        for leaf in leaves:
            n = leaf.numel() * leaf.element_size()
            buf[off:off + n].copy_(_as_bytes(leaf.detach()),
                                   non_blocking=self.pin)
            off += n
        if self.pin:
            torch.cuda.current_stream(self.device).synchronize()
        pre = torch.tensor([tag[0], tag[1], len(header), nbytes],
                           dtype=torch.int64)
        msgs = [pre]
        if header:
            msgs.append(torch.frombuffer(bytearray(header), dtype=torch.uint8))
        if nbytes:
            msgs.append(buf)
        tg = _stream_tag(stream)
        works = [self.dist.isend(x, dst, group=self.group.group, tag=tg)
                 for x in msgs]
        self.inflight.setdefault(stream, []).append((works, msgs))
        st = self.stats[payload_class(stream)]
        st["hops"] += 1
        st["bytes"] += nbytes

    def wait(self, stream: str) -> None:
        """Wait for the stream's sends in flight."""
        pending = self.inflight.pop(stream, [])
        if not pending:
            return
        t0 = time.perf_counter()
        for works, _ in pending:
            for w in works:
                w.wait()
        self.stats[payload_class(stream)]["wait_s"] += \
            time.perf_counter() - t0

    def wait_sends(self) -> None:
        for stream in list(self.inflight):
            self.wait(stream)

    # ---------------------------------------------------------- receiving
    def take(self, stream: str, src: int, dst: int, expect: bool):
        """The payload that lands on this rank this tick: from the local
        outbox when ``src`` is this rank, else received from ``src``; None
        when the plan expects nothing."""
        if src == self.rank:
            item = self.local.pop(stream, None)
            if expect != (item is not None):
                raise RuntimeError(
                    f"stream {stream}: rank {dst} "
                    + ("expects an arrival nobody shipped" if expect
                       else "has no slot for the value shipped to it"))
            return item
        if not expect:
            return None
        return self.recv_tree(stream, src)

    def recv_tree(self, stream: str, src: int):
        """Receive one payload from ``src``: ``(tag, wire, proto)``."""
        tg = _stream_tag(stream)
        t0 = time.perf_counter()
        pre = torch.empty(4, dtype=torch.int64)
        self.dist.irecv(pre, src, group=self.group.group, tag=tg).wait()
        micro, stage, hlen, nbytes = (int(x) for x in pre.tolist())
        key = (stream, src, stage)
        if hlen:
            hbuf = torch.empty(hlen, dtype=torch.uint8)
            self.dist.irecv(hbuf, src, group=self.group.group, tag=tg).wait()
            self.recv_layouts[key] = json.loads(bytes(hbuf.tolist()))
        layout = self.recv_layouts.get(key)
        if layout is None:
            raise RuntimeError(f"stream {stream}: a payload from rank {src} "
                               f"for stage {stage} came without its layout")
        specs = _layout_leaves(layout["wire"])
        if sum(_nbytes(dt, shp) for dt, shp in specs) != nbytes:
            raise RuntimeError(f"stream {stream}: {nbytes} payload bytes "
                               f"from rank {src} do not fill its layout")
        buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pin)
        if nbytes:
            self.dist.irecv(buf, src, group=self.group.group, tag=tg).wait()
        self.stats[payload_class(stream)]["wait_s"] += \
            time.perf_counter() - t0
        offset = [0]

        def leaf(dtype, shape):
            out = torch.empty(shape, dtype=dtype, device=self.device)
            n = out.numel() * out.element_size()
            _as_bytes(out).copy_(buf[offset[0]:offset[0] + n],
                                 non_blocking=self.pin)
            offset[0] += n
            return out
        wire = _rebuild(layout["wire"], leaf)
        proto = None if layout["proto"] is None else _rebuild(
            layout["proto"],
            lambda dt, shp: torch.empty(shp, dtype=dt, device="meta"))
        return (micro, stage), wire, proto

    def finish(self) -> None:
        """Wait for every send; raise if a payload never left or landed."""
        self.check_posted(-1)
        self.wait_sends()
        if self.local:
            raise RuntimeError(f"payloads never landed: {sorted(self.local)}")


def _stream_tag(stream: str) -> int:
    """The message tag of a stream: the same on every rank."""
    return zlib.crc32(stream.encode()) & 0x7FFFFFFF
