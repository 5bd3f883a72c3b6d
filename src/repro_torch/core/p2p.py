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
  ``.to(device)``, a no-op when every stage sits on one card; autograd
  sees one graph through it.
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
``portal``, ``stream``, and, outside the plan's classes, ``embed`` for the
step's tied-embedding exchange and ``token`` for the token a server's last
rank sends rank 0 each decode step), the hops this rank sent, their
payload bytes (the wire tree's leaves: what ``core/wire.plan_wire_report``
prices) and the host-clock seconds this rank waited on sends and receives
of the class.

Autograd across processes (:class:`Backprop`, the forward executor under
grad): a payload whose leaves require grad leaves a *sink* on its sender,
a 0-d tensor whose backward waits for the payload's cotangent from the
destination and hands it to the wire tree's leaves; on the receiver the
leaves are the outputs of an *arrival* node whose backward ships their
cotangent back on the payload's cotangent stream (``b`` for ``f``,
``g:<route>`` for ``r:<route>``), tagged like the payload.  The cotangent
of a wire tree travels in the wire's dtype (a bf16 wire's cotangent is
bf16), as autograd transposes the casts around the hop.  Each rank
differentiates its loss (the last rank) together with its sinks; its
engine visits micro-batches in descending order, as one process's does
stage by stage, so every sum folds in the single-process order.
"""
from __future__ import annotations

import json
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

Tag = Tuple[int, int]                 # (micro, global stage)

#: payload classes a rank counts; the first three are plan_wire_report's
CLASSES = ("chain", "cotangent", "portal", "stream", "embed", "token")


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
    if stream == "tok":
        return "token"
    return "embed"


def cotangent_stream(stream: str) -> str:
    """The stream a payload's cotangent travels back on."""
    if stream == "f":
        return "b"
    if stream.startswith("r:"):
        return "g:" + stream[2:]
    raise ValueError(f"stream {stream!r} carries no cotangent")


@dataclass
class PipeGroup:
    """One pipe rank's view of its process group (the ``pipe`` axis of
    :func:`repro_torch.launch.mesh.init_mesh_groups`'s mesh view, or of
    ``init_pipe_group``'s): its rank, the
    group's size (the pipe degree), the device its stages run on, the
    ``torch.distributed`` group the hops use and ``peers``, the global
    rank of every pipe rank (empty: the pipe group is the world, pipe rank
    ``r`` is global rank ``r``).  ``torch.distributed``'s point-to-point
    calls and ``broadcast`` name global ranks: :meth:`glob` maps."""
    rank: int
    size: int
    device: torch.device
    group: Any = None                 # None: the default (world) group
    peers: Tuple[int, ...] = ()

    @property
    def first(self) -> bool:
        return self.rank == 0

    @property
    def last(self) -> bool:
        return self.rank == self.size - 1

    def glob(self, r: int) -> int:
        """The global rank of pipe rank ``r``."""
        return self.peers[r] if self.peers else r


@dataclass
class AxisGroup:
    """One mesh axis as this rank sees it
    (:func:`repro_torch.launch.mesh.init_mesh_groups`): its coordinate on
    the axis, the axis's size, the ``torch.distributed`` group of the ranks
    that differ from this one on the axis alone (None at size 1) and their
    global ranks by coordinate.

    Its collectives move every rank's tensor through the host (gloo takes
    host tensors; a leaf crosses as its bytes, so any dtype does) and fold
    in coordinate order, so every rank that holds a result gets the same
    bits, whatever order gloo's own reductions would take.  Each call is
    counted under its class in :attr:`stats`: ``calls``, ``bytes`` (what
    this rank received from its peers in a call, summed) and ``wait_s``
    (the host clock inside the call)."""
    name: str
    rank: int
    size: int
    device: torch.device
    group: Any = None
    peers: Tuple[int, ...] = ()
    stats: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def gather(self, x: torch.Tensor, cls: str) -> List[torch.Tensor]:
        """Every rank's ``x`` (one shape and dtype on all), in coordinate
        order, on ``x``'s device; this rank's is ``x`` itself."""
        if self.size == 1:
            return [x]
        import torch.distributed as dist
        t0 = time.perf_counter()
        x = x.detach()
        host = _as_bytes(x.contiguous()).cpu()
        parts = [torch.empty_like(host) for _ in range(self.size)]
        dist.all_gather(parts, host, group=self.group)
        out = [x if r == self.rank else parts[r].to(x.device).view(
            x.dtype).reshape(x.shape) for r in range(self.size)]
        self._count(cls, (self.size - 1) * host.numel(), t0)
        return out

    def _count(self, cls: str, nbytes: int, t0: float) -> None:
        st = self.stats.setdefault(cls, {"calls": 0, "bytes": 0,
                                         "wait_s": 0.0})
        st["calls"] += 1
        st["bytes"] += nbytes
        st["wait_s"] += time.perf_counter() - t0

    def sum(self, x: torch.Tensor, cls: str, *,
            mean: bool = False) -> torch.Tensor:
        """The sum (``mean``: the mean) of every rank's ``x``, folded in
        fp32 in coordinate order and cast back to ``x``'s dtype."""
        if self.size == 1:
            return x
        parts = self.gather(x, cls)
        acc = parts[0].float()
        for p in parts[1:]:
            acc = acc + p.float()
        if mean:
            acc = acc / self.size
        return acc.to(x.dtype)

    def reduce_scatter(self, x: torch.Tensor, dim: int, cls: str, *,
                       mean: bool = False) -> torch.Tensor:
        """This rank's block (``x`` split evenly along ``dim``) of the sum
        (``mean``: the mean) of every rank's ``x``: each rank sends every
        peer that peer's block (one all-to-all through the host) and folds
        the blocks it receives in fp32 in coordinate order, cast back to
        ``x``'s dtype; the bits are those of :meth:`sum`'s block."""
        if self.size == 1:
            return x
        import torch.distributed as dist
        t0 = time.perf_counter()
        blocks = [b.contiguous() for b in x.detach().chunk(self.size, dim)]
        host = torch.cat([_as_bytes(b) for b in blocks]).cpu()
        got = torch.empty_like(host)
        dist.all_to_all_single(got, host, group=self.group)
        mine = blocks[self.rank]
        n = host.numel() // self.size
        acc = None
        for r in range(self.size):
            p = mine if r == self.rank else got[r * n:(r + 1) * n].to(
                x.device).view(x.dtype).reshape(mine.shape)
            acc = p.float() if acc is None else acc + p.float()
        if mean:
            acc = acc / self.size
        self._count(cls, (self.size - 1) * n, t0)
        return acc.to(x.dtype)

    def cat(self, x: torch.Tensor, dim: int, cls: str) -> torch.Tensor:
        """Every rank's block of a tensor split evenly along ``dim``, joined:
        the whole tensor."""
        if self.size == 1:
            return x
        return torch.cat(self.gather(x, cls), dim)

    def block(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``x`` split evenly along ``dim``."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)


def hop_node(wire):
    """The payload behind one autograd node (a view), as a pipe group's
    sink is: the cotangents of its uses on the destination sum before they
    meet the sender's other uses of the value, so that one process sums in
    the order the ranks must.  That order is not the plain graph's: at
    pipe 4 whisper-tiny's gradients move by a few ulp
    (``tests/test_torch_whisper.py::test_gpipe_hop_node_order``)."""
    return tree_map(lambda a: a.view_as(a) if a.requires_grad else a, wire)


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
        if src != dst and torch.is_grad_enabled():
            wire = hop_node(wire)
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
        # cotangents that landed before the backward asked for them
        self.early: Dict[Tuple[str, int], Dict[Tag, Any]] = {}
        self.backprop: Optional["Backprop"] = None   # set under grad
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
        grad = []
        if self.backprop is not None:        # the cotangent comes back
            leaves = tree_leaves(wire)
            grad = [k for k, a in enumerate(leaves) if a.requires_grad]
            if grad:
                self.backprop.sink(cotangent_stream(stream), dst, tag,
                                   [leaves[k] for k in grad])
        if not self.latch:
            self._send(stream, dst, tag, wire, proto, grad)
            return
        if stream in self.latched:
            raise RuntimeError(f"stream {stream}: the send register of rank "
                               f"{self.rank} is latched twice in one tick")
        self.wait(stream)                       # the register is reused
        self.latched[stream] = (dst, tag, (wire, proto, grad))

    def post(self, stream: str) -> None:
        """mpmd: send what the stream latched on the previous tick."""
        if stream not in self.latched:
            raise RuntimeError(f"stream {stream}: the plan ships from rank "
                               f"{self.rank} but nothing was latched")
        dst, tag, (wire, proto, grad) = self.latched.pop(stream)
        self._send(stream, dst, tag, wire, proto, grad)

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

    def send_cotangent(self, stream: str, dst: int, tag: Tag, tree) -> None:
        """Post a payload's cotangent (``{str(leaf index): tensor}``, the
        leaves that got one) back to its sender, tagged like the payload;
        :meth:`finish` waits for it."""
        self._send(stream, dst, tag, tree, None)

    def recv_cotangent(self, stream: str, src: int, tag: Tag):
        """The cotangent tagged ``tag`` from ``src``: taken from those that
        landed early, or received, parking any other that lands first."""
        early = self.early.setdefault((stream, src), {})
        while tag not in early:
            got, tree, _ = self.recv_tree(stream, src)
            if got in early:
                raise RuntimeError(f"stream {stream}: two cotangents for "
                                   f"{got} from rank {src}")
            early[got] = tree
        return early.pop(tag)

    def _send(self, stream, dst, tag, wire, proto, grad=()) -> None:
        leaves = tree_leaves(wire)
        layout = json.dumps({"wire": _layout(wire),
                             "proto": None if proto is None
                             else _layout(proto), "grad": list(grad)})
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
        peer = self.group.glob(dst)
        works = [self.dist.isend(x, peer, group=self.group.group, tag=tg)
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
        tag, wire, proto, grad = self._recv(stream, src)
        if grad and self.backprop is not None:
            wire = Arrival(self.backprop, cotangent_stream(stream), src, tag,
                           wire, grad)
        return tag, wire, proto

    def recv_tree(self, stream: str, src: int):
        """Receive one payload from ``src``: ``(tag, wire, proto)``."""
        return self._recv(stream, src)[:3]

    def _recv(self, stream: str, src: int):
        """One payload from ``src``, and the indices of the wire leaves
        whose sender waits for their cotangent."""
        tg = _stream_tag(stream)
        peer = self.group.glob(src)
        t0 = time.perf_counter()
        pre = torch.empty(4, dtype=torch.int64)
        self.dist.irecv(pre, peer, group=self.group.group, tag=tg).wait()
        micro, stage, hlen, nbytes = (int(x) for x in pre.tolist())
        key = (stream, src, stage)
        if hlen:
            hbuf = torch.empty(hlen, dtype=torch.uint8)
            self.dist.irecv(hbuf, peer, group=self.group.group, tag=tg).wait()
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
            self.dist.irecv(buf, peer, group=self.group.group, tag=tg).wait()
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
        return (micro, stage), wire, proto, layout.get("grad", [])

    def finish(self) -> None:
        """Wait for every send; raise if a payload never left or landed."""
        self.check_posted(-1)
        self.wait_sends()
        if self.local:
            raise RuntimeError(f"payloads never landed: {sorted(self.local)}")
        stray = {k: sorted(v) for k, v in self.early.items() if v}
        if stray:
            raise RuntimeError(f"cotangents nobody asked for: {stray}")


# ---------------------------------------------------------------------------
# Autograd across processes
# ---------------------------------------------------------------------------

class _Sink(torch.autograd.Function):
    """On the sender: a 0-d stand-in for the leaves it shipped, whose
    backward waits for their cotangent."""

    @staticmethod
    def forward(ctx, bp, key, *leaves):
        ctx.bp, ctx.key, ctx.n = bp, key, len(leaves)
        return torch.zeros((), dtype=torch.float32, device=leaves[0].device)

    @staticmethod
    def backward(ctx, _):
        return (None, None) + tuple(ctx.bp._wait(ctx.key, ctx.n))


class _Arrive(torch.autograd.Function):
    """On the receiver: the landed leaves as outputs of a node whose
    backward ships their cotangent to the sender."""

    @staticmethod
    def forward(ctx, bp, rec, anchor, *leaves):
        ctx.bp, ctx.rec = bp, rec
        ctx.set_materialize_grads(False)       # an unused leaf ships none
        return leaves

    @staticmethod
    def backward(ctx, *grads):
        ctx.bp._ship(ctx.rec, grads)
        return (None, None, None) + (None,) * len(grads)


class Arrival:
    """A payload that landed under grad, parked as it came: its arrival
    node is made by :meth:`resolve`, at the read that consumes it, so
    that on the receiver's engine it runs right after that task's stage
    (the order :class:`Backprop` relies on)."""

    def __init__(self, bp: "Backprop", stream: str, src: int, tag: Tag,
                 wire, grad: Sequence[int]):
        self.bp, self.stream, self.src, self.tag = bp, stream, src, tag
        self.wire, self.grad = wire, list(grad)

    def resolve(self):
        """The wire tree, its leaves that carry a cotangent differentiable."""
        leaves = tree_leaves(self.wire)
        outs = dict(zip(self.grad, self.bp.arrive(
            self.stream, self.src, self.tag,
            [leaves[k] for k in self.grad])))
        it = iter(range(len(leaves)))
        return tree_map(lambda a: outs.get(next(it), a), self.wire)


class Backprop:
    """One differentiable forward call's reverse clock-cycle.

    Pass one to the forward executor (``pipeline_call``'s ``call(...,
    backprop=bp)``) under grad, then :meth:`grad`.  In one process it is
    ``torch.autograd.grad``.  In a pipe group the executor's
    :class:`P2PHop` registers a sink for every payload it sent and an
    arrival for every payload it received (module docstring), and
    :meth:`grad` differentiates the rank's roots with its sinks, so the
    engine blocks on a sink until its cotangent lands and ships each
    arrival's cotangent as soon as its consumers are done.

    An arrival whose leaves nothing on its rank used never runs its
    backward; its sender still waits, so it ships an empty cotangent
    instead (the sender adds nothing, as one process's autograd would):
    when the rank's engine reaches an earlier micro-batch, or at the end.
    That relies on the engine visiting micro-batches in descending order:
    it runs ready nodes by descending sequence number, and an arrival is
    made at the read that consumes it (:class:`Arrival`), after every
    node of the earlier micro-batches.  A backward that comes back to a
    later micro-batch raises."""

    def __init__(self):
        self.hop: Optional[P2PHop] = None
        self.anchor: Optional[torch.Tensor] = None
        self.sinks: List[torch.Tensor] = []
        self.arrivals: List[Dict[str, Any]] = []
        self.reached: Optional[int] = None    # the micro-batch backward is at

    def attach(self, hop: P2PHop) -> None:
        if self.hop is not None:
            raise RuntimeError("a Backprop serves one forward call")
        self.hop, hop.backprop = hop, self
        # the arrivals' common input: asking for its gradient makes the
        # engine run every arrival that a root reaches
        self.anchor = torch.zeros((), device=hop.device, requires_grad=True)

    def sink(self, stream: str, src: int, tag: Tag, leaves) -> None:
        """A payload left for ``src`` (as ``tag``); its cotangent comes
        back from there on ``stream``."""
        self.sinks.append(_Sink.apply(self, (stream, src, tag), *leaves))

    def arrive(self, stream: str, dst: int, tag: Tag, leaves):
        """A payload landed from ``dst``: its leaves, differentiable,
        whose cotangent goes back to ``dst`` on ``stream``."""
        rec = {"stream": stream, "dst": dst, "tag": tag, "fired": False}
        self.arrivals.append(rec)
        return _Arrive.apply(self, rec, self.anchor, *leaves)

    def _ship(self, rec, grads) -> None:
        self._reach(rec["tag"][0])
        if rec["fired"]:
            raise RuntimeError(f"the cotangent of {rec['tag']} on stream "
                               f"{rec['stream']} came after it was given up")
        rec["fired"] = True
        self.hop.send_cotangent(rec["stream"], rec["dst"], rec["tag"],
                                {str(k): g.contiguous()
                                 for k, g in enumerate(grads)
                                 if g is not None})

    def _wait(self, key, n: int):
        stream, src, tag = key
        self._reach(tag[0])
        tree = self.hop.recv_cotangent(stream, src, tag)
        return [tree.get(str(k)) for k in range(n)]

    def _reach(self, micro: int) -> None:
        """The backward is at ``micro``: it may not go back to a later
        micro-batch, whose unfired arrivals are given up here."""
        if self.reached is not None and micro > self.reached:
            raise RuntimeError(
                f"the backward came back to micro-batch {micro} after "
                f"micro-batch {self.reached}: the arrivals of the later "
                "micro-batches were given up on the assumption that "
                "autograd visits micro-batches in descending order")
        self.reached = micro
        self._flush(micro)

    def _flush(self, micro: Optional[int] = None) -> None:
        """Ship an empty cotangent for every arrival of a later micro-batch
        than ``micro`` (of every one, with None) whose backward has not
        run: nothing on this rank used it."""
        for rec in self.arrivals:
            if not rec["fired"] and (micro is None or rec["tag"][0] > micro):
                rec["fired"] = True
                self.hop.send_cotangent(rec["stream"], rec["dst"],
                                        rec["tag"], {})

    def grad(self, roots: Sequence[torch.Tensor], inputs: Sequence[Any],
             seeds: Optional[Sequence[Any]] = None) -> List[torch.Tensor]:
        """The gradients of ``roots`` (seeded by ``seeds``, default ones)
        with respect to ``inputs``, zeros where unused.  In a pipe group
        ``roots`` are this rank's (the loss on the last rank, none
        elsewhere): its sinks join them, and every cotangent it owes is
        shipped and sent before this returns."""
        roots, inputs = list(roots), list(inputs)
        seeds = list(seeds) if seeds is not None else [None] * len(roots)
        outs = roots + self.sinks
        wrt = inputs + ([self.anchor] if self.anchor is not None else [])
        if outs:
            g = torch.autograd.grad(outs, wrt,
                                    seeds + [None] * len(self.sinks),
                                    allow_unused=True, materialize_grads=True)
        else:
            g = [torch.zeros_like(x) for x in wrt]
        if self.hop is not None:
            self._flush()
            self.hop.finish()
        return list(g[:len(inputs)])


def group_loss(group: PipeGroup, loss):
    """The last rank's loss on every rank (0-d fp32 on its device; the
    others pass anything, None included)."""
    if group.size == 1:
        return loss
    import torch.distributed as dist
    buf = (loss.detach().float().reshape(1).cpu() if group.last
           else torch.zeros(1, dtype=torch.float32))
    dist.broadcast(buf, src=group.glob(group.size - 1), group=group.group)
    return loss if group.last else buf[0].to(group.device)


def _stream_tag(stream: str) -> int:
    """The message tag of a stream: the same on every rank."""
    return zlib.crc32(stream.encode()) & 0x7FFFFFFF
