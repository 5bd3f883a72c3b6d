"""Pipeline executors on torch tensors: the GPipe forward clock-cycle (paper
Algorithm 1) and the fused F+B scheduler.

Counterpart of :mod:`repro.core.pipeline`.  Both executors run the SAME
plans the JAX executor lowers (:func:`repro_torch.core.plan.plan_for`): on
tick ``t`` rank ``r`` runs the task in ``kind[t, r]`` on micro-batch
``micro[t, r]``, touching its chunk ``chunk[t, r]`` (global stage
``chunk * R + r``); a boundary activation shipped at the end of tick
``t - 1`` parks in slot ``park_recv[t, r]`` and the tasks of that stage read
slot ``park_read[t, r]``.  The plan's columns are read directly each tick:
there are no segments, switches or masks, and the tick loop runs every
rank in one process, or one rank in each process of a pipe group.

Placement follows torchgpipe: ``devices[s]`` holds global stage ``s`` and
the boundary hop is ``.to(devices[s + 1])``, a no-op when every stage sits
on one card.

Forward-only plans (``gpipe_fwd``, :func:`pipeline_call`): resident state
(KV caches) is read and updated on each rank's forward ticks, per
micro-batch.  Training (``schedule="gpipe"``): with grad mode on, each
forward tick's stage application is wrapped by
:func:`repro_torch.core.checkpointing.wrap_stage_for_micro` under
``cfg.remat`` (every micro-batch unless ``cfg.remat_last_micro`` is False,
paper §2.1) and autograd induces the reverse clock-cycle, recomputing each
stage forward right before its backward.  Serving callers hold
``torch.inference_mode()`` themselves.

F+B plans (``gpipe_tasked`` / ``1f1b`` / ``interleaved:v`` / ``zb``,
:func:`pipeline_grad_call`): backward tasks run inside the tick loop.  An F
tick runs the stage under ``torch.no_grad()`` and keeps nothing but its
parked input (on the last stage it runs nothing: its output would only feed
the loss, which the B tick's graph computes and records); a fused B tick
re-reads that input, re-runs the stage (and the loss on the last stage)
with grad and calls ``torch.autograd.grad``
seeded by the cotangent parked in its b-inbox slot: the paper's
Checkpoint/Recompute pairing, one stage and one micro-batch at a time.
That is what bounds each stage's stash at ``min(n - j, m)`` under 1F1B.
``zb`` splits B into Bx (input cotangents, shipped at once) and Bw (weight
gradients, re-seeded from the still-parked inbox slot): each re-runs the
stage under ``residuals="recompute"``; under ``"reuse"`` Bx keeps its graph
in the residual slot the plan allocates and Bw differentiates that graph
(:func:`repro_torch.core.checkpointing.wrap_for_residuals`).

Skip routes (paper §3.3, :class:`repro_torch.core.plan.RoutePlan`) run in
both executors.  A stage returns a skip in ``skips_out``; on its ``send``
tick the value ships to the next rank of its route (the destination for a
portal, the next stage for a threaded hop, which the relay re-ships on its
own F tick), parks in the route's slot on arrival and reaches the consuming
stage as ``skips_in[name]`` on the forward and on every backward that
re-runs it.  Under autograd the skip is an input and an output of the
checkpointed stage function; the fused executor ships the skip's
cotangent back on the route's ``g_`` columns and seeds the producer's
backward with it (summed in route order over a skip's destinations).

``stage_params`` is a tree stacked ``[n_stages, ...]`` (homogeneous
stages) or a sequence of ``n_stages`` trees (heterogeneous stages, each
its own structure); gradients come back in the same form.

Stream injection (``cfg.stream_inputs``, :class:`_Stream`): the
micro-batches are sharded over the ranks (micro-batch ``i`` on rank
``i % R``, slot ``i // R``), stage 0 reads rank 0's shard at the plan's
``stream_slot`` and every shard moves one rank towards 0 after each
``stream_rot`` tick; the fused executor parks each F tick's fresh slice in
the plan's ``fs_slot`` for its backward.  The wire codec
(``cfg.wire``, :class:`_Wire`) encodes each payload where a rank ships it
and decodes it where it lands: the forward chain, the cotangent chain, and
each route's values and cotangents, on the hops that cross ranks.

Hops (:mod:`repro_torch.core.p2p`): by default every stage runs in this
process and a hop is ``.to()``.  Given a pipe group
(:mod:`repro_torch.launch.mesh`), either executor runs one rank's column
of the plan in each process and a hop to another rank is a
``torch.distributed`` message of the wire tree, sent eagerly
(``executor="spmd"``) or latched one tick ahead (``"mpmd"``).  Serving
keeps each rank's own stages' caches; under autograd the forward
executor's hops carry their cotangents back (:class:`p2p.Backprop`), so
autograd's reverse clock-cycle crosses the processes.

Either executor runs one data-parallel replica of one model shard: the
mesh's other axes (data, FSDP, ``tp``) live in the model and the step
(``models.lm``, ``launch.steps``).  What raises: an ``int8-ef`` wire under
autograd in the forward executor (:func:`check_plan`).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.core import checkpointing, p2p
from repro_torch.core import plan as plan_lib
from repro_torch.core.plan import BWD, BWD_W, BWD_X, FWD, NOP
from repro_torch.core.skip import SkipSpec
from repro_torch.devices import stage_devices
from repro_torch.runtime import compression
from repro_torch.tree import tree_leaves, tree_map


@dataclass
class TickCtx:
    """Per-tick context handed to the stage function."""
    stage: int                # GLOBAL stage index (chunk * n_ranks + rank)
    micro: int                # micro-batch index of this rank's task
    valid: bool               # a real (scheduled) task
    t: int                    # tick counter
    fresh: Any                # stage 0's input tree slice; None elsewhere
    n_stages: int             # GLOBAL stage count (n_ranks * n_chunks)
    n_micro: int


# StageApplyFn signature:
#   stage_apply(stage_params, carry, skips_in: dict, resident, ctx: TickCtx)
#       -> (carry_out, skips_out: dict, resident_out)
# ``carry`` is None on stage 0, which reads ``ctx.fresh`` instead.
StageApplyFn = Callable[..., Tuple[Any, Dict[str, Any], Any]]


def check_plan(tplan: plan_lib.TaskPlan, cfg: ParallelConfig, *,
               autograd: bool = False) -> None:
    """Raise for what the executors refuse to run of a plan.

    * The fused executor streams only when the ranks divide the
      micro-batches (reference ``pipeline_grad_call``): a streamed F+B
      plan with ``n_micro % pipe != 0`` raises, where a forward plan
      silently runs unstreamed (:func:`_streaming`).
    * ``autograd``: the forward executor differentiated by autograd
      (``schedule="gpipe"``) refuses an ``int8-ef`` codec on a hop it
      encodes (the forward chain, a route's values).  The reference takes
      that gradient through its quantizer, whose round and int8 cast have
      zero derivative: only the per-block scale carries gradient upstream
      of the hop, so every gradient before it comes out truncated.  The
      fused schedules ship cotangents explicitly and train int8-wired.
    """
    R, m = tplan.n_ranks, tplan.n_micro
    if tplan.has_backward and cfg.stream_inputs and R > 1 and m % R:
        raise ValueError(f"stream_inputs needs n_micro ({m}) divisible by "
                         f"pipe ({R})")
    if autograd and not tplan.has_backward:
        lossy = [name for name, codec in _Wire(tplan).codecs.items()
                 if codec.stateful and (name == "f" or name[:2] == "r:")]
        if lossy:
            raise ValueError(
                f"wire={tplan.wire.name!r} puts int8-ef on the {lossy} "
                "hops of the gpipe forward under autograd: the reference's "
                "autodiff through the quantizer (round and int8 cast have "
                "zero derivative) leaves only the per-block scale's "
                "gradient upstream of a quantized hop, a truncated "
                "gradient the port does not mirror.  Train int8-wired with "
                "a fused schedule (1f1b, gpipe_tasked, interleaved:v, zb), "
                "which ships cotangents explicitly, or use wire='bf16'")


def _streaming(tplan: plan_lib.TaskPlan, cfg: ParallelConfig) -> bool:
    """Whether this run streams its inputs: ``cfg.stream_inputs`` at
    ``pipe > 1`` with the ranks dividing the micro-batches (reference
    ``pipeline_call``: off otherwise)."""
    R = tplan.n_ranks
    return cfg.stream_inputs and R > 1 and tplan.n_micro % R == 0


# ---------------------------------------------------------------------------
# On-the-wire codec: encode where a rank ships, decode where it lands
# ---------------------------------------------------------------------------

WIRE_CODEC_RANGE = "wire_codec"    # profiler range of each lossy encode /
#                                    decode: the codec's device time


def _codec_range():
    """The ``WIRE_CODEC_RANGE`` range while a profiler runs, else nothing
    (a range costs host time on every payload)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(WIRE_CODEC_RANGE)
    return contextlib.nullcontext()


class _Codec:
    """One payload class's wire codec (reference ``_Codec``), leaf-wise over
    a tree.  ``enc(value, ef)`` encodes at the ship and, for the stateful
    ``int8-ef`` codec, returns the new error-feedback residual of the
    stream; ``dec(wire, proto)`` decodes at the arrival to ``proto``'s
    shapes and dtypes.  Non-float leaves (token ids) pass through, and
    ``fp32`` is a strict identity: the wire tree is the value tree, the same
    tensors.  ``bf16`` casts (a no-op on bf16 values); ``int8-ef`` ships
    int8 blocks with one fp32 scale each (``runtime.compression``) and
    keeps what they lose for the stream's next payload."""

    def __init__(self, codec: str, block: int):
        self.codec, self.block = codec, block
        self.stateful = codec == "int8-ef"

    def ef_zeros(self, proto):
        """The cold error-feedback residual: fp32 zeros per float leaf
        (None where the codec is exact)."""
        return tree_map(
            lambda p: compression.ef_zeros_like(p)
            if self.stateful and p.is_floating_point() else None, proto)

    def enc(self, value, ef=None):
        """value tree -> (wire tree, new ef tree)."""
        if self.codec == "fp32":
            return value, ef
        with _codec_range():
            if self.codec == "bf16":
                return tree_map(lambda v: v.to(torch.bfloat16)
                                if v.is_floating_point() else v, value), ef
            pairs = tree_map(self._enc_int8, value, ef)
            return (tree_map(lambda _, p: p[0], value, pairs),
                    tree_map(lambda _, p: p[1], value, pairs))

    def _enc_int8(self, v, e):
        if not v.is_floating_point():
            return v, e
        q, s, _, resid = compression.ef_quantize(v, e, self.block)
        return {"q": q, "s": s}, resid

    def dec(self, wire, proto):
        """wire tree -> value tree (shapes and dtypes of ``proto``)."""
        if self.codec == "fp32":
            return wire
        with _codec_range():
            return tree_map(self._dec_leaf, proto, wire)

    def _dec_leaf(self, p, w):
        if not p.is_floating_point():
            return w
        if self.codec == "bf16":
            return w.to(p.dtype)
        flat = compression._dequantize_block(w["q"], w["s"], p.numel())
        return flat.reshape(p.shape).to(p.dtype)


class _Wire:
    """The wire of one executor run: a codec per stream and the ``int8-ef``
    residual per (rank, stream).  Streams: ``f`` (the forward chain),
    ``b`` (the cotangent chain), ``r:<route>`` and ``g:<route>`` (a
    route's values and cotangents).  As in the reference, every hop is an
    identity at pipe 1, and a route's value (cotangent) takes the portal
    (cotangent) codec only where its hop crosses ranks.  The residuals are
    cold at each call and advance on real sends only, in tick order."""

    def __init__(self, tplan: plan_lib.TaskPlan):
        spec = tplan.wire
        ident = _Codec("fp32", spec.block)

        def codec(name, crosses):
            return _Codec(name, spec.block) if crosses else ident
        cross = tplan.n_ranks > 1
        self.codecs = {"f": codec(spec.chain, cross),
                       "b": codec(spec.cotangent, cross)}
        for rt in tplan.routes:
            self.codecs["r:" + rt.key] = codec(spec.portal, rt.fwd_perm)
            self.codecs["g:" + rt.key] = codec(spec.cotangent, rt.bwd_perm)
        self.ef: Dict[Tuple[int, str], Any] = {}

    def enc(self, stream: str, r: int, value):
        """What rank ``r`` puts on the wire for ``value``, and the proto
        its arrival decodes to (None for the identity)."""
        codec = self.codecs[stream]
        if codec.codec == "fp32" or (codec.codec == "bf16" and all(
                a.dtype == torch.bfloat16 for a in tree_leaves(value)
                if a.is_floating_point())):
            return value, None                # the identity on this value
        proto = tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype,
                                               device="meta"), value)
        if not codec.stateful:
            return codec.enc(value)[0], proto
        ef = self.ef.get((r, stream))
        if ef is None:
            ef = codec.ef_zeros(value)
        wire, self.ef[(r, stream)] = codec.enc(value, ef)
        return wire, proto

    def dec(self, stream: str, wire, proto):
        return wire if proto is None else self.codecs[stream].dec(wire,
                                                                  proto)


class _FromStream(torch.autograd.Function):
    """Stage 0's streamed input on rank 0 of a pipe group under autograd:
    forward the value the shard rotations brought (``landed``, an exact
    copy), backward its cotangent to the slice of rank 0's own inputs it
    was cut from (``origin``).  Stage 0, the stream's one reader, runs on
    rank 0, which holds those inputs: the cotangents never travel."""

    @staticmethod
    def forward(ctx, landed, origin):
        return landed.clone()

    @staticmethod
    def backward(ctx, g):
        return None, g


class _Stream:
    """Stream injection (reference ``cfg.stream_inputs``): the ``[m, ...]``
    inputs sharded over the R ranks, micro-batch ``i`` on rank ``i % R``
    at slot ``i // R`` (rank ``r``'s shard is ``[m // R, ...]`` on
    ``devices[r]``).  Stage 0 reads rank 0's shard at the plan's
    ``stream_slot``; after each ``stream_rot`` tick every shard moves one
    rank towards 0, so micro-batch ``i`` reaches rank 0 after ``i``
    rotations.  The hop hands the shards out and rotates them
    (:mod:`repro_torch.core.p2p`): in a pipe group each process holds
    only its own rank's shard, and rank 0 alone is given the inputs."""

    def __init__(self, inputs_mb, n_ranks: int, hop):
        self.R, self.hop = n_ranks, hop
        self.origin = list(range(n_ranks))   # the rank each shard began on
        split = None if inputs_mb is None else tree_map(
            lambda a: a.reshape((a.shape[0] // n_ranks, n_ranks)
                                + tuple(a.shape[1:])).transpose(0, 1),
            inputs_mb)
        self.shards = hop.scatter_shards(split)

    def read(self, t: int, tplan: plan_lib.TaskPlan, micro: int):
        slot = int(tplan.stream_slot[t])
        if slot < 0 or slot * self.R + self.origin[0] != micro:
            raise RuntimeError(f"tick {t}: stage 0 wants micro-batch {micro}"
                               f", the stream holds slot {slot} of the "
                               f"shard that began on rank {self.origin[0]}")
        return tree_map(lambda a: a[slot], self.shards[0])

    def rotate(self) -> None:
        self.shards = self.hop.rotate_shards(self.shards)
        self.origin = self.origin[1:] + self.origin[:1]


class _Slots:
    """One plan-addressed buffer family (park, b-inbox, residual stash, a
    route's values or cotangents) for the ranks this process runs: per
    rank, slot -> (tag, value), with the high-water mark of slots held at
    once.  The tag (micro, global stage) catches a plan/executor mismatch
    at the read."""

    def __init__(self, name: str, ranks: Sequence[int]):
        self.name = name
        self.slots: Dict[int, Dict[int, Tuple[Tuple[int, int], Any]]] = {
            r: {} for r in ranks}
        self.high = {r: 0 for r in ranks}

    def put(self, r: int, slot: int, tag: Tuple[int, int], value) -> None:
        if slot in self.slots[r]:
            raise RuntimeError(f"{self.name} slot {slot} of rank {r} still "
                               f"holds {self.slots[r][slot][0]}, {tag} "
                               "arrives")
        self.slots[r][slot] = (tag, value)
        self.high[r] = max(self.high[r], len(self.slots[r]))

    def get(self, r: int, slot: int, tag: Tuple[int, int], release: bool):
        held = self.slots[r].pop(slot) if release else self.slots[r][slot]
        if held[0] != tag:
            raise RuntimeError(f"{self.name} slot {slot} of rank {r} holds "
                               f"{held[0]}, the task wants {tag}")
        return held[1].value() if isinstance(held[1], _Landed) else held[1]

    def highs(self) -> Tuple[int, ...]:
        """High-water per rank, in rank order."""
        return tuple(self.high[r] for r in sorted(self.high))

    def check_empty(self) -> None:
        if any(self.slots.values()):
            raise RuntimeError(f"{self.name} slots still hold values after "
                               f"the last tick: {self.slots}")


class _Landed:
    """A payload parked as it landed under grad in a pipe group
    (:class:`p2p.Arrival`): its arrival node and its decode run at the
    read that consumes it (a forward executor read releases its slot)."""

    def __init__(self, link: "_Link", wire, proto):
        self.link, self.wire, self.proto = link, wire, proto

    def value(self):
        return self.link.wire.dec(self.link.stream, self.wire.resolve(),
                                  self.proto)


class _Link:
    """The hop into one buffer family: what a rank ships on tick ``t``
    parks on tick ``t + 1`` in the slot the plan's column names on the
    destination rank, on the device of its tag's stage.  The value rides
    the hop (:mod:`repro_torch.core.p2p`) as its stream's codec encodes
    it; ``src_of(r)`` is the rank an arrival on ``r`` comes from."""

    def __init__(self, buf: _Slots, wire: _Wire, stream: str, hop,
                 src_of: Callable[[int], int]):
        self.buf, self.wire, self.stream = buf, wire, stream
        self.hop, self.src_of = hop, src_of

    def ship(self, src: int, dst: int, tag: Tuple[int, int], value) -> None:
        self.hop.put(self.stream, src, dst, tag,
                     *self.wire.enc(self.stream, src, value))

    def land(self, t: int, column) -> None:
        for r in self.hop.ranks:
            slot = int(column[t, r])
            item = self.hop.take(self.stream, self.src_of(r), r,
                                 expect=slot >= 0)
            if item is not None:
                tag, wire, proto = item
                self.buf.put(r, slot, tag,
                             _Landed(self, wire, proto)
                             if isinstance(wire, p2p.Arrival)
                             else self.wire.dec(self.stream, wire, proto))


class _Route:
    """One skip route (:class:`plan_lib.RoutePlan`) in the tick loop: the
    value parks on its way src -> (relays) -> dst, the cotangent on its
    way back.  The hop goes to the rank the plan's permute pairs name, or
    stays on the rank (src and dst chunks of one rank: an identity hold)."""

    def __init__(self, rt: plan_lib.RoutePlan, wire: _Wire, hop):
        self.rt = rt
        self.next_rank = {False: dict(rt.fwd_perm), True: dict(rt.bwd_perm)}
        prev = {cot: {d: s for s, d in pairs.items()}
                for cot, pairs in self.next_rank.items()}
        self.value = _Link(_Slots(f"route {rt.key}", hop.ranks), wire,
                           "r:" + rt.key, hop,
                           lambda r: prev[False].get(r, r))
        self.cot = _Link(_Slots(f"route {rt.key} cotangent", hop.ranks),
                         wire, "g:" + rt.key, hop,
                         lambda r: prev[True].get(r, r))

    def land(self, t: int) -> None:
        self.value.land(t, self.rt.recv)
        self.cot.land(t, self.rt.g_recv)

    def post(self, t: int, r: int, hop) -> None:
        """mpmd: send the value and cotangent rank ``r`` latched on tick
        ``t - 1``, where the plan's ``ship`` / ``g_ship`` columns say a
        hop leaves at the top of tick ``t`` (a hold on the rank itself
        stays in the local outbox)."""
        rt = self.rt
        for cot, ship, send, link in ((False, rt.ship, rt.send, self.value),
                                      (True, rt.g_ship, rt.g_send,
                                       self.cot)):
            if ship[t] and send[t - 1, r] != -1 \
                    and self.next_rank[cot].get(r, r) != r:
                hop.post(link.stream)

    def read(self, t: int, r: int, tag, release: bool, cot: bool = False):
        """The parked value (cotangent) this tick's task reads, or None."""
        slot = int((self.rt.g_read if cot else self.rt.read)[t, r])
        if slot < 0:
            return None
        return (self.cot if cot else self.value).buf.get(r, slot, tag,
                                                         release)

    def send(self, t: int, r: int, micro: int, stage: int, produced,
             cot: bool = False) -> bool:
        """Ship what the plan's send column says on tick ``t``: this task's
        own value (``produced[name]``: a skip output, or the cotangent of a
        skip input) or, on a threaded relay, the one parked in a slot.
        Returns whether it shipped ``produced[name]``."""
        rt = self.rt
        slot = int((rt.g_send if cot else rt.send)[t, r])
        if slot == -1:
            return False
        link = self.cot if cot else self.value
        if slot == plan_lib.SEND_STAGE:
            if rt.name not in produced:
                raise RuntimeError(f"tick {t}: stage {stage} ships skip "
                                   f"{rt.name!r} but did not produce it")
            value = produced[rt.name]
        else:
            value = link.buf.get(r, slot, (micro, stage), release=True)
        if rt.threaded:
            nxt = stage - 1 if cot else stage + 1
        else:
            nxt = rt.src if cot else rt.dst
        link.ship(r, self.next_rank[cot].get(r, r), (micro, nxt), value)
        return slot == plan_lib.SEND_STAGE

    def check_empty(self) -> None:
        self.value.buf.check_empty()
        self.cot.buf.check_empty()

    def high(self, backward: bool) -> Dict[str, int]:
        """High-water over this process's ranks: the plan's ``depth`` (and
        ``g_depth``) when it runs them all."""
        out = {"depth": max(self.value.buf.highs())}
        if backward:
            out["g_depth"] = max(self.cot.buf.highs())
        return out


def _skips_in(routes: Sequence[_Route], t: int, r: int, tag,
              release: bool) -> Dict[str, Any]:
    """The skips this tick's task consumes, by name."""
    out: Dict[str, Any] = {}
    for route in routes:
        value = route.read(t, r, tag, release)
        if value is not None:
            if route.rt.name in out:
                raise RuntimeError(f"tick {t}: rank {r} reads skip "
                                   f"{route.rt.name!r} twice")
            out[route.rt.name] = value
    return out


def _skip_seeds(routes: Sequence[_Route], t: int, r: int, tag,
                release: bool) -> Dict[str, Any]:
    """The cotangents that seed this backward's skip outputs, by name; a
    skip with several destinations sums them in the plan's route order."""
    out: Dict[str, Any] = {}
    for route in routes:
        g = route.read(t, r, tag, release, cot=True)
        if g is not None:
            name = route.rt.name
            out[name] = g if name not in out else tree_map(torch.add,
                                                           out[name], g)
    return out


def _send_skips(routes: Sequence[_Route], t: int, r: int, micro: int,
                stage: int, skips_out: Dict[str, Any]) -> None:
    """Ship the skip outputs and relays of a forward tick; a skip output no
    route carries from here raises (declare it as a ``SkipSpec``)."""
    shipped = {route.rt.name for route in routes
               if route.send(t, r, micro, stage, skips_out)}
    stray = sorted(set(skips_out) - shipped)
    if stray:
        raise RuntimeError(f"tick {t}: stage {stage} returned skips {stray} "
                           "that no route ships from it: declare each as a "
                           "SkipSpec")


def _hop(tplan: plan_lib.TaskPlan, cfg: ParallelConfig, devices,
         group: Optional[p2p.PipeGroup]):
    """``(devices, hop)`` of one executor call: one device per global
    stage and the in-process outbox, or, in a pipe group, the group's
    device for every stage and the message hop under ``cfg.executor``."""
    R, S = tplan.n_ranks, tplan.n_stages
    if group is None:
        devices = stage_devices(devices, S)
        return devices, p2p.LocalHop(R, devices)
    if group.size != R:
        raise ValueError(f"plan is for pipe={R}; the group has "
                         f"{group.size} ranks")
    return [group.device] * S, p2p.P2PHop(group, cfg.executor)


def _post_latched(hop, tplan: plan_lib.TaskPlan, routes, t: int,
                  me: int) -> None:
    """mpmd: what rank ``me`` latched on tick ``t - 1`` leaves now, where
    the plan's send columns say (a forward plan's ``b_send_slot`` is
    empty)."""
    if tplan.send_slot[t - 1, me] >= 0:
        hop.post("f")
    if tplan.b_send_slot[t - 1, me] >= 0:
        hop.post("b")
    for route in routes:
        route.post(t, me, hop)
    hop.check_posted(t)


def _stage_trees(stage_params, stages: Sequence[int], devices
                 ) -> Dict[int, Any]:
    """``{s: stage s's parameter tree on devices[s]}`` for the global
    ``stages`` this process runs: the slices of a tree stacked
    ``[len(stages), ...]``, or the trees of a sequence of ``len(stages)``
    (heterogeneous stages), in ``stages`` order."""
    n = len(stages)
    if isinstance(stage_params, (list, tuple)):
        if len(stage_params) != n:
            raise ValueError(f"{len(stage_params)} stage parameter trees "
                             f"for {n} stages")
        return {s: tree_map(lambda a: a.to(devices[s]), stage_params[c])
                for c, s in enumerate(stages)}
    for leaf in tree_leaves(stage_params):
        if leaf.shape[0] != n:
            raise ValueError(f"stacked leaf {tuple(leaf.shape)} does not "
                             f"lead with {n} stages")
    return {s: tree_map(lambda a: a[c].to(devices[s]), stage_params)
            for c, s in enumerate(stages)}


# ---------------------------------------------------------------------------
# Forward-only plans
# ---------------------------------------------------------------------------

def run_pipeline_tasks(stage_apply: StageApplyFn,
                       stage_params,
                       inputs_mb,
                       cfg: ParallelConfig,
                       *,
                       tplan: plan_lib.TaskPlan,
                       devices: Any,
                       resident=None,
                       park_info: Optional[Dict[str, Any]] = None,
                       group: Optional[p2p.PipeGroup] = None,
                       backprop: Optional[p2p.Backprop] = None):
    """Execute one forward-only event plan for a mini-batch.

    ``devices`` is one device per stage (or one for all).
    ``stage_params`` is stacked ``[n_stages, ...]`` (stage ``s``'s slice
    runs on ``devices[s]``) or a sequence of ``n_stages`` trees;
    ``resident`` leaves carry a leading ``[n_stages]`` axis and are updated
    in place by the stage functions.  ``inputs_mb`` leaves are ``[m, ...]``.
    Returns ``(outputs, resident)`` where ``outputs`` is a per-stage list
    holding the ``[m, ...]`` carry tree at the last stage and ``None``
    elsewhere (outputs are valid on the last rank, as in the reference).
    Pass a dict as ``park_info`` to receive ``per_stage_park``, the park
    slots each rank held at once at most in this run, and, with skip
    routes, ``per_route``: each route's slots held at once over its ranks
    (``{route key: {"depth": n}}``).
    With grad mode on, every forward tick runs under ``cfg.remat``
    (:mod:`checkpointing`), skips in and out included, and autograd runs
    backward through the wire's casts (an ``int8-ef`` hop raises,
    :func:`check_plan`); the cotangent class is not used here.  With
    ``cfg.stream_inputs`` and ``m % pipe == 0`` the inputs stream
    (:class:`_Stream`).  F+B plans run through
    :func:`run_pipeline_grad_tasks`.

    With a pipe ``group`` this process runs rank ``group.rank``'s column
    of the plan on ``group.device``, hopping to the other ranks as
    :func:`run_pipeline_grad_tasks` does under ``cfg.executor``'s send
    discipline: ``stage_params`` is this rank's stage (a tree stacked
    ``[1, ...]`` or a sequence of one tree), ``resident`` leaves lead
    with ``[1]``, ``inputs_mb`` is read on rank 0 (None elsewhere) and the
    last rank gets the outputs.  ``park_info`` receives ``rank``,
    ``buffer_slots`` (``{"park": n}``), ``per_route`` and ``hops``.
    Under grad mode pass a :class:`p2p.Backprop` and differentiate with
    its ``grad``: each hop's cotangent comes back through it, counted
    under ``hops["cotangent"]`` as it ships.  Streamed inputs under grad
    rotate as values; rank 0 sends their cotangents to its own inputs
    (:class:`_FromStream`).
    """
    if tplan.has_backward:
        raise ValueError("plans with backward tasks run through "
                         "run_pipeline_grad_tasks (pipeline_grad_call)")
    grad = torch.is_grad_enabled()
    check_plan(tplan, cfg, autograd=grad)
    remat = cfg.remat if grad else "none"
    R, m = tplan.n_ranks, tplan.n_micro
    if (R, m) != (cfg.pipe, cfg.n_micro):
        raise ValueError(f"plan is for pipe={R}, m={m}; config has "
                         f"pipe={cfg.pipe}, n_micro={cfg.n_micro}")
    streaming = _streaming(tplan, cfg)
    devices, hop = _hop(tplan, cfg, devices, group)
    if group is not None and grad:
        if backprop is None:
            raise ValueError("the forward executor under grad in a pipe "
                             "group needs a p2p.Backprop to carry the "
                             "cotangents back")
        backprop.attach(hop)
    mine = list(hop.ranks)                  # one stage per rank here
    resident = {} if resident is None else resident
    params_s = _stage_trees(stage_params, mine, devices)
    for leaf in tree_leaves(resident):
        if leaf.shape[0] != len(mine):
            raise ValueError(f"stacked leaf {tuple(leaf.shape)} does not "
                             f"lead with n_stages={len(mine)}")
    resident_s = {s: tree_map(lambda a: a[c], resident)
                  for c, s in enumerate(mine)}
    for s in mine:
        for leaf in tree_leaves(resident_s[s]):
            if leaf.device != devices[s]:
                raise ValueError(f"resident state of stage {s} lives on "
                                 f"{leaf.device}, stage on {devices[s]}")

    park = _Slots("park", hop.ranks)
    wire = _Wire(tplan)
    chain = _Link(park, wire, "f", hop, lambda r: (r - 1) % R)
    routes = [_Route(rt, wire, hop) for rt in tplan.routes]
    stream = _Stream(inputs_mb, R, hop) if streaming else None
    latch = group is not None and cfg.executor == "mpmd"
    outputs: List[Any] = [None] * m
    for t in range(tplan.n_ticks):
        if latch and t:
            _post_latched(hop, tplan, routes, t, group.rank)
        # 1. arrivals: last tick's boundary outputs and skips park
        chain.land(t, tplan.park_recv)
        for route in routes:
            route.land(t)
        if group is not None and not latch:
            hop.wait_sends()               # spmd: last tick's sends are done
        # 2. each rank runs at most one task; its forward consumes the slots
        for r in hop.ranks:
            if int(tplan.kind[t, r]) == NOP:
                continue
            i = int(tplan.micro[t, r])
            slot = int(tplan.park_read[t, r])
            carry = park.get(r, slot, (i, r), release=True) \
                if slot >= 0 else None
            skips_in = _skips_in(routes, t, r, (i, r), release=True)
            fresh = None
            if r == 0:
                fresh = (stream.read(t, tplan, i) if stream else
                         tree_map(lambda a: a[i].to(devices[r]), inputs_mb))
                if stream and group is not None and grad:
                    fresh = tree_map(
                        lambda v, o: _FromStream.apply(v, o[i])
                        if o.requires_grad else v, fresh, inputs_mb)
            ctx = TickCtx(stage=r, micro=i, valid=True, t=t, fresh=fresh,
                          n_stages=tplan.n_stages, n_micro=m)
            wrapped = checkpointing.wrap_stage_for_micro(
                lambda p, c, si, rr, ctx=ctx: stage_apply(p, c, si, rr, ctx),
                remat, micro=i, n_micro=m,
                remat_last_micro=cfg.remat_last_micro)
            carry_out, skips_out, resident_s[r] = wrapped(
                params_s[r], carry, skips_in, resident_s[r])
            _send_skips(routes, t, r, i, r, skips_out)
            if r == R - 1:
                outputs[i] = carry_out
            else:
                chain.ship(r, r + 1, (i, r + 1), carry_out)
        if stream and tplan.stream_rot[t]:
            stream.rotate()
    hop.finish()
    for buf in [park] + routes:
        buf.check_empty()
    if park_info is not None:
        if group is None:
            park_info["per_stage_park"] = park.highs()
        else:
            park_info.update(rank=group.rank,
                             buffer_slots={"park": park.high[group.rank]},
                             hops=hop.stats)
        if routes:
            park_info["per_route"] = {route.rt.key: route.high(False)
                                      for route in routes}
    stacked = (tree_map(lambda *xs: torch.stack(xs), *outputs)
               if R - 1 in mine else None)
    return [None] * (R - 1) + [stacked], resident


def run_pipeline(stage_apply: StageApplyFn,
                 stage_params,
                 inputs_mb,
                 cfg: ParallelConfig,
                 *,
                 devices: Any,
                 skips: Sequence[SkipSpec] = (),
                 resident=None,
                 park_info: Optional[Dict[str, Any]] = None):
    """Lower the GPipe clock-cycle plan and run it."""
    tplan = plan_lib.plan_for("gpipe_fwd", cfg.n_micro, cfg.pipe,
                              skips=skips, portals=cfg.portals,
                              wire=cfg.wire)
    return run_pipeline_tasks(stage_apply, stage_params, inputs_mb, cfg,
                              tplan=tplan, devices=devices,
                              resident=resident, park_info=park_info)


def pipeline_call(stage_apply: StageApplyFn,
                  *,
                  cfg: ParallelConfig,
                  devices: Any = "cuda",
                  skips: Sequence[SkipSpec] = (),
                  park_info: Optional[Dict[str, Any]] = None,
                  group: Optional[p2p.PipeGroup] = None):
    """Build ``(stage_params, inputs_mb, resident, *, backprop) ->
    (outputs, resident)``.

    ``devices`` is one device per stage (or one device for all).  Forward
    execution always runs the GPipe clock-cycle plan; the plan is lowered
    once here, with one route per skip edge and destination (portals, or
    threaded hops with ``cfg.portals=False``).  ``outputs[-1]`` is the
    last stage's ``[m, ...]`` collection (:func:`last_stage_output`).  The
    call is differentiable: under grad mode autograd records the
    clock-cycle and its backward is the reverse one, with each stage
    recomputed under ``cfg.remat``; pass a :class:`p2p.Backprop` as
    ``backprop`` and take the gradients with its ``grad``.

    With a pipe ``group`` this process runs one rank
    (:func:`run_pipeline_tasks` says what it passes and gets back) under
    ``cfg.executor``'s send discipline, and ``devices`` is ignored.  Under
    grad the ``backprop`` is required: each rank's ``backprop.grad``
    differentiates its own roots (the loss on the last rank, nothing
    elsewhere) and the cotangents cross between the processes.
    """
    if cfg.virtual_stages > 1:
        raise ValueError("interleaved schedules are train-only; forward "
                         "execution runs the clock-cycle plan")
    tplan = plan_lib.plan_for("gpipe_fwd", cfg.n_micro, cfg.pipe,
                              skips=skips, portals=cfg.portals, wire=cfg.wire)

    def call(stage_params, inputs_mb, resident=None, *,
             backprop: Optional[p2p.Backprop] = None):
        return run_pipeline_tasks(stage_apply, stage_params, inputs_mb, cfg,
                                  tplan=tplan, devices=devices,
                                  resident=resident, park_info=park_info,
                                  group=group, backprop=backprop)

    call.tplan = tplan
    return call


# ---------------------------------------------------------------------------
# F+B plans: the fused scheduler
# ---------------------------------------------------------------------------

class _GradSum:
    """One stage's (or the head's) gradient, summed over micro-batches into
    ``dest``.  ``ordered`` folds micro 0, 1, ... in turn, whatever order the
    schedule computes them in (one that comes early waits for its
    predecessors), so any two schedules of one computation give bitwise
    equal sums; ``running`` folds in schedule order."""

    def __init__(self, dest: List[torch.Tensor], ordered: bool):
        self.dest, self.ordered = dest, ordered
        self.pending: Dict[int, List[torch.Tensor]] = {}
        self.folded = 0

    def add(self, micro: int, grads: List[torch.Tensor]) -> None:
        if not self.ordered:
            self._fold(grads)
            return
        self.pending[micro] = grads
        while self.folded in self.pending:
            self._fold(self.pending.pop(self.folded))

    def _fold(self, grads) -> None:
        for d, g in zip(self.dest, grads):
            g = g.to(d.device)
            if self.folded == 0:
                d.copy_(g)
            else:
                d.add_(g)
        self.folded += 1


def run_pipeline_grad_tasks(stage_apply: StageApplyFn,
                            stage_params,
                            head_params,
                            inputs_mb,
                            loss_args_mb,
                            cfg: ParallelConfig,
                            *,
                            tplan: plan_lib.TaskPlan,
                            loss_fn,
                            devices: Any,
                            loss_scale=1.0,
                            park_info: Optional[Dict[str, Any]] = None,
                            group: Optional[p2p.PipeGroup] = None):
    """Execute one F+B event plan for a mini-batch.

    ``stage_params`` leaves lead with ``[n_stages]`` global stages, stacked
    stage-major (with interleaved chunks, rank ``r`` hosts stages
    ``{r, r + R, ...}``), or ``stage_params`` is a sequence of ``n_stages``
    trees, one per global stage; ``devices`` is one device per global stage
    (or one for all).  ``inputs_mb`` (stage 0's input) and ``loss_args_mb``
    leaves are ``[m, ...]``; ``loss_fn(head_params, carry_out, loss_args)``
    is one micro-batch's loss on the last stage.  The loss seed is
    ``loss_scale / m`` (``loss_scale`` may be a tensor: a dynamic loss
    scale), so every gradient is the mean loss's, scaled.

    Returns ``(loss_sum, stage_grads, head_grads, input_grads_mb)``: the
    fp32 sum of the per-micro losses in ascending micro order (unscaled),
    gradients mirroring ``stage_params`` and ``head_params``, and the
    ``[m, ...]`` cotangents of ``inputs_mb`` in micro-batch order.
    ``cfg.grad_reduce`` picks the micro-batch fold (:class:`_GradSum`).
    With ``cfg.stream_inputs`` the inputs stream (:class:`_Stream`; the
    ranks must divide ``m``) and each F tick parks its fresh slice in the
    plan's ``fs_slot`` for the backward that re-runs it.  Pass a dict as
    ``park_info`` to receive the park, b-inbox and residual-stash
    high-water per rank (``per_stage_park``, ``per_stage_b_inbox``,
    ``per_stage_resid``; ``per_stage_fs`` when streaming) and, with skip
    routes, each route's value and cotangent high-water (``per_route``:
    ``{route key: {"depth": n, "g_depth": n}}``).

    With a pipe ``group`` (:class:`p2p.PipeGroup`, one process per rank)
    this process runs rank ``group.rank``'s column of the plan
    (``plan.specialize``) on ``group.device``, and every hop to another
    rank is a message (:class:`p2p.P2PHop`, under ``cfg.executor``'s send
    discipline).  ``stage_params`` then holds this rank's stages only,
    stacked ``[n_chunks, ...]`` or a sequence of ``n_chunks`` trees, in
    chunk order (global stages ``rank, rank + R, ...``), and the
    gradients mirror it.  ``inputs_mb`` is read on rank 0 (which sends the
    other ranks their shards when streaming) and ``head_params`` and
    ``loss_args_mb`` on the last rank; elsewhere pass None.  Rank 0 gets
    ``input_grads_mb`` and the last rank ``loss_sum`` and ``head_grads``;
    the others get None in their place.  ``park_info`` receives
    ``rank``, this rank's ``buffer_slots`` (the high-water of the
    families ``plan.specialize(tplan, rank).buffer_slots()`` declares:
    ``park``, ``b_inbox``, ``resid``, and ``fs`` when streaming), its
    ``per_route`` high-water and ``hops``: per payload class the hops this
    rank sent, their bytes and its host-clock wait.
    """
    if not tplan.has_backward:
        raise ValueError("forward-only plans run through run_pipeline_tasks")
    check_plan(tplan, cfg)
    if cfg.grad_reduce not in ("ordered", "running"):
        raise ValueError(f"unknown grad_reduce {cfg.grad_reduce!r}; "
                         "want 'ordered' or 'running'")
    R, m, S = tplan.n_ranks, tplan.n_micro, tplan.n_stages
    if (R, m) != (cfg.pipe, cfg.n_micro):
        raise ValueError(f"plan is for pipe={R}, m={m}; config has "
                         f"pipe={cfg.pipe}, n_micro={cfg.n_micro}")
    devices, hop = _hop(tplan, cfg, devices, group)
    mine = [s for s in range(S) if s % R in hop.ranks]  # stages run here
    first, last = 0 in mine, S - 1 in mine
    reuse = tplan.residuals == "reuse"
    ordered = cfg.grad_reduce == "ordered"

    # autograd leaves: each global stage's parameter tree and the head's
    params_s = {s: tree_map(lambda a: a.detach().requires_grad_(), p)
                for s, p in _stage_trees(stage_params, mine,
                                         devices).items()}
    head_s = (tree_map(lambda a: a.to(devices[-1]).detach()
                       .requires_grad_(), head_params) if last else None)
    seed = torch.as_tensor(loss_scale, dtype=torch.float32,
                           device=devices[-1]) / m
    if isinstance(stage_params, (list, tuple)):
        g_stage = [tree_map(torch.zeros_like, p) for p in stage_params]
        dests = {s: tree_leaves(g_stage[c]) for c, s in enumerate(mine)}
    else:
        g_stage = tree_map(torch.zeros_like, stage_params)
        dests = {s: [g[c] for g in tree_leaves(g_stage)]
                 for c, s in enumerate(mine)}
    stage_sums = {s: _GradSum(d, ordered) for s, d in dests.items()}
    g_head = head_sum = None
    if last:
        g_head = tree_map(torch.zeros_like, head_params)
        head_sum = _GradSum(tree_leaves(g_head), ordered)
    input_grads: List[Any] = [None] * m
    losses: List[Optional[torch.Tensor]] = [None] * m

    def stage_loss(p, carry, fresh, skips_in, hp, ctx, largs):
        """The stage, and on the last stage its loss: what every task of
        the plan runs and every backward differentiates."""
        ctx.fresh = fresh
        carry_out, skips_out, _ = stage_apply(p, carry, skips_in, {}, ctx)
        loss = None if largs is None else loss_fn(hp, carry_out,
                                                  largs).float()
        return carry_out, skips_out, loss

    # bare, unless Bx keeps its graph for Bw (residuals="reuse")
    stage_loss_b = checkpointing.wrap_for_residuals(stage_loss, cfg.remat,
                                                    tplan.residuals)

    def graph(s, carry, fresh, skips_in, seeded, ctx, largs):
        """Re-run stage ``s`` with grad from its parked (or fresh) input and
        parked skips.  Returns the outputs to differentiate (the loss, or
        the carry and the ``seeded`` skip outputs), the input leaves and
        the skip-input tree."""
        x = tree_map(lambda a: a.detach().requires_grad_(),
                     carry if s else fresh)
        carry, fresh = (x, None) if s else (None, x)
        si = tree_map(lambda a: a.detach().requires_grad_(), skips_in)
        with torch.enable_grad():
            carry_out, skips_out, loss = stage_loss_b(
                params_s[s], carry, fresh, si, head_s, ctx, largs)
        outs = [loss] if loss is not None else tree_leaves(carry_out)
        for name in seeded:
            if name not in skips_out:
                raise RuntimeError(f"stage {s} did not produce skip "
                                   f"{name!r}, which a route seeds")
            outs = outs + tree_leaves(skips_out[name])
        return outs, tree_leaves(x), si

    def weights(s):
        return tree_leaves(params_s[s]) + (tree_leaves(head_s)
                                           if s == S - 1 else [])

    def grad(outs, wrt, seeds, retain=False):
        return torch.autograd.grad(outs, wrt, seeds, retain_graph=retain,
                                   allow_unused=True, materialize_grads=True)

    park = _Slots("park", hop.ranks)
    inbox = _Slots("b-inbox", hop.ranks)
    resid = _Slots("residual", hop.ranks)
    wire = _Wire(tplan)
    chain_f = _Link(park, wire, "f", hop, lambda r: (r - 1) % R)
    chain_b = _Link(inbox, wire, "b", hop, lambda r: (r + 1) % R)
    routes = [_Route(rt, wire, hop) for rt in tplan.routes]
    stream = fs = None
    if _streaming(tplan, cfg):
        stream = _Stream(inputs_mb, R, hop)
        fs = _Slots("fs", hop.ranks)
    latch = group is not None and cfg.executor == "mpmd"
    for t in range(tplan.n_ticks):
        if latch and t:
            _post_latched(hop, tplan, routes, t, group.rank)
        # 1. arrivals: forward carries from rank r - 1, cotangents from r + 1,
        #    skip values and cotangents from their routes' previous hop
        chain_f.land(t, tplan.park_recv)
        chain_b.land(t, tplan.b_recv)
        for route in routes:
            route.land(t)
        if group is not None and not latch:
            hop.wait_sends()               # spmd: last tick's sends are done
        # 2. each rank runs at most one task
        for r in hop.ranks:
            kind = int(tplan.kind[t, r])
            if kind == NOP:
                continue
            i = int(tplan.micro[t, r])
            s = int(tplan.chunk[t, r]) * R + r
            tag = (i, s)
            # a slot frees at its last reader: the fused B, or Bw when split
            last_read = kind in (BWD, BWD_W)
            slot = int(tplan.park_read[t, r])
            carry = (park.get(r, slot, tag, release=last_read)
                     if slot >= 0 else None)
            if (carry is None) != (s == 0):
                raise RuntimeError(f"tick {t}: stage {s} reads "
                                   f"{'no' if carry is None else 'a'} "
                                   "parked carry")
            skips_in = _skips_in(routes, t, r, tag, release=last_read)
            if stream is None:
                fresh = (tree_map(lambda a: a[i].to(devices[s]), inputs_mb)
                         if s == 0 else None)
            elif kind == FWD:     # every F parks its slice (None past 0)
                fresh = stream.read(t, tplan, i) if s == 0 else None
                fs.put(r, int(tplan.fs_slot[t, r]), tag, fresh)
            else:
                fresh = fs.get(r, int(tplan.fs_slot[t, r]), tag,
                               release=last_read)
            largs = (tree_map(lambda a: a[i].to(devices[s]), loss_args_mb)
                     if s == S - 1 else None)
            ctx = TickCtx(stage=s, micro=i, valid=True, t=t, fresh=fresh,
                          n_stages=S, n_micro=m)
            if kind == FWD:
                if s == S - 1:          # the B / Bx graph records the loss
                    continue
                with torch.no_grad():
                    carry_out, skips_out, _ = stage_loss(
                        params_s[s], carry, fresh, skips_in, head_s, ctx,
                        None)
                chain_f.ship(r, (r + 1) % R, (i, s + 1), carry_out)
                _send_skips(routes, t, r, i, s, skips_out)
                continue
            if s == S - 1:
                seeds = [seed]
            else:
                seeds = tree_leaves(inbox.get(r, int(tplan.b_read[t, r]),
                                              tag, release=last_read))
            skip_seeds = _skip_seeds(routes, t, r, tag, release=last_read)
            seeds = seeds + tree_leaves(skip_seeds)
            if kind in (BWD, BWD_X):
                outs, xs, si = graph(s, carry, fresh, skips_in, skip_seeds,
                                     ctx, largs)
                n_in = len(xs) + len(tree_leaves(si))
                if s == S - 1:
                    losses[i] = outs[0].detach()
            if kind == BWD:
                g = grad(outs, xs + tree_leaves(si) + weights(s), seeds)
                g_in, g_w = g[:n_in], g[n_in:]
            elif kind == BWD_X:
                g_in, g_w = grad(outs, xs + tree_leaves(si), seeds,
                                 retain=reuse), None
                if reuse:
                    resid.put(r, int(tplan.resid_write[t, r]), tag, outs)
            else:                                   # BWD_W
                if reuse:
                    outs = resid.get(r, int(tplan.resid_read[t, r]), tag,
                                     release=True)
                else:
                    outs, _, _ = graph(s, carry, fresh, skips_in,
                                       skip_seeds, ctx, largs)
                g_in, g_w = None, grad(outs, weights(s), seeds)
            if g_w is not None:
                n_p = len(tree_leaves(params_s[s]))
                stage_sums[s].add(i, g_w[:n_p])
                if s == S - 1:
                    head_sum.add(i, g_w[n_p:])
            if g_in is not None:
                g_tree = _unflatten(fresh if s == 0 else carry,
                                    g_in[:len(xs)])
                g_skips = _unflatten(si, g_in[len(xs):])
                if s == 0:
                    input_grads[i] = g_tree
                else:
                    chain_b.ship(r, (r - 1) % R, (i, s - 1), g_tree)
                for route in routes:
                    route.send(t, r, i, s, g_skips, cot=True)
        if stream and tplan.stream_rot[t]:
            stream.rotate()
    hop.finish()
    for buf in [park, inbox, resid] + routes + ([fs] if fs else []):
        buf.check_empty()
    sums = list(stage_sums.values()) + ([head_sum] if last else [])
    if any(gs.folded != m or gs.pending for gs in sums) \
            or (last and any(x is None for x in losses)) \
            or (first and any(x is None for x in input_grads)):
        raise RuntimeError("the plan left a micro-batch without its loss or "
                           "a gradient")
    if park_info is not None:
        if group is None:
            park_info.update(per_stage_park=park.highs(),
                             per_stage_b_inbox=inbox.highs(),
                             per_stage_resid=resid.highs())
            if fs:
                park_info["per_stage_fs"] = fs.highs()
        else:
            me = group.rank
            slots = {"park": park.high[me], "b_inbox": inbox.high[me],
                     "resid": resid.high[me]}
            if fs:
                slots["fs"] = fs.high[me]
            park_info.update(rank=me, buffer_slots=slots, hops=hop.stats)
        if routes:
            park_info["per_route"] = {route.rt.key: route.high(True)
                                      for route in routes}
    loss_sum = input_grads_mb = None
    if last:
        loss_sum = torch.zeros((), dtype=torch.float32, device=devices[-1])
        for loss in losses:                   # ascending micro order
            loss_sum = loss_sum + loss
    if first:
        input_grads_mb = tree_map(lambda *xs: torch.stack(xs), *input_grads)
    return loss_sum, g_stage, g_head, input_grads_mb


def _unflatten(like, leaves):
    """``leaves`` in the tree structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def pipeline_grad_call(stage_apply: StageApplyFn,
                       *,
                       cfg: ParallelConfig,
                       loss_fn,
                       devices: Any = "cuda",
                       skips: Sequence[SkipSpec] = (),
                       park_info: Optional[Dict[str, Any]] = None,
                       group: Optional[p2p.PipeGroup] = None):
    """Build the fused schedule-driven training call.

    Returns ``(call, tplan)`` with ``call(stage_params, head_params,
    inputs_mb, loss_args_mb, *, loss_scale=1.0) -> (loss, stage_grads,
    head_grads, input_grads_mb)``, the reference's contract: ``loss`` is
    the mean per-micro loss, ``stage_grads`` mirror ``stage_params``
    (stacked stage-major ``[n_stages, ...]``, or a sequence of
    ``n_stages`` trees; ``pipe * v`` global stages for
    ``interleaved:v``), ``head_grads`` mirror ``head_params`` and
    ``input_grads_mb`` (``[m, ...]``) feeds the embed VJP outside the
    pipeline.  Gradients carry ``loss_scale``; the loss does not.

    The schedule comes from ``cfg.schedule`` (``"gpipe"`` /
    ``"gpipe_tasked"``, ``"1f1b"``, ``"interleaved:v"``, ``"zb"`` with
    ``cfg.residuals``), lowered once here by :func:`plan_lib.plan_for`
    with one route per skip edge and destination (portals, or threaded
    hops with ``cfg.portals=False``); ``cfg.grad_reduce`` picks the
    micro-batch fold.  ``park_info`` (a dict) receives each call's buffer
    high-water per rank and per route.

    With a pipe ``group`` this process runs one rank of the plan
    (:func:`run_pipeline_grad_tasks` says what each rank passes and gets
    back; ``loss`` is None but on the last rank), with ``cfg.executor``'s
    send discipline: ``"spmd"`` eager sends, ``"mpmd"`` sends latched one
    tick ahead; the two give bitwise equal results.  ``devices`` is then
    ignored: every stage of the rank runs on ``group.device``.
    """
    checkpointing.check_policy(cfg.remat)
    tplan = plan_lib.plan_for(cfg.schedule, cfg.n_micro, cfg.pipe,
                              skips=skips, portals=cfg.portals,
                              residuals=cfg.residuals, wire=cfg.wire)
    check_plan(tplan, cfg)

    def call(stage_params, head_params, inputs_mb, loss_args_mb, *,
             loss_scale=1.0):
        loss_sum, g_stage, g_head, ig = run_pipeline_grad_tasks(
            stage_apply, stage_params, head_params, inputs_mb, loss_args_mb,
            cfg, tplan=tplan, loss_fn=loss_fn, devices=devices,
            loss_scale=loss_scale, park_info=park_info, group=group)
        loss = None if loss_sum is None else loss_sum / cfg.n_micro
        return loss, g_stage, g_head, ig

    return call, tplan


def last_stage_output(outputs):
    """The last stage's collected outputs: an ``[m, ...]`` tree."""
    return outputs[-1]


def microbatch(tree, n_micro: int):
    """Split leading batch dim B -> [n_micro, B // n_micro, ...]."""
    def f(a):
        b = a.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
        return a.reshape((n_micro, b // n_micro) + tuple(a.shape[1:]))
    return tree_map(f, tree)


def unmicrobatch(tree):
    return tree_map(
        lambda a: a.reshape((a.shape[0] * a.shape[1],) + tuple(a.shape[2:])),
        tree)
