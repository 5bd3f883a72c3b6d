"""Lowering: schedule task tables -> per-rank, per-tick static event plans.

:mod:`repro_torch.core.schedules` is the single source of truth for execution
order: it builds task tables (lists of ticks, each tick a list of
``Task(kind, micro, stage)`` with ``stage`` a GLOBAL stage index) and proves
them against the paper's dependency graph (``schedules.validate``).  This
module lowers a validated table to the *static* per-rank arrays the compiled
tick loop (:func:`repro_torch.core.pipeline.run_pipeline_tasks`) consumes.  There
is exactly one executor; every workload — plain LM, skip-connection (U-Net /
enc-dec), resident-state serving, streamed inputs — runs a
:class:`TaskPlan`.

A plan carries these event families, all resolved at lowering time:

* **tasks** — ``kind[t, r]`` / ``micro[t, r]`` / ``chunk[t, r]``: which
  task rank ``r`` runs at tick ``t`` (NOP during bubbles).  With
  interleaved virtual stages (``n_chunks > 1``) rank ``r`` hosts global
  stages ``{r, r + R, ...}`` and ``chunk`` selects which of its parameter
  chunks the tick touches.  Backward tasks come in three flavours: fused
  ``BWD`` (input + weight cotangents in one tick), and the split pair
  ``BWD_X`` (input cotangent, on the inter-stage critical path) /
  ``BWD_W`` (weight gradient, filled into bubble ticks).

* **park buffer** (the paper's "stashed activations", donated): the ring
  shift delivers a stage's boundary input one tick after the producer's F;
  the value *parks* in a slot and stays there — the consuming F reads it
  in place and, in F+B plans, the matching backward re-reads the same slot
  for its recompute.  There is no separate inbox→stash copy: the arrival
  buffer IS the stash (buffer donation), so per tick the executor does one
  masked park write instead of a park write plus a stash write, and the
  per-rank high-water (``per_stage_park``) is the true footprint a
  per-device allocator charges — e.g. 0 slots for 1F1B's stage 0 (its
  input is re-gathered from the micro-batch buffer, not stashed).
  ``per_stage_stash`` keeps the schedule-level bound (``m`` for GPipe,
  ``min(n - j, m)`` for 1F1B) for reporting against the paper.

* **backward inbox** — cotangents travelling ``r+1 -> r`` park
  symmetrically; in split-backward plans the seed stays parked after
  ``BWD_X`` reads it so ``BWD_W`` can re-seed the weight-gradient VJP.

* **residual stash** (``residuals="reuse"``, true ZB-H1): on a ``BWD_X``
  tick the executor captures the stage vjp's residuals (what the remat
  policy saves — the values the weight gradient needs) and parks them in a
  donated per-rank residual slot (``resid_write``); the matching ``BWD_W``
  re-reads the slot (``resid_read``) instead of re-running the stage
  forward, and the slot frees at the Bw tick.  Slot intervals are
  allocated next to the park buffer (same free-list allocator); the
  per-rank high-water is ``per_stage_resid`` and
  ``schedules.peak_residuals`` predicts it exactly.  Fused-backward tables
  carry no residual events (nothing crosses ticks).

* **skip routes** (:class:`RoutePlan`, lowered from ``SkipSpec`` edges,
  paper §3.3): one route per (edge, destination).  Portal mode sends the
  value directly ``src -> dst`` with a single-pair collective-permute
  (an identity hold when both stages live on one rank); threaded mode
  relays it hop-by-hop through every intermediate stage.  The destination
  parks the value until its consuming forward and keeps holding it through
  the consumer's backward(s); cotangent routes mirror the value routes in
  reverse, seeding the producer's backward — and, split, its ``BWD_W``.

* **stream injection** — with ``cfg.stream_inputs`` the micro-batches are
  sharded over pipe and rotated one hop towards stage 0; ``stream_slot``
  names the shard slot rank 0 consumes at each chunk-0 forward and
  ``stream_rot`` flags the rotation ticks.

* **segments** — maximal runs of ticks that use the same *branch set*
  (e.g. GPipe's pure-F fill, 1F1B's mixed steady state, a ZB drain of
  ``BWD_W`` only).  The executor runs one scan per segment with the
  ``lax.switch`` pruned to exactly the branches the segment uses and the
  bookkeeping (grad writes, stream rotation, chain permutes) elided when
  the segment provably never needs it.  All-rank-NOP ticks are dropped
  entirely at lowering time.

* **chain double buffering** (``send_slot`` / ``b_send_slot``): the clock
  cycle makes every ring send known one tick ahead, so the MPMD executor
  latches a tick's boundary output (the forward carry on ``send_slot``
  ticks, the ``B``/``Bx`` input cotangent on ``b_send_slot`` ticks) into
  a depth-1 send register and ships it at the TOP of the *next* tick —
  the ``ppermute`` then has no data dependency on that tick's stage
  compute, so XLA's scheduler can overlap comm with compute instead of
  serializing compute -> send.  Arrival ticks are unchanged (producer's
  tick + 1), so the values that park are bitwise the ones the eager send
  would have delivered.  The columns hold ``0`` (the register slot — one
  suffices, a latch written at the bottom of tick ``t`` is consumed at
  the top of ``t+1`` before the next write) on shipping ticks and ``-1``
  elsewhere; the last global stage never ships forward, stage 0 never
  ships backward.

Every array is ``[n_ticks, n_ranks]`` host-side numpy, turned into
constants of the compiled program; nothing about the order is decided at
runtime.  :func:`specialize` projects the whole plan onto one rank's
column — the MPMD lowering unit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import parse_schedule
from repro_torch.core import schedules
from repro_torch.core.schedules import Task
from repro_torch.core.skip import SkipSpec
from repro_torch.core.wire import WIRE_FP32, WireSpec

NOP, FWD, BWD, BWD_X, BWD_W = 0, 1, 2, 3, 4

_KIND_OF = {"F": FWD, "B": BWD, "Bx": BWD_X, "Bw": BWD_W}

#: backward flavours that compute input cotangents (ship down the b chain)
BWD_INPUT_KINDS = (BWD, BWD_X)
#: backward flavours that compute weight gradients
BWD_WEIGHT_KINDS = (BWD, BWD_W)
#: every backward flavour (reads the parked activation for its recompute)
BWD_KINDS = (BWD, BWD_X, BWD_W)

#: cap on executor segments: beyond this, adjacent segments are coalesced
#: (their branch sets unioned) to bound trace/compile time.
MAX_SEGMENTS = 8

# sentinel for RoutePlan send arrays: transmit the value the stage produced
# THIS tick (skips_out in forward routes, the VJP's skip cotangent in
# backward routes) instead of a parked buffer slot.
SEND_STAGE = -2


def pipe_ring_perm(n: int, *, reverse: bool = False,
                   ring: bool = False) -> list:
    """Static ppermute pairs for the pipeline chain on ``n`` pipe ranks.

    Forward: ``j -> j+1`` (the boundary-activation hop); ``reverse``:
    ``j -> j-1`` (the cotangent hop).  ``ring`` adds the wraparound pair
    (last -> first, or first -> last reversed) that interleaved chunk
    boundaries ride.  The pipeline executor and any tool reasoning about
    chain collectives (dryrun comm accounting, launch.mesh, tests) share
    this one definition so the wire topology cannot drift between them.
    """
    if reverse:
        return [(i, i - 1) for i in range(1, n)] \
            + ([(0, n - 1)] if ring else [])
    return [(i, i + 1) for i in range(n - 1)] + ([(n - 1, 0)] if ring else [])


@dataclass(frozen=True)
class Segment:
    """One executor phase: ticks [start, stop) sharing a branch set."""
    start: int
    stop: int
    kinds: Tuple[int, ...]        # sorted kind ids present (incl. NOP)


@dataclass(frozen=True)
class RoutePlan:
    """Lowered transfer schedule for one (skip edge, destination) flow.

    ``send``/``recv``/``read`` are ``[T, R]`` int32: ``send`` is
    :data:`SEND_STAGE` on the tick a rank transmits its freshly produced
    value, a slot index when it relays a parked value (threaded hops), and
    ``-1`` otherwise; ``recv`` parks the in-flight value into a buffer slot
    the tick after the hop; ``read`` feeds a parked slot to the stage
    compute (the consuming F and every backward flavour that recomputes
    it).  ``g_send``/``g_recv``/``g_read`` mirror them for the cotangent
    flowing ``dst -> src``; ``g_read`` marks the producer's backward
    tick(s), where the parked cotangent seeds ``skips_out``'s VJP.  Empty
    ``fwd_perm``/``bwd_perm`` mean src and dst share a rank (interleaved
    chunks): the "hop" is an identity hold, no collective.
    """
    name: str
    src: int
    dst: int
    threaded: bool
    fwd_perm: Tuple[Tuple[int, int], ...]   # static ppermute pairs, value hop
    bwd_perm: Tuple[Tuple[int, int], ...]   # reverse pairs, cotangent hop
    send: np.ndarray
    recv: np.ndarray
    read: np.ndarray
    g_send: np.ndarray
    g_recv: np.ndarray
    g_read: np.ndarray
    depth: int
    g_depth: int

    @property
    def key(self) -> str:
        return f"{self.name}@{self.dst}"

    # Ship masks for the double-buffered (mpmd) lowering: a payload that
    # latched on any rank at the bottom of tick t-1 ships at the TOP of
    # tick t, overlapped with tick t's compute — exactly the chain-carry
    # discipline of ``send_slot``.  ``ship[t]`` marks the ticks whose top
    # needs the value hop; ``g_ship`` mirrors it for the cotangent.
    @property
    def ship(self) -> np.ndarray:
        s = np.zeros(self.send.shape[0], bool)
        s[1:] = (self.send[:-1] != -1).any(axis=1)
        return s

    @property
    def g_ship(self) -> np.ndarray:
        s = np.zeros(self.g_send.shape[0], bool)
        s[1:] = (self.g_send[:-1] != -1).any(axis=1)
        return s


@dataclass(frozen=True)
class TaskPlan:
    """Full fused-schedule event plan (the only executor input)."""
    kind: np.ndarray          # [T, R] NOP/FWD/BWD/BWD_X/BWD_W
    micro: np.ndarray         # [T, R] micro index of the task (0 on NOP)
    chunk: np.ndarray         # [T, R] virtual-stage chunk of the task (0 ..)
    park_recv: np.ndarray     # [T, R] ring arrival -> park slot; -1
    park_read: np.ndarray     # [T, R] park slot this tick's task reads; -1
    b_recv: np.ndarray        # [T, R] bwd-chain arrival -> inbox slot; -1
    b_read: np.ndarray        # [T, R] B seed inbox slot (B/Bx and Bw); -1
    fs_slot: np.ndarray       # [T, R] stream-stash slot (F write, B read); -1
    stream_slot: np.ndarray   # [T] stream shard slot rank 0 consumes; -1
    stream_rot: np.ndarray    # [T] bool: rotate the input stream after tick t
    send_slot: np.ndarray     # [T, R] latch fwd carry for next-tick ship; -1
    b_send_slot: np.ndarray   # [T, R] latch bwd cotangent for next ship; -1
    segments: Tuple[Segment, ...]
    n_ticks: int
    n_stages: int             # GLOBAL stages (= n_ranks * n_chunks)
    n_ranks: int
    n_micro: int
    n_chunks: int
    park_depth: int           # SPMD park buffer depth (max over ranks)
    b_inbox_depth: int
    fs_depth: int
    per_stage_stash: Tuple[int, ...]   # schedule-level bound (peak_stash/rank)
    per_stage_park: Tuple[int, ...]    # donated park high-water per rank
    per_stage_b_inbox: Tuple[int, ...] = ()   # bwd-inbox high-water per rank
    per_stage_fs: Tuple[int, ...] = ()        # stream-stash high-water per rank
    has_backward: bool = True
    routes: Tuple[RoutePlan, ...] = ()
    # --- split-backward residual reuse (ZB-H1, residuals="reuse") ---------
    residuals: str = "recompute"       # effective mode ("reuse" only when
    #   the table actually splits backward — fused tables coerce back)
    resid_write: Optional[np.ndarray] = None   # [T, R] BWD_X -> stash slot
    resid_read: Optional[np.ndarray] = None    # [T, R] BWD_W <- stash slot
    resid_depth: int = 0               # SPMD residual buffer depth (max/rank)
    per_stage_resid: Tuple[int, ...] = ()      # residual high-water per rank
    # --- on-the-wire codec ----------------------------------------------
    wire: WireSpec = WIRE_FP32         # per-payload-class encode at latch /
    #   decode at arrival; fp32 is the bitwise-lossless identity

    @property
    def stash_depth(self) -> int:
        """Depth of the (uniform SPMD) park buffer the executor allocates."""
        return self.park_depth

    def per_stage_stash_bytes(self, bytes_per_micro: int) -> Tuple[int, ...]:
        """Donated activation footprint per rank: what a per-device
        allocator charges — the park high-water, NOT a flattened max."""
        return tuple(d * bytes_per_micro for d in self.per_stage_park)


class _SlotPool:
    """Free-list slot allocator; tracks the high-water mark."""

    def __init__(self):
        self.free: List[int] = []
        self.next = 0
        self.high = 0

    def alloc(self) -> int:
        if self.free:
            return self.free.pop()
        s = self.next
        self.next += 1
        self.high = max(self.high, self.next)
        return s

    def release(self, slot: int) -> None:
        self.free.append(slot)


def _alloc_intervals(per_rank: Sequence[Sequence[Tuple[int, int, object]]]):
    """Assign buffer slots to live intervals, one free-list per rank.

    ``per_rank[j]`` is a list of ``(arrive_tick, last_use_tick, tag)``; a
    slot is reusable strictly *after* its last-use tick (arrival parks at
    the start of a tick, reads/sends happen later the same tick, so
    same-tick reuse would clobber a live value).  Returns
    ``({tag: slot}, depth, per_rank_high)``.
    """
    assign: Dict[object, int] = {}
    highs: List[int] = []
    for rank_events in per_rank:
        pool = _SlotPool()
        live: List[Tuple[int, object]] = []   # (last_use, tag)
        for a, c, tag in sorted(rank_events, key=lambda e: (e[0], e[1])):
            assert a <= c, f"interval arrives {a} after last use {c}"
            for lu, tg in list(live):
                if lu < a:
                    pool.release(assign[tg])
                    live.remove((lu, tg))
            s = pool.alloc()
            assign[tag] = s
            live.append((c, tag))
        highs.append(pool.high)
    return assign, max(highs, default=0), highs


class _TaskIndex:
    """Tick lookup per (kind-family, micro, stage) for one compacted table."""

    def __init__(self, table: Sequence[Sequence[Task]]):
        self.f: Dict[Tuple[int, int], int] = {}
        self.b: Dict[Tuple[int, int], int] = {}   # fused B or Bx
        self.w: Dict[Tuple[int, int], int] = {}   # Bw (split only)
        for t, tick in enumerate(table):
            for task in tick:
                if task.kind == "F":
                    self.f[(task.micro, task.stage)] = t
                elif task.kind in ("B", "Bx"):
                    self.b[(task.micro, task.stage)] = t
                elif task.kind == "Bw":
                    self.w[(task.micro, task.stage)] = t

    def last_b(self, i: int, s: int) -> int:
        """Tick of the LAST backward reader of (i, s)'s activation."""
        return self.w.get((i, s), self.b.get((i, s), -1))

    def b_ticks(self, i: int, s: int) -> List[int]:
        """Every backward tick that re-reads (i, s)'s operands."""
        out = [self.b[(i, s)]]
        if (i, s) in self.w:
            out.append(self.w[(i, s)])
        return out


def _lower_routes(ix: _TaskIndex, T: int, m: int, ranks: int,
                  skips: Sequence[SkipSpec], portals: bool,
                  has_backward: bool) -> Tuple[RoutePlan, ...]:
    """Lower skip edges to per-(edge, dst) transfer schedules."""
    routes = []
    for spec in skips:
        for dst in spec.dsts:
            src = spec.src_stage

            def rk(s):
                return s % ranks

            if portals:
                hop_stages = [(src, dst)]
            else:
                hop_stages = [(s, s + 1) for s in range(src, dst)]
            fwd_perm = tuple((rk(a), rk(b)) for a, b in hop_stages
                             if rk(a) != rk(b))
            if len(set(fwd_perm)) != len(fwd_perm):
                # a threaded chain spanning more than one chunk ring wraps
                # onto the same physical link twice — one ppermute cannot
                # carry two values over one pair.  Portals avoid this.
                raise NotImplementedError(
                    f"threaded route {spec.name!r} ({src}->{dst}) wraps the "
                    f"rank ring under interleaving; use portals=True")
            bwd_perm = tuple((b, a) for a, b in reversed(fwd_perm))

            send = np.full((T, ranks), -1, np.int32)
            recv = np.full((T, ranks), -1, np.int32)
            read = np.full((T, ranks), -1, np.int32)
            g_send = np.full((T, ranks), -1, np.int32)
            g_recv = np.full((T, ranks), -1, np.int32)
            g_read = np.full((T, ranks), -1, np.int32)

            iv: List[List[Tuple[int, int, object]]] = [[] for _ in range(ranks)]
            g_iv: List[List[Tuple[int, int, object]]] = [[] for _ in range(ranks)]
            relays = [b for _, b in hop_stages[:-1]]     # stages that re-send
            for i in range(m):
                # ---- value: src -> (relays) -> dst --------------------
                send[ix.f[(i, src)], rk(src)] = SEND_STAGE
                prev = src
                for r in relays:
                    arrive = ix.f[(i, prev)] + 1
                    resend = ix.f[(i, r)]
                    iv[rk(r)].append((arrive, resend, ("f", i, r)))
                    prev = r
                arrive = ix.f[(i, prev)] + 1
                consume = ix.f[(i, dst)]
                hold = (ix.last_b(i, dst) if has_backward else consume)
                iv[rk(dst)].append((arrive, hold, ("f", i, dst)))
                # ---- cotangent: dst -> (relays) -> src ----------------
                if has_backward:
                    g_send[ix.b[(i, dst)], rk(dst)] = SEND_STAGE
                    prev = dst
                    for r in reversed(relays):
                        arrive = ix.b[(i, prev)] + 1
                        resend = ix.b[(i, r)]
                        g_iv[rk(r)].append((arrive, resend, ("b", i, r)))
                        prev = r
                    arrive = ix.b[(i, prev)] + 1
                    g_iv[rk(src)].append((arrive, ix.last_b(i, src),
                                          ("b", i, src)))

            assign, depth, _ = _alloc_intervals(iv)
            for i in range(m):
                prev = src
                for r in relays:
                    s = assign[("f", i, r)]
                    recv[ix.f[(i, prev)] + 1, rk(r)] = s
                    send[ix.f[(i, r)], rk(r)] = s
                    prev = r
                s = assign[("f", i, dst)]
                recv[ix.f[(i, prev)] + 1, rk(dst)] = s
                read[ix.f[(i, dst)], rk(dst)] = s
                if has_backward:
                    for tb in ix.b_ticks(i, dst):
                        read[tb, rk(dst)] = s

            g_depth = 1
            if has_backward:
                g_assign, g_depth, _ = _alloc_intervals(g_iv)
                for i in range(m):
                    prev = dst
                    for r in reversed(relays):
                        s = g_assign[("b", i, r)]
                        g_recv[ix.b[(i, prev)] + 1, rk(r)] = s
                        g_send[ix.b[(i, r)], rk(r)] = s
                        prev = r
                    s = g_assign[("b", i, src)]
                    g_recv[ix.b[(i, prev)] + 1, rk(src)] = s
                    for tb in ix.b_ticks(i, src):
                        g_read[tb, rk(src)] = s

            routes.append(RoutePlan(
                spec.name, src, dst, not portals, fwd_perm, bwd_perm,
                send, recv, read, g_send, g_recv, g_read,
                max(depth, 1), max(g_depth, 1)))
    return tuple(routes)


def _segments(kind: np.ndarray) -> Tuple[Segment, ...]:
    """Maximal runs of ticks sharing a branch set, coalesced to a cap."""
    T = kind.shape[0]
    sets = [frozenset(int(k) for k in kind[t]) for t in range(T)]
    segs: List[Tuple[int, int, frozenset]] = []
    for t in range(T):
        if segs and segs[-1][2] == sets[t]:
            segs[-1] = (segs[-1][0], t + 1, segs[-1][2])
        else:
            segs.append((t, t + 1, sets[t]))
    while len(segs) > MAX_SEGMENTS:
        # merge the shortest segment into its shorter neighbour
        li = min(range(len(segs)), key=lambda i: segs[i][1] - segs[i][0])
        ni = li - 1 if li > 0 and (
            li == len(segs) - 1
            or (segs[li - 1][1] - segs[li - 1][0]
                <= segs[li + 1][1] - segs[li + 1][0])) else li + 1
        a, b = sorted((li, ni))
        segs[a] = (segs[a][0], segs[b][1], segs[a][2] | segs[b][2])
        del segs[b]
    return tuple(Segment(s, e, tuple(sorted(ks))) for s, e, ks in segs)


# ---------------------------------------------------------------------------
# MPMD specialization: one rank's column of the plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RankProgram:
    """The plan projected onto ONE rank — the MPMD lowering unit.

    Where the SPMD plan flattens every per-rank quantity to the ring max
    (uniform buffers, union branch sets), a rank program carries exactly
    what *this* rank's column needs: its own tick kinds and slot columns,
    buffer depths equal to its own slot high-water (1F1B's rank 0 parks 0
    slots, not ``max_j``), and segments cut along ITS kind runs — a rank
    whose column is all-F in a window gets a branch-free program there.

    The executor dispatches the per-rank programs under one top-level
    rank-indexed ``lax.switch`` inside the shared ``shard_map`` body; the
    collective skeleton (chain / route permutes, stream rotation) stays
    rank-uniform OUTSIDE the switch — collectives inside per-rank branches
    would deadlock a real device group, so only pure compute specializes.
    One SPMD executable must still physically allocate the ring-max
    buffers; the per-rank depths here are the footprint each rank's
    program *declares* (and a one-program-per-host MPMD deployment would
    allocate), which the bench / dryrun report per rank.
    """
    rank: int
    n_ranks: int
    kind: np.ndarray          # [T] this rank's task kind per tick
    micro: np.ndarray         # [T]
    chunk: np.ndarray         # [T]
    park_recv: np.ndarray     # [T] slot columns, already rank-local: the
    park_read: np.ndarray     # [T] free-list allocator runs one pool per
    b_recv: np.ndarray        # [T] rank, so every slot index in a column
    b_read: np.ndarray        # [T] is < the matching per-rank depth below
    fs_slot: np.ndarray       # [T]
    send_slot: np.ndarray     # [T] latch fwd carry for next-tick ship; -1
    b_send_slot: np.ndarray   # [T]
    resid_write: Optional[np.ndarray]   # [T] (reuse plans only)
    resid_read: Optional[np.ndarray]    # [T]
    segments: Tuple[Segment, ...]       # cuts along THIS rank's kind runs
    n_ticks: int
    park_depth: int           # this rank's park high-water (exact)
    b_inbox_depth: int
    fs_depth: int
    resid_depth: int
    residuals: str

    def branches_in(self, start: int, stop: int) -> Tuple[int, ...]:
        """Exact branch set of this rank's column over ticks [start, stop)."""
        return tuple(sorted(set(int(k) for k in self.kind[start:stop])))

    def buffer_slots(self) -> Dict[str, int]:
        """Slot counts per buffer family this rank's program declares."""
        return {"park": self.park_depth, "b_inbox": self.b_inbox_depth,
                "fs": self.fs_depth, "resid": self.resid_depth}


def specialize(tplan: TaskPlan, rank: int) -> RankProgram:
    """Project the global plan onto ``rank``'s column.

    Slot indices need no renumbering: the plan's free-list allocator
    already runs one pool per rank, so each column's indices are dense in
    ``[0, per_rank_depth)``.  Segments are recomputed from the single
    column, so a window where this rank runs only one kind becomes a
    branch-free segment even when other ranks mix kinds there.
    """
    if not 0 <= rank < tplan.n_ranks:
        raise ValueError(f"rank {rank} out of range (n_ranks="
                         f"{tplan.n_ranks})")
    r = rank

    def col(a):
        return None if a is None else np.ascontiguousarray(a[:, r])

    def depth_of(per_stage, fallback):
        return int(per_stage[r]) if len(per_stage) == tplan.n_ranks \
            else fallback

    prog = RankProgram(
        rank=r, n_ranks=tplan.n_ranks,
        kind=col(tplan.kind), micro=col(tplan.micro), chunk=col(tplan.chunk),
        park_recv=col(tplan.park_recv), park_read=col(tplan.park_read),
        b_recv=col(tplan.b_recv), b_read=col(tplan.b_read),
        fs_slot=col(tplan.fs_slot),
        send_slot=col(tplan.send_slot), b_send_slot=col(tplan.b_send_slot),
        resid_write=col(tplan.resid_write), resid_read=col(tplan.resid_read),
        segments=_segments(tplan.kind[:, r:r + 1]),
        n_ticks=tplan.n_ticks,
        park_depth=depth_of(tplan.per_stage_park, tplan.park_depth),
        b_inbox_depth=depth_of(tplan.per_stage_b_inbox, tplan.b_inbox_depth),
        fs_depth=depth_of(tplan.per_stage_fs, tplan.fs_depth),
        resid_depth=depth_of(tplan.per_stage_resid, tplan.resid_depth),
        residuals=tplan.residuals)
    for name, column, depth in (
            ("park", prog.park_recv, prog.park_depth),
            ("park", prog.park_read, prog.park_depth),
            ("b_inbox", prog.b_recv, prog.b_inbox_depth),
            ("b_inbox", prog.b_read, prog.b_inbox_depth),
            ("fs", prog.fs_slot, prog.fs_depth),
            ("resid", prog.resid_write, prog.resid_depth),
            ("resid", prog.resid_read, prog.resid_depth)):
        if column is not None and column.size and int(column.max()) >= 0:
            assert int(column.max()) < depth, \
                (f"rank {r}: {name} slot {int(column.max())} outside the "
                 f"declared depth {depth}")
    return prog


def lower_tasks(table: Sequence[Sequence[Task]], m: int, n: int, *,
                ranks: Optional[int] = None,
                skips: Sequence[SkipSpec] = (), portals: bool = True,
                forward_only: bool = False,
                residuals: str = "recompute",
                wire: Optional[WireSpec] = None) -> TaskPlan:
    """Lower a validated task table to the fused executor's event plan.

    ``n`` is the number of GLOBAL stages; ``ranks`` (default ``n``) the
    number of executing devices — pass ``ranks < n`` for interleaved
    tables, where rank ``r`` hosts the ``n // ranks`` chunks
    ``{r, r + ranks, ...}``.  ``residuals="reuse"`` additionally allocates
    the Bx->Bw residual-stash slots for split-backward tables (coerced back
    to ``"recompute"`` when the table has no ``Bw`` — there is nothing to
    reuse across ticks in a fused backward).  ``wire`` selects the
    on-the-wire codec the executor applies at latch/arrival (default: the
    lossless fp32 identity).
    """
    if residuals not in ("recompute", "reuse"):
        raise ValueError(f"unknown residuals mode {residuals!r}; "
                         "want 'recompute' or 'reuse'")
    wire = WireSpec.parse(wire) if wire is not None else WIRE_FP32
    R = n if ranks is None else ranks
    if n % R:
        raise ValueError(f"stages ({n}) must tile ranks ({R})")
    v = n // R
    schedules.validate(table, m, n, ranks=R, checkpoint=False,
                       backward_micro_order=False, forward_only=forward_only)
    # compact: all-rank-NOP ticks cost a full executor iteration for no work
    table = [tick for tick in table
             if any(t.kind != "R" for t in tick)]
    T = len(table)
    ix = _TaskIndex(table)

    kind = np.full((T, R), NOP, np.int32)
    micro = np.zeros((T, R), np.int32)
    chunk = np.zeros((T, R), np.int32)
    park_recv = np.full((T, R), -1, np.int32)
    park_read = np.full((T, R), -1, np.int32)
    b_recv = np.full((T, R), -1, np.int32)
    b_read = np.full((T, R), -1, np.int32)
    fs_slot = np.full((T, R), -1, np.int32)
    stream_slot = np.full((T,), -1, np.int32)

    for t, tick in enumerate(table):
        for task in sorted(tick):
            if task.kind == "R":
                continue           # recompute is fused into B by the VJP
            r = task.stage % R
            assert kind[t, r] == NOP, \
                f"tick {t}: rank {r} runs two tasks"
            kind[t, r] = _KIND_OF[task.kind]
            micro[t, r] = task.micro
            chunk[t, r] = task.stage // R

    # --- park buffer: arrival -> consuming F -> (B/Bx and Bw) re-reads ----
    park_iv: List[List[Tuple[int, int, object]]] = [[] for _ in range(R)]
    for i in range(m):
        for s in range(1, n):
            arrive = ix.f[(i, s - 1)] + 1
            last = ix.f[(i, s)] if forward_only else ix.last_b(i, s)
            park_iv[s % R].append((arrive, last, (i, s)))
    p_assign, park_depth, park_high = _alloc_intervals(park_iv)
    for i in range(m):
        for s in range(1, n):
            slot = p_assign[(i, s)]
            park_recv[ix.f[(i, s - 1)] + 1, s % R] = slot
            park_read[ix.f[(i, s)], s % R] = slot
            if not forward_only:
                for tb in ix.b_ticks(i, s):
                    park_read[tb, s % R] = slot

    # --- backward inbox: B(i,s+1)'s cotangent parks until B/Bx (and Bw) ---
    b_depth = 1
    b_high = [0] * R
    if not forward_only:
        b_iv: List[List[Tuple[int, int, object]]] = [[] for _ in range(R)]
        for i in range(m):
            for s in range(n - 1):
                arrive = ix.b[(i, s + 1)] + 1
                b_iv[s % R].append((arrive, ix.last_b(i, s), (i, s)))
        b_assign, b_depth, b_high = _alloc_intervals(b_iv)
        for i in range(m):
            for s in range(n - 1):
                slot = b_assign[(i, s)]
                b_recv[ix.b[(i, s + 1)] + 1, s % R] = slot
                for tb in ix.b_ticks(i, s):
                    b_read[tb, s % R] = slot

    # --- stream stash: every F parks its fresh slice for the backward -----
    fs_depth = 1
    fs_high = [0] * R
    if not forward_only:
        fs_iv: List[List[Tuple[int, int, object]]] = [[] for _ in range(R)]
        for i in range(m):
            for s in range(n):
                fs_iv[s % R].append((ix.f[(i, s)], ix.last_b(i, s), (i, s)))
        fs_assign, fs_depth, fs_high = _alloc_intervals(fs_iv)
        for i in range(m):
            for s in range(n):
                slot = fs_assign[(i, s)]
                fs_slot[ix.f[(i, s)], s % R] = slot
                for tb in ix.b_ticks(i, s):
                    fs_slot[tb, s % R] = slot

    # --- chain send latches (MPMD double buffering): a tick whose output
    # crosses the ring latches it into the depth-1 send register; the
    # executor ships the register at the top of the NEXT tick, overlapping
    # the permute with that tick's compute.  The last global stage never
    # ships forward; stage 0 never ships a cotangent.
    send_slot = np.full((T, R), -1, np.int32)
    b_send_slot = np.full((T, R), -1, np.int32)
    for i in range(m):
        for s in range(n - 1):
            send_slot[ix.f[(i, s)], s % R] = 0
        if not forward_only:
            for s in range(1, n):
                b_send_slot[ix.b[(i, s)], s % R] = 0

    # --- residual stash: BWD_X parks its vjp residuals until BWD_W --------
    resid_write = np.full((T, R), -1, np.int32)
    resid_read = np.full((T, R), -1, np.int32)
    resid_depth = 0
    resid_high = [0] * R
    if residuals == "reuse" and ix.w:
        r_iv: List[List[Tuple[int, int, object]]] = [[] for _ in range(R)]
        for (i, s), tw in ix.w.items():
            tb = ix.b.get((i, s))
            assert tb is not None, f"Bw[{i},{s}] has no matching Bx"
            assert tb < tw, \
                f"Bw[{i},{s}] at tick {tw} must follow its Bx (tick {tb})"
            r_iv[s % R].append((tb, tw, (i, s)))
        r_assign, resid_depth, resid_high = _alloc_intervals(r_iv)
        for (i, s), tw in ix.w.items():
            slot = r_assign[(i, s)]
            resid_write[ix.b[(i, s)], s % R] = slot
            resid_read[tw, s % R] = slot
    else:
        residuals = "recompute"

    # --- stream injection: rank 0's chunk-0 forwards consume + rotate -----
    stream_rot = (kind[:, 0] == FWD) & (chunk[:, 0] == 0)
    for i in range(m):
        stream_slot[ix.f[(i, 0)]] = i // R

    per_stage_stash = tuple(schedules.peak_stash(table, n, ranks=R))
    routes = _lower_routes(ix, T, m, R, skips, portals,
                           has_backward=not forward_only)
    return TaskPlan(kind, micro, chunk, park_recv, park_read, b_recv, b_read,
                    fs_slot, stream_slot, stream_rot, send_slot, b_send_slot,
                    _segments(kind),
                    T, n, R, m, v,
                    park_depth, max(b_depth, 1), max(fs_depth, 1),
                    per_stage_stash, tuple(park_high),
                    per_stage_b_inbox=tuple(b_high),
                    per_stage_fs=tuple(fs_high),
                    has_backward=not forward_only, routes=routes,
                    residuals=residuals, resid_write=resid_write,
                    resid_read=resid_read, resid_depth=resid_depth,
                    per_stage_resid=tuple(resid_high),
                    wire=wire)


def schedule_table(schedule: str, m: int, n: int):
    """Build (but do not lower) the named schedule's task table.

    Returns ``(table, n_stages, ranks)``.  ``"gpipe"``/``"gpipe_fwd"`` map
    to the full GPipe fill/drain table (the clock the legacy autodiff path
    also follows).
    """
    base, v = parse_schedule(schedule)
    if base in ("gpipe", "gpipe_fwd", "gpipe_tasked"):
        return schedules.gpipe_schedule(m, n, checkpoint=False), n, n
    if base == "1f1b":
        return schedules.one_f_one_b_schedule(m, n), n, n
    if base == "interleaved":
        return schedules.interleaved_1f1b_schedule(m, n, v), n * v, n
    if base == "zb":
        return schedules.zb_schedule(m, n), n, n
    raise ValueError(f"unknown schedule {schedule!r}")


def schedule_bubble(schedule: str, m: int, n: int,
                    *, residuals: str = "recompute",
                    remat: str = "dots",
                    executor: str = "spmd",
                    comm_cost: float = 0.0,
                    bwd_comm_cost: Optional[float] = None,
                    route_edges: Sequence[Tuple[int, int]] = (),
                    route_comm_cost: Optional[float] = None) -> float:
    """Dedicated-device bubble fraction of the named schedule's table
    (cost-weighted critical-path idle share) — the dry-run cost model's
    pipeline-efficiency term.  ``residuals`` selects the split-backward
    pricing (``"reuse"`` drops Bw's recompute — unless ``remat="full"``,
    whose stash is empty and still recomputes); ``comm_cost`` prices one
    chain hop and ``executor`` decides whether it overlaps compute
    (``"mpmd"`` double buffering) or serializes after the producing task
    (``"spmd"``).  ``bwd_comm_cost``/``route_comm_cost`` price the
    cotangent chain and skip-route hops separately (byte-derived wire
    terms — the codec can shrink each payload class independently;
    ``None`` = same as ``comm_cost``); ``route_edges`` lists the
    ``(src_stage, dst_stage)`` skip edges whose hops the model should
    charge.  Returns 0 for a single-stage pipeline."""
    if n <= 1:
        return 0.0
    table, n_stages, ranks = schedule_table(schedule, m, n)
    return schedules.device_bubble_fraction(
        table, ranks,
        schedules.default_task_cost(n_stages, ranks, residuals=residuals,
                                    remat=remat),
        comm_cost=comm_cost, overlap_comm=executor == "mpmd",
        bwd_comm_cost=bwd_comm_cost, route_edges=route_edges,
        route_comm_cost=route_comm_cost)


@dataclass(frozen=True)
class PlanCost:
    """Planner-facing time + memory summary of one lowered schedule.

    Times are in stage-forward units under the supplied cost model; slot
    counts are the EXACT per-rank high-water marks of the lowered plan's
    free-list allocator (what the executor allocates), not schedule-level
    bounds.
    """
    t_end: float                      # device-model makespan
    busy: Tuple[float, ...]           # per-rank busy time
    bubble: float                     # 1 - sum(busy) / (ranks * t_end)
    park: Tuple[int, ...]             # per-rank park-slot high-water
    b_inbox: Tuple[int, ...]          # per-rank bwd-inbox high-water
    fs: Tuple[int, ...]               # per-rank stream-stash high-water
    resid: Tuple[int, ...]            # per-rank residual-stash high-water
    n_stages: int
    ranks: int

    def carry_slots(self, rank: int) -> int:
        """Activation-sized buffer slots rank ``rank`` allocates."""
        return int(self.park[rank]) + int(self.b_inbox[rank]) \
            + int(self.fs[rank])


def plan_cost(schedule: str, m: int, n: int, *,
              residuals: str = "recompute", remat: str = "dots",
              executor: str = "spmd", comm_cost: float = 0.0,
              bwd_comm_cost: Optional[float] = None,
              route_edges: Sequence[Tuple[int, int]] = (),
              route_comm_cost: Optional[float] = None,
              stage_weights: Optional[Sequence[float]] = None,
              rank_slowdown: Optional[Sequence[float]] = None) -> PlanCost:
    """Score one (schedule, m, n) point: device-model time + exact memory.

    The stable query the automatic planner drives: builds the named
    schedule's task table, prices it with ``stage_weights`` (per-GLOBAL-
    stage forward cost in stage-forward units; ``None`` = the uniform
    ``ranks / n_stages`` share of :func:`schedules.default_task_cost`),
    runs :func:`schedules.simulate_device_times` with the comm/overlap
    terms (``bwd_comm_cost``/``route_edges``/``route_comm_cost`` price
    the cotangent chain and skip-route wire hops; see
    :func:`schedule_bubble`), and lowers the table once to read the
    executor's true per-rank buffer high-water marks.

    ``rank_slowdown`` prices a degraded pool (per-rank compute-time
    multipliers >= 1; see :func:`schedules.simulate_device_times`) — the
    planner's straggler-sensitivity term.
    """
    table, n_stages, ranks = schedule_table(schedule, m, n)
    if stage_weights is None:
        cost_of = schedules.default_task_cost(
            n_stages, ranks, residuals=residuals, remat=remat)
    else:
        if len(stage_weights) != n_stages:
            raise ValueError(f"stage_weights has {len(stage_weights)} "
                             f"entries for {n_stages} stages")
        cost_of = schedules.weighted_task_cost(
            stage_weights, residuals=residuals, remat=remat)
    t_end, busy = schedules.simulate_device_times(
        table, ranks, cost_of, comm_cost=comm_cost,
        overlap_comm=executor == "mpmd",
        bwd_comm_cost=bwd_comm_cost, route_edges=route_edges,
        route_comm_cost=route_comm_cost, rank_slowdown=rank_slowdown)
    tplan = plan_for(schedule, m, n, residuals=residuals)
    bubble = 1.0 - sum(busy) / (ranks * t_end) if t_end > 0 else 0.0

    def per_rank(values, fallback):
        if len(values) == ranks:
            return tuple(int(x) for x in values)
        return tuple(int(fallback) for _ in range(ranks))

    return PlanCost(
        t_end=float(t_end), busy=tuple(float(b) for b in busy),
        bubble=float(bubble),
        park=per_rank(tplan.per_stage_park, tplan.park_depth),
        b_inbox=per_rank(tplan.per_stage_b_inbox, tplan.b_inbox_depth),
        fs=per_rank(tplan.per_stage_fs, tplan.fs_depth),
        resid=per_rank(tplan.per_stage_resid, tplan.resid_depth),
        n_stages=n_stages, ranks=ranks)


def plan_time(schedule: str, m: int, n: int, *,
              residuals: str = "recompute", remat: str = "dots",
              executor: str = "spmd", comm_cost: float = 0.0,
              bwd_comm_cost: Optional[float] = None,
              stage_weights: Optional[Sequence[float]] = None,
              rank_slowdown: Optional[Sequence[float]] = None) -> float:
    """Device-model makespan ONLY — :func:`plan_cost` without the plan
    lowering.  The straggler-sensitivity sweep re-prices every candidate
    once per rank (one slow rank at a time); the buffer high-waters don't
    change under a slowdown, so paying :func:`plan_for`'s full lowering
    ``ranks`` extra times per candidate would be pure waste."""
    table, n_stages, ranks = schedule_table(schedule, m, n)
    if stage_weights is None:
        cost_of = schedules.default_task_cost(
            n_stages, ranks, residuals=residuals, remat=remat)
    else:
        cost_of = schedules.weighted_task_cost(
            stage_weights, residuals=residuals, remat=remat)
    t_end, _ = schedules.simulate_device_times(
        table, ranks, cost_of, comm_cost=comm_cost,
        overlap_comm=executor == "mpmd", bwd_comm_cost=bwd_comm_cost,
        rank_slowdown=rank_slowdown)
    return float(t_end)


def plan_for(schedule: str, m: int, n: int, *,
             skips: Sequence[SkipSpec] = (),
             portals: bool = True,
             residuals: str = "recompute",
             wire: Optional[WireSpec] = None) -> TaskPlan:
    """Build + lower the named schedule for ``n`` pipe ranks.

    ``"gpipe"``/``"gpipe_tasked"``, ``"1f1b"``, ``"interleaved:v"`` and
    ``"zb"`` produce full F+B plans for the fused executor;
    ``"gpipe_fwd"`` produces the forward-only clock-cycle plan (paper
    Algorithm 1) that inference and the autodiff-backward path execute.
    ``residuals="reuse"`` adds the Bx->Bw residual-stash events to
    split-backward plans (``"zb"``); ``wire`` selects the on-the-wire
    codec (default fp32 identity).
    """
    if parse_schedule(schedule)[0] == "gpipe_fwd":
        table = [list(tick) for tick in schedules.clock_cycles(m, n)]
        return lower_tasks(table, m, n, skips=skips, portals=portals,
                           forward_only=True, wire=wire)
    table, n_stages, ranks = schedule_table(schedule, m, n)
    return lower_tasks(table, m, n_stages, ranks=ranks, skips=skips,
                       portals=portals, residuals=residuals, wire=wire)


def assert_route_overlap(tplan: TaskPlan) -> int:
    """Plan-level tripwire: no route hop serializes after its producer.

    For every route arrival (value and cotangent) there must be a latch —
    a non--1 ``send`` entry — one tick EARLIER on the rank the arrival's
    permute sources from (the rank itself for same-rank identity holds).
    That is exactly the property the mpmd executor's double buffering
    relies on to ship route payloads at the top of the arrival tick,
    overlapped with that tick's compute.  Returns the number of arrivals
    checked; raises ``AssertionError`` with the offending (route, tick,
    rank) on violation.
    """
    checked = 0
    for rt in tplan.routes:
        for tag, arrs, sends, perm in (("value", rt.recv, rt.send,
                                        rt.fwd_perm),
                                       ("cotangent", rt.g_recv, rt.g_send,
                                        rt.bwd_perm)):
            src_of = {d: s for s, d in perm}
            for t, r in zip(*np.nonzero(arrs >= 0)):
                t, r = int(t), int(r)
                assert t >= 1, \
                    (f"route {rt.key} {tag} arrival at tick 0 on rank {r} "
                     f"has no earlier latch tick")
                src = src_of.get(r, r)
                assert sends[t - 1, src] != -1, \
                    (f"route {rt.key} {tag} arrival at tick {t} rank {r} "
                     f"has no latch at tick {t - 1} on source rank {src} — "
                     f"the hop would serialize after its producer")
                checked += 1
    return checked
