"""Pipeline schedules as host-level task tables.

The paper's *deterministic clock-cycle* (Algorithm 1) totally orders the tasks
``F_{i,j}`` by their distance ``k = i + j`` to ``F_{0,0}`` (0-indexed here; the
paper uses 1-indexing so its ``k = i + j - 1``).  In an eager framework that
ordering is what the host thread must issue; in our trace-and-compile setting
the same ordering is realized *structurally* by a scan over clock ticks — this
module is the single source of truth both for that scan (which tick runs which
task) and for the property tests that prove the orderings agree with the
paper's Algorithm 1 and its dependency constraints (§2.1).

Task naming follows the paper: F(i, j) is the forward of micro-batch ``i`` on
partition ``j``; B(i, j) its backward; R(i, j) the recomputation ``F'_{i,j}``.

Beyond-paper schedules extend the same vocabulary:

* **interleaved 1F1B** (Megatron-style virtual stages, Narayanan et al.):
  the model is cut into ``n * v`` stages and rank ``r`` hosts the *chunks*
  ``{r, r + n, ..., r + (v-1) n}``.  ``Task.stage`` is always the GLOBAL
  stage index; the executing rank is ``stage % n``.  Finer stages shrink
  the fill/drain bubble by ~``1/v`` at the cost of ``v``× more boundary
  hops.

* **zero-bubble split backward** (ZB-H1 flavour, arXiv 2405.18047 /
  2401.10241): ``B`` is decomposed into ``Bx`` (input cotangent — the only
  part on the inter-stage critical path) and ``Bw`` (weight gradient),
  and the ``Bw`` tasks are drained into ticks where a rank would otherwise
  idle.  ``Bx`` inherits B's dependency chain; ``Bw(i,j)`` only requires
  ``Bx(i,j)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

#: kinds that chain backwards across stages (B(i,j) needs <kind>(i,j+1))
_BWD_CHAIN = ("B", "Bx")


@dataclass(frozen=True, order=True)
class Task:
    kind: str        # "F" | "B" | "R" | "Bx" | "Bw"
    micro: int       # i  (0-indexed)
    stage: int       # j  (0-indexed, GLOBAL stage — rank is stage % n_ranks)

    def __repr__(self) -> str:  # compact: F[i,j]
        return f"{self.kind}[{self.micro},{self.stage}]"


def clock_cycles(m: int, n: int) -> Iterator[List[Task]]:
    """Paper Algorithm 1 (deterministic clock-cycle), 0-indexed.

    Yields, for each clock tick ``k = 0 .. m+n-2``, the list of forward tasks
    ``F_{i,j}`` with ``i + j == k``.  Tasks within one tick are independent
    (they touch different stages *and* different micro-batches) and may be
    issued concurrently, exactly as in the paper.
    """
    if m < 1 or n < 1:
        raise ValueError(f"need m >= 1 and n >= 1, got {m=} {n=}")
    for k in range(m + n - 1):
        yield [Task("F", i, k - i)
               for i in range(max(0, k - n + 1), min(m, k + 1))]


def gpipe_backward_cycles(m: int, n: int, *, checkpoint: bool = True,
                          recompute_last_micro: bool = False) -> Iterator[List[Task]]:
    """The reverse clock-cycle that autodiff induces for GPipe.

    Backward task ``B_{i,j}`` runs at reverse tick ``k' = (m-1-i) + (n-1-j)``.
    With checkpointing, the recomputation ``R_{i,j}`` is scheduled in the same
    tick immediately before ``B_{i,j}`` — except for each stage's *last*
    forward micro-batch (``i == m-1``), whose recompute the paper elides
    (§2.1: "re-computations for the last micro-batch are unnecessary").
    """
    for k in range(m + n - 1):
        tasks: List[Task] = []
        for i in range(m):
            j = (m - 1 - i) + (n - 1) - k
            if 0 <= j < n:
                if checkpoint and (recompute_last_micro or i != m - 1):
                    tasks.append(Task("R", i, j))
                tasks.append(Task("B", i, j))
        yield tasks


def gpipe_schedule(m: int, n: int, *, checkpoint: bool = True,
                   recompute_last_micro: bool = False) -> List[List[Task]]:
    """Full GPipe schedule: forward fill-drain, then backward fill-drain."""
    fwd = list(clock_cycles(m, n))
    bwd = list(gpipe_backward_cycles(m, n, checkpoint=checkpoint,
                                     recompute_last_micro=recompute_last_micro))
    return fwd + bwd


# ---------------------------------------------------------------------------
# Dependency-driven packing (shared by 1F1B / interleaved / zero-bubble)
# ---------------------------------------------------------------------------

def _pack(per_rank: Sequence[Sequence[Task]], ranks: int, n_stages: int,
          *, fill_bw: bool = False) -> List[List[Task]]:
    """Greedily pack fixed per-rank task orders into the earliest ticks that
    satisfy the cross-stage dependencies (F(i,s) after F(i,s-1); a backward-
    chain task after its successor stage's; the last stage's backward after
    its own forward).

    With ``fill_bw`` every executed ``Bx(i,s)`` enqueues ``Bw(i,s)`` on the
    owning rank; a rank whose next main-queue task is not yet runnable (or
    whose queue is drained) runs its oldest pending ``Bw`` instead — the
    ZB-H1 bubble-filling rule.  ``Bw`` has no cross-rank dependencies, so
    the fill can never deadlock.
    """
    done = {}
    ptr = [0] * ranks
    pending_w: List[List[Task]] = [[] for _ in range(ranks)]
    table: List[List[Task]] = []
    t = 0

    def runnable(task: Task) -> bool:
        if task.kind == "F":
            return task.stage == 0 or Task("F", task.micro, task.stage - 1) in done
        assert task.kind in _BWD_CHAIN
        if task.stage == n_stages - 1:
            return Task("F", task.micro, task.stage) in done
        return any(Task(k, task.micro, task.stage + 1) in done
                   for k in _BWD_CHAIN)

    while any(ptr[r] < len(per_rank[r]) for r in range(ranks)) \
            or any(pending_w):
        tick: List[Task] = []
        for r in range(ranks):
            task: Optional[Task] = None
            if ptr[r] < len(per_rank[r]) and runnable(per_rank[r][ptr[r]]):
                task = per_rank[r][ptr[r]]
                ptr[r] += 1
            elif pending_w[r]:
                task = pending_w[r].pop(0)
            if task is not None:
                tick.append(task)
        if not tick:
            raise RuntimeError(f"schedule deadlock at tick {t}, ptrs={ptr}")
        for task in tick:
            done[task] = t
            if fill_bw and task.kind == "Bx":
                pending_w[task.stage % ranks].append(
                    Task("Bw", task.micro, task.stage))
        table.append(tick)
        t += 1
    return table


def one_f_one_b_schedule(m: int, n: int) -> List[List[Task]]:
    """1F1B (PipeDream-flush) schedule — beyond-paper optimization.

    Same synchronous semantics as GPipe (flush every mini-batch) but each
    stage starts draining backward as soon as its first backward dependency
    resolves, bounding stashed activations by ``n - j`` instead of ``m``.

    Built per-stage: stage ``j`` runs ``min(n - j, m)`` warmup forwards, then
    alternates 1F/1B, then drains remaining backwards.  The global table is
    produced by packing the per-stage queues under the cross-stage
    dependencies (F(i,j) needs F(i,j-1); B(i,j) needs B(i,j+1)).
    """
    per_rank = [_one_f_one_b_order(m, n, j, bwd_kind="B") for j in range(n)]
    return _pack(per_rank, n, n)


def _one_f_one_b_order(m: int, n: int, j: int, *, bwd_kind: str) -> List[Task]:
    """Stage ``j``'s 1F1B issue order: warmup forwards, steady 1F/1B, drain."""
    warm = min(n - j, m)
    order: List[Task] = [Task("F", i, j) for i in range(warm)]
    fi, bi = warm, 0
    while bi < m:
        order.append(Task(bwd_kind, bi, j)); bi += 1
        if fi < m:
            order.append(Task("F", fi, j)); fi += 1
    return order


def interleaved_1f1b_schedule(m: int, n: int, v: int) -> List[List[Task]]:
    """Interleaved 1F1B with ``v`` virtual stages (chunks) per rank.

    Megatron-style (Narayanan et al., PAPERS.md): global stage
    ``s = c * n + r`` runs on rank ``r = s % n``; micro-batches advance in
    waves of ``n``, cycling through the chunks, so the fill bubble shrinks
    from ``(n-1)`` full-stage slots to ``(n-1)`` chunk slots (≈ ``1/v``).
    Requires ``m % n == 0`` (the wave width), per Megatron.
    """
    if v < 1:
        raise ValueError(f"need v >= 1, got {v=}")
    if v == 1:
        return one_f_one_b_schedule(m, n)
    if m % n:
        raise ValueError(
            f"interleaved schedule needs n_micro ({m}) divisible by "
            f"pipe ({n})")

    def unit(r: int, k: int, *, back: bool) -> Task:
        c = (k // n) % v
        if back:
            c = v - 1 - c
        i = (k // (n * v)) * n + (k % n)
        return Task("B" if back else "F", i, c * n + r)

    total = m * v
    per_rank: List[List[Task]] = []
    for r in range(n):
        warm = min((n - r - 1) * 2 + (v - 1) * n, total)
        order = [unit(r, k, back=False) for k in range(warm)]
        fi, bi = warm, 0
        while bi < total:
            if fi < total:
                order.append(unit(r, fi, back=False)); fi += 1
            order.append(unit(r, bi, back=True)); bi += 1
        per_rank.append(order)
    return _pack(per_rank, n, n * v)


def zb_schedule(m: int, n: int) -> List[List[Task]]:
    """ZB-H1-style split-backward schedule (arXiv 2405.18047).

    1F1B's issue order with ``B`` replaced by ``Bx`` (input cotangent — the
    only backward half other stages wait for), while the decoupled weight
    gradients ``Bw`` fill ticks where a rank's main queue is blocked and the
    drain tail.  Same flush semantics and activation bound as 1F1B; the
    bubble fraction drops because former idle slots now do useful work.
    """
    per_rank = [_one_f_one_b_order(m, n, j, bwd_kind="Bx") for j in range(n)]
    return _pack(per_rank, n, n, fill_bw=True)


# ---------------------------------------------------------------------------
# Schedule metrics (used by tests and by the balance/bubble reporting)
# ---------------------------------------------------------------------------

def bubble_fraction(table: Sequence[Sequence[Task]], *,
                    ranks: Optional[int] = None) -> float:
    """Idle share of the table: idle (rank, tick) slots / total slots.

    Computed from the task table itself, so it is correct for every
    schedule shape — GPipe's fill/drain gives the paper's closed form
    ``(n-1)/(m+n-1)``, 1F1B the same, interleaved ≈ ``(n-1)/v`` chunk
    slots, and split-backward tables get credit for the ``Bw``-filled
    ticks.  ``ranks`` defaults to the number of distinct executing ranks
    (``stage % ranks``) inferred as ``max stage + 1``; pass it explicitly
    for chunked tables.  R (recompute) tasks ride along with their B and
    are not counted as separate busy slots.
    """
    if not table:
        return 0.0
    if ranks is None:
        ranks = max(t.stage for tick in table for t in tick) + 1
    T = len(table)
    busy = sum(1 for tick in table for t in tick if t.kind != "R")
    return 1.0 - busy / (T * ranks)


def ideal_bubble_fraction(m: int, n: int) -> float:
    """The paper's closed form for the GPipe clock: (n-1)/(m+n-1)."""
    return (n - 1) / (m + n - 1)


def peak_stash(table: Sequence[Sequence[Task]], n: int,
               *, ranks: Optional[int] = None) -> List[int]:
    """Peak number of outstanding forward activations stashed per stage.

    An activation goes live at its F and is freed by the LAST backward
    reader: ``B`` for fused tables, ``Bw`` for split-backward tables (the
    weight gradient still needs the stage input after ``Bx`` ran).  With
    ``ranks`` given, stages co-resident on one rank (interleaved chunks)
    are aggregated into per-RANK peaks — the footprint a device allocator
    actually charges.
    """
    has_bw = any(t.kind == "Bw" for tick in table for t in tick)
    free_kind = "Bw" if has_bw else "B"
    slots = ranks if ranks is not None else n
    live = [0] * slots
    peak = [0] * slots
    for tick in table:
        for t in tick:
            r = t.stage % slots
            if t.kind == "F":
                live[r] += 1
                peak[r] = max(peak[r], live[r])
            elif t.kind == free_kind:
                live[r] -= 1
    return peak


def _tick_index(table: Sequence[Sequence[Task]]):
    """Tick of each task, split by family: (F, B-or-Bx, Bw) dicts keyed
    ``(micro, stage)``."""
    f: dict = {}
    b: dict = {}
    w: dict = {}
    for t, tick in enumerate(table):
        for task in tick:
            if task.kind == "F":
                f[(task.micro, task.stage)] = t
            elif task.kind in ("B", "Bx"):
                b[(task.micro, task.stage)] = t
            elif task.kind == "Bw":
                w[(task.micro, task.stage)] = t
    return f, b, w


def _max_overlap(intervals: Sequence[Tuple[int, int]]) -> int:
    """Peak number of concurrently live CLOSED intervals [a, c].

    This is exactly the high-water mark of plan.py's free-list slot
    allocator (``_alloc_intervals``): a slot is reusable strictly after its
    last-use tick, so the allocator's peak equals the maximum overlap of
    the closed intervals — the interval-graph clique number.
    """
    if not intervals:
        return 0
    events = sorted([(a, 1) for a, _ in intervals]
                    + [(c + 1, -1) for _, c in intervals])
    live = peak = 0
    for _, d in events:
        live += d
        peak = max(peak, live)
    return peak


def peak_park(table: Sequence[Sequence[Task]], n: int,
              *, ranks: Optional[int] = None) -> List[int]:
    """EXACT per-rank high-water of the donated park buffer plan.py
    allocates: one interval per (micro, stage >= 1) boundary value, live
    from its ring arrival (producer's F + 1) until its last backward reader
    (``Bw`` for split tables, ``B`` otherwise; the consuming F for
    forward-only tables).  Unlike :func:`peak_stash` (the schedule-level
    activation bound), this predicts ``TaskPlan.per_stage_park`` slot for
    slot — stage 0 parks nothing, and the one-tick in-flight arrival is
    included."""
    slots = ranks if ranks is not None else n
    f, b, w = _tick_index(table)
    per_rank: List[List[Tuple[int, int]]] = [[] for _ in range(slots)]
    for (i, s), tf in f.items():
        if s == 0:
            continue
        arrive = f[(i, s - 1)] + 1
        last = w.get((i, s), b.get((i, s), tf))
        per_rank[s % slots].append((arrive, last))
    return [_max_overlap(iv) for iv in per_rank]


def peak_residuals(table: Sequence[Sequence[Task]], n: int,
                   *, ranks: Optional[int] = None) -> List[int]:
    """EXACT per-rank high-water of the residual stash a ``reuse`` plan
    allocates: one interval per (micro, stage), live from the Bx tick that
    materializes the vjp residuals until the Bw tick that consumes them.
    All zeros for fused-backward tables (nothing crosses ticks)."""
    slots = ranks if ranks is not None else n
    _, b, w = _tick_index(table)
    per_rank: List[List[Tuple[int, int]]] = [[] for _ in range(slots)]
    for (i, s), tw in w.items():
        tb = b.get((i, s))
        if tb is None:
            raise ValueError(f"Bw[{i},{s}] has no matching Bx")
        per_rank[s % slots].append((tb, tw))
    return [_max_overlap(iv) for iv in per_rank]


def default_task_cost(n_stages: int, ranks: Optional[int] = None,
                      *, residuals: str = "recompute", remat: str = "dots"):
    """Per-task cost model of the FUSED EXECUTOR, in stage-forward units.

    A stage holds ``ranks / n_stages`` of the model, so interleaved chunks
    cost proportionally less per task.  Backward flavours reflect what the
    executor actually runs (remat recompute included): fused ``B`` =
    recompute + input-grad + weight-grad = 3 forwards' work; split ``Bx`` /
    ``Bw`` = recompute + one gradient half = 2 each (the split pays one
    extra recompute per micro — ZB's remat tradeoff, visible here rather
    than hidden).  With ``residuals="reuse"`` the Bw re-reads the residuals
    its Bx stashed instead of rematerializing, so ``Bw`` drops to 1 (the
    weight-grad half alone) and the split's total cost returns to the fused
    ``B``'s 3 — true ZB-H1 pricing.  EXCEPT under ``remat="full"``: the
    full policy saves only the stage boundary inputs, so there is nothing
    to stash and the executor's Bw still rematerializes (the degenerate
    crossing the README policy table documents) — priced at 2 so the cost
    model never promises a payoff the executor cannot deliver.
    """
    ranks = n_stages if ranks is None else ranks
    share = ranks / n_stages          # fraction of the model per stage
    return weighted_task_cost([share] * n_stages,
                              residuals=residuals, remat=remat)


def weighted_task_cost(stage_weights: Sequence[float],
                       *, residuals: str = "recompute", remat: str = "dots"):
    """Per-task cost model with NON-UNIFORM stage weights.

    ``stage_weights[s]`` is stage ``s``'s forward cost in stage-forward
    units — for a balanced partition, ``stage_flops_s / total_flops *
    ranks`` so uniform stages reduce to :func:`default_task_cost`'s
    ``ranks / n_stages`` share.  Backward flavours use the same
    multipliers as :func:`default_task_cost` (B=3, Bx=2, Bw=1|2 per the
    residuals/remat pricing documented there).
    """
    weights = [float(w) for w in stage_weights]
    bw = 1.0 if residuals == "reuse" and remat != "full" else 2.0
    per_kind = {"F": 1.0, "B": 3.0, "Bx": 2.0, "Bw": bw, "R": 0.0}

    def cost(task: Task) -> float:
        return per_kind[task.kind] * weights[task.stage]
    return cost


def simulate_device_times(table: Sequence[Sequence[Task]], ranks: int,
                          cost_of=None, *, comm_cost: float = 0.0,
                          overlap_comm: bool = False,
                          bwd_comm_cost: Optional[float] = None,
                          route_edges: Sequence[Tuple[int, int]] = (),
                          route_comm_cost: Optional[float] = None,
                          overlap_routes: Optional[bool] = None,
                          rank_slowdown: Optional[Sequence[float]] = None
                          ) -> Tuple[float, List[float]]:
    """Event-driven critical path of a table on ``ranks`` DEDICATED devices.

    Each rank executes its tasks in table order; a task starts when its
    rank is free AND its cross-stage dependencies (F chain, backward
    chain, Bw-after-Bx, skip-route arrivals) have finished.  Returns
    ``(t_end, per_rank_busy)``; the pipeline bubble a device group
    actually pays is ``1 - sum(busy) / (ranks * t_end)``.

    ``comm_cost`` prices one cross-RANK boundary hop (chain ``ppermute``)
    in the same stage-forward units as ``cost_of`` (0 = the legacy
    zero-latency clock; co-resident interleaved chunks hop for free).
    ``bwd_comm_cost`` prices the cotangent chain hop separately (``None``
    = ``comm_cost``) — with a wire codec the two payload classes can ship
    at different precisions, so their byte-derived costs differ.
    ``overlap_comm`` selects the executor's comm story:

    * ``False`` (SPMD reference): the send is issued at the end of the
      producing task on the compute stream — the producer's rank is
      BLOCKED for the hop cost after the task, and the consumer sees
      ``finish + hop``.
    * ``True`` (MPMD double buffering): the send is latched and shipped
      one tick ahead, overlapping the producer's next compute — the
      consumer still sees ``finish + hop``, but the producer's rank
      is free immediately.  Pointwise no later than the serialized story,
      so the mpmd model is <= the spmd model for every table.

    ``route_edges`` lists skip/portal ``(src_stage, dst_stage)`` edges:
    ``F(i, dst)`` additionally waits on ``F(i, src)`` plus
    ``route_comm_cost`` (``None`` = ``comm_cost``) when the edge crosses
    ranks, and the mirrored cotangent makes the producer's backward wait
    on the consumer's.  ``overlap_routes`` (``None`` = follow
    ``overlap_comm``) decides whether route sends stall the producing
    rank (eager, serialized after the producer) or ship latched one tick
    ahead like the chain carry — the route double buffering.

    This is the schedule-comparison clock for the speed tables: a
    single-host CPU bench timeshares every "device" over the same cores,
    so measured wall-clock reflects TOTAL work, not the critical path the
    schedule shortens (benchmarks/util.py documents the same convention
    for the paper-table model).

    ``rank_slowdown`` prices a DEGRADED pool: ``rank_slowdown[r]`` is a
    multiplicative compute-time factor (>= 1) applied to every task that
    rank ``r`` executes — a thermally throttled or contended straggler
    runs its tasks slower while the wire costs stay unchanged.  Because a
    pipeline step is a dependency chain through every rank, one slow rank
    delays every downstream consumer; the planner uses this term to rank
    plans by straggler *sensitivity*, not just healthy-path speed.
    """
    n_stages = max((t.stage for tick in table for t in tick), default=0) + 1
    if cost_of is None:
        cost_of = default_task_cost(n_stages, ranks)
    bwd_comm_cost = comm_cost if bwd_comm_cost is None else bwd_comm_cost
    route_comm_cost = comm_cost if route_comm_cost is None \
        else route_comm_cost
    overlap_routes = overlap_comm if overlap_routes is None \
        else overlap_routes
    route_edges = tuple((int(a), int(b)) for a, b in route_edges)
    if rank_slowdown is None:
        slow = [1.0] * ranks
    else:
        slow = [float(s) for s in rank_slowdown]
        if len(slow) != ranks:
            raise ValueError(
                f"rank_slowdown has {len(slow)} entries for {ranks} ranks")
        if any(s < 1.0 for s in slow):
            raise ValueError("rank_slowdown factors must be >= 1")
    split = any(t.kind == "Bx" for tick in table for t in tick)
    bk = "Bx" if split else "B"
    finish: dict = {}
    rank_free = [0.0] * ranks
    busy = [0.0] * ranks

    def hop(a_stage: int, b_stage: int, cost: float) -> float:
        """Comm latency for a stage -> stage payload hop."""
        if a_stage % ranks == b_stage % ranks:
            return 0.0             # co-resident chunk: no collective hop
        return cost

    for tick in table:
        for task in sorted(tick):
            if task.kind == "R":
                continue
            # (dependency task, wire latency it arrives with)
            deps: List[Tuple[Task, float]] = []
            if task.kind == "F":
                if task.stage > 0:
                    deps.append((Task("F", task.micro, task.stage - 1),
                                 hop(task.stage - 1, task.stage, comm_cost)))
                for src, dst in route_edges:
                    if dst == task.stage:
                        deps.append((Task("F", task.micro, src),
                                     hop(src, dst, route_comm_cost)))
            elif task.kind == bk:
                if task.stage == n_stages - 1:
                    deps.append((Task("F", task.micro, task.stage), 0.0))
                else:
                    deps.append((Task(bk, task.micro, task.stage + 1),
                                 hop(task.stage + 1, task.stage,
                                     bwd_comm_cost)))
                for src, dst in route_edges:
                    if src == task.stage:
                        deps.append((Task(bk, task.micro, dst),
                                     hop(dst, src, route_comm_cost)))
            elif task.kind == "Bw":
                deps.append((Task("Bx", task.micro, task.stage), 0.0))
            r = task.stage % ranks
            start = max([rank_free[r]]
                        + [finish[d] + h for d, h in deps])
            c = cost_of(task) * slow[r]
            finish[task] = start + c
            rank_free[r] = start + c
            busy[r] += c
            # serialized sends: the producer's compute stream carries the
            # hop, blocking the rank until the wire drains.  The stall
            # counts as bubble (busy stays compute-only), so the spmd
            # bubble fraction >= the mpmd one and a step-time estimate
            # dividing by (1 - bubble) moves the right way.
            if not overlap_comm:
                if task.kind == "F" and task.stage < n_stages - 1 \
                        and (task.stage + 1) % ranks != r and comm_cost:
                    rank_free[r] += comm_cost
                elif task.kind in _BWD_CHAIN and task.stage > 0 \
                        and (task.stage - 1) % ranks != r and bwd_comm_cost:
                    rank_free[r] += bwd_comm_cost
            if not overlap_routes and route_comm_cost:
                # eager route sends: each outgoing value/cotangent hop
                # drains on the producer's stream (the story before route latching)
                for src, dst in route_edges:
                    if task.kind == "F" and src == task.stage \
                            and dst % ranks != r:
                        rank_free[r] += route_comm_cost
                    elif task.kind == bk and dst == task.stage \
                            and src % ranks != r:
                        rank_free[r] += route_comm_cost
    return max(rank_free, default=0.0), busy


def device_bubble_fraction(table: Sequence[Sequence[Task]], ranks: int,
                           cost_of=None, *, comm_cost: float = 0.0,
                           overlap_comm: bool = False,
                           bwd_comm_cost: Optional[float] = None,
                           route_edges: Sequence[Tuple[int, int]] = (),
                           route_comm_cost: Optional[float] = None,
                           overlap_routes: Optional[bool] = None,
                           rank_slowdown: Optional[Sequence[float]] = None
                           ) -> float:
    """Idle share of the dedicated-device critical path (cost-weighted)."""
    t_end, busy = simulate_device_times(table, ranks, cost_of,
                                        comm_cost=comm_cost,
                                        overlap_comm=overlap_comm,
                                        bwd_comm_cost=bwd_comm_cost,
                                        route_edges=route_edges,
                                        route_comm_cost=route_comm_cost,
                                        overlap_routes=overlap_routes,
                                        rank_slowdown=rank_slowdown)
    if t_end <= 0:
        return 0.0
    return 1.0 - sum(busy) / (ranks * t_end)


def validate(table: Sequence[Sequence[Task]], m: int, n: int,
             *, ranks: Optional[int] = None,
             checkpoint: bool = False,
             recompute_last_micro: bool = False,
             backward_micro_order: bool = True,
             forward_only: bool = False) -> None:
    """Assert the schedule respects every dependency in the paper's §2 graph.

    ``n`` is the number of (global) stages; ``ranks`` the number of
    executing devices (defaults to ``n``; chunked tables pass the physical
    rank count so per-rank single-task-per-tick is enforced across chunks).

    Raises AssertionError on: missing/duplicate tasks, F(i,j) before
    F(i,j-1), a backward-chain task before its successor stage's,
    per-stage micro-batch order violations (F(i+1,j) before F(i,j) /
    B(i-1,j) before B(i,j), the dashed arrows of Fig. 2), a B(i,j) without
    its R(i,j) earlier in the same stage, or — for split-backward tables —
    a ``Bw(i,j)`` missing or preceding its ``Bx(i,j)``.

    ``backward_micro_order=False`` relaxes the B-side dashed-arrow order:
    1F1B deliberately drains early backwards (B[i] before B[i+1] at a
    stage), which is a *schedule choice* in GPipe, not a data dependency.

    ``forward_only=True`` validates an inference / autodiff-backward plan:
    the table must cover every F task and contain no backward at all (the
    reverse clock-cycle is induced outside the table).
    """
    ranks = n if ranks is None else ranks
    seen = {}
    order = 0
    for tick in table:
        ranks_this_tick = set()
        for t in tick:
            assert t not in seen, f"duplicate {t}"
            assert 0 <= t.stage < n, f"{t} stage out of range (n={n})"
            key = (t.stage % ranks, t.kind in ("B", "Bx", "Bw"), t.kind == "R")
            assert key not in ranks_this_tick, \
                f"rank {t.stage % ranks} runs two {t.kind}-side tasks in one tick"
            ranks_this_tick.add(key)
            seen[t] = order
        order += 1
    have = set(seen)
    split = any(t.kind in ("Bx", "Bw") for t in have)
    bk = "Bx" if split else "B"
    expect_f = {Task("F", i, j) for i in range(m) for j in range(n)}
    assert expect_f <= have, f"missing forwards: {sorted(expect_f - have)[:4]}"
    if forward_only:
        assert not any(t.kind != "F" for t in have), \
            "forward-only table contains backward tasks"
    else:
        expect_b = {Task(bk, i, j) for i in range(m) for j in range(n)}
        assert expect_b <= have, \
            f"missing backwards: {sorted(expect_b - have)[:4]}"
        if split:
            expect_w = {Task("Bw", i, j) for i in range(m) for j in range(n)}
            assert expect_w <= have, \
                f"missing weight grads: {sorted(expect_w - have)[:4]}"
            assert not any(t.kind == "B" for t in have), \
                "split-backward table mixes fused B with Bx/Bw"
    for i in range(m):
        for j in range(n):
            if forward_only:
                if j > 0:
                    assert seen[Task("F", i, j - 1)] < seen[Task("F", i, j)]
                if i > 0:
                    assert seen[Task("F", i - 1, j)] < seen[Task("F", i, j)]
                continue
            assert seen[Task("F", i, j)] < seen[Task(bk, i, j)], \
                f"F[{i},{j}] must precede {bk}[{i},{j}]"
            if split:
                assert seen[Task("Bx", i, j)] < seen[Task("Bw", i, j)], \
                    f"Bx[{i},{j}] must precede Bw[{i},{j}]"
            if j > 0:
                assert seen[Task("F", i, j - 1)] < seen[Task("F", i, j)]
                assert seen[Task(bk, i, j)] < seen[Task(bk, i, j - 1)]
            if i > 0:
                assert seen[Task("F", i - 1, j)] < seen[Task("F", i, j)], \
                    f"micro-batch order: F[{i-1},{j}] !< F[{i},{j}]"
                if backward_micro_order:
                    assert seen[Task(bk, i, j)] < seen[Task(bk, i - 1, j)], \
                        f"micro-batch order: {bk}[{i},{j}] !< {bk}[{i-1},{j}]"
            if checkpoint:
                needs_r = recompute_last_micro or i != m - 1
                if needs_r:
                    r = Task("R", i, j)
                    assert r in seen and seen[r] <= seen[Task("B", i, j)], \
                        f"{r} must precede B[{i},{j}]"
