"""Stages in their own processes: the fused executor across gloo ranks on
the CPU, against the port's own single-process executor.

One spawned group per world size (R = 2 and R = 4,
``tests/_torch_dist_ranks.py``) runs all its cases and saves them, with
the single-process runs of the same cases, under a temporary directory;
the tests below read them from a module-scoped fixture.  Every process
keeps torch to one thread.  The cases:

* smollm smoke, ``1f1b``, ``gpipe_tasked``, ``zb`` (recompute and reuse)
  and ``interleaved:2`` at R = 2, and ``1f1b`` at R = 4, each under the
  ``spmd`` and ``mpmd`` send disciplines; whisper smoke at R = 4,
  streamed, with its portal routes, under the ``bf16`` and ``int8-ef``
  wires: the loss and every gradient leaf **bitwise** equal to the single
  process's, the per-rank buffer high-water equal to
  ``plan.specialize(...).buffer_slots()``, the hops and bytes per payload
  class equal to ``core/wire.plan_wire_report``'s;
* two AdamW steps with clipping on the tied smollm at R = 2: the first
  loss bitwise, both within ``TOL`` (the group's norm sums in another
  order), the params within ``TOL``, the two embedding copies bitwise
  equal; the same through ``launch.train.train`` (what ``--nproc`` runs),
  with every rank's records on every rank;
* a U-Net's fused 1F1B at R = 2 (``hetero_grad_call`` with the group);
* a rank that raises mid-step fails the group within its time limit,
  naming the rank and the error, with a deadline on the group or none;
* ``plan.specialize`` equals the reference's over the fused schedules.

The multi-process run held against the JAX oracle is in
``tests/test_torch_fused.py``, which already holds that oracle.
"""
import time

import numpy as np
import pytest
import torch
from torch.multiprocessing import ProcessRaisedException

import _torch_dist_ranks as ranks_lib
from repro.core import plan as jplan
from repro.core import skip as jskip
from repro_torch.core import plan as tplan_lib
from repro_torch.core.skip import SkipSpec
from repro_torch.core.wire import plan_wire_report
from repro_torch.launch import mesh
from repro_torch.tree import tree_items

# tests/test_oracle.py's fp32 TOL
TOL = dict(rtol=5e-4, atol=5e-5)
SPAWN_S = 120                       # hard limit on one spawned group
SUITES = {name: ranks_lib.suite(name, n) for name, n in (("r2", 2),
                                                        ("r4", 4))}
GRAD_CASES = [(name, n) for sname, n in (("r2", 2), ("r4", 4))
              for name, case in SUITES[sname] if case["kind"] == "grads"]
HETERO_CASES = [name for name, case in SUITES["r2"]
                if case["kind"] == "hetero"]


def _spawn(out_dir, suite, nproc, cases=None, timeout_s=SPAWN_S):
    """Run one group; each rank's saved ``{"dist", "ref"}``."""
    mesh.spawn(ranks_lib.run_rank, nproc, (str(out_dir), suite, cases),
               timeout_s=timeout_s, rendezvous_dir=str(out_dir))
    return [torch.load(out_dir / f"rank{r}.pt") for r in range(nproc)]


def collect(saved):
    """Per case: every rank's result and the single-process one."""
    out = {}
    for name in saved[0]["dist"]:
        ref = next(s["ref"][name] for s in saved if name in s["ref"])
        out[name] = {"dist": [s["dist"][name] for s in saved], "ref": ref}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for suite, nproc in (("r2", 2), ("r4", 4)):
        tmp = tmp_path_factory.mktemp(suite)
        out.update({(name, nproc): run
                    for name, run in collect(_spawn(tmp, suite,
                                                    nproc)).items()})
    return out


def _case(name, nproc):
    suite = "r2" if nproc == 2 else "r4"
    return dict(SUITES[suite])[name]


def _model(name, nproc):
    return ranks_lib._model(_case(name, nproc), nproc)


def share_pairs(model, share, whole, rank):
    """``(path, rank's leaf, single-process leaf)`` for each leaf of a
    rank's share: its stages' rows, and the embedding and head it keeps."""
    R = model.pcfg.pipe
    rows = {k: v[rank::R] for k, v in tree_items(whole["stages"])}
    pairs = [(f"stages/{k}", v, rows[k])
             for k, v in tree_items(share["stages"])]
    for part in ("embed", "head"):
        if part in share:
            want = dict(tree_items(whole[part]))
            pairs += [(f"{part}/{k}", v, want[k])
                      for k, v in tree_items(share[part])]
    return pairs


def _tplan(model):
    p = model.pcfg
    return tplan_lib.plan_for(p.schedule, p.n_micro, p.pipe,
                              skips=model.skips(), portals=p.portals,
                              residuals=p.residuals, wire=p.wire)


@pytest.mark.parametrize("name, nproc", GRAD_CASES)
def test_dist_loss_and_grads_bitwise_equal_single_process(runs, name,
                                                           nproc):
    run, model = runs[(name, nproc)], _model(name, nproc)
    ref = run["ref"]
    covered = set()
    for r, got in enumerate(run["dist"]):
        assert torch.equal(got["loss"], ref["loss"]), f"rank {r} loss"
        for path, a, b in share_pairs(model, got["grads"], ref["grads"], r):
            assert torch.equal(a, b), f"{name} rank {r} {path}"
            covered.add(path.split("/")[0])
    assert covered == {"stages", "embed", "head"}


@pytest.mark.parametrize("name, nproc", GRAD_CASES)
def test_dist_buffer_high_water_equals_specialize(runs, name, nproc):
    model = _model(name, nproc)
    tplan = _tplan(model)
    streamed = model.pcfg.stream_inputs
    for r, got in enumerate(runs[(name, nproc)]["dist"]):
        park = got["park"]
        want = tplan_lib.specialize(tplan, r).buffer_slots()
        if not streamed:
            want.pop("fs")
        assert park["rank"] == r
        assert park["buffer_slots"] == want, f"rank {r}"
    for k, rt in enumerate(tplan.routes):
        highs = [got["park"]["per_route"][rt.key]
                 for got in runs[(name, nproc)]["dist"]]
        assert max(h["depth"] for h in highs) == rt.depth, rt.key
        assert max(h["g_depth"] for h in highs) == rt.g_depth, rt.key
    assert bool(tplan.routes) == model.arch.is_encdec


@pytest.mark.parametrize("name, nproc", GRAD_CASES)
def test_dist_hops_and_bytes_equal_plan_wire_report(runs, name, nproc):
    """Hops and payload bytes a step sent, per class and summed over the
    ranks, against the plan's pricing with the carry's real size (the
    smoke models are fp32: the fp32 codec ships 4 bytes an element)."""
    model = _model(name, nproc)
    tplan = _tplan(model)
    d = model.arch.d_model
    carry = ranks_lib.BATCH // ranks_lib.M * ranks_lib.SEQ * d * 4
    report = plan_wire_report(tplan, carry)
    got = {c: {k: sum(run["park"]["hops"][c][k]
                      for run in runs[(name, nproc)]["dist"])
               for k in ("hops", "bytes")}
           for c in ("chain", "cotangent", "portal")}
    h = report["hops"]
    assert got["chain"]["hops"] == h["chain"] > 0
    assert got["cotangent"]["hops"] == h["cotangent_chain"] + \
        h["route_cotangent"]
    assert got["portal"]["hops"] == h["route_value"]
    for c in got:
        assert got[c]["bytes"] == report["per_class"][c], c


@pytest.mark.parametrize("name", HETERO_CASES)
def test_dist_hetero_bitwise_slots_and_hops(runs, name):
    """The U-Net's fused 1F1B at R = 2 (``hetero_grad_call`` with the
    group): the last rank's loss and every stage's grads bitwise equal to
    one process's, the buffer high-water equal to ``specialize``'s, the
    hops per class to the plan's (its carries and skips change shape from
    stage to stage: bytes are not priced by one carry size)."""
    run = runs[(name, 2)]
    ref = run["ref"]
    assert run["dist"][0]["loss"] is None
    assert torch.equal(run["dist"][1]["loss"], ref["loss"])
    for r, got in enumerate(run["dist"]):
        for c, tree in enumerate(got["grads"]):
            want = dict(tree_items(ref["grads"][c * 2 + r]))
            for path, a in tree_items(tree):
                assert torch.equal(a, want[path]), f"rank {r} {path}"
    pcfg = ranks_lib._hetero_pcfg(_case(name, 2), 2)
    model = ranks_lib.UNetModel(ranks_lib.UNET, 2)
    tplan = tplan_lib.plan_for(pcfg.schedule, pcfg.n_micro, 2,
                               skips=model.skip_edges(), portals=True)
    h = plan_wire_report(tplan, 1)["hops"]
    hops = {c: sum(got["park"]["hops"][c]["hops"] for got in run["dist"])
            for c in ("chain", "cotangent", "portal")}
    assert hops == {"chain": h["chain"], "portal": h["route_value"],
                    "cotangent": h["cotangent_chain"] + h["route_cotangent"]}
    assert hops["portal"] > 0
    for r, got in enumerate(run["dist"]):
        want = tplan_lib.specialize(tplan, r).buffer_slots()
        want.pop("fs")
        assert got["park"]["buffer_slots"] == want


def test_dist_two_train_steps(runs):
    """AdamW with clipping, tied embeddings: the group's norm sums in
    another order than one process, so the clip scale may move in its
    last bit; the first loss is bitwise, the rest within TOL, and both
    copies of the embedding take the same update."""
    name = "smollm-train-1f1b"
    run, model = runs[(name, 2)], _model(name, 2)
    ref = run["ref"]
    for r, got in enumerate(run["dist"]):
        assert torch.equal(got["losses"][0], ref["losses"][0]), f"rank {r}"
        np.testing.assert_allclose([float(x) for x in got["losses"]],
                                   [float(x) for x in ref["losses"]], **TOL)
        for path, a, b in share_pairs(model, got["params"], ref["params"],
                                      r):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL,
                                       err_msg=f"rank {r} {path}")
    first, last = run["dist"][0]["params"], run["dist"][-1]["params"]
    assert model.arch.tie_embeddings
    for (path, a), (_, b) in zip(tree_items(first["embed"]),
                                 tree_items(last["embed"])):
        assert torch.equal(a, b), path


def test_dist_launch_train_records(runs):
    """``launch.train.train`` with a group (what ``--nproc`` runs): every
    rank reports the group's losses, the first bitwise one process's, and
    every rank gets each rank's high-water and hops."""
    run = runs[("launch-train-1f1b", 2)]
    ref = run["ref"]["losses"]
    for r, got in enumerate(run["dist"]):
        assert got["losses"][0] == ref[0], f"rank {r}"
        np.testing.assert_allclose(got["losses"], ref, **TOL)
        ranks = got["ranks"]
        assert [rec["park_info"]["rank"] for rec in ranks] == [0, 1]
        assert all(len(rec["step_s"]) == 2 for rec in ranks)
    assert run["ref"]["ranks"] is None
    hops = [rec["park_info"]["hops"] for rec in run["dist"][0]["ranks"]]
    assert hops[0]["chain"]["hops"] == hops[1]["cotangent"]["hops"] > 0


@pytest.mark.parametrize("timeout_s", [SPAWN_S, None])
def test_failing_rank_fails_the_group(tmp_path, timeout_s):
    # None: what the --nproc launcher runs, no overall limit; the rank's
    # exception alone ends the group
    t0 = time.monotonic()
    with pytest.raises(ProcessRaisedException,
                       match=r"(?s)Process 1 terminated.*injected fault on "
                             r"pipe rank 1"):
        _spawn(tmp_path, "fail", 2, timeout_s=timeout_s)
    assert time.monotonic() - t0 < SPAWN_S


SPECIALIZE = [(sched, res, m, n) for sched, res in (
    ("gpipe_tasked", "recompute"), ("1f1b", "recompute"), ("zb", "recompute"),
    ("zb", "reuse"), ("interleaved:2", "recompute"))
    for m, n in ((1, 1), (4, 2), (8, 4), (3, 4))
    if not (sched.startswith("interleaved") and m % n)]


@pytest.mark.parametrize("schedule, residuals, m, n", SPECIALIZE)
def test_specialize_equals_reference(schedule, residuals, m, n):
    """Each rank's column, with a two-destination skip where there are
    three stages or more: every field of the port's ``RankProgram``
    equals the reference's."""
    v = int(schedule.split(":")[1]) if ":" in schedule else 1
    jspecs = ((jskip.SkipSpec("a", 0, (2, n * v - 1)),) if n * v >= 3
              else ())
    tspecs = tuple(SkipSpec(s.name, s.src_stage, s.dsts) for s in jspecs)
    want = jplan.plan_for(schedule, m, n, skips=jspecs, residuals=residuals)
    got = tplan_lib.plan_for(schedule, m, n, skips=tspecs,
                             residuals=residuals)
    for r in range(n):
        a, b = jplan.specialize(want, r), tplan_lib.specialize(got, r)
        assert type(a).__name__ == type(b).__name__ == "RankProgram"
        for field in a.__dataclass_fields__:
            x, y = getattr(a, field), getattr(b, field)
            if field == "segments":       # each package's Segment class
                x, y = ([(g.start, g.stop, g.kinds) for g in z]
                        for z in (x, y))
            if isinstance(x, np.ndarray) or x is None:
                assert (x is None and y is None) or np.array_equal(x, y), \
                    (r, field)
            else:
                assert x == y, (r, field)
        assert a.buffer_slots() == b.buffer_slots()
