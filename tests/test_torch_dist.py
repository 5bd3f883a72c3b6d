"""Stages in their own processes: both executors across gloo ranks on
the CPU, against the port's own single-process executors.

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
* a U-Net's fused 1F1B at R = 2 (``hetero_grad_call`` on the group's mesh);
* the forward executor under autograd (``schedule="gpipe"``, the
  cotangents crossing through ``p2p.Backprop``): smollm, whisper (and
  under a bf16 wire) and the U-Net with its portals at R = 2 under spmd
  and mpmd, whisper at R = 4 (``mem``'s three destinations, a carry the
  first decoder stage drops), smollm streamed at R = 4 (the shards rotate
  as values, rank 0 takes their cotangents into its own inputs): the loss
  and every gradient bitwise, the
  park and route high-water equal to the forward plan's, chain and portal
  hops and bytes equal to ``plan_wire_report``'s, one cotangent hop per
  chain and portal hop; two AdamW steps and ``launch.train.train`` with
  gpipe, as for 1F1B;
* serving with per-rank caches through ``launch.serve.serve(mesh_view=)``
  on a pipe group (what ``serve --nproc`` runs): smollm (spmd, mpmd), rwkv6 and whisper
  at R = 2, whisper streamed at R = 4: tokens and last logits bitwise
  equal to one process's, each rank's cache bytes its share of
  ``cache_protos``, one token hop a decode step, the chain and portal
  hops and the park and route high-water the plans' (two ranks on the
  JAX reference's weights are held against the JAX serve in
  ``tests/test_torch_serve.py``, beside its JAX run);
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
SERVE_CASES = [(name, n) for sname, n in (("r2", 2), ("r4", 4))
               for name, case in SUITES[sname] if case["kind"] == "serve"]


def _spawn(out_dir, suite, nproc, cases=None, timeout_s=SPAWN_S):
    """Run one group; each rank's saved ``{"dist", "ref"}``."""
    mesh.spawn(ranks_lib.run_rank, nproc, (str(out_dir), suite, cases),
               timeout_s=timeout_s, rendezvous_dir=str(out_dir))
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(nproc)]


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


def _gpipe(model) -> bool:
    return model.pcfg.schedule == "gpipe"


def _tplan(model):
    """The plan the executor runs: the forward plan for gpipe."""
    p = model.pcfg
    return tplan_lib.plan_for("gpipe_fwd" if _gpipe(model) else p.schedule,
                              p.n_micro, p.pipe, skips=model.skips(),
                              portals=p.portals, residuals=p.residuals,
                              wire=p.wire)


def _want_slots(tplan, r, streamed):
    """The buffer high-water a rank reports: ``specialize``'s, the
    families its executor holds (the forward executor: park)."""
    want = tplan_lib.specialize(tplan, r).buffer_slots()
    if not tplan.has_backward:
        return {"park": want["park"]}
    if not streamed:
        want.pop("fs")
    return want


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
        assert park["rank"] == r
        assert park["buffer_slots"] == _want_slots(tplan, r, streamed), \
            f"rank {r}"
    for k, rt in enumerate(tplan.routes):
        highs = [got["park"]["per_route"][rt.key]
                 for got in runs[(name, nproc)]["dist"]]
        assert max(h["depth"] for h in highs) == rt.depth, rt.key
        if tplan.has_backward:
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
    assert got["portal"]["hops"] == h["route_value"]
    for c in ("chain", "portal"):
        assert got[c]["bytes"] == report["per_class"][c], c
    if not _gpipe(model):
        assert got["cotangent"]["hops"] == h["cotangent_chain"] + \
            h["route_cotangent"]
        assert got["cotangent"]["bytes"] == report["per_class"]["cotangent"]
        return
    # autograd's: one cotangent a chain or portal hop, in the wire's
    # dtype; a payload its stage never reads ships an empty one
    assert got["cotangent"]["hops"] == h["chain"] + h["route_value"]
    unused = model.pcfg.n_micro * _dropped(model) \
        * report["per_class"]["chain"] // h["chain"]
    assert got["cotangent"]["bytes"] == report["per_class"]["chain"] + \
        report["per_class"]["portal"] - unused


def _dropped(model) -> int:
    """Hops a micro-batch makes whose payload the receiving stage never
    reads, all the carry's size: whisper's carry into a stage whose first
    layer starts the decoder (it reads ``dec_in``), and ``mem`` into a
    stage of padding only (no cross-attention)."""
    if not model.arch.is_encdec:
        return 0
    c = model.consts()
    carry = sum(1 for s in range(1, model.n_stages)
                if c["is_dec_first"][s, 0])
    mem = sum(1 for edge in model.skips() if edge.name == "mem"
              for d in edge.dsts if not c["cross"][d].any())
    return carry + mem


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
    gpipe = pcfg.schedule == "gpipe"
    tplan = tplan_lib.plan_for("gpipe_fwd" if gpipe else pcfg.schedule,
                               pcfg.n_micro, 2, skips=model.skip_edges(),
                               portals=True)
    h = plan_wire_report(tplan, 1)["hops"]
    hops = {c: sum(got["park"]["hops"][c]["hops"] for got in run["dist"])
            for c in ("chain", "cotangent", "portal")}
    cot = (h["chain"] + h["route_value"] if gpipe
           else h["cotangent_chain"] + h["route_cotangent"])
    assert hops == {"chain": h["chain"], "portal": h["route_value"],
                    "cotangent": cot}
    assert hops["portal"] > 0
    for r, got in enumerate(run["dist"]):
        assert got["park"]["buffer_slots"] == _want_slots(tplan, r, False)


def test_dist_two_train_steps(runs):
    """AdamW with clipping, tied embeddings: the group's norm sums in
    another order than one process, so the clip scale may move in its
    last bit; the first loss is bitwise, the rest within TOL, and both
    copies of the embedding take the same update."""
    _check_two_train_steps(runs, "smollm-train-1f1b")


def test_dist_two_gpipe_train_steps(runs):
    """The same two steps through gpipe's autograd across the ranks."""
    _check_two_train_steps(runs, "smollm-train-gpipe")


def _check_two_train_steps(runs, name):
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
    _check_launch_train(runs, "launch-train-1f1b")


def test_dist_launch_gpipe_train_records(runs):
    """``train --nproc 2 --schedule gpipe``'s ranks."""
    _check_launch_train(runs, "launch-train-gpipe")


def _check_launch_train(runs, name):
    run = runs[(name, 2)]
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


@pytest.mark.parametrize("name, nproc", SERVE_CASES)
def test_dist_serve_bitwise_equal_single_process(runs, name, nproc):
    """``serve(mesh_view=)`` on a pipe group: the last rank's tokens and
    last logits bitwise one process's (the others return none); every rank
    gets every rank's records and the last rank's tokens."""
    run = runs[(name, nproc)]
    ref, last = run["ref"], run["dist"][-1]
    assert np.array_equal(last["tokens"], ref["tokens"])
    assert torch.equal(last["logits"], ref["logits"])
    assert last["tokens"].shape == (ranks_lib.BATCH, ranks_lib.GEN)
    for r, got in enumerate(run["dist"][:-1]):
        assert got["tokens"] is None and got["logits"] is None, f"rank {r}"
    for got in run["dist"]:
        assert len(got["ranks"]) == nproc
        assert np.array_equal(got["ranks"][-1]["tokens"], ref["tokens"])


@pytest.mark.parametrize("name, nproc", SERVE_CASES)
def test_dist_serve_caches_hops_and_high_water(runs, name, nproc):
    """Each rank holds its stages' caches only (its share of
    ``cache_protos``); the last rank sends rank 0 one token a decode step;
    the chain and portal hops and the park and route high-water of the
    prefill and of each decode step are the plans'."""
    from repro_torch.configs.base import ShapeConfig
    run, model = runs[(name, nproc)], _model(name, nproc)
    m = run["ref"]["n_micro"]
    pcfg = model.pcfg.with_(n_micro=m)
    model = ranks_lib.LMModel(model.arch, pcfg, dtype=torch.float32,
                              device="cpu")
    dshape = ShapeConfig("d", ranks_lib.PROMPT + ranks_lib.GEN,
                         ranks_lib.BATCH, "decode")
    whole = model.cache_protos(dshape, m)
    plans = {"prefill": tplan_lib.plan_for(
        "gpipe_fwd", m, nproc, skips=model.skips(), portals=pcfg.portals),
        "decode": tplan_lib.plan_for("gpipe_fwd", m, nproc)}
    steps = {"prefill": 1, "decode": ranks_lib.GEN - 1}
    total = {c: 0 for c in ("chain", "portal")}
    for r, got in enumerate(run["dist"]):
        share = model.cache_protos(dshape, m, rank=r)
        assert _proto_leaves(share) == [((1,) + tuple(shp[1:]), dt)
                                        for shp, dt in _proto_leaves(whole)]
        assert got["cache_bytes"] == sum(
            np.prod(shp) * torch.empty((), dtype=dt).element_size()
            for shp, dt in _proto_leaves(share)) > 0, f"rank {r}"
        want_tok = ranks_lib.GEN - 1 if r == nproc - 1 else 0
        assert got["hops"]["token"]["hops"] == want_tok, f"rank {r}"
        assert got["hops"]["cotangent"]["hops"] == 0
        for phase, tplan in plans.items():
            park = got["park"][phase]
            assert park["buffer_slots"] == _want_slots(tplan, r, False)
            for rt in tplan.routes:
                assert park["per_route"][rt.key]["depth"] <= rt.depth
        for c in total:
            total[c] += got["hops"][c]["hops"]
    for c, key in (("chain", "chain"), ("portal", "route_value")):
        assert total[c] == sum(
            n * plan_wire_report(plans[p], 1)["hops"][key]
            for p, n in steps.items()), c
    for rt in plans["prefill"].routes:
        assert max(got["park"]["prefill"]["per_route"][rt.key]["depth"]
                   for got in run["dist"]) == rt.depth, rt.key
    assert bool(plans["prefill"].routes) == model.arch.is_encdec


def _proto_leaves(protos):
    if isinstance(protos, dict):
        return [leaf for v in protos.values() for leaf in _proto_leaves(v)]
    return [protos]


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
    # the per-rank buffer accounting over those programs
    from repro.launch import sharding as jsharding
    from repro_torch.launch import sharding as tsharding
    assert tsharding.per_rank_buffer_bytes(got, 64, 16) == \
        jsharding.per_rank_buffer_bytes(want, 64, 16)
