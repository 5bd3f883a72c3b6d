"""Skip-route mechanics of both executors with toy stage functions, on the
CPU in float64.

Four ranks; skip ``a`` leaves stage 0 for stages 2 and 3 (two
destinations, one route each), and with ``interleaved:2`` (8 stages) skip
``b`` leaves stage 1 for stage 5, a stage on the same rank (a route with
no permute: the value is held, not sent).  Each schedule runs with portals
and with threaded routes (relayed hop by hop), and its loss, gradients and
forward output equal plain sequential autograd of the same stage functions;
every route's value and cotangent high-water equals the plan's ``depth``
and ``g_depth``.
"""
import pytest
import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.core.pipeline import (last_stage_output, microbatch,
                                       pipeline_call, pipeline_grad_call)
from repro_torch.core.skip import SkipSpec
from repro_torch.tree import tree_leaves, tree_map

PIPE, M, MB, D = 4, 4, 3, 5
SCHEDULES = {
    "gpipe": dict(schedule="gpipe"),
    "gpipe_tasked": dict(schedule="gpipe_tasked"),
    "1f1b": dict(schedule="1f1b"),
    "zb": dict(schedule="zb"),
    "zb-reuse": dict(schedule="zb", residuals="reuse", remat="none"),
    "zb-reuse-full": dict(schedule="zb", residuals="reuse", remat="full"),
    "interleaved2": dict(schedule="interleaved:2"),
}
TOL = dict(rtol=1e-11, atol=1e-12)


def _skips(n_stages):
    specs = [SkipSpec("a", 0, (2, 3))]
    if n_stages > PIPE:
        specs.append(SkipSpec("b", 1, (5,)))
    return specs


def _stage_fn(specs):
    def stage_apply(p, carry, skips_in, resident, ctx):
        s = ctx.stage
        h = ctx.fresh["h"] if s == 0 else carry["h"]
        y = torch.tanh(h @ p["w"] + p["b"] + p["g"])
        for name in sorted(skips_in):
            y = y + skips_in[name] * p["g"]
        skips_out = {sp.name: torch.sin(y) * (s + 1) for sp in specs
                     if sp.src_stage == s}
        return {"h": y}, skips_out, resident
    return stage_apply


def _loss(head_params, carry, largs):
    return torch.mean((carry["h"] - largs["y"]) ** 2)


def _data(n_stages):
    g = torch.Generator().manual_seed(n_stages)
    params = [{"w": torch.randn(D, D, generator=g, dtype=torch.float64) / 2,
               "b": torch.randn(D, generator=g, dtype=torch.float64),
               "g": torch.randn(D, generator=g, dtype=torch.float64)}
              for _ in range(n_stages)]
    x = torch.randn(M * MB, D, generator=g, dtype=torch.float64)
    y = torch.randn(M * MB, D, generator=g, dtype=torch.float64)
    return params, x, y


def _sequential(specs, params, x, y):
    """Each micro-batch through stages 0..n-1 in turn, skips in a dict;
    the loss meaned over micro-batches; autograd for the gradients."""
    fn = _stage_fn(specs)
    ps = [tree_map(lambda a: a.clone().requires_grad_(), p) for p in params]
    loss, outs = 0.0, []
    for i in range(M):
        carry, store = None, {}
        fresh = {"h": x[i * MB:(i + 1) * MB]}
        for s, p in enumerate(ps):
            ctx = type("Ctx", (), {"stage": s, "fresh": fresh})
            skips_in = {sp.name: store[sp.name] for sp in specs
                        if s in sp.dsts}
            carry, skips_out, _ = fn(p, carry, skips_in, {}, ctx)
            store.update(skips_out)
        outs.append(carry["h"])
        loss = loss + _loss(None, carry, {"y": y[i * MB:(i + 1) * MB]})
    loss = loss / M
    leaves = [leaf for p in ps for leaf in tree_leaves(p)]
    flat = iter(torch.autograd.grad(loss, leaves))
    return (loss.detach(), torch.stack(outs).detach(),
            [tree_map(lambda _: next(flat), p) for p in ps])


def _pipelined(case, portals, form="per-stage"):
    """Loss, grads, high-water and plan through the executors."""
    pcfg = ParallelConfig(pipe=PIPE, tp=1, data=1, n_micro=M,
                          portals=portals, **SCHEDULES[case])
    n = PIPE * pcfg.virtual_stages
    specs = _skips(n)
    params, x, y = _data(n)
    stage_params = params if form == "per-stage" else tree_map(
        lambda *xs: torch.stack(xs), *params)
    info = {}
    if case == "gpipe":
        call = pipeline_call(_stage_fn(specs), cfg=pcfg, devices="cpu",
                             skips=specs, park_info=info)
        ps = tree_map(lambda a: a.detach().requires_grad_(), stage_params) \
            if form == "stacked" else [
                tree_map(lambda a: a.detach().requires_grad_(), p)
                for p in stage_params]
        outs, _ = call(ps, microbatch({"h": x}, M))
        out = last_stage_output(outs)["h"]
        y_mb = microbatch(y, M)
        loss = sum(_loss(None, {"h": out[i]}, {"y": y_mb[i]})
                   for i in range(M)) / M
        leaves = tree_leaves(ps) if form == "stacked" else [
            leaf for p in ps for leaf in tree_leaves(p)]
        grads = torch.autograd.grad(loss, leaves)
        tplan = call.tplan
    else:
        call, tplan = pipeline_grad_call(_stage_fn(specs), cfg=pcfg,
                                         loss_fn=_loss, devices="cpu",
                                         skips=specs, park_info=info)
        loss, g, _, _ = call(stage_params, {}, microbatch({"h": x}, M),
                             microbatch({"y": y}, M))
        grads = tree_leaves(g) if form == "stacked" else [
            leaf for gs in g for leaf in tree_leaves(gs)]
    if form == "stacked":         # stage-major leaves -> per-stage order
        grads = [g[s] for s in range(n) for g in grads]
    return dict(loss=loss.detach(), grads=[g.detach() for g in grads],
                info=info, tplan=tplan, specs=specs, params=params, x=x,
                y=y)


_RUNS = {}


def _run(case, portals, form="per-stage"):
    key = (case, portals, form)
    if key not in _RUNS:
        _RUNS[key] = _pipelined(case, portals, form)
    return _RUNS[key]


@pytest.mark.parametrize("portals", [True, False],
                         ids=["portals", "threaded"])
@pytest.mark.parametrize("case", list(SCHEDULES))
def test_skip_routes_equal_sequential_autograd(case, portals):
    run = _run(case, portals)
    loss, _, grads = _sequential(run["specs"], run["params"], run["x"],
                                 run["y"])
    # the fused executor sums its losses in fp32, whatever the stage dtype
    torch.testing.assert_close(run["loss"].double(), loss,
                               rtol=1e-6, atol=0)
    want = [leaf for g in grads for leaf in tree_leaves(g)]
    assert len(run["grads"]) == len(want)
    for got, w in zip(run["grads"], want):
        torch.testing.assert_close(got, w, **TOL)
    assert all(float(g.abs().max()) > 0 for g in run["grads"])


@pytest.mark.parametrize("portals", [True, False],
                         ids=["portals", "threaded"])
@pytest.mark.parametrize("case", list(SCHEDULES))
def test_route_high_water_equals_plan(case, portals):
    run = _run(case, portals)
    tplan, info = run["tplan"], run["info"]
    want = {rt.key: ({"depth": rt.depth} if case == "gpipe" else
                     {"depth": rt.depth, "g_depth": rt.g_depth})
            for rt in tplan.routes}
    assert info["per_route"] == want
    assert sorted(want) == sorted(f"{sp.name}@{d}" for sp in run["specs"]
                                  for d in sp.dsts)
    assert all(rt.threaded == (not portals) for rt in tplan.routes)
    assert info["per_stage_park"] == tplan.per_stage_park


def test_interleaved_same_rank_route_holds_the_value():
    """Stages 1 and 5 share rank 1 under interleaved:2 at pipe 4: the
    portal route has no permute pairs, and the value it holds reaches
    stage 5 (the gradients above include stage 1's through it)."""
    run = _run("interleaved2", True)
    route = {rt.key: rt for rt in run["tplan"].routes}["b@5"]
    assert route.fwd_perm == () and route.bwd_perm == ()
    assert run["info"]["per_route"]["b@5"]["depth"] >= 1


@pytest.mark.parametrize("case", ["gpipe", "1f1b", "zb-reuse"])
def test_stacked_and_per_stage_params_agree(case):
    """The same stages with their parameters stacked ``[n_stages, ...]``
    give the per-stage run's loss and gradients bit for bit."""
    a, b = _run(case, True), _run(case, True, form="stacked")
    assert torch.equal(a["loss"], b["loss"])
    for x, y in zip(a["grads"], b["grads"]):
        assert torch.equal(x, y)


def test_forward_only_plan_runs_routes():
    """Serving-style forward (no grad): the clock-cycle plan's routes
    deliver every skip; the output equals the sequential one."""
    specs = _skips(PIPE)
    params, x, y = _data(PIPE)
    for portals in (True, False):
        info = {}
        cfg = ParallelConfig(pipe=PIPE, tp=1, data=1, n_micro=M,
                             portals=portals)
        call = pipeline_call(_stage_fn(specs), cfg=cfg, devices="cpu",
                             skips=specs, park_info=info)
        with torch.no_grad():
            outs, _ = call(params, microbatch({"h": x}, M))
        _, want, _ = _sequential(specs, params, x, y)
        torch.testing.assert_close(last_stage_output(outs)["h"], want,
                                   **TOL)
        assert info["per_route"] == {rt.key: {"depth": rt.depth}
                                     for rt in call.tplan.routes}


@pytest.mark.parametrize("what", ["stream_inputs", "wire"])
def test_unported_plan_features_still_raise(what):
    """Streams and wires run on these skip routes; what of them still
    raises.  ``stream_inputs``: the streamed runs equal the replicated ones
    bit for bit (the gpipe forward, 1F1B's loss and grads), and a fused
    plan whose ranks do not divide the micro-batches raises.  ``wire``:
    bf16 on both routes' values (and 1F1B's cotangents) runs; int8-ef on
    them under autograd raises in the forward executor (the reference's
    truncated gradient), and trains through the fused one."""
    specs = _skips(PIPE)
    params, x, y = _data(PIPE)
    cfg = ParallelConfig(pipe=PIPE, tp=1, data=1, n_micro=M)
    if what == "stream_inputs":
        for schedule in ("gpipe", "1f1b"):
            a = _run_cfg(cfg.with_(schedule=schedule), specs, params, x, y)
            b = _run_cfg(cfg.with_(schedule=schedule, stream_inputs=True),
                         specs, params, x, y)
            assert torch.equal(a[0], b[0])
            assert all(torch.equal(g, h) for g, h in zip(a[1], b[1]))
        with pytest.raises(ValueError, match="divisible by pipe"):
            pipeline_grad_call(_stage_fn(specs), cfg=cfg.with_(
                schedule="1f1b", stream_inputs=True, n_micro=2),
                loss_fn=_loss, devices="cpu", skips=specs)
        return
    base = _run_cfg(cfg.with_(schedule="1f1b"), specs, params, x, y)
    for schedule in ("gpipe", "1f1b"):
        loss, grads = _run_cfg(cfg.with_(schedule=schedule, wire="bf16"),
                               specs, params, x, y)
        torch.testing.assert_close(loss.double(), base[0].double(),
                                   rtol=1e-2, atol=0)
        assert not torch.equal(loss, base[0])
    with pytest.raises(ValueError, match="truncated gradient"):
        _run_cfg(cfg.with_(wire="int8-ef"), specs, params, x, y)
    loss, _ = _run_cfg(cfg.with_(schedule="1f1b", wire="int8-ef"), specs,
                       params, x, y)
    torch.testing.assert_close(loss.double(), base[0].double(), rtol=1e-2,
                               atol=0)


def _run_cfg(pcfg, specs, params, x, y):
    """Loss and flat grads of one run of the toy stages under ``pcfg``:
    the forward executor under autograd for gpipe, else the fused one."""
    if pcfg.schedule == "gpipe":
        call = pipeline_call(_stage_fn(specs), cfg=pcfg, devices="cpu",
                             skips=specs)
        ps = [tree_map(lambda a: a.detach().requires_grad_(), p)
              for p in params]
        outs, _ = call(ps, microbatch({"h": x}, M))
        out, y_mb = last_stage_output(outs)["h"], microbatch(y, M)
        loss = sum(_loss(None, {"h": out[i]}, {"y": y_mb[i]})
                   for i in range(M)) / M
        leaves = [leaf for p in ps for leaf in tree_leaves(p)]
        return loss.detach(), list(torch.autograd.grad(loss, leaves))
    call, _ = pipeline_grad_call(_stage_fn(specs), cfg=pcfg, loss_fn=_loss,
                                 devices="cpu", skips=specs)
    loss, g, _, _ = call(params, {}, microbatch({"h": x}, M),
                         microbatch({"y": y}, M))
    return loss, [leaf for gs in g for leaf in tree_leaves(gs)]
