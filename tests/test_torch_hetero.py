"""The port's heterogeneous pipelines (U-Net, AmoebaNet-D) against the JAX
package, on the CPU.

Same weights (the JAX ``model.init(PRNGKey(0))`` moved across with
``interop.hetero_params_from_jax``) and the same seeded-numpy batch.  The
oracle is the reference's sequential model: ``apply_sequential`` for the
forward and ``jax.value_and_grad`` of the micro-batch-meaned MSE for the
loss and gradients (as ``tests/test_oracle.py``'s U-Net check), computed
once per model.  The reference's own pipelined hetero tests do not pass on
the installed jax, so nothing here compares with them.

Beside the oracle: partitions and portal edges equal the reference's, the
"SAME" padding, transposed-conv and depthwise mappings at odd and even
sizes, portals and threaded skips bitwise equal, the fused schedules
bitwise equal under ``grad_reduce="ordered"``, buffer and route
high-water equal to the plan's, a short SGD curve and the BatchNorm caveat.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import balance as jbalance
from repro.models.amoebanet import AmoebaConfig as JAmoebaConfig
from repro.models.amoebanet import AmoebaNetModel as JAmoebaNetModel
from repro.models.unet import UNetConfig as JUNetConfig
from repro.models.unet import UNetModel as JUNetModel
from repro_torch.configs.base import ParallelConfig
from repro_torch.core import balance
from repro_torch.interop import (conv_leaf_from_jax, hetero_params_from_jax,
                                 to_tensor)
from repro_torch.launch.train_hetero import sgd, train_hetero
from repro_torch.models import pipeline_hetero as PH
from repro_torch.models.amoebanet import AmoebaConfig, AmoebaNetModel
from repro_torch.models.unet import (UNetConfig, UNetModel, conv2d_same,
                                     max_pool_same)
from repro_torch.tree import tree_items

FWD_TOL = dict(rtol=2e-4, atol=2e-4)      # the reference's hetero tolerance
LOSS_RTOL = 2e-5
TOL = dict(rtol=5e-4, atol=5e-5)          # fp32 grads (tests/test_oracle.py)
BATCH, M = 8, 4
MODELS = {
    "unet": (JUNetModel, JUNetConfig(B=1, C=4, levels=3, img=32),
             UNetModel, UNetConfig(B=1, C=4, levels=3, img=32)),
    "amoeba": (JAmoebaNetModel, JAmoebaConfig(L=6, F=16, img=32,
                                              n_classes=10),
               AmoebaNetModel, AmoebaConfig(L=6, F=16, img=32,
                                            n_classes=10)),
}
SCHEDULES = {
    "gpipe": dict(schedule="gpipe"),
    "gpipe_tasked": dict(schedule="gpipe_tasked"),
    "1f1b": dict(schedule="1f1b"),
    "zb": dict(schedule="zb"),
    "zb-reuse": dict(schedule="zb", residuals="reuse", remat="none"),
    "zb-reuse-full": dict(schedule="zb", residuals="reuse", remat="full"),
    "interleaved2": dict(schedule="interleaved:2"),
}
FUSED = ("gpipe_tasked", "1f1b", "zb", "zb-reuse", "zb-reuse-full")


@pytest.fixture(autouse=True)
def _few_threads():
    """The suite runs several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _nchw(a):
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 3, 1, 2) if a.ndim == 4 else a))


def _oracle(name):
    """JAX params, batch, forward output, loss and grads of one model."""
    jcls, jcfg, _, _ = MODELS[name]
    jm = jcls(jcfg, 1)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))   # one compile, not 16
    rng = np.random.default_rng(7)
    x = rng.standard_normal((BATCH, jcfg.img, jcfg.img, 3)).astype(np.float32)
    out_shape = jax.eval_shape(jm.apply_sequential, params, x).shape
    y = rng.standard_normal(out_shape).astype(np.float32)

    def loss_fn(ps):
        # both models act on each sample alone (GroupNorm, no BatchNorm), so
        # one forward of the batch gives every micro-batch's output
        out = jm.apply_sequential(ps, jnp.asarray(x))
        per_micro = jnp.mean(((out - y) ** 2).reshape(M, -1), axis=1)
        return jnp.mean(per_micro), out

    (loss, y_fwd), grads = jax.jit(jax.value_and_grad(loss_fn,
                                                      has_aux=True))(params)
    return dict(params=jax.device_get(params), x=x, y=y,
                y_fwd=np.asarray(y_fwd), loss=float(loss),
                grads=jax.device_get(grads))


_ORACLES = {}


@pytest.fixture(scope="module")
def oracle():
    def get(name):
        if name not in _ORACLES:
            _ORACLES[name] = _oracle(name)
        return _ORACLES[name]
    return get


_RUNS = {}


def _run(ref, name, case, pipe, portals=True):
    """Loss, per-layer grads, high-water and plan of one hetero grad call
    (memoised: several tests read a run)."""
    key = (name, case, pipe, portals)
    if key not in _RUNS:
        kw = SCHEDULES[case]
        pcfg = ParallelConfig(pipe=pipe, tp=1, data=1, n_micro=M,
                              portals=portals, **kw)
        model = MODELS[name][2](MODELS[name][3],
                                pipe * pcfg.virtual_stages)
        params = hetero_params_from_jax(ref["params"], model, "cpu")
        prog = PH.build_hetero_program(model, params, pcfg, "cpu")
        info = {}
        call = PH.hetero_grad_call(prog, pcfg, info)
        loss, grads = call(prog.stage_params, _nchw(ref["x"]),
                           _nchw(ref["y"]))
        _RUNS[key] = dict(loss=loss, grads=PH.layer_list(model, grads),
                          info=info, tplan=call.tplan, model=model,
                          prog=prog)
    return _RUNS[key]


def _items(layers):
    return tree_items({str(i): t for i, t in enumerate(layers)})


def _assert_bitwise(a, b, tag):
    assert torch.equal(a["loss"], b["loss"]), tag
    for (path, x), (_, y) in zip(_items(a["grads"]), _items(b["grads"])):
        assert torch.equal(x, y), f"{tag} {path}"


# ---------------------------------------------------------------------------
# partitions, edges, layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,C,levels,n", [(1, 4, 3, 2), (2, 8, 4, 4),
                                          (4, 8, 4, 4), (1, 8, 4, 8),
                                          (5, 64, 5, 8)])
def test_unet_partition_and_edges_equal_reference(B, C, levels, n):
    jm = JUNetModel(JUNetConfig(B=B, C=C, levels=levels, img=64), n)
    pm = UNetModel(UNetConfig(B=B, C=C, levels=levels, img=64), n)
    assert pm.sizes == jm.sizes and pm.bounds == jm.bounds
    edges = [(e.name, e.src_stage, e.dsts) for e in pm.skip_edges()]
    assert edges == [(e.name, e.src_stage, e.dsts) for e in jm.skip_edges()]
    assert pm.total_params() == jm.total_params()
    assert [l.flops() for l in pm.layers] == [l.flops() for l in jm.layers]


def test_paper_configurations():
    """U-Net (5, 64) at 192 on 8 stages and AmoebaNet-D (18, 256) at 224:
    the partitions and portal edges chip_smoke.py trains."""
    u = UNetModel(UNetConfig(B=5, C=64, levels=5, img=192), 8)
    assert (len(u.layers), u.sizes) == (61, [8, 8, 7, 7, 8, 8, 9, 6])
    assert round(u.total_params() / 1e6, 1) == 194.2
    assert round(sum(l.flops() for l in u.layers) / 1e9) == 181
    assert {e.name: (e.src_stage, e.dsts) for e in u.skip_edges()} == {
        "s4": (3, (4,)), "s3": (2, (4,)), "s2": (2, (5,)), "s1": (1, (6,)),
        "s0": (0, (6,))}
    a = AmoebaNetModel(AmoebaConfig(L=18, F=256, img=224), 8)
    ja = JAmoebaNetModel(JAmoebaConfig(L=18, F=256, img=224), 8)
    assert len(a.layers) == 20 and a.sizes == ja.sizes
    assert a.skip_edges() == []
    assert a.total_params() == ja.total_params()
    assert round(a.total_params() / 1e6, 2) == 1.30


@pytest.mark.parametrize("n", [1, 2, 3, 5, 9])
def test_balance_equals_reference(n):
    costs = list(np.random.default_rng(n).integers(1, 100, 17).astype(float))
    for fn in ("block_partition", "balance_by_size"):
        assert getattr(balance, fn)(costs, n) == \
            getattr(jbalance, fn)(costs, n)
    sizes = balance.block_partition(costs, n)
    assert balance.partition_bounds(sizes) == jbalance.partition_bounds(sizes)
    assert balance.max_block_cost(costs, sizes) == \
        jbalance.max_block_cost(costs, sizes)


def _jconv(x, w, stride, groups=1):
    return jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        feature_group_count=groups,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


@pytest.mark.parametrize("size", [7, 8, 15, 16])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (5, 1), (5, 2)])
def test_same_padding_and_depthwise_match_jax(size, k, stride):
    """JAX pads "SAME" with the odd row at the end ((0, 1) for k 3 s 2 on
    even sizes); the port's conv, depthwise conv and -inf max pool agree
    at odd and even sizes."""
    rng = np.random.default_rng(size * 10 + k + stride)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 4, 6)).astype(np.float32)
    dw = rng.standard_normal((k, k, 1, 4)).astype(np.float32)
    tw, tdw = (to_tensor(conv_leaf_from_jax(p, a))
               for p, a in (("w", w), ("s3/dw", dw)))
    got = conv2d_same(_nchw(x), tw, stride=stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(_jconv(x, w, stride)),
                               rtol=1e-5, atol=1e-5)
    got = conv2d_same(_nchw(x), tdw, stride=stride, groups=4)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(_jconv(x, dw, stride, groups=4)),
                               rtol=1e-5, atol=1e-5)
    if k == 3:
        want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                     (1, 3, 3, 1), (1, stride, stride, 1),
                                     "SAME")
        got = max_pool_same(_nchw(x), 3, stride)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(want))


@pytest.mark.parametrize("size", [3, 4, 7])
def test_transposed_conv_matches_jax(size):
    """``jax.lax.conv_transpose`` (no kernel flip) against
    ``F.conv_transpose2d`` on the flipped, permuted weight."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((2, 2, 5, 3)).astype(np.float32)
    want = jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(w), (2, 2),
                                  "SAME",
                                  dimension_numbers=("NHWC", "HWIO", "NHWC"))
    tw = to_tensor(conv_leaf_from_jax("/7/upconv/w", w))
    got = torch.nn.functional.conv_transpose2d(_nchw(x), tw, stride=2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the pipelines against the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,pipe,portals",
                         [("unet", p, q) for p in (1, 2, 4)
                          for q in (True, False)]
                         + [("amoeba", 2, True), ("amoeba", 4, True)])
def test_hetero_forward_matches_jax(oracle, name, pipe, portals):
    ref = oracle(name)
    model = MODELS[name][2](MODELS[name][3], pipe)
    pcfg = ParallelConfig(pipe=pipe, tp=1, data=1, n_micro=M,
                          portals=portals)
    prog = PH.build_hetero_program(
        model, hetero_params_from_jax(ref["params"], model, "cpu"), pcfg,
        "cpu")
    assert bool(prog.skips) == (portals and pipe > 1 and name == "unet")
    with torch.no_grad():
        y = PH.hetero_forward(prog, pcfg, _nchw(ref["x"]))
    got = y.permute(0, 2, 3, 1) if y.ndim == 4 else y
    np.testing.assert_allclose(got.numpy(), ref["y_fwd"], **FWD_TOL)


@pytest.mark.parametrize("name,case,pipe",
                         [(n, c, p) for n in MODELS for c in SCHEDULES
                          for p in (2, 4)])
def test_hetero_loss_and_grads_match_jax_oracle(oracle, name, case, pipe):
    ref = oracle(name)
    run = _run(ref, name, case, pipe)
    np.testing.assert_allclose(float(run["loss"]), ref["loss"],
                               rtol=LOSS_RTOL)
    want = hetero_params_from_jax(ref["grads"], run["model"], "cpu")
    got = dict(_items(run["grads"]))
    for path, w in _items(want):
        np.testing.assert_allclose(got[path].numpy(), w.numpy(), **TOL,
                                   err_msg=f"{name} {case} pipe {pipe} "
                                           f"{path}")
    # every buffer and route held at most what the plan allocates
    tplan, info = run["tplan"], run["info"]
    assert info["per_stage_park"] == tplan.per_stage_park
    routes = {rt.key: {"depth": rt.depth, "g_depth": rt.g_depth}
              for rt in tplan.routes}
    if case == "gpipe":
        routes = {k: {"depth": v["depth"]} for k, v in routes.items()}
    else:
        assert info["per_stage_b_inbox"] == tplan.per_stage_b_inbox
        assert info["per_stage_resid"] == tplan.per_stage_resid
    assert info.get("per_route", {}) == routes
    assert bool(routes) == (name == "unet")


@pytest.mark.parametrize("case", ["gpipe", "1f1b", "zb-reuse",
                                  "interleaved2"])
def test_portals_and_threaded_skips_bitwise_equal(oracle, case):
    """A skip through a portal and the same skip in the carry through the
    stages between give the same bits."""
    ref = oracle("unet")
    a = _run(ref, "unet", case, 4, portals=True)
    b = _run(ref, "unet", case, 4, portals=False)
    assert a["prog"].skips and not b["prog"].skips
    _assert_bitwise(a, b, f"{case} portals vs threaded")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fused_schedules_bitwise_equal_under_ordered(oracle, name):
    base = _run(oracle(name), name, FUSED[0], 4)
    for case in FUSED[1:]:
        _assert_bitwise(_run(oracle(name), name, case, 4), base,
                        f"{name} {case} vs {FUSED[0]}")


@pytest.mark.parametrize("name,schedule", [("unet", "gpipe"),
                                           ("unet", "1f1b"),
                                           ("amoeba", "1f1b")])
def test_sgd_steps_lower_the_loss(name, schedule):
    """chip_smoke.py's training loop at a small size
    (``launch.train_hetero``): SGD with momentum 0.9 on one fixed batch,
    5 steps, the loss falls."""
    pcfg = ParallelConfig(pipe=2, tp=1, data=1, n_micro=M,
                          schedule=schedule)
    res = train_hetero(MODELS[name][3], pcfg, batch=BATCH, steps=5,
                       device="cpu", ocfg=sgd(0.05))
    losses = [r["loss"] for r in res["history"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert res["park_info"]["per_stage_park"] == res["park_plan"]
    assert res["park_info"].get("per_route", {}) == res["route_plan"]
    summary = res["summary"]
    assert summary["conv_flops_per_step"] == (
        3 * res["model"].conv_flops() * BATCH)
    assert summary["samples_per_s"] == pytest.approx(
        BATCH / summary["step_ms_median_warm"] * 1e3)


@pytest.mark.parametrize("schedule", ["forward", "gpipe", "1f1b"])
def test_hetero_calls_run_fp32(schedule):
    """The program turns TF32 off in cuDNN and cuBLAS while it runs, the
    forward and the backward alike, whatever the process has set, and
    restores the process's flags after."""
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    saved = [f.allow_tf32 for f in flags]
    model = UNetModel(MODELS["unet"][3], 2)
    pcfg = ParallelConfig(pipe=2, tp=1, data=1, n_micro=M,
                          schedule="gpipe" if schedule == "forward"
                          else schedule)
    prog = PH.build_hetero_program(
        model, model.init(torch.Generator().manual_seed(0), "cpu"), pcfg,
        "cpu")
    seen = []

    class Probe(torch.autograd.Function):
        """Identity that records the flags in its forward and backward."""
        @staticmethod
        def forward(ctx, x):
            seen.append([f.allow_tf32 for f in flags])
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            seen.append([f.allow_tf32 for f in flags])
            return g

    apply = model.layer_apply
    model.layer_apply = lambda li, p, x, skips: apply(li, p, Probe.apply(x),
                                                      skips)
    x = torch.randn(BATCH, 3, 32, 32,
                    generator=torch.Generator().manual_seed(1))
    try:
        for f in flags:
            f.allow_tf32 = True
        if schedule == "forward":
            with torch.no_grad():
                y = PH.hetero_forward(prog, pcfg, x)
            assert y.shape == (BATCH, 1, 32, 32)
        else:
            PH.hetero_grad_call(prog, pcfg)(prog.stage_params, x,
                                            torch.zeros(BATCH, 1, 32, 32))
        after = [f.allow_tf32 for f in flags]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
    assert seen and all(s == [False, False] for s in seen), seen
    assert after == [True, True]


def test_batchnorm_caveat(oracle):
    """Paper §2 footnote 1: BatchNorm statistics differ under
    micro-batching, GroupNorm (the default) does not; the port's BatchNorm
    matches the reference's on the same micro-batch."""
    ref = oracle("unet")
    x = _nchw(ref["x"])
    for norm, should_match in (("group", True), ("batch", False)):
        pm = UNetModel(dataclasses.replace(MODELS["unet"][3], norm=norm), 1)
        params = hetero_params_from_jax(ref["params"], pm, "cpu")
        full = pm.apply_sequential(params, x)
        halves = torch.cat([pm.apply_sequential(params, x[:4]),
                            pm.apply_sequential(params, x[4:])])
        match = torch.allclose(full, halves, rtol=1e-4, atol=1e-4)
        assert match == should_match, (norm, match)
    jm = JUNetModel(dataclasses.replace(MODELS["unet"][1], norm="batch"), 1)
    want = jax.jit(jm.apply_sequential)(ref["params"], ref["x"][:4])
    np.testing.assert_allclose(halves[:4].permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **FWD_TOL)
