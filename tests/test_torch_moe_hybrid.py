"""The MoE and hybrid families against the JAX package, on the CPU:
mixtral-8x7b (8 experts top-2, sliding window), dbrx-132b (16 experts
top-4, GQA 6:1) and hymba-1.5b (attention and a selective SSM side by
side, per-layer windows: ``GLOBAL_WINDOW`` on its global layers).

Each arch at ``configs.smoke_arch`` (4 layers, d 64, head_dim 16, window
8, capacity factor 8: no token drops) with the JAX
``model.init(PRNGKey(0))`` weights moved across as numpy: the port's
training loss and every gradient leaf at pipe 2 (gpipe and 1f1b) against
``jax.value_and_grad`` of the sequential oracle within the fp32 ``TOL``;
the prefill logits, every cache leaf and three greedy decode steps against
the JAX serve at pipe 1 (mixtral's ring of 8 slots wraps; hymba runs at
pipe 3, two of its six slots identity padding with window 0).  Beside
them: ``moe_apply`` with token drops (capacity factor 1.0) in the 512-token
and the decode grouping, at a capacity of exactly x.5 slots and with tied
gates, output and every gradient; ``moe_aux_loss``; ``ssm_scan`` with and
without ``state0`` at an S that is neither a power of 2 nor a multiple of
the chunk, and a chain of ``ssm_decode`` steps equal to it; the per-layer
window consts; the three parameter trees at full width (meta device)
against ``jax.eval_shape``; the model FLOPs and the serving and training
launch formulas of both families.  Each arch's JAX runs are made once, in
the module fixture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import MoEConfig as JMoE, SSMConfig as JSSM
from repro.models import layers as JL
from repro.models.lm import LMModel as JLMModel

from repro_torch import configs
from repro_torch.configs.base import MoEConfig, SSMConfig, ShapeConfig
from repro_torch.interop import params_from_jax
from repro_torch.launch import steps
from repro_torch.launch.serve import expected_serve_launches
from repro_torch.launch.train import (expected_train_launches,
                                      model_flops_per_step, visible_pairs)
from repro_torch.models import blocks
from repro_torch.models import layers as L
from repro_torch.models.lm import LMModel
from repro_torch.tree import tree_items, tree_map

from test_torch_archs import (JAX_MICRO, SEQ, SERVE_BATCH, TOL, _canon_cache,
                              _jax_shapes, _JaxRuns)
from test_torch_archs import _port as _port_at
from test_torch_train import (COUNT_M, COUNT_SEQ, _assert_tree_close,
                              _count_train_calls)

ARCHS = ("mixtral-8x7b", "dbrx-132b", "hymba-1.5b")
M = 2                                   # training micro-batches (batch 8)
SERVE_PIPE = {"mixtral-8x7b": 2, "dbrx-132b": 2, "hymba-1.5b": 3}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs():
    return _JaxRuns(m=M)


# ---------------------------------------------------------------------------
# training and serving at smoke size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("name", ARCHS)
def test_train_loss_and_grads_match_jax_oracle(jax_runs, name, schedule):
    ref = jax_runs.train(name)
    model, pcfg, params = _port_at(name, ref, 2, n_micro=M,
                                   schedule=schedule)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    loss, grads = steps.build_grad_fn(model, pcfg, "cpu")(params, batch)
    np.testing.assert_allclose(float(loss), ref["loss"], **TOL)
    want = params_from_jax(ref["grads"], arch=model.arch, src_pipe=1,
                           pcfg=pcfg, device="cpu")
    _assert_tree_close(grads, want, f"{name} {schedule}")


@pytest.mark.parametrize("name", ARCHS)
def test_serve_matches_jax(jax_runs, name):
    """The port (pipe 2; hymba pipe 3, padded) against the JAX serve at
    pipe 1: prefill logits, every cache leaf after it and after three
    greedy decode steps, and each step's logits."""
    ref = jax_runs.serve(name)
    model, pcfg, params = _port_at(name, jax_runs.train(name),
                                   SERVE_PIPE[name], n_micro=JAX_MICRO)
    dshape = ShapeConfig("d", SEQ + len(ref["tokens"]) + 1, SERVE_BATCH,
                         "decode")
    prefill = steps.build_prefill_step(
        model, pcfg, "cpu", ShapeConfig("p", SEQ, SERVE_BATCH, "prefill"))
    decode = steps.build_serve_step(model, pcfg, "cpu", dshape)
    cache = model.init_cache(dshape, JAX_MICRO, filled=False)
    logits, cache = prefill(params, cache, {k: torch.from_numpy(v)
                                            for k, v in ref["batch"].items()})
    np.testing.assert_allclose(logits.numpy(), ref["prefill"], **TOL,
                               err_msg="prefill logits")
    got = {"cache": _canon_cache(cache, model.layout)}
    for i, tok in enumerate(ref["tokens"]):
        logits, cache = decode(params, cache, torch.tensor(tok))
        np.testing.assert_allclose(logits.numpy(), ref["decode"][i], **TOL,
                                   err_msg=f"decode step {i}")
    got["cache_end"] = _canon_cache(cache, model.layout)
    from repro_torch.core import stage as stage_lib
    jax_layout = stage_lib.partition_layout(model.arch.n_layers, 1)
    for tag in ("cache", "cache_end"):
        want = _canon_cache(ref[tag], jax_layout)
        assert want.keys() == got[tag].keys()
        for path, w in want.items():
            np.testing.assert_allclose(got[tag][path], w, **TOL,
                                       err_msg=f"{tag} {path}")


# ---------------------------------------------------------------------------
# the MoE dispatch with drops, the aux loss
# ---------------------------------------------------------------------------

# (B, S, E, k, cf, group_size, capacity): 2 groups of 512 at cf 1.0; the
# decode grouping (B * 1 tokens) at mixtral's E 8, k 2, cf 1.25 and B 8,
# g k cf / E = 2.5 -> 2 (half to even), every token's second choice a tie
# of experts 3 and 5; 12 * 2 * 1.25 / 4 = 7.5 -> 8, all 12 tokens asking
# for expert 0
MOE_CASES = {"group512": (2, 512, 4, 2, 1.0, 512, 256),
             "decode": (8, 1, 8, 2, 1.25, 8, 2),
             "half_even_up": (2, 6, 4, 2, 1.25, 12, 8)}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_with_drops_matches_jax(case):
    """Output, router logits and the gradient of every parameter and of x
    against ``jax.vjp`` of the reference's ``moe_apply``; tokens are
    dropped (fewer kept slots than g k).  In the decode case expert 0 is
    every token's first choice and experts 3 and 5 tie exactly for the
    second: the lower index wins, as in ``jax.lax.top_k``."""
    B, S, E, k, cf, gs, cap = MOE_CASES[case]
    D, Fd = 16, 24
    rng = np.random.default_rng(3)
    p = {"router": rng.normal(size=(D, E)).astype(np.float32),
         "wg": (rng.normal(size=(E, D, Fd)) * 0.3).astype(np.float32),
         "wu": (rng.normal(size=(E, D, Fd)) * 0.3).astype(np.float32),
         "wd": (rng.normal(size=(E, Fd, D)) * 0.3).astype(np.float32)}
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    if case == "decode":
        p["router"] *= 0.1
        p["router"][0] = -5.0
        p["router"][0, 0], p["router"][0, 3] = 10.0, 5.0
        p["router"][:, 5] = p["router"][:, 3]
        x[..., 0] = 3.0
    elif case == "half_even_up":        # every token asks for expert 0
        p["router"][0, 0] = 10.0
        x[..., 0] = 3.0
    ct = rng.normal(size=(B, S, D)).astype(np.float32)
    m, jm = MoEConfig(E, k, cf), JMoE(E, k, cf)
    g = L.moe_group(B * S, gs)
    assert L.moe_capacity(g, m) == cap

    @jax.jit
    def jax_vjp(p_, x_, ct_):
        (o, lg), vjp = jax.vjp(
            lambda a, b: JL.moe_apply(a, b, jm, group_size=gs), p_, x_)
        return o, lg, vjp((ct_, jnp.zeros_like(lg)))

    jout, jlog, (jgp, jgx) = jax_vjp(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x), jnp.asarray(ct))
    tp = {k_: torch.from_numpy(v).requires_grad_() for k_, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, logits = L.moe_apply(tp, tx, m, group_size=gs)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlog),
                               **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    for name, gr in tp.items():
        np.testing.assert_allclose(gr.grad.numpy(), np.asarray(jgp[name]),
                                   **TOL, err_msg=name)
    # drops happened: fewer kept (token, slot) pairs than g k a group
    gates = torch.softmax(logits.detach(), -1)
    picks = torch.sort(gates, stable=True, dim=-1,
                       descending=True).indices[..., :k]
    demand = torch.stack([(picks == e).sum((1, 2)) for e in range(E)], -1)
    assert int(demand.clamp_max(cap).sum()) < B * S * k
    if case == "decode":
        assert bool((gates[..., 3] == gates[..., 5]).all())
        assert bool((picks == torch.tensor([0, 3])).all())


def test_moe_aux_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 16, 8)).astype(np.float32)
    got = L.moe_aux_loss(torch.from_numpy(logits), MoEConfig(8, 2))
    want = JL.moe_aux_loss(jnp.asarray(logits), JMoE(8, 2))
    np.testing.assert_allclose(float(got), float(want), **TOL)


# ---------------------------------------------------------------------------
# the selective SSM
# ---------------------------------------------------------------------------

SSM_S = 45            # neither a power of 2 nor a multiple of SSM_CHUNK
SSM_D, SSM_H, SSM_HD, SSM_N = 32, 4, 8, 4


def _ssm_case(seed=5, S=SSM_S):
    rng = np.random.default_rng(seed)
    D, H, hd, N = SSM_D, SSM_H, SSM_HD, SSM_N
    p = {"w_in": rng.normal(size=(D, H * hd)) * 0.2,
         "w_bc": rng.normal(size=(D, H * 2 * N)) * 0.2,
         "w_dt": rng.normal(size=(D, H)) * 0.5,
         "a_log": rng.normal(size=(H, N)) * 0.5,
         "w_out": rng.normal(size=(H * hd, D)) * 0.2,
         "dskip": np.full((H, 1), 0.1)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, S, D)).astype(np.float32)
    s0 = rng.normal(size=(2, H, hd, N)).astype(np.float32)
    return p, x, s0


@pytest.mark.parametrize("with_state0", [False, True])
def test_ssm_scan_matches_jax(with_state0):
    """y, the last state and the gradients of every parameter, of x and of
    state0 against ``jax.vjp`` of the reference's associative scan."""
    assert SSM_S % L.SSM_CHUNK and SSM_S & (SSM_S - 1)
    p, x, s0 = _ssm_case()
    s, js = SSMConfig(state_dim=SSM_N, head_dim=SSM_HD), \
        JSSM(state_dim=SSM_N, head_dim=SSM_HD)
    rng = np.random.default_rng(6)
    cy = rng.normal(size=x.shape).astype(np.float32)
    ch = rng.normal(size=s0.shape).astype(np.float32)
    @jax.jit
    def jax_vjp(p_, x_, s_, cts):
        out, vjp = jax.vjp(lambda a, b, c: JL.ssm_scan(
            a, b, js, c if with_state0 else None), p_, x_, s_)
        return out, vjp(cts)

    (jy, jh), (jgp, jgx, jgs) = jax_vjp(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(s0),
        (jnp.asarray(cy), jnp.asarray(ch)))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(s0).requires_grad_()
    y, h = L.ssm_scan(tp, tx, s, ts if with_state0 else None)
    torch.autograd.backward((y, h), (torch.from_numpy(cy),
                                     torch.from_numpy(ch)))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    for k, gr in tp.items():
        np.testing.assert_allclose(gr.grad.numpy(), np.asarray(jgp[k]),
                                   **TOL, err_msg=k)
    if with_state0:
        np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jgs), **TOL)


def test_ssm_decode_chain_equals_scan():
    """S steps of ``ssm_decode`` from state0 give the scan's outputs and its
    last state (and the reference's one step)."""
    p, x, s0 = _ssm_case(seed=7)
    s = SSMConfig(state_dim=SSM_N, head_dim=SSM_HD)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    y, h = L.ssm_scan(tp, torch.from_numpy(x), s, torch.from_numpy(s0))
    state, ys = torch.from_numpy(s0), []
    for t in range(x.shape[1]):
        yt, state = L.ssm_decode(tp, torch.from_numpy(x[:, t:t + 1]), state,
                                 s)
        ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y.numpy(), **TOL)
    np.testing.assert_allclose(state.numpy(), h.numpy(), **TOL)
    jy, jst = jax.jit(JL.ssm_decode, static_argnums=3)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x[:, :1]), jnp.asarray(s0),
        JSSM(state_dim=SSM_N, head_dim=SSM_HD))
    np.testing.assert_allclose(ys[0].numpy(), np.asarray(jy), **TOL)


# ---------------------------------------------------------------------------
# window consts, full-width trees, FLOPs, launch formulas
# ---------------------------------------------------------------------------

def test_window_consts_match_reference():
    """hymba's per-layer windows (1,024, GLOBAL_WINDOW on layers 0, 15 and
    31, 0 on padding slots) and mixtral's uniform one, on the slot grid of
    several pipes, equal the reference's consts."""
    assert blocks.GLOBAL_WINDOW == 32768
    for name, pipes in (("hymba-1.5b", (1, 3, 5, 16)),
                        ("mixtral-8x7b", (1, 3, 8))):
        for arch, jarch in ((configs.get_arch(name), jconfigs.get_arch(name)),
                            (configs.smoke_arch(name),
                             jconfigs.smoke_arch(name))):
            for pipe in pipes:
                pcfg = configs.smoke_parallel(name).with_(pipe=pipe)
                got = LMModel(arch, pcfg, device="meta").consts()["window"]
                want = JLMModel(jarch, jconfigs.smoke_parallel(name).with_(
                    pipe=pipe)).consts()["window"]
                np.testing.assert_array_equal(got, np.asarray(want),
                                              err_msg=f"{name} pipe {pipe}")
    full = configs.get_arch("hymba-1.5b")
    w = blocks.layer_windows(full, full.n_layers)
    assert set(np.flatnonzero(w == blocks.GLOBAL_WINDOW)) == {0, 15, 31}
    assert (np.delete(w, [0, 15, 31]) == 1024).all()


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_param_tree_matches_jax_eval_shape(name):
    """The whole model at full width and depth, on the meta device, under
    the config's pipe: every leaf's path, shape and dtype as ``jax.eval_shape``
    of the reference's ``init`` gives them (bf16; the router, ``a_log`` and
    ``dskip`` fp32, and so after ``params_from_jax`` into a bf16 model)."""
    jpcfg = jconfigs.get_parallel(name)
    jshapes = _jax_shapes(jax.eval_shape(
        JLMModel(jconfigs.get_arch(name), jpcfg, dtype=jnp.bfloat16).init,
        jax.random.PRNGKey(0)))
    pcfg = configs.get_parallel(name).with_(tp=1, data=1)
    assert pcfg.pipe == jpcfg.pipe
    params = LMModel(configs.get_arch(name), pcfg, dtype=torch.bfloat16,
                     device="meta").init(torch.Generator().manual_seed(0))
    shapes = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
              for p, t in tree_items(params)}
    assert shapes == jshapes
    fp32 = {p for p, (_, dt) in shapes.items() if dt == "float32"}
    assert fp32 == {p for p in shapes if p.endswith(
        ("moe/router", "ssm/a_log", "ssm/dskip"))}
    # params_from_jax into a bf16 model keeps those leaves fp32
    arch, small = configs.smoke_arch(name), configs.smoke_parallel(name)
    tree = LMModel(arch, small, dtype=torch.float32, device="cpu").init(
        torch.Generator().manual_seed(0))
    moved = params_from_jax(tree_map(lambda t: t.numpy(), tree), arch=arch,
                            src_pipe=1, pcfg=small, device="cpu",
                            dtype=torch.bfloat16)
    assert {p for p, t in tree_items(moved) if t.dtype == torch.float32} \
        == fp32


def test_model_flops_count_active_experts_scan_and_windows():
    """moe: the top_k experts a token reaches and the router (the config's
    active parameters less the embedding lookup), hybrid: every matrix of
    a layer's tree (the SSM's four projections among them) and the scan,
    2 x 2 x hd x N a token and head; attention over the pairs each
    layer's window leaves visible."""
    seq, batch = 4096, 16
    tokens = seq * batch
    assert visible_pairs(6, 2) == 1 + 2 * 5 and visible_pairs(6, 0) == 21
    mix = configs.get_arch("mixtral-8x7b")
    a = mix.attn
    attn = batch * 2 * 2 * a.head_dim * a.n_heads * mix.n_layers \
        * visible_pairs(seq, a.window)
    weights = mix.active_params_per_token() - mix.vocab * mix.d_model
    assert model_flops_per_step(mix, seq, batch) == \
        3.0 * (2.0 * weights * tokens + attn)
    hy = configs.get_arch("hymba-1.5b")
    layer = LMModel(dataclasses.replace(hy, n_layers=1),
                    configs.get_parallel("hymba-1.5b").with_(pipe=1),
                    device="meta").init(torch.Generator())["stages"]
    mats = sum(t[0, 0].numel() for p, t in tree_items(layer)
               if t.dim() == 4 and not p.endswith(("a_log", "dskip")))
    a, s = hy.attn, hy.ssm
    H = hy.d_model // s.head_dim
    pairs = 3 * visible_pairs(seq, blocks.GLOBAL_WINDOW) \
        + 29 * visible_pairs(seq, a.window)
    want = 3.0 * (2.0 * (hy.n_layers * mats + hy.d_model * hy.vocab) * tokens
                  + batch * 2 * 2 * a.head_dim * a.n_heads * pairs
                  + hy.n_layers * H * 2 * 2 * s.head_dim * s.state_dim
                  * tokens)
    assert model_flops_per_step(hy, seq, batch) == want


def _count_kernels(monkeypatch):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    calls = {"flash_attention": 0, "rmsnorm": 0}

    def counted(name, plain):
        def fn(*args, **kw):
            calls[name] += 1
            return plain(*args, **kw)
        return fn

    monkeypatch.setattr(fa, "flash_attention_plain", counted(
        "flash_attention", fa.flash_attention_plain))
    monkeypatch.setattr(rn, "rmsnorm_plain", counted("rmsnorm",
                                                     rn.rmsnorm_plain))
    return calls


@pytest.mark.parametrize("name", ["mixtral-8x7b", "hymba-1.5b"])
def test_serve_launch_formula(monkeypatch, name):
    """A prefill and two decode steps at pipe 3 (two padding slots): the
    attention and RMSNorm calls equal ``expected_serve_launches`` (three
    norms a slot in a moe prefill, two in a hybrid's)."""
    calls = _count_kernels(monkeypatch)
    arch, m, gen = configs.smoke_arch(name), 2, 3
    pcfg = configs.smoke_parallel(name).with_(pipe=3, n_micro=m)
    model = LMModel(arch, pcfg, dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    dshape = ShapeConfig("d", SEQ + gen, 2, "decode")
    prefill = steps.build_prefill_step(model, pcfg, "cpu",
                                       ShapeConfig("p", SEQ, 2, "prefill"))
    decode = steps.build_serve_step(model, pcfg, "cpu", dshape)
    cache = model.init_cache(dshape, m, filled=False)
    tokens = torch.randint(0, arch.vocab, (2, SEQ),
                           generator=torch.Generator().manual_seed(1))
    logits, cache = prefill(params, cache, {"tokens": tokens})
    want = expected_serve_launches(arch, pcfg, m, gen)
    assert want["prefill"]["rmsnorm"] == \
        (2 if arch.family == "hybrid" else 3) * 6 * m + 1
    assert calls == {k: want["prefill"][k] for k in calls}
    for _ in range(gen - 1):
        logits, cache = decode(params, cache, torch.argmax(logits, -1))
    assert calls == {k: want["prefill"][k] + want["decode"][k]
                     for k in calls}


@pytest.mark.parametrize("name", ["mixtral-8x7b", "hymba-1.5b"])
def test_train_launch_formula_and_kernel_contract(monkeypatch, name):
    """One 1F1B train step of the smoke arch at pipe 2 (head_dim 64, seq
    1024, m 2) on the CPU path: every call that reaches a kernel's plain
    version, forward or backward, meets the CUDA kernel's contract, and
    the calls equal ``expected_train_launches``."""
    calls, metrics, arch, pcfg = _count_train_calls(monkeypatch, name,
                                                    schedule="1f1b")
    assert calls == expected_train_launches(pcfg, arch, COUNT_SEQ)
    assert calls["flash_attention_bwd"] == arch.n_layers * COUNT_M
    assert np.isfinite(float(metrics["loss"]))
