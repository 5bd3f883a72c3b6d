"""The port's rwkv6 serving slice against the JAX package, on the CPU.

* The WKV-6 oracles and the kernel wrapper's plain version against the JAX
  oracle and ``wkv6_pallas`` in interpret mode, on the same numpy inputs
  (fp32, and bf16 r/k/v with fp32 or bf16 w), with state chaining.
* The whole slice: rwkv6 prefill logits, every cache leaf after prefill and
  after three greedy decode steps, and the decode logits, against the JAX
  ``build_prefill_step`` / ``build_serve_step`` at pipe 1, for the port at
  several (pipe, m), with the same weights moved across by
  ``params_from_jax``; once more with the JAX side through its Pallas
  kernels in interpret mode.  The smoke arch is widened to d_model 128 (two
  heads of 64) on both sides so that the head indexing is exercised.
* The full-width parameter tree (meta device) against ``jax.eval_shape``,
  the dtype rule of ``params_from_jax``, and the kernel contracts and
  launch formulas on the CPU path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.compat import set_mesh
from repro.configs.base import ShapeConfig as JShape
from repro.kernels import ref as jref
from repro.kernels.rwkv6 import wkv6_pallas
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models.lm import LMModel as JLMModel

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import stage as stage_lib
from repro_torch.interop import params_from_jax, to_tensor
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6 as wkv_mod
from repro_torch.launch import steps
from repro_torch.launch.train import expected_train_launches
from repro_torch.models.lm import LMModel
from repro_torch.tree import tree_items

# tests/test_oracle.py's fp32 TOL: same math, different graphs and sum order
TOL = dict(rtol=5e-4, atol=5e-5)
# kernel-level WKV comparisons: tests/test_kernels.py's fp32 tolerance; a
# bf16 output is one rounding of the fp32 result apart (its 4e-2)
WKV_TOL = 5e-4
WKV_BF16_OUT_TOL = 4e-2
ARCH = "rwkv6-1.6b"
D_MODEL = 128
BATCH, PROMPT, STEPS = 4, 12, 3
DECODE_LEN = PROMPT + STEPS + 1
JAX_MICRO = 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# WKV-6 kernel level
# ---------------------------------------------------------------------------

WKV_SHAPES = [
    # B, H, T, K, V, chunk: tests/test_kernels.py's shapes, T = 1 (decode)
    # and a ragged T (the Pallas kernel then takes one chunk of T steps)
    (1, 1, 64, 8, 8, 16),
    (2, 3, 128, 16, 16, 32),
    (1, 2, 96, 32, 32, 32),
    (2, 2, 1, 64, 64, 64),
    (1, 2, 37, 64, 64, 64),
]
# (r/k/v dtype, w dtype)
WKV_DTYPES = {"float32": ("float32", "float32"),
              "bf16_rkv": ("bfloat16", "float32"),
              "bf16": ("bfloat16", "bfloat16")}


def _wkv_inputs(B, H, T, K, V, seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return dict(r=n(B, H, T, K, scale=0.5), k=n(B, H, T, K, scale=0.5),
                v=n(B, H, T, V, scale=0.5),
                w=np.exp(-np.exp(n(B, H, T, K, scale=0.5))),
                u=n(H, K, scale=0.5), s0=n(B, H, K, V, scale=0.3))


def _cast(inputs, kind):
    """The inputs as torch tensors and jax arrays of the case's dtypes."""
    dt, wdt = WKV_DTYPES[kind]
    dts = {"r": dt, "k": dt, "v": dt, "w": wdt, "u": "float32",
           "s0": "float32"}
    tor = {n: torch.from_numpy(a).to(getattr(torch, dts[n]))
           for n, a in inputs.items()}
    jx = {n: jnp.asarray(a).astype(getattr(jnp, dts[n]))
          for n, a in inputs.items()}
    return tor, jx


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32), np.float32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


# every shape in fp32; bf16 r/k/v (the path's form) on a narrow and the
# 64-wide ragged shape; all-bf16 (as tests/test_kernels.py passes w) once
WKV_CASES = ([("float32", s) for s in WKV_SHAPES]
             + [("bf16_rkv", WKV_SHAPES[1]), ("bf16_rkv", WKV_SHAPES[4]),
                ("bf16", WKV_SHAPES[4])])


@pytest.mark.parametrize("kind,shape", WKV_CASES, ids=str)
def test_wkv6_vs_jax_oracle_and_pallas(kind, shape):
    B, H, T, K, V, C = shape
    t, j = _cast(_wkv_inputs(B, H, T, K, V), kind)
    args = ("r", "k", "v", "w", "u", "s0")
    o_ref, s_ref = ref.wkv6(*(t[a] for a in args))
    o_jref, s_jref = jref.wkv6(*(j[a] for a in args))
    _close(o_ref, o_jref, WKV_TOL, "oracle out")
    _close(s_ref, s_jref, WKV_TOL, "oracle state")
    o_pl, s_pl = wkv6_pallas(*(j[a] for a in args), chunk=C, interpret=True)
    o_k, s_k = wkv_mod.wkv6(*(t[a] for a in args))    # CPU -> plain version
    assert o_k.dtype == t["r"].dtype and s_k.dtype == torch.float32
    out_tol = WKV_TOL if kind == "float32" else WKV_BF16_OUT_TOL
    _close(o_k, o_pl, out_tol, "wkv6 out vs Pallas")
    _close(s_k, s_pl, WKV_TOL, "wkv6 state vs Pallas")
    if K == V == wkv_mod.HEAD_SIZE:
        wkv_mod.check_inputs(*(t[a] for a in args))


def test_wkv6_state_chaining_and_zero_default():
    """[0:T/2] then [T/2:T] with the carried state == one pass; ops.wkv6
    without a state starts from zeros."""
    t, _ = _cast(_wkv_inputs(2, 2, 64, 64, 64, seed=2), "float32")
    r, k, v, w, u = (t[a] for a in ("r", "k", "v", "w", "u"))
    o_full, s_full = ops.wkv6(r, k, v, w, u)
    _close(o_full, ref.wkv6(r, k, v, w, u)[0], 0, "zero default")
    h = 32
    halves = [x[:, :, :h] for x in (r, k, v, w)], [x[:, :, h:]
                                                   for x in (r, k, v, w)]
    o1, s1 = ops.wkv6(*halves[0], u)
    o2, s2 = ops.wkv6(*halves[1], u, s1)
    _close(torch.cat([o1, o2], 2), o_full, WKV_TOL, "chained out")
    _close(s2, s_full, WKV_TOL, "chained state")


def test_wkv6_chunked_matches_sequential():
    t, _ = _cast(_wkv_inputs(2, 2, 128, 16, 16, seed=1), "float32")
    args = [t[a] for a in ("r", "k", "v", "w", "u", "s0")]
    o1, s1 = ref.wkv6(*args)
    o2, s2 = ref.wkv6_chunked(*args, chunk=32)
    _close(o2, o1, 2e-4, "chunked out")      # tests/test_kernels.py's 2e-4
    _close(s2, s1, 2e-4, "chunked state")


# the Hopper kernel's chunked form (ref.wkv6_subchunked) against the JAX
# oracle: fp32 math at the fp32 kernel tolerance; with its tensor-core
# operands rounded to bf16 hi + lo pairs, at chip_smoke.py's bf16 WKV_TOL for
# the (bf16-rounded) output and WKV_STATE_TOL for the state
SUBCHUNK_TOL = {False: (1e-4, 1e-4), True: (2e-2, 1e-4)}


@pytest.mark.parametrize("decay", ["normal", "extreme"])
@pytest.mark.parametrize("T", [1, 16, 63, 64, 65, 100, 130])
def test_wkv6_subchunked_vs_jax_oracle(T, decay):
    """Masked tails (T % 64 != 0), zero and random s0; extreme decays
    w = exp(-exp(3 N(0, 1))) underflow to w = 0, which must give no NaN."""
    inputs = _wkv_inputs(1, 2, T, 64, 64, seed=T)
    if decay == "extreme":
        rng = np.random.default_rng(T + 1)
        inputs["w"] = np.exp(-np.exp(
            3 * rng.standard_normal(inputs["w"].shape))).astype(np.float32)
        assert T < 16 or (inputs["w"] == 0).any()
    args = ("r", "k", "v", "w", "u", "s0")
    for s0_zero in (True, False):
        case = dict(inputs, s0=inputs["s0"] * (not s0_zero))
        for split in (False, True):
            if split:      # the kernel's inputs: bf16 r/k/v, fp32 w
                case = {a: (torch.from_numpy(x).to(torch.bfloat16).float()
                            .numpy() if a in "rkv" else x)
                        for a, x in case.items()}
            o_j, s_j = jref.wkv6(*(jnp.asarray(case[a]) for a in args))
            o, s = ref.wkv6_subchunked(
                *(torch.from_numpy(case[a]) for a in args), split_bf16=split)
            assert bool(torch.isfinite(o).all() and torch.isfinite(s).all())
            tol_o, tol_s = SUBCHUNK_TOL[split]
            what = f"split_bf16={split} s0_zero={s0_zero}"
            _close(o, o_j, tol_o, f"out, {what}")
            _close(s, s_j, tol_s, f"state, {what}")


# the Hopper kernel's chunked backward (ref.wkv6_subchunked_bwd) against
# jax.vjp of the reference's sequential ref.wkv6: fp32 math at TOL; with its
# tensor-core operands as bf16 hi + lo pairs and dr / dk / dv rounded to
# bf16, at the card's backward tolerances (chip_smoke.py's BWD_BF16_REL of
# each gradient's largest entry, BWD_FP32_TOL for the fp32 dw, du, ds0)
BWD_BF16_REL, BWD_FP32_TOL = 2e-2, 1e-3


@pytest.mark.parametrize("decay", ["normal", "extreme"])
@pytest.mark.parametrize("B,T", [(2, 64), (1, 65), (1, 130)])
def test_wkv6_subchunked_bwd_vs_jax_vjp(B, T, decay):
    """All six gradients, from a random s0, with and without a cotangent on
    the final state; T 65 and 130 leave masked tails (65: one step), and
    extreme decays w = exp(-exp(3 N(0, 1))) underflow to w = 0."""
    inputs = _wkv_inputs(B, 2, T, 64, 64, seed=T + B)
    rng = np.random.default_rng(T + 7)
    if decay == "extreme":
        inputs["w"] = np.exp(-np.exp(
            3 * rng.standard_normal(inputs["w"].shape))).astype(np.float32)
        assert (inputs["w"] == 0).any()
    don = rng.standard_normal((B, 2, T, 64)).astype(np.float32)
    dsn = rng.standard_normal((B, 2, 64, 64)).astype(np.float32)
    args = ("r", "k", "v", "w", "u", "s0")
    for split in (False, True):
        case = dict(inputs)
        if split:          # the kernel's inputs: bf16 r/k/v and dout, fp32 w
            case = {a: (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                        if a in "rkv" else x) for a, x in case.items()}
            do_case = torch.from_numpy(don).to(torch.bfloat16).float().numpy()
        else:
            do_case = don
        _, vjp = jax.vjp(jref.wkv6, *(jnp.asarray(case[a]) for a in args))
        for ds_case in (dsn, None):
            want = vjp((jnp.asarray(do_case), jnp.asarray(
                np.zeros_like(dsn) if ds_case is None else ds_case)))
            got = ref.wkv6_subchunked_bwd(
                *(torch.from_numpy(case[a]) for a in args),
                torch.from_numpy(do_case),
                None if ds_case is None else torch.from_numpy(ds_case),
                split_bf16=split)
            for name, g, w in zip(WKV_GRADS, got, want):
                what = f"{name}, split_bf16={split}, dsT={ds_case is not None}"
                w = np.asarray(w)
                assert g.shape == w.shape and bool(torch.isfinite(g).all()), what
                if not split:
                    np.testing.assert_allclose(g.numpy(), w, **TOL,
                                               err_msg=what)
                elif name in ("dr", "dk", "dv"):
                    err = float(np.abs(g.numpy() - w).max())
                    assert err <= BWD_BF16_REL * float(np.abs(w).max()), what
                else:
                    np.testing.assert_allclose(g.numpy(), w, rtol=BWD_FP32_TOL,
                                               atol=BWD_FP32_TOL, err_msg=what)


def test_wkv6_contract_rejects():
    good = {n: torch.zeros(s, dtype=torch.float32) for n, s in (
        ("r", (1, 2, 3, 64)), ("k", (1, 2, 3, 64)), ("v", (1, 2, 3, 64)),
        ("w", (1, 2, 3, 64)), ("u", (2, 64)), ("s0", (1, 2, 64, 64)))}
    wkv_mod.check_inputs(**good)
    bad = [("r", torch.zeros(1, 2, 3, 32)),                  # K != 64
           ("u", torch.zeros(2, 64, dtype=torch.bfloat16)),  # u not fp32
           ("w", torch.zeros(1, 2, 3, 64, dtype=torch.float64)),
           ("s0", torch.zeros(1, 2, 64, 64).transpose(2, 3)),  # layout
           ("r", torch.zeros(1, 2, 3, 64, dtype=torch.bfloat16))]
    for name, val in bad:
        with pytest.raises((TypeError, ValueError)):
            wkv_mod.check_inputs(**{**good, name: val})
    empty = {n: (x[:, :, :0] if x.dim() == 4 and n != "s0" else x)
             for n, x in good.items()}
    with pytest.raises(ValueError, match="T >= 1"):
        wkv_mod.check_inputs(**empty)


# ---------------------------------------------------------------------------
# The slice: rwkv6 serving against JAX
# ---------------------------------------------------------------------------

def _widen(arch):
    return dataclasses.replace(arch, d_model=D_MODEL)


def _jax_run(interpret: bool, monkeypatch):
    """JAX prefill + STEPS greedy decode steps at pipe 1 (numpy results)."""
    if interpret:
        monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("REPRO_PALLAS_INTERPRET", raising=False)
    arch = _widen(jconfigs.smoke_arch(ARCH))
    pcfg = jconfigs.smoke_parallel(ARCH).with_(n_micro=JAX_MICRO)
    mesh = jmesh.make_smoke_mesh(pcfg)
    model = JLMModel(arch, pcfg, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0))
    pshape = JShape("p", PROMPT, BATCH, "prefill")
    dshape = JShape("d", DECODE_LEN, BATCH, "decode")
    prompts = np.random.default_rng(0).integers(
        0, arch.vocab, (BATCH, PROMPT)).astype(np.int32)
    with set_mesh(mesh):
        prefill = jax.jit(jsteps.build_prefill_step(model, pcfg, mesh, pshape))
        decode = jax.jit(jsteps.build_serve_step(model, pcfg, mesh, dshape))
        cache = model.init_cache(dshape, pcfg.n_micro, filled=False)
        logits, cache = prefill(params, cache, {"tokens": jnp.asarray(prompts)})
        out = {"prefill": np.asarray(logits),
               "cache": jax.device_get(cache), "tokens": [], "decode": []}
        for _ in range(STEPS):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            out["tokens"].append(np.asarray(tok))
            logits, cache = decode(params, cache, tok)
            out["decode"].append(np.asarray(logits))
        out["cache_end"] = jax.device_get(cache)
    out["params"] = jax.device_get(params)
    out["prompts"] = prompts
    return out


@pytest.fixture(scope="module")
def jax_ref():
    mp = pytest.MonkeyPatch()
    try:
        yield _jax_run(False, mp)
    finally:
        mp.undo()


def _canon_cache(cache, layout: stage_lib.StageLayout):
    """[n_stages, L, m, mb, ...] leaves (numpy or torch) -> [layers, B, ...]."""
    out = {}
    for path, leaf in tree_items(cache):
        t = leaf if torch.is_tensor(leaf) else to_tensor(leaf)
        per_layer = stage_lib.unstack_layers(t, layout)
        out[path] = per_layer.reshape(
            (per_layer.shape[0], -1) + tuple(per_layer.shape[3:])).numpy()
    return out


def _port_run(ref_out, pipe: int, m: int):
    arch = _widen(configs.smoke_arch(ARCH))
    pcfg = configs.smoke_parallel(ARCH).with_(pipe=pipe, n_micro=m)
    model = LMModel(arch, pcfg, dtype=torch.float32, device="cpu")
    params = params_from_jax(ref_out["params"], arch=arch, src_pipe=1,
                             pcfg=pcfg, device="cpu")
    pshape = ShapeConfig("p", PROMPT, BATCH, "prefill")
    dshape = ShapeConfig("d", DECODE_LEN, BATCH, "decode")
    prefill = steps.build_prefill_step(model, pcfg, "cpu", pshape)
    decode = steps.build_serve_step(model, pcfg, "cpu", dshape)
    cache = model.init_cache(dshape, m, filled=False)
    logits, cache = prefill(params, cache,
                            {"tokens": torch.from_numpy(ref_out["prompts"])})
    out = {"prefill": logits.numpy(),
           "cache": _canon_cache(cache, model.layout), "decode": []}
    for tok in ref_out["tokens"]:
        logits, cache = decode(params, cache, torch.tensor(tok))
        out["decode"].append(logits.numpy())
    out["cache_end"] = _canon_cache(cache, model.layout)
    return out


def _assert_matches(ref_out, got):
    jax_layout = stage_lib.partition_layout(
        configs.smoke_arch(ARCH).n_layers, 1)
    np.testing.assert_allclose(got["prefill"], ref_out["prefill"], **TOL,
                               err_msg="prefill logits")
    for tag in ("cache", "cache_end"):
        want = _canon_cache(ref_out[tag], jax_layout)
        assert want.keys() == got[tag].keys() == {"state", "last_tm",
                                                  "last_cm"}
        for path, w in want.items():
            assert np.abs(w).max() > 0, f"{tag} {path} is all zero"
            np.testing.assert_allclose(got[tag][path], w, **TOL,
                                       err_msg=f"{tag} {path}")
    assert len(got["decode"]) == STEPS
    for i, (g, w) in enumerate(zip(got["decode"], ref_out["decode"])):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"decode step {i}")


@pytest.mark.parametrize("pipe,m", [(1, 2), (2, 2), (2, 4), (4, 4)])
def test_rwkv_serve_matches_jax(jax_ref, pipe, m):
    _assert_matches(jax_ref, _port_run(jax_ref, pipe, m))


def test_rwkv_serve_matches_jax_pallas_interpret(monkeypatch):
    """The JAX side through wkv6_pallas and rmsnorm_pallas (interpret)."""
    ref_out = _jax_run(True, monkeypatch)
    _assert_matches(ref_out, _port_run(ref_out, 2, 2))


# ---------------------------------------------------------------------------
# Training: the WKV-6 gradient, rwkv6 through the pipeline
# ---------------------------------------------------------------------------

WKV_GRADS = ("dr", "dk", "dv", "dw", "du", "ds0")


@pytest.mark.parametrize("shape", [WKV_SHAPES[1], WKV_SHAPES[4]], ids=str)
def test_wkv6_backward_vs_jax_vjp(shape):
    """The plain backward (autograd through ``wkv6_plain``) and the
    :class:`WKV6` Function's CPU path against ``jax.vjp`` of the
    reference's ``ref.wkv6`` (the reference's own rule, ``ops.py``), all
    six gradients, from a non-zero s0 with a cotangent on the final
    state."""
    B, H, T, K, V, _ = shape
    inputs = _wkv_inputs(B, H, T, K, V, seed=5)
    rng = np.random.default_rng(6)
    don = rng.standard_normal((B, H, T, V)).astype(np.float32)
    dsn = rng.standard_normal((B, H, K, V)).astype(np.float32)
    args = ("r", "k", "v", "w", "u", "s0")
    _, vjp = jax.vjp(jref.wkv6, *(jnp.asarray(inputs[a]) for a in args))
    want = vjp((jnp.asarray(don), jnp.asarray(dsn)))
    xs = [torch.from_numpy(inputs[a]) for a in args]
    do, ds = torch.from_numpy(don), torch.from_numpy(dsn)
    got = wkv_mod.wkv6_bwd_plain(*xs, do, ds)
    xs = [x.clone().requires_grad_() for x in xs]
    out, state = wkv_mod.wkv6(*xs)
    assert type(out.grad_fn).__name__ == "WKV6Backward"
    through = torch.autograd.grad([out, state], xs, [do, ds])
    for name, g, f, w in zip(WKV_GRADS, got, through, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
        assert torch.equal(f, g), name


TRAIN_BATCH, TRAIN_SEQ, TRAIN_M = 8, 16, 4


@pytest.fixture(scope="module")
def jax_train_ref(jax_ref):
    """The sequential JAX oracle's loss and grads (``test_torch_train``'s
    ``_oracle_loss_fn``) at pipe 1 on ``jax_ref``'s weights, one seeded
    batch."""
    from test_torch_train import _oracle_loss_fn
    arch = _widen(jconfigs.smoke_arch(ARCH))
    pcfg = jconfigs.smoke_parallel(ARCH).with_(n_micro=TRAIN_M)
    model = JLMModel(arch, pcfg, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, arch.vocab, (TRAIN_BATCH, TRAIN_SEQ))
             .astype(np.int32) for k in ("tokens", "labels")}
    loss, grads = jax.jit(jax.value_and_grad(_oracle_loss_fn(
        model, TRAIN_M)))(jax_ref["params"], jax.tree.map(jnp.asarray, batch))
    return {"params": jax_ref["params"], "batch": batch,
            "loss": float(loss), "grads": jax.device_get(grads)}


def _train_grads(ref_, pipe, **pcfg_kw):
    """The port's loss and grads at ``pipe`` on the oracle's weights and
    batch, through ``build_grad_fn`` (gpipe: autograd)."""
    arch = _widen(configs.smoke_arch(ARCH))
    pcfg = configs.smoke_parallel(ARCH).with_(pipe=pipe, n_micro=TRAIN_M,
                                              **pcfg_kw)
    model = LMModel(arch, pcfg, dtype=torch.float32, device="cpu")
    params = params_from_jax(ref_["params"], arch=arch, src_pipe=1,
                             pcfg=pcfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref_["batch"].items()}
    loss, grads = steps.build_grad_fn(model, pcfg, "cpu")(params, batch)
    return loss, grads, arch, pcfg


def test_rwkv_train_loss_and_grads_match_jax_oracle(jax_train_ref):
    """rwkv6 smoke (two heads) at pipe 2, m 4, gpipe: the loss and every
    gradient leaf against the sequential JAX oracle's, through the WKV6
    Function's backward."""
    from test_torch_train import _assert_tree_close
    loss, grads, arch, pcfg = _train_grads(jax_train_ref, 2)
    np.testing.assert_allclose(float(loss), jax_train_ref["loss"], **TOL)
    want = params_from_jax(jax_train_ref["grads"], arch=arch, src_pipe=1,
                           pcfg=pcfg, device="cpu")
    _assert_tree_close(grads, want, "rwkv6 pipe 2")
    assert all(float(g.abs().max()) > 0 for _, g in tree_items(grads))


def test_rwkv_1f1b_bitwise_equals_gpipe_tasked(jax_train_ref):
    """The fused executor's 1F1B and GPipe schedules run the same
    (stage, micro) work and fold it in micro order under
    ``grad_reduce="ordered"``: loss and grads bitwise equal."""
    a = _train_grads(jax_train_ref, 2, schedule="1f1b")
    b = _train_grads(jax_train_ref, 2, schedule="gpipe_tasked")
    assert torch.equal(a[0], b[0])
    for (path, x), (_, y) in zip(tree_items(a[1]), tree_items(b[1])):
        assert torch.equal(x, y), path


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_rwkv_train_kernel_contract_and_call_counts_on_cpu(monkeypatch,
                                                         schedule):
    """A train step of rwkv6 smoke at pipe 2 on the CPU path: every WKV-6
    and RMSNorm call, forward and backward, meets its CUDA kernel's
    contract, and the counts equal ``expected_train_launches``: one WKV-6
    and one RMSNorm (the group norm) a layer and micro-batch, each
    recomputed under remat "full", and one backward each."""
    from test_torch_train import COUNT_M, _count_train_calls
    seq = 64                  # no RMSNorm head: one loss chunk is enough
    calls, metrics, arch, pcfg = _count_train_calls(
        monkeypatch, ARCH, seq, schedule=schedule)
    L, m = arch.n_layers, COUNT_M
    fwd = 2 * L * m if schedule == "gpipe" else 2 * L * m - L // 2 * m
    assert calls == {"flash_attention": 0, "flash_attention_bwd": 0,
                     "rmsnorm": fwd, "rmsnorm_bwd": L * m, "wkv6": fwd,
                     "wkv6_bwd": L * m}
    assert calls == expected_train_launches(pcfg, arch, seq)
    assert np.isfinite(float(metrics["loss"]))


# ---------------------------------------------------------------------------
# Parameters: full-width tree, dtype rule of params_from_jax
# ---------------------------------------------------------------------------

def _flat_jax(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_full_width_param_tree_matches_jax():
    """Full rwkv6-1.6b: the port's parameter tree (meta device, nothing
    allocated) has jax.eval_shape(model.init)'s leaves, shapes and dtypes
    (tm/u and tm/w_base fp32 in a bf16 model)."""
    jarch = jconfigs.get_arch(ARCH)
    jpcfg = jconfigs.get_parallel(ARCH).with_(data=1, tp=1)
    want = _flat_jax(jax.eval_shape(JLMModel(jarch, jpcfg).init,
                                    jax.random.PRNGKey(0)))
    pcfg = configs.get_parallel(ARCH).with_(data=1, tp=1)
    model = LMModel(configs.get_arch(ARCH), pcfg, dtype=torch.bfloat16,
                    device="meta")
    got = dict(tree_items(model.init(torch.Generator().manual_seed(0))))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert tuple(got[path].shape) == tuple(leaf.shape), path
        assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), path
        assert got[path].device.type == "meta"
    assert str(want["stages/tm/u"].dtype) == "float32"
    assert str(want["stages/tm/w_base"].dtype) == "float32"


def test_params_from_jax_dtype_keeps_fp32_leaves():
    """A bf16 JAX rwkv tree (zeros with the leaves, shapes and dtypes of the
    JAX init): ``dtype=`` casts to the port's own leaf dtypes for that model
    dtype, so tm/u and tm/w_base stay fp32."""
    arch = _widen(jconfigs.smoke_arch(ARCH))
    jpcfg = jconfigs.smoke_parallel(ARCH)
    protos = jax.eval_shape(JLMModel(arch, jpcfg, dtype=jnp.bfloat16).init,
                            jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda p: np.zeros(p.shape, p.dtype),
                                  protos)
    src = _flat_jax(tree)
    assert str(src["stages/tm/wr"].dtype) == "bfloat16"
    pcfg = configs.smoke_parallel(ARCH).with_(pipe=2)
    for dtype in (None, torch.bfloat16, torch.float32):
        got = dict(tree_items(params_from_jax(
            tree, arch=_widen(configs.smoke_arch(ARCH)), src_pipe=1,
            pcfg=pcfg, device="cpu", dtype=dtype)))
        assert got.keys() == src.keys()
        for path, leaf in got.items():
            fp32_leaf = path in ("stages/tm/u", "stages/tm/w_base")
            if dtype is None:
                want = str(src[path].dtype)
            elif fp32_leaf or dtype == torch.float32:
                want = "float32"
            else:
                want = "bfloat16"
            assert str(leaf.dtype).split(".")[-1] == want, (dtype, path)


# ---------------------------------------------------------------------------
# Kernel contracts and launch formulas on the CPU path
# ---------------------------------------------------------------------------

def test_kernel_contract_and_call_counts_on_cpu(monkeypatch):
    """Every call that reaches a kernel's plain version meets the CUDA
    kernel's contract, and the calls follow the formulas chip_smoke.py checks
    on the card: wkv6 = rmsnorm = L*m per prefill and per decode step,
    flash_attention 0.  Full width (d_model 2048, 32 heads, d_ff 7168),
    2 layers, bf16; the vocabulary is cut to 4096, which no kernel sees."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import rmsnorm as rn_mod
    from repro_torch.launch.serve import serve

    calls = {"flash_attention": 0, "rmsnorm": 0, "wkv6": 0}

    def norm(x, scale, eps=1e-6, _plain=rn_mod.rmsnorm_plain):
        rn_mod.check_inputs(x, scale)
        calls["rmsnorm"] += 1
        return _plain(x, scale, eps)

    def attn(q, k, v, _plain=fa_mod.flash_attention_plain, **kw):
        calls["flash_attention"] += 1
        return _plain(q, k, v, **kw)

    def wkv(r, k, v, w, u, s0, _plain=wkv_mod.wkv6_plain):
        wkv_mod.check_inputs(r, k, v, w, u, s0)
        assert (r.dtype, w.dtype) == (torch.bfloat16, torch.float32)
        calls["wkv6"] += 1
        return _plain(r, k, v, w, u, s0)

    monkeypatch.setattr(rn_mod, "rmsnorm_plain", norm)
    monkeypatch.setattr(fa_mod, "flash_attention_plain", attn)
    monkeypatch.setattr(wkv_mod, "wkv6_plain", wkv)
    arch = dataclasses.replace(configs.get_arch(ARCH), n_layers=2, vocab=4096)
    pcfg = configs.get_parallel(ARCH).with_(pipe=2, data=1, tp=1)
    gen = 3
    res = serve(arch, pcfg, prompt_len=8, gen=gen, batch=4, device="cpu",
                dtype=torch.bfloat16)
    m, n_layers = res["n_micro"], arch.n_layers
    assert m == 4
    per_call = n_layers * m
    assert calls == {"flash_attention": 0, "rmsnorm": gen * per_call,
                     "wkv6": gen * per_call}
    assert res["tokens"].shape == (4, gen)
    assert bool(torch.isfinite(res["logits"].float()).all())
