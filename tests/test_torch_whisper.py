"""The port's encoder-decoder (whisper-tiny) against the JAX package, on the
CPU, at smoke size (``configs.smoke_arch("whisper-tiny")``: 2 encoder and 4
decoder blocks, d 64) in fp32.

Same weights (the JAX ``model.init(PRNGKey(0))`` moved across with
``interop.params_from_jax``) and the same seeded-numpy batches: (a) the
GELU MLP, cross-attention (train and decode), sinusoidal positions, the
blocks and the embeddings; (b) the per-layer constants, the skips and
their protos at pipe 1, 2, 4 and 8; (c) the loss and every gradient leaf
of gpipe at pipe 1, 2 and 4 and of the fused schedules at pipe 2 against a
sequential JAX oracle (``tests/test_oracle.py``'s ``oracle_loss_fn``, its
skip store included) at JAX pipe 1, the encoder layers' ``lnx`` / ``xattn``
gradients exactly 0; (d) inside the port, bit for bit: the one-chunk fused
schedules, portals against threaded routes, and the route high-water
against the plan; (e) prefill and three decode steps against the JAX
``build_prefill_step`` / ``build_serve_step``; (f) the kernel calls of the
CPU path against the launch formulas ``chip_smoke.py`` holds the card to.
The JAX side runs its attention through the blocked-jnp reference (the
per-layer ``causal`` flag is traced there).
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
from repro.core.pipeline import TickCtx as JTickCtx
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import lm as jlm

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import p2p
from repro_torch.interop import params_from_jax
from repro_torch.launch import steps
from repro_torch.launch.serve import expected_serve_launches
from repro_torch.launch.train import expected_train_launches
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.optim import optimizers as optim
from repro_torch.tree import tree_items, tree_map

# tests/test_oracle.py's fp32 TOL: same math, different graphs and sum order
TOL = dict(rtol=5e-4, atol=5e-5)
ARCH = "whisper-tiny"
BATCH, SEQ, M = 8, 16, 4
PROMPT, STEPS = 12, 3
DECODE_LEN = PROMPT + STEPS + 1          # cache slots = DECODE_LEN + 64

SCHEDULES = {
    "gpipe": dict(schedule="gpipe"),
    "gpipe_tasked": dict(schedule="gpipe_tasked"),
    "1f1b": dict(schedule="1f1b"),
    "zb": dict(schedule="zb"),
    "zb-reuse": dict(schedule="zb", residuals="reuse", remat="none"),
    "interleaved2": dict(schedule="interleaved:2"),
}
ORACLE_CASES = [("gpipe", 1), ("gpipe", 2), ("gpipe", 4),
                ("gpipe_tasked", 2), ("1f1b", 2), ("zb", 2), ("zb-reuse", 2),
                ("interleaved2", 2)]
# the schedules of one chunk per rank: bitwise equal under "ordered"
FLAT = ("gpipe_tasked", "1f1b", "zb", "zb-reuse")
_RUNS = {}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tag):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               **TOL, err_msg=tag)


def _jax_model(pipe=1, m=M):
    arch = jconfigs.smoke_arch(ARCH)
    pcfg = jconfigs.smoke_parallel(ARCH).with_(pipe=pipe, n_micro=m)
    return JLMModel(arch, pcfg, dtype=jnp.float32), pcfg


JLMModel = jlm.LMModel


def _oracle_loss_fn(model, m):
    """``tests/test_oracle.py``'s ``oracle_loss_fn``: the stage chain per
    micro-batch with the skips held in a plain dict, mean of the per-micro
    losses."""
    sk = model.skips()
    stage_apply = model.make_stage_apply(model.consts())

    def loss_fn(params, batch):
        fresh = model.embed_inputs(params["embed"], batch)
        fresh_mb = jax.tree.map(
            lambda a: a.reshape((m, a.shape[0] // m) + a.shape[1:]), fresh)
        labels_mb = batch["labels"].reshape(
            (m, batch["labels"].shape[0] // m) + batch["labels"].shape[1:])
        hp = {"head": params["head"], "embed": params["embed"]}
        total = jnp.zeros((), jnp.float32)
        for i in range(m):
            fresh_i = jax.tree.map(lambda a: a[i], fresh_mb)
            carry = {"h": jnp.zeros_like(fresh_i["h"])}
            store = {}
            for s in range(model.n_stages):
                skips_in = {e.name: store[e.name] for e in sk
                            if s in e.dsts and e.name in store}
                ctx = JTickCtx(stage=jnp.int32(s), micro=jnp.int32(i),
                               valid=jnp.asarray(True), t=jnp.int32(0),
                               fresh=fresh_i, n_stages=model.n_stages,
                               n_micro=m)
                p_s = jax.tree.map(lambda a: a[s], params["stages"])
                carry, skips_out, _ = stage_apply(p_s, carry, skips_in,
                                                  {}, ctx)
                for e in sk:
                    if e.src_stage == s:
                        store[e.name] = skips_out[e.name].astype(model.dtype)
            total = total + model.head_loss(
                hp, carry["h"], labels_mb[i]).astype(jnp.float32)
        return total / m
    return loss_fn


def _batch(rng, batch, seq, d, vocab):
    return {"frames": (rng.standard_normal((batch, seq, d)) * 0.1
                       ).astype(np.float32),
            "dec_tokens": rng.integers(0, vocab, (batch, seq)
                                       ).astype(np.int32),
            "labels": rng.integers(0, vocab, (batch, seq)).astype(np.int32)}


@pytest.fixture(scope="module")
def jax_ref():
    """JAX at pipe 1: the oracle's loss and grads on one seeded batch, and
    prefill + STEPS greedy decode steps through the reference's steps."""
    model, pcfg = _jax_model()
    arch = model.arch
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    batch = _batch(np.random.default_rng(0), BATCH, SEQ, arch.d_model,
                   arch.vocab)
    loss, grads = jax.jit(jax.value_and_grad(_oracle_loss_fn(model, M)))(
        params, jax.tree.map(jnp.asarray, batch))

    spcfg = pcfg.with_(n_micro=2)
    smodel = JLMModel(arch, spcfg, dtype=jnp.float32)
    mesh = jmesh.make_smoke_mesh(spcfg)
    prompt = _batch(np.random.default_rng(1), 4, PROMPT, arch.d_model,
                    arch.vocab)
    del prompt["labels"]
    serve = {"prompt": prompt, "tokens": [], "decode": []}
    with set_mesh(mesh):
        prefill = jax.jit(jsteps.build_prefill_step(
            smodel, spcfg, mesh, JShape("p", PROMPT, 4, "prefill")))
        decode = jax.jit(jsteps.build_serve_step(
            smodel, spcfg, mesh, JShape("d", DECODE_LEN, 4, "decode")))
        cache = smodel.init_cache(JShape("d", DECODE_LEN, 4, "decode"), 2,
                                  filled=False)
        logits, cache = prefill(params, cache,
                                jax.tree.map(jnp.asarray, prompt))
        serve["prefill"] = np.asarray(logits)
        for _ in range(STEPS):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            serve["tokens"].append(np.asarray(tok))
            logits, cache = decode(params, cache, tok)
            serve["decode"].append(np.asarray(logits))
    return {"params": jax.device_get(params), "batch": batch,
            "loss": float(loss), "grads": jax.device_get(grads),
            "serve": serve}


def _port(ref, pipe, m=M, **pcfg_kw):
    arch = configs.smoke_arch(ARCH)
    pcfg = configs.smoke_parallel(ARCH).with_(pipe=pipe, n_micro=m,
                                              **pcfg_kw)
    model = lm.LMModel(arch, pcfg, dtype=torch.float32, device="cpu")
    params = params_from_jax(ref["params"], arch=arch, src_pipe=1, pcfg=pcfg,
                             device="cpu", dtype=torch.float32)
    return model, pcfg, params


def _run(ref, name, pipe, **kw):
    """Loss, grads, buffer high-water and plan of one grad call of the port
    on the oracle's weights and batch (memoised: several tests read a run)."""
    key = (name, pipe, tuple(sorted(kw.items())))
    if key not in _RUNS:
        model, pcfg, params = _port(ref, pipe, **SCHEDULES[name], **kw)
        batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
        grad_fn = steps.build_grad_fn(model, pcfg, "cpu")
        loss, grads = grad_fn(params, batch)
        _RUNS[key] = dict(loss=loss, grads=grads, pcfg=pcfg, model=model,
                          park=dict(grad_fn.park_info), tplan=grad_fn.tplan)
    return _RUNS[key]


def _assert_bitwise(a, b, tag):
    assert torch.equal(a["loss"], b["loss"]), tag
    for (path, x), (_, y) in zip(tree_items(a["grads"]),
                                 tree_items(b["grads"])):
        assert torch.equal(x, y), f"{tag} {path}"


# ---------------------------------------------------------------------------
# (a) layers, blocks, positions, embeddings
# ---------------------------------------------------------------------------

def _attn_params(rng, d, a):
    def w(din, dout):
        return (rng.standard_normal((din, dout)) * din ** -0.5
                ).astype(np.float32)
    return {"wq": w(d, a.n_heads * a.head_dim),
            "wk": w(d, a.n_kv_heads * a.head_dim),
            "wv": w(d, a.n_kv_heads * a.head_dim),
            "wo": w(a.n_heads * a.head_dim, d)}


def _layer_case(case):
    """(JAX result, port result) of one layer-level case, numpy / torch."""
    arch, jarch = configs.smoke_arch(ARCH), jconfigs.smoke_arch(ARCH)
    a, ja, d = arch.attn, jarch.attn, arch.d_model
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, d)).astype(np.float32)
    mem = rng.standard_normal((2, 6, d)).astype(np.float32)
    tt = lambda tree: tree_map(_t, tree)                       # noqa: E731
    if case == "gelu_mlp":
        p = {"wu": rng.standard_normal((d, arch.d_ff)).astype(np.float32)
             * 0.2,
             "wd": rng.standard_normal((arch.d_ff, d)).astype(np.float32)
             * 0.1}
        return (JL.mlp_apply(p, x, "gelu"),
                L.mlp_apply(tt(p), _t(x), arch.act))
    if case in ("cross_attn", "self_attn_noncausal"):
        p = _attn_params(rng, d, a)
        memory = mem if case == "cross_attn" else None
        want = JL.attn_apply(p, x, ja, memory=memory, causal=0)
        got = L.attn_apply(tt(p), _t(x), a, causal=0,
                           memory=None if memory is None else _t(memory))
        return want, got
    if case == "cross_decode":
        p = _attn_params(rng, d, a)
        kv = [rng.standard_normal((2, 8, a.n_kv_heads, a.head_dim)
                                  ).astype(np.float32) for _ in range(2)]
        cache = {"k": kv[0], "v": kv[1], "len": np.int32(5)}
        want, jcache = JL.attn_decode(p, x[:, :1], jax.tree.map(
            jnp.asarray, cache), ja, cross=True)
        tcache = {"k": _t(kv[0]), "v": _t(kv[1]),
                  "len": torch.tensor(5, dtype=torch.int32)}
        got, tcache = L.attn_decode(tt(p), _t(x[:, :1]), tcache, a,
                                    cross=True)
        assert int(tcache["len"]) == int(jcache["len"]) == 5
        assert torch.equal(tcache["k"], _t(kv[0]))
        return want, got
    if case == "sinusoidal":
        # positions of this file's sequences; every position to 4095 is
        # held to a rounding bound below (TOL does not reach that far)
        pos = np.array([0, 1, 5, 37, 63])
        return (jlm.sinusoidal(jnp.asarray(pos), d),
                lm.sinusoidal(torch.from_numpy(pos), d))
    if case in ("enc_block", "dec_block"):
        jmodel, _ = _jax_model()
        p = JB.dense_init(jax.random.PRNGKey(3), jmodel.arch, jnp.float32)
        p = jax.tree.map(lambda v: v + 0.1 * jax.random.normal(
            jax.random.PRNGKey(4), v.shape), p)       # norms off the identity
        enc = case == "enc_block"
        c = {"mask": 1.0, "window": 0, "causal": 0 if enc else 1,
             "cross": 0.0 if enc else 1.0}
        want = JB.dense_apply(p, x, jax.tree.map(jnp.asarray, c),
                              jmodel.arch,
                              memory=np.zeros_like(mem) if enc else mem)
        got = B.dense_apply(tt(jax.device_get(p)), _t(x), c, arch,
                            memory=None if enc else _t(mem))
        return want, got
    raise ValueError(case)


@pytest.mark.parametrize("case", ["gelu_mlp", "cross_attn",
                                  "self_attn_noncausal", "cross_decode",
                                  "sinusoidal", "enc_block", "dec_block"])
def test_layers_match_jax(case):
    want, got = _layer_case(case)
    assert tuple(got.shape) == tuple(np.shape(want))
    _close(got, want, case)


@pytest.mark.parametrize("d", [64, 384])
def test_sinusoidal_matches_jax_to_4095(d):
    """Every position up to 4095 (the card trains whisper at seq 4096), at
    the smoke and the full width, against a bound from fp32 rounding rather
    than TOL: the two sides' fp32 ``exp`` may round a frequency ``f`` an ulp
    apart, which the angle ``pos * f`` carries times the position; each
    side rounds the angle (half an ulp of it) and sin / cos (about an ulp
    of a value in [-1, 1], 2^-24).  The bound allows twice their sum."""
    pos = np.arange(4096)
    half = d // 2
    freq = np.asarray(jnp.exp(-jnp.arange(half) / (half - 1)
                              * np.log(10000.0)))
    ang = pos[:, None].astype(np.float32) * freq
    err = pos[:, None] * np.spacing(freq) + np.spacing(np.abs(ang)) \
        + 2.0 ** -24
    bound = 2 * np.concatenate([err, err], -1)
    want = np.asarray(jlm.sinusoidal(jnp.asarray(pos), d))
    got = lm.sinusoidal(torch.from_numpy(pos), d).numpy()
    assert got.shape == want.shape == (4096, d)
    gap = np.abs(got.astype(np.float64) - want)
    assert np.all(gap <= bound), float((gap / bound).max())


@pytest.mark.parametrize("what", ["embed_inputs", "embed_decode"])
def test_embeddings_match_jax(jax_ref, what):
    jmodel, _ = _jax_model()
    model, _, params = _port(jax_ref, 1)
    emb = jax_ref["params"]["embed"]
    if what == "embed_inputs":
        batch = {k: v for k, v in jax_ref["batch"].items() if k != "labels"}
        want = jmodel.embed_inputs(emb, jax.tree.map(jnp.asarray, batch))
        got = model.embed_inputs(params["embed"], tree_map(_t, batch))
        assert got.keys() == want.keys() == {"h", "dec_h"}
        for k in want:
            _close(got[k], want[k], k)
    else:
        tok = jax_ref["batch"]["dec_tokens"][:, :1]
        _close(model.embed_decode(params["embed"], _t(tok), pos=21),
               jmodel.embed_decode(emb, jnp.asarray(tok), 21), what)


# ---------------------------------------------------------------------------
# (b) constants, skips and protos
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipe", [1, 2, 4, 8])
def test_consts_and_skips_match_jax(pipe):
    jmodel, _ = _jax_model(pipe)
    model = lm.LMModel(configs.smoke_arch(ARCH),
                       configs.smoke_parallel(ARCH).with_(pipe=pipe,
                                                          n_micro=M),
                       dtype=torch.float32, device="cpu")
    want, got = jmodel.consts(), model.consts()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    edges = [(e.name, e.src_stage, tuple(e.dsts)) for e in model.skips()]
    assert edges == [(e.name, e.src_stage, tuple(e.dsts))
                     for e in jmodel.skips()]
    protos = model.skip_protos(2, SEQ)
    jprotos = jmodel.skip_protos(2, SEQ)
    assert protos.keys() == jprotos.keys()
    for k, (shape, dtype) in protos.items():
        assert shape == tuple(jprotos[k].shape) and dtype == torch.float32
    assert (model.enc_last_stage, model.dec_first_stage) == \
        (jmodel.enc_last_stage, jmodel.dec_first_stage)
    if pipe == 4:
        # one encoder stage, three decoder stages (the last all padding)
        assert edges == [("mem", 0, (1, 2, 3)), ("dec_in", 0, (1,))]
        assert not got["mask"][3].any()


# ---------------------------------------------------------------------------
# (c) loss and every grad vs the sequential oracle
# ---------------------------------------------------------------------------

def _encoder_slots(model):
    c = model.consts()
    return [(s, l) for s, l in zip(*np.nonzero(c["mask"] > 0))
            if not c["cross"][s, l]]


@pytest.mark.parametrize("name, pipe", ORACLE_CASES)
def test_loss_and_grads_match_jax_oracle(jax_ref, name, pipe):
    run = _run(jax_ref, name, pipe)
    np.testing.assert_allclose(float(run["loss"]), jax_ref["loss"], **TOL)
    model = run["model"]
    want = params_from_jax(jax_ref["grads"], arch=model.arch, src_pipe=1,
                           pcfg=run["pcfg"], device="cpu")
    got_items, want_items = (dict(tree_items(t)) for t in (run["grads"],
                                                           want))
    assert got_items.keys() == want_items.keys()
    for path, w in want_items.items():
        _close(got_items[path], w.numpy(), f"{name} pipe {pipe} {path}")
    # an encoder layer's cross-attention adds exact zeros: its grads are 0
    enc = _encoder_slots(model)
    assert len(enc) == model.arch.enc_layers
    for path, g in got_items.items():
        if path.startswith(("stages/lnx", "stages/xattn")):
            for s, l in enc:
                assert not g[s, l].any(), (path, s, l)
                assert not want_items[path][s, l].any(), (path, s, l)


def test_gpipe_hop_node_order(jax_ref, monkeypatch):
    """One process puts an autograd node on every cross-rank hop
    (``p2p.hop_node``) so that it sums a value's cotangents per hop, the
    order a pipe group must keep (``tests/test_torch_dist.py`` holds the
    ranks bitwise to it).  That order is not the plain graph's: at pipe 4
    whisper's gradients move, by a few ulp (7.5e-9 at most when it was
    introduced).  Both orders stay within TOL of the JAX oracle, and the
    move is pinned here."""
    run = _run(jax_ref, "gpipe", 4)
    monkeypatch.setattr(p2p, "hop_node", lambda wire: wire)
    model, pcfg, params = _port(jax_ref, 4, **SCHEDULES["gpipe"])
    batch = {k: torch.from_numpy(v) for k, v in jax_ref["batch"].items()}
    loss, grads = steps.build_grad_fn(model, pcfg, "cpu")(params, batch)
    assert torch.equal(loss, run["loss"])
    want = dict(tree_items(params_from_jax(
        jax_ref["grads"], arch=model.arch, src_pipe=1, pcfg=pcfg,
        device="cpu")))
    shift = 0.0
    for (path, a), (_, b) in zip(tree_items(grads),
                                 tree_items(run["grads"])):
        _close(a, want[path].numpy(), f"plain graph {path}")
        shift = max(shift, float((a - b).abs().max()))
    assert 0 < shift < 1e-7, shift


# ---------------------------------------------------------------------------
# (d) inside the port, bit for bit
# ---------------------------------------------------------------------------

def test_fused_schedules_bitwise_equal(jax_ref):
    base = _run(jax_ref, FLAT[0], 2)
    for name in FLAT[1:]:
        _assert_bitwise(_run(jax_ref, name, 2), base, f"{name} vs {FLAT[0]}")


@pytest.mark.parametrize("name", ["gpipe", "1f1b"])
def test_portals_equal_threaded_routes(jax_ref, name):
    """At pipe 4 ``mem`` travels 0 -> 1, 2, 3: threaded, stages 1 and 2
    relay it; the values and gradients are the same bits."""
    portal = _run(jax_ref, name, 4)
    threaded = _run(jax_ref, name, 4, portals=False)
    assert len(portal["tplan"].routes) == 4
    assert any(rt.threaded for rt in threaded["tplan"].routes)
    _assert_bitwise(threaded, portal, f"{name} threaded vs portals")


@pytest.mark.parametrize("name, pipe, portals",
                         [(n, p, True) for n, p in ORACLE_CASES if p > 1]
                         + [("gpipe", 4, False), ("1f1b", 4, False)])
def test_route_high_water_equals_plan(jax_ref, name, pipe, portals):
    run = _run(jax_ref, name, pipe, **({} if portals else
                                        {"portals": False}))
    tplan = run["tplan"]
    want = {rt.key: ({"depth": rt.depth, "g_depth": rt.g_depth}
                     if tplan.has_backward else {"depth": rt.depth})
            for rt in tplan.routes}
    assert want and run["park"]["per_route"] == want
    assert run["park"]["per_stage_park"] == tplan.per_stage_park
    mem = [k for k in want if k.startswith("mem@")]
    assert len(mem) == len(run["model"].skips()[0].dsts)


# ---------------------------------------------------------------------------
# (e) serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipe", [1, 2, 4])
def test_prefill_and_decode_match_jax(jax_ref, pipe):
    ref = jax_ref["serve"]
    model, pcfg, params = _port(jax_ref, pipe, m=2)
    prefill = steps.build_prefill_step(
        model, pcfg, "cpu", ShapeConfig("p", PROMPT, 4, "prefill"))
    dshape = ShapeConfig("d", DECODE_LEN, 4, "decode")
    decode = steps.build_serve_step(model, pcfg, "cpu", dshape)
    cache = model.init_cache(dshape, 2, filled=False)
    logits, cache = prefill(params, cache, tree_map(_t, ref["prompt"]))
    _close(logits, ref["prefill"], f"pipe {pipe} prefill")
    for i, tok in enumerate(ref["tokens"]):
        logits, cache = decode(params, cache, _t(tok))
        _close(logits, ref["decode"][i], f"pipe {pipe} decode {i}")


# ---------------------------------------------------------------------------
# (f) kernel calls of the CPU path vs the launch formulas
# ---------------------------------------------------------------------------

def _counting(monkeypatch):
    """Count each plain attention call, forward and backward, after holding
    it to the CUDA kernel's contract."""
    from repro_torch.kernels import flash_attention as fa

    calls = {"flash_attention": 0, "flash_attention_bwd": 0}

    def counted(name, check, plain):
        def fn(*args, **kw):
            check(*args, **kw)
            calls[name] += 1
            return plain(*args, **kw)
        return fn

    monkeypatch.setattr(fa, "flash_attention_plain", counted(
        "flash_attention", lambda q, k, v, **_: fa.check_inputs(q, k, v),
        fa.flash_attention_plain))
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", counted(
        "flash_attention_bwd",
        lambda q, k, v, out, lse, do, q_offset=0, **_: fa.check_bwd_inputs(
            q, k, v, out, lse, do, q_offset), fa.flash_attention_bwd_plain))
    return calls


def _count_arch():
    """The smoke arch with head_dim 64, so the attention contract holds."""
    arch = configs.smoke_arch(ARCH)
    return dataclasses.replace(arch, attn=dataclasses.replace(
        arch.attn, head_dim=64))


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_train_attention_calls_match_formula(monkeypatch, schedule):
    """Per micro-batch, an encoder layer runs one attention and a decoder
    layer two (self and cross): the encoder's cross-attention is skipped."""
    calls = _counting(monkeypatch)
    arch, seq, m = _count_arch(), 64, 2
    pcfg = configs.smoke_parallel(ARCH).with_(pipe=2, n_micro=m,
                                              schedule=schedule)
    model = lm.LMModel(arch, pcfg, dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    ocfg = optim.OptimizerConfig()
    step = steps.build_train_step(model, pcfg, "cpu",
                                  ShapeConfig("t", seq, 2, "train"), ocfg)
    batch = tree_map(_t, _batch(np.random.default_rng(2), 2, seq,
                                arch.d_model, arch.vocab))
    _, _, metrics = step(params, optim.init(ocfg, params), batch)
    want = expected_train_launches(pcfg, arch, seq)
    assert calls == {k: want[k] for k in calls}
    assert want["rmsnorm"] == want["rmsnorm_bwd"] == 0      # LayerNorm
    per_micro = arch.enc_layers + 2 * arch.n_layers
    assert want["flash_attention_bwd"] == per_micro * m
    assert np.isfinite(float(metrics["loss"]))


def test_serve_attention_calls_match_formula(monkeypatch):
    calls = _counting(monkeypatch)
    arch, m, gen = _count_arch(), 2, 3
    pcfg = configs.smoke_parallel(ARCH).with_(pipe=2, n_micro=m)
    model = lm.LMModel(arch, pcfg, dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    dshape = ShapeConfig("d", 32 + gen, 2, "decode")
    prefill = steps.build_prefill_step(model, pcfg, "cpu",
                                       ShapeConfig("p", 32, 2, "prefill"))
    decode = steps.build_serve_step(model, pcfg, "cpu", dshape)
    cache = model.init_cache(dshape, m, filled=False)
    batch = tree_map(_t, _batch(np.random.default_rng(3), 2, 32,
                                arch.d_model, arch.vocab))
    logits, cache = prefill(params, cache, {k: batch[k] for k in
                                            ("frames", "dec_tokens")})
    want = expected_serve_launches(arch, pcfg, m, gen)
    assert calls["flash_attention"] == want["prefill"]["flash_attention"] \
        == (arch.enc_layers + 2 * arch.n_layers) * m
    for _ in range(gen - 1):
        logits, cache = decode(params, cache, torch.argmax(logits, -1))
    assert calls["flash_attention"] == want["prefill"]["flash_attention"]
    assert want["decode"] == dict.fromkeys(want["decode"], 0)
    assert calls["flash_attention_bwd"] == 0
    assert bool(torch.isfinite(logits).all())
