"""Stream injection and the wire codec of the port (``cfg.stream_inputs``,
``cfg.wire``, ``grad_compression="int8_ef"``) against the JAX package, on
the CPU, at smoke size in fp32: seq 16, global batch 16, m 4.

Same weights (the JAX ``model.init(PRNGKey(0))`` moved across with
``interop.params_from_jax``) and seeded-numpy batches:

(a) the wire codec's ``enc`` / ``dec`` and ``EFCompressor.compress_reduce``
    bitwise against the reference's ``_Codec`` and ``EFCompressor`` on the
    same arrays and error-feedback state over repeated sends (non-float
    leaves, a block that does not divide the leaf, an all-zero block);
(b) streamed runs bitwise equal to replicated ones in the loss and every
    gradient (the embeddings' too, which the input cotangents reach in
    micro-batch order) for gpipe and every fused schedule at pipe 2 and 4
    on smollm-360m and whisper-tiny, within ``TOL`` of the sequential
    oracle, the stream stash's high-water equal to the plan's, and the
    reference's rules for ``n_micro % pipe != 0``; the prefill streams;
(c) lossy wires in the fused executor against the oracle at the
    reference's own tolerances (``tests/test_wire.py``: loss rtol 2e-3,
    grads rtol 5e-3 / atol 2e-3) and a 5-step curve within 5% of fp32's
    that falls; ``fp32`` the identity, ``bf16`` bitwise on a bf16 model;
(d) the forward executor: ``bf16`` under autograd against the oracle with
    the wire's casts at its hops, within ``TOL``; ``int8-ef`` under autograd
    raises, in serving it runs;
(e) ``grad_compression="int8_ef"``: a train step against the reference's
    ``_maybe_compress_grads`` on the same gradients, bitwise; a non-finite
    step keeps the old residual.
The reference's multi-device executor is not spawned: the port is held to
the single-device oracle, as ``tests/test_torch_fused.py`` explains.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_whisper import _batch, _few_threads  # noqa: F401

from repro import configs as jconfigs
from repro.core import pipeline as jpipeline
from repro.core.pipeline import TickCtx as JTickCtx
from repro.configs.base import ParallelConfig as JParallel
from repro.launch import steps as jsteps
from repro.models.lm import LMModel as JLMModel
from repro.optim import optimizers as joptim
from repro.runtime import compression as jcompression

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import pipeline
from repro_torch.core.plan import plan_for
from repro_torch.interop import params_from_jax
from repro_torch.launch import steps
from repro_torch.models.lm import LMModel
from repro_torch.optim import optimizers as optim
from repro_torch.runtime.compression import EFCompressor
from repro_torch.tree import tree_items, tree_leaves, tree_map

# tests/test_oracle.py's fp32 TOL: same math, different graphs and sum order
TOL = dict(rtol=5e-4, atol=5e-5)
# the reference's int8-ef wire against its oracle (tests/test_wire.py)
WIRE_LOSS_RTOL = 2e-3
WIRE_GRAD_TOL = dict(rtol=5e-3, atol=2e-3)
CURVE_RTOL = 5e-2          # the lossy 5-step curve against fp32's
SEQ, BATCH, M = 16, 16, 4
OCFG = dict(lr=2e-3, warmup_steps=2, total_steps=20)
FUSED = {"gpipe_tasked": dict(schedule="gpipe_tasked"),
         "1f1b": dict(schedule="1f1b"),
         "zb": dict(schedule="zb"),
         "zb-reuse": dict(schedule="zb", residuals="reuse", remat="none"),
         "interleaved2": dict(schedule="interleaved:2")}
SCHEDULES = {"gpipe": dict(schedule="gpipe"), **FUSED}
ARCHS = ("smollm-360m", "whisper-tiny")
MIXED = "chain=fp32,portal=int8-ef,cotangent=bf16"


def _bf16_hop(cast):
    """The bf16 wire on one leaf where ``cast`` (a traced flag) holds: a
    cast there and back (ints pass); elsewhere the leaf itself, bitwise, in
    value and in gradient."""
    def hop(a):
        if not jnp.issubdtype(a.dtype, jnp.floating):
            return a
        return jnp.where(cast, a.astype(jnp.bfloat16).astype(a.dtype), a)
    return hop


def _oracle_loss_fn(model, m, hop=None):
    """``tests/test_oracle.py``'s ``oracle_loss_fn``: the stage chain per
    micro-batch, skips held in a dict, mean of the per-micro losses (summed
    in micro order; one ``lax.scan`` over the micro-batches keeps the
    compile short).  ``hop`` is applied where a value leaves its stage for
    another (the carry, a skip): with one stage a rank, the wire's codec on
    every hop."""
    hop = hop or (lambda a: a)
    sk = model.skips()
    stage_apply = model.make_stage_apply(model.consts())

    def loss_fn(params, batch):
        fresh = model.embed_inputs(params["embed"], batch)
        fresh_mb = jax.tree.map(
            lambda a: a.reshape((m, a.shape[0] // m) + a.shape[1:]), fresh)
        labels_mb = batch["labels"].reshape(
            (m, batch["labels"].shape[0] // m) + batch["labels"].shape[1:])
        hp = {"head": params["head"], "embed": params["embed"]}

        def micro(total, xs):
            i, fresh_i, labels_i = xs
            carry = {"h": jnp.zeros_like(fresh_i["h"])}
            store = {}
            for s in range(model.n_stages):
                skips_in = {e.name: store[e.name] for e in sk
                            if s in e.dsts and e.name in store}
                ctx = JTickCtx(stage=jnp.int32(s), micro=i,
                               valid=jnp.asarray(True), t=jnp.int32(0),
                               fresh=fresh_i, n_stages=model.n_stages,
                               n_micro=m)
                p_s = jax.tree.map(lambda a: a[s], params["stages"])
                carry, skips_out, _ = stage_apply(p_s, carry, skips_in,
                                                  {}, ctx)
                if s < model.n_stages - 1:
                    carry = jax.tree.map(hop, carry)
                for e in sk:
                    if e.src_stage == s:
                        store[e.name] = hop(
                            skips_out[e.name].astype(model.dtype))
            loss = model.head_loss(hp, carry["h"], labels_i)
            return total + loss.astype(jnp.float32), None

        total, _ = jax.lax.scan(micro, jnp.zeros((), jnp.float32),
                                (jnp.arange(m, dtype=jnp.int32), fresh_mb,
                                 labels_mb))
        return total / m
    return loss_fn


_REFS = {}


def _ref(arch_name):
    """JAX params, one seeded batch, and the oracle's loss and grads at
    pipe 2 (grads in that layout): unwired, and with the bf16 wire's casts
    at the stage boundary (one compile: the cast is a traced flag)."""
    if arch_name not in _REFS:
        arch = jconfigs.smoke_arch(arch_name)
        pcfg = jconfigs.smoke_parallel(arch_name).with_(n_micro=M)
        params = jax.jit(JLMModel(arch, pcfg, dtype=jnp.float32).init)(
            jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        if arch.is_encdec:
            batch = _batch(rng, BATCH, SEQ, arch.d_model, arch.vocab)
        else:
            batch = {k: rng.integers(0, arch.vocab, (BATCH, SEQ)
                                     ).astype(np.int32)
                     for k in ("tokens", "labels")}
        model2 = JLMModel(arch, pcfg.with_(pipe=2), dtype=jnp.float32)
        params2 = dict(params, stages=jax.tree.map(
            lambda a: a.reshape((2, a.shape[1] // 2) + a.shape[2:]),
            params["stages"]))

        @jax.jit
        def oracle(p, b, cast):
            return jax.value_and_grad(_oracle_loss_fn(
                model2, M, hop=_bf16_hop(cast)))(p, b)
        jbatch = jax.tree.map(jnp.asarray, batch)
        out = {"params": jax.device_get(params), "batch": batch}
        for key, cast in (("", False), ("bf16_", True)):
            loss, grads = oracle(params2, jbatch, jnp.asarray(cast))
            out[key + "loss"] = float(loss)
            out[key + "grads"] = jax.device_get(grads)
        _REFS[arch_name] = out
    return _REFS[arch_name]


def _port(arch_name, pipe, dtype=torch.float32, **pcfg_kw):
    ref = _ref(arch_name)
    arch = configs.smoke_arch(arch_name)
    pcfg = configs.smoke_parallel(arch_name).with_(pipe=pipe, n_micro=M,
                                                   **pcfg_kw)
    model = LMModel(arch, pcfg, dtype=dtype, device="cpu")
    params = params_from_jax(ref["params"], arch=arch, src_pipe=1, pcfg=pcfg,
                             device="cpu", dtype=dtype)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    if dtype != torch.float32 and "frames" in batch:
        batch["frames"] = batch["frames"].to(dtype)
    return model, pcfg, params, batch


_RUNS = {}


def _run(arch_name, pipe, name, dtype=torch.float32, **kw):
    """Loss, grads, buffer high-water and plan of one grad call of the port
    (memoised: several tests read a run)."""
    key = (arch_name, pipe, name, dtype, tuple(sorted(kw.items())))
    if key not in _RUNS:
        model, pcfg, params, batch = _port(arch_name, pipe, dtype,
                                           **SCHEDULES[name], **kw)
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


def _assert_vs_oracle(run, arch_name, loss, grads, loss_rtol=TOL["rtol"],
                      **tol):
    np.testing.assert_allclose(float(run["loss"]), loss, rtol=loss_rtol)
    want = params_from_jax(grads, arch=run["model"].arch, src_pipe=2,
                           pcfg=run["pcfg"], device="cpu")
    want_items = dict(tree_items(want))
    for path, g in tree_items(run["grads"]):
        np.testing.assert_allclose(g.float().numpy(),
                                   want_items[path].float().numpy(),
                                   **(tol or TOL),
                                   err_msg=f"{arch_name} {path}")


# ---------------------------------------------------------------------------
# (a) the codec and the compressor against the reference, bitwise
# ---------------------------------------------------------------------------

def _payloads(n_sends):
    """Trees with a float leaf of 37 elements (block 16 leaves a tail) whose
    second block is all zero, a [2, 3, 16] leaf and an int32 leaf."""
    rng = np.random.default_rng(5)
    out = []
    for k in range(n_sends):
        h = (rng.standard_normal(37) * (k + 1)).astype(np.float32)
        h[16:32] = 0.0
        out.append({"h": h,
                    "x": rng.standard_normal((2, 3, 16)).astype(np.float32),
                    "ids": rng.integers(0, 100, (4,)).astype(np.int32)})
    return out


def _bits(a):
    """A leaf's bits as numpy (bf16 viewed as int16)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("codec", ["bf16", "int8-ef"])
def test_codec_matches_reference_bitwise(codec):
    """Three sends of one stream: the wire, the error-feedback residual
    after each and the decoded arrival equal the reference's bit for bit;
    the int32 leaf passes through untouched."""
    ours = pipeline._Codec(codec, 16)
    theirs = jpipeline._Codec(codec, 16)
    sends = _payloads(3)
    ef_t = ours.ef_zeros(tree_map(torch.from_numpy, sends[0]))
    ef_j = theirs.ef_zeros(jax.tree.map(jnp.asarray, sends[0]))
    for k, value in enumerate(sends):
        v_t = tree_map(torch.from_numpy, value)
        wire_t, ef_t = ours.enc(v_t, ef_t)
        wire_j, ef_j = theirs.enc(jax.tree.map(jnp.asarray, value), ef_j)
        got = dict(tree_items(wire_t))
        want = {"/".join(str(getattr(p, "key", p)) for p in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    wire_j)[0]}
        assert got.keys() == want.keys()
        for path in want:
            np.testing.assert_array_equal(_bits(got[path]),
                                          _bits(want[path]),
                                          err_msg=f"{codec} send {k} {path}")
        assert got["ids"] is v_t["ids"]
        if ours.stateful:
            for leaf in ("h", "x"):
                np.testing.assert_array_equal(ef_t[leaf].numpy(),
                                              np.asarray(ef_j[leaf]))
            assert ef_t["ids"] is None
        dec_t = ours.dec(wire_t, v_t)
        dec_j = theirs.dec(wire_j, jax.tree.map(jnp.asarray, value))
        for path, leaf in tree_items(dec_t):
            assert leaf.dtype == v_t[path].dtype
            np.testing.assert_array_equal(leaf.numpy(),
                                          np.asarray(dec_j[path]))


def test_fp32_wire_is_the_identity():
    """The fp32 codec ships the value tree itself: the same tensors, no
    proto to decode to, no error-feedback state."""
    tplan = plan_for("1f1b", M, 2, wire="chain=fp32,portal=fp32,"
                                        "cotangent=fp32")
    wire = pipeline._Wire(tplan)
    value = {"h": torch.ones(3), "ids": torch.arange(2)}
    sent, proto = wire.enc("f", 0, value)
    assert sent is value and proto is None
    assert wire.dec("f", sent, proto) is value and not wire.ef
    codec = pipeline._Codec("fp32", 16)
    assert codec.enc(value)[0] is value and codec.dec(value, value) is value


def test_bf16_wire_ships_bf16_values_as_they_are():
    """A bf16 hop of a value whose float leaves are already bf16 is the
    identity (no proto, no cast); an fp32 leaf is cast and cast back."""
    tplan = plan_for("1f1b", M, 2, wire="bf16")
    wire = pipeline._Wire(tplan)
    value = {"h": torch.ones(3, dtype=torch.bfloat16),
             "ids": torch.arange(2)}
    sent, proto = wire.enc("f", 0, value)
    assert sent is value and proto is None
    mixed = {"h": torch.full((3,), 1 / 3), "ids": torch.arange(2)}
    sent, proto = wire.enc("f", 0, mixed)
    assert sent["h"].dtype == torch.bfloat16 and proto is not None
    back = wire.dec("f", sent, proto)
    assert back["h"].dtype == torch.float32 and back["ids"] is mixed["ids"]
    assert torch.equal(back["h"], mixed["h"].to(torch.bfloat16).float())


def test_codec_range_only_while_profiling():
    """The codec enters its profiler range only while a profiler runs: one
    range for the encode and one for the decode of a lossy payload."""
    codec = pipeline._Codec("int8-ef", 16)
    x = torch.randn(4, 40, generator=torch.Generator().manual_seed(0))
    assert isinstance(pipeline._codec_range(), contextlib.nullcontext)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        codec.dec(codec.enc(x, codec.ef_zeros(x))[0], x)
    names = [e.name for e in prof.events()]
    assert names.count(pipeline.WIRE_CODEC_RANGE) == 2


def test_ef_compressor_matches_reference_bitwise():
    """Three steps of compress_reduce with the residual fed back: the
    dequantized grads and the residuals equal the reference's bit for bit;
    payload bytes too."""
    comp, jcomp = EFCompressor(block=16), jcompression.EFCompressor(block=16)
    steps_ = _payloads(3)
    grads0 = {k: v for k, v in steps_[0].items() if k != "ids"}
    ef_t = comp.init_state(tree_map(torch.from_numpy, grads0))
    ef_j = jcomp.init_state(jax.tree.map(jnp.asarray, grads0))
    for k, value in enumerate(steps_):
        g = {kk: v for kk, v in value.items() if kk != "ids"}
        red_t, ef_t = comp.compress_reduce(tree_map(torch.from_numpy, g),
                                           ef_t)
        red_j, ef_j = jcomp.compress_reduce(jax.tree.map(jnp.asarray, g),
                                            ef_j)
        for leaf in g:
            np.testing.assert_array_equal(red_t[leaf].numpy(),
                                          np.asarray(red_j[leaf]),
                                          err_msg=f"step {k} {leaf}")
            np.testing.assert_array_equal(ef_t[leaf].numpy(),
                                          np.asarray(ef_j[leaf]),
                                          err_msg=f"step {k} {leaf}")
    assert comp.payload_bytes(tree_map(torch.from_numpy, grads0)) == \
        jcomp.payload_bytes(jax.tree.map(jnp.asarray, grads0))


# ---------------------------------------------------------------------------
# (b) streaming
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SCHEDULES))
@pytest.mark.parametrize("pipe", [2, 4])
@pytest.mark.parametrize("arch_name", ARCHS)
def test_streamed_equals_replicated_bitwise(arch_name, pipe, name):
    """Streamed: the loss and every gradient bitwise equal to the
    replicated run's, within TOL of the sequential oracle; a fused plan's
    stream stash held as many slots per rank as the plan allocates."""
    streamed = _run(arch_name, pipe, name, stream_inputs=True)
    _assert_bitwise(streamed, _run(arch_name, pipe, name), name)
    ref = _ref(arch_name)
    _assert_vs_oracle(streamed, arch_name, ref["loss"], ref["grads"])
    if name in FUSED:
        assert streamed["park"]["per_stage_fs"] == \
            streamed["tplan"].per_stage_fs
    else:
        assert "per_stage_fs" not in streamed["park"]


def test_stream_off_for_gpipe_when_ranks_do_not_divide_m(monkeypatch):
    """gpipe at pipe 4, m 2: the stream is silently off (the reference's
    rule), so the run is the replicated one."""
    def no_stream(*a):
        raise AssertionError("streamed with m % pipe != 0")
    model, pcfg, params, batch = _port("smollm-360m", 4, schedule="gpipe",
                                       stream_inputs=True)
    pcfg = pcfg.with_(n_micro=2)
    monkeypatch.setattr(pipeline, "_Stream", no_stream)
    loss, _ = steps.build_grad_fn(model, pcfg, "cpu")(params, batch)
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("name", list(FUSED))
def test_fused_stream_raises_when_ranks_do_not_divide_m(name):
    model, pcfg, _, _ = _port("smollm-360m", 4, **FUSED[name],
                              stream_inputs=True)
    m = 6 if name == "interleaved2" else 2     # interleaved needs m % 2
    with pytest.raises(ValueError, match="divisible by pipe"):
        steps.build_grad_fn(model, pcfg.with_(n_micro=m), "cpu")


@pytest.mark.parametrize("arch_name", ARCHS)
def test_streamed_prefill_equals_replicated(arch_name):
    """The prefill step streams when the config asks: logits and every
    cache leaf bitwise equal to the replicated prefill's, at pipe 2."""
    out = []
    for stream in (False, True):
        model, pcfg, params, _ = _port(arch_name, 2, stream_inputs=stream)
        arch = model.arch
        shape = ShapeConfig("p", SEQ, 8, "prefill")
        prefill = steps.build_prefill_step(model, pcfg, "cpu", shape)
        cache = model.init_cache(ShapeConfig("d", SEQ + 4, 8, "decode"), M,
                                 filled=False)
        rng = np.random.default_rng(3)
        b = _batch(rng, 8, SEQ, arch.d_model, arch.vocab)
        b = ({"frames": b["frames"], "dec_tokens": b["dec_tokens"]}
             if arch.is_encdec else {"tokens": b["dec_tokens"]})
        out.append(prefill(params, cache, tree_map(torch.from_numpy, b)))
    assert torch.equal(out[0][0], out[1][0])
    for (path, a), (_, b) in zip(tree_items(out[0][1]),
                                 tree_items(out[1][1])):
        assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# (c) lossy wires in the fused executor
# ---------------------------------------------------------------------------

FUSED_WIRES = [("smollm-360m", "int8-ef"), ("smollm-360m", "bf16"),
               ("whisper-tiny", "int8-ef"), ("whisper-tiny", MIXED),
               ("whisper-tiny", "bf16")]


@pytest.mark.parametrize("arch_name, wire", FUSED_WIRES)
def test_lossy_wire_fused_vs_oracle(arch_name, wire):
    """1f1b at pipe 2 (smollm: the chain and cotangent classes; whisper:
    its ``mem`` portal too) against the unwired oracle at the reference's
    stated int8-ef tolerances; the codec changes the result."""
    run = _run(arch_name, 2, "1f1b", wire=wire)
    ref = _ref(arch_name)
    _assert_vs_oracle(run, arch_name, ref["loss"], ref["grads"],
                      loss_rtol=WIRE_LOSS_RTOL, **WIRE_GRAD_TOL)
    if arch_name == "whisper-tiny":
        assert [rt.key for rt in run["tplan"].routes] == ["mem@1"]
    base = _run(arch_name, 2, "1f1b")
    assert any(not torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_items(run["grads"]), tree_items(base["grads"])))


def _curve(arch_name, wire, n_steps=5):
    model, pcfg, params, batch = _port(arch_name, 2, schedule="1f1b",
                                       wire=wire)
    ocfg = optim.OptimizerConfig(**OCFG)
    step = steps.build_train_step(model, pcfg, "cpu",
                                  ShapeConfig("t", SEQ, BATCH, "train"), ocfg)
    opt = optim.init(ocfg, params)
    losses = []
    for _ in range(n_steps):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    return losses


@pytest.mark.parametrize("arch_name, wire", [
    ("smollm-360m", "int8-ef"), ("whisper-tiny", "int8-ef"),
    ("whisper-tiny", MIXED)])
def test_lossy_wire_curve_tracks_fp32(arch_name, wire):
    """The reference's rule: a 5-step curve within 5% of fp32's at every
    step, and falling."""
    base, lossy = _curve(arch_name, "fp32"), _curve(arch_name, wire)
    np.testing.assert_allclose(lossy, base, rtol=CURVE_RTOL)
    assert lossy[-1] < lossy[0]


@pytest.mark.parametrize("name", ["gpipe", "1f1b"])
@pytest.mark.parametrize("arch_name", ARCHS)
def test_bf16_wire_is_exact_on_a_bf16_model(arch_name, name):
    """On a bf16 model every payload is bf16 already: the bf16 wire's loss
    and grads equal the fp32 wire's bit for bit."""
    a = _run(arch_name, 2, name, dtype=torch.bfloat16)
    b = _run(arch_name, 2, name, dtype=torch.bfloat16, wire="bf16")
    _assert_bitwise(b, a, f"{arch_name} {name}")


# ---------------------------------------------------------------------------
# (d) the forward executor
# ---------------------------------------------------------------------------

def _rel_l2(got, want):
    """||got - want|| / ||want|| over every leaf of two grad trees."""
    want_items = dict(tree_items(want))
    num = sum(float(((g - want_items[p]) ** 2).sum())
              for p, g in tree_items(got))
    return (num / sum(float((w ** 2).sum()) for w in want_items.values())
            ) ** 0.5


@pytest.mark.parametrize("arch_name", ARCHS)
def test_gpipe_bf16_wire_vs_oracle_with_the_casts(arch_name):
    """gpipe at pipe 2, bf16 wire, autograd through the casts, against the
    JAX oracle with the same cast on the carry and on whisper's ``mem``
    where they leave stage 0, differentiated by ``jax.grad`` (the
    reference's semantics of this wire: the cotangent is cast too).  The
    loss is within TOL of it and every gradient within the reference's
    lossy-wire tolerance of the unwired oracle.  Elementwise TOL against
    the cast oracle does not hold everywhere: an fp32 ulp between the two
    sides can round a value across a bf16 boundary.  So the gradients are
    held in norm: their gap to the cast oracle is below a quarter of
    bf16's rounding unit (2^-11 relative), while the unwired oracle, which
    the casts move by about that unit, sits beyond it."""
    run = _run(arch_name, 2, "gpipe", wire="bf16")
    ref = _ref(arch_name)
    np.testing.assert_allclose(float(run["loss"]), ref["bf16_loss"],
                               rtol=TOL["rtol"])
    _assert_vs_oracle(run, arch_name, ref["loss"], ref["grads"],
                      loss_rtol=WIRE_LOSS_RTOL, **WIRE_GRAD_TOL)
    arch, pcfg = run["model"].arch, run["pcfg"]
    cast, plain = (params_from_jax(ref[k], arch=arch, src_pipe=2, pcfg=pcfg,
                                   device="cpu")
                   for k in ("bf16_grads", "grads"))
    assert _rel_l2(run["grads"], cast) < 2.0 ** -11 < _rel_l2(run["grads"],
                                                              plain)


@pytest.mark.parametrize("arch_name, wire", [
    ("smollm-360m", "int8-ef"), ("whisper-tiny", "int8-ef"),
    ("whisper-tiny", MIXED)])
def test_gpipe_int8_wire_under_autograd_raises(arch_name, wire):
    """An int8-ef hop the forward executor encodes (the chain; whisper's
    ``mem`` portal under MIXED) refuses autograd, at build time in the
    train step and at the call of ``pipeline_call`` under grad."""
    model, pcfg, params, batch = _port(arch_name, 2, schedule="gpipe",
                                       wire=wire)
    with pytest.raises(ValueError, match="truncated gradient"):
        steps.build_grad_fn(model, pcfg, "cpu")
    loss_fn = steps.build_loss_fn(model, pcfg, "cpu")
    with pytest.raises(ValueError, match="fused schedule"):
        loss_fn(params, batch)


def test_gpipe_ignores_the_cotangent_class():
    """The forward executor encodes no cotangent (autograd transposes the
    forward hops, as in the reference): an int8-ef cotangent class trains
    gpipe bitwise like fp32."""
    a = _run("whisper-tiny", 2, "gpipe")
    b = _run("whisper-tiny", 2, "gpipe",
             wire="chain=fp32,portal=fp32,cotangent=int8-ef")
    _assert_bitwise(b, a, "cotangent class")


@pytest.mark.parametrize("arch_name", ARCHS)
def test_int8_wire_serves(arch_name):
    """int8-ef in serving (no autograd): prefill at pipe 2 runs, its logits
    finite and moved by the codec, within 5% of the fp32 wire's."""
    out = []
    for wire in ("fp32", "int8-ef"):
        model, pcfg, params, _ = _port(arch_name, 2, wire=wire)
        prefill = steps.build_prefill_step(model, pcfg, "cpu",
                                           ShapeConfig("p", SEQ, 8,
                                                       "prefill"))
        cache = model.init_cache(ShapeConfig("d", SEQ + 4, 8, "decode"), M,
                                 filled=False)
        b = _batch(np.random.default_rng(3), 8, SEQ, model.arch.d_model,
                   model.arch.vocab)
        b = ({"frames": b["frames"], "dec_tokens": b["dec_tokens"]}
             if model.arch.is_encdec else {"tokens": b["dec_tokens"]})
        out.append(prefill(params, cache, tree_map(torch.from_numpy, b))[0])
    assert torch.isfinite(out[1]).all() and not torch.equal(out[0], out[1])
    scale = float(out[0].abs().max())
    assert float((out[1] - out[0]).abs().max()) < CURVE_RTOL * scale


# ---------------------------------------------------------------------------
# (e) int8 error-feedback gradient compression
# ---------------------------------------------------------------------------

def _compression_setup():
    model, pcfg, params, batch = _port("smollm-360m", 2, schedule="1f1b",
                                       grad_compression="int8_ef")
    ocfg = optim.OptimizerConfig(**OCFG)
    step = steps.build_train_step(model, pcfg, "cpu",
                                  ShapeConfig("t", SEQ, BATCH, "train"), ocfg)
    return model, pcfg, params, batch, ocfg, step


def test_grad_compression_matches_reference():
    """Two train steps: each step's new residual equals the reference's
    ``_maybe_compress_grads`` on the same grads and residual bit for bit,
    and the params equal the port's optimizer applied to the reference's
    compressed grads."""
    model, pcfg, params, batch, ocfg, step = _compression_setup()
    grad_fn = steps.build_grad_fn(model, pcfg, "cpu")
    opt = optim.init(ocfg, params, with_ef=True)
    jpcfg = JParallel(grad_compression="int8_ef")

    def to_jax(tree):
        return jax.tree.map(jnp.asarray, tree_map(
            lambda a: a.detach().numpy().copy(), tree))

    for k in range(2):
        loss, grads = grad_fn(params, batch)
        # eager, as written: under jit XLA rewrites the division by the
        # block scale and moves the last bits of 70% of the residual
        want_g, want_ef = jsteps._maybe_compress_grads(
            jpcfg, to_jax(grads), joptim.OptState(
                step=None, mu=None, nu=None, master=None, ef=to_jax(opt.ef)))
        want_p = tree_map(torch.clone, params)
        optim.apply(ocfg, optim.OptState(*(tree_map(torch.clone, f)
                                           for f in opt)),
                    want_p, tree_map(lambda a: torch.from_numpy(np.array(a)),
                                     jax.device_get(want_g)), loss=loss)
        params, opt, metrics = step(params, opt, batch)
        assert float(metrics["finite"]) == 1.0
        got_ef = dict(tree_items(opt.ef))
        for path, w in tree_items(jax.device_get(want_ef)):
            np.testing.assert_array_equal(got_ef[path].numpy(), np.asarray(w),
                                          err_msg=f"step {k} ef {path}")
        for (path, a), (_, b) in zip(tree_items(params), tree_items(want_p)):
            assert torch.equal(a, b), f"step {k} {path}"


def test_grad_compression_keeps_the_residual_on_a_skipped_step():
    """A NaN in the head poisons every gradient: the guard skips the step
    and the residual keeps the value the last finite step left."""
    _, _, params, batch, ocfg, step = _compression_setup()
    opt = optim.init(ocfg, params, with_ef=True)
    params, opt, metrics = step(params, opt, batch)
    kept = tree_map(torch.clone, opt.ef)
    assert any(float(e.abs().max()) > 0 for e in tree_leaves(kept))
    params["head"]["norm"]["scale"][0] = float("nan")
    params, opt, metrics = step(params, opt, batch)
    assert float(metrics["finite"]) == 0.0 and int(opt.skipped) == 1
    for (path, a), (_, b) in zip(tree_items(opt.ef), tree_items(kept)):
        assert torch.equal(a, b), path


def test_grad_compression_needs_the_residual():
    _, _, params, batch, ocfg, step = _compression_setup()
    with pytest.raises(ValueError, match="with_ef=True"):
        step(params, optim.init(ocfg, params), batch)
