"""The port's training slice against the JAX package, on the CPU.

Same weights (the JAX ``model.init(PRNGKey(0))`` moved across as numpy with
``interop.params_from_jax``) and the same batches (seeded numpy): the
port's GPipe train loss and every gradient leaf must equal
``jax.value_and_grad`` of a sequential single-device oracle (the stage chain
per micro-batch, mirroring ``oracle_loss_fn`` of ``tests/test_oracle.py``)
within that file's fp32 ``TOL``, at pipe 1, 2 and 4 with m = 4; so must a
5-step loss curve of ``build_train_step`` against the oracle plus the JAX
``optim.apply``.  Beside them: the attention and RMSNorm backwards (plain
versions and the autograd Functions' CPU path) against ``jax.vjp`` of the
JAX plain references, the optimizer against the JAX optimizer, the data
stream bit for bit, remat policies, and the features that still raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.pipeline import TickCtx as JTickCtx
from repro.data import pipeline as jdata
from repro.kernels import ref as jref
from repro.models.lm import LMModel as JLMModel
from repro.optim import optimizers as joptim

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import checkpointing
from repro_torch.data import pipeline as data
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.launch import steps
from repro_torch.models.lm import LMModel, head_loss_chunk
from repro_torch.optim import optimizers as optim
from repro_torch.tree import tree_items, tree_map

# tests/test_oracle.py's fp32 TOL: same math, different graphs and sum order
TOL = dict(rtol=5e-4, atol=5e-5)
ARCH = "smollm-360m"
BATCH, SEQ, M = 8, 16, 4
CURVE_STEPS = 5
OCFG = dict(lr=2e-3, warmup_steps=2, total_steps=20)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_tree_close(got, want, tag, **tol):
    want_items = dict(tree_items(want))
    got_items = dict(tree_items(got))
    assert got_items.keys() == want_items.keys(), tag
    for path, w in want_items.items():
        np.testing.assert_allclose(got_items[path].detach().float().numpy(),
                                   w.detach().float().numpy(),
                                   **(tol or TOL), err_msg=f"{tag} {path}")


# ---------------------------------------------------------------------------
# (a) attention backward, (b) RMSNorm backward
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, S, D, causal, window): GQA 3:1 causal, a sliding window over
# GQA 2:1, full attention; block_k 16 so the blocked loops take several blocks
ATTN_CASES = [(2, 3, 1, 40, 16, True, 0), (1, 4, 2, 48, 16, True, 12),
              (1, 2, 2, 24, 16, False, 0)]


@pytest.mark.parametrize("case", ATTN_CASES, ids=["gqa3-causal", "window",
                                                  "full"])
def test_attention_backward_vs_jax_vjp(case):
    B, hq, hkv, S, D, causal, window = case
    rng = np.random.default_rng(0)
    qn = rng.normal(size=(B, hq, S, D)).astype(np.float32)
    kn, vn = (rng.normal(size=(B, hkv, S, D)).astype(np.float32)
              for _ in range(2))
    don = rng.normal(size=qn.shape).astype(np.float32)
    kw = dict(causal=causal, window=window)

    out_j, vjp = jax.vjp(lambda a, b, c: jref.mha_blocked(
        a, b, c, block_k=16, **kw), qn, kn, vn)
    want = [np.asarray(g) for g in vjp(don)]
    _, lse_j = jref._mha_blocked_fwd_pass(
        qn, jref._expand_kv(kn, hq), jref._expand_kv(vn, hq), causal=causal,
        window=window or None, q_offset=0, scale=D ** -0.5, block_k=16,
        kv_len=None)

    q, k, v, do = (_t(a) for a in (qn, kn, vn, don))
    out, lse = ref.mha_blocked_fwd(q, k, v, block_k=16, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)
    plain = ref.mha_blocked_bwd(q, k, v, out, lse, do, block_k=16, **kw)
    for g, w, name in zip(plain, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"d{name}")

    # the autograd Function's CPU path: same forward, plain backward
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    y = flash_attention(qr, kr, vr, **kw)
    assert y.grad_fn is not None
    grads = torch.autograd.grad(y, (qr, kr, vr), do)
    for g, w, name in zip(grads, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("shape", [(3, 5, 64), (16, 960)])
def test_rmsnorm_backward_vs_jax_grad(shape):
    rng = np.random.default_rng(1)
    xn = rng.normal(size=shape).astype(np.float32) * 2
    sn = rng.normal(size=shape[-1:]).astype(np.float32) + 1
    dyn = rng.normal(size=shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm(a, b), xn, sn)
    want = [np.asarray(g) for g in vjp(dyn)]
    x, s, dy = _t(xn), _t(sn), _t(dyn)
    for g, w in zip(ref.rmsnorm_bwd(x, s, dy), want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    xr, sr = x.clone().requires_grad_(), s.clone().requires_grad_()
    y = rmsnorm(xr, sr)                   # the Function's CPU path
    assert y.grad_fn is not None
    for g, w in zip(torch.autograd.grad(y, (xr, sr), dy), want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


# ---------------------------------------------------------------------------
# (c) optimizer, (d) data
# ---------------------------------------------------------------------------

OPT_CASES = {
    "adamw-clip": dict(name="adamw", clip_norm=1.0),
    "adamw-noclip": dict(name="adamw", clip_norm=0.0),
    "sgd-clip": dict(name="sgd", clip_norm=0.5),
    "adamw-loss-scale": dict(name="adamw", clip_norm=1.0,
                             dynamic_loss_scale=True, loss_scale_growth=2),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_jax(case):
    """Four steps, the third with a NaN grad: both sides skip it; the port
    leaves params and every moment bitwise unchanged and counts it."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, **OPT_CASES[case])
    jcfg, cfg = joptim.OptimizerConfig(**kw), optim.OptimizerConfig(**kw)
    rng = np.random.default_rng(2)
    params_n = {"a": {"w": rng.normal(size=(4, 3)).astype(np.float32)},
                "b": rng.normal(size=(5,)).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, params_n)
    jstate = joptim.init(jcfg, jp)
    tp = tree_map(_t, params_n)
    tstate = optim.init(cfg, tp)
    for i in range(4):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32)
                         * 3, params_n)
        if i == 2:
            g["b"][1] = np.nan
        scale = float(tstate.scale)
        g = jax.tree.map(lambda a: a * np.float32(scale), g)
        loss = np.float32(1.5 * scale)
        jp, jstate, jm = joptim.apply(jcfg, jstate, jp, g, loss=loss)
        before = [tree_map(torch.clone, t)
                  for t in (tp, tstate.mu, tstate.nu, tstate.master)]
        tp, tstate, tm = optim.apply(cfg, tstate, tp, tree_map(_t, g),
                                     loss=torch.tensor(loss))
        if i == 2:
            assert int(tstate.skipped) == 1 and float(tm["finite"]) == 0.0
            for a, b in zip(before, (tp, tstate.mu, tstate.nu,
                                     tstate.master)):
                for (path, x), (_, y) in zip(tree_items(a), tree_items(b)):
                    assert torch.equal(x, y), (case, path)
        want = {"params": jp, "mu": jstate.mu, "nu": jstate.nu,
                "master": jstate.master}
        got = {"params": tp, "mu": tstate.mu, "nu": tstate.nu,
               "master": tstate.master}
        _assert_tree_close(got, tree_map(lambda a: _t(np.array(a)), want),
                           f"{case} step {i}")
        for k in ("grad_norm", "lr", "skipped", "loss_scale"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL,
                                       err_msg=f"{case} step {i} {k}")
        for k in ("step", "skipped", "good", "scale"):
            assert float(getattr(tstate, k)) == float(getattr(jstate, k)), k


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_global_norm_and_clip_match_jax(max_norm):
    rng = np.random.default_rng(4)
    tree = {"a": {"w": rng.normal(size=(4, 3)).astype(np.float32)},
            "b": rng.normal(size=(5,)).astype(np.float32)}
    jclipped, jgn = joptim.clip_by_global_norm(
        jax.tree.map(jnp.asarray, tree), max_norm)
    clipped, gn = optim.clip_by_global_norm(tree_map(_t, tree), max_norm)
    np.testing.assert_allclose(float(gn), float(jgn), **TOL)
    np.testing.assert_allclose(float(optim.global_norm(tree_map(_t, tree))),
                               float(jgn), **TOL)
    _assert_tree_close(clipped, tree_map(lambda a: _t(np.array(a)),
                                         jclipped), f"clip {max_norm}")


@pytest.mark.parametrize("cfg_kw, arch", [
    (dict(seed=3, vocab=256, seq_len=16, global_batch=4), None),
    (dict(seed=0, vocab=49152, seq_len=128, global_batch=2, doc_len=64),
     None),
    (dict(seed=1, vocab=256, seq_len=8, global_batch=2), "whisper-tiny"),
])
def test_synthetic_batches_equal_reference_bitwise(cfg_kw, arch):
    ds = data.SyntheticLM(data.DataConfig(**cfg_kw),
                          configs.smoke_arch(arch) if arch else None)
    jds = jdata.SyntheticLM(jdata.DataConfig(**cfg_kw),
                            jconfigs.smoke_arch(arch) if arch else None)
    for step in (0, 7):
        got, want = ds.batch_at(step), jds.batch_at(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# (e) loss and grads vs the sequential oracle, (f) the 5-step curve
# ---------------------------------------------------------------------------

def _oracle_loss_fn(model, m):
    """Sequential single-device reference (``tests/test_oracle.py``'s
    ``oracle_loss_fn`` for an LM without skips): the stage chain per
    micro-batch, mean of the per-micro losses."""
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
            for s in range(model.n_stages):
                ctx = JTickCtx(stage=jnp.int32(s), micro=jnp.int32(i),
                               valid=jnp.asarray(True), t=jnp.int32(0),
                               fresh=fresh_i, n_stages=model.n_stages,
                               n_micro=m)
                p_s = jax.tree.map(lambda a: a[s], params["stages"])
                carry, _, _ = stage_apply(p_s, carry, {}, {}, ctx)
            total = total + model.head_loss(
                hp, carry["h"], labels_mb[i]).astype(jnp.float32)
        return total / m
    return loss_fn


@pytest.fixture(scope="module")
def jax_ref():
    """JAX at pipe 1: oracle loss and grads, and a 5-step curve with the JAX
    optimizer, on one seeded batch."""
    arch = jconfigs.smoke_arch(ARCH)
    pcfg = jconfigs.smoke_parallel(ARCH).with_(n_micro=M)
    model = JLMModel(arch, pcfg, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, arch.vocab, (BATCH, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")}
    jbatch = jax.tree.map(jnp.asarray, batch)
    loss_fn = _oracle_loss_fn(model, M)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, jbatch)
    ocfg = joptim.OptimizerConfig(**OCFG)

    @jax.jit
    def step(p, o, b):
        l, g = jax.value_and_grad(loss_fn)(p, b)
        p2, o2, _ = joptim.apply(ocfg, o, p, g)
        return p2, o2, l

    p, o, curve = params, joptim.init(ocfg, params), []
    for _ in range(CURVE_STEPS):
        p, o, l = step(p, o, jbatch)
        curve.append(float(l))
    return {"params": jax.device_get(params), "batch": batch,
            "loss": float(loss), "grads": jax.device_get(grads),
            "curve": curve}


def _port(ref_, pipe, m=M, **pcfg_kw):
    arch = configs.smoke_arch(ARCH)
    pcfg = configs.smoke_parallel(ARCH).with_(pipe=pipe, n_micro=m,
                                              **pcfg_kw)
    model = LMModel(arch, pcfg, dtype=torch.float32, device="cpu")
    params = params_from_jax(ref_["params"], arch=arch, src_pipe=1,
                             pcfg=pcfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref_["batch"].items()}
    return model, pcfg, params, batch


def _loss_and_grads(model, pcfg, params, batch):
    leaves = [p for _, p in tree_items(params)]
    for p in leaves:
        p.requires_grad_()
    loss = steps.build_loss_fn(model, pcfg, "cpu")(params, batch)
    flat = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(flat), params)


@pytest.mark.parametrize("pipe,m", [(1, 4), (2, 4), (4, 4)])
def test_gpipe_loss_and_grads_match_jax_oracle(jax_ref, pipe, m):
    model, pcfg, params, batch = _port(jax_ref, pipe, m)
    loss, grads = _loss_and_grads(model, pcfg, params, batch)
    np.testing.assert_allclose(float(loss), jax_ref["loss"], **TOL)
    want = params_from_jax(jax_ref["grads"], arch=model.arch, src_pipe=1,
                           pcfg=pcfg, device="cpu")
    _assert_tree_close(grads, want, f"pipe {pipe} m {m}")


def test_gpipe_train_curve_matches_jax_oracle(jax_ref):
    model, pcfg, params, batch = _port(jax_ref, 2)
    ocfg = optim.OptimizerConfig(**OCFG)
    step = steps.build_train_step(model, pcfg, "cpu",
                                  ShapeConfig("t", SEQ, BATCH, "train"), ocfg)
    opt = optim.init(ocfg, params)
    curve = []
    for _ in range(CURVE_STEPS):
        params, opt, metrics = step(params, opt, batch)
        curve.append(float(metrics["loss"]))
    np.testing.assert_allclose(curve, jax_ref["curve"], **TOL)
    assert curve[-1] < curve[0]


# ---------------------------------------------------------------------------
# (g) remat policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat, remat_layers", [("none", False),
                                                 ("full", True)])
def test_remat_policies_give_equal_grads(jax_ref, remat, remat_layers):
    """Recompute replays the same ops on the same inputs: the grads equal
    those of the default ``remat="full"`` bit for bit."""
    base = _loss_and_grads(*_port(jax_ref, 2))
    other = _loss_and_grads(*_port(jax_ref, 2, remat=remat,
                                   remat_layers=remat_layers))
    assert torch.equal(base[0], other[0])
    for (path, a), (_, b) in zip(tree_items(base[1]), tree_items(other[1])):
        assert torch.equal(a, b), path


def test_wrap_stage_for_micro_elides_the_last_recompute():
    def f(x):
        return x
    wrap = checkpointing.wrap_stage_for_micro
    assert wrap(f, "full", micro=3, n_micro=4, remat_last_micro=False) is f
    assert wrap(f, "none", micro=0, n_micro=4, remat_last_micro=True) is f
    for micro, forced in ((0, False), (3, True)):
        g = wrap(f, "full", micro=micro, n_micro=4, remat_last_micro=forced)
        assert g is not f
        x = torch.ones(2, requires_grad=True)
        assert torch.equal(g(x), x)


# ---------------------------------------------------------------------------
# launches per step (the formulas chip_smoke.py holds the card to)
# ---------------------------------------------------------------------------

COUNT_M, COUNT_SEQ = 2, 1024      # seq 1024: two head-loss chunks


def _count_train_calls(monkeypatch, **pcfg_kw):
    """Run one train step (m = COUNT_M, seq COUNT_SEQ) on the CPU path with
    every kernel's plain version wrapped by its CUDA contract check and a
    call counter; returns the counts, the step's metrics and the layers."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import rmsnorm as rn_mod

    calls = dict.fromkeys(("attn", "attn_bwd", "norm", "norm_bwd"), 0)

    def counted(name, check, plain):
        def fn(*args, **kw):
            check(*args, **kw)
            calls[name] += 1
            return plain(*args, **kw)
        return fn

    def attn_bwd_check(q, k, v, out, lse, dout, q_offset=0, **_):
        fa_mod.check_bwd_inputs(q, k, v, out, lse, dout, q_offset)

    def norm_bwd_check(x, scale, dy, eps=1e-6):
        rn_mod.check_inputs(x, scale)
        assert dy.shape == x.shape and dy.is_contiguous()

    for mod, name, key, check in (
            (fa_mod, "flash_attention_plain", "attn",
             lambda q, k, v, **_: fa_mod.check_inputs(q, k, v)),
            (fa_mod, "flash_attention_bwd_plain", "attn_bwd", attn_bwd_check),
            (rn_mod, "rmsnorm_plain", "norm",
             lambda x, s, eps=1e-6: rn_mod.check_inputs(x, s)),
            (rn_mod, "rmsnorm_bwd_plain", "norm_bwd", norm_bwd_check)):
        monkeypatch.setattr(mod, name, counted(key, check,
                                               getattr(mod, name)))
    arch = configs.smoke_arch(ARCH)
    arch = dataclasses.replace(arch, attn=dataclasses.replace(
        arch.attn, head_dim=64))
    m, seq = COUNT_M, COUNT_SEQ
    pcfg = configs.smoke_parallel(ARCH).with_(pipe=2, n_micro=m, **pcfg_kw)
    model = LMModel(arch, pcfg, dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    ocfg = optim.OptimizerConfig()
    step = steps.build_train_step(model, pcfg, "cpu",
                                  ShapeConfig("t", seq, 2, "train"), ocfg)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, arch.vocab, (2, seq), generator=g)
             for k in ("tokens", "labels")}
    _, _, metrics = step(params, optim.init(ocfg, params), batch)
    return calls, metrics, arch.n_layers


@pytest.mark.parametrize("remat", ["full", "none"])
def test_train_kernel_contract_and_call_counts_on_cpu(monkeypatch, remat):
    """On the CPU path every call that reaches a kernel's plain version,
    forward or backward, meets the CUDA kernel's contract, and the calls of
    one train step follow chip_smoke.py's formulas: with L layers, m
    micro-batches and nc head-loss chunks, attention L m forwards (2 L m
    with remat "full", which recomputes each stage) and L m backwards;
    RMSNorm 2 L m (or 4 L m) + 2 nc forwards (the head's chunks are always
    recomputed) and 2 L m + nc backwards.  head_dim 64 so the attention
    contract holds; seq 1024 gives nc = 2."""
    calls, metrics, L = _count_train_calls(monkeypatch, remat=remat)
    m, nc = COUNT_M, COUNT_SEQ // head_loss_chunk(COUNT_SEQ)
    assert nc == 2
    recompute = 2 if remat == "full" else 1
    assert calls == {"attn": recompute * L * m, "attn_bwd": L * m,
                     "norm": recompute * 2 * L * m + 2 * nc,
                     "norm_bwd": 2 * L * m + nc}
    assert np.isfinite(float(metrics["loss"]))


def test_remat_except_last_skips_one_recompute_per_stage(monkeypatch):
    """``remat_last_micro=False`` (paper §2.1): each stage's last
    micro-batch runs bare, so the forwards of one step drop by L (one
    micro-batch of every layer) against remat "full" over every
    micro-batch."""
    calls, _, L = _count_train_calls(monkeypatch, remat="full",
                                     remat_last_micro=False)
    m, nc = COUNT_M, COUNT_SEQ // head_loss_chunk(COUNT_SEQ)
    assert calls == {"attn": (2 * m - 1) * L, "attn_bwd": L * m,
                     "norm": (2 * m - 1) * 2 * L + 2 * nc,
                     "norm_bwd": 2 * L * m + nc}


def test_remat_except_last_gives_equal_grads(jax_ref):
    base = _loss_and_grads(*_port(jax_ref, 2))
    other = _loss_and_grads(*_port(jax_ref, 2, remat_last_micro=False))
    assert torch.equal(base[0], other[0])
    for (path, a), (_, b) in zip(tree_items(base[1]), tree_items(other[1])):
        assert torch.equal(a, b), path


def test_train_entry_point_on_cpu():
    from repro_torch.launch.train import train
    res = train(configs.smoke_arch(ARCH),
                configs.smoke_parallel(ARCH).with_(pipe=2, n_micro=2),
                seq_len=16, batch=4, steps=3, device="cpu",
                dtype=torch.float32,
                ocfg=optim.OptimizerConfig(lr=1e-2, warmup_steps=0,
                                           min_lr_ratio=1.0),
                fixed_batch=True)
    losses = [r["loss"] for r in res["history"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert res["tokens_per_step"] == 64 and "peak_mem_bytes" not in res


# ---------------------------------------------------------------------------
# (h) what is not ported raises, naming its ROADMAP item
# ---------------------------------------------------------------------------

def _pipe_call(**kw):
    from repro_torch.core.pipeline import pipeline_call
    pipeline_call(lambda *a: a, cfg=configs.smoke_parallel(ARCH).with_(**kw),
                  devices="cpu")


def _train_step(**kw):
    arch = configs.smoke_arch(ARCH)
    pcfg = configs.smoke_parallel(ARCH).with_(**kw)
    steps.build_train_step(LMModel(arch, pcfg, dtype=torch.float32,
                                   device="cpu"), pcfg, "cpu",
                           ShapeConfig("t", 8, 4, "train"))


def _train_cli(monkeypatch):
    import sys
    from repro_torch.launch import train
    monkeypatch.setattr(sys, "argv", ["train", "--smoke", "--device", "cpu",
                                      "--fail-at", "3"])
    train.main()


def _grad_call():
    from repro_torch.core.pipeline import pipeline_grad_call
    pipeline_grad_call()


UNPORTED = {
    "tp2": (lambda mp: _pipe_call(tp=2), "A9"),
    "data2": (lambda mp: _pipe_call(data=2), "A9"),
    "pod2": (lambda mp: _pipe_call(pod=2), "A9"),
    "1f1b": (lambda mp: _train_step(schedule="1f1b"), "A3"),
    "zb": (lambda mp: _train_step(schedule="zb"), "A3"),
    "int8_ef": (lambda mp: _train_step(grad_compression="int8_ef"), "A7"),
    "dots": (lambda mp: checkpointing.wrap_stage(lambda x: x, "dots"), "A14"),
    "grad_call": (lambda mp: _grad_call(), "A3"),
    "sharded_loader": (lambda mp: data.make_sharded_loader(), "A9"),
    "ef_state": (lambda mp: optim.init(optim.OptimizerConfig(),
                                       {"w": torch.zeros(2)}, with_ef=True),
                 "A7"),
    "elastic_flags": (_train_cli, "A11"),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_features_raise(monkeypatch, case):
    fn, item = UNPORTED[case]
    with pytest.raises(NotImplementedError, match=item):
        fn(monkeypatch)
