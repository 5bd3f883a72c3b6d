"""The dense-block architectures beyond smollm against the JAX package, on
the CPU: deepseek-7b (MHA), llama3-405b (GQA, rope_theta 500,000),
gemma-2b (GeGLU, the embedding scale, MQA at head_dim 256) and pixtral-12b
(the vision stub: patch embeddings in place of the first token rows).

Each arch at ``configs.smoke_arch`` (4 layers, d 64, head_dim 16) with the
JAX ``model.init(PRNGKey(0))`` weights moved across as numpy: the port's
training loss and every gradient leaf at pipe 2 (gpipe and 1f1b) against
``jax.value_and_grad`` of the sequential oracle (``tests/test_oracle.py``'s
``oracle_loss_fn`` for an LM without skips, as ``tests/test_torch_train.py``
mirrors it) within that file's fp32 ``TOL``; the prefill logits, every cache
leaf and three greedy decode steps against the JAX ``build_prefill_step`` /
``build_serve_step`` at pipe 1.  pixtral's batches carry 4 patch rows at
S 16, so both the patch prefix and the token rows are held.  Beside them:
gemma's bf16 embedding scale bitwise the reference's, the four parameter
trees at full width (on the meta device) against ``jax.eval_shape``,
and the model-FLOPs count of GeGLU.
Each arch's JAX runs are made once, in the module fixture.
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
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models.lm import LMModel as JLMModel

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import stage as stage_lib
from repro_torch.interop import params_from_jax, to_tensor
from repro_torch.launch import steps
from repro_torch.launch.train import model_flops_per_step
from repro_torch.models.lm import LMModel
from repro_torch.tree import tree_items

from test_torch_train import _assert_tree_close, _oracle_loss_fn

# tests/test_oracle.py's fp32 TOL: same math, different graphs and sum order
TOL = dict(rtol=5e-4, atol=5e-5)
ARCHS = ("deepseek-7b", "llama3-405b", "gemma-2b", "pixtral-12b")
BATCH, SEQ, M = 8, 16, 4             # training: pipe 2, m 4
SERVE_BATCH, STEPS, JAX_MICRO = 4, 3, 2
DECODE_LEN = SEQ + STEPS + 1
PATCHES = 4                          # pixtral's patch rows of the 16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(arch, rng, batch):
    """Tokens and labels [batch, SEQ] (int32), and a vision stub's patches
    [batch, PATCHES, d] (N(0, 1) x 0.1, fp32)."""
    out = {k: rng.integers(0, arch.vocab, (batch, SEQ)).astype(np.int32)
           for k in ("tokens", "labels")}
    if arch.frontend == "vision_stub":
        out["patches"] = (rng.standard_normal((batch, PATCHES, arch.d_model))
                          * 0.1).astype(np.float32)
    return out


def _jax_train(name, m=M):
    """The oracle's loss and grads at pipe 1 (m micro-batches) on one
    seeded batch."""
    arch = jconfigs.smoke_arch(name)
    pcfg = jconfigs.smoke_parallel(name).with_(n_micro=m)
    model = JLMModel(arch, pcfg, dtype=jnp.float32)
    # jitted: eager jax.random compiles once per leaf shape
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    batch = _batch(arch, np.random.default_rng(0), BATCH)
    loss, grads = jax.jit(jax.value_and_grad(_oracle_loss_fn(model, m)))(
        params, jax.tree.map(jnp.asarray, batch))
    return {"params": jax.device_get(params), "batch": batch,
            "loss": float(loss), "grads": jax.device_get(grads)}


def _jax_serve(name, params):
    """JAX prefill + STEPS greedy decode steps at pipe 1 (numpy results)."""
    arch = jconfigs.smoke_arch(name)
    pcfg = jconfigs.smoke_parallel(name).with_(n_micro=JAX_MICRO)
    mesh = jmesh.make_smoke_mesh(pcfg)
    model = JLMModel(arch, pcfg, dtype=jnp.float32)
    batch = _batch(arch, np.random.default_rng(1), SERVE_BATCH)
    del batch["labels"]
    with set_mesh(mesh):
        prefill = jax.jit(jsteps.build_prefill_step(
            model, pcfg, mesh, JShape("p", SEQ, SERVE_BATCH, "prefill")))
        decode = jax.jit(jsteps.build_serve_step(
            model, pcfg, mesh, JShape("d", DECODE_LEN, SERVE_BATCH,
                                      "decode")))
        cache = model.init_cache(JShape("d", DECODE_LEN, SERVE_BATCH,
                                        "decode"), JAX_MICRO, filled=False)
        logits, cache = prefill(params, cache,
                                jax.tree.map(jnp.asarray, batch))
        out = {"batch": batch, "prefill": np.asarray(logits),
               "cache": jax.device_get(cache), "tokens": [], "decode": []}
        for _ in range(STEPS):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            out["tokens"].append(np.asarray(tok))
            logits, cache = decode(params, cache, tok)
            out["decode"].append(np.asarray(logits))
        out["cache_end"] = jax.device_get(cache)
    return out


class _JaxRuns:
    """Each arch's JAX runs, made at first use and kept for the module;
    training at ``m`` micro-batches."""

    def __init__(self, m=M):
        self.m = m
        self._train, self._serve = {}, {}

    def train(self, name):
        if name not in self._train:
            self._train[name] = _jax_train(name, self.m)
        return self._train[name]

    def serve(self, name):
        if name not in self._serve:
            self._serve[name] = _jax_serve(name, self.train(name)["params"])
        return self._serve[name]


@pytest.fixture(scope="module")
def jax_runs():
    return _JaxRuns()


def _port(name, ref, pipe, **pcfg_kw):
    arch = configs.smoke_arch(name)
    pcfg = configs.smoke_parallel(name).with_(pipe=pipe, **pcfg_kw)
    model = LMModel(arch, pcfg, dtype=torch.float32, device="cpu")
    params = params_from_jax(ref["params"], arch=arch, src_pipe=1, pcfg=pcfg,
                             device="cpu")
    return model, pcfg, params


# ---------------------------------------------------------------------------
# training: loss and every gradient leaf vs the sequential oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("name", ARCHS)
def test_train_loss_and_grads_match_jax_oracle(jax_runs, name, schedule):
    ref = jax_runs.train(name)
    model, pcfg, params = _port(name, ref, 2, n_micro=M, schedule=schedule)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    loss, grads = steps.build_grad_fn(model, pcfg, "cpu")(params, batch)
    np.testing.assert_allclose(float(loss), ref["loss"], **TOL)
    want = params_from_jax(ref["grads"], arch=model.arch, src_pipe=1,
                           pcfg=pcfg, device="cpu")
    _assert_tree_close(grads, want, f"{name} {schedule}")


# ---------------------------------------------------------------------------
# serving: prefill logits, caches, three greedy decode steps
# ---------------------------------------------------------------------------

def _canon_cache(cache, layout):
    """[n_stages, L, m, mb, ...] leaves -> per layer [layers, B, ...]
    (``len``: [layers])."""
    out = {}
    for path, leaf in tree_items(cache):
        t = leaf if torch.is_tensor(leaf) else to_tensor(leaf)
        per_layer = stage_lib.unstack_layers(t, layout)
        if path.endswith("len"):
            assert bool((per_layer == per_layer[:, :1]).all()), path
            out[path] = per_layer[:, 0].numpy()
        else:
            out[path] = per_layer.reshape(
                (per_layer.shape[0], -1) + tuple(per_layer.shape[3:])).numpy()
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_serve_matches_jax(jax_runs, name):
    """The port at pipe 2 (m 2) against the JAX serve at pipe 1."""
    ref = jax_runs.serve(name)
    model, pcfg, params = _port(name, jax_runs.train(name), 2, n_micro=2)
    prefill = steps.build_prefill_step(
        model, pcfg, "cpu", ShapeConfig("p", SEQ, SERVE_BATCH, "prefill"))
    dshape = ShapeConfig("d", DECODE_LEN, SERVE_BATCH, "decode")
    decode = steps.build_serve_step(model, pcfg, "cpu", dshape)
    cache = model.init_cache(dshape, 2, filled=False)
    logits, cache = prefill(params, cache, {k: torch.from_numpy(v)
                                            for k, v in ref["batch"].items()})
    np.testing.assert_allclose(logits.numpy(), ref["prefill"], **TOL,
                               err_msg="prefill logits")
    jax_layout = stage_lib.partition_layout(model.arch.n_layers, 1)
    got = {"cache": _canon_cache(cache, model.layout)}
    for i, tok in enumerate(ref["tokens"]):
        logits, cache = decode(params, cache, torch.tensor(tok))
        np.testing.assert_allclose(logits.numpy(), ref["decode"][i], **TOL,
                                   err_msg=f"decode step {i}")
    got["cache_end"] = _canon_cache(cache, model.layout)
    for tag in ("cache", "cache_end"):
        want = _canon_cache(ref[tag], jax_layout)
        assert want.keys() == got[tag].keys()
        for path, w in want.items():
            np.testing.assert_allclose(got[tag][path], w, **TOL,
                                       err_msg=f"{tag} {path}")


def test_serve_launch_formula_counts_identity_padding(monkeypatch):
    """deepseek-7b's 30 layers fill 32 slots at pipe 16, and every slot runs
    its layer: here its smoke arch's 4 layers at pipe 3 (two slots a stage,
    two of them padding).  The attention and RMSNorm calls of a prefill and
    of the decode steps equal ``expected_serve_launches``, which counts
    the 6 slots."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch.serve import expected_serve_launches
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
    arch, m, gen = configs.smoke_arch("deepseek-7b"), 2, 3
    pcfg = configs.smoke_parallel("deepseek-7b").with_(pipe=3, n_micro=m)
    model = LMModel(arch, pcfg, dtype=torch.float32, device="cpu")
    assert model.layer_mask.size == 6 and model.layer_mask.sum() == 4
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
    assert want["prefill"]["flash_attention"] == 6 * m
    assert calls == {k: want["prefill"][k] for k in calls}
    for _ in range(gen - 1):
        logits, cache = decode(params, cache, torch.argmax(logits, -1))
    assert calls == {k: want["prefill"][k] + want["decode"][k]
                     for k in calls}


# ---------------------------------------------------------------------------
# gemma's embedding scale, the full-width trees, GeGLU's FLOPs
# ---------------------------------------------------------------------------

def test_gemma_embedding_scale_is_bitwise_the_reference_in_bf16():
    """At gemma's width, d 2048: sqrt(2048) is a bf16 scalar (45.25), so the
    scaled prompt and decode embeddings are bitwise the reference's.  The
    port's ``embed_scale`` is set on exactly the archs whose name the
    reference keys the scale on."""
    for name in configs.ARCH_NAMES:
        assert configs.get_arch(name).embed_scale == \
            jconfigs.get_arch(name).name.startswith("gemma"), name
        assert configs.smoke_arch(name).embed_scale == \
            configs.get_arch(name).embed_scale, name
    jarch = dataclasses.replace(jconfigs.smoke_arch("gemma-2b"), d_model=2048)
    arch = dataclasses.replace(configs.smoke_arch("gemma-2b"), d_model=2048)
    rng = np.random.default_rng(2)
    table = (rng.standard_normal((arch.vocab, arch.d_model)) * 0.5).astype(
        np.float32)
    tokens = rng.integers(0, arch.vocab, (2, SEQ)).astype(np.int32)
    jmodel = JLMModel(jarch, jconfigs.smoke_parallel("gemma-2b"),
                      dtype=jnp.bfloat16)
    model = LMModel(arch, configs.smoke_parallel("gemma-2b"),
                    dtype=torch.bfloat16, device="cpu")
    jemb = {"tok": jnp.asarray(table).astype(jnp.bfloat16)}
    emb = {"tok": torch.from_numpy(table).to(torch.bfloat16)}
    got = model.embed_inputs(emb, {"tokens": torch.from_numpy(tokens)})["h"]
    want = jmodel.embed_inputs(jemb, {"tokens": jnp.asarray(tokens)})["h"]
    got_d = model.embed_decode(emb, torch.from_numpy(tokens[:, :1]), SEQ)
    want_d = jmodel.embed_decode(jemb, jnp.asarray(tokens[:, :1]), SEQ)
    for g, w in ((got, want), (got_d, want_d)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      to_tensor(jax.device_get(w))
                                      .view(torch.int16).numpy())
    rows = emb["tok"][torch.from_numpy(tokens).long()]
    assert torch.equal(got, rows * torch.tensor(45.25, dtype=torch.bfloat16))


def _jax_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jax_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype))
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_param_tree_matches_jax_eval_shape(name):
    """The whole model at full width and depth, on the meta device, under
    the config's pipe: every leaf's path, shape and dtype as ``jax.eval_shape``
    of the reference's ``init`` gives them (bf16)."""
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


def test_model_flops_count_geglu_as_three_matrices():
    """GeGLU has SwiGLU's three MLP matrices: gemma-2b's count is the one of
    the same arch with SiLU, and above GELU's two by 3 x 2 x d x d_ff a
    token and layer."""
    arch = configs.get_arch("gemma-2b")
    seq, batch = 4096, 16
    flops = model_flops_per_step(arch, seq, batch)
    silu = dataclasses.replace(arch, act="silu")
    gelu = dataclasses.replace(arch, act="gelu")
    assert flops == model_flops_per_step(silu, seq, batch)
    assert flops - model_flops_per_step(gelu, seq, batch) == \
        3.0 * 2.0 * arch.n_layers * arch.d_model * arch.d_ff * seq * batch
    assert 1.0e15 < flops < 1.1e15        # ~1.05 PFLOP a step
