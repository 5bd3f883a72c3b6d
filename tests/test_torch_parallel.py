"""Data, FSDP and tensor parallelism (ROADMAP A9a) on the CPU: four gloo
ranks laid out as ``(pod, data, pipe, tp)`` meshes, against the JAX
reference's single-device math.

One spawned world of four (``tests/_torch_parallel_ranks.py``) runs every
case, each on its own mesh of the four ranks, on the JAX reference's
weights (``model.init(PRNGKey(0))`` moved across as numpy, each rank
keeping its blocks) and batches (each replica its rows):

* deepseek-7b smoke (4 MHA heads) at (pipe 2, tp 2), (pipe 2, data 2,
  FSDP) and (tp 2, data 2), gpipe and 1f1b; mixtral-8x7b smoke with its
  experts over tp 2 and data 2 (seq 256: a dispatch group of 512 tokens
  stays inside a replica's rows); whisper-tiny smoke at (pipe 2, tp 2):
  gemma-2b smoke at tp 4 (4 heads over 2 kv heads: ``wk`` / ``wv``
  joined, each rank keeping its kv head) and smollm-360m smoke at (tp 2,
  data 2) (3 heads: the attention whole on every rank), both with the
  head tied to the embedding and the vocab over tp: the mean loss over
  the replicas and each rank's block of every gradient leaf within
  ``TOL`` of the sequential JAX oracle (GSPMD keeps one device's math,
  so that is the reference of every layout);
* deepseek serving at (pipe 2, tp 2): the prefill logits and one decode
  step within ``TOL`` of the JAX serve;
* the small U-Net at data 2 x pipe 2 against the port in one process at
  pipe 2 on the whole batch (which ``tests/test_torch_hetero.py`` holds
  against the JAX oracle);
* bitwise inside the port, one AdamW step at pipe 2 x data 2: FSDP on
  against off, the stage weights joined once a step against at each
  application, the two replicas' weights; gpipe against 1f1b.

Without a spawn: the placement against the reference's ``param_specs``,
``opt_state_specs`` and ``cache_specs`` for all ten archs at full size
(``jax.eval_shape`` on an ``AbstractMesh``) at each config's own tp and
data 2; int8-EF on a shard against the whole leaf; a
MoE dispatch group inside a replica's rows against the whole
micro-batch's.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _torch_parallel_ranks as ranks_lib
from repro import configs as jconfigs
from repro.compat import set_mesh
from repro.configs.base import ShapeConfig as JShape
from repro.launch import mesh as jmesh
from repro.launch import sharding as jsharding
from repro.launch import steps as jsteps
from repro.models.lm import LMModel as JLMModel
from repro.optim import optimizers as joptim
from repro_torch import configs
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.interop import params_from_jax
from repro_torch.launch import mesh, sharding, steps
from repro_torch.launch import train_hetero as TH
from repro_torch.models import layers as L
from repro_torch.models import pipeline_hetero as PH
from repro_torch.models.lm import LMModel
from repro_torch.runtime.compression import EFCompressor
from repro_torch.tree import tree_items

from test_torch_train import _oracle_loss_fn
from test_torch_whisper import _batch as _whisper_batch
from test_torch_whisper import _oracle_loss_fn as _whisper_oracle

# tests/test_oracle.py's fp32 TOL: same math, different graphs and sum order
TOL = dict(rtol=5e-4, atol=5e-5)
SPAWN_S = 120
M = ranks_lib.M
MOE_SEQ = 256
GRAD_CASES = [n for n, c in ranks_lib.cases() if c["kind"] == "grads"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two threads in this process (the ranks keep one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _lm_batch(arch, rng, seq):
    return {k: rng.integers(0, arch.vocab, (8, seq)).astype(np.int32)
            for k in ("tokens", "labels")}


# arch -> (its batch, the oracle's loss fn)
ORACLES = {
    "deepseek-7b": (lambda a: _lm_batch(a, np.random.default_rng(0), 16),
                    _oracle_loss_fn),
    "gemma-2b": (lambda a: _lm_batch(a, np.random.default_rng(0), 16),
                 _oracle_loss_fn),
    "smollm-360m": (lambda a: _lm_batch(a, np.random.default_rng(0), 16),
                    _oracle_loss_fn),
    "mixtral-8x7b": (lambda a: _lm_batch(a, np.random.default_rng(0),
                                         MOE_SEQ), _oracle_loss_fn),
    "whisper-tiny": (lambda a: _whisper_batch(np.random.default_rng(0), 8, 16,
                                              a.d_model, a.vocab),
                     _whisper_oracle),
}


def _jax_model(name, m=M):
    return JLMModel(jconfigs.smoke_arch(name),
                    jconfigs.smoke_parallel(name).with_(n_micro=m),
                    dtype=jnp.float32)


def _jax_inputs():
    """Each arch's weights (``model.init(PRNGKey(0))``) and batch, and the
    serving case's prompt and decode token: what the ranks read."""
    refs = {}
    for name, (batch_fn, _) in ORACLES.items():
        model = _jax_model(name)
        refs[name] = {"params": jax.device_get(jax.jit(model.init)(
            jax.random.PRNGKey(0))), "batch": batch_fn(model.arch)}
    rng = np.random.default_rng(1)
    vocab = jconfigs.smoke_arch("deepseek-7b").vocab
    refs["deepseek-7b"]["serve"] = {
        "tokens": rng.integers(0, vocab, (4, 16)).astype(np.int32),
        "token": rng.integers(0, vocab, (4, 1)).astype(np.int32),
        "decode_len": 20}
    return refs


def _jax_oracles(refs):
    """The sequential oracle's loss and grads of each arch, and the JAX
    serve's prefill logits and one decode step (of the given token) at
    pipe 1, m 2, into ``refs``."""
    for name, (_, oracle) in ORACLES.items():
        model, ref = _jax_model(name), refs[name]
        loss, grads = jax.jit(jax.value_and_grad(oracle(model, M)))(
            ref["params"], jax.tree.map(jnp.asarray, ref["batch"]))
        ref.update(loss=float(loss), grads=jax.device_get(grads))
    sv = refs["deepseek-7b"]["serve"]
    model = _jax_model("deepseek-7b")
    pcfg = model.pcfg
    jm = jmesh.make_smoke_mesh(pcfg)
    B, S = sv["tokens"].shape
    dshape = JShape("d", sv["decode_len"], B, "decode")
    with set_mesh(jm):
        prefill = jax.jit(jsteps.build_prefill_step(
            model, pcfg, jm, JShape("p", S, B, "prefill")))
        decode = jax.jit(jsteps.build_serve_step(model, pcfg, jm, dshape))
        cache = model.init_cache(dshape, M, filled=False)
        params = refs["deepseek-7b"]["params"]
        logits, cache = prefill(params, cache,
                                {"tokens": jnp.asarray(sv["tokens"])})
        sv["prefill"] = np.asarray(logits)
        logits, cache = decode(params, cache, jnp.asarray(sv["token"]))
        sv["decode"] = np.asarray(logits)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case of the world of four (per case, each rank's result by
    global rank) and the JAX runs, made in this process while the ranks
    run."""
    refs = _jax_inputs()
    tmp = tmp_path_factory.mktemp("mesh")
    torch.save(refs, tmp / "refs.pt")
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(mesh.spawn, ranks_lib.run_rank, ranks_lib.WORLD,
                            (str(tmp), str(tmp / "refs.pt")),
                            timeout_s=SPAWN_S, rendezvous_dir=str(tmp))
        _jax_oracles(refs)
        ranks.result()
    saved = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(ranks_lib.WORLD)]
    return {"refs": refs,
            "runs": {name: [s[name] for s in saved] for name in saved[0]}}


def _want_block(model, whole, got):
    """The block of a whole (pipe-stacked) tree a rank of ``got``'s mesh
    holds: its pipe rank's rows, its FSDP and tp blocks."""
    c, shape = got["coords"], mesh.mesh_shape(model.pcfg)
    share = (model.rank_share(whole, c["pipe"]) if model.pcfg.pipe > 1
             else whole)
    specs = dict(tree_items(got["specs"]))
    return {p: sharding.shard(a, specs[p], c, shape)
            for p, a in tree_items(share)}


def _port_model(case):
    return LMModel(configs.smoke_arch(case["ref"]), ranks_lib.pcfg_of(case),
                   dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("name", GRAD_CASES)
def test_layout_matches_jax_oracle(world, name):
    case = dict(ranks_lib.cases())[name]
    ref = world["refs"][case["ref"]]
    model = _port_model(case)
    want = params_from_jax(ref["grads"], arch=model.arch, src_pipe=1,
                           pcfg=model.pcfg, device="cpu",
                           dtype=torch.float32)
    for r, got in enumerate(world["runs"][name]):
        np.testing.assert_allclose(float(got["loss"]), ref["loss"], **TOL,
                                   err_msg=f"rank {r} loss")
        blocks = _want_block(model, want, got)
        assert blocks.keys() == got["grads"].keys()
        for path, w in blocks.items():
            np.testing.assert_allclose(got["grads"][path].numpy(), w.numpy(),
                                       **TOL, err_msg=f"rank {r} {path}")
    stats = world["runs"][name][0]["stats"]
    lay = case["layout"]
    assert ("tp_sum" in stats) == (lay["tp"] > 1)
    assert ("data_reduce" in stats) == (lay["data"] > 1)


def test_serve_matches_jax(world):
    """deepseek at (pipe 2, tp 2): each rank's cache holds its 2 of the 4
    kv heads; the last pipe ranks' logits, whole over the vocab."""
    ref = world["refs"]["deepseek-7b"]["serve"]
    runs = world["runs"]["deepseek-pt2-serve"]
    for r, got in enumerate(runs):
        if got["coords"]["pipe"] == 1:
            np.testing.assert_allclose(got["prefill"].numpy(),
                                       ref["prefill"], **TOL)
            np.testing.assert_allclose(got["decode"].numpy(), ref["decode"],
                                       **TOL)
        else:
            assert got["prefill"] is None and got["decode"] is None
    one = _port_model(dict(dict(ranks_lib.cases())["deepseek-pt2-serve"],
                           layout=dict(pipe=2, tp=1, data=1)))
    whole = one.cache_protos(ShapeConfig("d", ref["decode_len"], 4, "d"), M,
                             rank=0)
    full = sum(int(np.prod(s)) * torch.empty((), dtype=d).element_size()
               for _, (s, d) in _proto_items(whole))
    kv = sum(int(np.prod(s)) * 4 for p, (s, _) in _proto_items(whole)
             if not p.endswith("len"))
    assert runs[0]["cache_bytes"] == full - kv // 2


def _proto_items(tree, prefix=""):
    if isinstance(tree, dict):
        return [i for k, v in tree.items()
                for i in _proto_items(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def test_unet_data_parallel_matches_one_process(world):
    pcfg = ParallelConfig(pipe=2, tp=1, data=1, n_micro=M, schedule="gpipe")
    _, prog, stages, x, y = TH.build_problem(ranks_lib.UNET, pcfg,
                                             batch=ranks_lib.UNET_BATCH,
                                             device="cpu")
    loss, grads = PH.hetero_grad_call(prog, pcfg)(stages, x, y)
    want = dict(tree_items({str(i): g for i, g in enumerate(grads)}))
    for r, got in enumerate(world["runs"]["unet-pd2-gpipe"]):
        c = got["coords"]
        if c["pipe"] == 1:
            np.testing.assert_allclose(float(got["loss"]), float(loss), **TOL)
        for path, g in got["grads"].items():
            stage, rest = path.split("/", 1)
            w = want[f"{int(stage) * 2 + c['pipe']}/{rest}"]
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL,
                                       err_msg=f"rank {r} {path}")


def _step_params(world, tag):
    return [got["params"] for got in world["runs"][f"deepseek-pd2-step-{tag}"]]


def _assert_bitwise(a, b, tag):
    assert a.keys() == b.keys(), tag
    for k in a:
        assert torch.equal(a[k], b[k]), f"{tag} {k}"


def test_fsdp_is_bitwise_the_replicated_step(world):
    """FSDP on (blocks over data at rest, joined at each stage
    application) against off: the weights after an AdamW step, joined,
    bitwise."""
    for a, b in zip(_step_params(world, "fsdp"),
                    _step_params(world, "replicated")):
        _assert_bitwise(a, b, "fsdp")
    runs = world["runs"]["deepseek-pd2-step-fsdp"]
    assert runs[0]["stats"]["fsdp_gather"]["calls"] > 0


def test_gather_weights_once_is_bitwise_per_application(world):
    """The stage weights joined once a step against at each application
    (and at each recompute): bitwise, with fewer joins."""
    for a, b in zip(_step_params(world, "fsdp"), _step_params(world, "once")):
        _assert_bitwise(a, b, "once")
    per_app = world["runs"]["deepseek-pd2-step-fsdp"][0]["stats"]
    once = world["runs"]["deepseek-pd2-step-once"][0]["stats"]
    assert once["fsdp_gather"]["calls"] < per_app["fsdp_gather"]["calls"]


def test_replicas_hold_the_same_weights(world):
    """The two data replicas of each (pipe, tp) coordinate: the same bits
    after the step, whatever the placement; one mean loss and norm."""
    for tag in ("fsdp", "replicated"):
        runs = world["runs"][f"deepseek-pd2-step-{tag}"]
        by = {}
        for got in runs:
            by.setdefault(got["coords"]["pipe"], []).append(got)
        for pair in by.values():
            _assert_bitwise(pair[0]["params"], pair[1]["params"], tag)
        assert len({float(g["loss"]) for g in runs}) == 1
        assert len({float(g["grad_norm"]) for g in runs}) == 1


def test_gpipe_and_1f1b_agree_at_data2(world):
    """gpipe against 1f1b (``grad_reduce="ordered"``) at pipe 2 x data 2:
    every stage leaf bitwise (at m 2 each fold is one commutative add);
    the loss, the head and the embedding within ``TOL``: gpipe takes the
    head loss over the replica's whole batch, 1f1b one micro-batch at a
    time, and the sums differ in their last bits."""
    a = world["runs"]["deepseek-pd2-gpipe"]
    b = world["runs"]["deepseek-pd2-1f1b"]
    for x, y in zip(a, b):
        np.testing.assert_allclose(float(x["loss"]), float(y["loss"]), **TOL)
        for path in x["grads"]:
            if path.startswith("stages/"):
                assert torch.equal(x["grads"][path], y["grads"][path]), path
            else:
                np.testing.assert_allclose(x["grads"][path].numpy(),
                                           y["grads"][path].numpy(), **TOL)


# ---------------------------------------------------------------------------
# without a spawn
# ---------------------------------------------------------------------------

def _ref_specs(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))}


def _port_specs(tree):
    return {p: tuple(s) for p, s in tree_items(tree)}


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_placement_matches_reference(name):
    """Every leaf of the full-size tree, of the optimizer state, of a batch
    and of a decode cache placed as the reference places it, at the
    config's own pipe and tp and data 2."""
    jp = jconfigs.get_parallel(name).with_(data=2, pod=1, dp2=1)
    jmodel = JLMModel(jconfigs.get_arch(name), jp)
    jshapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    amesh = AbstractMesh((1, 2, jp.pipe, jp.tp),
                         ("pod", "data", "pipe", "tp"))
    jspecs = jsharding.param_specs(jshapes, amesh)

    pcfg = configs.get_parallel(name).with_(data=2, pod=1, dp2=1)
    meta = LMModel(configs.get_arch(name), pcfg, device="meta")
    mshape = mesh.mesh_shape(pcfg)
    pspecs = sharding.param_specs(meta.init(torch.Generator()), mshape)
    assert _port_specs(pspecs) == _ref_specs(jspecs)

    ostate = jax.eval_shape(lambda p: joptim.init(joptim.OptimizerConfig(),
                                                  p), jshapes)
    jo = jsharding.opt_state_specs(jspecs, ostate)
    po = sharding.opt_state_specs(pspecs)
    for field in ("mu", "nu", "master"):
        assert _port_specs(po[field]) == _ref_specs(getattr(jo, field))
    assert po["step"] == tuple(jo.step) and po["ef"] == jo.ef == ()

    batch = {k: torch.empty(8, 16, dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    jbatch = {k: jax.ShapeDtypeStruct((8, 16), jnp.int32) for k in batch}
    for m in (None, mshape):
        assert _port_specs(sharding.batch_specs(batch, m)) == _ref_specs(
            jsharding.batch_specs(jbatch, None if m is None else amesh))

    shape = ShapeConfig("d", 64, 8, "decode")
    jcache = jax.eval_shape(lambda: jmodel.init_cache(shape, 2,
                                                      filled=False))
    protos = meta.cache_protos(shape, 2)
    for seq_shard in (False, True):
        got = sharding.cache_specs(protos, mshape, seq_shard=seq_shard)
        want = jsharding.cache_specs(jcache, amesh, seq_shard=seq_shard)
        assert _port_specs(got) == _ref_specs(want)


class _Axis:
    """One coordinate of a mesh axis whose other blocks come from the
    whole tensors it is given (``cat`` finds the whole one of a block)."""

    def __init__(self, rank, size, wholes):
        self.rank, self.size, self.wholes = rank, size, wholes

    def block(self, x, dim):
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)

    def cat(self, x, dim, cls):
        if self.size == 1:
            return x
        for w in self.wholes:
            if w.shape[dim] == x.shape[dim] * self.size and torch.equal(
                    self.block(w, dim), x):
                return w
        raise AssertionError("no whole tensor holds this block")


def test_int8_ef_on_a_shard_equals_the_whole_leaf():
    """The EF blocks of 256 lie over the whole flattened leaf: each rank's
    dequantized block and residual block equal the whole leaf's."""
    g = torch.randn(1, 1, 24, 40, generator=torch.Generator().manual_seed(0))
    e = torch.randn(1, 1, 24, 40, generator=torch.Generator().manual_seed(1))
    g[..., 3, 7] = 50.0                              # one block's big scale
    deq, resid = EFCompressor().compress_reduce({"w": g}, {"w": e})
    spec = ("pipe", None, "data", "tp")
    shape = {"pod": 1, "data": 2, "pipe": 1, "tp": 2}
    for d in range(2):
        for t in range(2):
            coords = {"pod": 0, "data": d, "pipe": 0, "tp": t}
            tp_axis = _Axis(t, 2, [g, e])
            data_axis = _Axis(d, 2, [sharding.shard(
                x, spec, coords, shape, skip=("pipe", "data"))
                for x in (g, e)])
            view = mesh.MeshView(0, shape, coords, torch.device("cpu"),
                                 {"tp": tp_axis, "data": data_axis}, None)
            model = type("M", (), {"mesh": view, "specs": {"w": spec}})
            opt = type("O", (), {"ef": {"w": sharding.shard(e, spec, coords,
                                                            shape)}})
            got, new = steps._compress(
                ParallelConfig(grad_compression="int8_ef"), model,
                {"w": sharding.shard(g, spec, coords, shape)}, opt)
            assert torch.equal(got["w"], sharding.shard(deq["w"], spec,
                                                        coords, shape))
            assert torch.equal(new["w"], sharding.shard(resid["w"], spec,
                                                        coords, shape))


def test_moe_group_inside_a_replica_matches_the_whole_batch():
    """A micro-batch of 4 rows of 512 tokens over 2 replicas: the groups
    of 512 tokens each lie inside one replica's rows, so each replica's
    dispatch (at capacity factor 1, with drops) is its rows of the whole
    micro-batch's."""
    arch = configs.smoke_arch("mixtral-8x7b")
    m = dataclasses.replace(arch.moe, capacity_factor=1.0)
    g = torch.Generator().manual_seed(0)
    p = L.moe_init(g, arch.d_model, arch.d_ff, m, torch.float32,
                   torch.device("cpu"))
    x = torch.randn(4, 512, arch.d_model, generator=g)
    whole, logits = L.moe_apply(p, x, m)
    for r in range(2):
        out, lg = L.moe_apply(p, x[2 * r:2 * r + 2], m, replicas=2)
        np.testing.assert_allclose(out.numpy(), whole[2 * r:2 * r + 2].numpy(),
                                   **TOL)
        np.testing.assert_allclose(lg.numpy(), logits[2 * r:2 * r + 2].numpy(),
                                   **TOL)
    with pytest.raises(NotImplementedError, match="A9b"):
        L.moe_apply(p, x[:1, :256], m, replicas=2)
