"""The port's serving slice against the JAX package, on the CPU.

Same weights (the JAX ``model.init(PRNGKey(0))`` moved across as numpy and
restacked onto the port's layout) and the same prompts (numpy, seeded): the
port's prefill logits, every KV-cache leaf and three greedy decode steps'
logits must equal the JAX ``build_prefill_step`` / ``build_serve_step``
results at pipe 1 within ``tests/test_oracle.py``'s fp32 tolerance, for the
port at pipe 1, 2 and 4, and for two pipe ranks in their own processes
(``serve`` with a group's steps, ``tests/_torch_dist_ranks.py``; the ranks
import no JAX and read the weights, prompts and tokens as numpy).  The JAX
side runs its blocked-jnp path, and once its Pallas kernels in interpret
mode.
"""
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
from repro_torch.models.lm import LMModel
from repro_torch.tree import tree_items

# tests/test_oracle.py's fp32 TOL: same math, different graphs and sum order
TOL = dict(rtol=5e-4, atol=5e-5)
ARCH = "smollm-360m"
BATCH, PROMPT, STEPS = 4, 12, 3
DECODE_LEN = PROMPT + STEPS + 1          # cache slots = DECODE_LEN + 64
JAX_MICRO = 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_run(interpret: bool, monkeypatch):
    """JAX prefill + STEPS greedy decode steps at pipe 1 (numpy results)."""
    if interpret:
        monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("REPRO_PALLAS_INTERPRET", raising=False)
    arch = jconfigs.smoke_arch(ARCH)
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
    """[n_stages, L, m, mb, ...] leaves (numpy or torch) ->
    {"self/k", "self/v": [layers, B, ...], "self/len": [layers]}."""
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


def _port_run(ref, pipe: int, m: int):
    arch = configs.smoke_arch(ARCH)
    pcfg = configs.smoke_parallel(ARCH).with_(pipe=pipe, n_micro=m)
    model = LMModel(arch, pcfg, dtype=torch.float32, device="cpu")
    params = params_from_jax(ref["params"], arch=arch, src_pipe=1, pcfg=pcfg,
                             device="cpu")
    pshape = ShapeConfig("p", PROMPT, BATCH, "prefill")
    dshape = ShapeConfig("d", DECODE_LEN, BATCH, "decode")
    park_p, park_d = {}, {}
    prefill = steps.build_prefill_step(model, pcfg, "cpu", pshape,
                                       park_info=park_p)
    decode = steps.build_serve_step(model, pcfg, "cpu", dshape,
                                    park_info=park_d)
    cache = model.init_cache(dshape, m, filled=False)
    logits, cache = prefill(params, cache,
                            {"tokens": torch.from_numpy(ref["prompts"])})
    out = {"prefill": logits.numpy(),
           "cache": _canon_cache(cache, model.layout), "decode": []}
    for tok in ref["tokens"]:
        logits, cache = decode(params, cache, torch.tensor(tok))
        out["decode"].append(logits.numpy())
    out["cache_end"] = _canon_cache(cache, model.layout)
    out["park"] = (park_p["per_stage_park"], prefill.tplan.per_stage_park,
                   park_d["per_stage_park"], decode.tplan.per_stage_park)
    return out


def _assert_matches(ref, got):
    jax_layout = stage_lib.partition_layout(
        configs.smoke_arch(ARCH).n_layers, 1)
    np.testing.assert_allclose(got["prefill"], ref["prefill"], **TOL,
                               err_msg="prefill logits")
    for tag in ("cache", "cache_end"):
        want = _canon_cache(ref[tag], jax_layout)
        assert want.keys() == got[tag].keys()
        for path, w in want.items():
            np.testing.assert_allclose(got[tag][path], w, **TOL,
                                       err_msg=f"{tag} {path}")
    for i, (g, w) in enumerate(zip(got["decode"], ref["decode"])):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"decode step {i}")
    assert len(got["decode"]) == STEPS


@pytest.mark.parametrize("pipe,m", [(1, 2), (2, 2), (2, 4), (4, 4)])
def test_port_serve_matches_jax(jax_ref, pipe, m):
    got = _port_run(jax_ref, pipe, m)
    _assert_matches(jax_ref, got)


def test_two_ranks_serve_matches_jax(jax_ref, tmp_path):
    """Two pipe ranks on gloo, each with its share of the JAX reference's
    weights (``interop.params_from_jax``, then ``rank_share``), prefill
    the JAX prompts and decode the JAX tokens: the last rank's logits are
    within TOL of the JAX serve's, pick its greedy tokens, and are bitwise
    one process's at pipe 2; rank 0 returns none."""
    import pickle
    import _torch_dist_ranks as ranks_lib
    from repro_torch.launch import mesh
    path = tmp_path / "jax_serve.pkl"
    with open(path, "wb") as f:
        pickle.dump({"params": jax_ref["params"],
                     "prompts": jax_ref["prompts"],
                     "tokens": jax_ref["tokens"], "decode_len": DECODE_LEN},
                    f)
    case = dict(kind="serve_jax", arch=ARCH, pcfg={}, ref=str(path))
    mesh.spawn(ranks_lib.run_rank, 2, (str(tmp_path), "r2", [("jax", case)]),
               timeout_s=120, rendezvous_dir=str(tmp_path))
    saved = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    first, last = (s["dist"]["jax"] for s in saved)
    assert first["prefill"] is None
    np.testing.assert_allclose(last["prefill"].numpy(), jax_ref["prefill"],
                               **TOL, err_msg="prefill logits")
    assert len(last["decode"]) == len(jax_ref["decode"]) == STEPS
    for i, (g, w) in enumerate(zip(last["decode"], jax_ref["decode"])):
        np.testing.assert_allclose(g.numpy(), w, **TOL,
                                   err_msg=f"decode step {i}")
    # the greedy tokens the ranks would pick are the JAX serve's
    picked = [last["prefill"]] + last["decode"][:-1]
    for i, (g, tok) in enumerate(zip(picked, jax_ref["tokens"])):
        assert np.array_equal(g.argmax(-1).numpy(), tok), f"token {i}"
    one = saved[0]["ref"]["jax"]          # one process at pipe 2
    assert torch.equal(last["prefill"], one["prefill"])
    for g, w in zip(last["decode"], one["decode"]):
        assert torch.equal(g, w)


def test_port_serve_matches_jax_pallas_interpret(monkeypatch):
    """The JAX side through its Pallas kernels (interpret mode)."""
    ref = _jax_run(True, monkeypatch)
    _assert_matches(ref, _port_run(ref, 2, 2))


@pytest.mark.parametrize("pipe,m", [(1, 2), (2, 4), (4, 2), (4, 4)])
def test_park_high_water_equals_plan(jax_ref, pipe, m):
    """The executor's park high-water is the plan's per_stage_park."""
    got = _port_run(jax_ref, pipe, m)
    prefill_seen, prefill_plan, decode_seen, decode_plan = got["park"]
    assert prefill_seen == prefill_plan
    assert decode_seen == decode_plan
    assert len(prefill_plan) == pipe


def test_full_width_param_shapes_match_jax():
    """Full smollm-360m: the port's parameter tree (meta device, nothing
    allocated) has jax.eval_shape(model.init)'s leaves, shapes and dtypes."""
    jarch = jconfigs.get_arch(ARCH)
    jpcfg = jconfigs.get_parallel(ARCH).with_(data=1)
    want = jax.eval_shape(JLMModel(jarch, jpcfg).init, jax.random.PRNGKey(0))
    arch = configs.get_arch(ARCH)
    pcfg = configs.get_parallel(ARCH).with_(data=1)
    model = LMModel(arch, pcfg, dtype=torch.bfloat16, device="meta")
    got = model.init(torch.Generator().manual_seed(0))
    got_items = dict(tree_items(got))
    want_items = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                  for path, leaf in
                  jax.tree_util.tree_flatten_with_path(want)[0]}
    assert got_items.keys() == want_items.keys()
    for path, leaf in want_items.items():
        assert tuple(got_items[path].shape) == tuple(leaf.shape), path
        assert str(got_items[path].dtype).split(".")[-1] == str(leaf.dtype), path
        assert got_items[path].device.type == "meta"


def test_kernel_contract_and_call_counts_on_cpu(monkeypatch):
    """On the CPU path, every call that reaches a kernel's plain version
    meets the CUDA kernel's contract (dtype, shape, contiguity), and the
    calls per prefill / decode step follow the formulas chip_smoke.py checks
    on the card: flash L*m and rmsnorm 3*L*m + 1 per prefill, rmsnorm
    2*L*m + 1 per decode step.  Full width, 4 layers, bf16."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import rmsnorm as rn_mod
    from repro_torch.launch.serve import serve

    calls = {"flash_attention": 0, "rmsnorm": 0}

    def norm(x, scale, eps=1e-6, _plain=rn_mod.rmsnorm_plain):
        rn_mod.check_inputs(x, scale)
        calls["rmsnorm"] += 1
        return _plain(x, scale, eps)

    def attn(q, k, v, _plain=fa_mod.flash_attention_plain, **kw):
        fa_mod.check_inputs(q, k, v)
        calls["flash_attention"] += 1
        return _plain(q, k, v, **kw)

    monkeypatch.setattr(rn_mod, "rmsnorm_plain", norm)
    monkeypatch.setattr(fa_mod, "flash_attention_plain", attn)
    arch = dataclasses.replace(configs.get_arch(ARCH), n_layers=4)
    pcfg = configs.get_parallel(ARCH).with_(pipe=2, data=1)
    gen = 3
    res = serve(arch, pcfg, prompt_len=16, gen=gen, batch=4, device="cpu",
                dtype=torch.bfloat16)
    m, n_layers = res["n_micro"], arch.n_layers
    assert m == 4
    want = {"flash_attention": n_layers * m,
            "rmsnorm": 3 * n_layers * m + 1
            + (gen - 1) * (2 * n_layers * m + 1)}
    assert calls == want
    assert res["tokens"].shape == (4, gen)
    assert bool(torch.isfinite(res["logits"].float()).all())
