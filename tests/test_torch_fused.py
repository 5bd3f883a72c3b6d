"""The port's fused F+B executor against the JAX package, on the CPU.

Same weights (the JAX ``model.init(PRNGKey(0))`` moved across with
``interop.params_from_jax``) and the same seeded-numpy batch as
``tests/test_torch_train.py``, whose sequential JAX oracle and 5-step JAX
curve this file reuses: the reference's own multi-device fused executor
does not reproduce its equivalence claims on the installed jax, so the port
is held against the single-device oracle, at that file's fp32 ``TOL``.

Beside the loss and every gradient leaf of each fused schedule: the
schedules bitwise equal to each other under ``grad_reduce="ordered"``,
``"running"``, the park / b-inbox / residual high-water against the plan,
the launch formulas ``chip_smoke.py`` holds the card to, the 1F1B train
curve, the fused step against the port's own ``gpipe`` step, and lossy
wires (which run at pipe 2 but for int8-ef under gpipe's autograd, and are
the identity at pipe 1), and 1F1B with its two stages in two processes (a
gloo group on the CPU) against the same oracle.
"""
import numpy as np
import pytest
import torch

from test_torch_train import (  # noqa: F401  (fixtures used by name)
    ARCH, BATCH, COUNT_M, COUNT_SEQ, CURVE_STEPS, OCFG, SEQ, TOL,
    _assert_tree_close, _count_train_calls, _few_threads, _port, jax_ref)

import _torch_dist_ranks as ranks_lib
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.pipeline import pipeline_grad_call
from repro_torch.core.skip import SkipSpec
from repro_torch.interop import params_from_jax
from repro_torch.launch import mesh, steps
from repro_torch.launch.train import expected_train_launches
from repro_torch.models.lm import head_loss_chunk
from repro_torch.optim import optimizers as optim
from repro_torch.tree import tree_items

SCHEDULES = {
    "gpipe_tasked": dict(schedule="gpipe_tasked"),
    "1f1b": dict(schedule="1f1b"),
    "zb": dict(schedule="zb"),
    "zb-reuse": dict(schedule="zb", residuals="reuse", remat="none"),
    # Bx's graph checkpointed: Bw recomputes the stage inside its backward
    "zb-reuse-full": dict(schedule="zb", residuals="reuse", remat="full"),
    # Bx's graph keeps the products: both backwards recompute the rest
    "zb-reuse-dots": dict(schedule="zb", residuals="reuse", remat="dots"),
    "zb-reuse-dots_no_batch": dict(schedule="zb", residuals="reuse",
                                   remat="dots_no_batch"),
    "interleaved2": dict(schedule="interleaved:2"),
}
# the schedules of one stage per rank: bitwise equal to each other
FLAT = ("gpipe_tasked", "1f1b", "zb", "zb-reuse", "zb-reuse-full")
ORACLE_CASES = [(name, pipe) for name in ("gpipe_tasked", "1f1b", "zb")
                for pipe in (2, 4)] + [("zb-reuse", 2), ("zb-reuse-full", 2),
                                       ("interleaved2", 2)]
_RUNS = {}


def _fused(ref_, name, pipe, **kw):
    """Loss, grads, buffer high-water and plan of one fused grad call on
    the oracle's weights and batch (memoised: several tests read a run)."""
    key = (name, pipe, tuple(sorted(kw.items())))
    if key not in _RUNS:
        model, pcfg, params, batch = _port(ref_, pipe, **SCHEDULES[name],
                                           **kw)
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


@pytest.mark.parametrize("name, pipe", ORACLE_CASES)
def test_fused_loss_and_grads_match_jax_oracle(jax_ref, name, pipe):
    run = _fused(jax_ref, name, pipe)
    np.testing.assert_allclose(float(run["loss"]), jax_ref["loss"], **TOL)
    want = params_from_jax(jax_ref["grads"], arch=run["model"].arch,
                           src_pipe=1, pcfg=run["pcfg"], device="cpu")
    _assert_tree_close(run["grads"], want, f"{name} pipe {pipe}")


def test_fused_1f1b_in_two_processes_matches_jax_oracle(jax_ref, tmp_path):
    """Stages in their own processes (a gloo group of two on the CPU,
    ``tests/_torch_dist_ranks.py``) on the oracle's weights and batch:
    each rank's loss and gradients against the oracle's, as
    :func:`test_fused_loss_and_grads_match_jax_oracle` holds one
    process."""
    model, pcfg, params, batch = _port(jax_ref, 2, schedule="1f1b")
    torch.save(params, tmp_path / "params.pt")
    torch.save(batch, tmp_path / "batch.pt")
    case = dict(kind="grads", arch=ARCH, pcfg=dict(schedule="1f1b"),
                params=str(tmp_path / "params.pt"),
                batch=str(tmp_path / "batch.pt"))
    mesh.spawn(ranks_lib.run_rank, 2,
               (str(tmp_path), "jax", [("jax-1f1b", case)]), timeout_s=120,
               rendezvous_dir=str(tmp_path))
    want = params_from_jax(jax_ref["grads"], arch=model.arch, src_pipe=1,
                           pcfg=pcfg, device="cpu")
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")["dist"]["jax-1f1b"]
        np.testing.assert_allclose(float(got["loss"]), jax_ref["loss"],
                                   **TOL)
        _assert_tree_close(got["grads"], model.rank_share(want, r),
                           f"rank {r}")


@pytest.mark.parametrize("pipe", [2, 4])
def test_schedules_bitwise_equal_under_ordered_reduce(jax_ref, pipe):
    """Each (stage, micro) gradient comes from the same ops on the same
    inputs in every schedule, and "ordered" folds them in micro order."""
    base = _fused(jax_ref, FLAT[0], pipe)
    for name in FLAT[1:]:
        _assert_bitwise(_fused(jax_ref, name, pipe), base,
                        f"{name} vs {FLAT[0]} pipe {pipe}")


@pytest.mark.parametrize("name", ["zb-reuse-dots", "zb-reuse-dots_no_batch"])
def test_zb_reuse_selective_bitwise_equal_to_zb_recompute(jax_ref, name):
    """The reference's acceptance test for residual reuse
    (``tests/test_oracle.py``: zb reuse under "dots" is bitwise zb
    recompute): Bx keeps the policy's stored products in its graph and
    Bw differentiates that graph a second time, replaying them; the loss
    and every gradient equal zb's with residuals "recompute"."""
    _assert_bitwise(_fused(jax_ref, name, 2), _fused(jax_ref, "zb", 2),
                    f"{name} vs zb")


@pytest.mark.parametrize("name", ["1f1b", "zb"])
def test_running_reduce_close_to_ordered_and_stable(jax_ref, name):
    ordered = _fused(jax_ref, name, 4)
    running = _fused(jax_ref, name, 4, grad_reduce="running")
    _assert_tree_close(running["grads"], ordered["grads"], f"{name} running")
    _RUNS.pop((name, 4, (("grad_reduce", "running"),)))
    again = _fused(jax_ref, name, 4, grad_reduce="running")
    _assert_bitwise(again, running, f"{name} running twice")


@pytest.mark.parametrize("name, pipe", ORACLE_CASES + [("zb-reuse", 4)])
def test_buffer_high_water_equals_plan(jax_ref, name, pipe):
    run = _fused(jax_ref, name, pipe)
    tplan, park = run["tplan"], run["park"]
    assert park == {"per_stage_park": tplan.per_stage_park,
                    "per_stage_b_inbox": tplan.per_stage_b_inbox,
                    "per_stage_resid": tplan.per_stage_resid}
    if name == "1f1b":        # the 1F1B bound: min(n - j, m), none on rank 0
        assert park["per_stage_park"] == tuple(
            0 if j == 0 else min(pipe - j + 1, 4) for j in range(pipe))
    assert any(park["per_stage_resid"]) == name.startswith("zb-reuse")


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_fused_kernel_contract_and_call_counts_on_cpu(monkeypatch, name):
    """Every kernel call of a fused step meets the CUDA contract, and the
    calls follow the formula chip_smoke.py holds the card to
    (``expected_train_launches``).  Spelled out for 1F1B with L layers
    over S stages, m micro-batches and nc head-loss chunks: attention
    2 L m - (L / S) m forwards (F ticks but the last stage's, and each B
    tick's graph) and L m backwards; RMSNorm twice the layers' forwards
    plus 2 nc m (the head in each B graph and its chunks' recompute), and
    2 L m + nc m backwards."""
    calls, metrics, arch, pcfg = _count_train_calls(monkeypatch,
                                                    **SCHEDULES[name])
    L = arch.n_layers
    assert calls == expected_train_launches(pcfg, arch, COUNT_SEQ), name
    if name == "1f1b":
        m, nc, S = COUNT_M, COUNT_SEQ // head_loss_chunk(COUNT_SEQ), pcfg.pipe
        fwd = 2 * L * m - L // S * m
        assert calls == {"flash_attention": fwd,
                         "flash_attention_bwd": L * m,
                         "rmsnorm": 2 * fwd + 2 * nc * m,
                         "rmsnorm_bwd": 2 * L * m + nc * m,
                         "wkv6": 0, "wkv6_bwd": 0}
    assert np.isfinite(float(metrics["loss"]))


def test_1f1b_train_curve_matches_jax_oracle(jax_ref):
    model, pcfg, params, batch = _port(jax_ref, 2, schedule="1f1b")
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


@pytest.mark.parametrize("loss_scale", [False, True])
def test_fused_step_matches_gpipe_step(jax_ref, loss_scale):
    """Two optimizer steps through 1F1B and through the autograd GPipe
    step: losses, metrics and parameters agree; with the dynamic loss
    scale the fused executor seeds every cotangent by the state's scale."""
    ocfg = optim.OptimizerConfig(**OCFG, dynamic_loss_scale=loss_scale)
    out = {}
    for schedule in ("gpipe", "1f1b"):
        model, pcfg, params, batch = _port(jax_ref, 2, schedule=schedule)
        step = steps.build_train_step(
            model, pcfg, "cpu", ShapeConfig("t", SEQ, BATCH, "train"), ocfg)
        opt = optim.init(ocfg, params)
        ms = []
        for _ in range(2):
            params, opt, metrics = step(params, opt, batch)
            ms.append({k: float(v) for k, v in metrics.items()})
        out[schedule] = (params, ms)
    _assert_tree_close(out["1f1b"][0], out["gpipe"][0], "params")
    for got, want in zip(out["1f1b"][1], out["gpipe"][1]):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


# ---------------------------------------------------------------------------
# lossy wires; what the fused path does not run raises
# ---------------------------------------------------------------------------

def _stage(*a):
    return a


@pytest.mark.parametrize("wire", ["bf16", "int8-ef",
                                  "chain=fp32,portal=fp32,cotangent=bf16"])
@pytest.mark.parametrize("entry", ["pipeline_call", "pipeline_grad_call"])
def test_lossy_wire_raises_at_pipe_2(jax_ref, entry, wire):
    """At pipe 2 a lossy wire trains through both executors, its loss
    within the reference's int8-ef tolerance (rtol 2e-3) of the oracle's
    (the codecs themselves are held against the reference in
    tests/test_torch_transport.py), except int8-ef on a hop the forward
    executor encodes under autograd (``schedule="gpipe"``, run by
    ``pipeline_call``): that raises, where the reference would train on a
    truncated gradient."""
    schedule = "gpipe" if entry == "pipeline_call" else "1f1b"
    model, pcfg, params, batch = _port(jax_ref, 2, schedule=schedule,
                                       wire=wire)
    if entry == "pipeline_call" and wire == "int8-ef":
        with pytest.raises(ValueError, match="truncated gradient"):
            steps.build_grad_fn(model, pcfg, "cpu")
        return
    loss, grads = steps.build_grad_fn(model, pcfg, "cpu")(params, batch)
    np.testing.assert_allclose(float(loss), jax_ref["loss"], rtol=2e-3)
    assert all(bool(torch.isfinite(g).all()) for _, g in tree_items(grads))


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_lossy_wire_is_the_identity_at_pipe_1(jax_ref, schedule):
    """At pipe 1 there is no hop, so the reference never encodes: bf16 and
    int8-ef wires give the fp32 wire's loss and grads bit for bit."""
    runs = []
    for wire in ("fp32", "bf16", "int8-ef"):
        model, pcfg, params, batch = _port(jax_ref, 1, schedule=schedule,
                                           wire=wire)
        loss, grads = steps.build_grad_fn(model, pcfg, "cpu")(params, batch)
        runs.append({"loss": loss, "grads": grads})
    for run in runs[1:]:
        _assert_bitwise(run, runs[0], schedule)


def test_fused_skip_routes_raise():
    """Skip routes run in both executors (tests/test_torch_skip.py).  What
    still raises: a threaded route that crosses one rank link twice under
    interleaving (one hop a tick per link), and a stage that returns a
    skip no route carries."""
    pcfg = configs.smoke_parallel(ARCH).with_(
        pipe=2, n_micro=2, schedule="interleaved:2", portals=False)
    with pytest.raises(NotImplementedError, match="portals=True"):
        pipeline_grad_call(_stage, cfg=pcfg, loss_fn=_stage, devices="cpu",
                           skips=(SkipSpec("x", 0, (3,)),))

    def stray(p, carry, skips_in, resident, ctx):
        h = ctx.fresh["h"] if ctx.stage == 0 else carry["h"]
        return {"h": h * p["w"]}, {"x": h}, resident

    call, _ = pipeline_grad_call(
        stray, cfg=pcfg.with_(schedule="1f1b", portals=True),
        loss_fn=lambda hp, carry, largs: carry["h"].sum(), devices="cpu")
    with pytest.raises(RuntimeError, match="SkipSpec"):
        call({"w": torch.ones(2)}, {}, {"h": torch.ones(2, 1, 3)},
             {"y": torch.zeros(2)})
