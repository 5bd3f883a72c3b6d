"""The pipe ranks of ``tests/test_torch_dist.py`` (and of the one
multi-process case each of ``tests/test_torch_fused.py`` and
``tests/test_torch_serve.py``): each spawned process
joins a gloo group on the CPU, runs every case of its suite as one rank,
then computes the single-process runs of the cases dealt to it, and saves
both under ``out_dir``.  Its own module, so that a spawned process imports
this and the port, not a test file's imports: no JAX (a case held against
the JAX reference reads the parent's numpy arrays).

Every rank and every single-process run keeps torch to one thread: CPU
matmuls may sum in another order at another thread count.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.interop import params_from_jax
from repro_torch.launch import mesh, steps
from repro_torch.launch import serve as serve_lib
from repro_torch.launch import train as train_lib
from repro_torch.models import pipeline_hetero as PH
from repro_torch.models.lm import LMModel
from repro_torch.models.unet import UNetConfig, UNetModel
from repro_torch.optim import optimizers as optim

BATCH, SEQ, M = 8, 16, 4
PROMPT, GEN = 12, 4       # serving: prompt length, tokens generated
OCFG = dict(lr=2e-3, warmup_steps=2, total_steps=20, clip_norm=1.0)
FAIL_AFTER = 3            # the failing rank raises at this stage call


def _pcfg(arch_name: str, pipe: int, **kw):
    return configs.smoke_parallel(arch_name).with_(pipe=pipe, n_micro=M,
                                                   **kw)


def _batch(arch) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng(0)
    if arch.is_encdec:
        return {"frames": torch.from_numpy(
                    (rng.standard_normal((BATCH, SEQ, arch.d_model)) * 0.1
                     ).astype(np.float32)),
                "dec_tokens": torch.from_numpy(
                    rng.integers(0, arch.vocab, (BATCH, SEQ)).astype(np.int32)),
                "labels": torch.from_numpy(
                    rng.integers(0, arch.vocab, (BATCH, SEQ)).astype(np.int32))}
    return {k: torch.from_numpy(rng.integers(0, arch.vocab, (BATCH, SEQ)
                                             ).astype(np.int32))
            for k in ("tokens", "labels")}


def suite(name: str, nproc: int) -> List[Tuple[str, Dict[str, Any]]]:
    """``(case name, case)`` in the order every rank runs them."""
    if name == "fail":
        return [("fail", dict(kind="fail", arch="smollm-360m",
                              pcfg=dict(schedule="1f1b")))]
    cases = []
    if name == "r2":
        for sched, kw in (("1f1b", {}), ("gpipe_tasked", {}), ("zb", {}),
                          ("zb-reuse", dict(residuals="reuse",
                                            remat="none")),
                          ("interleaved2", {})):
            schedule = {"zb-reuse": "zb",
                        "interleaved2": "interleaved:2"}.get(sched, sched)
            for ex in ("spmd", "mpmd"):
                cases.append((f"smollm-{sched}-{ex}", dict(
                    kind="grads", arch="smollm-360m",
                    pcfg=dict(schedule=schedule, executor=ex, **kw))))
        cases.append(("smollm-train-1f1b", dict(
            kind="train", arch="smollm-360m",
            pcfg=dict(schedule="1f1b"))))
        cases.append(("launch-train-1f1b", dict(
            kind="launch", arch="smollm-360m",
            pcfg=dict(schedule="1f1b"))))
        for ex in ("spmd", "mpmd"):
            cases.append((f"unet-1f1b-{ex}", dict(
                kind="hetero", pcfg=dict(schedule="1f1b", executor=ex))))
        # the forward executor: gpipe under autograd, and serving
        for arch in ("smollm-360m", "whisper-tiny"):
            for ex in ("spmd", "mpmd"):
                cases.append((f"{arch.split('-')[0]}-gpipe-{ex}", dict(
                    kind="grads", arch=arch,
                    pcfg=dict(schedule="gpipe", executor=ex))))
        cases.append(("whisper-gpipe-bf16-spmd", dict(
            kind="grads", arch="whisper-tiny",
            pcfg=dict(schedule="gpipe", wire="bf16"))))
        for ex in ("spmd", "mpmd"):
            cases.append((f"unet-gpipe-{ex}", dict(
                kind="hetero", pcfg=dict(schedule="gpipe", executor=ex))))
        cases.append(("smollm-train-gpipe", dict(
            kind="train", arch="smollm-360m",
            pcfg=dict(schedule="gpipe"))))
        cases.append(("launch-train-gpipe", dict(
            kind="launch", arch="smollm-360m",
            pcfg=dict(schedule="gpipe"))))
        for arch, ex in (("smollm-360m", "spmd"), ("smollm-360m", "mpmd"),
                         ("rwkv6-1.6b", "spmd"), ("whisper-tiny", "mpmd")):
            cases.append((f"{arch.split('-')[0]}-serve-{ex}", dict(
                kind="serve", arch=arch, pcfg=dict(executor=ex))))
    elif name == "r4":
        for ex in ("spmd", "mpmd"):
            cases.append((f"smollm-1f1b-{ex}", dict(
                kind="grads", arch="smollm-360m",
                pcfg=dict(schedule="1f1b", executor=ex))))
        for wire, ex in (("bf16", "spmd"), ("int8-ef", "mpmd"),
                         ("int8-ef", "spmd")):
            cases.append((f"whisper-1f1b-stream-{wire}-{ex}", dict(
                kind="grads", arch="whisper-tiny",
                pcfg=dict(schedule="1f1b", executor=ex, wire=wire,
                          stream_inputs=True))))
        # the forward executor: mem's three destinations and a carry the
        # first decoder stage drops; streamed serving
        cases.append(("whisper-gpipe-spmd", dict(
            kind="grads", arch="whisper-tiny",
            pcfg=dict(schedule="gpipe"))))
        cases.append(("smollm-gpipe-mpmd", dict(
            kind="grads", arch="smollm-360m",
            pcfg=dict(schedule="gpipe", executor="mpmd"))))
        # streamed inputs under autograd: the shards rotate as values and
        # rank 0 sends the cotangents to its own inputs
        cases.append(("smollm-gpipe-stream-spmd", dict(
            kind="grads", arch="smollm-360m",
            pcfg=dict(schedule="gpipe", stream_inputs=True))))
        cases.append(("whisper-serve-stream-spmd", dict(
            kind="serve", arch="whisper-tiny",
            pcfg=dict(stream_inputs=True))))
    else:
        raise ValueError(f"unknown suite {name!r}")
    return cases


def _model(case, pipe: int, view=None):
    """The case's model, on the pipe group's mesh ``view`` (None: one
    process)."""
    arch = configs.smoke_arch(case["arch"])
    pcfg = _pcfg(case["arch"], pipe, **case["pcfg"])
    return LMModel(arch, pcfg, dtype=torch.float32, device="cpu", mesh=view)


def _whole(model, params):
    """The rank's blocks of a whole ``params`` tree (itself in one
    process)."""
    if model.mesh is None:
        return params
    return model.shard_params(model.rank_share(params, model.mesh.pipe.rank))


def _params(model, case):
    if "params" in case:                  # given whole (a JAX oracle's)
        return _whole(model, torch.load(case["params"]))
    return model.init(torch.Generator().manual_seed(0))


def _batch_of(model, case):
    if "batch" in case:
        return torch.load(case["batch"])
    return _batch(model.arch)


def _grads(view, case, pipe: int):
    model = _model(case, pipe, view)
    grad_fn = steps.build_grad_fn(model, model.pcfg, "cpu")
    loss, grads = grad_fn(_params(model, case), _batch_of(model, case))
    return {"loss": loss, "grads": grads, "park": dict(grad_fn.park_info)}


def _train(view, case, pipe: int, n_steps: int = 2):
    model = _model(case, pipe, view)
    ocfg = optim.OptimizerConfig(**OCFG)
    step = steps.build_train_step(model, model.pcfg, "cpu",
                                  ShapeConfig("t", SEQ, BATCH, "train"),
                                  ocfg)
    params = _params(model, case)
    opt = optim.init(ocfg, params)
    batch = _batch_of(model, case)
    losses = []
    for _ in range(n_steps):
        params, opt, metrics = step(params, opt, batch)
        losses.append(metrics["loss"])
    return {"losses": losses, "params": params}


def _fail(view, case, pipe: int):
    """Rank 1 raises inside a stage mid-step; the others wait on it."""
    model = _model(case, pipe, view)
    inner = model.make_stage_apply
    calls = [0]

    def failing(*a, **kw):
        apply = inner(*a, **kw)

        def stage_apply(*args):
            calls[0] += 1
            if view.pipe.rank == 1 and calls[0] == FAIL_AFTER:
                raise RuntimeError("injected fault on pipe rank 1")
            return apply(*args)
        return stage_apply
    model.make_stage_apply = failing
    steps.build_grad_fn(model, model.pcfg, "cpu")(
        _params(model, case), _batch_of(model, case))
    return {}


def _launch(view, case, pipe: int):
    """``launch.train.train``, the entry point ``--nproc`` runs in each
    rank: two steps on the CPU."""
    model = _model(case, pipe)
    res = train_lib.train(model.arch, model.pcfg, seq_len=SEQ, batch=BATCH,
                          steps=2, device="cpu", dtype=torch.float32,
                          ocfg=optim.OptimizerConfig(**OCFG), mesh_view=view)
    return {"losses": [r["loss"] for r in res["history"]],
            "ranks": res.get("ranks")}


def _serve(view, case, pipe: int):
    """``launch.serve.serve``, what ``serve --nproc`` runs in each rank:
    a PROMPT-token batch of BATCH, GEN tokens greedy."""
    model = _model(case, pipe)
    res = serve_lib.serve(model.arch, model.pcfg, prompt_len=PROMPT,
                          gen=GEN, batch=BATCH, device="cpu",
                          dtype=torch.float32, mesh_view=view)
    return {k: res.get(k) for k in ("tokens", "logits", "n_micro",
                                    "cache_bytes", "hops", "park", "ranks")}


def _serve_jax(view, case, pipe: int):
    """Prefill and decode on the JAX reference's weights, prompts and
    tokens (numpy, ``case["ref"]``): the last rank's logits."""
    model = _model(case, pipe, view)
    with open(case["ref"], "rb") as f:
        ref = pickle.load(f)
    params = _whole(model, params_from_jax(ref["params"], arch=model.arch,
                                           src_pipe=1, pcfg=model.pcfg,
                                           device="cpu"))
    batch, n_prompt = ref["prompts"].shape
    pshape = ShapeConfig("p", n_prompt, batch, "prefill")
    dshape = ShapeConfig("d", ref["decode_len"], batch, "decode")
    prefill = steps.build_prefill_step(model, model.pcfg, "cpu", pshape)
    decode = steps.build_serve_step(model, model.pcfg, "cpu", dshape)
    cache = model.init_cache(dshape, model.pcfg.n_micro, filled=False,
                             rank=None if view is None else view.pipe.rank)
    logits, cache = prefill(params, cache,
                            {"tokens": torch.from_numpy(ref["prompts"])})
    out = {"prefill": logits, "decode": []}
    for tok in ref["tokens"]:
        logits, cache = decode(params, cache, torch.from_numpy(tok))
        out["decode"].append(logits)
    return out


UNET = UNetConfig(B=1, C=4, levels=3, img=32)


def _hetero_pcfg(case, pipe: int) -> ParallelConfig:
    return ParallelConfig(pipe=pipe, tp=1, data=1, n_micro=M, **case["pcfg"])


def _hetero(view, case, pipe: int):
    """A small U-Net, portals on: loss and every stage's grads."""
    model = UNetModel(UNET, pipe)
    pcfg = _hetero_pcfg(case, pipe)
    prog = PH.build_hetero_program(
        model, model.init(torch.Generator().manual_seed(0), "cpu"), pcfg,
        "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(BATCH, 3, UNET.img, UNET.img, generator=g)
    y = torch.randn(BATCH, 3, UNET.img, UNET.img, generator=g)
    park: Dict[str, Any] = {}
    call = PH.hetero_grad_call(prog, pcfg, park, mesh_view=view)
    stages = prog.stage_params if view is None else \
        prog.stage_params[view.pipe.rank::pipe]
    loss, grads = call(stages, x, y)
    return {"loss": loss, "grads": grads, "park": park}


RUN = {"grads": _grads, "train": _train, "fail": _fail, "hetero": _hetero,
       "launch": _launch, "serve": _serve, "serve_jax": _serve_jax}


def run_rank(rank: int, nproc: int, init_method: str, out_dir: str,
             suite_name: str, extra=None) -> None:
    """One pipe rank: the suite's cases in the group, then the
    single-process runs of the cases ``k`` with ``k % nproc == rank``."""
    torch.set_num_threads(1)
    cases = extra or suite(suite_name, nproc)
    view = mesh.init_pipe_group(rank, nproc, init_method, device="cpu",
                                timeout_s=60)
    try:
        dist = {name: RUN[case["kind"]](view, case, nproc)
                for name, case in cases}
    finally:
        mesh.destroy_pipe_group(view)
    ref = {name: RUN[case["kind"]](None, case, nproc)
           for k, (name, case) in enumerate(cases) if k % nproc == rank}
    torch.save({"dist": dist, "ref": ref},
               os.path.join(out_dir, f"rank{rank}.pt"))
