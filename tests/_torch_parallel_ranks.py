"""The mesh ranks of ``tests/test_torch_parallel.py``: each spawned process
joins a gloo world of four on the CPU and runs every case as one rank of
the case's ``(pod, data, pipe, tp)`` mesh (the world laid out again for
each, ``launch.mesh.mesh_groups``), then saves its results under
``out_dir``.  Its own module, so that a spawned process imports this and
the port, not a test file's imports: no JAX (the weights and batches held
against the JAX reference come from the parent as numpy arrays).

Every rank keeps torch to one thread: CPU matmuls may sum in another order
at another thread count.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.interop import params_from_jax
from repro_torch.launch import mesh, steps
from repro_torch.launch import train_hetero as TH
from repro_torch.models import pipeline_hetero as PH
from repro_torch.models.lm import LMModel
from repro_torch.models.unet import UNetConfig
from repro_torch.optim import optimizers as optim
from repro_torch.tree import tree_items

WORLD = 4
M = 2                      # micro-batches of every case
UNET = UNetConfig(B=1, C=4, levels=3, img=32)
UNET_BATCH = 8
OCFG = dict(lr=2e-3, warmup_steps=0, min_lr_ratio=1.0, clip_norm=1.0)

PT2 = dict(pipe=2, tp=2, data=1)
PD2 = dict(pipe=2, tp=1, data=2)
TD2 = dict(pipe=1, tp=2, data=2)


def cases() -> List[Tuple[str, Dict[str, Any]]]:
    """``(name, case)`` in the order every rank runs them.  ``ref`` names
    the parent's JAX run a case reads its weights and batch from."""
    out = []
    for sched in ("gpipe", "1f1b"):
        for tag, lay in (("pt2", PT2), ("pd2", PD2), ("td2", TD2)):
            out.append((f"deepseek-{tag}-{sched}", dict(
                kind="grads", ref="deepseek-7b", layout=lay,
                pcfg=dict(schedule=sched))))
    out.append(("mixtral-td2-gpipe", dict(
        kind="grads", ref="mixtral-8x7b", layout=TD2,
        pcfg=dict(schedule="gpipe"))))
    out.append(("whisper-pt2-1f1b", dict(
        kind="grads", ref="whisper-tiny", layout=PT2,
        pcfg=dict(schedule="1f1b"))))
    # splits off head boundaries: gemma's 4 heads over 2 kv heads at tp 4
    # (wk / wv joined, each rank's kv head kept), smollm's 3 heads at tp
    # 2 (the attention whole on each rank); both tie the head to the
    # embedding, whose vocab lies over tp
    out.append(("gemma-t4-gpipe", dict(
        kind="grads", ref="gemma-2b", layout=dict(pipe=1, tp=4, data=1),
        pcfg=dict(schedule="gpipe"))))
    out.append(("smollm-td2-1f1b", dict(
        kind="grads", ref="smollm-360m", layout=TD2,
        pcfg=dict(schedule="1f1b"))))
    # the bitwise gates: one AdamW step at pipe 2 x data 2 under each
    # placement of the same weights (FSDP on / off, joined once a step)
    for tag, kw in (("fsdp", {}), ("once", dict(gather_weights_once=True)),
                    ("replicated", dict(fsdp=False))):
        out.append((f"deepseek-pd2-step-{tag}", dict(
            kind="step", ref="deepseek-7b", layout=PD2,
            pcfg=dict(schedule="gpipe", **kw))))
    out.append(("deepseek-pt2-serve", dict(kind="serve", ref="deepseek-7b",
                                           layout=PT2, pcfg={})))
    out.append(("unet-pd2-gpipe", dict(kind="hetero", layout=PD2,
                                       pcfg=dict(schedule="gpipe"))))
    return out


def pcfg_of(case) -> ParallelConfig:
    name = case.get("ref", "smollm-360m")
    return configs.smoke_parallel(name).with_(n_micro=M, **case["layout"],
                                              **case["pcfg"])


def _model(case, view):
    arch = configs.smoke_arch(case["ref"])
    return LMModel(arch, pcfg_of(case), dtype=torch.float32, device="cpu",
                   mesh=view)


def _shards(model, ref):
    """This rank's blocks of the JAX reference's weights."""
    pcfg = model.pcfg
    whole = params_from_jax(ref["params"], arch=model.arch, src_pipe=1,
                            pcfg=pcfg, device="cpu", dtype=torch.float32)
    share = (model.rank_share(whole, model.mesh.pipe.rank) if pcfg.pipe > 1
             else whole)
    return model.shard_params(share)


def _slice(view, batch: Dict[str, np.ndarray]):
    """The replica's rows of a numpy batch, as tensors."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // view.replicas
        out[k] = torch.from_numpy(v[view.replica * n:(view.replica + 1) * n])
    return out


def _common(view, model=None):
    out = {"coords": dict(view.coords), "stats": view.stats()}
    if model is not None:
        out["specs"] = model.specs
    return out


def _grads(case, view, refs):
    ref = refs[case["ref"]]
    model = _model(case, view)
    params = _shards(model, ref)
    loss, grads = steps.build_grad_fn(model, model.pcfg, "cpu")(
        params, _slice(view, ref["batch"]))
    return dict(_common(view, model), loss=loss, grads=dict(tree_items(grads)))


def _step(case, view, refs):
    """One AdamW step; the weights after it joined over the FSDP axes."""
    ref = refs[case["ref"]]
    model = _model(case, view)
    params = _shards(model, ref)
    ocfg = optim.OptimizerConfig(**OCFG)
    step = steps.build_train_step(model, model.pcfg, "cpu",
                                  ShapeConfig("t", 16, 8, "train"), ocfg)
    opt = optim.init(ocfg, params)
    params, opt, metrics = step(params, opt, _slice(view, ref["batch"]))
    return dict(_common(view, model), loss=metrics["loss"],
                grad_norm=metrics["grad_norm"],
                params=dict(tree_items(model.gather_fsdp(params))))


def _serve(case, view, refs):
    """Prefill and one decode step (the reference's greedy token) of the
    JAX serve's prompt; the logits on the last pipe rank."""
    ref = refs[case["ref"]]
    model = _model(case, view)
    pcfg = model.pcfg
    params = model.gather_fsdp(_shards(model, ref))
    B, S = ref["serve"]["tokens"].shape
    dshape = ShapeConfig("d", ref["serve"]["decode_len"], B, "decode")
    prefill = steps.build_prefill_step(model, pcfg, "cpu",
                                       ShapeConfig("p", S, B, "prefill"))
    decode = steps.build_serve_step(model, pcfg, "cpu", dshape)
    pipe = view.pipe
    cache = model.init_cache(dshape, pcfg.n_micro, filled=False,
                             rank=pipe.rank if pipe.size > 1 else None)
    first = pipe.first
    logits, cache = prefill(params, cache,
                            _slice(view, {"tokens": ref["serve"]["tokens"]})
                            if first else None)
    tok = torch.from_numpy(ref["serve"]["token"])
    logits2, cache = decode(params, cache, tok if first else None)
    return dict(_common(view, model), prefill=logits, decode=logits2,
                cache_bytes=sum(a.nbytes for _, a in tree_items(cache)))


def _hetero(case, view, refs):
    """The small U-Net's grad call, each replica on its rows."""
    pcfg = ParallelConfig(n_micro=M, **case["layout"], **case["pcfg"])
    _, prog, stages, x, y = TH.build_problem(UNET, pcfg, batch=UNET_BATCH,
                                             device="cpu", mesh_view=view)
    loss, grads = PH.hetero_grad_call(prog, pcfg, mesh_view=view)(stages, x,
                                                                  y)
    return dict(_common(view), loss=loss,
                grads=dict(tree_items({str(i): g
                                       for i, g in enumerate(grads)})))


RUN = {"grads": _grads, "step": _step, "serve": _serve, "hetero": _hetero}


def run_rank(rank: int, nproc: int, init_method: str, out_dir: str,
             refs_path: str) -> None:
    """One rank of the world: every case on its mesh, saved by name."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    refs = torch.load(refs_path, weights_only=False)
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=nproc)
    out = {}
    try:
        for name, case in cases():
            pcfg = (pcfg_of(case) if "ref" in case
                    else ParallelConfig(**case["layout"]))
            view = mesh.mesh_groups(pcfg, device="cpu", timeout_s=60)
            out[name] = RUN[case["kind"]](case, view, refs)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
