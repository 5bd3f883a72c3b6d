"""Training entry point: the plain loop on synthetic data through the GPipe
clock-cycle with per-micro-batch checkpointing.

Counterpart of :mod:`repro.launch.train`'s loop.  All pipeline stages sit on
the one card given by ``--device`` (the default ``cuda``; ``cpu`` runs the
plain versions of the kernels); the full configs run with ``data=1`` and
``tp=1``.  The reference's ``ElasticTrainer`` supervisor (async checkpoints,
injected faults, elastic re-plan) is ROADMAP A11: its flags raise.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 5 --seq-len 4096 --batch 16 --n-micro 8
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 5 --pipe 2
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import time
from typing import Any, Dict, Optional

import torch

from repro_torch import configs
from repro_torch.configs.base import (REMAT_POLICIES, ArchConfig,
                                      ParallelConfig, ShapeConfig)
from repro_torch.data.pipeline import (DataConfig, SyntheticLM, make_loader,
                                       to_device)
from repro_torch.devices import resolve_device
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
from repro_torch.launch import steps as steps_lib
from repro_torch.models.lm import LMModel
from repro_torch.optim import optimizers as optim

PEAK_BF16_FLOPS = 989e12        # H100 SXM data sheet, dense tensor cores


def launches() -> Dict[str, int]:
    """The training path's kernel launch counters, forward and backward."""
    return {"flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention_bwd.launches,
            "rmsnorm": rmsnorm.launches, "rmsnorm_bwd": rmsnorm_bwd.launches}


def model_flops_per_step(arch: ArchConfig, seq_len: int, batch: int) -> float:
    """Model FLOPs of one training step of a dense decoder (recompute not
    counted): 3 x the forward, whose FLOPs are 2 per matmul weight per token
    (attention projections, MLP and the head; tied or not) plus the causal
    attention products, 2 x 2 x hd x Hq x S (S + 1) / 2 per layer and
    sequence."""
    a, d = arch.attn, arch.d_model
    per_layer = d * a.head_dim * 2 * (a.n_heads + a.n_kv_heads) + 3 * d * arch.d_ff
    weights = arch.n_layers * per_layer + d * arch.vocab
    tokens = seq_len * batch
    attn = arch.n_layers * batch * 2 * a.head_dim * a.n_heads * seq_len * (seq_len + 1)
    return 3.0 * (2.0 * weights * tokens + attn)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(arch: ArchConfig, pcfg: ParallelConfig, *, seq_len: int, batch: int,
          steps: int, device="cuda", dtype=torch.bfloat16, seed: int = 0,
          ocfg: Optional[optim.OptimizerConfig] = None,
          fixed_batch: bool = False, trace: bool = False) -> Dict[str, Any]:
    """Train ``steps`` steps from random weights (``seed``) on
    :class:`SyntheticLM` batches (``seed``), or on its first batch every step
    with ``fixed_batch``.  Returns one record per step (its metrics as
    floats, ``step_s`` on the host clock around the synchronized step, and
    the kernel launches of that step) and, on a card, the peak memory.
    ``trace`` (a card only) runs one step more under the profiler and
    returns its device time by kernel family and the card's idle share as
    ``trace``; that step is not in ``history``."""
    dev = resolve_device(device)
    if trace and dev.type != "cuda":
        raise ValueError("trace profiles the card: pass a CUDA device")
    ocfg = ocfg or optim.OptimizerConfig()
    shape = ShapeConfig("train", seq_len, batch, "train")
    model = LMModel(arch, pcfg, dtype=dtype, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    opt = optim.init(ocfg, params)
    step = steps_lib.build_train_step(model, pcfg, model.stage_devices, shape,
                                      ocfg)
    data = DataConfig(seed=seed, vocab=arch.vocab, seq_len=seq_len,
                      global_batch=batch)
    loader = None
    if fixed_batch:
        batches = itertools.repeat(to_device(SyntheticLM(data).batch_at(0), dev))
    else:
        batches = loader = make_loader(data, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    history = []
    try:
        for _ in range(steps):
            b = next(batches)
            l0 = launches()
            _sync(dev)
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, b)
            rec = {k: float(v) for k, v in metrics.items()}   # waits for it
            rec["step_s"] = time.perf_counter() - t0
            l1 = launches()
            rec["launches"] = {k: l1[k] - l0[k] for k in l0}
            history.append(rec)
        if trace:
            from repro_torch.launch.profile_serve import device_profile
            b = next(batches)
            l0 = launches()
            traced = device_profile(lambda: step(params, opt, b), dev)
            l1 = launches()
            traced["launches"] = {k: l1[k] - l0[k] for k in l0}
    finally:
        if loader is not None:
            loader.close()
    out = {"history": history, "n_micro": pcfg.n_micro,
           "tokens_per_step": seq_len * batch,
           "model_flops_per_step": model_flops_per_step(arch, seq_len, batch)}
    if dev.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    if trace:
        out["trace"] = traced
    return out


def _elastic_flags(args) -> list:
    return [f for f in ("ckpt_dir", "ckpt_every", "fail_at", "shrink_at",
                        "poison_at") if getattr(args, f) is not None]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced arch in fp32 (the default: full, bf16)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--pipe", type=int, default=0,
                    help="override the config's pipe degree")
    ap.add_argument("--n-micro", type=int, default=0,
                    help="micro-batches (0: derived from batch and pipe)")
    ap.add_argument("--remat", default="full", choices=REMAT_POLICIES)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", action="store_true",
                    help="profile one more step: device ms by kernel family")
    # the reference's ElasticTrainer flags (ROADMAP A11)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int)
    ap.add_argument("--fail-at", type=int, nargs="*")
    ap.add_argument("--shrink-at", nargs="*")
    ap.add_argument("--poison-at", type=int, nargs="*")
    args = ap.parse_args()
    if _elastic_flags(args):
        raise NotImplementedError(
            f"{_elastic_flags(args)}: checkpoints, fault injection and "
            "elastic restarts (ElasticTrainer) are not ported yet: ROADMAP A11")

    if args.smoke:
        arch = configs.smoke_arch(args.arch)
        pcfg = configs.smoke_parallel(args.arch)
        dtype = torch.float32
    else:
        arch = configs.get_arch(args.arch)
        pcfg = configs.get_parallel(args.arch).with_(data=1, tp=1)
        dtype = torch.bfloat16
    if args.pipe:
        pcfg = pcfg.with_(pipe=args.pipe)
    shape = ShapeConfig("train", args.seq_len, args.batch, "train")
    pcfg = pcfg.with_(remat=args.remat, n_micro=args.n_micro
                      or configs.derive_n_micro(shape, pcfg))
    ocfg = optim.OptimizerConfig(lr=args.lr, warmup_steps=min(20, args.steps),
                                 total_steps=args.steps,
                                 dynamic_loss_scale=not args.smoke)
    dev = resolve_device(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"[train] {arch.name}: pipe={pcfg.pipe} m={pcfg.n_micro} "
          f"remat={pcfg.remat} seq={args.seq_len} batch={args.batch} "
          f"{str(dtype).split('.')[-1]} on {where}", flush=True)
    res = train(arch, pcfg, seq_len=args.seq_len, batch=args.batch,
                steps=args.steps, device=dev, dtype=dtype, seed=args.seed,
                ocfg=ocfg, trace=args.trace)
    for i, rec in enumerate(res["history"]):
        print(f"[train] step {i} loss {rec['loss']:.4f} grad_norm "
              f"{rec['grad_norm']:.4f} skipped {int(rec['skipped'])} "
              f"{rec['step_s'] * 1e3:.1f} ms "
              f"({res['tokens_per_step'] / rec['step_s']:.0f} tok/s)",
              flush=True)
    last = res["history"][-1]
    print(f"[train] kernel launches per step {last['launches']}")
    if dev.type == "cuda":
        share = res["model_flops_per_step"] / last["step_s"] / PEAK_BF16_FLOPS
        print(f"[train] peak memory {res['peak_mem_bytes'] / 2**30:.2f} GiB; "
              f"model FLOPs share of the bf16 peak {share:.4f}")
    if "trace" in res:
        print(f"[train] traced step {json.dumps(res['trace'])}")
    losses = [rec["loss"] for rec in res["history"]]
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"non-finite loss: {losses}")


if __name__ == "__main__":
    main()
