"""Training entry point: the plain loop on synthetic data through the GPipe
clock-cycle with per-micro-batch checkpointing, or through the fused F+B
scheduler (``--schedule 1f1b``, ``gpipe_tasked``, ``interleaved:v``, ``zb``).

Counterpart of :mod:`repro.launch.train`'s loop.  All pipeline stages sit on
the one card given by ``--device`` (the default ``cuda``; ``cpu`` runs the
plain versions of the kernels), in this process or, with ``--nproc N``
(any schedule: gpipe's autograd backward crosses the processes too), one
rank of the ``(pod, data, pipe, tp)`` mesh in each of N spawned
processes joined over gloo (:mod:`repro_torch.launch.mesh`): ``tp`` from
the config, ``--data`` replicas (1 by default),
pipe ``N / (data * tp)``.  In one process the configs run at ``data=1``
and ``tp=1``.  The reference's ``ElasticTrainer`` supervisor (async
checkpoints, injected faults, elastic re-plan) is ROADMAP A11: its flags
raise.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 5 --seq-len 4096 --batch 16 --n-micro 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \\
        --steps 5 --seq-len 4096 --batch 16 --n-micro 8 [--schedule 1f1b]
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 5 --pipe 2 [--schedule 1f1b] [--arch whisper-tiny]
    PYTHONPATH=src python -m repro_torch.launch.train --schedule 1f1b \\
        --nproc 4 --steps 3 --seq-len 4096 --batch 16 --n-micro 8
    PYTHONPATH=src python -m repro_torch.launch.train --schedule gpipe \\
        --nproc 4 --steps 3 --seq-len 4096 --batch 16 --n-micro 8
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import (REMAT_POLICIES, RESIDUAL_MODES,
                                      ArchConfig, ParallelConfig,
                                      ShapeConfig)
from repro_torch.core.pipeline import WIRE_CODEC_RANGE
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,
                                       make_sharded_loader, replica_slice,
                                       to_device)
from repro_torch.devices import resolve_device
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd
from repro_torch.launch import mesh, sharding
from repro_torch.launch import steps as steps_lib
from repro_torch.models.lm import LMModel
from repro_torch.optim import optimizers as optim
from repro_torch.tree import tree_leaves

PEAK_BF16_FLOPS = 989e12        # H100 SXM data sheet, dense tensor cores
# the profiler ranges a traced step reports apart (launch/profile_serve.py)
TRACED_RANGES = (WIRE_CODEC_RANGE, steps_lib.GRAD_COMPRESSION_RANGE)


def launches() -> Dict[str, int]:
    """The training path's kernel launch counters, forward and backward."""
    return {"flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention_bwd.launches,
            "rmsnorm": rmsnorm.launches, "rmsnorm_bwd": rmsnorm_bwd.launches,
            "wkv6": wkv6.launches, "wkv6_bwd": wkv6_bwd.launches}


def stage_kernel_calls(arch: ArchConfig, pcfg: ParallelConfig):
    """Per global stage, the attention, RMSNorm and WKV-6 kernel calls one
    micro-batch's forward makes, and whether the head's norm is an RMSNorm.

    Every slot of the stage's layout runs its layer (an identity-padding
    slot too, gated by its mask).  A dense, vlm, moe, hybrid or enc-dec
    layer: one attention (a hybrid's attention half; the MoE dispatch
    and the SSM scan are plain torch),
    a second on a layer whose ``cross`` flag is set, and its norms (two,
    three with ``cross``) where the arch's norm is RMSNorm (LayerNorm is
    plain torch: no kernel).  An ssm (RWKV-6) layer: one WKV-6 and one
    RMSNorm, its time mix's group norm (its block norms are the arch's)."""
    consts = LMModel(arch, pcfg, device="meta").consts()
    n_stages, per = consts["mask"].shape
    rms = arch.norm == "rms"
    if arch.family == "ssm":
        zero = [0] * n_stages
        return zero, [per * (1 + 2 * int(rms))] * n_stages, [per] * n_stages, rms
    cross = consts.get("cross", np.zeros((n_stages, per), np.float32)) > 0
    attn = [int(per + cross[s].sum()) for s in range(n_stages)]
    norms = [int(rms) * (2 * per + int(cross[s].sum()))
             for s in range(n_stages)]
    return attn, norms, [0] * n_stages, rms


def expected_train_launches(pcfg: ParallelConfig, arch: ArchConfig,
                            seq: int) -> Dict[str, int]:
    """Kernel launches one train step of ``arch`` implies under ``pcfg``
    (m = ``pcfg.n_micro`` micro-batches, nc head-loss chunks of ``seq``):
    the formula ``chip_smoke.py`` and the CPU tests hold the counters of
    :func:`launches` to.  A, N and W are the attention, RMSNorm and WKV-6
    calls of one micro-batch's forward over all stages, A_last, N_last and
    W_last the last stage's (:func:`stage_kernel_calls`); the head adds
    RMSNorms only where its norm is one.  Each kernel's backward runs once
    for each of its forward calls that autograd differentiates.

    ``gpipe`` (autograd backward): every forward call once per micro-batch,
    again for each micro-batch recomputed before its backward (all m with
    remat "full", "dots" or "dots_no_batch", m - 1 without the last when
    ``remat_last_micro`` is False, none with "none"), and once backward; the
    head's norm once per loss chunk forward and again in that chunk's
    recompute (the chunks are always checkpointed) and once backward.  The
    selective policies keep only the outputs of matrix products, which no
    kernel computes: a kernel's outputs are recomputed as under "full", so
    the counts equal "full"'s (``core/checkpointing.py``).

    Fused schedules: each micro-batch runs every stage once on its F tick
    (except the last stage, whose F tick runs nothing), once more for
    each graph a backward tick builds (``graphs``: the fused B; zb's Bx and
    Bw, or Bx alone when Bw differentiates Bx's graph under
    ``residuals="reuse"``), once more in each backward that recomputes the
    stage (zb reuse under a remat policy other than "none": Bx's graph is
    checkpointed) and once backward for each ``autograd.grad`` (``grads``:
    B, or Bx and Bw).  The head runs per micro-batch: its chunks once in
    each graph and once more in each backward (their own recompute); where
    the stage is recomputed as well, that recompute also runs nc - 1 of them
    (PyTorch's nested checkpoint stops early once it holds the last tensor
    it saved).

    So at rwkv6-1.6b's full config (24 layers, pipe 8, m 8, remat "full"):
    384 WKV-6 and 192 backward launches a gpipe step, 360 and 192 a 1F1B
    step; an RMSNorm (the group norm) beside each."""
    from repro_torch.models.lm import head_loss_chunk
    m, nc = pcfg.n_micro, seq // head_loss_chunk(seq)
    attn, norms, wkv, rms_head = stage_kernel_calls(arch, pcfg)
    A, N, W, hn = sum(attn), sum(norms), sum(wkv), int(rms_head)
    base = pcfg.schedule.split(":")[0]
    if base == "gpipe":
        replays = 0 if pcfg.remat == "none" else (
            m if pcfg.remat_last_micro else m - 1)
        return {"flash_attention": A * (m + replays),
                "flash_attention_bwd": A * m,
                "rmsnorm": N * (m + replays) + hn * 2 * nc,
                "rmsnorm_bwd": N * m + hn * nc,
                "wkv6": W * (m + replays), "wkv6_bwd": W * m}
    reuse = base == "zb" and pcfg.residuals == "reuse"
    graphs = 2 if base == "zb" and not reuse else 1
    grads = 2 if base == "zb" else 1
    recomputes = grads if reuse and pcfg.remat != "none" else 0
    runs = 1 + graphs + recomputes
    head = (graphs + grads) * nc + recomputes * (nc - 1)
    return {"flash_attention": (runs * A - attn[-1]) * m,
            "flash_attention_bwd": grads * A * m,
            "rmsnorm": (runs * N - norms[-1]) * m + hn * head * m,
            "rmsnorm_bwd": grads * N * m + hn * grads * nc * m,
            "wkv6": (runs * W - wkv[-1]) * m, "wkv6_bwd": grads * W * m}


def visible_pairs(seq: int, window: int) -> int:
    """(query, key) pairs causal attention over ``seq`` positions sees
    under ``window`` (0 = unlimited): the sum over i of min(i + 1, w)."""
    w = window if 0 < window < seq else seq
    return w * (w + 1) // 2 + (seq - w) * w


def model_flops_per_step(arch: ArchConfig, seq_len: int, batch: int) -> float:
    """Model FLOPs of one training step (recompute not counted): 3 x the
    forward, whose FLOPs are 2 per matmul weight per token plus what is not
    a weight product.

    dense, vlm, moe, hybrid and enc-dec: the attention projections, the MLP
    (three matrices for SwiGLU and GeGLU, two for GELU; a moe layer's
    top_k experts of three matrices each and its router, d x E), a hybrid
    layer's SSM projections (``w_in``, ``w_bc``, ``w_dt``, ``w_out``), an
    enc-dec decoder's cross-attention projections and the head, tied or
    not; plus the attention products, 2 x 2 x hd x Hq per visible (query,
    key) pair: :func:`visible_pairs` a sequence for causal self-attention
    under each layer's window (``blocks.layer_windows``), S x S for an
    encoder's self-attention and a decoder's cross-attention (the memory
    has S frames); and a hybrid layer's scan, 2 x 2 x hd x N a token and
    head (the state update and the read, as two products).

    ssm (RWKV-6): per layer the time mix's five D x D projections (r, k, v,
    the gate g and the output), its decay LoRA (D x 64 and 64 x D), the
    channel mix's D x F, F x D and D x D, and the head; plus the WKV
    recurrence, 2 x 2 x K x V per token and head (the read ``r (S + u k v)``
    and the state update ``diag(w) S + k v``, as two products)."""
    from repro_torch.models.blocks import (RWKV_HEAD, RWKV_LORA,
                                           layer_windows)
    from repro_torch.models.layers import ssm_heads
    d, f, tokens = arch.d_model, arch.d_ff, seq_len * batch
    if arch.family == "ssm":
        layer = 5 * d * d + 2 * d * RWKV_LORA + 2 * d * f + d * d
        weights = arch.n_layers * layer + d * arch.vocab
        recurrence = arch.n_layers * (d // RWKV_HEAD) * 2 * 2 \
            * RWKV_HEAD * RWKV_HEAD * tokens
        return 3.0 * (2.0 * weights * tokens + recurrence)
    a = arch.attn
    enc, dec = arch.enc_layers, arch.n_layers
    attn_w = d * a.head_dim * 2 * (a.n_heads + a.n_kv_heads)
    if arch.moe is not None:
        mlp_w = arch.moe.top_k * 3 * d * f + d * arch.moe.n_experts
    else:
        mlp_w = (3 if arch.act in ("silu", "geglu") else 2) * d * f
    scan = 0
    if arch.family == "hybrid":
        s = arch.ssm
        H = ssm_heads(d, s)
        mlp_w += d * H * (2 * s.head_dim + 2 * s.state_dim + 1)
        scan = dec * H * 2 * 2 * s.head_dim * s.state_dim * tokens
    cross = dec if arch.is_encdec else 0
    weights = (enc + dec) * (attn_w + mlp_w) + cross * attn_w \
        + d * arch.vocab
    windows = layer_windows(arch, enc + dec)[enc:]
    pairs = sum(visible_pairs(seq_len, int(w)) for w in windows) \
        + (enc + cross) * seq_len ** 2
    attn = batch * 2 * 2 * a.head_dim * a.n_heads * pairs
    return 3.0 * (2.0 * weights * tokens + attn + scan)


def model_batch(batch: Dict[str, torch.Tensor], dtype: torch.dtype
                ) -> Dict[str, torch.Tensor]:
    """A batch with its float leaves (an enc-dec's ``frames``, a vision
    stub's ``patches``) in the model dtype; token ids stay."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in batch.items()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def placement_bytes(model: LMModel, *, with_ef: bool = False,
                    state_bytes: int = 12) -> int:
    """Bytes the placement gives this mesh rank of the weights and their
    AdamW state (``state_bytes`` a parameter: two fp32 moments and the
    fp32 master; and the fp32 error-feedback residual with ``with_ef``):
    each leaf's block, counted from the whole tree's shapes on the meta
    device."""
    pipe = model.mesh.pipe
    meta = LMModel(model.arch, model.pcfg, dtype=model.dtype, device="meta")
    share = meta.init(torch.Generator(),
                      rank=pipe.rank if pipe.size > 1 else None)
    total = 0
    for leaf, spec in zip(tree_leaves(share), tree_leaves(model.specs)):
        n = 1
        for d in sharding.local_shape(tuple(leaf.shape), spec,
                                      model.mesh.shape):
            n *= d
        total += n * (leaf.element_size() + state_bytes + 4 * with_ef)
    return total


def train(arch: ArchConfig, pcfg: ParallelConfig, *, seq_len: int, batch: int,
          steps: int, device="cuda", dtype=torch.bfloat16, seed: int = 0,
          ocfg: Optional[optim.OptimizerConfig] = None,
          fixed_batch: bool = False, trace: bool = False,
          mesh_view: Optional[mesh.MeshView] = None) -> Dict[str, Any]:
    """Train ``steps`` steps from random weights (``seed``) on
    :class:`SyntheticLM` batches (``seed``; an enc-dec's hold ``frames``,
    ``dec_tokens`` and ``labels``, a vision stub's also 256 ``patches``),
    or on its first batch every step with
    ``fixed_batch``.  Returns one record per step (its metrics as
    floats, ``step_s`` on the host clock around the synchronized step, and
    the kernel launches of that step), the executor's buffer high-water
    per rank (``park_info``, from the last step), the bytes of the
    optimizer's error-feedback residual (``ef_bytes``: 0 unless
    ``pcfg.grad_compression="int8_ef"``) and, on a card, the peak
    memory.
    ``trace`` (a card only) runs one step more under the profiler and
    returns its device time by kernel family, the card's idle share and
    the device time and kernels of the wire codec and of the gradient
    compressor (``TRACED_RANGES``) as ``trace``; that step is not in
    ``history``.

    On a mesh (``mesh_view``, :func:`repro_torch.launch.mesh.
    init_mesh_groups`, or a pipe group's, :func:`~repro_torch.launch.mesh.
    init_pipe_group`; any schedule) this process trains its rank's blocks
    on ``mesh_view.device`` (``device`` is ignored), on its replica's
    slice of every batch (``make_sharded_loader``): each record's metrics
    are the mesh's (the mean loss over the replicas, one grad norm) and
    its ``step_s`` and launches this rank's, and ``park_info`` is this
    rank's (its ``buffer_slots`` and per-class ``hops``).  Every rank also
    reports ``resident_bytes`` (its weights and optimizer state as they
    lie), ``placement_bytes`` (the placement's count of them) and
    ``collectives`` (per class: calls, bytes and host-clock wait, over
    all the steps), and gets ``ranks``: per rank of the world those, its
    ``peak_mem_bytes`` (on a card), ``park_info`` and ``step_s``."""
    dev = resolve_device(device) if mesh_view is None else mesh_view.device
    if trace and (dev.type != "cuda" or mesh_view is not None):
        raise ValueError("trace profiles the card from one process: pass a "
                         "CUDA device and no pipe group")
    ocfg = ocfg or optim.OptimizerConfig()
    shape = ShapeConfig("train", seq_len, batch, "train")
    model = LMModel(arch, pcfg, dtype=dtype, device=dev, mesh=mesh_view)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    with_ef = pcfg.grad_compression == "int8_ef"
    opt = optim.init(ocfg, params, with_ef=with_ef)
    step = steps_lib.build_train_step(model, pcfg, model.stage_devices, shape,
                                      ocfg)
    data = DataConfig(seed=seed, vocab=arch.vocab, seq_len=seq_len,
                      global_batch=batch)
    loader = None
    rep = (0, 1) if mesh_view is None else (mesh_view.replica,
                                            mesh_view.replicas)
    if fixed_batch:
        batches = itertools.repeat(model_batch(to_device(replica_slice(
            SyntheticLM(data, arch).batch_at(0), *rep), dev), dtype))
    else:
        loader = make_sharded_loader(data, dev, *rep, arch)
        batches = (model_batch(b, dtype) for b in loader)
    if mesh_view is not None:
        mesh_view.reset_stats()
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
            traced = device_profile(lambda: step(params, opt, b), dev,
                                    ranges=TRACED_RANGES)
            l1 = launches()
            traced["launches"] = {k: l1[k] - l0[k] for k in l0}
    finally:
        if loader is not None:
            loader.close()
    out = {"history": history, "n_micro": pcfg.n_micro,
           "park_info": dict(step.park_info),
           "ef_bytes": (0 if opt.ef == ()
                        else sum(e.nbytes for e in tree_leaves(opt.ef))),
           "tokens_per_step": seq_len * batch,
           "model_flops_per_step": model_flops_per_step(arch, seq_len, batch)}
    if dev.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    if trace:
        out["trace"] = traced
    if mesh_view is not None:
        out["collectives"] = mesh_view.stats()
        kept = [params, opt.mu, opt.nu, opt.master] + ([opt.ef] if with_ef
                                                       else [])
        out["resident_bytes"] = sum(a.nbytes for t in kept
                                    for a in tree_leaves(t))
        out["placement_bytes"] = placement_bytes(model, with_ef=with_ef)
        import torch.distributed as dist
        mine = {k: out[k] for k in ("park_info", "peak_mem_bytes",
                                    "collectives", "resident_bytes",
                                    "placement_bytes") if k in out}
        mine["step_s"] = [rec["step_s"] for rec in history]
        out["ranks"] = [None] * dist.get_world_size()
        dist.all_gather_object(out["ranks"], mine)
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
    ap.add_argument("--schedule", default="gpipe",
                    help="gpipe (autograd backward), or a fused F+B "
                         "schedule: gpipe_tasked, 1f1b, interleaved:v, zb")
    ap.add_argument("--residuals", default="recompute",
                    choices=RESIDUAL_MODES,
                    help="zb: re-run the stage in Bw, or keep Bx's graph")
    ap.add_argument("--grad-reduce", default="ordered",
                    choices=("ordered", "running"),
                    help="fused schedules: fold micro-batch gradients in "
                         "micro order or in schedule order")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--constant-lr", action="store_true",
                    help="no warmup and no decay (chip_smoke.py's train "
                         "phases); default: warmup over min(20, steps), "
                         "cosine to 0.1 lr")
    ap.add_argument("--fixed-batch", action="store_true",
                    help="train on the first batch every step")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", action="store_true",
                    help="profile one more step: device ms by kernel family")
    ap.add_argument("--nproc", type=int, default=0,
                    help="run each rank of the (data, pipe, tp) mesh in its "
                         "own process, over gloo: the world size (pipe = "
                         "nproc / (data * tp); any schedule, gpipe "
                         "included)")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel replicas of the --nproc mesh")
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

    arch, pcfg, dtype = mesh_config(args, args.pipe)
    shape = ShapeConfig("train", args.seq_len, args.batch, "train")
    pcfg = pcfg.with_(remat=args.remat, schedule=args.schedule,
                      residuals=args.residuals, grad_reduce=args.grad_reduce)
    pcfg = pcfg.with_(n_micro=args.n_micro
                      or configs.derive_n_micro(shape, pcfg))
    sched = (dict(warmup_steps=0, min_lr_ratio=1.0) if args.constant_lr
             else dict(warmup_steps=min(20, args.steps)))
    ocfg = optim.OptimizerConfig(lr=args.lr, total_steps=args.steps,
                                 dynamic_loss_scale=not args.smoke, **sched)
    dev = resolve_device(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    procs = (f" in {args.nproc} processes (gloo)" if args.nproc else "")
    print(f"[train] {arch.name}: data={pcfg.data} pipe={pcfg.pipe} "
          f"tp={pcfg.tp} m={pcfg.n_micro} "
          f"schedule={pcfg.schedule} remat={pcfg.remat} "
          f"seq={args.seq_len} batch={args.batch} "
          f"{str(dtype).split('.')[-1]} on {where}{procs}", flush=True)
    job = dict(arch=arch, pcfg=pcfg, seq_len=args.seq_len, batch=args.batch,
               steps=args.steps, dtype=dtype, seed=args.seed, ocfg=ocfg,
               fixed_batch=args.fixed_batch, trace=args.trace)
    if not args.nproc:
        _report(train(device=dev, **job), dev)
        return
    if dev.type == "cuda":        # once here, not once in every rank
        from repro_torch.kernels import build
        build.build_all()
    # no overall deadline: a hang fails at the group's wait timeout, a
    # rank that raises fails the group
    mesh.spawn(_rank_main, args.nproc, (args.device, job), timeout_s=None)


def mesh_config(args, pipe: int = 0):
    """``(arch, pcfg, dtype)`` of the CLI's flags: the smoke arch in fp32 or
    the full one in bf16; in one process data and tp 1, with ``--nproc``
    the config's tp, ``--data`` replicas and pipe the rest of the world.
    ``pipe`` (the train CLI's ``--pipe``; 0: none) overrides the config's
    pipe degree in one process and must agree with the world's."""
    if args.smoke:
        arch = configs.smoke_arch(args.arch)
        pcfg = configs.smoke_parallel(args.arch)
        dtype = torch.float32
    else:
        arch = configs.get_arch(args.arch)
        pcfg = configs.get_parallel(args.arch)
        dtype = torch.bfloat16
    pcfg = pcfg.with_(pod=1, dp2=1, data=args.data,
                      tp=pcfg.tp if args.nproc else 1)
    if not args.nproc:
        if args.data != 1:
            raise ValueError("--data needs --nproc: one process a rank")
        return arch, pcfg.with_(pipe=pipe or pcfg.pipe), dtype
    if args.nproc % (pcfg.data * pcfg.tp):
        raise ValueError(f"--nproc {args.nproc} is not a mesh of data "
                         f"{pcfg.data} x tp {pcfg.tp}")
    world_pipe = args.nproc // (pcfg.data * pcfg.tp)
    if pipe not in (0, world_pipe):
        raise ValueError(f"--nproc {args.nproc} at data {pcfg.data} and tp "
                         f"{pcfg.tp} runs pipe {world_pipe}, not --pipe "
                         f"{pipe}")
    return arch, pcfg.with_(pipe=world_pipe), dtype


def _rank_main(rank: int, nproc: int, init_method: str, device: str,
               job: Dict[str, Any]) -> None:
    """One rank of ``--nproc``: join the mesh, train, and on rank 0 print
    the world's records."""
    view = mesh.init_mesh_groups(rank, nproc, init_method, job["pcfg"],
                                 device=device)
    try:
        res = train(mesh_view=view, **job)
        if rank == 0:
            _report(res, view.device)
    finally:
        mesh.destroy_pipe_group(view.pipe)


def _report(res: Dict[str, Any], dev: torch.device) -> None:
    for i, rec in enumerate(res["history"]):
        print(f"[train] step {i} loss {rec['loss']:.4f} grad_norm "
              f"{rec['grad_norm']:.4f} skipped {int(rec['skipped'])} "
              f"{rec['step_s'] * 1e3:.1f} ms "
              f"({res['tokens_per_step'] / rec['step_s']:.0f} tok/s)",
              flush=True)
    last = res["history"][-1]
    print(f"[train] kernel launches per step {last['launches']}")
    if "ranks" in res:
        for r, rec in enumerate(res["ranks"]):
            peak = (f"peak memory {rec['peak_mem_bytes'] / 2**30:.2f} GiB, "
                    if "peak_mem_bytes" in rec else "")
            slots = rec["park_info"].get("buffer_slots")
            mem = (f"resident {rec['resident_bytes']} B (placement "
                   f"{rec['placement_bytes']} B), "
                   if "resident_bytes" in rec else "")
            print(f"[train] rank {r}: {peak}{mem}"
                  f"buffer high-water {slots}, "
                  f"hops {json.dumps(rec['park_info'].get('hops'))}, "
                  f"collectives {json.dumps(rec.get('collectives'))}")
    else:
        print(f"[train] buffer high-water per rank {res['park_info']}")
    if dev.type == "cuda" and "ranks" not in res:
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
