#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (``src/repro_torch``): the quickest
proof that the port builds, agrees with itself, serves and trains on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases (each prints JSON lines and then a ``phase_done`` line with its
seconds; any failure raises, so the exit code is non-zero and no result
line is printed):

1. device   the card's name and ``nvidia-smi`` name / power limit;
2. build    the three CUDA sources from ``src/repro_torch/kernels/csrc``
            with ``nvcc`` for sm_90a, in parallel; per kernel function, the
            count of wgmma (HGMMA) and mma.sync (HMMA) instructions in the
            SASS: the bf16 attention forward, dQ and dK/dV kernels (the
            head_dim-256 backward's own two among them) must hold HGMMA
            (the backward ones no HMMA), the chunked WKV passes HMMA
            (the backward's chunk pass too); each kernel's registers and
            spills (no WKV or backward kernel, the WKV-6 backward's among
            them, may spill) and any wgmma that ptxas serialised;
3. kernels  each kernel against its plain PyTorch version on the card over
            a grid of shapes (RMSNorm, forward and backward, at the row
            counts both training paths give it; WKV in both its chunked and
            its serial form,
            with masked tails and decays that underflow to 0; attention
            at head_dim 64, 128 and 256 (gemma-2b's: causal, non-causal
            and windowed, MQA 8:1 and MHA, both dtypes), windowed GQA at
            mixtral's (D 128, 32:8, window 4,096), hymba's (D 64, 25:5,
            window 1,024) and a D-128 window shorter than S, and at the
            training path's q [2,15,4096,64] with the lse the
            backward reads; RMSNorm also at D 1,600, 4,096 and 6,144),
            then timed at
            the serving paths' shapes beside its plain version and one
            library call where PyTorch has one (the yardstick only); RMSNorm
            at both paths' widths (960 and 2048); attention also at
            whisper-tiny's training call, q [2,6,4096,64], non-causal and
            causal, gemma-2b's q [2,8,4096,256] (kv 1 head, causal),
            deepseek-7b's prefill q [1,32,2048,128] and the training calls
            of mixtral-8x7b (q [2,32,4096,128], kv 8, window 4,096) and
            hymba-1.5b (q [2,25,4096,64], kv 5, window 1,024), each beside
            SDPA at the same mask; RMSNorm at D 1,600 and 4,096; WKV also
            at one
            decode step and at rwkv6's training call [2,32,4096,64], and
            by kernel from a profiler trace;
   backward the attention and RMSNorm backward kernels against their plain
            versions over a grid that holds the training path's shapes, and
            again at every timed shape, the bf16 attention backward twice
            at smollm's and gemma-2b's training calls (bitwise equal), the
            autograd checks (the
            Functions' outputs carry a grad_fn, WKV-6's too); the WKV-6
            backward through its Function against autograd through the
            plain version, every gradient (dr, dk, dv, dw, du, ds0), H 32,
            over T 1, 16, 64, 65, 100, 130, 256 (both forms, forward and
            backward: bf16 with T >= 64 chunked, masked tails), decays
            that underflow to w = 0, a random s0, with and without a
            cotangent on the final state, and at rwkv6's training call
            [2,32,4096,64] bf16, then timed there beside its bound and by
            kernel, and run twice there (bitwise equal); then the
            attention and RMSNorm backwards
            (RMSNorm also at rwkv6's [2,4096,2048])
            timed beside the bound and the PyTorch call that computes the
            same backward (SDPA's, F.rms_norm's: yardsticks only), with the
            achieved TFLOP/s and the bound's share of the time; the
            attention backward also at whisper-tiny's q [2,6,4096,64],
            non-causal and causal, at mixtral's and hymba's training calls
            (the grid holds their windows and heads too; RMSNorm at
            [2,4096,1600] and [2,4096,4096]), and at gemma-2b's q
            [2,8,4096,256] (its grid holds head_dim 256 too), there also
            by kernel
            (delta, dK / dV, the q-head slices' sum, dQ) from a profiler
            trace;
4. port     the same weights through the kernels on the card and through
            the plain versions on the CPU, prefill + 4 decode steps, logits
            compared: smollm-360m at full width, 4 layers, pipe 2, fp32;
            rwkv6-1.6b at full width, 2 layers, pipe 2, fp32; and training:
            smollm-360m at full width, 4 layers, and rwkv6-1.6b at full
            width, 2 layers (tp 1), pipe 2, seq 256, fp32, the
            GPipe loss and every gradient leaf compared (each leaf also
            within 1e-4 of its own largest entry); then the fused F+B
            executor the same way (``train_fused_gpu_vs_cpu``, smollm-360m
            cut to 4 layers, batch 4, so every virtual stage of
            interleaved:2 holds a layer):
            1f1b (m 2), zb with residuals "reuse" under remat "none" and
            "full" (m 4) and interleaved:2 (m 2), and 1f1b against
            gpipe_tasked on the card, bitwise equal but for the embedding's
            leaf; then gemma-2b at full width, 2 layers, pipe 2, fp32
            (prompt and seq 256): serving and the GPipe loss and every
            gradient, where the fp32 head_dim-256 kernels meet the CPU;
            mixtral-8x7b (prompt and seq 128) and hymba-1.5b the same way,
            where the MoE dispatch, the SSM scan and the windowed D-128 and
            D-64 kernels meet the CPU (weights drawn on the card, gaps
            taken on the card);
5. serve    the main paths, each with the launch counters set to 0 just
            before it and read just after, through
            ``repro_torch.launch.serve.serve`` on one card with batch 8
            (m = 8), prompt 2048 and 32 generated tokens: smollm-360m, all
            32 layers, bf16, pipe 16, data 1; rwkv6-1.6b, all 24 layers,
            bf16, pipe 8, tp 1, data 1; gemma-2b (18 layers, pipe 2),
            deepseek-7b cut to 15 layers in 16 slots (pipe 16: a padded
            layout), pixtral-12b cut to 24 layers (pipe 8, 256 patch
            embeddings a prompt), llama3-405b
            at full width cut to 4 layers (pipe 4), mixtral-8x7b cut to 16
            layers (pipe 8), dbrx-132b cut to 4 (pipe 4) and hymba-1.5b
            cut to 16 layers (pipe 8, per-layer windows), tp 1.  The counters
            must equal what each path implies;
6. train    the training main path with the counters set to 0 just before
            and read just after, through ``repro_torch.launch.train.train``:
            smollm-360m, all 32 layers, bf16, pipe 16, data 1, seq 4096,
            batch 16 (m = 8), remat "full", AdamW at a constant lr, 5 steps
            on one fixed batch and a sixth under the profiler: finite loss
            and grad norm, the step-5 loss below step 1's, each step's
            launches equal to the path's formulas; step ms, tokens/s, the
            model-FLOPs share and the traced step's device ms by kernel
            family and idle share; then the same cell through the fused
            executor with schedule "1f1b" (``train_fused``), whose park
            high-water per rank must also equal the plan's; then
            rwkv6-1.6b the same way (``rwkv6_train``: all 24 layers, pipe
            8, tp 1, gpipe and 1f1b), with the WKV-6 backward's share of
            the traced step's device time; then gemma-2b the same way (18
            layers, pipe 2, tp 1: ``train`` and ``train_fused`` records
            with ``"arch": "gemma-2b"``), mixtral-8x7b (2 layers, pipe 2,
            lr 5e-5, a workaround: ``TRAIN_LR``) and hymba-1.5b (16 of
            its 32 layers, pipe 8: its global layers 0 and 15 and the
            windowed ones between; 3 steps and a traced fourth:
            ``TRAIN_STEPS``) the same way, and
            ``fused_bitwise``: one grad
            call of gemma-2b at that size through 1f1b and through
            gpipe_tasked under deterministic algorithms, the loss and
            every gradient bitwise equal;
7. memory   peak device memory of one train step under remat "full",
            "dots", "dots_no_batch" and "none" (all 32 layers, seq 4096,
            batch 4, m 4, where "none" fits on the card): each selective
            policy must lie between "full" and "none";
8. hetero_gpu_vs_cpu  the heterogeneous pipelines (paper §4.2) with skip
            routes, the port against itself: U-Net (1, 8), 4 levels at
            64 x 64 and AmoebaNet (6, 32) at 64 x 64, pipe 4, batch 8, m 4,
            fp32 with TF32 off and deterministic cuDNN: the forward, the
            loss and every gradient leaf of gpipe, gpipe_tasked, 1f1b, zb
            (reuse, remat "full") and interleaved:2 on the card vs the CPU;
            portals vs threaded skips and gpipe_tasked vs 1f1b bitwise
            equal on the card;
9. hetero_train  the hetero main path, counters set to 0 just before and
            read just after (it launches none of the port's kernels):
            U-Net (5, 64) at 192 x 192, batch 32 and AmoebaNet-D (18, 256)
            at 224 x 224, batch 64, pipe 8, m 8, fp32 (TF32 off), remat
            "full", portals, SGD with momentum 0.9, through gpipe and 1f1b:
            5 steps on one fixed batch and a sixth under the profiler;
            finite losses, step 5's below step 1's, park and route
            high-water equal to the plan's; step ms, samples/s, counted
            fp32 TFLOP/s, peak memory, device ms by kernel family, idle
            share;
10. hetero_memory  peak memory of one U-Net (5, 64) gpipe step under remat
            "full" and "none" at the largest batch at which "none" fits:
            "full" must be the lower;
11. whisper_gpu_vs_cpu  the encoder-decoder, the port against itself:
            whisper-tiny at full width, all 8 blocks, pipe 4, seq 256, fp32
            (TF32 off): the loss and every gradient leaf of gpipe, 1f1b, zb
            (reuse, remat "full") and interleaved:2 on the card vs the CPU,
            the encoder layers' cross-attention gradients exactly 0, 1f1b
            vs gpipe_tasked bitwise on the card; prefill and 4 decode
            steps' logits;
12. serve (whisper-tiny)  the serving main path as in 5: all 8 blocks,
            bf16, pipe 8, tp 1, batch 8 (m 8), 2048 frames and a 2048-token
            prompt, 32 generated tokens;
13. whisper_train  the training main path as in 6 for whisper-tiny: pipe
            8, seq 4096, batch 16 (m 8), remat "full", AdamW, gpipe and
            1f1b; the park and route high-water (``mem`` 3 -> (4, 5, 6, 7),
            ``dec_in`` 0 -> 4) must equal the plan's;
14. stream  stream injection on whisper-tiny at that size, with
            deterministic algorithms on: streamed against replicated at
            pipe 8 and at PARALLEL_OPTIMIZED's pipe 2 (four micro-batches a
            rank, rotated), gpipe and 1f1b: the loss and every gradient
            bitwise equal, the stream stash high-water equal to the plan's;
            5 train steps of 1f1b at pipe 8, losses and grad norms bitwise
            equal (gpipe's streaming is held by its grad calls); the
            prefill's logits bitwise equal;
15. wire    the wire codec, 1f1b at pipe 8, 5 steps and a traced sixth
            under fp32, bf16 (bitwise equal to fp32 on this bf16 model),
            int8-ef and chain=fp32,portal=int8-ef,cotangent=bf16 (each
            curve within 5% of fp32's and falling); the codec's device ms
            and kernels from the trace, the plan's wire bytes per class;
            gpipe with int8-ef raises;
16. grad_compression  the same cell with int8 error-feedback gradient
            compression: its curve within 5% of the uncompressed one and
            falling, the residual's bytes, the peak, step ms and the
            compressor's device ms;
17. dist_train  stages in their own processes: four pipe ranks spawned on
            the one card (gloo; every hop crosses pinned host memory), one
            group for every case of this phase and of ``dist_serve`` (one
            spawn, after the single-process runs of both): smollm-360m at full width and depth (32
            layers, seq 4096, batch 16, m 8, remat "full", bf16), pipe 4,
            1f1b under the spmd and the mpmd send discipline and
            gpipe_tasked under spmd, a grad call and 3 AdamW steps each,
            and gpipe streamed (the shards rotate as values, rank 0 takes
            their cotangents into its own inputs), a grad call;
            whisper-tiny (all 8 blocks), pipe 4, 1f1b, streamed, int8-ef
            wire, its portal routes, a grad call.  Against the
            single-process run of each config, seed and batch on the card
            (deterministic algorithms in both): the loss and the SHA-256
            of every gradient leaf equal, mpmd equal to spmd, each rank's
            buffer high-water equal to ``plan.specialize``'s, the hops and
            bytes per payload class equal to ``plan_wire_report``'s, the
            launches summed over the ranks equal to the path's formulas,
            the two embedding copies equal after the steps, the losses
            finite and falling; per-rank peak memory beside one process's,
            step and hop-wait ms on the host clock ("4 processes
            time-slicing one card").  A rank that fails or hangs fails the
            phase with its traceback.  Also in that group: smollm-360m
            through gpipe (autograd's reverse clock-cycle across the
            ranks, the hops carrying their cotangents back) and the U-Net
            (5, 64) at 192 x 192, batch 32, pipe 4, m 8, fp32, gpipe with
            its portals, through ``launch.train_hetero`` (a grad call and
            3 SGD steps), each against one process: the loss, every
            gradient's SHA-256 and the step-1 loss equal, the park and
            route high-water equal to the forward plan's, one cotangent
            hop for each chain and portal hop;
18. dist_serve  serving with one process per pipe rank: the four ranks of
            ``dist_train``'s group, each holding its own stages' weights and caches,
            through ``launch.serve.serve(mesh_view=)``: smollm-360m and
            rwkv6-1.6b (tp 1) cut to 8 layers, and whisper-tiny (8
            blocks, 2048 frames) at pipe 4, batch 8, prompt 2048, 32
            tokens, bf16.  Against one process at pipe 4: the tokens and
            the last logits' SHA-256 equal, the launches summed over the
            ranks equal to the path's formula, each rank's cache bytes its
            share of ``cache_protos``, 31 token hops from the last rank to
            rank 0; prefill ms, decode tok/s, peak and cache GiB per rank
            beside one process's ("4 processes time-slicing one card");
19. dist_mesh  data, FSDP and tensor parallelism: the four ranks of that
            spawn laid out again as each case's ``(pod, data, pipe, tp)``
            mesh (``mesh_cases``): smollm-360m whole at data 2 x pipe 2
            with FSDP, 2 AdamW steps of gpipe with the stage weights
            joined once a step, 2 of 1f1b joined at each application, 1
            of 1f1b with FSDP off; whisper-tiny whole at tp 2 x pipe 2,
            streamed, 1f1b, 2 steps, and served (batch 8, 2048 frames, 32
            tokens), and at 2 blocks of full width in fp32 (seq 256) a
            grad call; mixtral-8x7b at full width, 1 layer, tp 2 x data
            2, 2 steps at lr 5e-5.  Gates: each replica pair's weights
            bitwise equal after every step, 1f1b's with FSDP on and off
            bitwise equal, gpipe's and 1f1b's losses within bf16 ``TOL``,
            the step-1 loss within bf16 ``TOL`` of one process (smollm at
            pipe 2, whisper streamed at pipe 2, mixtral at 1 layer; run
            and freed before the spawn), the fp32 whisper loss and every
            gradient block within 1e-3 of one process's, each rank's
            resident bytes of weights and AdamW state equal to the
            placement's count, the launches over the ranks equal to data
            x tp times the path's formula, each serving rank's cache its
            kv heads' share; per rank and case the collectives' calls,
            bytes and host-clock wait by class (tp sum, data reduce, FSDP
            gather), peak memory and step ms ("4 processes time-slicing
            one card": not a speed figure).

The kernels summary line, then the card's ``nvidia-smi`` name and power
limit, then the last line ``{"ok": true, "device": {...}}``.  It imports
nothing of JAX or ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_BF16_FLOPS = 989e12         # dense tensor-core bf16
PEAK_FP32_FLOPS = 67e12          # fp32 outside the tensor cores
D_MODEL = 960

# Tolerances against the plain versions on the same card and inputs.
# fp32: the kernels sum in another order than the plain versions (the norm's
# warp reduction, the attention's 64-key tiles against 512-key blocks);
# bf16: both round the fp32 result to bf16, which can land one ulp apart
# (the attention kernel also rounds p to bf16 for the tensor cores).
NORM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ATTN_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# WKV: fp32 (serial form) sums in another order (r.S in eight partial sums
# joined by shuffles, the bonus term apart); bf16 with T >= 64 (chunked
# form) runs its products on tensor cores with each fp32 operand split into
# bf16 hi + lo (~2^-16 relative), so its fp32 state is the summation order
# and that split apart, and its bf16 out one rounding of the fp32 result.
WKV_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
WKV_STATE_TOL = 1e-4
# Backward kernels: fp32 sums in another order (tiles of 64 keys against
# blocks of 512, a warp reduction); bf16 rounds dq / dk / dv once from fp32,
# so each output is held within 2e-2 of its own largest magnitude.
BWD_FP32_TOL = 1e-3
BWD_BF16_REL = 2e-2
LSE_TOL = 1e-4     # the forward's fp32 log-sum-exp, both dtypes
PORT_TOL = 1e-3   # whole model, fp32, kernels on the card vs plain on the CPU
GRAD_REL = 1e-4   # training: each grad leaf's gap over its largest entry
# Leaves whose card result may differ between two schedules of one
# computation: the embedding's gradient comes from index_select's backward,
# an index_add_ of fp32 atomics over repeated tokens on CUDA.
NONDETERMINISTIC_LEAVES = ("embed/tok",)
KERNELS = ("flash_attention", "rmsnorm", "wkv6", "flash_attention_bwd",
           "rmsnorm_bwd", "wkv6_bwd")
# The dense-block archs served at full size beside smollm (gemma-2b at its
# config's pipe 2, deepseek-7b at pipe 16, pixtral-12b with its patches at
# pipe 8, tp cut to 1); llama3-405b at full width cut to 4 layers (pipe 4,
# one a stage): its 126 (~810 GB of bf16 weights) do not fit one card
DENSE_SERVE = ("gemma-2b", "deepseek-7b", "pixtral-12b", "llama3-405b")
# The MoE and hybrid archs, served: mixtral-8x7b at full width cut to 16 of
# its 32 layers (2.9 GB of bf16 weights a layer; pipe 8), dbrx-132b to 4 of
# 40 (6.5 GB a layer; pipe 4), hymba-1.5b to 16 of 32 (pipe 8, as it
# trains); trained: mixtral at 2 layers, pipe 2 (16 B a parameter: ~51 GB),
# hymba at 16
MOE_HYBRID = ("mixtral-8x7b", "dbrx-132b", "hymba-1.5b")
# hymba-1.5b at 16 of its 32 layers, pipe 8: its global-attention layers 0
# and 15 and windowed ones between, half the SSM scan's time
HYMBA_CUT = dict(n_layers=16, pipe=8)
# deepseek-7b cut to 15 layers in 16 slots at its pipe 16 (a padded
# layout, as its 30 in 32 are), pixtral-12b to 24 of 40 layers and hymba,
# for the script's clock
SERVE_CUT = {"llama3-405b": dict(n_layers=4),
             "deepseek-7b": dict(n_layers=15),
             "pixtral-12b": dict(n_layers=24),
             "mixtral-8x7b": dict(n_layers=16),
             "dbrx-132b": dict(n_layers=4, pipe=4),
             "hymba-1.5b": HYMBA_CUT}
TRAIN_CUT = {"mixtral-8x7b": dict(n_layers=2, pipe=2),
             "hymba-1.5b": HYMBA_CUT}
# The train phases' AdamW lr (constant, no warmup), 5e-4 but for
# mixtral-8x7b, a workaround: at 5e-4 its 2-layer cut's curve on one fixed
# batch rises (11.01, 13.27, 35.54, 20.95, 12.83; 1e-4 rises at steps 2-3
# too) and the last-below-first gate fails; at 5e-5 it falls at every
# step.  Why it rises is open (ROADMAP C5): ``train_gpu_vs_cpu`` holds
# one step's fp32 gradients to the CPU, not a bf16 curve
TRAIN_LR = {"mixtral-8x7b": 5e-5}
# Steps before the traced one: 5, but 3 for hymba-1.5b, whose ~4.5 s steps
# (the SSM scan's elementwise kernels) would take the script past its time
# limit
TRAIN_STEPS = {"hymba-1.5b": 3}
# RMSNorm widths of hymba-1.5b, mixtral-8x7b and dbrx-132b
WIDE_NORMS = (1600, 4096, 6144)
# (window, hq, hkv, d): mixtral's attention, a D-128 window shorter than
# the sequences it meets (its key tiles skipped), hymba's
WINDOWED = ((4096, 32, 8, 128), (1000, 32, 8, 128), (1024, 25, 5, 64))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, iters: int) -> float:
    """Device time per call: events around ``iters`` back-to-back calls.

    A sleep kernel first holds the stream while the host enqueues the calls,
    so the events time the card's work and not the Python launch path."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hasattr(torch.cuda, "_sleep"):
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_name(name: str) -> str:
    """A kernel's demangled name without its return type, namespaces and
    arguments: ``flash_bwd_delta_kernel<__nv_bfloat16, 256>``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    base, bracket, args = name.split("(")[0].partition("<")
    return base.split("::")[-1] + bracket + args


def kernel_us(torch, fn, iters: int):
    """Device µs per call of each kernel that ``fn`` launches, by name, from
    a profiler trace of ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            key = kernel_name(evt.name)
            per[key] = per.get(key, 0.0) + evt.device_time / iters
    return per


def with_rates(rec, flops):
    """A kernel_timing record with its achieved TFLOP/s (``flops`` over the
    measured time) and its bound share (bound over time)."""
    return rec | {"tflops": flops / (rec["ms"] * 1e-3) / 1e12,
                  "bound_share": rec["bound_ms"] / rec["ms"]}


def sdpa_call(torch, q, k, v, causal: bool, window: int = 0):
    """``F.scaled_dot_product_attention`` at the kernel's mask, as a
    thunk: ``is_causal`` where the window covers the sequence, else a
    boolean mask of the window (k and v then repeated to q's heads, since
    a masked GQA call has no fused form)."""
    import torch.nn.functional as F
    sq, hq, hkv = q.shape[2], q.shape[1], k.shape[1]
    if not causal or not 0 < window < sq:
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=hq != hkv)
    i = torch.arange(sq, device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    if hq != hkv:
        k, v = (t.repeat_interleave(hq // hkv, 1) for t in (k, v))
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def max_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max().item())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; "
                         "this script runs only on a GPU")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name, smi


def ptxas_kernels(log: str):
    """Per kernel (mangled name): registers and spill bytes from ``-Xptxas -v``."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?([\w.$]+)", ln)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


SASS_OPS = ("HGMMA", "HMMA")


def sass_by_function(build, lib: str):
    """Per kernel function of a built library: the lines of each op in
    ``SASS_OPS`` (wgmma is HGMMA, mma.sync HMMA), from ``cuobjdump
    --dump-sass`` split at its ``Function :`` headers."""
    sass = subprocess.run(
        [str(Path(build.nvcc_path()).parent / "cuobjdump"), "--dump-sass",
         str(build.lib_path(lib))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = dict.fromkeys(SASS_OPS, 0)
        elif name is not None:
            for op in SASS_OPS:
                out[name][op] += op in ln
    return out


# Kernel functions (a substring of the mangled name) and the tensor-core
# instructions each must hold: the bf16 attention kernels run on wgmma
# (HGMMA) and none on mma.sync (HMMA); the chunked WKV form's update and
# output passes on mma.sync, and the chunked backward's update and chunk
# passes.
SASS_GATES = {
    "flash_fwd_wgmma_kernel": {"HGMMA": True},
    "flash_bwd_dkdv_wgmma_kernel": {"HGMMA": True, "HMMA": False},
    "flash_bwd_dq_wgmma_kernel": {"HGMMA": True, "HMMA": False},
    "flash_bwd_dkdv_d256_kernel": {"HGMMA": True, "HMMA": False},
    "flash_bwd_dq_d256_kernel": {"HGMMA": True, "HMMA": False},
    "wkv6_update_kernel": {"HMMA": True},
    "wkv6_out_kernel": {"HMMA": True},
    "wkv6_bwd_update_kernel": {"HMMA": True},
    "wkv6_bwd_chunk_kernel": {"HMMA": True},
}
BWD_KERNELS = ("flash_bwd_", "rmsnorm_bwd_kernel", "rmsnorm_dscale_kernel")


def sass_gate(funcs):
    """Check each function named in ``SASS_GATES`` (both head dims where
    templated); returns the failures."""
    bad = []
    for key, want in SASS_GATES.items():
        hits = {n: c for n, c in funcs.items() if key in n}
        if not hits:
            bad.append(f"no function {key}")
        for n, counts in hits.items():
            for op, present in want.items():
                if (counts[op] > 0) != present:
                    bad.append(f"{n}: {op} {counts[op]}")
    return bad


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all(force=True)
    dt = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    # ptxas names any kernel whose wgmma it had to serialise (C7518)
    wgmma_warnings = [ln.strip() for log in logs.values()
                      for ln in log.splitlines() if "serialized" in ln]
    funcs = {}
    for lib in ("flash_attention", "wkv6"):
        funcs.update(sass_by_function(build, lib))
    kernels = {n: k for lib in ("flash_attention", "rmsnorm", "wkv6")
               for n, k in ptxas_kernels(logs[lib]).items()}
    sass = {n: c for n, c in funcs.items() if any(c.values())}
    emit({"phase": "build", "seconds": dt, "nvcc": build.nvcc_path(),
          "flags": list(build.NVCC_FLAGS), "ptxas": ptxas,
          "wgmma_warnings": wgmma_warnings, "sass_count": sass,
          "kernels": kernels})
    bad = sass_gate(funcs)
    if bad:
        raise AssertionError(f"SASS gate: {bad}")
    # no WKV or backward kernel may spill
    checked = {n: k for n, k in kernels.items()
               if "wkv6" in n or any(b in n for b in BWD_KERNELS)}
    spilled = {n: k for n, k in checked.items() if k.get("spill_bytes", 0) > 0}
    if not checked or spilled:
        raise AssertionError(f"kernels spill or were not reported: "
                             f"{spilled or checked}")


def phase_kernels(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_cuda,
                                                     flash_attention_plain)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
    from repro_torch.kernels.wkv6 import (uses_chunked_form, wkv6,
                                          wkv6_plain)
    from repro_torch.launch.train import visible_pairs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # -- RMSNorm grid: smollm's width, rwkv6's group norm (both compiled for
    #    their D) and a width that takes the kernel's generic-D form; 1024
    #    rows are the fused schedules' head norm (one micro-batch), 8192 the
    #    gpipe path's layers and head chunks; hymba's, mixtral's and dbrx's
    #    widths (1,600, 4,096, 6,144) -----------------------------------------
    for d in (D_MODEL, 2048, 448) + WIDE_NORMS:
        for rows in (1, 8, 1024, 2048, 8192):
            for dname, dt in dtypes.items():
                x = randn(rows, d, dtype=dt) * 2
                s = randn(d, dtype=dt) + 1
                got = rmsnorm(x, s)
                torch.cuda.synchronize()
                want = rmsnorm_plain(x, s)
                err = max_err(torch, got, want)
                ok = torch.allclose(got.float(), want.float(),
                                    rtol=NORM_TOL[dname],
                                    atol=NORM_TOL[dname])
                emit({"check": "rmsnorm", "rows": rows, "d": d,
                      "dtype": dname, "max_abs_err": err,
                      "tol": NORM_TOL[dname], "ok": bool(ok)})
                if not ok:
                    raise AssertionError(f"rmsnorm kernel disagrees: {err}")

    # -- attention grid: D = 64 over masks and heads; D = 128 causal with a
    #    ragged Sq (not a multiple of the 128-row q tile) ------------------
    seqs = ((100, 100, 0), (2048, 2048, 0), (100, 300, 200))
    cases = [(causal, window, sq, sk, q_offset, hq, hkv, 64)
             for causal in (0, 1) for window in (0, 128)
             for sq, sk, q_offset in seqs for hq, hkv in ((15, 5), (4, 4))]
    cases += [(1, 0, sq, sk, q_offset, 15, 5, 128)
              for sq, sk, q_offset in ((100, 100, 0), (1000, 1000, 0),
                                       (100, 300, 200))]
    # D = 256 (gemma-2b): causal, non-causal and windowed, MQA 8:1 and MHA
    cases += [(causal, window, sq, sk, q_offset, hq, hkv, 256)
              for causal, window in ((1, 0), (0, 0), (1, 128))
              for sq, sk, q_offset in ((100, 100, 0), (1000, 1000, 0),
                                       (100, 300, 200))
              for hq, hkv in ((8, 1), (4, 4))]
    # windowed GQA: mixtral's (D 128, 32:8, window 4,096), a D-128 window
    # shorter than the sequence (key tiles skipped), hymba's (D 64, 25:5,
    # window 1,024)
    cases += [(1, window, sq, sk, q_offset, hq, hkv, d)
              for window, hq, hkv, d in WINDOWED
              for sq, sk, q_offset in ((100, 100, 0), (2048, 2048, 0),
                                       (100, 300, 200))]
    for causal, window, sq, sk, q_offset, hq, hkv, d in cases:
        for dname, dt in dtypes.items():
            q = randn(1, hq, sq, d, dtype=dt)
            k = randn(1, hkv, sk, d, dtype=dt)
            v = randn(1, hkv, sk, d, dtype=dt)
            kw = dict(causal=bool(causal), window=window, q_offset=q_offset)
            got = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = flash_attention_plain(q, k, v, **kw)
            err = max_err(torch, got, want)
            ok = torch.allclose(got.float(), want.float(),
                                rtol=ATTN_TOL[dname], atol=ATTN_TOL[dname])
            emit({"check": "flash_attention", "causal": causal,
                  "window": window, "sq": sq, "sk": sk, "q_offset": q_offset,
                  "hq": hq, "hkv": hkv, "d": d, "dtype": dname,
                  "max_abs_err": err, "tol": ATTN_TOL[dname], "ok": bool(ok)})
            if not ok:
                raise AssertionError(f"flash_attention kernel disagrees: {err}")

    # -- the training path's shape, q [2,15,4096,64] causal, with the lse
    #    the backward reads (natural log, fp32) -----------------------------
    for dname, dt in dtypes.items():
        q = randn(2, 15, 4096, 64, dtype=dt)
        k, v = (randn(2, 5, 4096, 64, dtype=dt) for _ in range(2))
        got, lse = flash_attention_cuda(q, k, v, return_lse=True)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v)
        err = max_err(torch, got, want)
        lse_err = max_err(torch, lse, ref.mha_blocked_fwd(q, k, v)[1])
        ok = (torch.allclose(got.float(), want.float(), rtol=ATTN_TOL[dname],
                             atol=ATTN_TOL[dname]) and lse_err <= LSE_TOL)
        emit({"check": "flash_attention", "causal": 1, "window": 0,
              "b": 2, "sq": 4096, "sk": 4096, "q_offset": 0, "hq": 15,
              "hkv": 5, "d": 64, "dtype": dname, "lse": True,
              "max_abs_err": err, "tol": ATTN_TOL[dname],
              "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL, "ok": ok})
        if not ok:
            raise AssertionError(f"flash_attention kernel disagrees at the "
                                 f"training shape: {err}, lse {lse_err}")

    # -- WKV grid: H = 32, K = V = 64 (rwkv6-1.6b's heads), w fp32 as on
    #    the path.  bf16 with T >= 64 takes the chunked form, fp32 and
    #    T < 64 the serial form; T = 1 is a decode step, 65 / 100 / 130
    #    leave a masked tail (130: a tail of one step past two chunks);
    #    "extreme" decays w = exp(-exp(3 N(0, 1))) underflow to w = 0 -----
    def wkv_inputs(B, T, dt, s0_random, decay="normal"):
        r, k, v = (randn(B, 32, T, 64, dtype=dt) * 0.5 for _ in range(3))
        w = torch.exp(-torch.exp(randn(B, 32, T, 64, dtype=torch.float32)
                                 * (0.5 if decay == "normal" else 3.0)))
        u = randn(32, 64, dtype=torch.float32) * 0.5
        s0 = (randn(B, 32, 64, 64, dtype=torch.float32) * 0.3 if s0_random
              else torch.zeros(B, 32, 64, 64, device=dev))
        return r, k, v, w, u, s0

    for T in (1, 16, 64, 65, 100, 130, 2048):
        for B in (1, 2):
            for s0_random in (False, True):
                for decay in ("normal", "extreme"):
                    for dname, dt in dtypes.items():
                        args = wkv_inputs(B, T, dt, s0_random, decay)
                        got_o, got_s = wkv6(*args)
                        torch.cuda.synchronize()
                        want_o, want_s = wkv6_plain(*args)
                        err_o = max_err(torch, got_o, want_o)
                        err_s = max_err(torch, got_s, want_s)
                        ok = (got_o.dtype == dt
                              and bool(torch.isfinite(got_o.float()).all())
                              and torch.allclose(got_o.float(),
                                                 want_o.float(),
                                                 rtol=WKV_TOL[dname],
                                                 atol=WKV_TOL[dname])
                              and torch.allclose(got_s, want_s,
                                                 rtol=WKV_STATE_TOL,
                                                 atol=WKV_STATE_TOL))
                        emit({"check": "wkv6", "B": B, "H": 32, "T": T,
                              "K": 64, "s0": "random" if s0_random
                              else "zero", "decay": decay, "dtype": dname,
                              "w_dtype": "float32",
                              "form": ("chunked" if uses_chunked_form(dt, T)
                                       else "serial"),
                              "max_abs_err": err_o,
                              "state_max_abs_err": err_s,
                              "tol": WKV_TOL[dname],
                              "state_tol": WKV_STATE_TOL, "ok": bool(ok)})
                        if not ok:
                            raise AssertionError(
                                f"wkv6 kernel disagrees: out {err_o}, "
                                f"state {err_s}")

    # -- timing at the serving paths' shapes (bf16, one micro-batch of the
    #    2048-token prefill: mb = 1) ----------------------------------------
    def norm_timing(d):
        """RMSNorm at [1, 2048, d] (a prefill micro-batch) and one decode row."""
        rows = 2048
        x = randn(1, rows, d, dtype=torch.bfloat16)
        s = randn(d, dtype=torch.bfloat16) + 1
        x1 = x[:, :1].contiguous()
        err_n = max_err(torch, rmsnorm(x, s), rmsnorm_plain(x, s))
        norm_bytes = (2 * rows * d + d) * 2
        norm_flops = 4 * rows * d
        bound_s = max(norm_bytes / HBM_BYTES_PER_S,
                      norm_flops / PEAK_FP32_FLOPS)
        rec = {
            "name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:22",
            "max_abs_err": err_n,
            "ms": device_ms(torch, lambda: rmsnorm(x, s), 500),
            "plain_ms": device_ms(torch, lambda: rmsnorm_plain(x, s), 100),
            "library_ms": device_ms(
                torch, lambda: F.rms_norm(x, (d,), s, 1e-6), 500),
            "bound_ms": 1e3 * bound_s,
            "bound_by": ("bytes" if norm_bytes / HBM_BYTES_PER_S
                         >= norm_flops / PEAK_FP32_FLOPS else "operations"),
            "shape": [1, rows, d], "dtype": "bfloat16",
            "decode_row_ms": device_ms(torch, lambda: rmsnorm(x1, s), 500),
        }
        return with_rates(rec, norm_flops)

    norm = norm_timing(D_MODEL)           # smollm-360m
    norm_rwkv = norm_timing(2048)         # rwkv6-1.6b's group norm
    norm_wide = [norm_timing(d) for d in WIDE_NORMS[:2]]   # hymba, mixtral

    def attn_timing(b, hq, hkv, sq, causal, iters, d=64, window=0):
        """The bf16 forward at q [b, hq, sq, d], checked against its plain
        version (and its lse, at the training calls) and timed beside SDPA
        at the same mask (the yardstick only) and its bound; non-causal
        work is every (query, key) pair, causal work the visible ones
        (``visible_pairs`` under ``window``)."""
        q = randn(b, hq, sq, d, dtype=torch.bfloat16)
        k = randn(b, hkv, sq, d, dtype=torch.bfloat16)
        v = randn(b, hkv, sq, d, dtype=torch.bfloat16)
        kw = dict(causal=causal, window=window)
        got, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        want, want_lse = ref.mha_blocked_fwd(q, k, v, **kw)
        err = max_err(torch, got, want)
        lse_err = max_err(torch, lse, want_lse)
        tol = ATTN_TOL["bfloat16"]
        if not (torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
                and lse_err <= LSE_TOL):
            raise AssertionError(f"flash_attention disagrees at q {[b, hq, sq]}"
                                 f" {kw}: {err}, lse {lse_err}")
        pairs = visible_pairs(sq, window) if causal else sq * sq
        flops = 4 * d * hq * b * pairs                  # q k^T and p v
        nbytes = 2 * d * b * sq * (hq + hkv + hkv + hq)
        lib = sdpa_call(torch, q, k, v, causal, window)
        rec = {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:36",
            "max_abs_err": err, "lse_max_abs_err": lse_err,
            "ms": device_ms(torch, lambda: flash_attention(q, k, v, **kw),
                            iters),
            "plain_ms": device_ms(torch, lambda: flash_attention_plain(
                q, k, v, **kw), 2 if sq > 2048 else 10),
            "library_ms": device_ms(torch, lib, iters),
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  flops / PEAK_BF16_FLOPS),
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / PEAK_BF16_FLOPS else "operations"),
            "shape": {"q": [b, hq, sq, d], "kv": [b, hkv, sq, d],
                      "causal": causal, "window": window},
            "dtype": "bfloat16", "flops": flops,
        }
        return with_rates(rec, flops)

    attn = attn_timing(1, 15, 5, 2048, True, 50)      # smollm-360m prefill
    # gemma-2b's training call (m 8: micro-batch 2), MQA 8:1 at D 256, and
    # deepseek-7b's prefill call (m 8: micro-batch 1), MHA at D 128
    wide = [attn_timing(2, 8, 1, 4096, True, 20, d=256)
            | {"call": "gemma-2b training"},
            attn_timing(1, 32, 32, 2048, True, 20, d=128)
            | {"call": "deepseek-7b prefill"}]
    # the training calls (micro-batch 2) of mixtral-8x7b (GQA 32:8 at D 128,
    # window 4,096) and hymba-1.5b (25:5 at D 64, window 1,024)
    wide += [attn_timing(2, 32, 8, 4096, True, 20, d=128, window=4096)
             | {"call": "mixtral-8x7b training"},
             attn_timing(2, 25, 5, 4096, True, 20, window=1024)
             | {"call": "hymba-1.5b training"}]
    # whisper-tiny's training call (m 8: micro-batch 2), 6 heads over 6:
    # the encoder's self- and every cross-attention non-causal, the
    # decoder's self-attention causal
    whisper = [attn_timing(2, 6, 6, 4096, causal, 20) | {"call": "whisper"}
               for causal in (False, True)]
    # rwkv6-1.6b prefill: B = mb = 1, H = 32, T = 2048, bf16 r/k/v/out,
    # fp32 w, u and state; no PyTorch call computes WKV-6 (library: none);
    # and its training call (m 8: micro-batch 2, seq 4096) from a zero state
    n = 64

    def wkv_timing(B, T, s0_random, plain_iters):
        args = wkv_inputs(B, T, torch.bfloat16, s0_random)
        err_w = max_err(torch, wkv6(*args)[0], wkv6_plain(*args)[0])
        wkv_bytes = (B * 32 * T * n * (3 * 2 + 4 + 2)    # r, k, v, w in; out
                     + 32 * n * 4 + 2 * B * 32 * n * n * 4)  # u; s0 in, sT out
        # the chunked form's four 64 x 64 x 64 products a chunk (r S_in,
        # r k^T, A v, k~^T v) on bf16 tensor cores; the serial form's 5 fp32
        # operations per (k, v) a step (r.S, w*S + k*v) on the CUDA cores,
        # beside it
        wkv_tc_flops = 4 * 2 * n ** 3 * B * 32 * (-(-T // 64))
        wkv_serial_flops = 5 * B * 32 * T * n * n
        bytes_s = wkv_bytes / HBM_BYTES_PER_S
        ops_s = wkv_tc_flops / PEAK_BF16_FLOPS
        rec = {
            "name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/rwkv6.py:35",
            "max_abs_err": err_w,
            "ms": device_ms(torch, lambda: wkv6(*args), 200),
            "plain_ms": device_ms(torch, lambda: wkv6_plain(*args),
                                  plain_iters),
            "library_ms": None,
            "bound_ms": 1e3 * max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "serial_fp32_ops_bound_ms": 1e3 * wkv_serial_flops
            / PEAK_FP32_FLOPS,
            "shape": [B, 32, T, n], "dtype": "bfloat16",
            "w_dtype": "float32", "bytes": wkv_bytes,
            "tc_flops": wkv_tc_flops, "serial_flops": wkv_serial_flops,
            "per_kernel_us": kernel_us(torch, lambda: wkv6(*args), 20),
        }
        return with_rates(rec, wkv_tc_flops)

    wkv = wkv_timing(1, 2048, True, 2)
    dec = wkv_inputs(1, 1, torch.bfloat16, True)      # one decode step
    dec_bytes = (32 * n * (3 * 2 + 4 + 2) + 32 * n * 4
                 + 2 * 32 * n * n * 4)
    wkv.update(decode_shape=[1, 32, 1, n],
               decode_ms=device_ms(torch, lambda: wkv6(*dec), 500),
               decode_bound_ms=1e3 * dec_bytes / HBM_BYTES_PER_S)
    wkv_train = wkv_timing(2, 4096, False, 1) | {"call": "rwkv6-1.6b training"}
    for rec in (norm, norm_rwkv, *norm_wide, attn, *whisper, *wide, wkv,
                wkv_train):
        emit({"phase": "kernel_timing", **rec})
    return {"rmsnorm": norm, "flash_attention": attn, "wkv6": wkv}


def bwd_close(torch, dname, got, want):
    """(ok, max |got - want|, max |want|) by the backward tolerances."""
    err = max_err(torch, got, want)
    top = float(want.float().abs().max().item())
    if dname == "float32":
        ok = torch.allclose(got.float(), want.float(), rtol=BWD_FP32_TOL,
                            atol=BWD_FP32_TOL)
    else:
        ok = err <= BWD_BF16_REL * top
    return bool(ok) and bool(torch.isfinite(got.float()).all()), err, top


def checked_max_err(torch, dname, what, pairs) -> float:
    """Hold each (kernel, plain) output pair to :func:`bwd_close`; returns
    the largest |kernel - plain| over them."""
    res = [bwd_close(torch, dname, g, w) for g, w in pairs]
    if not all(r[0] for r in res):
        raise AssertionError(f"{what} disagrees at a timed shape: {res}")
    return max(r[1] for r in res)


def grad_ms(torch, out, inputs, grad_out, iters: int) -> float:
    """Device ms of the backward alone: autograd.grad over a kept graph."""
    return device_ms(torch, lambda: torch.autograd.grad(
        out, inputs, grad_out, retain_graph=True), iters)


def phase_backward(torch):
    """Backward kernels vs plain, the autograd checks, and their timings."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        bwd_head_slices, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_cuda)
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_bwd,
                                             rmsnorm_bwd_plain)
    from repro_torch.kernels.wkv6 import (uses_chunked_form, wkv6, wkv6_bwd,
                                          wkv6_bwd_plain)
    from repro_torch.launch.train import visible_pairs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # -- attention: GQA 3:1, 5:1 and MHA, causal / full / window, ragged S:
    #    100 and 192 are not multiples of the 128-row tiles, a window of 100
    #    straddles the 128-key blocks -----------------------------------------
    cases = [(b, hq, hkv, sq, d, causal, window)
             for b, hq, hkv in ((1, 15, 5), (2, 4, 4), (1, 15, 3))
             for sq in (100, 192, 256, 2048) for d in (64, 128)
             for causal, window in ((True, 0), (False, 0), (True, 128),
                                    (True, 100))]
    cases.append((2, 15, 5, 4096, 64, True, 0))       # the training path's
    # windowed GQA: mixtral's, a D-128 window shorter than S, hymba's
    cases += [(1, hq, hkv, sq, d, True, window)
              for window, hq, hkv, d in WINDOWED for sq in (100, 2048)]
    # D = 256 (gemma-2b): MQA 8:1 and MHA over the same masks and lengths
    cases += [(b, hq, hkv, sq, 256, causal, window)
              for b, hq, hkv in ((1, 8, 1), (2, 4, 4))
              for sq in (100, 192, 256, 2048)
              for causal, window in ((True, 0), (False, 0), (True, 128),
                                     (True, 100))]
    for b, hq, hkv, sq, d, causal, window in cases:
        for dname, dt in dtypes.items():
            q = randn(b, hq, sq, d, dtype=dt)
            k, v = (randn(b, hkv, sq, d, dtype=dt) for _ in range(2))
            do = randn(b, hq, sq, d, dtype=dt)
            kw = dict(causal=causal, window=window)
            out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
            got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
            lse_err = max_err(torch, lse,
                              ref.mha_blocked_fwd(q, k, v, **kw)[1])
            res = [bwd_close(torch, dname, g, w) for g, w in zip(got, want)]
            ok = all(r[0] for r in res) and lse_err <= LSE_TOL
            emit({"check": "flash_attention_bwd", "b": b, "hq": hq,
                  "hkv": hkv, "s": sq, "d": d, "causal": causal,
                  "window": window, "dtype": dname,
                  "max_abs_err": {n: r[1] for n, r in zip("qkv", res)},
                  "max_abs_ref": {n: r[2] for n, r in zip("qkv", res)},
                  "lse_max_abs_err": lse_err, "ok": ok})
            if not ok:
                raise AssertionError(f"attention backward disagrees: {res}, "
                                     f"lse {lse_err}")

    # -- the bf16 backward at smollm's and gemma-2b's training calls, twice
    #    on the same inputs: no atomics (gemma's q-head slices are added in
    #    slice order), so dq, dk and dv are bitwise equal ---------------------
    for hq, hkv, d in ((15, 5, 64), (8, 1, 256)):
        q = randn(2, hq, 4096, d, dtype=torch.bfloat16)
        k, v = (randn(2, hkv, 4096, d, dtype=torch.bfloat16)
                for _ in range(2))
        do = randn(2, hq, 4096, d, dtype=torch.bfloat16)
        out, lse = flash_attention_cuda(q, k, v, return_lse=True)
        first = flash_attention_bwd(q, k, v, out, lse, do)
        again = flash_attention_bwd(q, k, v, out, lse, do)
        same = [bool(torch.equal(a, b)) for a, b in zip(first, again)]
        emit({"check": "flash_attention_bwd_bitwise", "b": 2, "hq": hq,
              "hkv": hkv, "s": 4096, "d": d, "dtype": "bfloat16",
              "head_slices": bwd_head_slices(q, k),
              "equal": dict(zip(("dq", "dk", "dv"), same)), "ok": all(same)})
        if not all(same):
            raise AssertionError(f"attention backward differs between calls "
                                 f"at D {d}: {same}")
        del q, k, v, do, out, lse, first, again

    # -- RMSNorm: both widths compiled for the forward and a generic one;
    #    5 and 33 rows are ragged shares of the backward's grid, 1024 the
    #    fused schedules' head norm ------------------------------------------
    for d in (D_MODEL, 2048, 448) + WIDE_NORMS:
        for rows in (1, 3, 5, 33, 1024, 2048, 8192):
            for dname, dt in dtypes.items():
                x = randn(rows, d, dtype=dt) * 2
                s = randn(d, dtype=dt) + 1
                dy = randn(rows, d, dtype=dt)
                got = rmsnorm_bwd(x, s, dy)
                torch.cuda.synchronize()
                want = rmsnorm_bwd_plain(x, s, dy)
                res = [bwd_close(torch, dname, g, w)
                       for g, w in zip(got, want)]
                ok = all(r[0] for r in res)
                emit({"check": "rmsnorm_bwd", "rows": rows, "d": d,
                      "dtype": dname,
                      "max_abs_err": {"x": res[0][1], "scale": res[1][1]},
                      "max_abs_ref": {"x": res[0][2], "scale": res[1][2]},
                      "ok": ok})
                if not ok:
                    raise AssertionError(f"rmsnorm backward disagrees: {res}")

    # -- autograd: the Functions carry grad_fn, WKV's too -------------------
    q = randn(1, 15, 64, 64, dtype=torch.bfloat16).requires_grad_()
    k, v = (randn(1, 5, 64, 64, dtype=torch.bfloat16) for _ in range(2))
    x = randn(4, D_MODEL, dtype=torch.bfloat16).requires_grad_()
    s = randn(D_MODEL, dtype=torch.bfloat16)
    r = randn(1, 32, 64, 64, dtype=torch.bfloat16).requires_grad_()
    w = torch.full((1, 32, 64, 64), 0.9, device=dev)
    u = torch.zeros(32, 64, device=dev)
    s0 = torch.zeros(1, 32, 64, 64, device=dev)
    outs = {"attention": flash_attention(q, k, v), "rmsnorm": rmsnorm(x, s),
            "wkv6": wkv6(r, r.detach(), r.detach(), w, u, s0)[0]}
    if any(o.grad_fn is None for o in outs.values()):
        raise AssertionError("a kernel Function's output has no grad_fn")
    emit({"check": "autograd", **{f"{n}_grad_fn": type(o.grad_fn).__name__
                                  for n, o in outs.items()}, "ok": True})

    # -- WKV-6 backward: every gradient against autograd through the plain
    #    version on the card, H 32, from a random s0 with a random cotangent
    #    on the final state (and without one: the model's case); bf16 with
    #    T >= 64 runs the chunked forms, forward and backward, fp32 and
    #    T < 64 the serial ones; 65 / 100 / 130 leave a masked tail, 256
    #    spans four chunks, "extreme" decays underflow to w = 0 ------------
    def wkv_case(B, T, dt, decay="normal"):
        r, k, v = (randn(B, 32, T, 64, dtype=dt) * 0.5 for _ in range(3))
        w = torch.exp(-torch.exp(randn(B, 32, T, 64, dtype=torch.float32)
                                 * (0.5 if decay == "normal" else 3.0)))
        u = randn(32, 64, dtype=torch.float32) * 0.5
        s0 = randn(B, 32, 64, 64, dtype=torch.float32) * 0.3
        do = randn(B, 32, T, 64, dtype=dt)
        return (r, k, v, w, u, s0), do

    def wkv_check(args, do, ds, dname, **rec):
        """The kernels (through the WKV6 Function, as the model calls them)
        against the plain backward; returns the plain call's device ms and
        the largest |kernel - plain|."""
        xs = [a.clone().requires_grad_() for a in args]
        out, state = wkv6(*xs)
        outs, cots = ([out, state], [do, ds]) if ds is not None \
            else ([out], [do])
        got = torch.autograd.grad(outs, xs, cots)
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        want = wkv6_bwd_plain(*args, do, ds)
        t1.record()
        torch.cuda.synchronize()
        res = {n: bwd_close(torch, "float32" if g.dtype == torch.float32
                            else dname, g, w_)
               for n, g, w_ in zip(("dr", "dk", "dv", "dw", "du", "ds0"),
                                   got, want)}
        ok = all(r_[0] for r_ in res.values())
        form = ("chunked" if uses_chunked_form(args[0].dtype,
                                               args[0].shape[2])
                else "serial")
        emit({"check": "wkv6_bwd", **rec, "dtype": dname,
              "w_dtype": "float32", "ds_T": ds is not None,
              "forward_form": form, "backward_form": form,
              "max_abs_err": {n: r_[1] for n, r_ in res.items()},
              "max_abs_ref": {n: r_[2] for n, r_ in res.items()}, "ok": ok})
        if not ok:
            raise AssertionError(f"wkv6 backward disagrees: {res}")
        return t0.elapsed_time(t1), max(r_[1] for r_ in res.values())

    for T in (1, 16, 64, 65, 100, 130, 256):
        for decay in ("normal", "extreme"):
            for dname, dt in dtypes.items():
                args, do = wkv_case(2, T, dt, decay)
                ds = randn(2, 32, 64, 64, dtype=torch.float32)
                wkv_check(args, do, ds, dname, B=2, H=32, T=T, decay=decay)
                wkv_check(args, do, None, dname, B=2, H=32, T=T, decay=decay)
    # the training call: micro-batch 2 of seq 4096, bf16, w fp32 (the plain
    # version's one call is its timing); the chunked backward
    B, H, T, n = 2, 32, 4096, 64
    args, do = wkv_case(B, T, torch.bfloat16)
    wkv_plain_ms, err = wkv_check(args, do, None, "bfloat16", B=B, H=H, T=T,
                                  decay="normal", call="training")
    # bytes: r, k, v, dout read, dr, dk, dv written (bf16); w read, dw
    # written (fp32); u, s0 read, du, ds0 written (fp32).  Operations, as
    # the forward's row counts them: a chunked backward's ten 64 x 64 x 64
    # products a chunk on bf16 tensor cores (r k^T, the chunk's state k~^T v,
    # dout v^T, dr's two, dk's two, dv's two, r^T dout for G); the serial
    # form's six 64 x 64 FMA sweeps a step and head (the state recomputed
    # from its checkpoint, dr, dk, dw, dv and the G step) on the fp32 CUDA
    # cores, beside it
    wkv_bytes = (B * H * T * n * (7 * 2 + 2 * 4)
                 + 2 * (H * n * 4 + B * H * n * n * 4))
    wkv_tc_flops = 10 * 2 * n ** 3 * B * H * (-(-T // 64))
    wkv_serial_flops = 6 * 2 * B * H * T * n * n
    bytes_s = wkv_bytes / HBM_BYTES_PER_S
    ops_s = wkv_tc_flops / PEAK_BF16_FLOPS
    wkv_rec = {
        "name": "wkv6_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/ops.py:99",
        "max_abs_err": err,
        "ms": device_ms(torch, lambda: wkv6_bwd(*args, do), 20),
        "plain_ms": wkv_plain_ms,
        "library_ms": None,
        "bound_ms": 1e3 * max(bytes_s, ops_s),
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
        "serial_fp32_ops_bound_ms": 1e3 * wkv_serial_flops / PEAK_FP32_FLOPS,
        "shape": [B, H, T, n], "dtype": "bfloat16", "w_dtype": "float32",
        "bytes": wkv_bytes, "tc_flops": wkv_tc_flops,
        "serial_flops": wkv_serial_flops,
        "per_kernel_us": kernel_us(torch, lambda: wkv6_bwd(*args, do), 5),
    }
    wkv_rec = with_rates(wkv_rec, wkv_tc_flops)
    # no atomics: two calls on the same inputs give the same bits
    first = wkv6_bwd(*args, do)
    again = wkv6_bwd(*args, do)
    same = [bool(torch.equal(a, b)) for a, b in zip(first, again)]
    wkv_rec["bitwise_run_to_run"] = all(same)
    emit({"phase": "kernel_timing", **wkv_rec})
    emit({"check": "wkv6_bwd_bitwise", "shape": [B, H, T, n],
          "dtype": "bfloat16", "backward_form": "chunked",
          "equal": dict(zip(("dr", "dk", "dv", "dw", "du", "ds0"), same)),
          "ok": all(same)})
    if not all(same):
        raise AssertionError(f"wkv6 backward differs between calls: {same}")
    del args, do, first, again

    # -- timing: attention at q [1,15,S,64] causal (S 2048, 4096; bf16 and
    #    fp32) and at the training path's [2,15,4096,64] bf16; RMSNorm at
    #    [1,2048,960], [16,4096,960] and the path's [2,4096,960] bf16 ------
    def attn_timing(b, sq, dname, hq=15, hkv=5, causal=True, d=64,
                    split=False, window=0):
        """The backward at q [b, hq, sq, d], checked against its plain
        version and timed beside SDPA's backward at the same mask and its
        bound; non-causal work is every (query, key) pair, causal work the
        visible ones (``visible_pairs`` under ``window``).  ``split`` adds
        each kernel's µs a call (delta, dK / dV, the slice sum, dQ) from a
        profiler trace."""
        dt = dtypes[dname]
        q = randn(b, hq, sq, d, dtype=dt)
        k, v = (randn(b, hkv, sq, d, dtype=dt) for _ in range(2))
        do = randn(b, hq, sq, d, dtype=dt)
        kw = dict(causal=causal, window=window)
        out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        err = checked_max_err(torch, dname, "flash_attention_bwd", zip(
            flash_attention_bwd(q, k, v, out, lse, do, **kw),
            flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)))
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        sdpa = sdpa_call(torch, qg, kg, vg, causal, window)()
        pairs = visible_pairs(sq, window) if causal else sq * sq
        flops = 5 * 2 * d * hq * b * pairs
        nbytes = (q.element_size() * d * b * sq * (4 * hq + 4 * hkv)
                  + 4 * b * hq * sq)
        peak = PEAK_BF16_FLOPS if dname == "bfloat16" else PEAK_FP32_FLOPS
        iters = 20 if sq <= 2048 else 5
        rec = {
            "name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/ref.py:138",
            "max_abs_err": err,
            "ms": device_ms(torch, lambda: flash_attention_bwd(
                q, k, v, out, lse, do, **kw), iters),
            "plain_ms": device_ms(torch, lambda: flash_attention_bwd_plain(
                q, k, v, out, lse, do, **kw), 2),
            "library_ms": grad_ms(torch, sdpa, (qg, kg, vg), do, iters),
            "bound_ms": 1e3 * max(flops / peak, nbytes / HBM_BYTES_PER_S),
            "bound_by": ("operations" if flops / peak >= nbytes / HBM_BYTES_PER_S
                         else "bytes"),
            "shape": {"q": [b, hq, sq, d], "kv": [b, hkv, sq, d],
                      "causal": causal, "window": window}, "dtype": dname,
            "flops": flops,
        }
        if split:
            rec["head_slices"] = bwd_head_slices(q, k, causal=causal)
            rec["per_kernel_us"] = kernel_us(torch, lambda: flash_attention_bwd(
                q, k, v, out, lse, do, **kw), 5)
        rec = with_rates(rec, flops)
        emit({"phase": "kernel_timing", **rec})
        return rec

    def norm_timing(shape):
        x = randn(*shape, dtype=torch.bfloat16)
        s = randn(shape[-1], dtype=torch.bfloat16) + 1
        dy = randn(*shape, dtype=torch.bfloat16)
        err = checked_max_err(torch, "bfloat16", "rmsnorm_bwd", zip(
            rmsnorm_bwd(x, s, dy), rmsnorm_bwd_plain(x, s, dy)))
        xg, sg = x.clone().requires_grad_(), s.clone().requires_grad_()
        lib = F.rms_norm(xg, (shape[-1],), sg, 1e-6)
        nbytes = 2 * (3 * x.numel() + 2 * shape[-1])
        flops = 10 * x.numel()
        rec = {
            "name": "rmsnorm_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/ops.py:122",
            "max_abs_err": err,
            "ms": device_ms(torch, lambda: rmsnorm_bwd(x, s, dy), 200),
            "plain_ms": device_ms(torch, lambda: rmsnorm_bwd_plain(x, s, dy),
                                  20),
            "library_ms": grad_ms(torch, lib, (xg, sg), dy, 200),
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  flops / PEAK_FP32_FLOPS),
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / PEAK_FP32_FLOPS else "operations"),
            "shape": list(shape), "dtype": "bfloat16",
        }
        rec = with_rates(rec, flops)
        emit({"phase": "kernel_timing", **rec})
        return rec

    for sq in (2048, 4096):
        for dname in ("bfloat16", "float32"):
            attn_timing(1, sq, dname)
    # whisper-tiny's training call (m 8: micro-batch 2), 6 heads over 6,
    # non-causal (encoder, cross) and causal (decoder self-attention)
    for causal in (False, True):
        attn_timing(2, 4096, "bfloat16", hq=6, hkv=6, causal=causal)
    # gemma-2b's training call (micro-batch 2), MQA 8:1 at D 256
    attn_timing(2, 4096, "bfloat16", hq=8, hkv=1, d=256, split=True)
    norm_timing((1, 2048, D_MODEL))
    norm_timing((16, 4096, D_MODEL))
    norm_timing((2, 4096, 2048))          # rwkv6-1.6b's group norm, training
    # the training calls (micro-batch 2) of mixtral-8x7b and hymba-1.5b
    attn_timing(2, 4096, "bfloat16", hq=32, hkv=8, d=128, window=4096)
    attn_timing(2, 4096, "bfloat16", hq=25, hkv=5, window=1024)
    for d in WIDE_NORMS[:2]:
        norm_timing((2, 4096, d))
    return {"flash_attention_bwd": attn_timing(2, 4096, "bfloat16"),
            "rmsnorm_bwd": norm_timing((2, 4096, D_MODEL)),
            "wkv6_bwd": wkv_rec}


def card_generator(torch):
    """The generator the GPU-vs-CPU phases draw their weights from: seed 0
    on the card (a CPU generator takes ~25 s for mixtral-8x7b's 3.2 B
    parameters at 2 layers); the weights are then moved to each side."""
    return torch.Generator(device="cuda").manual_seed(0)


def serve_gaps(torch, arch, pcfg, prompt: int, batch: int = 2,
               n_dec: int = 4):
    """Prefill ``batch`` random prompts (an enc-dec's frames beside them)
    and decode ``n_dec`` greedy steps through the kernels on the card and
    through the plain versions on the CPU, same weights (fp32).  Returns
    each step's largest logit gap and the steps outside ``PORT_TOL`` or
    not finite."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models.lm import LMModel
    from repro_torch.tree import tree_map

    pshape = ShapeConfig("p", prompt, batch, "prefill")
    dshape = ShapeConfig("d", prompt + n_dec + 1, batch, "decode")
    params_cpu = LMModel(arch, pcfg, dtype=torch.float32, device="cpu").init(
        card_generator(torch))
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, arch.vocab, (batch, prompt), generator=gen)
    pbatch = prompt_batch(arch, prompts, torch.float32, gen)
    runs = {}
    for tag in ("cpu", "cuda"):
        model = LMModel(arch, pcfg, dtype=torch.float32, device=tag)
        dev = model.device
        params = tree_map(lambda a: a.to(dev), params_cpu)
        prefill = steps.build_prefill_step(model, pcfg, dev, pshape)
        decode = steps.build_serve_step(model, pcfg, dev, dshape)
        cache = model.init_cache(dshape, pcfg.n_micro, filled=False)
        logits, cache = prefill(params, cache, {k: v.to(dev)
                                                for k, v in pbatch.items()})
        runs[tag] = {"dev": dev, "decode": decode, "cache": cache,
                     "params": params, "logits": [logits.float().cpu()]}
    for _ in range(n_dec):
        tok = torch.argmax(runs["cpu"]["logits"][-1], -1)
        for r in runs.values():
            logits, r["cache"] = r["decode"](r["params"], r["cache"],
                                             tok.to(r["dev"]))
            r["logits"].append(logits.float().cpu())
    errs, bad = [], []
    for i, (a, b) in enumerate(zip(runs["cuda"]["logits"],
                                   runs["cpu"]["logits"])):
        errs.append(max_err(torch, a, b))
        if not (torch.allclose(a, b, rtol=PORT_TOL, atol=PORT_TOL)
                and bool(torch.isfinite(a).all())):
            bad.append(f"step {i}")
    return errs, bad


def phase_port(torch, arch_name: str, n_layers: int, prompt: int):
    """The port against itself: kernels on the card vs plain on the CPU."""
    from repro_torch import configs

    torch.backends.cuda.matmul.allow_tf32 = False
    arch = dataclasses.replace(configs.get_arch(arch_name), n_layers=n_layers)
    pcfg = configs.get_parallel(arch_name).with_(pipe=2, tp=1, data=1,
                                                  n_micro=2)
    batch, n_dec = 2, 4
    errs, bad = serve_gaps(torch, arch, pcfg, prompt, batch, n_dec)
    if bad:
        raise AssertionError(f"port GPU vs CPU {arch_name} at {bad}: max "
                             f"errs {errs} over tol {PORT_TOL}")
    emit({"phase": "port_gpu_vs_cpu", "arch": arch_name,
          "n_layers": n_layers, "pipe": 2, "dtype": "float32",
          "batch": batch, "prompt": prompt, "decode_steps": n_dec,
          "max_abs_err": errs, "tol": PORT_TOL, "ok": True})


def grad_gaps(torch, paths, got, want):
    """GPU-vs-CPU training check: ``got`` and ``want`` are (loss, grad
    leaves in ``paths`` order).  Returns each gap, each leaf's largest
    entry, and what fails: the loss at ``PORT_TOL``, each leaf at
    ``PORT_TOL`` and within ``GRAD_REL`` of its own largest entry, so a
    leaf of small gradients cannot pass zeroed."""
    errs = {"loss": max_err(torch, got[0], want[0])}
    tops, bad = {}, []
    if not torch.allclose(got[0], want[0], rtol=PORT_TOL, atol=PORT_TOL):
        bad.append("loss")
    for path, a, b in zip(paths, got[1], want[1]):
        errs[path] = max_err(torch, a, b)
        tops[path] = float(b.abs().max())
        if not (torch.allclose(a, b, rtol=PORT_TOL, atol=PORT_TOL)
                and errs[path] <= GRAD_REL * tops[path]
                and bool(torch.isfinite(a).all()) and tops[path] > 0):
            bad.append(path)
    return errs, tops, bad


def phase_train_port(torch, arch_name: str = "smollm-360m",
                     n_layers: int = 4, seq: int = 256):
    """Training, the port against itself: the GPipe loss and every gradient
    leaf through the kernels on the card vs the plain versions on the CPU,
    same weights and batch (fp32), so a dropped gradient cannot pass.
    smollm-360m runs attention and RMSNorm and their backward kernels,
    rwkv6-1.6b (tp 1) the WKV-6 and its group norm's."""
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models.lm import LMModel
    from repro_torch.tree import tree_items, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    arch = dataclasses.replace(configs.get_arch(arch_name),
                               n_layers=n_layers)
    pcfg = configs.get_parallel(arch_name).with_(pipe=2, tp=1, data=1,
                                                  n_micro=2)
    batch = 2
    g = torch.Generator().manual_seed(3)
    data = {k: torch.randint(0, arch.vocab, (batch, seq), generator=g)
            for k in ("tokens", "labels")}
    params_cpu = LMModel(arch, pcfg, dtype=torch.float32, device="cpu").init(
        card_generator(torch))
    runs = {}
    for dev in ("cpu", "cuda"):
        model = LMModel(arch, pcfg, dtype=torch.float32, device=dev)
        params = tree_map(lambda a: a.to(dev).requires_grad_(), params_cpu)
        leaves = [p for _, p in tree_items(params)]
        loss = steps.build_loss_fn(model, pcfg, model.device)(
            params, {k: v.to(dev) for k, v in data.items()})
        grads = torch.autograd.grad(loss, leaves)
        # compared on the card: the gaps of mixtral's 3.2 B gradients
        # take tens of seconds on the host
        runs[dev] = (loss.detach().cuda(), [gr.cuda() for gr in grads])
        del params, leaves, loss, grads
    paths = [p for p, _ in tree_items(params_cpu)]
    errs, tops, bad = grad_gaps(torch, paths, runs["cuda"], runs["cpu"])
    card_loss = float(runs["cuda"][0])
    del runs
    emit({"phase": "train_gpu_vs_cpu", "arch": arch.name,
          "n_layers": n_layers, "pipe": 2, "n_micro": 2, "batch": batch,
          "seq": seq, "dtype": "float32", "loss": card_loss,
          "max_abs_err": errs, "max_abs_ref": tops, "tol": PORT_TOL,
          "rel_tol": GRAD_REL, "ok": not bad})
    if bad:
        raise AssertionError(f"training GPU vs CPU disagrees at {bad}: "
                             f"{errs}")


def grad_runs(torch, arch, base, cases, data):
    """The loss and every gradient leaf (in ``tree_items`` order) of each
    case (``base.with_(**cases[name])``) through the kernels on the card and
    through the plain versions on the CPU ("gpipe_tasked" on the card
    only), with the same weights in every case, stacked for its stages
    (fp32).  Returns ``({(name, device): (loss, grads)}, paths)``."""
    from repro_torch.launch import steps
    from repro_torch.models.lm import LMModel
    from repro_torch.tree import tree_items, tree_map

    runs = {}
    for name, kw in cases.items():
        pcfg = base.with_(**kw)
        params_cpu = LMModel(arch, pcfg, dtype=torch.float32,
                             device="cpu").init(
            torch.Generator().manual_seed(0))
        for d in (("cpu", "cuda") if name != "gpipe_tasked" else ("cuda",)):
            model = LMModel(arch, pcfg, dtype=torch.float32, device=d)
            params = tree_map(lambda a: a.to(model.device), params_cpu)
            grad_fn = steps.build_grad_fn(model, pcfg, model.device)
            loss, grads = grad_fn(params, {k: v.to(model.device)
                                           for k, v in data.items()})
            runs[name, d] = (loss.cpu(), [gr.cpu() for _, gr in
                                          tree_items(grads)])
            del params, grads
    return runs, [p for p, _ in tree_items(params_cpu)]


def bitwise_gaps(torch, paths, got, want):
    """Two schedules of one computation on the card (``(loss, grads)``
    each): the unequal leaves with their gaps, and the failures.  A leaf of
    ``NONDETERMINISTIC_LEAVES`` may differ within ``GRAD_REL``."""
    (l1, g1), (l0, g0) = got, want
    unequal = {} if torch.equal(l1, l0) else {"loss": max_err(torch, l1, l0)}
    bad = ["loss"] if unequal else []
    for path, a, b in zip(paths, g1, g0):
        if not torch.equal(a, b):
            unequal[path] = max_err(torch, a, b)
            if path not in NONDETERMINISTIC_LEAVES or unequal[path] > \
                    GRAD_REL * float(b.abs().max()):
                bad.append(path)
    return unequal, bad


def phase_train_fused_port(torch, n_layers: int = 4, seq: int = 256,
                           batch: int = 4):
    """The fused F+B executor, the port against itself: loss and every
    gradient leaf of 1f1b (m 2), zb with residuals "reuse" under remat
    "none" and "full" (m 4) and interleaved:2 (m 2) through the kernels on
    the card vs the
    plain versions on the CPU, same weights and batch (fp32), as in
    :func:`phase_train_port`; then 1f1b against gpipe_tasked on the card,
    which must be bitwise equal under grad_reduce "ordered" except in the
    leaves of ``NONDETERMINISTIC_LEAVES``, held at ``GRAD_REL``."""
    from repro_torch import configs

    torch.backends.cuda.matmul.allow_tf32 = False
    arch = dataclasses.replace(configs.get_arch("smollm-360m"),
                               n_layers=n_layers)
    g = torch.Generator().manual_seed(4)
    data = {k: torch.randint(0, arch.vocab, (batch, seq), generator=g)
            for k in ("tokens", "labels")}
    cases = {"1f1b": dict(schedule="1f1b", n_micro=2),
             "zb-reuse": dict(schedule="zb", residuals="reuse",
                              remat="none", n_micro=4),
             "zb-reuse-full": dict(schedule="zb", residuals="reuse",
                                   remat="full", n_micro=4),
             "interleaved:2": dict(schedule="interleaved:2", n_micro=2),
             "gpipe_tasked": dict(schedule="gpipe_tasked", n_micro=2)}
    base = configs.get_parallel("smollm-360m").with_(pipe=2, data=1)
    runs, paths = grad_runs(torch, arch, base, cases, data)
    bad, recs = [], {}
    for name in ("1f1b", "zb-reuse", "zb-reuse-full", "interleaved:2"):
        errs, _, failed = grad_gaps(torch, paths, runs[name, "cuda"],
                                    runs[name, "cpu"])
        bad += [f"{name} {f}" for f in failed]
        recs[name] = {"loss": float(runs[name, "cuda"][0]),
                      "max_abs_err": errs}
    # 1f1b and gpipe_tasked on the card: the same per-(stage, micro) work,
    # folded in micro order
    unequal, failed = bitwise_gaps(torch, paths, runs["1f1b", "cuda"],
                                   runs["gpipe_tasked", "cuda"])
    bad += [f"1f1b vs gpipe_tasked {f}" for f in failed]
    emit({"phase": "train_fused_gpu_vs_cpu", "arch": arch.name,
          "n_layers": n_layers, "pipe": 2, "batch": batch, "seq": seq,
          "dtype": "float32", "schedules": recs, "tol": PORT_TOL,
          "rel_tol": GRAD_REL, "bitwise_1f1b_vs_gpipe_tasked": not unequal,
          "unequal_leaves": unequal, "ok": not bad})
    if bad:
        raise AssertionError(f"fused training disagrees at {bad}")



def phase_fused_bitwise(torch, arch_name: str = "gemma-2b", seq: int = 4096,
                        batch: int = 16):
    """1f1b against gpipe_tasked at full size on the card: one grad call of
    each (bf16, the config's pipe, tp 1, m 8, remat "full") on the same
    weights and batch, under :func:`deterministic` (in bf16 the embedding's
    atomic index_add_ moves its gradient by ulps of 2^-8); the loss and
    every gradient leaf bitwise equal."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.launch import steps
    from repro_torch.launch.train import model_batch
    from repro_torch.models.lm import LMModel
    from repro_torch.tree import tree_items

    arch = configs.get_arch(arch_name)
    base = configs.get_parallel(arch_name).with_(data=1, tp=1, n_micro=8,
                                                 remat="full")
    runs, params, data = {}, None, None
    for schedule in ("1f1b", "gpipe_tasked"):
        pcfg = base.with_(schedule=schedule)
        model = LMModel(arch, pcfg, dtype=torch.bfloat16, device="cuda")
        if params is None:
            params = model.init(torch.Generator(device=model.device
                                                ).manual_seed(0))
            data = model_batch(to_device(SyntheticLM(DataConfig(
                seed=0, vocab=arch.vocab, seq_len=seq, global_batch=batch),
                arch).batch_at(0), model.device), torch.bfloat16)
        with deterministic(torch):       # the embedding's index_add_
            loss, grads = steps.build_grad_fn(model, pcfg, model.device)(
                params, data)
        runs[schedule] = (loss.float(), [g for _, g in tree_items(grads)])
    paths = [p for p, _ in tree_items(params)]
    unequal, _ = bitwise_gaps(torch, paths, runs["1f1b"],
                              runs["gpipe_tasked"])
    emit({"phase": "fused_bitwise", "arch": arch.name,
          "n_layers": arch.n_layers, "pipe": base.pipe, "n_micro": 8,
          "seq": seq, "batch": batch, "dtype": "bfloat16",
          "loss": float(runs["1f1b"][0]), "leaves": len(paths),
          "bitwise_1f1b_vs_gpipe_tasked": not unequal,
          "unequal_leaves": unequal, "ok": not unequal})
    if unequal:
        raise AssertionError(f"1f1b vs gpipe_tasked differ at {unequal}")

def phase_whisper_port(torch, pipe: int = 4, seq: int = 256,
                       batch: int = 4):
    """``whisper_gpu_vs_cpu``: whisper-tiny at full width, all 8 blocks,
    pipe 4 (``mem`` 1 -> (2, 3), ``dec_in`` 0 -> 2; eight stages and
    ``mem`` 3 -> (4, 5, 6, 7) under interleaved:2), fp32 with TF32 off, the
    same weights through the kernels on the card and through the plain
    versions on the CPU.  Training, batch 4, m 4, seq 256: the loss and
    every gradient leaf of gpipe (autograd), 1f1b, zb with residuals
    "reuse" under remat "full" and interleaved:2 at ``PORT_TOL`` and
    ``GRAD_REL``, the encoder layers' ``lnx`` / ``xattn`` gradients exactly
    0 on both; 1f1b against gpipe_tasked bitwise on the card but for
    ``NONDETERMINISTIC_LEAVES``.  Serving (:func:`serve_gaps`), batch 2,
    m 2: prefill over 256 frames and a 256-token prompt, then 4 decode
    steps, logits compared."""
    from repro_torch import configs
    from repro_torch.models.lm import LMModel

    torch.backends.cuda.matmul.allow_tf32 = False
    arch = configs.get_arch("whisper-tiny")
    g = torch.Generator().manual_seed(7)
    data = {"frames": torch.randn(batch, seq, arch.d_model, generator=g)
            * 0.1,
            "dec_tokens": torch.randint(0, arch.vocab, (batch, seq),
                                        generator=g),
            "labels": torch.randint(0, arch.vocab, (batch, seq),
                                    generator=g)}
    cases = {"gpipe": dict(schedule="gpipe"),
             "1f1b": dict(schedule="1f1b"),
             "zb-reuse-full": dict(schedule="zb", residuals="reuse",
                                   remat="full"),
             "interleaved:2": dict(schedule="interleaved:2"),
             "gpipe_tasked": dict(schedule="gpipe_tasked")}
    base = configs.get_parallel("whisper-tiny").with_(pipe=pipe, tp=1,
                                                       data=1, n_micro=4)
    runs, paths = grad_runs(torch, arch, base, cases, data)
    bad, recs = [], {}
    for name in ("gpipe", "1f1b", "zb-reuse-full", "interleaved:2"):
        errs, _, failed = grad_gaps(torch, paths, runs[name, "cuda"],
                                    runs[name, "cpu"])
        bad += [f"{name} {f}" for f in failed]
        model = LMModel(arch, base.with_(**cases[name]), device="meta")
        recs[name] = {"loss": float(runs[name, "cuda"][0]),
                      "max_abs_err": errs,
                      "skips": [(e.name, e.src_stage, list(e.dsts))
                                for e in model.skips()]}
        # an encoder layer's cross-attention is skipped: exact zeros
        consts = model.consts()
        enc = list(zip(*((consts["mask"] > 0)
                         & (consts["cross"] == 0)).nonzero()))
        for d in ("cpu", "cuda"):
            for path, gr in zip(paths, runs[name, d][1]):
                if path.startswith(("stages/lnx", "stages/xattn")) and any(
                        bool(gr[s, l].abs().max() > 0) for s, l in enc):
                    bad.append(f"{name} {d} {path}: an encoder layer's "
                               "cross-attention gradient is not 0")
    unequal, failed = bitwise_gaps(torch, paths, runs["1f1b", "cuda"],
                                   runs["gpipe_tasked", "cuda"])
    bad += [f"1f1b vs gpipe_tasked {f}" for f in failed]
    serve_errs, failed = serve_gaps(torch, arch, base.with_(n_micro=2), seq)
    bad += [f"serve {f}" for f in failed]
    emit({"phase": "whisper_gpu_vs_cpu", "arch": arch.name,
          "n_layers": arch.n_layers + arch.enc_layers, "pipe": pipe,
          "batch": batch, "n_micro": 4, "seq": seq, "dtype": "float32",
          "tf32": False, "schedules": recs, "tol": PORT_TOL,
          "rel_tol": GRAD_REL, "bitwise_1f1b_vs_gpipe_tasked": not unequal,
          "unequal_leaves": unequal, "serve_batch": 2, "serve_n_micro": 2,
          "decode_steps": 4, "serve_max_abs_err": serve_errs,
          "ok": not bad})
    if bad:
        raise AssertionError(f"whisper GPU vs CPU disagrees at {bad}")


def phase_train(torch, schedule: str = "gpipe",
                arch_name: str = "smollm-360m"):
    """A training main path: counters set to 0 just before, read after.
    smollm-360m with ``schedule`` "gpipe" is phase ``train``, with a fused
    schedule phase ``train_fused``, which also holds the executor's park
    high-water per rank to the plan's; whisper-tiny (pipe 8: ``mem``
    3 -> (4, 5, 6, 7), ``dec_in`` 0 -> 4) is phase ``whisper_train``, whose
    park and route high-water must equal the plan's ``depth`` /
    ``g_depth``; rwkv6-1.6b (pipe 8, tp 2 cut to 1, as served) is phase
    ``rwkv6_train``, which also reports the WKV-6 backward's share of the
    traced step's device time; gemma-2b (pipe 2), mixtral-8x7b (2 layers,
    pipe 2: ``TRAIN_CUT``) and hymba-1.5b (16 layers, pipe 8) are
    ``train`` / ``train_fused`` records with their ``"arch"``."""
    from repro_torch.core.plan import plan_for
    from repro_torch.launch.train import (expected_train_launches,
                                          launches, train)
    from repro_torch.models.lm import LMModel
    from repro_torch.optim.optimizers import OptimizerConfig

    arch, pcfg = cut_config(arch_name, TRAIN_CUT)
    pcfg = pcfg.with_(n_micro=8, remat="full", schedule=schedule)
    seq, batch, n_steps = 4096, 16, TRAIN_STEPS.get(arch_name, 5)
    ocfg = OptimizerConfig(lr=TRAIN_LR.get(arch_name, 5e-4), warmup_steps=0,
                           min_lr_ratio=1.0, dynamic_loss_scale=True)
    train_counters()
    res = train(arch, pcfg, seq_len=seq, batch=batch, steps=n_steps,
                device="cuda", dtype=torch.bfloat16, seed=0, ocfg=ocfg,
                fixed_batch=True, trace=True)
    totals = launches()
    hist = res["history"]
    want = expected_train_launches(pcfg, arch, seq)
    warm = sorted(r["step_s"] for r in hist[1:])
    step_s = warm[len(warm) // 2]          # median of steps 2..n_steps
    skips = LMModel(arch, pcfg, device="meta").skips()
    tplan = plan_for(schedule if schedule != "gpipe" else "gpipe_fwd",
                     pcfg.n_micro, pcfg.pipe, skips=skips,
                     portals=pcfg.portals)
    plan_park = tplan.per_stage_park
    route_plan = {rt.key: ({"depth": rt.depth, "g_depth": rt.g_depth}
                           if tplan.has_backward else {"depth": rt.depth})
                  for rt in tplan.routes}
    phase = ("whisper_train" if arch.is_encdec else "rwkv6_train"
             if arch.family == "ssm" else
             "train" if schedule == "gpipe" else "train_fused")
    fam = res["trace"]["by_family_ms"]
    rec = {"phase": phase,
           "arch": arch.name, "n_layers": arch.n_layers + arch.enc_layers,
           "pipe": pcfg.pipe, "tp": pcfg.tp, "data": pcfg.data,
           "n_micro": pcfg.n_micro, "schedule": schedule,
           "grad_reduce": pcfg.grad_reduce, "remat": pcfg.remat, "seq": seq,
           "batch": batch, "dtype": "bfloat16", "optimizer": "adamw",
           "lr": ocfg.lr, "losses": [r["loss"] for r in hist],
           "grad_norms": [r["grad_norm"] for r in hist],
           "skipped": hist[-1]["skipped"],
           "step_ms": [r["step_s"] * 1e3 for r in hist],
           "step_ms_median_warm": step_s * 1e3,
           "tokens_per_s": res["tokens_per_step"] / step_s,
           "model_flops_per_step": res["model_flops_per_step"],
           "model_flops_share": (res["model_flops_per_step"] / step_s
                                 / PEAK_BF16_FLOPS),
           "model_flops_formula": (
               "3 x (2 x matmul weights x tokens + 2 x 2 x K x V x heads x "
               "layers x tokens for the WKV recurrence) over the step time "
               "and 989 TFLOP/s" if arch.family == "ssm" else
               "3 x (2 x matmul weights x tokens (a moe layer's top_k "
               "experts and router) + 2 x 2 x hd x Hq x visible (q, k) "
               "pairs: sum of min(i + 1, window) causal, S x S for the "
               "encoder and cross-attention + a hybrid's scan, 2 x 2 x hd x "
               "N a token and head) over the step time and 989 TFLOP/s"),
           "wkv6_bwd_share_of_device_ms": (
               fam.get("wkv6_bwd (ours)", 0.0) / res["trace"]["device_ms"]
               if res["trace"]["device_ms"] else None),
           "peak_mem_gib": res["peak_mem_bytes"] / 2 ** 30,
           "skips": [(e.name, e.src_stage, list(e.dsts)) for e in skips],
           "park_high_water": res["park_info"],
           "park_plan": plan_park, "route_plan": route_plan,
           "launches_per_step": [r["launches"] for r in hist],
           "launches_expected_per_step": want, "launches_total": totals,
           "trace": res["trace"]}
    emit(rec)
    losses = rec["losses"]
    if not all(math.isfinite(x) for x in losses + rec["grad_norms"]):
        raise AssertionError(f"non-finite training: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"last loss {losses[-1]} not below step 1's "
                             f"{losses[0]}")
    per_step = [r["launches"] for r in hist] + [res["trace"]["launches"]]
    if any(n != want for n in per_step) or totals != {
            k: (n_steps + 1) * v for k, v in want.items()}:
        raise AssertionError(f"train launches {rec['launches_per_step']} / "
                             f"{totals} differ from the path's {want}")
    if tuple(res["park_info"]["per_stage_park"]) != tuple(plan_park) \
            or res["park_info"].get("per_route", {}) != route_plan:
        raise AssertionError(f"high-water {res['park_info']} differs from "
                             f"the plan's {plan_park}, {route_plan}")
    if arch.is_encdec and sum(k.startswith("mem@")
                              for k in route_plan) != 4:
        raise AssertionError(f"whisper at pipe 8 ran routes {route_plan}, "
                             "not mem's four destinations")
    return totals


def phase_memory(torch):
    """Peak memory of one train step under each remat policy: "full",
    "dots", "dots_no_batch" and "none".

    The bytes first (smollm-360m, bf16, 32 layers, seq 4096, batch 4, m 4:
    16,384 tokens).  "none" keeps every layer's saved activations until its
    backward: ~40 KB a token a layer (norm inputs and outputs, q / k / v and
    their contiguous copies, the attention output twice, four d_ff-wide MLP
    tensors), ~21 GB, plus ~6 GB of weights, gradients and fp32 AdamW
    state: it fits on the 80 GB card.  "full" keeps each stage's input
    (16 stages x 4 micro-batches x 7.9 MB) and one stage's recompute at a
    time beside ~6 GB of weights, gradients and optimizer state, which the
    optimizer updates in place one leaf at a time: ~8 GB.  "dots" keeps,
    beside "full"'s, the outputs of q, k, v, o and the three MLP products:
    960 + 320 + 320 + 960 + 2 x 2,560 + 960 = 8,640 bf16 values a token a
    layer, 70.8 MB a layer and micro-batch, 9.06 GB over 32 layers and 4
    micro-batches: ~15-16.5 GiB.  On the card attention is a kernel, so no
    ``bmm`` runs and "dots_no_batch" keeps the same.  Each must lie
    between "full" and "none"."""
    from repro_torch import configs
    from repro_torch.launch.train import train
    from repro_torch.optim.optimizers import OptimizerConfig

    arch = configs.get_arch("smollm-360m")
    peaks = {}
    for remat in ("full", "dots", "dots_no_batch", "none"):
        pcfg = configs.get_parallel("smollm-360m").with_(
            data=1, tp=1, n_micro=4, remat=remat)
        res = train(arch, pcfg, seq_len=4096, batch=4, steps=1,
                    device="cuda", dtype=torch.bfloat16, seed=0,
                    ocfg=OptimizerConfig(dynamic_loss_scale=True),
                    fixed_batch=True)
        peaks[remat] = res["peak_mem_bytes"] / 2 ** 30
        if not math.isfinite(res["history"][0]["loss"]):
            raise AssertionError(f"remat {remat}: non-finite loss")
        torch.cuda.empty_cache()
    ok = all(peaks["full"] < peaks[p] < peaks["none"]
             for p in ("dots", "dots_no_batch"))
    emit({"phase": "memory", "arch": arch.name, "seq": 4096, "batch": 4,
          "n_micro": 4, "pipe": 16, "dtype": "bfloat16",
          "peak_mem_gib": peaks,
          "dots_minus_dots_no_batch_mib":
              (peaks["dots"] - peaks["dots_no_batch"]) * 1024, "ok": ok})
    if not ok:
        raise AssertionError(f"peaks {peaks} GiB: want full < dots, "
                             "dots_no_batch < none")


# ---------------------------------------------------------------------------
# heterogeneous pipelines: U-Net and AmoebaNet-D (paper §4.2), skip routes
# ---------------------------------------------------------------------------

# SGD with momentum 0.9 at this constant lr (the paper trains AmoebaNet with
# plain SGD); at 0.05 U-Net's loss oscillated over the five steps.
HETERO_LR = 0.01
# The batches (multiples of m = 8) hetero_memory tries, largest first, for
# U-Net (5, 64)'s gpipe step under remat "none": 160 peaked at 77.4 GiB on
# the 80 GB card; the phase takes the first that fits.
HETERO_MEMORY_BATCHES = (160, 152, 144, 128)


def phase_hetero_port(torch, pipe: int = 4, m: int = 4, batch: int = 8):
    """``hetero_gpu_vs_cpu``: the same weights through the port on the card
    and on the CPU, fp32 (the program turns TF32 off while it runs:
    ``pipeline_hetero.fp32_math``), deterministic cuDNN: U-Net (1, 8), 4
    levels at 64 x 64 and AmoebaNet (6, 32) at 64 x 64, pipe 4, batch 8,
    m 4.  The pipelined forward, then the loss and every gradient leaf of
    gpipe (autograd), gpipe_tasked, 1f1b, zb with residuals "reuse" under
    remat "full" and interleaved:2 (portals), at ``PORT_TOL`` and
    ``GRAD_REL``; a leaf the model never uses (the U-Net head's norm) must
    be exactly 0 on both.  On the card, bit for bit: portals against
    threaded skips (gpipe and 1f1b) and gpipe_tasked against 1f1b."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.train_hetero import target_shape
    from repro_torch.models import pipeline_hetero as PH
    from repro_torch.models.amoebanet import AmoebaConfig, AmoebaNetModel
    from repro_torch.models.unet import UNetConfig, UNetModel
    from repro_torch.tree import tree_items

    torch.backends.cudnn.deterministic = True
    models = {"unet": (UNetModel, UNetConfig(B=1, C=8, levels=4, img=64)),
              "amoebanet": (AmoebaNetModel, AmoebaConfig(
                  L=6, F=32, img=64, n_classes=10))}
    cases = {"gpipe": dict(schedule="gpipe"),
             "gpipe_tasked": dict(schedule="gpipe_tasked"),
             "1f1b": dict(schedule="1f1b"),
             "zb-reuse-full": dict(schedule="zb", residuals="reuse"),
             "interleaved:2": dict(schedule="interleaved:2")}
    bad, recs = [], {}
    for mname, (cls, mcfg) in models.items():
        params = cls(mcfg, pipe).init(torch.Generator().manual_seed(5),
                                      "cpu")
        paths = [p for p, _ in tree_items(dict(enumerate(params)))]
        g = torch.Generator().manual_seed(6)
        x = torch.randn(batch, mcfg.in_ch, mcfg.img, mcfg.img, generator=g)
        y = torch.randn(target_shape(mcfg, batch), generator=g)

        def build(case, dev, portals=True):
            pcfg = ParallelConfig(pipe=pipe, tp=1, data=1, n_micro=m,
                                  remat="full", portals=portals,
                                  **cases[case])
            model = cls(mcfg, pipe * pcfg.virtual_stages)
            return model, pcfg, PH.build_hetero_program(model, params, pcfg,
                                                         dev)

        def grads_of(case, dev, portals=True):
            model, pcfg, prog = build(case, dev, portals)
            loss, grads = PH.hetero_grad_call(prog, pcfg)(
                prog.stage_params, x.to(dev), y.to(dev))
            layers = dict(enumerate(PH.layer_list(model, grads)))
            return loss.cpu(), [t.cpu() for _, t in tree_items(layers)]

        fwd = {}
        for dev in ("cpu", "cuda"):
            _, pcfg, prog = build("gpipe", dev)
            with torch.no_grad():
                fwd[dev] = PH.hetero_forward(prog, pcfg, x.to(dev)).cpu()
        rec = {"forward_max_abs_err": max_err(torch, fwd["cuda"],
                                              fwd["cpu"])}
        if not (torch.allclose(fwd["cuda"], fwd["cpu"], rtol=PORT_TOL,
                               atol=PORT_TOL)
                and bool(torch.isfinite(fwd["cuda"]).all())):
            bad.append(f"{mname} forward")
        runs = {}
        for case in cases:
            runs[case] = gpu = grads_of(case, "cuda")
            cpu = grads_of(case, "cpu")
            used = [k for k, w in enumerate(cpu[1]) if bool(w.abs().max() > 0)]
            unused = [paths[k] for k in range(len(paths)) if k not in used]
            bad += [f"{mname} {case} {p} (unused) nonzero" for k, p
                    in enumerate(paths) if p in unused
                    and bool(gpu[1][k].abs().max() > 0)]
            errs, _, failed = grad_gaps(
                torch, [paths[k] for k in used],
                (gpu[0], [gpu[1][k] for k in used]),
                (cpu[0], [cpu[1][k] for k in used]))
            bad += [f"{mname} {case} {f}" for f in failed]
            rec[case] = {"loss": float(gpu[0]), "loss_err": errs["loss"],
                         "max_grad_err": max(v for k, v in errs.items()
                                             if k != "loss"),
                         "unused_leaves": unused}
        pairs = [("gpipe_tasked", runs["gpipe_tasked"], "1f1b",
                  runs["1f1b"])]
        if mname == "unet":
            pairs += [(f"{c} threaded", grads_of(c, "cuda", portals=False),
                       f"{c} portals", runs[c]) for c in ("gpipe", "1f1b")]
        rec["bitwise"] = {}
        for na, (la, ga), nb, (lb, gb) in pairs:
            unequal = [p for p, a, b in zip(paths, ga, gb)
                       if not torch.equal(a, b)]
            if not torch.equal(la, lb):
                unequal.append("loss")
            rec["bitwise"][f"{na} vs {nb}"] = unequal or True
            bad += [f"{mname} {na} vs {nb} {p}" for p in unequal]
        recs[mname] = rec
    torch.backends.cudnn.deterministic = False
    emit({"phase": "hetero_gpu_vs_cpu", "pipe": pipe, "n_micro": m,
          "batch": batch, "dtype": "float32", "tf32": False,
          "cudnn_deterministic": True, "models": recs, "tol": PORT_TOL,
          "rel_tol": GRAD_REL, "ok": not bad})
    if bad:
        raise AssertionError(f"hetero GPU vs CPU disagrees at {bad}")


def phase_hetero_train(torch, mname: str, schedule: str):
    """``hetero_train``: the hetero main path at the paper's width through
    ``repro_torch.launch.train_hetero.train_hetero``, the launch counters
    set to 0 just before and read just after (the path runs none of the
    port's kernels: convolutions, norms and pools are cuDNN's and
    PyTorch's).  fp32 (TF32 off: ``pipeline_hetero.fp32_math``), cuDNN's
    default algorithm choice, pipe 8, m 8, remat "full", portals,
    SGD with momentum 0.9 at ``HETERO_LR``: U-Net (5, 64) at 192 x 192,
    batch 32; AmoebaNet-D (18, 256) at 224 x 224, batch 64.  5 steps on one
    fixed batch and a sixth under the profiler.  Gates: finite losses, step
    5's below step 1's, the park high-water per rank and every route's
    high-water equal to the plan's, no launch of the port's kernels."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd
    from repro_torch.launch.train_hetero import PAPER, sgd, train_hetero

    batch = {"unet": 32, "amoebanet": 64}[mname]
    pcfg = ParallelConfig(pipe=8, tp=1, data=1, n_micro=8, remat="full",
                          portals=True, schedule=schedule)
    kernels = {"flash_attention": flash_attention, "rmsnorm": rmsnorm,
               "wkv6": wkv6, "flash_attention_bwd": flash_attention_bwd,
               "rmsnorm_bwd": rmsnorm_bwd, "wkv6_bwd": wkv6_bwd}
    for fn in kernels.values():
        fn.launches = 0
    res = train_hetero(PAPER[mname], pcfg, batch=batch, steps=5,
                       device="cuda", ocfg=sgd(HETERO_LR), trace=True)
    launches = {k: fn.launches for k, fn in kernels.items()}
    model, hist, info = res["model"], res["history"], res["park_info"]
    summary = res["summary"]                       # median of steps 2..5
    losses = [r["loss"] for r in hist]
    out = {"phase": "hetero_train", "model": mname,
           "config": dataclasses.asdict(model.cfg),
           "n_layers": len(model.layers), "params": model.total_params(),
           "sizes": model.sizes, "pipe": pcfg.pipe, "n_micro": pcfg.n_micro,
           "schedule": schedule, "grad_reduce": pcfg.grad_reduce,
           "remat": pcfg.remat, "portals": pcfg.portals, "batch": batch,
           "dtype": "float32", "tf32": False, "cudnn_benchmark": False,
           "optimizer": "sgd", "momentum": 0.9, "lr": HETERO_LR,
           "losses": losses, "grad_norms": [r["grad_norm"] for r in hist],
           "step_ms": [r["step_s"] * 1e3 for r in hist], **summary,
           "fp32_peak_share": summary["fp32_tflops"] * 1e12
                              / PEAK_FP32_FLOPS,
           "flops_formula": "3 x forward conv FLOPs (2 x multiply-adds of "
                            "every conv at its output size, and the "
                            "AmoebaNet head's product) x batch; the "
                            "recompute not counted",
           "park_high_water": info, "park_plan": res["park_plan"],
           "route_plan": res["route_plan"], "launches": launches,
           "trace": res["trace"]}
    emit(out)
    if not all(math.isfinite(v) for v in losses + out["grad_norms"]):
        raise AssertionError(f"{mname} {schedule}: non-finite training: "
                             f"{losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{mname} {schedule}: step-5 loss {losses[-1]}"
                             f" not below step 1's {losses[0]}")
    if tuple(info["per_stage_park"]) != tuple(res["park_plan"]) \
            or info.get("per_route", {}) != res["route_plan"]:
        raise AssertionError(f"{mname} {schedule}: high-water {info} "
                             f"differs from the plan's {res['park_plan']}, "
                             f"{res['route_plan']}")
    if any(launches.values()):
        raise AssertionError(f"the hetero path launched kernels of the "
                             f"port: {launches}")
    if mname == "unet" and not res["route_plan"]:
        raise AssertionError("U-Net at pipe 8 ran no skip route")


def hetero_peak_gib(torch, remat: str, batch: int):
    """Peak memory of one U-Net (5, 64) gpipe train step (pipe 8, m 8) under
    ``remat``, and its loss."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.train_hetero import PAPER, sgd, train_hetero

    pcfg = ParallelConfig(pipe=8, tp=1, data=1, n_micro=8, remat=remat,
                          portals=True, schedule="gpipe")
    res = train_hetero(PAPER["unet"], pcfg, batch=batch, steps=1,
                       device="cuda", ocfg=sgd(HETERO_LR))
    return res["summary"]["peak_mem_gib"], res["history"][0]["loss"]


def phase_hetero_memory(torch):
    """``hetero_memory``: peak device memory of one U-Net (5, 64) train step
    at 192 x 192 (gpipe, pipe 8, m 8, fp32) under remat "none" at the
    largest batch of ``HETERO_MEMORY_BATCHES`` that fits on the card, and
    under "full" at that batch: the paper's Table 3 on one card; "full"
    must be the lower."""
    import gc

    peaks, losses, tried = {}, {}, []
    for batch in HETERO_MEMORY_BATCHES:
        torch.cuda.empty_cache()
        tried.append(batch)
        try:
            peaks["none"], losses["none"] = hetero_peak_gib(torch, "none",
                                                            batch)
            break
        except torch.cuda.OutOfMemoryError:
            gc.collect()
    else:
        raise AssertionError(f"remat none fits at none of {tried}")
    torch.cuda.empty_cache()
    peaks["full"], losses["full"] = hetero_peak_gib(torch, "full", batch)
    torch.cuda.empty_cache()
    ok = peaks["full"] < peaks["none"] and all(
        math.isfinite(v) for v in losses.values())
    emit({"phase": "hetero_memory", "model": "unet", "B": 5, "C": 64,
          "img": 192, "batch": batch, "batches_tried": tried, "n_micro": 8,
          "pipe": 8, "schedule": "gpipe", "dtype": "float32",
          "peak_mem_gib": peaks, "losses": losses, "ok": ok})
    if not ok:
        raise AssertionError(f"remat full peak {peaks['full']} GiB is not "
                             f"below none's {peaks['none']} GiB, or a loss "
                             f"is not finite: {losses}")


def phase_serve(torch, arch_name: str):
    """One main path: counters set to 0 just before, read just after, and
    held to ``launch.serve.expected_serve_launches``; ``SERVE_CUT`` cuts
    an arch's depth (full width) and may set its pipe, the config's
    otherwise."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd
    from repro_torch.launch.serve import expected_serve_launches, serve

    counters = {"flash_attention": flash_attention, "rmsnorm": rmsnorm,
                "wkv6": wkv6}
    # serving runs none
    backward = (flash_attention_bwd, rmsnorm_bwd, wkv6_bwd)
    arch, pcfg = cut_config(arch_name, SERVE_CUT)
    full_layers = configs.get_arch(arch_name).n_layers
    batch, prompt, gen = 8, 2048, 32
    for fn in (*counters.values(), *backward):
        fn.launches = 0
    res = serve(arch, pcfg, prompt_len=prompt, gen=gen, batch=batch,
                device="cuda", dtype=torch.bfloat16, seed=0)
    totals = {k: fn.launches for k, fn in counters.items()}
    m, layers = res["n_micro"], arch.n_layers + arch.enc_layers
    want = expected_serve_launches(arch, pcfg, m, gen)
    want_totals = {k: want["prefill"][k] + want["decode"][k] for k in totals}
    per_step = {k: v / (gen - 1) for k, v in res["launches"]["decode"].items()}
    logits = res["logits"]
    toks = res["tokens"]
    emit({"phase": "serve", "arch": arch.name, "family": arch.family,
          "n_layers": layers, "n_layers_config": full_layers,
          "frontend": arch.frontend, "pipe": pcfg.pipe, "tp": pcfg.tp,
          "data": pcfg.data, "n_micro": m, "batch": batch, "prompt": prompt,
          "gen": gen, "dtype": "bfloat16",
          "prefill_ms": res["prefill_s"] * 1e3,
          "decode_s": res["decode_s"],
          "decode_tok_per_s": res["decode_tok_per_s"],
          "peak_mem_gib": res["peak_mem_bytes"] / 2 ** 30,
          "launches": res["launches"], "launches_per_decode_step": per_step,
          "launches_total": totals, "launches_expected": want,
          "sample_tokens": toks[0][:8].tolist()})
    if m != 8:
        raise AssertionError(f"expected m = 8 at batch 8, got {m}")
    if any(fn.launches for fn in backward):
        raise AssertionError("serving launched a backward kernel")
    if res["launches"] != want or totals != want_totals:
        raise AssertionError(f"launch counts {res['launches']} / {totals} "
                             f"differ from the path's {want}")
    if tuple(logits.shape) != (batch, 1, arch.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("serving logits are not finite [B, 1, V]")
    if toks.shape != (batch, gen) or toks.min() < 0 \
            or toks.max() >= arch.vocab:
        raise AssertionError(f"bad generated tokens {toks.shape}")
    return totals


# ---------------------------------------------------------------------------
# Stream injection, the wire codec, int8 gradient compression (whisper-tiny)
# ---------------------------------------------------------------------------

WHISPER_SEQ, WHISPER_BATCH, WHISPER_PROMPT = 4096, 16, 2048
MIXED_WIRE = "chain=fp32,portal=int8-ef,cotangent=bf16"
# a lossy run's loss curve against the lossless one at every step (the
# reference's rule, tests/test_wire.py), and it must fall
CURVE_RTOL = 5e-2


@contextlib.contextmanager
def deterministic(torch):
    """Deterministic algorithms for the bitwise pairs (the embedding's
    gradient is an index_add_, which sums in any order on the card
    otherwise), without filling fresh memory; warnings only where an op
    has no deterministic form."""
    import torch.utils.deterministic as det
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        det.fill_uninitialized_memory = before[2]


def train_counters():
    """The training path's kernel counters, each set to 0."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd
    fns = {"flash_attention": flash_attention,
           "flash_attention_bwd": flash_attention_bwd,
           "rmsnorm": rmsnorm, "rmsnorm_bwd": rmsnorm_bwd,
           "wkv6": wkv6, "wkv6_bwd": wkv6_bwd}
    for fn in fns.values():
        fn.launches = 0
    return fns


def whisper_pcfg(pipe: int, **kw):
    """whisper-tiny's PARALLEL (pipe 8) or PARALLEL_OPTIMIZED (pipe 2, which
    asks for stream_inputs), tp, data and dp2 cut to 1 (one process; the
    mesh cases run tp 2), m 8, remat "full", streaming off unless ``kw``
    turns it on."""
    from repro_torch import configs
    cfg = configs.get_parallel("whisper-tiny", optimized=pipe == 2)
    return cfg.with_(pipe=pipe, tp=1, data=1, dp2=1, n_micro=8,
                     remat="full", stream_inputs=False).with_(**kw)


def whisper_grads(torch, pcfg, runs: dict):
    """One grad call of whisper-tiny at full width, bf16, weights from seed
    0, on the fixed batch ``train`` steps on: ``(loss, grad leaves,
    park_info, plan, launches)``, the loss and grads copied to the host (a
    kept run holds no device memory the next run's peak would count).
    ``runs`` keeps each config's result for the phases that share it."""
    key = ("grads", pcfg)
    if key not in runs:
        runs[key] = _whisper_grads(torch, pcfg)
    return runs[key]


def _whisper_grads(torch, pcfg):
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.launch import steps
    from repro_torch.launch.train import launches, model_batch
    from repro_torch.models.lm import LMModel
    from repro_torch.tree import tree_items

    arch = configs.get_arch("whisper-tiny")
    model = LMModel(arch, pcfg, dtype=torch.bfloat16, device="cuda")
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    data = DataConfig(seed=0, vocab=arch.vocab, seq_len=WHISPER_SEQ,
                      global_batch=WHISPER_BATCH)
    batch = model_batch(to_device(SyntheticLM(data, arch).batch_at(0),
                                  model.device), torch.bfloat16)
    grad_fn = steps.build_grad_fn(model, pcfg, model.stage_devices)
    l0 = launches()
    loss, grads = grad_fn(params, batch)
    torch.cuda.synchronize()
    l1 = launches()
    return (loss.cpu(), [g.cpu() for _, g in tree_items(grads)],
            dict(grad_fn.park_info), grad_fn.tplan,
            {k: l1[k] - l0[k] for k in l0})


def unequal_leaves(torch, a, b):
    """Where two ``(loss, leaves, ...)`` runs differ: "loss" or the leaf
    index, with the largest gap."""
    out = {} if torch.equal(a[0], b[0]) else {"loss": max_err(torch, a[0],
                                                              b[0])}
    out.update({i: max_err(torch, x, y)
                for i, (x, y) in enumerate(zip(a[1], b[1]))
                if not torch.equal(x, y)})
    return out


def whisper_train(torch, pcfg, runs: dict, *, trace: bool = False):
    """``launch.train.train`` on whisper-tiny: 5 steps at full width, bf16,
    seq 4096, batch 16 on one fixed batch (AdamW at a constant lr, dynamic
    loss scale, as ``phase_train``), with the step's launches held to the
    path's formulas.  Returns the result and a summary record, kept in
    ``runs`` (a run asked again is not run again; its launches count in the
    phase that ran it)."""
    key = ("train", pcfg)
    if key not in runs or (trace and "trace" not in runs[key][1]):
        runs[key] = _whisper_train(torch, pcfg, trace)
    return runs[key]


def _whisper_train(torch, pcfg, trace: bool):
    from repro_torch import configs
    from repro_torch.launch.train import expected_train_launches, train
    from repro_torch.optim.optimizers import OptimizerConfig

    arch = configs.get_arch("whisper-tiny")
    ocfg = OptimizerConfig(lr=5e-4, warmup_steps=0, min_lr_ratio=1.0,
                           dynamic_loss_scale=True)
    res = train(arch, pcfg, seq_len=WHISPER_SEQ, batch=WHISPER_BATCH,
                steps=5, device="cuda", dtype=torch.bfloat16, seed=0,
                ocfg=ocfg, fixed_batch=True, trace=trace)
    hist = res["history"]
    want = expected_train_launches(pcfg, arch, WHISPER_SEQ)
    per_step = [r["launches"] for r in hist] + (
        [res["trace"]["launches"]] if trace else [])
    if any(n != want for n in per_step):
        raise AssertionError(f"{pcfg.schedule} stream={pcfg.stream_inputs} "
                             f"wire={pcfg.wire}: launches {per_step} differ "
                             f"from the path's {want}")
    warm = sorted(r["step_s"] for r in hist[1:])
    rec = {"schedule": pcfg.schedule, "pipe": pcfg.pipe,
           "stream_inputs": pcfg.stream_inputs, "wire": pcfg.wire,
           "grad_compression": pcfg.grad_compression,
           "losses": [r["loss"] for r in hist],
           "grad_norms": [r["grad_norm"] for r in hist],
           "step_ms": [r["step_s"] * 1e3 for r in hist],
           "step_ms_median_warm": warm[len(warm) // 2] * 1e3,
           "peak_mem_gib": res["peak_mem_bytes"] / 2 ** 30,
           "launches_per_step": want}
    if trace:
        t = res["trace"]
        rec["trace"] = {k: t[k] for k in ("wall_ms", "device_ms",
                                          "device_busy_ms", "idle_share",
                                          "device_events", "ranges")}
    if not all(math.isfinite(x) for x in rec["losses"] + rec["grad_norms"]):
        raise AssertionError(f"non-finite training: {rec}")
    return res, rec


def phase_stream(torch, runs: dict):
    """``stream``: whisper-tiny at full width, bf16, seq 4096, batch 16,
    m 8, streamed against replicated on the same weights and batch, under
    :func:`deterministic`.  At pipe 8 (PARALLEL: one micro-batch a rank
    each rotation) and pipe 2 (PARALLEL_OPTIMIZED: four slots a rank, so
    the rotation carries micro-batches), gpipe and 1f1b: the loss and every
    gradient of one grad call bitwise equal, 1f1b's stream stash
    high-water equal to the plan's; at pipe 8, 5 train steps of 1f1b
    (the wire phase's fp32 cell) each way, losses and grad norms bitwise
    equal, step ms and peak (gpipe's streaming is held by its grad
    calls at both pipes); the prefill's logits (batch 8, m 8,
    2048 frames and a 2048-token prompt) bitwise equal.  Launch counters
    set to 0 just before and read just after, held to the formulas."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.serve import expected_serve_launches, prompt_batch
    from repro_torch.launch.train import expected_train_launches
    from repro_torch.models.lm import LMModel

    arch = configs.get_arch("whisper-tiny")
    counters = train_counters()
    bad, grads_rec, curves = [], {}, {}
    with deterministic(torch):
        for pipe in (8, 2):
            for schedule in ("gpipe", "1f1b"):
                pair = [whisper_grads(torch, whisper_pcfg(
                    pipe, schedule=schedule, stream_inputs=s), runs)
                    for s in (False, True)]
                pcfg = whisper_pcfg(pipe, schedule=schedule)
                want = expected_train_launches(pcfg, arch, WHISPER_SEQ)
                diff = unequal_leaves(torch, pair[1], pair[0])
                fs, tplan = pair[1][2].get("per_stage_fs"), pair[1][3]
                key = f"pipe{pipe} {schedule}"
                grads_rec[key] = {"loss": float(pair[0][0]),
                                  "bitwise": not diff, "unequal": diff,
                                  "fs_high_water": fs,
                                  "fs_plan": (list(tplan.per_stage_fs)
                                              if schedule != "gpipe"
                                              else None)}
                if diff:
                    bad.append(f"{key}: streamed differs at {diff}")
                if schedule != "gpipe" and tuple(fs) != tuple(
                        tplan.per_stage_fs):
                    bad.append(f"{key}: fs high-water {fs} != the plan's "
                               f"{tplan.per_stage_fs}")
                if any(r[4] != want for r in pair):
                    bad.append(f"{key}: launches {[r[4] for r in pair]} "
                               f"!= {want}")
                torch.cuda.empty_cache()
        pair = [whisper_train(torch, whisper_pcfg(
            8, schedule="1f1b", stream_inputs=s), runs, trace=not s)[1]
            for s in (False, True)]
        curves["1f1b"] = pair
        if pair[0]["losses"] != pair[1]["losses"] \
                or pair[0]["grad_norms"] != pair[1]["grad_norms"]:
            bad.append(f"1f1b: streamed curve {pair[1]['losses']}"
                       f" != replicated {pair[0]['losses']}")
        torch.cuda.empty_cache()
        logits = []
        for s in (False, True):
            pcfg = whisper_pcfg(8, stream_inputs=s)
            pshape = ShapeConfig("prefill", WHISPER_PROMPT, 8, "prefill")
            dshape = ShapeConfig("decode", WHISPER_PROMPT + 1, 8, "decode")
            model = LMModel(arch, pcfg, dtype=torch.bfloat16, device="cuda")
            params = model.init(torch.Generator(device=model.device
                                                ).manual_seed(0))
            prefill = steps.build_prefill_step(model, pcfg,
                                               model.stage_devices, pshape)
            gen = torch.Generator(device=model.device).manual_seed(1)
            prompts = torch.randint(0, arch.vocab, (8, WHISPER_PROMPT),
                                    generator=gen, device=model.device)
            before = counters["flash_attention"].launches
            out, _ = prefill(params, model.init_cache(dshape, 8,
                                                      filled=False),
                             prompt_batch(arch, prompts, torch.bfloat16,
                                          gen))
            launched = counters["flash_attention"].launches - before
            if launched != expected_serve_launches(
                    arch, pcfg, 8, 2)["prefill"]["flash_attention"]:
                bad.append(f"prefill stream={s}: {launched} attention "
                           "launches")
            logits.append(out)
            del model, params, prefill
        if not torch.equal(logits[0], logits[1]):
            bad.append("prefill: streamed logits differ by "
                       f"{max_err(torch, logits[1], logits[0])}")
    totals = {k: fn.launches for k, fn in counters.items()}
    emit({"phase": "stream", "arch": arch.name, "seq": WHISPER_SEQ,
          "batch": WHISPER_BATCH, "n_micro": 8, "dtype": "bfloat16",
          "deterministic_algorithms": True, "grad_calls": grads_rec,
          "curves": curves, "prefill_bitwise": torch.equal(*logits),
          "launches_total": totals, "ok": not bad})
    if bad:
        raise AssertionError(f"stream: {bad}")
    return totals


def wire_report(torch):
    """``core.wire.plan_wire_report`` for whisper's 1f1b plan at pipe 8
    under each wire setting: the bytes a step would put on the links
    between cards, per payload class, priced on fp32-equivalent payloads
    ([2, 4096, 384] carries and skips)."""
    from repro_torch import configs
    from repro_torch.core.plan import plan_for
    from repro_torch.core.wire import WireSpec, plan_wire_report
    from repro_torch.models.lm import LMModel

    arch = configs.get_arch("whisper-tiny")
    pcfg = whisper_pcfg(8, schedule="1f1b")
    carry = WHISPER_BATCH // pcfg.n_micro * WHISPER_SEQ * arch.d_model * 4
    tplan = plan_for("1f1b", pcfg.n_micro, pcfg.pipe,
                     skips=LMModel(arch, pcfg, device="meta").skips(),
                     portals=True)
    out = {}
    for wire in ("fp32", "bf16", "int8-ef", MIXED_WIRE):
        rep = plan_wire_report(tplan, carry, spec=WireSpec.parse(wire))
        out[wire] = {k: rep[k] for k in ("bytes_per_step", "ratio",
                                         "per_class", "hops")}
    return out


def codec_on_card(torch) -> None:
    """One int8-ef payload of whisper's plan ([2, 4096, 384] bf16, from a
    seed), sent twice (the second send folds in the first's residual)
    through the wire codec on the card and on the CPU: the int8 blocks,
    scales, residuals and decoded values must be bitwise equal."""
    from repro_torch.core.pipeline import _Codec

    codec = _Codec("int8-ef", 256)
    gen = torch.Generator().manual_seed(0)
    shape = (WHISPER_BATCH // 8, WHISPER_SEQ, 384)
    sends = [torch.randn(shape, generator=gen).to(torch.bfloat16)
             for _ in range(2)]
    out = {}
    for dev in ("cpu", "cuda"):
        ef, got = codec.ef_zeros(sends[0].to(dev)), []
        for x in sends:
            x = x.to(dev)
            wire, ef = codec.enc(x, ef)
            got += [wire["q"], wire["s"], ef, codec.dec(wire, x)]
        out[dev] = [t.cpu() for t in got]
    unequal = [i for i, (a, b) in enumerate(zip(out["cpu"], out["cuda"]))
               if not torch.equal(a, b)]
    if unequal:
        raise AssertionError(f"wire codec: card differs from CPU at outputs "
                             f"{unequal} (q, s, ef, decoded per send)")


def int8_payloads(wire: str, hops: dict) -> int:
    """The payloads a step ships under an int8-ef class of ``wire``, from
    the plan's hop counts (``plan_wire_report``)."""
    from repro_torch.core.wire import WireSpec
    spec = WireSpec.parse(wire)
    per_class = {"chain": hops["chain"],
                 "cotangent": hops["cotangent_chain"]
                 + hops["route_cotangent"],
                 "portal": hops["route_value"]}
    return sum(n for cls, n in per_class.items()
               if getattr(spec, cls) == "int8-ef")


def phase_wire(torch, runs: dict):
    """``wire``: whisper-tiny at full width, bf16, pipe 8, 1f1b, seq 4096,
    batch 16, m 8, 5 train steps and a traced sixth under each wire, under
    :func:`deterministic`: ``bf16`` bitwise equal to ``fp32`` (the model's
    payloads are bf16: the cast is the identity) in its curve and in every
    gradient of one grad call; ``int8-ef`` and ``chain=fp32,portal=int8-ef,
    cotangent=bf16`` within ``CURVE_RTOL`` of fp32's curve at every step,
    falling, and not bitwise fp32's; gpipe with ``int8-ef`` raises.  The
    codec on the card is bitwise the CPU's on one payload
    (:func:`codec_on_card`); each traced step entered the ``wire_codec``
    range once to encode and once to decode every int8 payload the plan
    ships, and launched the same number of kernels for each payload under
    both lossy wires (none under fp32: bf16 payloads of a bf16 model take
    no range).  Prints the codec's device ms and kernels, the added device
    events against fp32's, and the plan's wire bytes per class.  Returns
    the launch totals and fp32's record."""
    from repro_torch import configs
    from repro_torch.core.pipeline import WIRE_CODEC_RANGE
    from repro_torch.launch import steps
    from repro_torch.models.lm import LMModel

    codec_on_card(torch)
    report = wire_report(torch)
    counters = train_counters()
    bad, recs = [], {}
    with deterministic(torch):
        for wire in ("fp32", "bf16", "int8-ef", MIXED_WIRE):
            recs[wire] = whisper_train(torch, whisper_pcfg(
                8, schedule="1f1b", wire=wire), runs,
                trace=wire != "bf16")[1]
            torch.cuda.empty_cache()
        pair = [whisper_grads(torch, whisper_pcfg(8, schedule="1f1b",
                                                  wire=w), runs)
                for w in ("fp32", "bf16")]
        diff = unequal_leaves(torch, pair[1], pair[0])
    base = recs["fp32"]
    if diff or recs["bf16"]["losses"] != base["losses"]:
        bad.append(f"bf16 wire differs from fp32: {diff}, "
                   f"{recs['bf16']['losses']} vs {base['losses']}")
    for wire in ("int8-ef", MIXED_WIRE):
        lossy = recs[wire]["losses"]
        gaps = [abs(a - b) / abs(b) for a, b in zip(lossy, base["losses"])]
        recs[wire]["rel_gap_to_fp32"] = gaps
        if max(gaps) > CURVE_RTOL or not lossy[-1] < lossy[0] \
                or lossy == base["losses"]:
            bad.append(f"{wire}: curve {lossy} vs fp32 {base['losses']}")
    per_payload = {}
    for wire in ("fp32", "int8-ef", MIXED_WIRE):
        rec, t0 = recs[wire], base["trace"]
        rec["added_device_events"] = (rec["trace"]["device_events"]
                                      - t0["device_events"])
        rec["added_device_ms"] = rec["trace"]["device_ms"] - t0["device_ms"]
        n = int8_payloads(wire, report[wire]["hops"])
        got = rec["trace"]["ranges"][WIRE_CODEC_RANGE]
        rec["int8_payloads"] = n
        if got["calls"] != 2 * n or (got["kernels"] == 0) != (n == 0) \
                or (n and got["kernels"] % n):
            bad.append(f"{wire}: wire_codec range launched {got['kernels']}"
                       f" kernels in {got['calls']} ranges for the plan's "
                       f"{n} int8 payloads")
        if n:
            per_payload[wire] = got["kernels"] // n
    if len(set(per_payload.values())) != 1:
        bad.append(f"codec kernels a payload differ: {per_payload}")
    try:
        pcfg = whisper_pcfg(8, schedule="gpipe", wire="int8-ef")
        steps.build_train_step(LMModel(configs.get_arch("whisper-tiny"),
                                       pcfg, device="cuda"), pcfg, "cuda",
                               None)
        bad.append("gpipe with an int8-ef wire did not raise")
    except ValueError as e:
        gpipe_raise = str(e)[:120]
    totals = {k: fn.launches for k, fn in counters.items()}
    emit({"phase": "wire", "arch": "whisper-tiny", "pipe": 8,
          "schedule": "1f1b", "seq": WHISPER_SEQ, "batch": WHISPER_BATCH,
          "n_micro": 8, "dtype": "bfloat16",
          "deterministic_algorithms": True, "runs": recs,
          "bf16_grads_bitwise": not diff, "gpipe_int8_ef_raises": gpipe_raise,
          "codec_card_bitwise_cpu": True,
          "codec_kernels_a_payload": per_payload,
          "plan_wire_report": report, "launches_total": totals,
          "ok": not bad})
    if bad:
        raise AssertionError(f"wire: {bad}")
    return totals, base


def phase_grad_compression(torch, runs: dict, fp32):
    """``grad_compression``: the wire phase's cell (1f1b, pipe 8, fp32
    wire) with ``grad_compression="int8_ef"``: 5 train steps and a traced
    sixth under :func:`deterministic`; the curve within ``CURVE_RTOL`` of
    ``fp32``'s (the wire phase's record) at every step, falling, and not
    bitwise the uncompressed curve; the error-feedback state 4 bytes a
    parameter; the traced step's ``grad_compression`` range entered once
    and launching kernels.  Prints the state's bytes, the step's peak and
    step ms beside the uncompressed run's, and the compressor's device ms
    and kernels."""
    from repro_torch.launch.steps import GRAD_COMPRESSION_RANGE

    n_params = sum(g.numel() for g in whisper_grads(
        torch, whisper_pcfg(8, schedule="1f1b", wire="fp32"), runs)[1])
    counters = train_counters()
    with deterministic(torch):
        res, rec = whisper_train(torch, whisper_pcfg(
            8, schedule="1f1b", grad_compression="int8_ef"), runs,
            trace=True)
    losses = rec["losses"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, fp32["losses"])]
    totals = {k: fn.launches for k, fn in counters.items()}
    comp = rec["trace"]["ranges"][GRAD_COMPRESSION_RANGE]
    bad = []
    if max(gaps) > CURVE_RTOL or not losses[-1] < losses[0] \
            or losses == fp32["losses"]:
        bad.append(f"curve {losses} vs {fp32['losses']}")
    if res["ef_bytes"] != 4 * n_params:
        bad.append(f"ef_bytes {res['ef_bytes']} != 4 x {n_params} params")
    if comp["calls"] != 1 or comp["kernels"] == 0:
        bad.append(f"grad_compression range: {comp}")
    ok = not bad
    emit({"phase": "grad_compression", "arch": "whisper-tiny", "pipe": 8,
          "schedule": "1f1b", "seq": WHISPER_SEQ, "batch": WHISPER_BATCH,
          "n_micro": 8, "dtype": "bfloat16", "block": 256,
          "deterministic_algorithms": True, "run": rec,
          "rel_gap_to_uncompressed": gaps,
          "uncompressed_losses": fp32["losses"],
          "ef_bytes": res["ef_bytes"], "n_params": n_params,
          "uncompressed_peak_mem_gib": fp32["peak_mem_gib"],
          "uncompressed_step_ms_median_warm": fp32["step_ms_median_warm"],
          "launches_total": totals, "ok": ok})
    if bad:
        raise AssertionError(f"grad_compression: {bad}")
    return totals


# ---------------------------------------------------------------------------
# dist_train: one process per pipe rank
# ---------------------------------------------------------------------------

DIST_RANKS = 4
DIST_STEPS = 3
# layers of the LMs dist_serve's ranks serve: smollm-360m's 32 and
# rwkv6-1.6b's 24 cut to 8 (two a rank) to keep the script inside its time
# limit; every bitwise gate holds at any depth
DIST_LAYERS = 8
DIST_SMOLLM = (("1f1b", "spmd"), ("1f1b", "mpmd"), ("gpipe_tasked", "spmd"),
               ("gpipe", "spmd"))
DIST_TIMEOUT_S = 900        # hard limit on the group, all its cases
DIST_HOP_TIMEOUT_S = 300    # one rendezvous, hop or collective


def dist_cases():
    """The cases the four ranks run, in order: smollm-360m at full width
    and depth (32 layers, seq 4096, batch 16, m 8, remat "full", bf16),
    pipe 4, under each (schedule, executor) of ``DIST_SMOLLM`` (gpipe's
    backward is autograd's, across the processes) and gpipe streamed (its
    grad call); whisper-tiny (all 8
    blocks), pipe 4, 1f1b, streamed, int8-ef wire; the U-Net (5, 64) at
    192 x 192, batch 32, pipe 4, m 8, fp32, gpipe with its portals,
    through ``launch.train_hetero``."""
    from repro_torch import configs
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.train_hetero import PAPER
    smollm = configs.get_parallel("smollm-360m").with_(
        data=1, tp=1, pipe=DIST_RANKS, n_micro=8, remat="full")
    cases = [dict(name=f"smollm-{s}-{e}", arch="smollm-360m",
                  pcfg=smollm.with_(schedule=s, executor=e), seq=4096,
                  batch=16, steps=DIST_STEPS) for s, e in DIST_SMOLLM]
    # streamed gpipe across processes (ROADMAP A4d): one grad call
    cases.append(dict(name="smollm-gpipe-stream", arch="smollm-360m",
                      pcfg=smollm.with_(schedule="gpipe",
                                        stream_inputs=True),
                      seq=4096, batch=16, steps=0))
    cases.append(dict(name="whisper-1f1b-stream-int8-ef", arch="whisper-tiny",
                      pcfg=whisper_pcfg(DIST_RANKS, schedule="1f1b",
                                        stream_inputs=True, wire="int8-ef"),
                      seq=WHISPER_SEQ, batch=WHISPER_BATCH, steps=0))
    cases.append(dict(name="unet-gpipe-spmd", arch="unet",
                      mcfg=PAPER["unet"], batch=32, steps=DIST_STEPS,
                      pcfg=ParallelConfig(pipe=DIST_RANKS, tp=1, data=1,
                                          n_micro=8, remat="full",
                                          portals=True, schedule="gpipe")))
    return cases


def digests(torch, tree) -> dict:
    """SHA-256 of each leaf's bytes, by path."""
    import hashlib
    from repro_torch.tree import tree_items
    return {path: hashlib.sha256(
        leaf.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
        .numpy().tobytes()).hexdigest() for path, leaf in tree_items(tree)}


def _dist_sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dist_peak_gib(torch, dev) -> float:
    return (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else 0.0)


def dist_run(torch, case, view, device: str = "cuda"):
    """One case, as a pipe rank of the pipe group's mesh ``view`` or
    (``view`` None) in one process: weights from seed 0 (the rank's
    share), one fixed batch; a
    grad call (its loss, the SHA-256 of every gradient leaf, per rank of
    the whole model's when in one process, the buffer high-water and
    hops, the kernel launches, the peak), then in the group ``steps``
    AdamW steps (losses, step ms, launches, and the embedding's digest
    after them)."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.launch import steps
    from repro_torch.launch.train import model_batch
    from repro_torch.models.lm import LMModel
    from repro_torch.optim import optimizers as optim

    if "mcfg" in case:
        return dist_run_hetero(torch, case, view, device)
    arch, pcfg = case.get("arch_cfg") or configs.get_arch(case["arch"]), \
        case["pcfg"]
    dev = torch.device(device) if view is None else view.device
    model = LMModel(arch, pcfg, dtype=torch.bfloat16, device=dev, mesh=view)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    data = DataConfig(seed=0, vocab=arch.vocab, seq_len=case["seq"],
                      global_batch=case["batch"])
    batch = model_batch(to_device(SyntheticLM(data, arch).batch_at(0), dev),
                        torch.bfloat16)
    grad_fn = steps.build_grad_fn(model, pcfg, model.stage_devices)
    fns = train_counters()
    _dist_sync(torch, dev)
    t0 = time.perf_counter()
    loss, grads = grad_fn(params, batch)
    _dist_sync(torch, dev)
    out = {"loss": float(loss).hex(),
           "grad_ms": (time.perf_counter() - t0) * 1e3,
           "launches": {k: fn.launches for k, fn in fns.items()},
           "park": grad_fn.park_info,
           "peak_gib": _dist_peak_gib(torch, dev)}
    if view is None:
        out["digests"] = [digests(torch, model.rank_share(grads, r))
                          for r in range(pcfg.pipe)]
        return out
    out["digests"] = digests(torch, grads)
    del grads
    ocfg = optim.OptimizerConfig(lr=5e-4, warmup_steps=0, min_lr_ratio=1.0,
                                 dynamic_loss_scale=True)
    opt = optim.init(ocfg, params)
    step = steps.build_train_step(
        model, pcfg, model.stage_devices,
        ShapeConfig("train", case["seq"], case["batch"], "train"), ocfg)
    out.update(losses=[], step_ms=[], step_launches=[])
    for _ in range(case["steps"]):
        fns = train_counters()
        _dist_sync(torch, dev)
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        out["losses"].append(float(metrics["loss"]))        # waits
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["step_launches"].append({k: fn.launches for k, fn in fns.items()})
    if "embed" in params:
        out["embed_digests"] = digests(torch, params["embed"])
    out["peak_gib"] = _dist_peak_gib(torch, dev)
    return out


def dist_run_hetero(torch, case, view, device: str = "cuda"):
    """The U-Net case, as a pipe rank of ``view`` or (``view`` None) in
    one process, through ``launch.train_hetero``: a grad call
    (``hetero_grad_call``) on ``build_problem``'s weights from seed 0 and
    its fixed batch (the loss on the last rank,
    the SHA-256 of every gradient leaf, per rank of the whole model's when
    in one process, the buffer high-water and hops, the launches, the
    peak), then ``train_hetero(..., mesh_view=)`` for ``steps`` SGD steps
    from the same weights (losses, step ms)."""
    from repro_torch.launch import train_hetero as TH
    from repro_torch.models import pipeline_hetero as PH

    pcfg = case["pcfg"]
    dev = torch.device(device) if view is None else view.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _, prog, stages, x, y = TH.build_problem(
        case["mcfg"], pcfg, batch=case["batch"], device=dev, mesh_view=view)
    park = {}
    call = PH.hetero_grad_call(prog, pcfg, park, mesh_view=view)
    fns = train_counters()
    _dist_sync(torch, dev)
    t0 = time.perf_counter()
    loss, grads = call(stages, x, y)
    _dist_sync(torch, dev)
    out = {"loss": None if loss is None else float(loss).hex(),
           "grad_ms": (time.perf_counter() - t0) * 1e3,
           "launches": {k: fn.launches for k, fn in fns.items()},
           "park": park, "peak_gib": _dist_peak_gib(torch, dev)}
    if view is None:
        out["digests"] = [digests(torch, dict(enumerate(
            grads[r::pcfg.pipe]))) for r in range(pcfg.pipe)]
    else:
        out["digests"] = digests(torch, dict(enumerate(grads)))
    del grads, prog, stages, call
    res = TH.train_hetero(case["mcfg"], pcfg, batch=case["batch"],
                          steps=case["steps"], device=dev,
                          ocfg=TH.sgd(HETERO_LR), mesh_view=view)
    out.update(losses=[r["loss"] for r in res["history"]],
               step_ms=[r["step_s"] * 1e3 for r in res["history"]],
               peak_gib=_dist_peak_gib(torch, dev))
    return out


def dist_rank(rank: int, nproc: int, init_method: str, out_dir: str,
              cases, device: str) -> None:
    """A rank of ``dist_train``, ``dist_serve`` and ``dist_mesh`` (a
    spawned process): every ``(phase, case)`` of ``cases``, in the pipe
    group of four or (``dist_mesh``) on the case's mesh of the four, the
    records to ``out_dir/rank<r>.json`` by case name."""
    import torch
    from repro_torch.launch import mesh

    run = {"dist_train": dist_run, "dist_serve": serve_run,
           "dist_mesh": mesh_run}
    view = mesh.init_pipe_group(rank, nproc, init_method, device=device,
                                timeout_s=DIST_HOP_TIMEOUT_S)
    out = {}
    try:
        with deterministic(torch):
            for phase, case in cases:
                if phase == "dist_mesh":
                    case = dict(case, out_dir=out_dir)
                out[case["name"]] = run[phase](torch, case, view, device)
                if view.device.type == "cuda":
                    torch.cuda.empty_cache()
    finally:
        mesh.destroy_pipe_group(view)
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))


def dist_gates(torch, case, ranks, one):
    """Why the four ranks' run of ``case`` disagrees with the
    single-process run ``one`` or with its plan, as a list."""
    from repro_torch import configs
    from repro_torch.core.plan import plan_for, specialize
    from repro_torch.core.wire import plan_wire_report
    from repro_torch.launch.train import expected_train_launches
    from repro_torch.models.lm import LMModel

    pcfg = case["pcfg"]
    gpipe = pcfg.schedule == "gpipe"
    bad = []
    last = len(ranks) - 1
    for r, got in enumerate(ranks):
        if got["loss"] != one["loss"] and (r == last or "mcfg" not in case):
            bad.append(f"rank {r} loss {got['loss']} != {one['loss']}")
        diff = sorted(k for k in one["digests"][r]
                      if got["digests"].get(k) != one["digests"][r][k])
        if diff or got["digests"].keys() != one["digests"][r].keys():
            bad.append(f"rank {r} grads differ: {diff}")
    if "mcfg" in case:
        from repro_torch.models.unet import UNetModel
        skips = UNetModel(case["mcfg"], pcfg.pipe).skip_edges()
    else:
        arch = case.get("arch_cfg") or configs.get_arch(case["arch"])
        skips = LMModel(arch, pcfg, device="meta").skips()
    # gpipe runs the forward plan; autograd's backward crosses its hops
    tplan = plan_for("gpipe_fwd" if gpipe else pcfg.schedule, pcfg.n_micro,
                     pcfg.pipe, skips=skips, portals=pcfg.portals,
                     residuals=pcfg.residuals, wire=pcfg.wire)
    for r, got in enumerate(ranks):
        want = specialize(tplan, r).buffer_slots()
        if gpipe:
            want = {"park": want["park"]}
        elif not pcfg.stream_inputs:
            want.pop("fs")
        if got["park"]["buffer_slots"] != want:
            bad.append(f"rank {r} high-water {got['park']['buffer_slots']} "
                       f"!= specialize's {want}")
    for rt in tplan.routes:
        highs = [got["park"]["per_route"][rt.key] for got in ranks]
        if max(h["depth"] for h in highs) != rt.depth or (
                not gpipe and max(h["g_depth"] for h in highs) != rt.g_depth):
            bad.append(f"route {rt.key} high-water {highs}")
    got = {c: {k: sum(g["park"]["hops"][c][k] for g in ranks)
               for k in ("hops", "bytes")}
           for c in ("chain", "cotangent", "portal")}
    # the carry and every skip are [mb, S, d]; the fp32 codec ships the
    # bf16 model's bytes, a lossy one is priced per fp32-equivalent byte
    # (the U-Net's carries change shape from stage to stage: hops only)
    numel = (0 if "mcfg" in case else
             case["batch"] // pcfg.n_micro * case["seq"] * arch.d_model)
    rep = plan_wire_report(tplan, numel * (2 if pcfg.wire == "fp32" else 4))
    h = rep["hops"]
    want = {"chain": h["chain"], "portal": h["route_value"],
            "cotangent": (h["chain"] + h["route_value"] if gpipe else
                          h["cotangent_chain"] + h["route_cotangent"])}
    per_class = dict(rep["per_class"])
    if gpipe:          # a cotangent in the wire's dtype for every payload
        per_class["cotangent"] = per_class["chain"] + per_class["portal"]
    if {c: v["hops"] for c, v in got.items()} != want or (
            "mcfg" not in case
            and any(got[c]["bytes"] != per_class[c] for c in got)):
        bad.append(f"hops {got} != the plan's {want}, {per_class}")
    if "mcfg" in case:
        losses = ranks[0]["losses"]
        if any(g["losses"] != losses for g in ranks):
            bad.append("ranks report different losses")
        if losses[0] != one["losses"][0]:
            bad.append(f"step 1 loss {losses[0]} != one process's "
                       f"{one['losses'][0]}")
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            bad.append(f"losses {losses} not finite and falling")
        if any(any(g["launches"].values()) for g in ranks):
            bad.append("the U-Net launched kernels of the port")
        return bad
    expected = expected_train_launches(pcfg, arch, case["seq"])
    calls = [[g["launches"]] + g.get("step_launches", []) for g in ranks]
    summed = [{k: sum(c[i][k] for c in calls) for k in expected}
              for i in range(len(calls[0]))]
    if any(s != expected for s in summed) or one["launches"] != expected:
        bad.append(f"launches over the ranks {summed}, one process "
                   f"{one['launches']}, the path's {expected}")
    if case["steps"]:
        losses = ranks[0]["losses"]
        if any(g["losses"] != losses for g in ranks):
            bad.append("ranks report different losses")
        if float.fromhex(one["loss"]) != losses[0]:
            bad.append(f"step 1 loss {losses[0]} != the grad call's")
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            bad.append(f"losses {losses} not finite and falling")
        if arch.tie_embeddings and ranks[0]["embed_digests"] \
                != ranks[-1]["embed_digests"]:
            bad.append("the embedding copies of rank 0 and the last rank "
                       f"differ after {case['steps']} steps")
    return bad


def dist_train_one(torch, cases, device: str):
    """Each ``dist_train`` case's single-process run on ``device`` (one per
    config: spmd and mpmd share theirs)."""
    one = {}
    for case in cases:
        key = (case["arch"], case["pcfg"].with_(executor="spmd"))
        if key not in one:
            one[key] = dist_run(torch, case, None, device)
            if device == "cuda":
                torch.cuda.empty_cache()
    return one


def dist_train_report(torch, cases, saved, one, t_one, t_group):
    """``dist_train``'s gates and records: four pipe ranks in four
    processes on the one card (gloo, hops through pinned host memory),
    every case against the single-process run of the same config, seed
    and batch on the card (deterministic algorithms in both).  Returns
    the launch totals and the failures by case."""
    totals = {k: 0 for k in KERNELS}
    bad = {}
    for case in cases:
        ranks = [s[case["name"]] for s in saved]
        ref = one[case["arch"], case["pcfg"].with_(executor="spmd")]
        bad[case["name"]] = dist_gates(torch, case, ranks, ref)
        for g in ranks:
            for rec in [g["launches"]] + g.get("step_launches", []):
                for k, n in rec.items():
                    totals[k] += n
        emit({"phase": "dist_train", "case": case["name"],
              "arch": case["arch"], "pipe": DIST_RANKS,
              "schedule": case["pcfg"].schedule,
              "executor": case["pcfg"].executor,
              "stream_inputs": case["pcfg"].stream_inputs,
              "wire": case["pcfg"].wire, "seq": case.get("seq"),
              "config": (dataclasses.asdict(case["mcfg"]) if "mcfg" in case
                         else None),
              "batch": case["batch"], "n_micro": case["pcfg"].n_micro,
              "remat": case["pcfg"].remat,
              "dtype": "float32" if "mcfg" in case else "bfloat16",
              "where": f"{DIST_RANKS} processes time-slicing one card",
              "losses": ranks[0].get("losses"),
              "one_process_losses": ref.get("losses"),
              "step_ms_per_rank": [g.get("step_ms") for g in ranks],
              "one_process_step_ms": ref.get("step_ms"),
              "grad_call_ms_per_rank": [g["grad_ms"] for g in ranks],
              "one_process_grad_call_ms": ref["grad_ms"],
              "peak_gib_per_rank": [g["peak_gib"] for g in ranks],
              "one_process_peak_gib": ref["peak_gib"],
              "buffer_slots_per_rank": [g["park"]["buffer_slots"]
                                        for g in ranks],
              "hops_per_rank": [g["park"]["hops"] for g in ranks],
              "hop_wait_ms_per_class": {
                  c: max(g["park"]["hops"][c]["wait_s"] for g in ranks) * 1e3
                  for c in ranks[0]["park"]["hops"]},
              "unequal": bad[case["name"]]})
    pair = [[s[name]["digests"] for s in saved] for name in
            ("smollm-1f1b-spmd", "smollm-1f1b-mpmd") if name in saved[0]]
    if len(pair) == 2 and pair[0] != pair[1]:
        bad["spmd_vs_mpmd"] = ["1f1b grads under mpmd differ from spmd's"]
    emit({"phase": "dist_train", "one_process_s": t_one,
          "group_s": t_group, "launches": totals,
          "spmd_vs_mpmd": "bitwise" if len(pair) == 2
          and pair[0] == pair[1] else "not compared or differ"})
    return totals, bad


# ---------------------------------------------------------------------------
# dist_serve: serving with one process per pipe rank
# ---------------------------------------------------------------------------

DIST_SERVE = ("smollm-360m", "rwkv6-1.6b", "whisper-tiny")
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 2048, 32


def dist_serve_cases():
    """One case per model of ``DIST_SERVE`` at full width, pipe 4
    (smollm-360m's 16 and rwkv6-1.6b's 8 cut to 4, tp and data 1), bf16,
    batch 8, a 2048-token prompt (and whisper-tiny's 2048 frames), 32
    tokens; the two LMs at ``DIST_LAYERS`` layers, whisper-tiny at its
    full 8 blocks."""
    from repro_torch import configs

    def arch(a):
        full = configs.get_arch(a)
        return (full if full.is_encdec
                else dataclasses.replace(full, n_layers=DIST_LAYERS))
    return [dict(name=f"{a}-serve", arch=a, arch_cfg=arch(a),
                 batch=SERVE_BATCH, prompt=SERVE_PROMPT, gen=SERVE_GEN,
                 pcfg=configs.get_parallel(a).with_(
                     data=1, tp=1, dp2=1, pipe=DIST_RANKS))
            for a in DIST_SERVE]


def serve_run(torch, case, view, device: str = "cuda"):
    """One serving case through ``launch.serve.serve``, as a pipe rank of
    ``view`` or (``view`` None) in one process: weights from seed 0 (the
    rank's share), prompts from seed 1.  Where the logits land
    (the last rank): the tokens, the logits' SHA-256, whether they are
    finite; everywhere: the launches, cache bytes, prefill ms, decode
    tok/s, the peak, and in a group the hops and high-water."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    from repro_torch.kernels.wkv6 import wkv6_bwd
    from repro_torch.launch.serve import serve

    arch = case.get("arch_cfg") or configs.get_arch(case["arch"])
    train_counters()
    res = serve(arch, case["pcfg"], prompt_len=case["prompt"],
                gen=case["gen"], batch=case["batch"], device=device,
                dtype=torch.bfloat16, seed=0, mesh_view=view)
    out = {"launches": res["launches"], "n_micro": res["n_micro"],
           "cache_bytes": res["cache_bytes"],
           "prefill_ms": res["prefill_s"] * 1e3,
           "decode_tok_per_s": res["decode_tok_per_s"],
           "peak_gib": res.get("peak_mem_bytes", 0) / 2 ** 30,
           "backward_launches": flash_attention_bwd.launches
           + rmsnorm_bwd.launches + wkv6_bwd.launches}
    if res["logits"] is not None:
        lg = res["logits"]
        out.update(tokens=res["tokens"].tolist(),
                   logits=digests(torch, {"logits": lg})["logits"],
                   logits_shape=list(lg.shape),
                   finite=bool(torch.isfinite(lg).all()))
    if view is not None:
        out.update(hops=res["hops"], park=res["park"])
    return out


def serve_gates(torch, case, ranks, one):
    """Why the four ranks' serving of ``case`` disagrees with one
    process's or with the path's counts, as a list."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.serve import expected_serve_launches
    from repro_torch.models.lm import LMModel
    from repro_torch.tree import tree_leaves

    arch = case.get("arch_cfg") or configs.get_arch(case["arch"])
    bad, last = [], ranks[-1]
    if last.get("tokens") != one["tokens"]:
        bad.append("tokens differ from one process's")
    if last.get("logits") != one["logits"]:
        bad.append("last logits differ from one process's")
    if not (last.get("finite") and last.get("logits_shape")
            == [case["batch"], 1, arch.vocab]):
        bad.append(f"logits not finite [B, 1, V]: {last.get('logits_shape')}")
    m = one["n_micro"]
    want = expected_serve_launches(arch, case["pcfg"], m, case["gen"])
    summed = {ph: {k: sum(g["launches"][ph][k] for g in ranks)
                   for k in want[ph]} for ph in want}
    if summed != want or one["launches"] != want:
        bad.append(f"launches over the ranks {summed}, one process "
                   f"{one['launches']}, the path's {want}")
    if any(g["backward_launches"] for g in ranks + [one]):
        bad.append("serving launched a backward kernel")
    model = LMModel(arch, case["pcfg"].with_(n_micro=m), dtype=torch.bfloat16,
                    device="meta")
    dshape = ShapeConfig("d", case["prompt"] + case["gen"], case["batch"],
                         "decode")
    for r, g in enumerate(ranks):
        share = model.init_cache(dshape, m, filled=False, rank=r)
        nbytes = sum(a.numel() * a.element_size() for a in tree_leaves(share))
        if g["cache_bytes"] != nbytes:
            bad.append(f"rank {r} cache {g['cache_bytes']} bytes, its share "
                       f"of cache_protos {nbytes}")
        tok = g["hops"]["token"]["hops"]
        if tok != (case["gen"] - 1 if r == len(ranks) - 1 else 0):
            bad.append(f"rank {r} sent {tok} token hops")
    if sum(g["cache_bytes"] for g in ranks) != one["cache_bytes"]:
        bad.append("the ranks' caches do not add up to one process's")
    return bad


def dist_serve_report(torch, cases, saved, one, t_one, t_group):
    """``dist_serve``'s gates and records: four pipe ranks in four
    processes on the one card (gloo, hops through pinned host memory),
    each holding its own stages' weights and caches, serving every case
    against one process at the same pipe (deterministic algorithms in
    both).  Returns the launch totals and the failures by case."""
    totals = {k: 0 for k in KERNELS}
    bad = {}
    for case in cases:
        ranks = [s[case["name"]] for s in saved]
        ref = one[case["name"]]
        bad[case["name"]] = serve_gates(torch, case, ranks, ref)
        for g in ranks:
            for rec in g["launches"].values():
                for k, n in rec.items():
                    totals[k] += n
        emit({"phase": "dist_serve", "case": case["name"],
              "arch": case["arch"], "pipe": DIST_RANKS,
              "n_micro": ref["n_micro"], "batch": case["batch"],
              "prompt": case["prompt"], "gen": case["gen"],
              "dtype": "bfloat16",
              "where": f"{DIST_RANKS} processes time-slicing one card",
              "prefill_ms_per_rank": [g["prefill_ms"] for g in ranks],
              "one_process_prefill_ms": ref["prefill_ms"],
              "decode_tok_per_s": ranks[-1]["decode_tok_per_s"],
              "one_process_decode_tok_per_s": ref["decode_tok_per_s"],
              "peak_gib_per_rank": [g["peak_gib"] for g in ranks],
              "one_process_peak_gib": ref["peak_gib"],
              "cache_gib_per_rank": [g["cache_bytes"] / 2 ** 30
                                     for g in ranks],
              "one_process_cache_gib": ref["cache_bytes"] / 2 ** 30,
              "hops_per_rank": [{c: v["hops"] for c, v in g["hops"].items()
                                 if v["hops"]} for g in ranks],
              "hop_wait_ms_per_class": {
                  c: max(g["hops"][c]["wait_s"] for g in ranks) * 1e3
                  for c in ranks[0]["hops"]},
              "launches_per_rank": [g["launches"] for g in ranks],
              "sample_tokens": ranks[-1].get("tokens", [[]])[0][:8],
              "unequal": bad[case["name"]]})
    emit({"phase": "dist_serve", "one_process_s": t_one,
          "group_s": t_group, "launches": totals})
    return totals, bad


def phase_dist(torch, device: str = "cuda", train_cases=None,
               serve_cases=None, mesh_case_list=None):
    """``dist_train``, ``dist_serve`` and ``dist_mesh`` in one spawn of
    four ranks (they reach the card and meet once; the mesh cases lay the
    four out again, case by case), after the single-process runs they are
    held to (mixtral-8x7b's, ~27 GB of weights and state, freed before the
    spawn).  ``device`` and the cases are for a rehearsal on the CPU at a
    small size.  Returns the launch totals of all three."""
    import tempfile
    from repro_torch.launch import mesh

    train_cases = dist_cases() if train_cases is None else train_cases
    serve_cases = dist_serve_cases() if serve_cases is None else serve_cases
    mesh_case_list = mesh_cases() if mesh_case_list is None \
        else mesh_case_list
    t_one = {}
    one_mesh = {}
    with deterministic(torch):
        t0 = time.perf_counter()
        for case in mesh_case_list:
            if case["kind"] != "serve" and case["name"] not in (
                    "smollm-pd2-1f1b", "smollm-pd2-1f1b-replicated"):
                one_mesh[case["name"]] = mesh_one(torch, case, device)
                if device == "cuda":
                    torch.cuda.empty_cache()
        t_one["dist_mesh"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        one_train = dist_train_one(torch, train_cases, device)
        t_one["dist_train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        one_serve = {}
        for case in serve_cases:
            one_serve[case["name"]] = serve_run(torch, case, None, device)
            if device == "cuda":
                torch.cuda.empty_cache()
        t_one["dist_serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        mesh.spawn(dist_rank, DIST_RANKS,
                   (out_dir, [("dist_train", c) for c in train_cases]
                    + [("dist_serve", c) for c in serve_cases]
                    + [("dist_mesh", c) for c in mesh_case_list], device),
                   timeout_s=DIST_TIMEOUT_S)
        saved = [json.loads((Path(out_dir) / f"rank{r}.json").read_text())
                 for r in range(DIST_RANKS)]
        t_group = time.perf_counter() - t0
        mesh_totals, mesh_bad = mesh_report(torch, mesh_case_list, saved,
                                            one_mesh, out_dir)
    totals, bad = dist_train_report(torch, train_cases, saved, one_train,
                                    t_one["dist_train"], t_group)
    serve_totals, serve_bad = dist_serve_report(
        torch, serve_cases, saved, one_serve, t_one["dist_serve"], t_group)
    add(totals, serve_totals)
    add(totals, mesh_totals)
    emit({"phase": "dist_mesh", "one_process_s": t_one["dist_mesh"],
          "group_s": t_group})
    failed = {k: v for k, v in (bad | serve_bad | mesh_bad).items() if v}
    if failed:
        raise AssertionError(f"dist: {failed}")
    return totals


# ---------------------------------------------------------------------------
# dist_mesh: data, FSDP and tensor parallelism over the four ranks
# ---------------------------------------------------------------------------

# tests/test_oracle.py's bf16 TOL: one replica's math against a mesh's
MESH_TOL = dict(rtol=2e-2, atol=2e-2)
MESH_FP32_REL = 1e-3      # fp32: each grad leaf's gap over its largest entry
MESH_SEQ, MESH_BATCH, MESH_M = 4096, 16, 8
MESH_FP32_SEQ, MESH_FP32_BATCH = 256, 8
MESH_LR = {"mixtral-8x7b": 5e-5}
# a train case against one process past its first loss: the step-1 grad
# norm and the step-2 loss (after one AdamW step), each relative to one
# process's, about 2-3x the largest gaps measured on an H100 (mixtral's
# 4.8e-3 and 2.9e-4; smollm's 2.4e-4 and 1.3e-4, whisper's 4e-6)
MESH_NORM_RTOL, MESH_LOSS2_RTOL = 1e-2, 1e-3


def _mesh_ocfg(case):
    from repro_torch.optim import optimizers as optim
    return optim.OptimizerConfig(lr=MESH_LR.get(case["arch"], 5e-4),
                                 warmup_steps=0, min_lr_ratio=1.0,
                                 dynamic_loss_scale=True)


def mesh_cases(archs=None, seq: int = MESH_SEQ, batch: int = MESH_BATCH,
               fp32_seq: int = MESH_FP32_SEQ,
               fp32_batch: int = MESH_FP32_BATCH,
               serve=(SERVE_BATCH, SERVE_PROMPT, SERVE_GEN)):
    """The cases the four ranks run, each on its own mesh of them
    (``archs`` replaces a full arch by name, for a rehearsal at a small
    size): (a) smollm-360m whole (32 layers, seq 4096, batch 16, m 8,
    bf16) at data 2 x pipe 2 with FSDP, 2 AdamW steps through gpipe with
    the stage weights joined once a step, 2 through 1f1b joined at each
    application, 1 through 1f1b with FSDP off; (b) whisper-tiny whole at tp
    2 x pipe 2, streamed, 1f1b, 2 steps, served (batch 8, 2048 frames, 32
    tokens), and cut to 2 blocks of full width in fp32 at seq 256 for a
    grad call; (c) mixtral-8x7b at full width cut to 1 layer, tp 2 (4
    experts, 16 of 32 query and 4 of 8 kv heads, 16,000 of the vocab a
    rank) x data 2, pipe 1, batch 8 (m 4), gpipe with the weights joined
    once a step, lr 5e-5, 2 steps (its weights hashed after the last)."""
    from repro_torch import configs
    archs = archs or {}

    def arch(name, **cut):
        a = archs.get(name) or configs.get_arch(name)
        return dataclasses.replace(a, **cut) if cut else a

    def pcfg(name, **kw):
        return configs.get_parallel(name).with_(
            dp2=1, pod=1, n_micro=MESH_M, remat="full", **kw)

    smollm = pcfg("smollm-360m", pipe=2, data=2, tp=1)
    whisper = pcfg("whisper-tiny", pipe=2, data=1, tp=2, schedule="1f1b",
                   stream_inputs=True)
    # the experts joined once a step: at each application (16 a step:
    # m 8, each recomputed) they cross the host 11.7 GB a rank, 49-52 s
    mixtral = pcfg("mixtral-8x7b", pipe=1, data=2, tp=2, schedule="gpipe",
                   gather_weights_once=True)
    common = dict(seq=seq, batch=batch)
    b, prompt, gen = serve
    return [
        dict(name="smollm-pd2-gpipe-once", kind="train", arch="smollm-360m",
             arch_cfg=arch("smollm-360m"), steps=2, **common,
             pcfg=smollm.with_(schedule="gpipe", gather_weights_once=True)),
        dict(name="smollm-pd2-1f1b", kind="train", arch="smollm-360m",
             arch_cfg=arch("smollm-360m"), steps=2, **common,
             pcfg=smollm.with_(schedule="1f1b")),
        dict(name="smollm-pd2-1f1b-replicated", kind="train",
             arch="smollm-360m", arch_cfg=arch("smollm-360m"), steps=1,
             **common, pcfg=smollm.with_(schedule="1f1b", fsdp=False)),
        dict(name="whisper-pt2-1f1b-stream", kind="train",
             arch="whisper-tiny", arch_cfg=arch("whisper-tiny"), steps=2,
             pcfg=whisper, **common),
        dict(name="whisper-pt2-fp32", kind="grads", arch="whisper-tiny",
             arch_cfg=arch("whisper-tiny", n_layers=1, enc_layers=1),
             pcfg=whisper, seq=fp32_seq, batch=fp32_batch, fp32=True),
        dict(name="whisper-pt2-serve", kind="serve", arch="whisper-tiny",
             arch_cfg=arch("whisper-tiny"), pcfg=whisper.with_(
                 stream_inputs=False), batch=b, prompt=prompt, gen=gen),
        dict(name="mixtral-td2", kind="train", arch="mixtral-8x7b",
             arch_cfg=arch("mixtral-8x7b", n_layers=1), steps=2,
             pcfg=mixtral.with_(n_micro=MESH_M // 2), digest_last=True,
             seq=seq, batch=batch // 2),
    ]


def _one_replica(pcfg):
    """A mesh case's config in one process: data and tp 1."""
    return pcfg.with_(data=1, tp=1, pod=1, dp2=1)


def _mesh_batch(torch, case, arch, dev, dtype, replica=0, replicas=1):
    from repro_torch.data.pipeline import (DataConfig, SyntheticLM,
                                           replica_slice, to_device)
    from repro_torch.launch.train import model_batch
    data = DataConfig(seed=0, vocab=arch.vocab, seq_len=case["seq"],
                      global_batch=case["batch"])
    return model_batch(to_device(replica_slice(
        SyntheticLM(data, arch).batch_at(0), replica, replicas), dev), dtype)


def mesh_one(torch, case, device: str = "cuda"):
    """A mesh case's reference in one process: the same weights (seed 0)
    and whole batch at the case's pipe, data and tp 1.  A ``grads`` case:
    the grad call's loss and every gradient leaf (on the host); a
    ``train`` case: its first two AdamW steps (``_mesh_ocfg``), each
    step's loss and grad norm."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models.lm import LMModel
    from repro_torch.optim import optimizers as optim
    from repro_torch.tree import tree_items
    arch, pcfg = case["arch_cfg"], _one_replica(case["pcfg"])
    dtype = torch.float32 if case.get("fp32") else torch.bfloat16
    dev = torch.device(device)
    model = LMModel(arch, pcfg, dtype=dtype, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    batch = _mesh_batch(torch, case, arch, dev, dtype)
    if case["kind"] == "grads":
        loss, grads = steps.build_grad_fn(model, pcfg, model.stage_devices)(
            params, batch)
        return {"loss": float(loss),
                "grads": {k: v.detach().cpu()
                          for k, v in tree_items(grads)}}
    ocfg = _mesh_ocfg(case)
    opt = optim.init(ocfg, params)
    step = steps.build_train_step(
        model, pcfg, model.stage_devices,
        ShapeConfig("train", case["seq"], case["batch"], "train"), ocfg)
    out = {"losses": [], "grad_norms": []}
    for _ in range(min(case["steps"], 2)):
        params, opt, metrics = step(params, opt, batch)
        out["losses"].append(float(metrics["loss"]))
        out["grad_norms"].append(float(metrics["grad_norm"]))
    out["loss"] = out["losses"][0]
    return out


def mesh_run(torch, case, view, device: str = "cuda"):
    """One mesh case as one of the four ranks, laid out as the case's mesh
    (``launch.mesh.mesh_groups``): the rank's blocks of the seed-0 weights
    and its replica's rows of the fixed batch (``view``, the four ranks'
    pipe group, is not used).  A ``train`` case takes its
    AdamW steps (each step's loss, grad norm, ms, launches and the SHA-256
    of every weight leaf joined over FSDP); a ``grads`` case one grad call
    (its gradients saved under ``case["out_dir"]``); a ``serve`` case
    serves through ``launch.serve.serve(mesh_view=)``.  Each reports the
    rank's coordinates, resident bytes against the placement's count,
    collectives per class and peak memory."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import mesh, steps
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import placement_bytes
    from repro_torch.models.lm import LMModel
    from repro_torch.optim import optimizers as optim
    from repro_torch.tree import tree_items, tree_leaves

    view = mesh.mesh_groups(case["pcfg"], device=device,
                            timeout_s=DIST_HOP_TIMEOUT_S)
    dev, arch, pcfg = view.device, case["arch_cfg"], case["pcfg"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = {"coords": view.coords}
    if case["kind"] == "serve":
        train_counters()
        res = serve(arch, pcfg, prompt_len=case["prompt"], gen=case["gen"],
                    batch=case["batch"], device=device, dtype=torch.bfloat16,
                    seed=0, mesh_view=view)
        out.update(launches=res["launches"], n_micro=res["n_micro"],
                   cache_bytes=res["cache_bytes"],
                   prefill_ms=res["prefill_s"] * 1e3,
                   decode_tok_per_s=res["decode_tok_per_s"],
                   collectives=res["collectives"],
                   peak_gib=_dist_peak_gib(torch, dev))
        if res["logits"] is not None:
            lg = res["logits"]
            out.update(logits_shape=list(lg.shape),
                       finite=bool(torch.isfinite(lg).all()),
                       tokens=res["tokens"].tolist())
        return out
    dtype = torch.float32 if case.get("fp32") else torch.bfloat16
    model = LMModel(arch, pcfg, dtype=dtype, device=dev, mesh=view)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    batch = _mesh_batch(torch, case, arch, dev, dtype, view.replica,
                        view.replicas)
    if case["kind"] == "grads":         # the weights alone
        out["resident_bytes"] = sum(a.nbytes for a in tree_leaves(params))
        out["placement_bytes"] = placement_bytes(model, state_bytes=0)
        fns = train_counters()
        view.reset_stats()
        loss, grads = steps.build_grad_fn(model, pcfg, model.stage_devices)(
            params, batch)
        out.update(loss=float(loss),
                   launches={k: fn.launches for k, fn in fns.items()},
                   collectives=view.stats(), specs=model.specs,
                   peak_gib=_dist_peak_gib(torch, dev))
        torch.save({k: v.detach().cpu() for k, v in tree_items(grads)},
                   Path(case["out_dir"]) / f"{case['name']}-{view.rank}.pt")
        return out
    ocfg = _mesh_ocfg(case)
    opt = optim.init(ocfg, params)
    out["resident_bytes"] = sum(a.nbytes for t in (params, opt.mu, opt.nu,
                                                   opt.master)
                                for a in tree_leaves(t))
    out["placement_bytes"] = placement_bytes(model)
    step = steps.build_train_step(
        model, pcfg, model.stage_devices,
        ShapeConfig("train", case["seq"], case["batch"], "train"), ocfg)
    out.update(losses=[], grad_norms=[], step_ms=[], step_launches=[],
               weights=[], collectives=[])
    for _ in range(case["steps"]):
        fns = train_counters()
        view.reset_stats()
        _dist_sync(torch, dev)
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        out["losses"].append(float(metrics["loss"]))           # waits
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["grad_norms"].append(float(metrics["grad_norm"]))
        out["step_launches"].append({k: fn.launches
                                     for k, fn in fns.items()})
        out["collectives"].append(view.stats())
        last = len(out["losses"]) == case["steps"]
        if last or not case.get("digest_last"):
            out["weights"].append(digests(torch, model.gather_fsdp(params)))
    out["peak_gib"] = _dist_peak_gib(torch, dev)
    return out


def mesh_gates(torch, case, ranks, one, out_dir):
    """Why the four ranks' run of a mesh case disagrees with one replica
    in one process, with itself or with the path's counts, as a list."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.launch.serve import expected_serve_launches
    from repro_torch.launch.train import expected_train_launches
    from repro_torch.models.lm import LMModel
    from repro_torch.tree import tree_items

    arch, pcfg = case["arch_cfg"], case["pcfg"]
    D, T = pcfg.data * pcfg.pod * pcfg.dp2, pcfg.tp
    bad = []
    if case["kind"] == "serve":
        one_cfg = _one_replica(pcfg)
        m = ranks[0]["n_micro"]
        want = expected_serve_launches(arch, one_cfg, m, case["gen"])
        summed = {ph: {k: sum(g["launches"][ph][k] for g in ranks)
                       for k in want[ph]} for ph in want}
        if summed != {ph: {k: D * T * n for k, n in w.items()}
                      for ph, w in want.items()}:
            bad.append(f"launches {summed} != {D * T} x the path's {want}")
        meta = LMModel(arch, one_cfg.with_(n_micro=m), dtype=torch.bfloat16,
                       device="meta")
        dshape = ShapeConfig("d", case["prompt"] + case["gen"],
                             case["batch"], "decode")
        for g in ranks:
            share = meta.init_cache(dshape, m, filled=False,
                                    rank=g["coords"]["pipe"])
            nbytes = sum(a.numel() * a.element_size() // (
                T if p.endswith(("/k", "/v")) else 1)
                for p, a in tree_items(share))
            if g["cache_bytes"] != nbytes:
                bad.append(f"rank {g['coords']} cache {g['cache_bytes']} B, "
                           f"its kv heads' share {nbytes} B")
            if g["coords"]["pipe"] == pcfg.pipe - 1 and not (
                    g.get("finite") and g.get("logits_shape")
                    == [case["batch"] // D, 1, arch.vocab]):
                bad.append(f"logits not finite [B, 1, V] on {g['coords']}")
        return bad
    for g in ranks:
        if g["resident_bytes"] != g["placement_bytes"]:
            bad.append(f"rank {g['coords']} holds {g['resident_bytes']} B, "
                       f"the placement {g['placement_bytes']} B")
    want = expected_train_launches(_one_replica(pcfg), arch, case["seq"])
    calls = ([g["launches"] for g in ranks] if case["kind"] == "grads"
             else None)
    per_call = ([calls] if calls else
                [[g["step_launches"][i] for g in ranks]
                 for i in range(case["steps"])])
    for recs in per_call:
        summed = {k: sum(r[k] for r in recs) for k in want}
        if summed != {k: D * T * n for k, n in want.items()}:
            bad.append(f"launches {summed} != {D * T} x the path's {want}")
    if case["kind"] == "grads":
        loss = ranks[0]["loss"]
        if abs(loss - one["loss"]) > MESH_FP32_REL * abs(one["loss"]):
            bad.append(f"loss {loss} vs one process {one['loss']}")
        model = LMModel(arch, _one_replica(pcfg), dtype=torch.float32,
                        device="meta")
        shape = mesh_shape(pcfg)
        for r, g in enumerate(ranks):
            got = torch.load(Path(out_dir) / f"{case['name']}-{r}.pt")
            c = g["coords"]
            share = model.rank_share(_nest(one["grads"]), c["pipe"])
            specs = dict(tree_items(g["specs"]))
            for p, w in tree_items(share):
                w = sharding.shard(w, specs[p], c, shape,
                                   skip=("pipe", "data", "pod"))
                gap = float((got[p].float() - w.float()).abs().max())
                scale = max(float(w.abs().max()), 1e-30)
                if gap > MESH_FP32_REL * scale:
                    bad.append(f"rank {r} {p}: gap {gap:.3g} over "
                               f"{scale:.3g}")
        return bad
    losses = ranks[0]["losses"]
    if any(g["losses"] != losses for g in ranks):
        bad.append("ranks report different losses")
    if not all(map(math.isfinite, losses)):
        bad.append(f"losses {losses} not finite")
    if one is not None:
        if abs(losses[0] - one["loss"]) > \
                MESH_TOL["atol"] + MESH_TOL["rtol"] * abs(one["loss"]):
            bad.append(f"step 1 loss {losses[0]} vs one process "
                       f"{one['loss']}")
        gap = _mesh_gaps(ranks[0], one)
        if gap["grad_norm_1"] > MESH_NORM_RTOL:
            bad.append(f"step 1 grad norm {ranks[0]['grad_norms'][0]} vs "
                       f"one process {one['grad_norms'][0]}")
        if gap.get("loss_2", 0.0) > MESH_LOSS2_RTOL:
            bad.append(f"step 2 loss {losses[1]} vs one process "
                       f"{one['losses'][1]}")
    by_coord = {}
    for g in ranks:
        c = g["coords"]
        by_coord.setdefault((c["pipe"], c["tp"]), []).append(g["weights"])
    for key, reps in by_coord.items():
        if any(w != reps[0] for w in reps):
            bad.append(f"the replicas of (pipe, tp) {key} hold different "
                       "weights after a step")
    return bad


def _mesh_gaps(got, one) -> dict:
    """A train case's relative gaps to one process: the step-1 grad norm
    and (where both took a second step) the step-2 loss."""
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)
    out = {"grad_norm_1": rel(got["grad_norms"][0], one["grad_norms"][0])}
    if len(got["losses"]) > 1 and len(one["losses"]) > 1:
        out["loss_2"] = rel(got["losses"][1], one["losses"][1])
    return out


def _nest(flat):
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    out = {}
    for p, v in flat.items():
        keys = p.split("/")
        d = out
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = v
    return out


def mesh_report(torch, cases, saved, one, out_dir):
    """``dist_mesh``'s gates and records, and the cross-case gates of (a):
    1f1b with FSDP on and off bitwise after its step, gpipe (weights
    joined once a step) and 1f1b within bf16 ``TOL`` of each other.
    Returns the launch totals and the failures by case."""
    totals = {k: 0 for k in KERNELS}
    bad = {}
    for case in cases:
        ranks = [s[case["name"]] for s in saved]
        bad[case["name"]] = mesh_gates(torch, case, ranks,
                                       one.get(case["name"]), out_dir)
        for g in ranks:
            recs = (list(g["launches"].values()) if case["kind"] == "serve"
                    else [g["launches"]] if case["kind"] == "grads"
                    else g["step_launches"])
            for rec in recs:
                for k, n in rec.items():
                    totals[k] += n
        pcfg = case["pcfg"]
        emit({"phase": "dist_mesh", "case": case["name"],
              "arch": case["arch"], "kind": case["kind"],
              "layers": case["arch_cfg"].n_layers
              + case["arch_cfg"].enc_layers,
              "mesh": {"data": pcfg.data, "pipe": pcfg.pipe, "tp": pcfg.tp},
              "schedule": pcfg.schedule, "fsdp": pcfg.fsdp,
              "gather_weights_once": pcfg.gather_weights_once,
              "stream_inputs": pcfg.stream_inputs,
              "seq": case.get("seq"), "batch": case["batch"],
              "n_micro": pcfg.n_micro,
              "dtype": "float32" if case.get("fp32") else "bfloat16",
              "where": f"{DIST_RANKS} processes time-slicing one card",
              "coords": [g["coords"] for g in ranks],
              "losses": ranks[0].get("losses") or ranks[0].get("loss"),
              "one_process_loss": (one.get(case["name"]) or {}).get("loss"),
              "grad_norms": ranks[0].get("grad_norms"),
              "one_process_losses": (one.get(case["name"]) or {}).get(
                  "losses"),
              "one_process_grad_norms": (one.get(case["name"]) or {}).get(
                  "grad_norms"),
              "rel_gaps_to_one_process": (
                  _mesh_gaps(ranks[0], one[case["name"]])
                  if case["kind"] == "train" and case["name"] in one
                  else None),
              "step_ms_per_rank": [g.get("step_ms") for g in ranks],
              "resident_bytes_per_rank": [g.get("resident_bytes")
                                          for g in ranks],
              "placement_bytes_per_rank": [g.get("placement_bytes")
                                           for g in ranks],
              "peak_gib_per_rank": [g["peak_gib"] for g in ranks],
              "collectives_per_rank": [g["collectives"] for g in ranks],
              "cache_bytes_per_rank": [g.get("cache_bytes") for g in ranks],
              "prefill_ms_per_rank": [g.get("prefill_ms") for g in ranks],
              "decode_tok_per_s": ranks[-1].get("decode_tok_per_s"),
              "unequal": bad[case["name"]]})
    names = {c["name"] for c in cases}
    if {"smollm-pd2-1f1b", "smollm-pd2-1f1b-replicated"} <= names:
        a = [s["smollm-pd2-1f1b"]["weights"][0] for s in saved]
        b = [s["smollm-pd2-1f1b-replicated"]["weights"][0] for s in saved]
        if a != b:
            bad["fsdp_vs_replicated"] = [
                "1f1b's weights after a step differ with FSDP on and off"]
    if {"smollm-pd2-1f1b", "smollm-pd2-gpipe-once"} <= names:
        x = saved[0]["smollm-pd2-1f1b"]["losses"]
        y = saved[0]["smollm-pd2-gpipe-once"]["losses"]
        if any(abs(p - q) > MESH_TOL["atol"] + MESH_TOL["rtol"] * abs(q)
               for p, q in zip(x, y)):
            bad["gpipe_vs_1f1b"] = [f"1f1b losses {x} vs gpipe {y}"]
    emit({"phase": "dist_mesh", "launches": totals,
          "fsdp_vs_replicated": "bitwise"
          if not bad.get("fsdp_vs_replicated") else "differ"})
    return totals, bad


PHASE_SECONDS = {}


def cut_config(arch_name: str, cuts: dict):
    """The arch at full width and its config (tp and data cut to 1), depth
    and pipe cut where ``cuts`` names the arch."""
    from repro_torch import configs
    cut = cuts.get(arch_name, {})
    arch = configs.get_arch(arch_name)
    if "n_layers" in cut:
        arch = dataclasses.replace(arch, n_layers=cut["n_layers"])
    pcfg = configs.get_parallel(arch_name).with_(data=1, tp=1)
    return arch, pcfg.with_(pipe=cut.get("pipe", pcfg.pipe))


def timed(name: str, fn, *args):
    """Run one phase; print and keep its seconds on the host clock."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    emit({"phase_done": name, "seconds": PHASE_SECONDS[name]})
    return out


def add(launches: dict, counts: dict) -> None:
    for k, n in counts.items():
        launches[k] += n


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch is missing beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    t0 = time.perf_counter()
    name, smi = timed("device", phase_device, torch)
    timed("build", phase_build)
    timing = timed("kernels", phase_kernels, torch)
    timing.update(timed("backward", phase_backward, torch))
    timed("port_gpu_vs_cpu smollm-360m", phase_port, torch, "smollm-360m",
          4, 256)
    timed("port_gpu_vs_cpu rwkv6-1.6b", phase_port, torch, "rwkv6-1.6b", 2,
          128)
    timed("train_gpu_vs_cpu smollm-360m", phase_train_port, torch)
    timed("train_gpu_vs_cpu rwkv6-1.6b", phase_train_port, torch,
          "rwkv6-1.6b", 2, 256)
    timed("train_fused_gpu_vs_cpu", phase_train_fused_port, torch)
    # gemma-2b at full width, 2 layers: the fp32 D-256 kernels on the card
    timed("port_gpu_vs_cpu gemma-2b", phase_port, torch, "gemma-2b", 2, 256)
    timed("train_gpu_vs_cpu gemma-2b", phase_train_port, torch, "gemma-2b",
          2, 256)
    # mixtral-8x7b and hymba-1.5b the same way: the MoE dispatch, the SSM
    # scan and the windowed D-128 / D-64 kernels in fp32 meet the CPU
    # (mixtral at seq 128: its CPU side is the longest of these phases)
    for arch_name, seq in (("mixtral-8x7b", 128), ("hymba-1.5b", 256)):
        timed(f"port_gpu_vs_cpu {arch_name}", phase_port, torch, arch_name,
              2, seq)
        timed(f"train_gpu_vs_cpu {arch_name}", phase_train_port, torch,
              arch_name, 2, seq)
        torch.cuda.empty_cache()
    launches = {k: 0 for k in KERNELS}
    for arch_name in ("smollm-360m", "rwkv6-1.6b"):
        add(launches, timed(f"serve {arch_name}", phase_serve, torch,
                            arch_name))
    # the dense-block, MoE and hybrid archs at full width (cut in depth
    # where SERVE_CUT says)
    for arch_name in DENSE_SERVE + MOE_HYBRID:
        add(launches, timed(f"serve {arch_name}", phase_serve, torch,
                            arch_name))
        torch.cuda.empty_cache()
    for arch_name in ("smollm-360m", "rwkv6-1.6b", "gemma-2b",
                      "mixtral-8x7b", "hymba-1.5b"):
        for schedule in ("gpipe", "1f1b"):
            add(launches, timed(f"train {arch_name} {schedule}", phase_train,
                                torch, schedule, arch_name))
            torch.cuda.empty_cache()
    timed("fused_bitwise gemma-2b", phase_fused_bitwise, torch)
    torch.cuda.empty_cache()
    timed("memory", phase_memory, torch)
    torch.cuda.empty_cache()
    timed("hetero_gpu_vs_cpu", phase_hetero_port, torch)
    for mname in ("unet", "amoebanet"):
        for schedule in ("gpipe", "1f1b"):
            timed(f"hetero_train {mname} {schedule}", phase_hetero_train,
                  torch, mname, schedule)
            torch.cuda.empty_cache()
    timed("hetero_memory", phase_hetero_memory, torch)
    torch.cuda.empty_cache()
    timed("whisper_gpu_vs_cpu", phase_whisper_port, torch)
    add(launches, timed("serve whisper-tiny", phase_serve, torch,
                        "whisper-tiny"))
    for schedule in ("gpipe", "1f1b"):
        add(launches, timed(f"whisper_train {schedule}", phase_train, torch,
                            schedule, "whisper-tiny"))
        torch.cuda.empty_cache()
    runs = {}          # whisper runs the stream and wire phases share
    add(launches, timed("stream", phase_stream, torch, runs))
    wire_totals, fp32 = timed("wire", phase_wire, torch, runs)
    add(launches, wire_totals)
    add(launches, timed("grad_compression", phase_grad_compression, torch,
                        runs, fp32))
    runs.clear()
    torch.cuda.empty_cache()
    add(launches, timed("dist", phase_dist, torch))
    kernels = []
    for kname in KERNELS:
        rec = timing[kname]
        kernels.append({k: rec[k] for k in (
            "name", "route", "source", "replaces")}
            | {"launches": launches[kname]}
            | {k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")})
        if launches[kname] == 0:
            raise AssertionError(f"{kname} never launched on the main path")
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "phase_seconds": PHASE_SECONDS})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
