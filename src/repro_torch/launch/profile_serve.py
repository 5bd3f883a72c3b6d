"""Where the serving time goes: warm timings and a device trace on one GPU.

Builds the serving path of :mod:`repro_torch.launch.serve` (same entry
points, same seeds), warms it up, then measures a warm prefill and warm
decode steps with the host clock and once more under ``torch.profiler``:
for each window it prints the wall time, the summed device time of the
kernels the card ran, the device's idle share, and the device time by
kernel family.  Prints one JSON object per line.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --prompt-len 2048 --gen 8 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch rwkv6-1.6b
"""
from __future__ import annotations

import argparse
import bisect
import json
import time
from collections import defaultdict
from typing import Sequence

import torch

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.devices import resolve_device
from repro_torch.launch import steps
from repro_torch.launch.serve import prompt_batch
from repro_torch.models.lm import LMModel


_CUDA = torch.autograd.DeviceType.CUDA


def _family(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_attention (ours)"
    if "flash_bwd" in n:
        return "flash_attention_bwd (ours)"
    if "rmsnorm_bwd" in n or "rmsnorm_dscale" in n:
        return "rmsnorm_bwd (ours)"
    if "rmsnorm" in n:
        return "rmsnorm (ours)"
    if "wkv6" in n:
        # the backward's kernels: its own names, or the forward's
        # kernels with a template flag true (the serial dv pass and the
        # chunked form's passes run backwards in time or for the backward)
        if any(t in n for t in ("bwd", "ckpt", "du_kernel", ", true>")):
            return "wkv6_bwd (ours)"
        return "wkv6 (ours)"
    if "layer_norm" in n:
        return "layer_norm (torch)"
    if "nchwtonhwc" in n or "nhwctonchw" in n:
        return "layout transform (cuDNN)"
    # cuDNN's FFT convolutions run complex (cf32) GEMMs
    if any(t in n for t in ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                            "implicit_gemm", "winograd", "fft", "cf32")):
        return "convolution (cuDNN, depthwise: torch)"
    if any(t in n for t in ("group_norm", "rowwisemoments", "fusedparams",
                            "gammabeta", "internalgradients",
                            "batch_norm")):
        return "group / batch norm (torch)"
    if "pool" in n:
        return "max pool (torch)"
    if any(t in n for t in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise (torch)"
    if "reduce" in n or "softmax" in n:
        return "reduction / softmax (torch)"
    if "copy" in n or "memcpy" in n or "memset" in n or "fill" in n:
        return "copy / fill"
    return "other"


def _union_ms(spans) -> float:
    """Length of the union of ``(start_us, end_us)`` intervals, in ms:
    kernels that overlap (several streams) count once."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _range_kernels(evs, kernels, ranges):
    """For each name in ``ranges``: the device ms, the kernels and the calls
    of the CPU ranges of that name, a range's kernels being those whose
    launch (the CPU runtime call with the kernel's linked correlation id)
    starts inside it on its thread."""
    by_corr = defaultdict(list)
    for k in kernels:
        by_corr[k.linked_correlation_id()].append(k)
    launches = sorted((e.start_thread_id(), e.start_ns(), e.correlation_id())
                      for e in evs if e.device_type() != _CUDA
                      and not e.is_user_annotation()
                      and e.correlation_id() in by_corr)
    out = {name: {"device_ms": 0.0, "kernels": 0, "calls": 0}
           for name in ranges}
    for a in evs:
        if not (a.is_user_annotation() and a.device_type() != _CUDA
                and a.name() in out):
            continue
        rec, tid = out[a.name()], a.start_thread_id()
        lo = bisect.bisect_left(launches, (tid, a.start_ns()))
        hi = bisect.bisect_left(launches, (tid, a.end_ns()))
        ks = [k for _, _, c in launches[lo:hi] for k in by_corr[c]]
        rec["device_ms"] += sum(k.duration_ns() for k in ks) / 1e6
        rec["kernels"] += len(ks)
        rec["calls"] += 1
    return out


def device_profile(fn, dev, ranges: Sequence[str] = ()):
    """Run ``fn`` under the profiler; wall ms, device ms by family (summed
    over kernels) and the idle share of the window (from the union of the
    kernels' intervals, so overlapping kernels count once).  For each name
    in ``ranges`` (a ``torch.profiler.record_function`` label), the device
    ms and the count of the kernels launched inside such ranges."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    return profile_summary(prof, wall * 1e3, ranges)


def profile_summary(prof, wall_ms: float, ranges: Sequence[str] = ()):
    """:func:`device_profile`'s figures from a finished
    ``torch.profiler.profile`` whose window took ``wall_ms``.

    It reads the profiler's raw event list,
    ``prof.profiler.kineto_results``: a private attribute, which a torch
    release may rename (then every traced phase fails here).  The public
    ``prof.events()`` builds a Python object tree of every event: ~27 s on
    the host of an NVIDIA H100 80GB HBM3 machine for a traced smollm-360m
    training step (57k kernels, 371k events).  The ``cuda`` test
    ``test_profile_summary_agrees_with_the_event_tree`` holds the two to
    the same family sums and range counts on one trace."""
    evs = prof.profiler.kineto_results.events()
    # device events but the ranges' own copies on the device timeline
    kernels = [e for e in evs
               if e.device_type() == _CUDA and not e.is_user_annotation()]
    by_family = defaultdict(float)
    by_name = defaultdict(float)
    spans = []
    for k in kernels:
        ms = k.duration_ns() / 1e6
        by_family[_family(k.name())] += ms
        by_name[k.name()[:80]] += ms
        spans.append((k.start_ns() / 1e3, k.end_ns() / 1e3))
    busy = _union_ms(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_ms, "device_ms": sum(by_family.values()),
           "device_busy_ms": busy,
           "idle_share": (1 - busy / wall_ms) if spans else None,
           "device_events": len(spans),
           "by_family_ms": dict(sorted(by_family.items(),
                                       key=lambda kv: -kv[1])),
           "top_kernels_ms": dict(top)}
    if ranges:
        out["ranges"] = _range_kernels(evs, kernels, ranges)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    choices=configs.ARCH_NAMES)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("profile_serve measures the card: pass a CUDA device")

    arch = configs.get_arch(args.arch)
    pcfg = configs.get_parallel(args.arch).with_(data=1, tp=1)
    pshape = ShapeConfig("prefill", args.prompt_len, args.batch, "prefill")
    dshape = ShapeConfig("decode", args.prompt_len + args.gen, args.batch,
                         "decode")
    pcfg = pcfg.with_(n_micro=configs.derive_n_micro(pshape, pcfg))
    model = LMModel(arch, pcfg, dtype=torch.bfloat16, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    prefill = steps.build_prefill_step(model, pcfg, model.stage_devices,
                                       pshape)
    decode = steps.build_serve_step(model, pcfg, model.stage_devices, dshape)
    tok_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, arch.vocab, (args.batch, args.prompt_len),
                            generator=tok_gen, device=dev)
    pbatch = prompt_batch(arch, prompts, torch.bfloat16, tok_gen)
    n_dec = args.gen - 1

    def run_prefill():
        cache = model.init_cache(dshape, pcfg.n_micro, filled=False)
        logits, cache = prefill(params, cache, pbatch)
        return torch.argmax(logits, -1), cache

    def run_decode(tok, cache):
        for _ in range(n_dec):
            logits, cache = decode(params, cache, tok)
            tok = torch.argmax(logits, -1)
        return tok

    tok, cache = run_prefill()            # warm-up: kernels, cuBLAS, allocator
    run_decode(tok, cache)
    torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    tok, cache = run_prefill()
    torch.cuda.synchronize(dev)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_decode(tok, cache)
    torch.cuda.synchronize(dev)
    t_decode = time.perf_counter() - t0
    print(json.dumps({
        "phase": "warm", "arch": arch.name, "pipe": pcfg.pipe,
        "n_micro": pcfg.n_micro, "batch": args.batch,
        "prompt": args.prompt_len, "decode_steps": n_dec,
        "device": torch.cuda.get_device_name(dev),
        "prefill_ms": t_prefill * 1e3,
        "decode_step_ms": t_decode * 1e3 / max(n_dec, 1),
        "decode_tok_per_s": n_dec * args.batch / max(t_decode, 1e-9)}),
        flush=True)

    state = {}

    def prof_prefill():
        state["tok"], state["cache"] = run_prefill()

    print(json.dumps({"phase": "trace_prefill",
                      **device_profile(prof_prefill, dev)}), flush=True)
    print(json.dumps({"phase": "trace_decode", "steps": n_dec,
                      **device_profile(lambda: run_decode(state["tok"],
                                                           state["cache"]),
                                        dev)}), flush=True)


if __name__ == "__main__":
    main()
