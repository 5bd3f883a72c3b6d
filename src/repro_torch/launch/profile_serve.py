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
import json
import time
from collections import defaultdict

import torch

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.devices import resolve_device
from repro_torch.launch import steps
from repro_torch.models.lm import LMModel


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
        return "wkv6 (ours)"
    if "layer_norm" in n:
        return "layer_norm (torch)"
    if any(t in n for t in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise (torch)"
    if "reduce" in n or "softmax" in n:
        return "reduction / softmax (torch)"
    if "copy" in n or "memcpy" in n or "memset" in n or "fill" in n:
        return "copy / fill"
    return "other"


def device_profile(fn, dev):
    """Run ``fn`` under the profiler; wall ms and device ms by family."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    by_family = defaultdict(float)
    by_name = defaultdict(float)
    n_kernels = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            ms = evt.device_time / 1e3                        # us -> ms
            by_family[_family(evt.name)] += ms
            by_name[evt.name[:80]] += ms
            n_kernels += 1
    busy = sum(by_family.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall * 1e3, "device_ms": busy,
            "idle_share": (1 - busy / (wall * 1e3)) if n_kernels else None,
            "device_events": n_kernels,
            "by_family_ms": dict(sorted(by_family.items(),
                                        key=lambda kv: -kv[1])),
            "top_kernels_ms": dict(top)}


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
    prompts = torch.randint(
        0, arch.vocab, (args.batch, args.prompt_len),
        generator=torch.Generator(device=dev).manual_seed(args.seed + 1),
        device=dev)
    n_dec = args.gen - 1

    def run_prefill():
        cache = model.init_cache(dshape, pcfg.n_micro, filled=False)
        logits, cache = prefill(params, cache, {"tokens": prompts})
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
