#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (``src/repro_torch``): the quickest
proof that the port builds, agrees with itself and serves on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases (each prints JSON lines; any failure raises, so the exit code is
non-zero and no result line is printed):

1. device   the card's name and ``nvidia-smi`` name / power limit;
2. build    the three CUDA sources from ``src/repro_torch/kernels/csrc``
            with ``nvcc`` for sm_90a, in parallel; the count of wgmma
            (HGMMA) instructions in the attention library and of mma.sync
            (HMMA) instructions in the WKV library, neither of which may be
            0; each WKV kernel's registers and spills (none may spill);
3. kernels  each kernel against its plain PyTorch version on the card over
            a grid of shapes (WKV in both its chunked and its serial form,
            with masked tails and decays that underflow to 0), then timed at
            the serving paths' shapes beside its plain version and one
            library call where PyTorch has one (the yardstick only); RMSNorm
            at both paths' widths (960 and 2048); WKV also at one decode
            step, and by kernel from a profiler trace;
4. port     the same weights through the kernels on the card and through
            the plain versions on the CPU, prefill + 4 decode steps, logits
            compared: smollm-360m at full width, 4 layers, pipe 2, fp32;
            rwkv6-1.6b at full width, 2 layers, pipe 2, fp32;
5. serve    the main paths, each with the launch counters set to 0 just
            before it and read just after, through
            ``repro_torch.launch.serve.serve`` on one card with batch 8
            (m = 8), prompt 2048 and 32 generated tokens: smollm-360m, all
            32 layers, bf16, pipe 16, data 1; rwkv6-1.6b, all 24 layers,
            bf16, pipe 8, tp 1, data 1.  The counters must equal what each
            path implies.

The line before the last is the ``kernels`` summary; the last line is
``{"ok": true, "device": {...}}``.  It imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
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
PORT_TOL = 1e-3   # whole model, fp32, kernels on the card vs plain on the CPU
KERNELS = ("flash_attention", "rmsnorm", "wkv6")


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
            key = evt.name[:60]
            per[key] = per.get(key, 0.0) + evt.device_time / iters
    return per


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


def sass_count(build, lib: str, op: str) -> int:
    """Lines of ``op`` (e.g. HGMMA, HMMA) in a built library's SASS."""
    sass = subprocess.run(
        [str(Path(build.nvcc_path()).parent / "cuobjdump"), "--dump-sass",
         str(build.lib_path(lib))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    return sum(op in ln for ln in sass.splitlines())


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all(force=True)
    dt = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    # the bf16 attention kernel runs both products on wgmma (HGMMA in the
    # SASS); the chunked WKV form runs its products on mma.sync (HMMA)
    hgmma = sass_count(build, "flash_attention", "HGMMA")
    hmma = sass_count(build, "wkv6", "HMMA")
    wkv_kernels = ptxas_kernels(logs["wkv6"])
    emit({"phase": "build", "seconds": dt, "nvcc": build.nvcc_path(),
          "flags": list(build.NVCC_FLAGS), "ptxas": ptxas,
          "hgmma": {"flash_attention": hgmma}, "hmma": {"wkv6": hmma},
          "wkv6_kernels": wkv_kernels})
    if hgmma == 0:
        raise AssertionError("libflash_attention.so holds no HGMMA")
    if hmma == 0:
        raise AssertionError("libwkv6.so holds no HMMA")
    spilled = {n: k for n, k in wkv_kernels.items()
               if k.get("spill_bytes", 0) > 0}
    if not wkv_kernels or spilled:
        raise AssertionError(f"WKV kernels spill or were not reported: "
                             f"{spilled or wkv_kernels}")


def phase_kernels(torch):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
    from repro_torch.kernels.wkv6 import (uses_chunked_form, wkv6,
                                          wkv6_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # -- RMSNorm grid: smollm's width, rwkv6's group norm (both compiled for
    #    their D) and a width that takes the kernel's generic-D form -------
    for d in (D_MODEL, 2048, 448):
        for rows in (1, 8, 2048):
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
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        return rec

    norm = norm_timing(D_MODEL)           # smollm-360m
    norm_rwkv = norm_timing(2048)         # rwkv6-1.6b's group norm
    hq, hkv, sq = 15, 5, 2048
    q = randn(1, hq, sq, 64, dtype=torch.bfloat16)
    k = randn(1, hkv, sq, 64, dtype=torch.bfloat16)
    v = randn(1, hkv, sq, 64, dtype=torch.bfloat16)
    err_a = max_err(torch, flash_attention(q, k, v, causal=True),
                    flash_attention_plain(q, k, v, causal=True))
    pairs = sq * (sq + 1) // 2                      # causal: visible (q, k)
    attn_flops = 4 * 64 * hq * pairs                # q k^T and p v
    attn_bytes = 2 * 64 * sq * (hq + hkv + hkv + hq)
    attn = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:36",
        "max_abs_err": err_a,
        "ms": device_ms(torch, lambda: flash_attention(q, k, v, causal=True),
                        50),
        "plain_ms": device_ms(
            torch, lambda: flash_attention_plain(q, k, v, causal=True), 10),
        "library_ms": device_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 50),
        "bound_ms": 1e3 * max(attn_bytes / HBM_BYTES_PER_S,
                              attn_flops / PEAK_BF16_FLOPS),
        "bound_by": ("bytes" if attn_bytes / HBM_BYTES_PER_S
                     >= attn_flops / PEAK_BF16_FLOPS else "operations"),
        "shape": {"q": [1, hq, sq, 64], "kv": [1, hkv, sq, 64],
                  "causal": True},
        "dtype": "bfloat16", "flops": attn_flops,
    }
    # rwkv6-1.6b prefill: B = mb = 1, H = 32, T = 2048, bf16 r/k/v/out,
    # fp32 w, u and state; no PyTorch call computes WKV-6 (library: none)
    B, H, T, n = 1, 32, 2048, 64
    args = wkv_inputs(B, T, torch.bfloat16, True)
    err_w = max_err(torch, wkv6(*args)[0], wkv6_plain(*args)[0])
    wkv_bytes = (B * H * T * n * (3 * 2 + 4 + 2)   # r, k, v, w in; out
                 + H * n * 4 + 2 * B * H * n * n * 4)   # u; s0 in, sT out
    # the chunked form's four 64 x 64 x 64 products a chunk (r S_in, r k^T,
    # A v, k~^T v) on bf16 tensor cores; the serial form's 5 fp32 operations
    # per (k, v) a step (r.S, w*S + k*v) on the CUDA cores, beside it
    wkv_tc_flops = 4 * 2 * n ** 3 * B * H * (-(-T // 64))
    wkv_serial_flops = 5 * B * H * T * n * n
    bytes_s = wkv_bytes / HBM_BYTES_PER_S
    ops_s = wkv_tc_flops / PEAK_BF16_FLOPS
    dec = wkv_inputs(1, 1, torch.bfloat16, True)      # one decode step
    dec_bytes = (32 * n * (3 * 2 + 4 + 2) + 32 * n * 4
                 + 2 * 32 * n * n * 4)
    wkv = {
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/rwkv6.py:35",
        "max_abs_err": err_w,
        "ms": device_ms(torch, lambda: wkv6(*args), 200),
        "plain_ms": device_ms(torch, lambda: wkv6_plain(*args), 2),
        "library_ms": None,
        "bound_ms": 1e3 * max(bytes_s, ops_s),
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
        "serial_fp32_ops_bound_ms": 1e3 * wkv_serial_flops / PEAK_FP32_FLOPS,
        "shape": [B, H, T, n], "dtype": "bfloat16", "w_dtype": "float32",
        "bytes": wkv_bytes, "tc_flops": wkv_tc_flops,
        "serial_flops": wkv_serial_flops,
        "per_kernel_us": kernel_us(torch, lambda: wkv6(*args), 20),
        "decode_shape": [1, 32, 1, n],
        "decode_ms": device_ms(torch, lambda: wkv6(*dec), 500),
        "decode_bound_ms": 1e3 * dec_bytes / HBM_BYTES_PER_S,
    }
    for rec in (norm, norm_rwkv, attn, wkv):
        emit({"phase": "kernel_timing", **rec})
    return {"rmsnorm": norm, "flash_attention": attn, "wkv6": wkv}


def phase_port(torch, arch_name: str, n_layers: int, prompt: int):
    """The port against itself: kernels on the card vs plain on the CPU."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models.lm import LMModel
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    arch = dataclasses.replace(configs.get_arch(arch_name), n_layers=n_layers)
    pcfg = configs.get_parallel(arch_name).with_(pipe=2, tp=1, data=1,
                                                  n_micro=2)
    batch, n_dec = 2, 4
    pshape = ShapeConfig("p", prompt, batch, "prefill")
    dshape = ShapeConfig("d", prompt + n_dec + 1, batch, "decode")
    cpu = LMModel(arch, pcfg, dtype=torch.float32, device="cpu")
    gpu = LMModel(arch, pcfg, dtype=torch.float32, device="cuda")
    params_cpu = cpu.init(torch.Generator().manual_seed(0))
    params_gpu = tree_map(lambda a: a.to("cuda"), params_cpu)
    prompts = torch.randint(0, arch.vocab, (batch, prompt),
                            generator=torch.Generator().manual_seed(1))
    runs = {}
    for tag, model, params in (("cpu", cpu, params_cpu),
                               ("gpu", gpu, params_gpu)):
        dev = model.device
        prefill = steps.build_prefill_step(model, pcfg, dev, pshape)
        decode = steps.build_serve_step(model, pcfg, dev, dshape)
        cache = model.init_cache(dshape, pcfg.n_micro, filled=False)
        logits, cache = prefill(params, cache, {"tokens": prompts.to(dev)})
        runs[tag] = {"model": model, "decode": decode, "cache": cache,
                     "params": params, "logits": [logits.float().cpu()]}
    for _ in range(n_dec):
        tok = torch.argmax(runs["cpu"]["logits"][-1], -1)
        for tag, r in runs.items():
            logits, r["cache"] = r["decode"](r["params"], r["cache"],
                                             tok.to(r["model"].device))
            r["logits"].append(logits.float().cpu())
    errs = []
    for i, (a, b) in enumerate(zip(runs["gpu"]["logits"],
                                   runs["cpu"]["logits"])):
        ok = torch.allclose(a, b, rtol=PORT_TOL, atol=PORT_TOL)
        errs.append(max_err(torch, a, b))
        if not ok or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"port GPU vs CPU {arch_name} step {i}: max "
                                 f"err {errs[-1]} over tol {PORT_TOL}")
    emit({"phase": "port_gpu_vs_cpu", "arch": arch_name,
          "n_layers": n_layers, "pipe": 2, "dtype": "float32",
          "batch": batch, "prompt": prompt, "decode_steps": n_dec,
          "max_abs_err": errs, "tol": PORT_TOL, "ok": True})


def expected_launches(family: str, layers: int, m: int, gen: int):
    """Kernel launches the serving path implies, per prefill and over the
    ``gen - 1`` decode steps.  dense: one attention per layer and
    micro-batch in prefill (decode attention is plain torch), RMSNorm twice
    per layer plus the head's; ssm: one WKV and one group RMSNorm per layer
    and micro-batch (the block and head norms are LayerNorms)."""
    lm, steps = layers * m, gen - 1
    if family == "dense":
        return {"prefill": {"flash_attention": lm, "rmsnorm": 3 * lm + 1,
                            "wkv6": 0},
                "decode": {"flash_attention": 0,
                           "rmsnorm": steps * (2 * lm + 1), "wkv6": 0}}
    return {"prefill": {"flash_attention": 0, "rmsnorm": lm, "wkv6": lm},
            "decode": {"flash_attention": 0, "rmsnorm": steps * lm,
                       "wkv6": steps * lm}}


def phase_serve(torch, arch_name: str):
    """One main path: counters set to 0 just before, read just after."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.launch.serve import serve

    counters = {"flash_attention": flash_attention, "rmsnorm": rmsnorm,
                "wkv6": wkv6}
    arch = configs.get_arch(arch_name)
    pcfg = configs.get_parallel(arch_name).with_(data=1, tp=1)
    batch, prompt, gen = 8, 2048, 32
    for fn in counters.values():
        fn.launches = 0
    res = serve(arch, pcfg, prompt_len=prompt, gen=gen, batch=batch,
                device="cuda", dtype=torch.bfloat16, seed=0)
    totals = {k: fn.launches for k, fn in counters.items()}
    m, layers = res["n_micro"], arch.n_layers
    want = expected_launches(arch.family, layers, m, gen)
    want_totals = {k: want["prefill"][k] + want["decode"][k] for k in totals}
    per_step = {k: v / (gen - 1) for k, v in res["launches"]["decode"].items()}
    logits = res["logits"]
    toks = res["tokens"]
    emit({"phase": "serve", "arch": arch.name, "family": arch.family,
          "n_layers": layers, "pipe": pcfg.pipe, "tp": pcfg.tp,
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


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch is missing beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    t0 = time.perf_counter()
    name, smi = phase_device(torch)
    phase_build()
    timing = phase_kernels(torch)
    phase_port(torch, "smollm-360m", n_layers=4, prompt=256)
    phase_port(torch, "rwkv6-1.6b", n_layers=2, prompt=128)
    launches = {k: 0 for k in KERNELS}
    for arch_name in ("smollm-360m", "rwkv6-1.6b"):
        for k, n in phase_serve(torch, arch_name).items():
            launches[k] += n
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
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
