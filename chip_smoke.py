#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (``src/repro_torch``): the quickest
proof that the port builds, agrees with itself, serves and trains on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases (each prints JSON lines; any failure raises, so the exit code is
non-zero and no result line is printed):

1. device   the card's name and ``nvidia-smi`` name / power limit;
2. build    the three CUDA sources from ``src/repro_torch/kernels/csrc``
            with ``nvcc`` for sm_90a, in parallel; per kernel function, the
            count of wgmma (HGMMA) and mma.sync (HMMA) instructions in the
            SASS: the bf16 attention forward, dQ and dK/dV kernels must hold
            HGMMA (the backward ones no HMMA), the chunked WKV passes HMMA;
            each kernel's registers and spills (no WKV or backward kernel
            may spill) and any wgmma that ptxas serialised;
3. kernels  each kernel against its plain PyTorch version on the card over
            a grid of shapes (WKV in both its chunked and its serial form,
            with masked tails and decays that underflow to 0; attention
            also at the training path's q [2,15,4096,64] with the lse the
            backward reads), then timed at
            the serving paths' shapes beside its plain version and one
            library call where PyTorch has one (the yardstick only); RMSNorm
            at both paths' widths (960 and 2048); WKV also at one decode
            step, and by kernel from a profiler trace;
   backward the attention and RMSNorm backward kernels against their plain
            versions over a grid that holds the training path's shapes, and
            again at every timed shape, the bf16 attention backward twice
            at the training call (bitwise equal), the autograd checks (the
            Functions' outputs carry a grad_fn, a CUDA WKV-6 call under
            grad raises), then both
            timed beside the bound and the PyTorch call that computes the
            same backward (SDPA's, F.rms_norm's: yardsticks only), with the
            achieved TFLOP/s and the bound's share of the time;
4. port     the same weights through the kernels on the card and through
            the plain versions on the CPU, prefill + 4 decode steps, logits
            compared: smollm-360m at full width, 4 layers, pipe 2, fp32;
            rwkv6-1.6b at full width, 2 layers, pipe 2, fp32; and training:
            smollm-360m at full width, 4 layers, pipe 2, seq 256, fp32, the
            GPipe loss and every gradient leaf compared (each leaf also
            within 1e-4 of its own largest entry);
5. serve    the main paths, each with the launch counters set to 0 just
            before it and read just after, through
            ``repro_torch.launch.serve.serve`` on one card with batch 8
            (m = 8), prompt 2048 and 32 generated tokens: smollm-360m, all
            32 layers, bf16, pipe 16, data 1; rwkv6-1.6b, all 24 layers,
            bf16, pipe 8, tp 1, data 1.  The counters must equal what each
            path implies;
6. train    the training main path with the counters set to 0 just before
            and read just after, through ``repro_torch.launch.train.train``:
            smollm-360m, all 32 layers, bf16, pipe 16, data 1, seq 4096,
            batch 16 (m = 8), remat "full", AdamW at a constant lr, 5 steps
            on one fixed batch and a sixth under the profiler: finite loss
            and grad norm, the step-5 loss below step 1's, each step's
            launches equal to the path's formulas; step ms, tokens/s, the
            model-FLOPs share and the traced step's device ms by kernel
            family and idle share;
7. memory   peak device memory of one train step with remat "full" and
            with "none" (all 32 layers, seq 4096, batch 4, m 4, where
            "none" fits on the card): "full" must be the lower.

The kernels summary line, then the card's ``nvidia-smi`` name and power
limit, then the last line ``{"ok": true, "device": {...}}``.  It imports
nothing of JAX or ``repro``.
"""
from __future__ import annotations

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
KERNELS = ("flash_attention", "rmsnorm", "wkv6", "flash_attention_bwd",
           "rmsnorm_bwd")


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


def with_rates(rec, flops):
    """A kernel_timing record with its achieved TFLOP/s (``flops`` over the
    measured time) and its bound share (bound over time)."""
    return rec | {"tflops": flops / (rec["ms"] * 1e-3) / 1e12,
                  "bound_share": rec["bound_ms"] / rec["ms"]}


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
# output passes on mma.sync.
SASS_GATES = {
    "flash_fwd_wgmma_kernel": {"HGMMA": True},
    "flash_bwd_dkdv_wgmma_kernel": {"HGMMA": True, "HMMA": False},
    "flash_bwd_dq_wgmma_kernel": {"HGMMA": True, "HMMA": False},
    "wkv6_update_kernel": {"HMMA": True},
    "wkv6_out_kernel": {"HMMA": True},
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
    attn = with_rates(attn, attn_flops)
    wkv = with_rates(wkv, wkv_tc_flops)
    for rec in (norm, norm_rwkv, attn, wkv):
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
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_cuda)
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_bwd,
                                             rmsnorm_bwd_plain)
    from repro_torch.kernels.wkv6 import wkv6

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

    # -- the bf16 backward at the training call, twice on the same inputs:
    #    no atomics, so dq, dk and dv are bitwise equal -----------------------
    q = randn(2, 15, 4096, 64, dtype=torch.bfloat16)
    k, v = (randn(2, 5, 4096, 64, dtype=torch.bfloat16) for _ in range(2))
    do = randn(2, 15, 4096, 64, dtype=torch.bfloat16)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True)
    first = flash_attention_bwd(q, k, v, out, lse, do)
    again = flash_attention_bwd(q, k, v, out, lse, do)
    same = [bool(torch.equal(a, b)) for a, b in zip(first, again)]
    emit({"check": "flash_attention_bwd_bitwise", "b": 2, "hq": 15, "hkv": 5,
          "s": 4096, "d": 64, "dtype": "bfloat16",
          "equal": dict(zip(("dq", "dk", "dv"), same)), "ok": all(same)})
    if not all(same):
        raise AssertionError(f"attention backward differs between calls: "
                             f"{same}")

    # -- RMSNorm: both widths compiled for the forward and a generic one;
    #    5 and 33 rows are ragged shares of the backward's grid --------------
    for d in (D_MODEL, 2048, 448):
        for rows in (1, 3, 5, 33, 2048, 8192):
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

    # -- autograd: the Functions carry grad_fn; WKV under grad raises -------
    q = randn(1, 15, 64, 64, dtype=torch.bfloat16).requires_grad_()
    k, v = (randn(1, 5, 64, 64, dtype=torch.bfloat16) for _ in range(2))
    x = randn(4, D_MODEL, dtype=torch.bfloat16).requires_grad_()
    s = randn(D_MODEL, dtype=torch.bfloat16)
    a_out, n_out = flash_attention(q, k, v), rmsnorm(x, s)
    if a_out.grad_fn is None or n_out.grad_fn is None:
        raise AssertionError("a kernel Function's output has no grad_fn")
    r = randn(1, 32, 64, 64, dtype=torch.bfloat16).requires_grad_()
    w = torch.full((1, 32, 64, 64), 0.9, device=dev)
    u = torch.zeros(32, 64, device=dev)
    s0 = torch.zeros(1, 32, 64, 64, device=dev)
    try:
        wkv6(r, r.detach(), r.detach(), w, u, s0)
    except NotImplementedError as e:
        wkv_msg = str(e)
    else:
        raise AssertionError("wkv6 on CUDA under grad did not raise")
    emit({"check": "autograd", "attention_grad_fn": type(a_out.grad_fn).__name__,
          "rmsnorm_grad_fn": type(n_out.grad_fn).__name__,
          "wkv6_under_grad": wkv_msg, "ok": True})

    # -- timing: attention at q [1,15,S,64] causal (S 2048, 4096; bf16 and
    #    fp32) and at the training path's [2,15,4096,64] bf16; RMSNorm at
    #    [1,2048,960], [16,4096,960] and the path's [2,4096,960] bf16 ------
    def attn_timing(b, sq, dname):
        dt = dtypes[dname]
        q = randn(b, 15, sq, 64, dtype=dt)
        k, v = (randn(b, 5, sq, 64, dtype=dt) for _ in range(2))
        do = randn(b, 15, sq, 64, dtype=dt)
        out, lse = flash_attention_cuda(q, k, v, return_lse=True)
        err = checked_max_err(torch, dname, "flash_attention_bwd", zip(
            flash_attention_bwd(q, k, v, out, lse, do),
            flash_attention_bwd_plain(q, k, v, out, lse, do)))
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                              enable_gqa=True)
        flops = 5 * 2 * 64 * 15 * b * sq * (sq + 1) // 2
        nbytes = q.element_size() * 64 * b * sq * (4 * 15 + 4 * 5) + 4 * b * 15 * sq
        peak = PEAK_BF16_FLOPS if dname == "bfloat16" else PEAK_FP32_FLOPS
        iters = 20 if sq <= 2048 else 5
        rec = {
            "name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/ref.py:138",
            "max_abs_err": err,
            "ms": device_ms(torch, lambda: flash_attention_bwd(
                q, k, v, out, lse, do), iters),
            "plain_ms": device_ms(torch, lambda: flash_attention_bwd_plain(
                q, k, v, out, lse, do), 2),
            "library_ms": grad_ms(torch, sdpa, (qg, kg, vg), do, iters),
            "bound_ms": 1e3 * max(flops / peak, nbytes / HBM_BYTES_PER_S),
            "bound_by": ("operations" if flops / peak >= nbytes / HBM_BYTES_PER_S
                         else "bytes"),
            "shape": {"q": [b, 15, sq, 64], "kv": [b, 5, sq, 64],
                      "causal": True}, "dtype": dname, "flops": flops,
        }
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
    norm_timing((1, 2048, D_MODEL))
    norm_timing((16, 4096, D_MODEL))
    return {"flash_attention_bwd": attn_timing(2, 4096, "bfloat16"),
            "rmsnorm_bwd": norm_timing((2, 4096, D_MODEL))}


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


def phase_train_port(torch, n_layers: int = 4, seq: int = 256):
    """Training, the port against itself: the GPipe loss and every gradient
    leaf through the kernels on the card vs the plain versions on the CPU,
    same weights and batch (fp32), so a dropped gradient cannot pass."""
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models.lm import LMModel
    from repro_torch.tree import tree_items, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    arch = dataclasses.replace(configs.get_arch("smollm-360m"),
                               n_layers=n_layers)
    pcfg = configs.get_parallel("smollm-360m").with_(pipe=2, data=1,
                                                      n_micro=2)
    batch = 2
    g = torch.Generator().manual_seed(3)
    data = {k: torch.randint(0, arch.vocab, (batch, seq), generator=g)
            for k in ("tokens", "labels")}
    params_cpu = LMModel(arch, pcfg, dtype=torch.float32, device="cpu").init(
        torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cpu", "cuda"):
        model = LMModel(arch, pcfg, dtype=torch.float32, device=dev)
        params = tree_map(lambda a: a.to(dev).requires_grad_(), params_cpu)
        leaves = [p for _, p in tree_items(params)]
        loss = steps.build_loss_fn(model, pcfg, model.device)(
            params, {k: v.to(dev) for k, v in data.items()})
        grads = torch.autograd.grad(loss, leaves)
        runs[dev] = (loss.detach().cpu(), [gr.cpu() for gr in grads])
    paths = [p for p, _ in tree_items(params_cpu)]
    errs = {"loss": max_err(torch, runs["cuda"][0], runs["cpu"][0])}
    tops, bad = {}, []
    if not torch.allclose(runs["cuda"][0], runs["cpu"][0], rtol=PORT_TOL,
                          atol=PORT_TOL):
        bad.append("loss")
    for path, a, b in zip(paths, runs["cuda"][1], runs["cpu"][1]):
        errs[path] = max_err(torch, a, b)
        tops[path] = float(b.abs().max())
        # each leaf at 1e-3 and within GRAD_REL of its own largest entry,
        # so a leaf of small gradients cannot pass zeroed
        if not (torch.allclose(a, b, rtol=PORT_TOL, atol=PORT_TOL)
                and errs[path] <= GRAD_REL * tops[path]
                and bool(torch.isfinite(a).all()) and tops[path] > 0):
            bad.append(path)
    emit({"phase": "train_gpu_vs_cpu", "arch": arch.name,
          "n_layers": n_layers, "pipe": 2, "n_micro": 2, "batch": batch,
          "seq": seq, "dtype": "float32", "loss": float(runs["cuda"][0]),
          "max_abs_err": errs, "max_abs_ref": tops, "tol": PORT_TOL,
          "rel_tol": GRAD_REL, "ok": not bad})
    if bad:
        raise AssertionError(f"training GPU vs CPU disagrees at {bad}: "
                             f"{errs}")


def head_chunks(seq: int) -> int:
    """The head loss's chunks over the sequence (``LMModel.head_loss``)."""
    from repro_torch.models.lm import head_loss_chunk
    return seq // head_loss_chunk(seq)


def expected_train_launches(layers: int, m: int, seq: int, remat: str,
                            remat_last_micro: bool = True):
    """Kernel launches one train step implies: attention once per layer and
    micro-batch forward, again for each micro-batch recomputed before its
    backward (all m with remat "full", m - 1 without the last when
    ``remat_last_micro`` is False, none with "none"), and once backward;
    RMSNorm twice per layer and micro-batch in each of those, plus the
    head's once per loss chunk forward and again in that chunk's recompute
    (the chunks are always checkpointed) and once backward."""
    lm, nc = layers * m, head_chunks(seq)
    replays = 0 if remat == "none" else (m if remat_last_micro else m - 1)
    fwd = lm + layers * replays
    return {"flash_attention": fwd, "flash_attention_bwd": lm,
            "rmsnorm": 2 * fwd + 2 * nc, "rmsnorm_bwd": 2 * lm + nc}


def phase_train(torch):
    """The training main path: counters set to 0 just before, read after."""
    from repro_torch import configs
    from repro_torch.launch.train import launches, train
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd

    arch = configs.get_arch("smollm-360m")
    pcfg = configs.get_parallel("smollm-360m").with_(data=1, tp=1, n_micro=8,
                                                      remat="full")
    seq, batch, n_steps = 4096, 16, 5
    ocfg = OptimizerConfig(lr=5e-4, warmup_steps=0, min_lr_ratio=1.0,
                           dynamic_loss_scale=True)
    for fn in (flash_attention, flash_attention_bwd, rmsnorm, rmsnorm_bwd):
        fn.launches = 0
    res = train(arch, pcfg, seq_len=seq, batch=batch, steps=n_steps,
                device="cuda", dtype=torch.bfloat16, seed=0, ocfg=ocfg,
                fixed_batch=True, trace=True)
    totals = launches()
    hist = res["history"]
    want = expected_train_launches(arch.n_layers, pcfg.n_micro, seq,
                                   pcfg.remat, pcfg.remat_last_micro)
    warm = sorted(r["step_s"] for r in hist[1:])
    step_s = warm[len(warm) // 2]                  # median of steps 2..5
    rec = {"phase": "train", "arch": arch.name, "n_layers": arch.n_layers,
           "pipe": pcfg.pipe, "tp": pcfg.tp, "data": pcfg.data,
           "n_micro": pcfg.n_micro, "remat": pcfg.remat, "seq": seq,
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
           "model_flops_formula": "3 x (2 x matmul weights x tokens + 2 x 2 "
                                  "x hd x Hq x S (S + 1) / 2 x layers x "
                                  "batch) over the step time and 989 TFLOP/s",
           "peak_mem_gib": res["peak_mem_bytes"] / 2 ** 30,
           "launches_per_step": [r["launches"] for r in hist],
           "launches_expected_per_step": want, "launches_total": totals,
           "trace": res["trace"]}
    emit(rec)
    losses = rec["losses"]
    if not all(math.isfinite(x) for x in losses + rec["grad_norms"]):
        raise AssertionError(f"non-finite training: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"step-5 loss {losses[-1]} not below step 1's "
                             f"{losses[0]}")
    per_step = [r["launches"] for r in hist] + [res["trace"]["launches"]]
    if any(n != want for n in per_step) or totals != {
            k: (n_steps + 1) * v for k, v in want.items()}:
        raise AssertionError(f"train launches {rec['launches_per_step']} / "
                             f"{totals} differ from the path's {want}")
    return totals


def phase_memory(torch):
    """Peak memory of one train step, remat "full" against "none".

    The bytes first (smollm-360m, bf16, 32 layers, seq 4096, batch 4, m 4:
    16,384 tokens).  "none" keeps every layer's saved activations until its
    backward: ~40 KB a token a layer (norm inputs and outputs, q / k / v and
    their contiguous copies, the attention output twice, four d_ff-wide MLP
    tensors), ~21 GB, plus ~6 GB of weights, gradients and fp32 AdamW
    state: it fits on the 80 GB card.  "full" keeps each stage's input
    (16 stages x 4 micro-batches x 7.9 MB) and one stage's recompute at a
    time beside ~6 GB of weights, gradients and optimizer state, which the
    optimizer updates in place one leaf at a time: ~8 GB."""
    from repro_torch import configs
    from repro_torch.launch.train import train
    from repro_torch.optim.optimizers import OptimizerConfig

    arch = configs.get_arch("smollm-360m")
    peaks = {}
    for remat in ("full", "none"):
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
    emit({"phase": "memory", "arch": arch.name, "seq": 4096, "batch": 4,
          "n_micro": 4, "pipe": 16, "dtype": "bfloat16",
          "peak_mem_gib": peaks, "ok": peaks["full"] < peaks["none"]})
    if not peaks["full"] < peaks["none"]:
        raise AssertionError(f"remat full peak {peaks['full']} GiB is not "
                             f"below none's {peaks['none']} GiB")


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
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.launch.serve import serve

    counters = {"flash_attention": flash_attention, "rmsnorm": rmsnorm,
                "wkv6": wkv6}
    backward = (flash_attention_bwd, rmsnorm_bwd)   # serving runs none
    arch = configs.get_arch(arch_name)
    pcfg = configs.get_parallel(arch_name).with_(data=1, tp=1)
    batch, prompt, gen = 8, 2048, 32
    for fn in (*counters.values(), *backward):
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
    timing.update(phase_backward(torch))
    phase_port(torch, "smollm-360m", n_layers=4, prompt=256)
    phase_port(torch, "rwkv6-1.6b", n_layers=2, prompt=128)
    phase_train_port(torch)
    launches = {k: 0 for k in KERNELS}
    for arch_name in ("smollm-360m", "rwkv6-1.6b"):
        for k, n in phase_serve(torch, arch_name).items():
            launches[k] += n
    for k, n in phase_train(torch).items():
        launches[k] += n
    phase_memory(torch)
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
