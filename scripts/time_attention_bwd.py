"""Time the attention backward kernel (``flash_attention_bwd``) on the card.

For each shape of a fixed grid: seeded inputs, the forward kernel for ``out``
and ``lse``, then the backward kernel held against its plain version (max
|kernel - plain| over dq, dk, dv, and the largest |plain|), a SHA-256 digest
of the kernel's dq, dk and dv (two builds that compute the same sums in the
same order give the same digest), its device time per call from CUDA events
around back-to-back calls, each of its kernels' device µs a call from a
profiler trace, and, for bf16, the time of SDPA's backward on the same
inputs (the library yardstick).  One JSON object a line, then the card's
name and power limit.

    python scripts/time_attention_bwd.py [--dtype float32|bfloat16] [--iters N]

Needs a CUDA card and ``nvcc``: the kernels are built from ``src/`` first.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import kernel_us  # noqa: E402  (imports no torch itself)

# (b, hq, hkv, s, d, causal, window): GQA 15:5 at D 64 (smollm's heads),
# whisper's non-causal 6:6, a window, MHA and GQA at D 128, MQA 8:1 at D 256
# and at gemma-2b's training call
GRID = (
    (1, 15, 5, 2048, 64, True, 0),
    (1, 15, 5, 4096, 64, True, 0),
    (2, 6, 6, 4096, 64, False, 0),
    (1, 15, 5, 2048, 64, True, 256),
    (1, 32, 32, 2048, 128, True, 0),
    (1, 8, 2, 2048, 128, False, 0),
    (1, 8, 1, 2048, 256, True, 0),
    (2, 8, 1, 4096, 256, True, 0),
)


def device_ms(torch, fn, iters: int) -> float:
    """Device ms per call: events around ``iters`` back-to-back calls, behind
    a sleep kernel that holds the stream while the host enqueues them."""
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_cuda)

    build.build_all(["flash_attention"])
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, args.dtype)
    dev = torch.device("cuda")
    for b, hq, hkv, s, d, causal, window in GRID:
        gen = torch.Generator(device=dev).manual_seed(0)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dt)

        q, do = randn(b, hq, s, d), randn(b, hq, s, d)
        k, v = randn(b, hkv, s, d), randn(b, hkv, s, d)
        kw = dict(causal=causal, window=window)
        out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        got = flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
        want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
        digest = hashlib.sha256()
        for g in got:
            digest.update(g.float().cpu().numpy().tobytes())

        def bwd():
            return flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
        sdpa_ms = None
        if dt == torch.bfloat16:
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
            y = torch.nn.functional.scaled_dot_product_attention(
                qg, kg, vg, is_causal=causal and not window,
                enable_gqa=hq != hkv,
                attn_mask=None if not window else ref.attention_mask(
                    s, s, causal=causal, window=window, device=dev))
            sdpa_ms = device_ms(torch, lambda: torch.autograd.grad(
                y, (qg, kg, vg), do, retain_graph=True), args.iters)
            del qg, kg, vg, y
        print(json.dumps({
            "q": [b, hq, s, d], "kv": [b, hkv, s, d], "causal": causal,
            "window": window, "dtype": args.dtype,
            "max_abs_err": max(float((g.float() - w.float()).abs().max())
                               for g, w in zip(got, want)),
            "max_abs_plain": max(float(w.float().abs().max()) for w in want),
            "sha256": digest.hexdigest()[:16],
            "ms": device_ms(torch, bwd, args.iters),
            "per_kernel_us": kernel_us(torch, bwd, 3),
            "sdpa_ms": sdpa_ms,
        }), flush=True)
        del q, k, v, do, out, lse, got, want
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
