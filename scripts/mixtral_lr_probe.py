"""mixtral-8x7b cut in depth on one card: the AdamW loss curve in bf16 and
in fp32 at the same lr, to tell the precision from the optimizer (ROADMAP
fault C5: at lr 5e-4 the 2-layer cut's bf16 curve rises over 5 steps).

Full width (d 4,096, 8 experts top-2 over d_ff 14,336, GQA 32:8 at head_dim
128, window 4,096), seq 4096, remat "full", gpipe, through
``launch.train.train`` on one fixed batch (weights and batch from seed 0),
AdamW at a constant lr with no warmup and a dynamic loss scale
(``chip_smoke.py``'s ``train`` settings).  Each run of ``RUNS`` is
(dtype, layers, pipe, batch, m, lr): the ``train`` phase's cell (bf16, 2
layers, pipe 2, batch 16, m 8), the same at batch 4, m 2 (the same 2-row
micro-batch), fp32 there (which does not fit: the fp32 weights and
gradients beside the master copy and moments), then bf16 and fp32 at 1
layer, pipe 1, batch 4, m 2, at lr 5e-4 and 5e-5.  One JSON object a run
(losses, grad norms, step ms, peak GiB, or the error of a run that
failed), then the card's name and power limit.

    python scripts/mixtral_lr_probe.py

Needs a CUDA card and ``nvcc``: the kernels are built from ``src/`` first.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SEQ, STEPS = 4096, 5
RUNS = (("bfloat16", 2, 2, 16, 8, 5e-4),
        ("bfloat16", 2, 2, 4, 2, 5e-4), ("float32", 2, 2, 4, 2, 5e-4),
        ("bfloat16", 1, 1, 4, 2, 5e-4), ("float32", 1, 1, 4, 2, 5e-4),
        ("bfloat16", 1, 1, 4, 2, 5e-5), ("float32", 1, 1, 4, 2, 5e-5))


def main() -> int:
    import torch
    from repro_torch import configs
    from repro_torch.launch.train import train
    from repro_torch.optim.optimizers import OptimizerConfig

    if not torch.cuda.is_available():
        print("mixtral_lr_probe.py needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    full = configs.get_arch("mixtral-8x7b")
    base = configs.get_parallel("mixtral-8x7b").with_(
        data=1, tp=1, remat="full", schedule="gpipe")
    for dname, layers, pipe, batch, m, lr in RUNS:
        arch = dataclasses.replace(full, n_layers=layers)
        rec = {"arch": arch.name, "n_layers": layers, "pipe": pipe,
               "seq": SEQ, "batch": batch, "n_micro": m, "dtype": dname,
               "lr": lr}
        ocfg = OptimizerConfig(lr=lr, warmup_steps=0, min_lr_ratio=1.0,
                               dynamic_loss_scale=True)
        try:
            res = train(arch, base.with_(pipe=pipe, n_micro=m), seq_len=SEQ,
                        batch=batch, steps=STEPS, device="cuda",
                        dtype=getattr(torch, dname), seed=0, ocfg=ocfg,
                        fixed_batch=True)
            hist = res["history"]
            rec.update(losses=[r["loss"] for r in hist],
                       grad_norms=[r["grad_norm"] for r in hist],
                       skipped=[r["skipped"] for r in hist],
                       step_ms=[r["step_s"] * 1e3 for r in hist],
                       peak_gib=res["peak_mem_bytes"] / 2 ** 30)
            del res
        except torch.cuda.OutOfMemoryError as e:
            rec["error"] = f"out of memory: {str(e)[:200]}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
