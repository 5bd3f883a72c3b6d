"""Serving entry point: batched prefill + pipelined greedy decode loop.

Counterpart of :mod:`repro.launch.serve`.  Both phases run the forward-only
GPipe clock-cycle plan through ``pipeline_call``; the resident caches (ring
KV caches, or RWKV-6 states) are read and updated on each stage's forward
ticks, per micro-batch slot.  The full configs run with ``data=1`` and
``tp=1`` (the port has no tensor parallelism): all pipeline stages on the
one card given by ``--device`` (the default ``cuda``; ``cpu`` runs the plain
versions of the kernels).

    PYTHONPATH=src python -m repro_torch.launch.serve --prompt-len 2048 \\
        --gen 32 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --prompt-len 2048 --gen 32 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
        --prompt-len 2048 --gen 32 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

An enc-dec (whisper) prefills ``frames`` (random, the stub frontend's
frame embeddings) with the prompt as ``dec_tokens``, both ``prompt_len``
long, as the reference does.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import torch

from repro_torch import configs
from repro_torch.configs.base import ArchConfig, ParallelConfig, ShapeConfig
from repro_torch.devices import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.launch import steps
from repro_torch.models.lm import LMModel


def _launches() -> Dict[str, int]:
    return {"flash_attention": flash_attention.launches,
            "rmsnorm": rmsnorm.launches, "wkv6": wkv6.launches}


def expected_serve_launches(arch: ArchConfig, m: int, gen: int
                            ) -> Dict[str, Dict[str, int]]:
    """Kernel launches the serving path implies, per prefill and over the
    ``gen - 1`` decode steps, for a layout without identity padding.

    dense and encdec: one attention per layer and micro-batch in prefill,
    and one more per decoder layer of an enc-dec (its cross-attention);
    decode attention is plain torch.  RMSNorm, where the arch's norm is
    one: three per layer in prefill (the cache fill normalizes again), one
    more per cross-attention, and the head's; two per layer a decode step
    (one more per cross-attention) and the head's.  LayerNorm (whisper)
    launches no kernel.  ssm: one WKV and one group RMSNorm per layer and
    micro-batch (the block and head norms are LayerNorms)."""
    layers = arch.n_layers + arch.enc_layers
    lm, steps = layers * m, gen - 1
    if arch.family == "ssm":
        return {"prefill": {"flash_attention": 0, "rmsnorm": lm, "wkv6": lm},
                "decode": {"flash_attention": 0, "rmsnorm": steps * lm,
                           "wkv6": steps * lm}}
    cross = arch.n_layers * m if arch.is_encdec else 0
    dec = arch.n_layers * m                  # layers a decode step runs
    rms = int(arch.norm == "rms")
    return {"prefill": {"flash_attention": lm + cross,
                        "rmsnorm": rms * (3 * lm + cross + 1), "wkv6": 0},
            "decode": {"flash_attention": 0,
                       "rmsnorm": rms * steps * (2 * dec + cross + 1),
                       "wkv6": 0}}


def prompt_batch(arch: ArchConfig, prompts: torch.Tensor, dtype,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The prefill batch for ``prompts`` [B, S]: ``tokens``, or an
    enc-dec's ``frames`` (N(0, 1) x 0.1 from ``generator``, [B, S, d]) and
    the prompts as ``dec_tokens``."""
    if not arch.is_encdec:
        return {"tokens": prompts}
    B, S = prompts.shape
    frames = torch.randn(B, S, arch.d_model, generator=generator,
                         device=prompts.device) * 0.1
    return {"frames": frames.to(dtype), "dec_tokens": prompts}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: ArchConfig, pcfg: ParallelConfig, *, prompt_len: int,
          gen: int, batch: int, device="cuda", dtype=torch.bfloat16,
          seed: int = 0, temperature: float = 0.0) -> Dict[str, Any]:
    """Prefill a random prompt batch, then decode ``gen - 1`` more tokens.

    Weights come from ``seed``, prompts (and an enc-dec's frames,
    :func:`prompt_batch`) from ``seed + 1``.  Returns the
    generated tokens, the last logits and the timings; ``launches`` holds
    the kernel launches of the prefill and of all decode steps."""
    dev = resolve_device(device)
    max_len = prompt_len + gen
    pshape = ShapeConfig("prefill", prompt_len, batch, "prefill")
    dshape = ShapeConfig("decode", max_len, batch, "decode")
    pcfg = pcfg.with_(n_micro=configs.derive_n_micro(pshape, pcfg))
    model = LMModel(arch, pcfg, dtype=dtype, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    prefill = steps.build_prefill_step(model, pcfg, model.stage_devices,
                                       pshape)
    decode = steps.build_serve_step(model, pcfg, model.stage_devices, dshape)
    cache = model.init_cache(dshape, pcfg.n_micro, filled=False)
    tok_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    prompts = torch.randint(0, arch.vocab, (batch, prompt_len),
                            generator=tok_gen, device=dev)
    pbatch = prompt_batch(arch, prompts, dtype, tok_gen)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    l0 = _launches()
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, pbatch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    l1 = _launches()

    def pick(lg):
        if temperature > 0:
            probs = torch.softmax(lg[:, 0].float() / temperature, -1)
            return torch.multinomial(probs, 1, generator=tok_gen)
        return torch.argmax(lg, -1)

    tokens = pick(logits)
    generated = [tokens]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = decode(params, cache, tokens)
        tokens = pick(logits)
        generated.append(tokens)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    l2 = _launches()
    out = {
        "tokens": torch.cat(generated, 1).cpu().numpy(),
        "logits": logits,
        "n_micro": pcfg.n_micro,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": (gen - 1) * batch / max(t_decode, 1e-9),
        "launches": {
            "prefill": {k: l1[k] - l0[k] for k in l0},
            "decode": {k: l2[k] - l1[k] for k in l0},
        },
    }
    if dev.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if args.smoke:
        arch = configs.smoke_arch(args.arch)
        pcfg = configs.smoke_parallel(args.arch)
        dtype = torch.float32
    else:
        arch = configs.get_arch(args.arch)
        pcfg = configs.get_parallel(args.arch).with_(data=1, tp=1)
        dtype = torch.bfloat16
    dev = resolve_device(args.device)
    res = serve(arch, pcfg, prompt_len=args.prompt_len, gen=args.gen,
                batch=args.batch, device=dev, dtype=dtype, seed=args.seed,
                temperature=args.temperature)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"[serve] {arch.name} pipe={pcfg.pipe} m={res['n_micro']} on "
          f"{where}: prefill {args.batch}x{args.prompt_len} in "
          f"{res['prefill_s'] * 1e3:.1f} ms")
    print(f"[serve] decoded {args.gen - 1} steps x {args.batch} seqs in "
          f"{res['decode_s']:.3f}s ({res['decode_tok_per_s']:.1f} tok/s)")
    if "peak_mem_bytes" in res:
        print(f"[serve] peak memory {res['peak_mem_bytes'] / 2**30:.2f} GiB")
    print(f"[serve] kernel launches {res['launches']}")
    print(f"[serve] sample tokens: {res['tokens'][0][:12].tolist()}")
    if not bool(torch.isfinite(res["logits"]).all()):
        raise RuntimeError("non-finite logits")


if __name__ == "__main__":
    main()
