"""Serving entry point: batched prefill + pipelined greedy decode loop.

Counterpart of :mod:`repro.launch.serve`.  Both phases run the forward-only
GPipe clock-cycle plan through ``pipeline_call``; the resident caches (ring
KV caches, or RWKV-6 states) are read and updated on each stage's forward
ticks, per micro-batch slot.  Every stage runs on the one card given by
``--device`` (the default ``cuda``; ``cpu`` runs the plain versions of the
kernels), in this process or, with ``--nproc N``, one rank of the
``(data, pipe, tp)`` mesh in each of N spawned processes joined over gloo
(:mod:`repro_torch.launch.mesh`; ``tp`` from the config, ``--data``
replicas, pipe ``N / (data * tp)``), each holding its own stages' weights
(its ``tp`` blocks) and caches (its kv heads, its replica's slice of the
batch); the last pipe rank samples and sends each token to rank 0, which
embeds it for the next decode step.

    PYTHONPATH=src python -m repro_torch.launch.serve --prompt-len 2048 \\
        --gen 32 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --prompt-len 2048 --gen 32 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
        --prompt-len 2048 --gen 32 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --nproc 4 \\
        --prompt-len 2048 --gen 32 --batch 8

An enc-dec (whisper) prefills ``frames`` (random, the stub frontend's
frame embeddings) with the prompt as ``dec_tokens``, both ``prompt_len``
long, as the reference does.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional

import torch

from repro_torch import configs
from repro_torch.configs.base import ArchConfig, ParallelConfig, ShapeConfig
from repro_torch.core import p2p
from repro_torch.core import stage as stage_lib
from repro_torch.devices import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.launch import mesh, steps
from repro_torch.models.lm import LMModel
from repro_torch.tree import tree_leaves


def _launches() -> Dict[str, int]:
    return {"flash_attention": flash_attention.launches,
            "rmsnorm": rmsnorm.launches, "wkv6": wkv6.launches}


def expected_serve_launches(arch: ArchConfig, pcfg: ParallelConfig, m: int,
                            gen: int) -> Dict[str, Dict[str, int]]:
    """Kernel launches the serving path implies under ``pcfg``, per prefill
    and over the ``gen - 1`` decode steps.

    Every slot of the stage layout runs its layer, an identity-padding slot
    too (gated by its mask; deepseek-7b's 30 layers fill 32 slots at pipe
    16), and decode runs every slot but the encoder layers.  dense, vlm,
    moe, hybrid and encdec: one attention per slot and micro-batch in
    prefill, and one more per decoder layer of an enc-dec (its
    cross-attention); decode attention is plain torch.  RMSNorm, where the
    arch's norm is one: three per slot in prefill (the cache fill
    normalizes again; two for hybrid, whose attention, SSM and cache fill
    share one), one more per cross-attention, and the head's; two per slot
    a decode step (one more per cross-attention) and the head's.
    LayerNorm (whisper) launches no kernel.  ssm: one WKV and one group
    RMSNorm per slot and micro-batch (the block and head norms are
    LayerNorms)."""
    slots = stage_lib.partition_layout(
        arch.n_layers + arch.enc_layers, pcfg.pipe * pcfg.virtual_stages,
        pcfg.partition or None).mask.size
    lm, steps = slots * m, gen - 1
    if arch.family == "ssm":
        return {"prefill": {"flash_attention": 0, "rmsnorm": lm, "wkv6": lm},
                "decode": {"flash_attention": 0, "rmsnorm": steps * lm,
                           "wkv6": steps * lm}}
    cross = arch.n_layers * m if arch.is_encdec else 0
    dec = (slots - arch.enc_layers) * m       # the slots a decode step runs
    rms = int(arch.norm == "rms")
    per_slot = 2 if arch.family == "hybrid" else 3
    return {"prefill": {"flash_attention": lm + cross,
                        "rmsnorm": rms * (per_slot * lm + cross + 1),
                        "wkv6": 0},
            "decode": {"flash_attention": 0,
                       "rmsnorm": rms * steps * (2 * dec + cross + 1),
                       "wkv6": 0}}


VISION_PATCHES = 256      # patch embeddings a vision-stub prompt carries


def prompt_batch(arch: ArchConfig, prompts: torch.Tensor, dtype,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The prefill batch for ``prompts`` [B, S]: ``tokens``, or an
    enc-dec's ``frames`` (N(0, 1) x 0.1 from ``generator``, [B, S, d]) and
    the prompts as ``dec_tokens``.  A vision-stub arch (pixtral) also gets
    ``patches``: [B, 256, d] in ``dtype``, N(0, 1) from ``generator`` cast
    and then times 0.1, as the reference's serve makes them."""
    B, S = prompts.shape
    if arch.frontend == "vision_stub":
        patches = torch.randn(B, VISION_PATCHES, arch.d_model,
                              generator=generator, device=prompts.device)
        return {"tokens": prompts, "patches": patches.to(dtype) * 0.1}
    if not arch.is_encdec:
        return {"tokens": prompts}
    frames = torch.randn(B, S, arch.d_model, generator=generator,
                         device=prompts.device) * 0.1
    return {"frames": frames.to(dtype), "dec_tokens": prompts}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _add_hops(total: Dict[str, Dict[str, float]], hops) -> None:
    for c, rec in hops.items():
        for k, v in rec.items():
            total[c][k] += v


def serve(arch: ArchConfig, pcfg: ParallelConfig, *, prompt_len: int,
          gen: int, batch: int, device="cuda", dtype=torch.bfloat16,
          seed: int = 0, temperature: float = 0.0,
          mesh_view: Optional[mesh.MeshView] = None) -> Dict[str, Any]:
    """Prefill a random prompt batch, then decode ``gen - 1`` more tokens.

    Weights come from ``seed``, prompts (and an enc-dec's frames,
    :func:`prompt_batch`) from ``seed + 1``.  Returns the
    generated tokens, the last logits and the timings; ``launches`` holds
    the kernel launches of the prefill and of all decode steps.

    On a mesh (``mesh_view``, :func:`repro_torch.launch.mesh.
    init_mesh_groups`, or a pipe group's, :func:`~repro_torch.launch.mesh.
    init_pipe_group`) this process serves its rank's blocks on
    ``mesh_view.device`` (``device`` is ignored): its pipe rank's stages,
    the weights joined over the FSDP axes once, its ``tp`` blocks kept,
    its kv heads' caches, and its replica's rows of the prompts.  Every
    rank draws the same prompts, so the last pipe rank's sampler state is
    one process's; pipe rank 0 embeds, the last samples and sends each
    token to pipe rank 0 (the ``token`` hop class).  ``tokens`` (the
    replica's), ``logits`` and the timings are the last pipe rank's (None
    elsewhere, but the timings: each rank's own, the clocks started
    together); ``launches``, ``cache_bytes``, ``hops`` (per payload class
    over the prefill and every decode step), ``park`` (each plan's
    high-water) and ``collectives`` are this rank's, and every rank gets
    ``ranks``: per rank of the world those, its peak memory on a card,
    and its tokens."""
    world = mesh_view
    group = None
    if world is not None and world.pipe.size > 1:
        group = world.pipe
    dev = resolve_device(device) if world is None else world.device
    rank = None if group is None else group.rank
    first = group is None or group.first
    last = group is None or group.last
    max_len = prompt_len + gen
    pshape = ShapeConfig("prefill", prompt_len, batch, "prefill")
    dshape = ShapeConfig("decode", max_len, batch, "decode")
    pcfg = pcfg.with_(n_micro=configs.derive_n_micro(pshape, pcfg))
    model = LMModel(arch, pcfg, dtype=dtype, device=dev, mesh=mesh_view)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    if mesh_view is not None:
        params = model.gather_fsdp(params)
    park_p: Dict[str, Any] = {}
    park_d: Dict[str, Any] = {}
    prefill = steps.build_prefill_step(model, pcfg, model.stage_devices,
                                       pshape, park_info=park_p)
    decode = steps.build_serve_step(model, pcfg, model.stage_devices, dshape,
                                    park_info=park_d)
    cache = model.init_cache(dshape, pcfg.n_micro, filled=False, rank=rank)
    tok_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    prompts = torch.randint(0, arch.vocab, (batch, prompt_len),
                            generator=tok_gen, device=dev)
    pbatch = prompt_batch(arch, prompts, dtype, tok_gen)
    if mesh_view is not None:
        n = batch // mesh_view.replicas
        lo = mesh_view.replica * n
        pbatch = {k: v[lo:lo + n] for k, v in pbatch.items()}
    hop = None if group is None else p2p.P2PHop(group)
    hops = {c: {"hops": 0, "bytes": 0, "wait_s": 0.0} for c in p2p.CLASSES}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if world is not None:
        import torch.distributed as dist
        _sync(dev)
        dist.barrier()                           # start the clocks together

    l0 = _launches()
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, pbatch if first else None)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    l1 = _launches()
    if group is not None:
        _add_hops(hops, park_p["hops"])

    def pick(lg):
        if temperature > 0:
            probs = torch.softmax(lg[:, 0].float() / temperature, -1)
            return torch.multinomial(probs, 1, generator=tok_gen)
        return torch.argmax(lg, -1)

    tokens = pick(logits) if last else None
    generated = [tokens]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        if hop is not None:            # the last rank's token to rank 0
            if last:
                hop.send_tree("tok", 0, tokens)
            elif first:
                tokens = hop.recv_tree("tok", group.size - 1)[1]
        logits, cache = decode(params, cache, tokens if first else None)
        if group is not None:
            _add_hops(hops, park_d["hops"])
        if last:
            tokens = pick(logits)
            generated.append(tokens)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    l2 = _launches()
    if hop is not None:
        hop.finish()
        _add_hops(hops, hop.stats)
    out = {
        "tokens": torch.cat(generated, 1).cpu().numpy() if last else None,
        "logits": logits,
        "n_micro": pcfg.n_micro,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": (gen - 1) * batch / max(t_decode, 1e-9),
        "launches": {
            "prefill": {k: l1[k] - l0[k] for k in l0},
            "decode": {k: l2[k] - l1[k] for k in l0},
        },
        "cache_bytes": sum(a.nbytes for a in tree_leaves(cache)),
    }
    if dev.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    if mesh_view is not None:
        out["collectives"] = mesh_view.stats()
    if world is not None:
        import torch.distributed as dist
        out["hops"] = hops
        out["park"] = {"prefill": dict(park_p, hops=None),
                       "decode": dict(park_d, hops=None)}
        mine = {k: out[k] for k in ("launches", "cache_bytes", "hops",
                                    "park", "prefill_s", "decode_s",
                                    "decode_tok_per_s", "peak_mem_bytes",
                                    "tokens", "collectives") if k in out}
        out["ranks"] = [None] * dist.get_world_size()
        dist.all_gather_object(out["ranks"], mine)
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
    ap.add_argument("--nproc", type=int, default=0,
                    help="run each rank of the (data, pipe, tp) mesh in its "
                         "own process, over gloo: the world size (pipe = "
                         "nproc / (data * tp))")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel replicas of the --nproc mesh")
    args = ap.parse_args()

    from repro_torch.launch.train import mesh_config
    arch, pcfg, dtype = mesh_config(args)
    dev = resolve_device(args.device)
    job = dict(arch=arch, pcfg=pcfg, prompt_len=args.prompt_len,
               gen=args.gen, batch=args.batch, dtype=dtype, seed=args.seed,
               temperature=args.temperature)
    if not args.nproc:
        _report(serve(device=dev, **job), dev, args)
        return
    if dev.type == "cuda":        # once here, not once in every rank
        from repro_torch.kernels import build
        build.build_all()
    # no overall deadline: a hang fails at the group's wait timeout, a
    # rank that raises fails the group
    mesh.spawn(_rank_main, args.nproc, (args.device, job, args),
               timeout_s=None)


def _rank_main(rank: int, nproc: int, init_method: str, device: str,
               job: Dict[str, Any], args) -> None:
    """One rank of ``--nproc``: join the mesh, serve, and on rank 0 print
    the world's records."""
    view = mesh.init_mesh_groups(rank, nproc, init_method, job["pcfg"],
                                 device=device)
    try:
        res = serve(mesh_view=view, **job)
        _check_finite(res)
        if rank == 0:
            _report(res, view.device, args)
    finally:
        mesh.destroy_pipe_group(view.pipe)


def _report(res: Dict[str, Any], dev: torch.device, args) -> None:
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    ranks = res.get("ranks")
    procs = f" in {len(ranks)} processes (gloo)" if ranks else ""
    last = ranks[-1] if ranks else res
    print(f"[serve] {args.arch} m={res['n_micro']} on {where}{procs}: "
          f"prefill {args.batch}x{args.prompt_len} in "
          f"{last['prefill_s'] * 1e3:.1f} ms")
    print(f"[serve] decoded {args.gen - 1} steps x {args.batch} seqs in "
          f"{last['decode_s']:.3f}s ({last['decode_tok_per_s']:.1f} tok/s)")
    if ranks:
        for r, rec in enumerate(ranks):
            peak = (f"peak memory {rec['peak_mem_bytes'] / 2**30:.2f} GiB, "
                    if "peak_mem_bytes" in rec else "")
            hops = {c: v["hops"] for c, v in rec["hops"].items()
                    if v["hops"]}
            print(f"[serve] rank {r}: {peak}cache "
                  f"{rec['cache_bytes'] / 2**30:.3f} GiB, launches "
                  f"{json.dumps(rec['launches'])}, hops {json.dumps(hops)}")
    else:
        if "peak_mem_bytes" in res:
            print(f"[serve] peak memory {res['peak_mem_bytes'] / 2**30:.2f} "
                  "GiB")
        print(f"[serve] kernel launches {res['launches']}")
    print(f"[serve] sample tokens: {last['tokens'][0][:12].tolist()}")
    _check_finite(res)


def _check_finite(res: Dict[str, Any]) -> None:
    """The logits are finite where they land (the last rank)."""
    if res["logits"] is not None \
            and not bool(torch.isfinite(res["logits"]).all()):
        raise RuntimeError("non-finite logits")


if __name__ == "__main__":
    main()
