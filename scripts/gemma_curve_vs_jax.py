"""gemma-2b's AdamW loss curve through the JAX reference and through the
port, side by side, on the CPU (ROADMAP fault C4).

Full width (d 2048, GeGLU over d_ff 16,384, MQA 8:1 at head_dim 256, the
tied 256,000-row embedding and its sqrt(d) scale) cut to ``--layers``
layers, fp32, seq 128, batch 4, m 2, one fixed batch of seeded numpy
tokens, 5 steps of AdamW with
``chip_smoke.py``'s ``train`` settings (constant lr, no warmup, dynamic
loss scale).  The reference's ``model.init(PRNGKey(0))`` weights move
across with ``interop.params_from_jax``; the JAX side runs the sequential
oracle (the stage chain per micro-batch at pipe 1) and its ``optim.apply``,
the port ``launch.steps.build_train_step`` at pipe 2 (gpipe).  Prints
one JSON line with both curves and their largest relative gap.

    PYTHONPATH=src python scripts/gemma_curve_vs_jax.py [--layers 2]

Needs both packages (jax and torch) and ~25 GB of host memory at 2 layers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.core.pipeline import TickCtx as JTickCtx
from repro.models.lm import LMModel as JLMModel
from repro.optim import optimizers as joptim

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.interop import params_from_jax
from repro_torch.launch import steps
from repro_torch.models.lm import LMModel
from repro_torch.optim import optimizers as optim

# chip_smoke.py's train phase: AdamW at a constant lr, no warmup
OCFG = dict(lr=5e-4, warmup_steps=0, min_lr_ratio=1.0,
            dynamic_loss_scale=True)
TOL = dict(rtol=5e-4, atol=5e-5)        # tests/test_oracle.py's fp32 TOL
ARCH, SEQ, BATCH, N_MICRO, PIPE, STEPS = "gemma-2b", 128, 4, 2, 2, 5


def jax_oracle_loss(model, m):
    """The stage chain per micro-batch at pipe 1, mean of the micro losses
    (``tests/test_oracle.py``'s ``oracle_loss_fn`` for an LM)."""
    stage_apply = model.make_stage_apply(model.consts())

    def loss_fn(params, batch):
        fresh = model.embed_inputs(params["embed"], batch)
        fresh_mb = jax.tree.map(
            lambda a: a.reshape((m, a.shape[0] // m) + a.shape[1:]), fresh)
        labels = batch["labels"].reshape((m, -1) + batch["labels"].shape[1:])
        hp = {"head": params["head"], "embed": params["embed"]}
        total = jnp.zeros((), jnp.float32)
        for i in range(m):
            fresh_i = jax.tree.map(lambda a: a[i], fresh_mb)
            carry = {"h": jnp.zeros_like(fresh_i["h"])}
            for s in range(model.n_stages):
                ctx = JTickCtx(stage=jnp.int32(s), micro=jnp.int32(i),
                               valid=jnp.asarray(True), t=jnp.int32(0),
                               fresh=fresh_i, n_stages=model.n_stages,
                               n_micro=m)
                p_s = jax.tree.map(lambda a: a[s], params["stages"])
                carry, _, _ = stage_apply(p_s, carry, {}, {}, ctx)
            total = total + model.head_loss(hp, carry["h"], labels[i])
        return total / m
    return loss_fn


def jax_curve(layers, batch):
    arch = dataclasses.replace(jconfigs.get_arch(ARCH), n_layers=layers)
    pcfg = jconfigs.smoke_parallel(ARCH).with_(n_micro=N_MICRO)
    model = JLMModel(arch, pcfg, dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    ocfg = joptim.OptimizerConfig(**OCFG)
    loss_fn = jax_oracle_loss(model, N_MICRO)

    @jax.jit
    def step(p, o, b):
        scaled, g = jax.value_and_grad(
            lambda p_, b_: loss_fn(p_, b_) * o.scale)(p, b)
        p2, o2, met = joptim.apply(ocfg, o, p, g, loss=scaled)
        return p2, o2, scaled / o.scale, met["grad_norm"]

    host = jax.device_get(params)
    jbatch = jax.tree.map(jnp.asarray, batch)
    p, o, curve, norms = params, joptim.init(ocfg, params), [], []
    for _ in range(STEPS):
        p, o, loss, gn = step(p, o, jbatch)
        curve.append(float(loss))
        norms.append(float(gn))
    return host, curve, norms


def port_curve(layers, batch, host_params):
    arch = dataclasses.replace(configs.get_arch(ARCH), n_layers=layers)
    pcfg = configs.get_parallel(ARCH).with_(
        pipe=PIPE, tp=1, data=1, n_micro=N_MICRO, schedule="gpipe",
        remat="full")
    model = LMModel(arch, pcfg, dtype=torch.float32, device="cpu")
    params = params_from_jax(host_params, arch=arch, src_pipe=1, pcfg=pcfg,
                             device="cpu")
    ocfg = optim.OptimizerConfig(**OCFG)
    seq = batch["tokens"].shape[1]
    step = steps.build_train_step(
        model, pcfg, "cpu",
        ShapeConfig("t", seq, batch["tokens"].shape[0], "train"), ocfg)
    opt = optim.init(ocfg, params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    curve, norms = [], []
    for _ in range(STEPS):
        params, opt, met = step(params, opt, tb)
        curve.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return curve, norms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args()
    vocab = configs.get_arch(ARCH).vocab
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")}
    t0 = time.perf_counter()
    host, jcurve, jnorms = jax_curve(args.layers, batch)
    t1 = time.perf_counter()
    pcurve, pnorms = port_curve(args.layers, batch, host)
    t2 = time.perf_counter()
    gap = [abs(a - b) / abs(b) for a, b in zip(pcurve, jcurve)]
    agree = bool(np.allclose(pcurve, jcurve, **TOL))
    print(json.dumps({
        "arch": ARCH, "layers": args.layers, "seq": SEQ, "batch": BATCH,
        "n_micro": N_MICRO, "pipe": PIPE, "dtype": "float32",
        "optimizer": OCFG,
        "jax_losses": jcurve, "port_losses": pcurve,
        "jax_grad_norms": jnorms, "port_grad_norms": pnorms,
        "rel_gap": gap, "agree_within_tol": agree, "tol": TOL,
        "jax_s": t1 - t0, "port_s": t2 - t1}))


if __name__ == "__main__":
    main()
