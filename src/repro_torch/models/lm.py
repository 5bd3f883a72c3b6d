"""LM assembly: params, stacked stages, embed / head, caches.

Counterpart of :mod:`repro.models.lm`, for every family of the
reference.  Blocks are stacked ``[n_stages, L_per_stage]`` for the pipeline
(identity-padded per :func:`repro_torch.core.stage.partition_layout`);
embed and head run outside the pipeline.  Parameters are nested dicts of
tensors with the reference's tree layout, so weights move across from JAX
leaf for leaf.

Encoder-decoder (whisper): encoder layers fill the leading stages, decoder
layers the trailing ones; the per-layer constants carry ``causal`` /
``cross`` / ``dec_active`` / ``is_enc_last`` / ``is_dec_first`` flags as
host scalars, and the encoder output reaches every decoder stage through
one skip with a destination per decoder stage (paper §3.3.1, portals).

On a mesh (``mesh``, a :class:`repro_torch.launch.mesh.MeshView`) a model
holds this rank's block of every leaf (:meth:`LMModel.shard_params`, the
placement of :mod:`repro_torch.launch.sharding`).  The FSDP axes are
joined outside the blocks: by the train step, once a step, or at each
stage application from memory-free stand-ins (:meth:`LMModel.bind_fsdp`).
The ``tp`` axis stays split through the blocks (``arch_c`` counts this
rank's heads); a leaf whose split does not fall on head boundaries is
joined for compute (:meth:`LMModel._tp_local`), and the head's vocab lies
over ``tp`` with a vocab-parallel cross-entropy.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ParallelConfig, ShapeConfig
from repro_torch.core import checkpointing
from repro_torch.core import stage as stage_lib
from repro_torch.core.pipeline import TickCtx
from repro_torch.core.skip import SkipSpec
from repro_torch.devices import DeviceLike, resolve_device, stage_devices
from repro_torch.launch import sharding
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.tree import tree_map


FSDP_GATHER = "fsdp_gather"        # collective class of the FSDP joins


class _Regather(torch.autograd.Function):
    """A stage leaf joined over its FSDP axis at one application (ZeRO-3):
    forward the join of the rank's block (``shard``), which ``standin``
    (a memory-free ``[...]`` of the whole leaf's shape) stands for; its
    cotangent goes to the stand-in whole, so the step accumulates the
    gradient of the joined leaf exactly as with the weights joined once a
    step."""

    @staticmethod
    def forward(ctx, standin, shard, axis, dim):
        return axis.cat(shard.contiguous(), dim, FSDP_GATHER)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


# positions per head-loss chunk: the reference's measured sweet spot
HEAD_LOSS_CHUNK = 512


def head_loss_chunk(seq: int) -> int:
    """Positions per head-loss chunk: ``HEAD_LOSS_CHUNK``, or the largest
    length below it that divides ``seq``."""
    c = min(HEAD_LOSS_CHUNK, seq)
    while seq % c:
        c -= 1
    return c


def _embed_lookup(table, tokens, dtype):
    """Token-embedding gather through fp32, cast to ``dtype``.

    The reference upcasts the table before its gather (a workaround for an
    XLA CPU pass); gathering the rows and then upcasting gives the same
    values without an fp32 copy of the whole table on every call."""
    rows = table.index_select(0, tokens.reshape(-1)).float()
    return rows.reshape(tuple(tokens.shape) + (table.shape[1],)).to(dtype)


def sinusoidal(positions, d: int, dtype=torch.float32):
    """Absolute sinusoidal positions [..., d]: ``[sin, cos]`` of
    ``pos * exp(-i / (d/2 - 1) * log 10000)``, computed in fp32 and cast to
    ``dtype`` (reference ``lm.sinusoidal``)."""
    half = d // 2
    freq = torch.exp(-torch.arange(half, dtype=torch.float32,
                                   device=positions.device)
                     / (half - 1) * math.log(10000.0))
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


@dataclass
class LMModel:
    arch: ArchConfig
    pcfg: ParallelConfig
    dtype: torch.dtype = torch.bfloat16
    device: DeviceLike = "cuda"
    mesh: Any = None                  # a MeshView: this rank's blocks

    def __post_init__(self):
        a = self.arch
        self.device = resolve_device(self.device)
        self.arch_c = a                 # what the blocks compute with
        self.tp = self.lmesh = self._fsdp = None
        self.specs: Optional[Dict[str, Any]] = None
        self.fsdp_specs: Optional[Dict[str, Any]] = None
        if self.mesh is not None:
            self._init_mesh()
        self.total_layers = a.n_layers + a.enc_layers
        self.n_stages = self.pcfg.pipe * self.pcfg.virtual_stages
        self.layout = stage_lib.partition_layout(
            self.total_layers, self.n_stages, self.pcfg.partition or None)
        self.L_per_stage = self.layout.L_per_stage
        self.layer_mask = self.layout.mask          # np [n_stages, L]
        (self.block_init, self.block_apply, self.block_decode,
         self.block_cache_proto, self.block_prefill) = B.FAMILIES[a.family]
        # encoder / decoder stage split (whisper): encoder layers come first
        if a.is_encdec:
            self.enc_last_stage = self.layout.stage_of(a.enc_layers - 1)
            self.dec_first_stage = (self.layout.stage_of(a.enc_layers)
                                    if a.enc_layers < self.total_layers
                                    else self.n_stages)
        else:
            self.enc_last_stage = self.dec_first_stage = -1

    def _init_mesh(self):
        """The tp splits (a sub-module splits where its heads, hidden
        columns or experts divide by ``tp``; else it runs whole on every
        rank), ``arch_c`` and the blocks' :class:`layers.LayerMesh`."""
        a, m = self.arch, self.mesh
        T = m.shape["tp"]
        tp = m.axes["tp"] if T > 1 else None
        if tp is not None and a.family in ("ssm", "hybrid"):
            raise NotImplementedError(
                f"tp={T} for the {a.family} family ({a.name}): its heads "
                "over tp are not ported yet (ROADMAP A9b); run it at tp=1")
        at = a.attn
        self.split = {"attn": at is not None and at.n_heads % T == 0,
                      "mlp": a.d_ff % T == 0,
                      "moe": a.moe is not None and a.moe.n_experts % T == 0}
        if tp is not None and self.split["attn"]:
            nq = at.n_heads // T
            nkv = at.n_kv_heads // T if at.n_kv_heads % T == 0 else nq
            self.arch_c = dataclasses.replace(a, attn=dataclasses.replace(
                at, n_heads=nq, n_kv_heads=nkv))
        self.tp = tp
        on = {k: tp if (tp is not None and v) else None
              for k, v in self.split.items()}
        self.lmesh = L.LayerMesh(attn=on["attn"], mlp=on["mlp"],
                                 moe=on["moe"], replicas=m.replicas)

    @property
    def stage_devices(self) -> List[torch.device]:
        """One device per stage (torchgpipe placement); all this model's."""
        return stage_devices(self.device, self.n_stages)

    # ------------------------------------------------------------------ params
    def init(self, generator: torch.Generator, *, rank: Optional[int] = None):
        """Random weights at the reference's scales, drawn from ``generator``.

        With ``rank`` (a pipe rank), only that rank's share: ``stages``
        stacked ``[n_chunks, L_per_stage, ...]`` for its global stages
        ``rank, rank + pipe, ...``, ``embed`` on rank 0 (and on the last
        rank too when the head is tied to it) and ``head`` on the last
        rank.  Every layer is still drawn, in order, and dropped unless
        kept, so each kept tensor is bitwise what ``init`` without
        ``rank`` gives it.  On a mesh, this rank's blocks of its pipe
        rank's share (:meth:`shard_params`; ``rank`` is the mesh's)."""
        if self.mesh is not None:
            pipe = self.mesh.pipe
            return self.shard_params(self._init_share(
                generator, pipe.rank if pipe.size > 1 else None))
        return self._init_share(generator, rank)

    def _init_share(self, generator: torch.Generator, rank: Optional[int]):
        a, dev = self.arch, self.device
        if rank is None:
            stages = stage_lib.place_layers(
                (self.block_init(generator, a, self.dtype, dev)
                 for _ in range(self.total_layers)), self.layout.slot_layer)
        else:
            stages = self._init_rank_stages(generator, rank)
        emb = {"tok": (L.randn(generator, (a.vocab, a.d_model), dev)
                       * a.d_model ** -0.5).to(self.dtype)}
        head = {"norm": L.norm_init(a.d_model, a.norm, self.dtype, dev)}
        if not a.tie_embeddings:
            head["w"] = (L.randn(generator, (a.d_model, a.vocab), dev)
                         * a.d_model ** -0.5).to(self.dtype)
        out = {"embed": emb, "stages": stages, "head": head}
        if rank is None:
            return out
        return {k: out[k] for k in self.rank_keys(rank)}

    # ------------------------------------------------------------- placement
    def param_specs(self, share) -> Dict[str, Any]:
        """The placement of a pipe rank's ``share`` (or of the whole tree)
        on this model's mesh (:func:`sharding.param_specs`; with
        ``pcfg.fsdp`` off, or one replica, the data axes are dropped:
        every replica holds its weights whole)."""
        specs = sharding.param_specs(share, self.mesh.shape)
        if not self.pcfg.fsdp or self.mesh.replicas == 1:
            specs = tree_map(sharding.drop_fsdp, specs)
        return specs

    def shard_params(self, share):
        """This rank's blocks of a pipe rank's ``share`` (clones: the share
        can be freed); sets :attr:`specs` and :attr:`fsdp_specs` (the
        placement with FSDP on, whose blocks the global norm folds
        whatever ``pcfg.fsdp`` says: ``steps.norm_terms``)."""
        self.specs = self.param_specs(share)
        self.fsdp_specs = sharding.param_specs(share, self.mesh.shape)
        return sharding.shard_tree(share, self.specs, self.mesh.coords,
                                   self.mesh.shape)

    def bind_fsdp(self, shards) -> None:
        """Join the stage weights at each application (ZeRO-3): until the
        next call, the stage tree the executor passes is one of stand-ins
        whose FSDP leaves are joined from ``shards`` (this rank's blocks,
        stacked ``[n_chunks, ...]``) inside every stage application, its
        recompute included, and freed after it.  None unbinds."""
        self._fsdp = shards

    def _stage_compute(self, sp, stage: int):
        """A stage's weights as its blocks compute with them: joined over
        FSDP when bound (:meth:`bind_fsdp`), then over ``tp`` where a split
        misses head boundaries (:meth:`_tp_local`)."""
        if self._fsdp is not None:
            c = stage // self.pcfg.pipe

            def one(standin, shard, spec):
                fg = sharding.fsdp_group(spec)
                if fg is None:
                    return standin           # a whole leaf: the leaf itself
                d, group = fg
                return _Regather.apply(standin, shard[c],
                                       self.mesh.axes[group], d - 1)
            sp = tree_map(one, sp, self._fsdp, self.specs["stages"])
        if self.tp is not None:
            sp = self._tp_local(sp, self.specs["stages"])
        return sp

    def _tp_local(self, tree, specs, path=()):
        """The per-stage tree as this tp rank computes with it.  Where a
        sub-module splits on head boundaries its blocks are the rank's own
        and stay; a whole attention (``n_heads % tp``) joins its blocks,
        whose cotangents every rank then holds whole; a split attention
        whose kv heads do not divide joins ``wk`` / ``wv`` (or takes them
        whole), their cotangents summed over ``tp``, and keeps the kv head
        of each of its query heads; a split MoE joins its router the same
        way."""
        if isinstance(tree, dict):
            return {k: self._tp_local(v, specs[k], path + (k,))
                    for k, v in tree.items()}
        d = sharding.axis_dim(specs, "tp")
        d = None if d is None else d - 1          # the stage tree: no axis 0
        name, tp = path[-1], self.tp
        if "moe" in path and name == "router" and self.split["moe"]:
            return L.tp_gather(tp, tree, d, True)
        if "attn" not in path and "xattn" not in path:
            return tree
        at = self.arch.attn
        if not self.split["attn"]:
            return tree if d is None else L.tp_gather(tp, tree, d, False)
        if name not in ("wk", "wv") or at.n_kv_heads % tp.size == 0:
            return tree
        full = (L.tp_copy(tp, tree) if d is None
                else L.tp_gather(tp, tree, d, True))
        nq, grp = self.arch_c.attn.n_heads, at.n_heads // at.n_kv_heads
        idx = torch.tensor([(tp.rank * nq + h) // grp for h in range(nq)],
                           device=full.device)
        lead = full.shape[:-1]
        return full.reshape(lead + (at.n_kv_heads, at.head_dim)).index_select(
            -2, idx).reshape(lead + (nq * at.head_dim,))

    def gather_fsdp(self, params):
        """``params`` (this rank's blocks) whole over the FSDP axes: the
        serving weights, joined once (the ``tp`` blocks stay)."""
        out = dict(params)
        for k in ("embed", "stages"):
            if k in params:
                out[k] = sharding.gather_stage_weights(params[k],
                                                       self.specs[k],
                                                       self.mesh)
        return out

    def _embed_table(self, emb):
        """The token table whole: joined over ``tp`` where it lies there
        (the FSDP axes are joined by the step)."""
        tok = emb["tok"]
        if self.tp is not None and sharding.axis_dim(
                self.specs["embed"]["tok"], "tp") is not None:
            tok = L.tp_gather(self.tp, tok, 1, False)
        return tok

    def vocab_parallel(self) -> bool:
        """The head's vocab lies over ``tp`` (it divides)."""
        return self.tp is not None and self.arch.vocab % self.tp.size == 0

    def rank_keys(self, rank: int) -> Tuple[str, ...]:
        """The top-level params pipe rank ``rank`` keeps: ``embed`` on rank
        0 (and on the last rank when the head is tied to it), ``stages``,
        and ``head`` on the last rank."""
        last = rank == self.pcfg.pipe - 1
        return (("embed",) if rank == 0 or (last and self.arch.tie_embeddings)
                else ()) + ("stages",) + (("head",) if last else ())

    def replicas(self, rank: int) -> Tuple[str, ...]:
        """The keys of ``rank``'s share that copy another rank's (the last
        rank's tied embedding, rank 0's): counted once by the optimizer's
        global norm."""
        return (("embed",) if rank != 0 and "embed" in self.rank_keys(rank)
                else ())

    def rank_share(self, params, rank: int):
        """Pipe rank ``rank``'s share of a whole ``params`` tree (what
        ``init(..., rank=rank)`` draws): its stages' rows, stacked in
        chunk order, and the embedding and head where that rank keeps
        them.  The rows are views of ``params``."""
        R = self.pcfg.pipe
        share = dict(params,
                     stages=tree_map(lambda a: a[rank::R], params["stages"]))
        return {k: share[k] for k in self.rank_keys(rank)}

    def _init_rank_stages(self, generator: torch.Generator, rank: int):
        """Draw every layer in order and place those of ``rank``'s stages
        (``slot_layer[rank::pipe]``) as :func:`stage_lib.place_layers`
        places all of them."""
        slots = self.layout.slot_layer[rank::self.pcfg.pipe]
        wanted = np.unique(slots[slots >= 0])          # global, ascending
        kept = []
        for li in range(self.total_layers):
            p = self.block_init(generator, self.arch, self.dtype, self.device)
            if li in wanted:
                kept.append(p)
        local = np.where(slots >= 0, np.searchsorted(wanted, slots), -1)
        return stage_lib.place_layers(kept or [p], local)   # [p]: all padding

    # ------------------------------------------------------------ layer consts
    def consts(self) -> Dict[str, np.ndarray]:
        """Per-layer constants on the [n_stages, L_per_stage] slot grid.

        Host arrays: the port reads one scalar per layer.  Padding slots
        take the identity defaults (mask 0, window 0, causal 1, cross 0,
        dec_active 1), as in the reference; ``window`` is
        :func:`B.layer_windows`'s."""
        a = self.arch
        tl = self.total_layers
        sc = self.layout.scatter
        c = {"mask": np.asarray(self.layer_mask, np.float32),
             "window": sc(B.layer_windows(a, tl), 0)}
        if a.is_encdec:
            causal = np.ones(tl, np.int32)
            cross = np.zeros(tl, np.float32)
            dec_active = np.ones(tl, np.float32)
            is_enc_last = np.zeros(tl, np.float32)
            is_dec_first = np.zeros(tl, np.float32)
            causal[:a.enc_layers] = 0
            cross[a.enc_layers:] = 1.0
            dec_active[:a.enc_layers] = 0.0
            is_enc_last[a.enc_layers - 1] = 1.0
            if a.enc_layers < tl:
                is_dec_first[a.enc_layers] = 1.0
            c.update(causal=sc(causal, 1), cross=sc(cross, 0.0),
                     dec_active=sc(dec_active, 1.0),
                     is_enc_last=sc(is_enc_last, 0.0),
                     is_dec_first=sc(is_dec_first, 0.0))
        return c

    def _layer_consts(self, consts, stage: int, slot: int) -> Dict[str, Any]:
        c = {k: v[stage, slot].item() for k, v in consts.items()}
        if self.lmesh is not None:
            c["mesh"] = self.lmesh
        return c

    # ------------------------------------------------------------------ skips
    def skips(self) -> List[SkipSpec]:
        """Whisper: the encoder memory from the last encoder stage to every
        decoder stage past it, and the decoder's input embeddings from
        stage 0 to the first decoder stage.  None where the boundary falls
        inside one stage."""
        if not self.arch.is_encdec:
            return []
        edges = []
        dec_stages = tuple(d for d in range(self.dec_first_stage,
                                            self.n_stages)
                           if d > self.enc_last_stage)
        if dec_stages:
            edges.append(SkipSpec("mem", self.enc_last_stage, dec_stages))
        if self.dec_first_stage > 0:
            edges.append(SkipSpec("dec_in", 0, (self.dec_first_stage,)))
        return edges

    def skip_protos(self, mb: int, S: int):
        """Each skip's value as ``(shape, dtype)``: [mb, S, d_model]."""
        if not self.arch.is_encdec:
            return {}
        proto = ((mb, S, self.arch.d_model), self.dtype)
        return {"mem": proto, "dec_in": proto}

    # ------------------------------------------------------------------ embed
    def _positions(self, n: int):
        return sinusoidal(torch.arange(n, device=self.device),
                          self.arch.d_model, self.dtype)

    def _scaled(self, h):
        """gemma's embedding scale (``arch.embed_scale``), sqrt(d_model) as
        a scalar of the model dtype: 45.25 in bf16 at d 2048."""
        if not self.arch.embed_scale:
            return h
        return h * torch.tensor(self.arch.d_model ** 0.5, dtype=self.dtype,
                                device=h.device)

    def embed_inputs(self, emb, batch) -> Dict[str, torch.Tensor]:
        """batch -> fresh stage-0 input tree [B, ...].  Enc-dec: ``h`` is
        the frames (the stub frontend's embeddings) plus positions,
        ``dec_h`` the decoder tokens' embeddings plus positions.  The vision
        stub (pixtral): a batch's ``patches`` [B, P, d] (precomputed patch
        embeddings) replace the first min(P, S) token rows."""
        a = self.arch
        if a.is_encdec:
            h = batch["frames"].to(self.dtype)
            h = h + self._positions(h.shape[1])[None]
            dec = _embed_lookup(self._embed_table(emb), batch["dec_tokens"],
                                self.dtype)
            dec = dec + self._positions(dec.shape[1])[None]
            return {"h": h, "dec_h": dec}
        h = self._scaled(_embed_lookup(self._embed_table(emb),
                                       batch["tokens"], self.dtype))
        if a.frontend == "vision_stub" and "patches" in batch:
            p = batch["patches"].to(self.dtype)
            n = min(p.shape[1], h.shape[1])
            h = torch.cat([p[:, :n], h[:, n:]], 1)
        return {"h": h}

    def embed_decode(self, emb, tokens, pos: int):
        """Embed one decode token at absolute position ``pos``: RoPE archs
        and the ssm family add no positions here, the others sinusoidal
        ones."""
        a = self.arch
        h = self._scaled(_embed_lookup(self._embed_table(emb), tokens,
                                       self.dtype))
        if a.family != "ssm" and (a.is_encdec
                                  or not (a.attn and a.attn.use_rope)):
            h = h + sinusoidal(torch.tensor([pos], device=h.device),
                               a.d_model, self.dtype)[None]
        return h

    # ------------------------------------------ stage fn (forward / prefill)
    def _stage_skips_out(self, stage: int, mem, dec_emb) -> Dict[str, Any]:
        """The skips ``stage`` is the source of: ``mem`` on the last encoder
        stage, ``dec_in`` (the decoder embeddings it got fresh) on stage 0."""
        out = {}
        for edge in self.skips():
            if edge.src_stage == stage:
                out[edge.name] = mem if edge.name == "mem" else dec_emb
        return out

    def make_stage_apply(self, consts, *, prefill: bool = False):
        """stage_apply for the pipeline runner (forward, or prefill + caches).

        Prefill writes each layer's cache slice for ``ctx.micro`` in place
        (the reference returns an updated copy).  With
        ``pcfg.remat_layers`` each layer of the forward is checkpointed
        on its own as well (nested inside the stage's remat).

        Enc-dec: the stage carries (h, mem, dec_emb).  ``h`` becomes the
        decoder embeddings at the ``is_dec_first`` layer and ``mem``
        latches ``h`` after the ``is_enc_last`` one; across stages ``mem``
        and ``dec_emb`` arrive as the ``mem`` / ``dec_in`` skips, and only
        stage 0 reads ``ctx.fresh``."""
        model, a = self, self.arch_c
        per_layer = "full" if self.pcfg.remat_layers else "none"

        def stage_apply(stage_params, carry, skips_in, resident,
                        ctx: TickCtx):
            stage_params = model._stage_compute(stage_params, ctx.stage)
            first = ctx.stage == 0
            h = ctx.fresh["h"] if first else carry["h"]
            mem: Optional[torch.Tensor] = None
            dec_emb: Optional[torch.Tensor] = None
            if a.is_encdec:
                mem = skips_in.get("mem")
                dec_emb = ctx.fresh["dec_h"] if first else skips_in.get(
                    "dec_in")
            for l in range(model.L_per_stage):
                lp = tree_map(lambda x: x[l], stage_params)
                c = model._layer_consts(consts, ctx.stage, l)
                if c.get("is_dec_first"):
                    h = dec_emb
                if prefill:
                    cache = tree_map(lambda x: x[l, ctx.micro], resident)
                    h, _ = model.block_prefill(lp, h, c, a, cache,
                                               memory=mem)
                else:
                    h = checkpointing.wrap_stage(
                        lambda lp_, h_, m_, c=c: model.block_apply(
                            lp_, h_, c, a, memory=m_), per_layer)(lp, h, mem)
                if c.get("is_enc_last"):
                    mem = h
            skips_out = (model._stage_skips_out(ctx.stage, mem, dec_emb)
                         if a.is_encdec else {})
            return {"h": h}, skips_out, resident

        return stage_apply

    # ------------------------------------------------------ stage fn (decode)
    def make_stage_apply_decode(self, consts):
        """Decode: each layer against its caches.  An encoder layer
        (``dec_active`` 0) is skipped: the reference runs it and keeps the
        old ``h`` and cache."""
        model, a = self, self.arch_c

        def stage_apply(stage_params, carry, skips_in, resident,
                        ctx: TickCtx):
            stage_params = model._stage_compute(stage_params, ctx.stage)
            h = ctx.fresh["h"] if ctx.stage == 0 else carry["h"]   # [mb, 1, D]
            for l in range(model.L_per_stage):
                c = model._layer_consts(consts, ctx.stage, l)
                if not c.get("dec_active", 1.0):
                    continue
                lp = tree_map(lambda x: x[l], stage_params)
                cache = tree_map(lambda x: x[l, ctx.micro], resident)
                h, _ = model.block_decode(lp, h, c, a, cache)
            return {"h": h}, {}, resident

        return stage_apply

    # ------------------------------------------------------------------- head
    def head_logits(self, params, h):
        """Logits [..., V]; with the vocab over ``tp``, every rank's block
        joined (serving)."""
        logits = self._head_logits_local(params, h)
        if self.vocab_parallel():
            logits = self.tp.cat(logits, -1, L.TP_GATHER)
        return logits

    def _head_logits_local(self, params, h):
        """Logits of this rank's vocab block (all of it off ``tp``)."""
        hn = L.norm_apply(params["head"]["norm"], h, self.arch.norm)
        w = params["head"].get("w")
        vp = self.vocab_parallel()
        if w is None:                          # tied embeddings
            tok = self._embed_table(params["embed"])
            w = (self.tp.block(L.tp_copy(self.tp, tok), 0) if vp else tok).T
        return L.tp_copy(self.tp, hn) @ w if vp else hn @ w

    def head_loss(self, params, h, labels):
        """Chunked softmax cross-entropy over the sequence, mean over all
        ``B * S`` positions in fp32 (reference ``LMModel.head_loss``).

        Chunks of :func:`head_loss_chunk` positions, each under
        ``torch.utils.checkpoint``: the forward keeps no chunk's logits and
        the backward recomputes them one chunk at a time, so [B, S, V] is
        never whole."""
        Bsz, S, _ = h.shape
        c = head_loss_chunk(S)
        labels = labels.long()

        def chunk_ce(hx, lx):
            logits = self._head_logits_local(params, hx).float()
            if self.vocab_parallel():
                return self._vocab_parallel_ce(logits, lx).sum()
            gold = torch.gather(logits, -1, lx[..., None])[..., 0]
            return (torch.logsumexp(logits, -1) - gold).sum()

        ce = checkpointing.wrap_stage(chunk_ce, "full")
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for start in range(0, S, c):
            total = total + ce(h[:, start:start + c], labels[:, start:start + c])
        return total / (Bsz * S)

    def _vocab_parallel_ce(self, logits, labels):
        """Cross-entropy of fp32 logits whose vocab lies over ``tp``
        ([..., V / tp] here): the max over every rank's block (a constant
        of the log-sum-exp), the sum of exponentials and the gold logit
        (from the rank that holds it) each summed over ``tp`` in rank
        order."""
        tp = self.tp
        n = logits.shape[-1]
        m = torch.stack(tp.gather(logits.detach().amax(-1), L.TP_SUM)).amax(0)
        se = L.tp_reduce(tp, torch.exp(logits - m[..., None]).sum(-1))
        lo = labels - tp.rank * n
        own = (lo >= 0) & (lo < n)
        gold = torch.gather(logits, -1, lo.clamp(0, n - 1)[..., None])[..., 0]
        gold = L.tp_reduce(tp, torch.where(own, gold, torch.zeros_like(gold)))
        return torch.log(se) + m - gold

    # ----------------------------------------------------------------- caches
    def cache_protos(self, shape: ShapeConfig, n_micro: int, *,
                     rank: Optional[int] = None):
        """Stacked resident cache leaves as ``(shape, dtype)``:
        ``[n_stages, L_per_stage, m, mb, ...]``; with ``rank`` (a pipe
        rank), only its stages' (``rank, rank + pipe, ...``):
        ``[n_stages // pipe, L_per_stage, m, mb, ...]``."""
        mb = shape.global_batch // n_micro
        if self.mesh is not None:           # one replica's slice, its heads
            if mb % self.mesh.replicas:
                raise NotImplementedError(
                    f"a micro-batch of {mb} over {self.mesh.replicas} "
                    "replicas: the sequence-sharded decode cache (the "
                    "reference's cache_specs(seq_shard=True)) is not "
                    "ported yet (ROADMAP A9b); serve a batch the replicas "
                    "divide")
            mb //= self.mesh.replicas
        slots_len = shape.seq_len + 64
        per_layer = self.block_cache_proto(self.arch_c, mb, slots_len,
                                           self.dtype)
        n = (self.n_stages if rank is None
             else len(range(rank, self.n_stages, self.pcfg.pipe)))

        def stack(p):
            shp, dt = p
            return ((n, self.L_per_stage, n_micro) + tuple(shp), dt)
        return _map_protos(stack, per_layer)

    def init_cache(self, shape: ShapeConfig, n_micro: int, *, filled: bool,
                   rank: Optional[int] = None):
        """Zero caches on this model's device; ``filled`` marks them as
        already holding ``seq_len`` tokens.  With ``rank``, only that pipe
        rank's stages' caches (:meth:`cache_protos`), bitwise the rows
        :meth:`cache_share` takes of the whole cache."""
        def mk(p):
            shp, dt = p
            z = torch.zeros(shp, dtype=dt, device=self.device)
            if filled and dt == torch.int32 and len(shp) == 3:
                z.fill_(shape.seq_len)
            return z
        return _map_protos(mk, self.cache_protos(shape, n_micro, rank=rank))

    def cache_share(self, cache, rank: int):
        """Pipe rank ``rank``'s share of a whole cache (or cache protos'
        shapes): its stages' rows, in chunk order; views of ``cache``."""
        return tree_map(lambda a: a[rank::self.pcfg.pipe], cache)


def _map_protos(fn, protos):
    """Map over a tree whose leaves are ``(shape, dtype)`` pairs."""
    if isinstance(protos, dict):
        return {k: _map_protos(fn, v) for k, v in protos.items()}
    return fn(protos)
