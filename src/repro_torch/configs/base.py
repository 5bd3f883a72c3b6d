"""Configuration dataclasses for the repro framework.

Every assigned architecture is expressed as an :class:`ArchConfig`; every
assigned input shape as a :class:`ShapeConfig`; and the distribution layout
(how the production mesh's ``model`` axis factors into ``pipe × tp``, how many
micro-batches the GPipe schedule uses, which remat policy applies, ...) as a
:class:`ParallelConfig`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

from repro_torch.core.wire import WireSpec


# ---------------------------------------------------------------------------
# Attention / MoE / SSM sub-configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    kind: str = "full"            # "full" | "swa" (sliding window) | "none"
    window: int = 0               # sliding-window size when kind == "swa"
    causal: bool = True
    rope_theta: float = 10000.0
    use_rope: bool = True         # whisper uses learned abs. positions instead
    # hymba-style mixed layouts: indices of layers that use *full* attention
    # while the rest use SWA (empty = uniform `kind`).
    global_layers: Tuple[int, ...] = ()


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM head-group (used by rwkv6/hymba families)."""
    state_dim: int = 16
    n_heads: int = 0              # 0 = derive from d_model / head_dim
    head_dim: int = 64
    conv_dim: int = 4


# ---------------------------------------------------------------------------
# Architecture
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm | conv
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attn: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    act: str = "silu"             # silu (SwiGLU) | geglu | gelu
    norm: str = "rms"             # rms | ln
    tie_embeddings: bool = False
    # encoder-decoder extras (whisper): ``n_layers`` counts *decoder* layers.
    enc_layers: int = 0
    enc_len: int = 0              # fixed encoder sequence length (audio frames)
    # modality frontend stub: number of patch/frame embeddings prepended
    frontend: str = "none"        # none | audio_stub | vision_stub
    # gemma: token embeddings times sqrt(d_model), a scalar of the model dtype
    embed_scale: bool = False
    param_dtype: str = "bfloat16"
    # documentation pointer (public source tier)
    source: str = ""

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    def layer_params(self) -> int:
        """Approximate per-block parameter count (for balance / MODEL_FLOPS)."""
        d, f = self.d_model, self.d_ff
        n = 0
        if self.attn is not None and self.attn.kind != "none":
            a = self.attn
            n += d * a.n_heads * a.head_dim * 2              # q, o
            n += d * a.n_kv_heads * a.head_dim * 2           # k, v
        if self.moe is not None:
            n += self.moe.n_experts * 3 * d * f              # gate/up/down per expert
            n += d * self.moe.n_experts                      # router
        elif self.family in ("ssm",):
            # rwkv6: time-mix (r,k,v,w,g,o ~ 6 d^2 at head granularity) + channel-mix
            n += 6 * d * d + 2 * d * f
        elif self.family == "hybrid":
            n += 3 * d * d                                   # ssm in/out/dt projections
            n += 3 * d * f
        else:
            mults = 3 if self.act in ("silu", "geglu") else 2
            n += mults * d * f
        return n

    def total_params(self) -> int:
        n = (self.n_layers + self.enc_layers) * self.layer_params()
        n += self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return n

    def active_params_per_token(self) -> int:
        """For MoE: params touched per token (6*N_active*D convention)."""
        per_block = self.layer_params()
        if self.moe is not None:
            dense = per_block - self.moe.n_experts * 3 * self.d_model * self.d_ff
            active = dense + self.moe.top_k * 3 * self.d_model * self.d_ff
            per_block = active
        n = (self.n_layers + self.enc_layers) * per_block
        n += self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return n


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# Parallel / schedule config
# ---------------------------------------------------------------------------

#: canonical rematerialization policies (mirrored as
#: ``repro_torch.core.checkpointing.POLICIES`` — defined here so the config layer
#: can validate at parse time without importing jax).
REMAT_POLICIES = ("none", "full", "dots", "dots_no_batch")

#: split-backward residual handling (ZB-H1): ``"recompute"`` re-runs the
#: stage forward inside both Bx and Bw; ``"reuse"`` stashes the residuals Bx
#: materialized and re-reads them at Bw (no second remat).
RESIDUAL_MODES = ("recompute", "reuse")

#: executor lowering of the task plan: ``"spmd"`` runs one rank-uniform
#: program (every rank traces every segment branch, buffers at ring-max
#: depth — the reference path); ``"mpmd"`` specializes a program per rank
#: (``plan.specialize``): each rank's column drives its own pruned branch
#: set under a top-level rank-indexed switch, with the chain ``ppermute``
#: double-buffered one tick ahead so comm overlaps the next stage compute.
EXECUTORS = ("spmd", "mpmd")


#: schedule bases the config layer accepts ("interleaved" carries a
#: ``virtual_stages`` count; every other base has exactly one chunk/rank).
SCHEDULE_BASES = ("gpipe", "gpipe_fwd", "gpipe_tasked", "1f1b",
                  "interleaved", "zb")


@dataclass(frozen=True)
class ScheduleSpec:
    """Structured schedule selection — the planner-facing replacement for
    overloaded ``schedule="interleaved:2"`` strings.

    Bundles the four knobs that together decide what the tick loop runs:
    the schedule *base* (task-table family), the interleaving factor
    ``virtual_stages`` (only meaningful for ``base="interleaved"``), the
    split-backward ``residuals`` mode, and the ``executor`` lowering.
    ``to_dict``/``from_dict`` round-trip exactly (the planner's
    ``PlanReport`` serializes specs through them), and :meth:`name`
    renders the legacy string form the rest of the stack still accepts.
    """
    base: str = "gpipe"
    virtual_stages: int = 1
    residuals: str = "recompute"
    executor: str = "spmd"

    def __post_init__(self):
        if self.base not in SCHEDULE_BASES:
            raise ValueError(f"unknown schedule base {self.base!r}; "
                             f"want one of {SCHEDULE_BASES}")
        if self.virtual_stages < 1:
            raise ValueError(
                f"virtual stages must be >= 1, got {self.virtual_stages}")
        if self.base != "interleaved" and self.virtual_stages != 1:
            raise ValueError(
                f"schedule base {self.base!r} has exactly 1 virtual stage "
                f"per rank, got {self.virtual_stages}")
        if self.residuals not in RESIDUAL_MODES:
            raise ValueError(f"unknown residuals mode {self.residuals!r}; "
                             f"want one of {RESIDUAL_MODES}")
        if self.executor not in EXECUTORS:
            raise ValueError(f"unknown executor {self.executor!r}; "
                             f"want one of {EXECUTORS}")

    @property
    def name(self) -> str:
        """The legacy string form (``"interleaved:3"``, ``"zb"``, ...)."""
        if self.base == "interleaved":
            return f"interleaved:{self.virtual_stages}"
        return self.base

    @classmethod
    def from_string(cls, schedule: str, *, residuals: str = "recompute",
                    executor: str = "spmd") -> "ScheduleSpec":
        """Build a spec from a legacy ``"interleaved:2"``-style string."""
        if schedule == "interleaved" or schedule.startswith("interleaved:"):
            v = int(schedule.split(":", 1)[1]) if ":" in schedule else 2
            return cls("interleaved", v, residuals, executor)
        return cls(schedule, 1, residuals, executor)

    def to_dict(self) -> dict:
        return {"base": self.base, "virtual_stages": self.virtual_stages,
                "residuals": self.residuals, "executor": self.executor}

    @classmethod
    def from_dict(cls, d: dict) -> "ScheduleSpec":
        return cls(base=d["base"],
                   virtual_stages=int(d.get("virtual_stages", 1)),
                   residuals=d.get("residuals", "recompute"),
                   executor=d.get("executor", "spmd"))


@dataclass(frozen=True)
class PlanSpec:
    """A complete, serializable pipeline plan: schedule spec + stage
    partition + microbatch count.

    This is the planner's unit of search and the payload of every
    ``PlanReport`` entry: :meth:`apply_to` turns it into a concrete
    :class:`ParallelConfig` (which is how ``dryrun`` and
    ``steps.build_train_step`` consume a planner choice), and
    ``to_dict``/``from_dict`` round-trip bit-for-bit through JSON.
    ``partition`` is the per-GLOBAL-stage layer counts (length
    ``pipe * virtual_stages``, summing to the model's layer count);
    empty means the legacy uniform ceil layout.
    """
    schedule: ScheduleSpec
    pipe: int
    microbatches: int
    partition: Tuple[int, ...] = ()
    wire: str = "fp32"            # on-the-wire codec (WireSpec.parse form)

    def __post_init__(self):
        object.__setattr__(self, "partition", tuple(self.partition))
        WireSpec.parse(self.wire)         # rejects malformed wire specs
        if self.pipe < 1:
            raise ValueError(f"need pipe >= 1, got {self.pipe}")
        if self.microbatches < 1:
            raise ValueError(f"need microbatches >= 1, "
                             f"got {self.microbatches}")
        if self.partition:
            n_stages = self.pipe * self.schedule.virtual_stages
            if len(self.partition) != n_stages:
                raise ValueError(
                    f"partition has {len(self.partition)} entries for "
                    f"{n_stages} global stages")
            if any(int(p) < 0 for p in self.partition):
                raise ValueError(f"negative partition entry: "
                                 f"{self.partition}")

    def to_dict(self) -> dict:
        return {"schedule": self.schedule.to_dict(), "pipe": self.pipe,
                "microbatches": self.microbatches,
                "partition": list(self.partition),
                "wire": self.wire}

    @classmethod
    def from_dict(cls, d: dict) -> "PlanSpec":
        return cls(schedule=ScheduleSpec.from_dict(d["schedule"]),
                   pipe=int(d["pipe"]),
                   microbatches=int(d["microbatches"]),
                   partition=tuple(int(p) for p in d.get("partition", ())),
                   wire=d.get("wire", "fp32"))

    def apply_to(self, pcfg: "ParallelConfig") -> "ParallelConfig":
        """Project this plan onto a base config (keeps tp/data/remat/...)."""
        return pcfg.with_(pipe=self.pipe, n_micro=self.microbatches,
                          schedule=self.schedule.name,
                          residuals=self.schedule.residuals,
                          executor=self.schedule.executor,
                          partition=self.partition,
                          wire=self.wire)


def parse_schedule(schedule: str) -> Tuple[str, int]:
    """DEPRECATED shim: split a schedule string into (base, virtual_stages).

    New code should use :meth:`ScheduleSpec.from_string` (this shim merely
    constructs the spec and unpacks it, so the two can never disagree).
    Kept because the string form is pervasive in configs and CLIs:
    ``"interleaved:3"`` -> ``("interleaved", 3)`` (bare ``"interleaved"``
    defaults to 2 chunks); every other name has one virtual stage per rank.
    """
    spec = ScheduleSpec.from_string(schedule)
    return spec.base, spec.virtual_stages


@dataclass(frozen=True)
class ParallelConfig:
    """How the production mesh maps onto this architecture.

    The assignment's production grid is ``(data=16, model=16)`` per pod; the
    ``model`` axis factors into ``pipe × tp`` (``pipe * tp == 16``).
    """
    pipe: int = 16
    tp: int = 1
    data: int = 16
    pod: int = 1
    n_micro: int = 8
    microbatch: int = 0           # 0 = derive from global_batch
    dp2: int = 1                  # surplus model-axis folded into extra DP
    schedule: str = "gpipe"       # execution order of the tick loop:
    #   "gpipe"         — fill/drain forward, autodiff-induced reverse
    #                     clock-cycle backward (paper Algorithm 1);
    #   "gpipe_tasked"  — the same task table, but executed by the fused
    #                     scheduler (explicit-VJP backwards in the loop);
    #   "1f1b"          — PipeDream-flush: same synchronous semantics, each
    #                     stage drains backwards early, bounding stashed
    #                     activations at min(n - j, m) instead of m;
    #   "interleaved:v" — Megatron-style interleaved 1F1B with v virtual
    #                     stages per rank (bubble shrinks ~1/v; needs
    #                     n_micro % pipe == 0);
    #   "zb"            — ZB-H1-style split backward: Bx (input cotangent)
    #                     on the critical path, Bw (weight grad) filling
    #                     bubble ticks.
    grad_reduce: str = "ordered"  # fused-scheduler cotangent folding:
    #   "ordered" — per-micro slots + fixed-order sum: gradients are
    #               bitwise-identical across schedules (costs m x stage-
    #               param memory for the slots);
    #   "running" — fold in schedule order: O(1) memory, bit-exact only
    #               against itself.
    remat: str = "full"           # none | full | dots | dots_no_batch
    #   (checkpointing.POLICIES): what each stage saves for its backward.
    #   "full" stores only the stage boundary input (the paper's §3.2.4
    #   setting); "dots" / "dots_no_batch" store matmul outputs; "none"
    #   stores whatever the vjp naturally needs.  Under residuals="reuse"
    #   the policy also decides WHAT Bx stashes for Bw (see ``residuals``).
    residuals: str = "recompute"  # split-backward (zb) residual handling:
    #   "recompute" — Bx and Bw each rematerialize the stage forward from
    #               the parked boundary input (2 forwards of remat per
    #               micro — the ZB tradeoff);
    #   "reuse"   — true ZB-H1: Bx stashes the vjp residuals its remat
    #               materialized (filtered by the remat policy) into a
    #               plan-allocated residual stash, and Bw re-reads them
    #               instead of re-running the forward (Bw ~ 1 forward of
    #               work instead of 2).  No effect on fused-B schedules.
    executor: str = "spmd"        # task-plan lowering target (EXECUTORS):
    #   "spmd" — one rank-uniform program: every segment traces the UNION
    #            of all ranks' branches and buffers flatten to the ring-max
    #            depth (the reference path);
    #   "mpmd" — per-rank specialized programs (plan.specialize): a
    #            top-level rank-indexed switch dispatches each rank's own
    #            pruned branch set / slot columns, and the chain ppermute
    #            is double-buffered one tick ahead (tick t's boundary
    #            output ships while tick t+1's compute runs).  Bitwise-
    #            identical to "spmd" by construction.
    remat_layers: bool = False    # nested checkpointing: remat each layer
    #   inside the stage as well, so a backward tick stashes only bf16
    #   layer-boundary activations instead of every layer's fp32 internals
    #   (the memory lever for deep stages, e.g. llama3's 32 layers/stage).
    gather_weights_once: bool = False  # pre-gather FSDP stage weights per
    #   step (ZeRO-1-style comm) instead of re-gathering every clock tick
    #   (ZeRO-3).  Trades +unsharded-stage-weights memory for ~T x fewer
    #   all-gather bytes; the dominant lever for collective-bound cells.
    remat_last_micro: bool = True  # False: paper §2.1, the executor runs
    #   each stage's last micro-batch bare, skipping its recompute F'_{m,j}
    #   (torchgpipe's checkpoint="except_last").  True, the default, wraps
    #   every micro-batch as the reference's scan executor does.
    unroll_ticks: bool = False
    overlap: bool = True          # async send-before-compute (paper C3 analogue)
    portals: bool = True          # paper C4
    stream_inputs: bool = False   # beyond-paper: shard µbatches over pipe + rotate
    fsdp: bool = True             # ZeRO-3 over the data axis
    grad_compression: str = "none"  # none | int8_ef (cross-pod): blockwise
    #   int8 + error feedback on the data-parallel gradient reduce
    #   (runtime.compression.EFCompressor; EF residual rides OptState.ef).
    wire: str = "fp32"            # pipeline on-the-wire codec, WireSpec.parse
    #   form: "fp32" | "bf16" | "int8-ef" uniform, or per payload class
    #   "chain=bf16,portal=fp32,cotangent=int8-ef".  fp32 is bitwise
    #   lossless; bf16 halves wire bytes (exact on bf16-cast models);
    #   int8-ef quantizes with per-(rank, stream) error feedback.
    activation_dtype: str = "bfloat16"
    partition: Tuple[int, ...] = ()  # per-GLOBAL-stage layer counts (length
    #   pipe * virtual_stages, summing to the model's layer count) — the
    #   torchgpipe.balance output wired through core.stage.partition_layout.
    #   Empty = the legacy uniform ceil layout with tail padding.

    def __post_init__(self):
        # Validate knob values at parse time: a typo'd policy should fail
        # when the config is built, not ticks deep inside wrap_stage / the
        # fused executor's backward branches.
        if self.remat not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {self.remat!r}; "
                             f"want one of {REMAT_POLICIES}")
        if self.residuals not in RESIDUAL_MODES:
            raise ValueError(f"unknown residuals mode {self.residuals!r}; "
                             f"want one of {RESIDUAL_MODES}")
        if self.executor not in EXECUTORS:
            raise ValueError(f"unknown executor {self.executor!r}; "
                             f"want one of {EXECUTORS}")
        if self.grad_compression not in ("none", "int8_ef"):
            raise ValueError(
                f"unknown grad_compression {self.grad_compression!r}; "
                f"want 'none' or 'int8_ef'")
        WireSpec.parse(self.wire)                 # rejects malformed specs
        base, v = parse_schedule(self.schedule)   # rejects malformed specs
        object.__setattr__(self, "partition", tuple(self.partition))
        if self.partition:
            if len(self.partition) != self.pipe * v:
                raise ValueError(
                    f"partition has {len(self.partition)} entries for "
                    f"{self.pipe * v} global stages (pipe={self.pipe}, "
                    f"virtual_stages={v})")
            if any(int(p) < 0 for p in self.partition):
                raise ValueError(f"negative partition entry: "
                                 f"{self.partition}")

    def advisories(self) -> Tuple[str, ...]:
        """Config smells worth surfacing before a run (dryrun prints these).

        ``zb`` + ``residuals="recompute"`` prices Bx+Bw at 4 stage-forwards
        of work per micro vs the fused B's 3, so in low-bubble regimes
        (small pipe, large n_micro) the split backward does MORE total work
        than 1F1B saves — the device model shows it losing at pipe=2.
        ``residuals="reuse"`` drops Bw's recompute and restores the ZB win.
        """
        out = []
        if parse_schedule(self.schedule)[0] == "zb" \
                and self.residuals == "recompute":
            out.append(
                "schedule='zb' with residuals='recompute' pays 2 remat "
                "forwards per micro (Bx+Bw = 4F vs fused B = 3F) and can be "
                "SLOWER than 1f1b in low-bubble regimes; set "
                "residuals='reuse' (true ZB-H1) to drop Bw's recompute.")
        return tuple(out)

    def with_(self, **kw) -> "ParallelConfig":
        return dataclasses.replace(self, **kw)

    def layout_dict(self) -> dict:
        """JSON-serializable record of the parallel layout a checkpoint is
        written under — what an elastic restore needs to decide whether
        (and how) to restack the stage parameters."""
        return {"pipe": self.pipe, "tp": self.tp, "data": self.data,
                "pod": self.pod, "dp2": self.dp2, "n_micro": self.n_micro,
                "schedule": self.schedule,
                "virtual_stages": self.virtual_stages,
                "partition": list(self.partition)}

    @property
    def model_axis(self) -> int:
        return self.pipe * self.tp * self.dp2

    @property
    def schedule_spec(self) -> ScheduleSpec:
        """This config's schedule knobs as a structured spec."""
        return ScheduleSpec.from_string(self.schedule,
                                        residuals=self.residuals,
                                        executor=self.executor)

    @property
    def spec(self) -> PlanSpec:
        """This config's pipeline plan as a first-class, serializable
        :class:`PlanSpec` (schedule + partition + microbatches) — the
        object the planner searches over and ``PlanReport`` serializes."""
        return PlanSpec(schedule=self.schedule_spec, pipe=self.pipe,
                        microbatches=self.n_micro,
                        partition=self.partition, wire=self.wire)

    @property
    def wire_spec(self) -> WireSpec:
        """This config's on-the-wire codec selection, parsed."""
        return WireSpec.parse(self.wire)

    @property
    def schedule_base(self) -> str:
        return parse_schedule(self.schedule)[0]

    @property
    def virtual_stages(self) -> int:
        """Chunks per rank: the model is cut into pipe * virtual_stages
        global stages (1 for every non-interleaved schedule)."""
        return parse_schedule(self.schedule)[1]

    @classmethod
    def auto(cls, arch, shape, hardware=None, executors=("spmd", "mpmd"),
             **overrides) -> "ParallelConfig":
        """Single planner entrypoint: search the plan space for ``arch`` ×
        ``shape`` on ``hardware`` and return a concrete config.

        ``hardware`` is a :class:`repro.planner.hardware.HardwareSpec`, a
        path to a ``hardware.yaml``, or ``None`` (spec defaults).
        ``overrides`` seed the base config the plan is projected onto
        (``data=2``, ``remat="dots"``, ...) — the planner owns ``pipe``,
        ``n_micro``, ``schedule``, ``residuals``, ``executor``, and
        ``partition``; everything else passes through.  ``executors``
        restricts the executor leg of the search (``("spmd",)`` where
        per-rank specialized compilation isn't worth it, e.g. host-CPU
        emulation).  Replaces the
        manual five-knob dance: the chosen partition/schedule/executor
        come ranked from the calibrated device model under the
        hardware's memory budget.
        """
        raise NotImplementedError(
            "the automatic planner is not ported to repro_torch yet "
            "(ROADMAP A12); pass an explicit ParallelConfig")

    @classmethod
    def plan(cls, arch, shape, hardware=None, **overrides
             ) -> "ParallelConfig":
        """Alias for :meth:`auto`."""
        return cls.auto(arch, shape, hardware, **overrides)


# ---------------------------------------------------------------------------
# Roofline hardware constants (TPU v5e per assignment)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HardwareConstants:
    peak_flops_bf16: float = 197e12      # per chip
    hbm_bw: float = 819e9                # bytes/s per chip
    ici_bw: float = 50e9                 # bytes/s per link
    hbm_bytes: float = 16 * 1024 ** 3    # v5e HBM capacity


V5E = HardwareConstants()


# ---------------------------------------------------------------------------
# A full experiment cell = arch × shape × parallel
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Cell:
    arch: ArchConfig
    shape: ShapeConfig
    parallel: ParallelConfig

    @property
    def key(self) -> str:
        return f"{self.arch.name}/{self.shape.name}"
