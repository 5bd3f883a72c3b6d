"""On-the-wire codec specs + byte accounting for pipeline comm traffic.

Everything the pipeline ships between ranks falls into one of three
payload classes:

* ``chain`` — the boundary activation riding the forward chain
  ``ppermute`` (rank j -> j+1, one carry per F tick below the last stage);
* ``cotangent`` — the backward chain carry (rank j -> j-1) AND the
  mirrored skip-route cotangents (dst -> src);
* ``portal`` — skip/portal route *values* (src -> dst, plus threaded
  relay hops).

A :class:`WireSpec` picks a codec per class:

* ``fp32``    — identity: ship the producing dtype untouched (bitwise
  lossless, the reference mode);
* ``bf16``    — downcast to bfloat16 at the latch, upcast at arrival
  (half the bytes; exact on values already bf16-representable, i.e.
  lossless for bf16-cast models);
* ``int8-ef`` — blockwise int8 quantization with per-block fp32 scales
  and a per-(rank, stream) error-feedback residual added to the next
  payload of the same stream — the EF-SGD construction of
  ``runtime.compression`` generalized from DP gradients to wire traffic
  (~4x fewer bytes; lossy, bounded by the EF residual).

The spec is lowered into the plan IR (``TaskPlan.wire``) so both
executors encode at the latch and decode at the arrival tick, and the
byte accounting here prices the device model's comm term from
``hardware.yaml``'s link bandwidth.  This module is dependency-light
(numpy only) — the jax codec kernels live in ``core.pipeline`` /
``runtime.compression``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import numpy as np

#: codecs a payload class can ride the wire as
WIRE_CODECS = ("fp32", "bf16", "int8-ef")

#: payload classes a WireSpec prices independently
PAYLOAD_CLASSES = ("chain", "portal", "cotangent")


def _check_codec(codec: str) -> str:
    if codec not in WIRE_CODECS:
        raise ValueError(f"unknown wire codec {codec!r}; "
                         f"want one of {WIRE_CODECS}")
    return codec


@dataclass(frozen=True)
class WireSpec:
    """Per-payload-class wire precision for pipeline comm traffic."""
    chain: str = "fp32"
    portal: str = "fp32"
    cotangent: str = "fp32"
    block: int = 256          # int8-ef quantization block (elements)

    def __post_init__(self):
        for cls_ in PAYLOAD_CLASSES:
            _check_codec(getattr(self, cls_))
        if self.block < 1:
            raise ValueError(f"need block >= 1, got {self.block}")

    @property
    def lossless(self) -> bool:
        """True when every class ships fp32 (bitwise vs an unwired run).
        ``bf16`` is additionally lossless on bf16-cast models, but that
        depends on the model dtype, not the spec alone."""
        return all(getattr(self, c) == "fp32" for c in PAYLOAD_CLASSES)

    @property
    def stateful(self) -> bool:
        """True when any class carries error-feedback state (int8-ef)."""
        return any(getattr(self, c) == "int8-ef" for c in PAYLOAD_CLASSES)

    @property
    def name(self) -> str:
        """Canonical string form ``parse`` round-trips."""
        vals = {c: getattr(self, c) for c in PAYLOAD_CLASSES}
        if len(set(vals.values())) == 1:
            return next(iter(vals.values()))
        return ",".join(f"{c}={v}" for c, v in vals.items())

    @classmethod
    def parse(cls, spec: "WireSpec | str | None") -> "WireSpec":
        """``"bf16"`` (uniform) or ``"chain=bf16,portal=fp32,..."``."""
        if spec is None:
            return cls()
        if isinstance(spec, WireSpec):
            return spec
        s = str(spec).strip()
        if not s:
            return cls()
        if "=" not in s:
            c = _check_codec(s)
            return cls(chain=c, portal=c, cotangent=c)
        kw: Dict[str, str] = {}
        for part in s.split(","):
            k, _, v = part.partition("=")
            k, v = k.strip(), v.strip()
            if k not in PAYLOAD_CLASSES:
                raise ValueError(f"unknown wire payload class {k!r}; "
                                 f"want one of {PAYLOAD_CLASSES}")
            kw[k] = _check_codec(v)
        return cls(**kw)

    def with_(self, **kw) -> "WireSpec":
        return replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return {"chain": self.chain, "portal": self.portal,
                "cotangent": self.cotangent, "block": self.block}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WireSpec":
        return cls(chain=d.get("chain", "fp32"),
                   portal=d.get("portal", "fp32"),
                   cotangent=d.get("cotangent", "fp32"),
                   block=int(d.get("block", 256)))


#: the identity spec every plan defaults to
WIRE_FP32 = WireSpec()


def bytes_factor(codec: str, *, block: int = 256) -> float:
    """Wire bytes per fp32-equivalent payload byte under ``codec``.

    fp32 ships 4 bytes/element, bf16 2, int8-ef 1 payload byte plus a
    4-byte fp32 scale per ``block`` elements (~1.016/4 at block=256).
    """
    _check_codec(codec)
    if codec == "fp32":
        return 1.0
    if codec == "bf16":
        return 0.5
    return 0.25 + 1.0 / float(block)


def payload_bytes(codec: str, fp32_bytes: float, *, block: int = 256) -> float:
    """On-the-wire bytes for a payload of ``fp32_bytes`` under ``codec``."""
    return fp32_bytes * bytes_factor(codec, block=block)


def hop_comm_units(fp32_bytes: float, codec: str, link_bytes_per_s: float,
                   unit_s: float, *, block: int = 256) -> float:
    """Bytes-priced comm term: one wire hop in stage-forward units.

    ``fp32_bytes / bandwidth`` seconds, scaled by the codec's byte factor
    and normalized by ``unit_s`` (seconds per stage-forward unit) — the
    term ``simulate_device_times`` / ``schedule_bubble`` consume as
    ``comm_cost``.
    """
    if link_bytes_per_s <= 0 or unit_s <= 0:
        return 0.0
    return payload_bytes(codec, fp32_bytes, block=block) \
        / link_bytes_per_s / unit_s


def plan_wire_report(tplan, carry_bytes: float, *,
                     spec: Optional[WireSpec] = None,
                     skip_bytes: Optional[Dict[str, float]] = None
                     ) -> Dict[str, Any]:
    """Price one step's wire traffic for a lowered plan, in actual bytes.

    Counts every cross-rank hop the executor's collectives carry — chain
    carries (``send_slot``), backward cotangents (``b_send_slot``), and
    route value/cotangent hops (same-rank identity holds are free) — and
    prices each class under ``spec``.  ``skip_bytes`` maps skip-edge
    names to their fp32-equivalent payload bytes (default: one carry).
    Returns per-step / per-tick wire bytes plus the compressed /
    uncompressed ratio the bench tables publish.
    """
    spec = spec or getattr(tplan, "wire", None) or WIRE_FP32
    skip_bytes = skip_bytes or {}
    bk = spec.block
    cross = tplan.n_ranks > 1

    chain_hops = int((tplan.send_slot >= 0).sum()) if cross else 0
    bwd_hops = int((tplan.b_send_slot >= 0).sum()) if cross else 0
    route_val = route_cot = 0.0
    route_val_raw = route_cot_raw = 0.0
    for rt in tplan.routes:
        rb = float(skip_bytes.get(rt.name, carry_bytes))
        if rt.fwd_perm:
            n = int((rt.send != -1).sum())
            route_val += n * payload_bytes(spec.portal, rb, block=bk)
            route_val_raw += n * rb
        if rt.bwd_perm:
            n = int((rt.g_send != -1).sum())
            route_cot += n * payload_bytes(spec.cotangent, rb, block=bk)
            route_cot_raw += n * rb

    chain = chain_hops * payload_bytes(spec.chain, carry_bytes, block=bk)
    cot = bwd_hops * payload_bytes(spec.cotangent, carry_bytes, block=bk)
    raw = (chain_hops + bwd_hops) * carry_bytes \
        + route_val_raw + route_cot_raw
    total = chain + cot + route_val + route_cot
    ticks = max(int(tplan.n_ticks), 1)
    return {
        "wire": spec.name,
        "bytes_per_step": total,
        "bytes_per_tick": total / ticks,
        "fp32_bytes_per_step": raw,
        "ratio": (total / raw) if raw else 1.0,
        "per_class": {"chain": chain, "cotangent": cot + route_cot,
                      "portal": route_val},
        "hops": {"chain": chain_hops, "cotangent_chain": bwd_hops,
                 "route_value": int(sum((rt.send != -1).sum()
                                        for rt in tplan.routes
                                        if rt.fwd_perm)),
                 "route_cotangent": int(sum((rt.g_send != -1).sum()
                                            for rt in tplan.routes
                                            if rt.bwd_perm))},
    }
