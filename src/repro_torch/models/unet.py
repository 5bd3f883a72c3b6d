"""U-Net (paper §4.2.2) as a heterogeneous pipeline program.

Counterpart of :mod:`repro.models.unet`.  Architecture per the paper: 5
down-sampling and 5 up-sampling levels, B convolution blocks between
samplings, first-conv channels C doubling per down level (halving per up
level).  Long skip connections tie each down level's output to the
matching up level: the paper's portal showcase.

GroupNorm replaces BatchNorm by default (paper §2 footnote 1: micro-batching
changes BN statistics; GN is micro-batch invariant, so pipelined results are
exactly sequential).  ``norm="batch"`` opts into the caveat (statistics of
the micro-batch).

Layouts are PyTorch's: activations NCHW (the reference is NHWC, so its
channel concatenation on the last axis is ``dim=1`` here), conv weights
OIHW, the transposed conv's ``[cin, cout, 2, 2]``.  Convolutions pad as
JAX's ``"SAME"`` does (:func:`same_pads`), which is asymmetric for stride
2, and the transposed conv's weight is the reference's flipped in both
spatial axes (``interop.hetero_params_from_jax`` maps it once).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import balance as balance_lib
from repro_torch.core.skip import SkipSpec, crossing_skips
from repro_torch.devices import DeviceLike, resolve_device


@dataclass(frozen=True)
class UNetConfig:
    B: int = 2                 # conv blocks between samplings (paper's B)
    C: int = 16                # first-conv output channels (paper's C)
    levels: int = 5
    in_ch: int = 3
    out_ch: int = 1
    img: int = 192
    norm: str = "group"        # group | batch (paper footnote-1 caveat)
    groups: int = 4


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """JAX's ``"SAME"`` padding of one spatial axis of size ``n`` for
    kernel ``k`` and stride ``s``: ``(low, high)``.  The total is
    ``max((ceil(n / s) - 1) s + k - n, 0)`` and ``low = total // 2``, so
    stride 2 on an even size pads ``(0, 1)`` for k 3 and ``(1, 2)`` for k
    5, where PyTorch's symmetric ``padding=k // 2`` would shift the
    sampling grid by one pixel."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, k: int, stride: int):
    """``"SAME"`` pads of an NCHW tensor's H and W, and ``F.pad``'s order."""
    (h0, h1), (w0, w1) = (same_pads(x.shape[-2], k, stride),
                          same_pads(x.shape[-1], k, stride))
    return (h0, h1), (w0, w1), (w0, w1, h0, h1)


def conv2d_same(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None, stride: int = 1,
                groups: int = 1) -> torch.Tensor:
    """NCHW convolution with an OIHW weight and ``"SAME"`` padding."""
    ph, pw, pad = _pads(x, w.shape[-1], stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, b, stride, (ph[0], pw[0]), groups=groups)
    return F.conv2d(F.pad(x, pad), w, b, stride, groups=groups)


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """``k`` x ``k`` max pool with ``"SAME"`` padding by -inf."""
    ph, pw, pad = _pads(x, k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.max_pool2d(x, k, stride, (ph[0], pw[0]))
    return F.max_pool2d(F.pad(x, pad, value=-math.inf), k, stride)


def conv_apply(p, x, stride=1):
    return conv2d_same(x, p["w"], p["b"], stride)


def norm_apply(p, x, cfg: UNetConfig):
    """GroupNorm over contiguous channel groups, or BatchNorm with the
    micro-batch's statistics; biased variance, eps 1e-5, fp32 statistics."""
    x32 = x.float()
    scale, bias = p["scale"].float(), p["bias"].float()
    if cfg.norm == "group":
        y = F.group_norm(x32, min(cfg.groups, x.shape[1]), scale, bias, 1e-5)
    else:
        y = F.batch_norm(x32, None, None, scale, bias, training=True,
                         eps=1e-5)
    return y.to(x.dtype)


@dataclass
class Layer:
    """One pipeline-visible layer of the sequentialized U-Net."""
    kind: str                  # block | down | up | head
    cin: int
    cout: int
    res: int                   # input spatial resolution
    skip_out: Optional[str] = None   # stash name (end of a down level)
    skip_in: Optional[str] = None    # pop name (start of an up level)

    def param_count(self) -> int:
        k = 9
        n = k * self.cin * self.cout + 2 * self.cout
        if self.kind == "up":
            n += 4 * self.cout * self.cout    # 2x2 transpose conv
        return n

    def flops(self) -> float:
        """The reference's balance cost: the 3x3 conv at the input size."""
        return 2.0 * 9 * self.cin * self.cout * self.res * self.res

    def conv_flops(self) -> float:
        """FLOPs of every convolution of the layer for one sample, at each
        conv's output size: 2 x the multiply-adds (norms and ReLUs not
        counted)."""
        r = self.res
        if self.kind == "down":
            return 2.0 * 9 * self.cin * self.cout * (-(-r // 2)) ** 2
        if self.kind == "up":                 # 2x2 transpose, 3x3 at 2r
            return 2.0 * (4 * self.cin * self.cout * r * r
                          + 9 * self.cout * self.cout * 4 * r * r)
        return 2.0 * 9 * self.cin * self.cout * r * r


def build_layers(cfg: UNetConfig) -> List[Layer]:
    layers: List[Layer] = []
    res = cfg.img
    ch = cfg.in_ch
    enc_ch = []
    for lvl in range(cfg.levels):
        cout = cfg.C * (2 ** lvl)
        for b in range(cfg.B):
            layers.append(Layer("block", ch, cout, res))
            ch = cout
        layers[-1] = dataclasses.replace(layers[-1], skip_out=f"s{lvl}")
        enc_ch.append(ch)
        layers.append(Layer("down", ch, cout * 2, res))
        ch = cout * 2
        res //= 2
    for lvl in reversed(range(cfg.levels)):
        cout = cfg.C * (2 ** lvl)
        layers.append(Layer("up", ch, cout, res, skip_in=f"s{lvl}"))
        res *= 2
        ch = cout + enc_ch[lvl]        # concat with the skip
        for b in range(cfg.B):
            layers.append(Layer("block", ch, cout, res))
            ch = cout
    layers.append(Layer("head", ch, cfg.out_ch, res))
    return layers


def normal_init(gen: torch.Generator, shape, std: float, device, dtype):
    """``std`` x N(0, 1) of ``shape``, drawn on the generator's device."""
    return (torch.randn(shape, generator=gen, device=gen.device) * std).to(
        device=device, dtype=dtype)


class UNetModel:
    """Layer list + params + per-layer apply; partitioned by balance."""

    def __init__(self, cfg: UNetConfig, n_stages: int,
                 balance_by: str = "flops"):
        self.cfg = cfg
        self.layers = build_layers(cfg)
        costs = [l.flops() if balance_by == "flops" else l.param_count()
                 for l in self.layers]
        self.sizes = balance_lib.block_partition(costs, n_stages)
        self.bounds = balance_lib.partition_bounds(self.sizes)
        self.n_stages = n_stages

    # ------------------------------------------------------------ parameters
    def init(self, gen: torch.Generator, device: DeviceLike = "cuda",
             dtype: torch.dtype = torch.float32) -> List[Dict[str, Any]]:
        """Per-layer parameter trees, random from ``gen`` (drawn on the
        generator's device, then moved to ``device``)."""
        dev = resolve_device(device)
        params = []
        for l in self.layers:
            # "up" layers first transpose-conv cin -> cout, then conv
            # cout -> cout; all other kinds conv cin -> cout.
            conv_cin = l.cout if l.kind == "up" else l.cin
            p = {"conv": {"w": normal_init(gen, (l.cout, conv_cin, 3, 3),
                                           (9 * conv_cin) ** -0.5, dev,
                                           dtype),
                          "b": torch.zeros(l.cout, device=dev, dtype=dtype)},
                 "norm": {"scale": torch.ones(l.cout, device=dev,
                                              dtype=dtype),
                          "bias": torch.zeros(l.cout, device=dev,
                                              dtype=dtype)}}
            if l.kind == "up":
                p["upconv"] = {
                    "w": normal_init(gen, (l.cin, l.cout, 2, 2),
                                     (4 * l.cin) ** -0.5, dev, dtype),
                    "b": torch.zeros(l.cout, device=dev, dtype=dtype)}
            params.append(p)
        return params

    # ---------------------------------------------------------- layer apply
    def layer_apply(self, li: int, p, x, skips: Dict[str, Any]):
        """Layer ``li`` on NCHW ``x``; pops the skip it consumes from and
        stores the skip it produces in ``skips``."""
        l = self.layers[li]
        cfg = self.cfg
        if l.kind == "block":
            if l.skip_in:
                x = torch.cat([x, skips.pop(l.skip_in)], dim=1)
            y = F.relu(norm_apply(p["norm"], conv_apply(p["conv"], x), cfg))
            if l.skip_out:
                skips[l.skip_out] = y
            return y
        if l.kind == "down":
            y = conv_apply(p["conv"], x, stride=2)
            return F.relu(norm_apply(p["norm"], y, cfg))
        if l.kind == "up":
            y = F.conv_transpose2d(x, p["upconv"]["w"], p["upconv"]["b"],
                                   stride=2)
            y = F.relu(norm_apply(p["norm"], conv_apply(p["conv"], y), cfg))
            return torch.cat([y, skips.pop(l.skip_in)], dim=1)
        if l.kind == "head":
            return conv_apply(p["conv"], x)
        raise ValueError(l.kind)

    def apply_sequential(self, params, x):
        """Reference forward (no pipeline)."""
        skips: Dict[str, Any] = {}
        for i, p in enumerate(params):
            x = self.layer_apply(i, p, x, skips)
        return x

    # ---------------------------------------------------------- skip routing
    def skip_edges(self) -> List[SkipSpec]:
        """Portal edges implied by the stage partition."""
        return crossing_skips(self.layers, self.bounds)

    def total_params(self) -> int:
        return sum(l.param_count() for l in self.layers)

    def conv_flops(self) -> float:
        """Forward conv FLOPs for one sample (:meth:`Layer.conv_flops`)."""
        return sum(l.conv_flops() for l in self.layers)
