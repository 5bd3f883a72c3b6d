"""AmoebaNet-D (sequentialized, as the paper's speed benchmark uses).

Counterpart of :mod:`repro.models.amoebanet`.  The paper benchmarks a
sequential AmoebaNet-D at (L, F) = (18, 256): L cells with filter scale F,
reduction cells at 1/3 and 2/3 depth.  Each cell sums three parallel
branches into the residual stream: separable 3x3 and 5x5 convs
(depthwise + pointwise) and a 3x3 **max** pool followed by a pointwise
conv (the reference's code pools with max, whatever its docstring says);
channels double at each reduction.

Layouts are PyTorch's (NCHW, OIHW; depthwise ``[cin, 1, k, k]`` with
``groups=cin``), and every strided conv and the pool pad as JAX's
``"SAME"`` does (:func:`repro_torch.models.unet.same_pads`), the pool with
-inf.  The head is ``mean over H, W`` then ``pooled @ w`` with ``w [cin,
cout]``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from repro_torch.core import balance as balance_lib
from repro_torch.core.skip import SkipSpec
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.models.unet import conv2d_same, max_pool_same, normal_init


@dataclass(frozen=True)
class AmoebaConfig:
    L: int = 18                 # number of cells (paper: 18)
    F: int = 256                # filter scale (paper: 256)
    in_ch: int = 3
    img: int = 224
    n_classes: int = 1000


def _sep_init(gen, cin, cout, k, dev, dtype):
    return {"dw": normal_init(gen, (cin, 1, k, k), (k * k) ** -0.5, dev,
                              dtype),
            "pw": normal_init(gen, (cout, cin, 1, 1), cin ** -0.5, dev,
                              dtype)}


def _sep_apply(p, x, stride=1):
    y = conv2d_same(x, p["dw"], stride=stride, groups=x.shape[1])
    return F.conv2d(y, p["pw"])


@dataclass
class Cell:
    kind: str       # stem | normal | reduction | head
    cin: int
    cout: int
    res: int

    def param_count(self) -> int:
        if self.kind == "stem":
            return 9 * self.cin * self.cout
        if self.kind == "head":
            return self.cin * self.cout
        return (9 + 25) * self.cin + 2 * self.cin * self.cout + 2 * self.cout

    def flops(self) -> float:
        """The reference's balance cost (at the input size)."""
        r = self.res * self.res
        if self.kind == "stem":
            return 2.0 * 9 * self.cin * self.cout * r
        if self.kind == "head":
            return 2.0 * self.cin * self.cout
        return 2.0 * r * ((9 + 25) * self.cin + 2 * self.cin * self.cout)

    def conv_flops(self) -> float:
        """FLOPs of every conv (and the head's product) for one sample, at
        each conv's output size: 2 x the multiply-adds.  A cell runs the
        3x3 and 5x5 depthwise convs and three pointwise convs."""
        if self.kind == "head":
            return 2.0 * self.cin * self.cout
        r = self.res if self.kind == "normal" else -(-self.res // 2)
        if self.kind == "stem":
            return 2.0 * 9 * self.cin * self.cout * r * r
        return 2.0 * r * r * ((9 + 25) * self.cin + 3 * self.cin * self.cout)


class AmoebaNetModel:
    """Layer-list model compatible with :mod:`pipeline_hetero`."""

    def __init__(self, cfg: AmoebaConfig, n_stages: int):
        self.cfg = cfg
        self.layers: List[Cell] = []
        res = cfg.img // 2
        ch = cfg.F // 4
        self.layers.append(Cell("stem", cfg.in_ch, ch, cfg.img))
        red = {cfg.L // 3, 2 * cfg.L // 3}
        for i in range(cfg.L):
            if i in red:
                self.layers.append(Cell("reduction", ch, ch * 2, res))
                ch *= 2
                res //= 2
            else:
                self.layers.append(Cell("normal", ch, ch, res))
        self.layers.append(Cell("head", ch, cfg.n_classes, res))
        costs = [c.flops() for c in self.layers]
        self.sizes = balance_lib.block_partition(costs, n_stages)
        self.bounds = balance_lib.partition_bounds(self.sizes)
        self.n_stages = n_stages

    def init(self, gen: torch.Generator, device: DeviceLike = "cuda",
             dtype: torch.dtype = torch.float32) -> List[Dict[str, Any]]:
        """Per-cell parameter trees, random from ``gen``."""
        dev = resolve_device(device)
        out = []
        for c in self.layers:
            if c.kind == "stem":
                out.append({"w": normal_init(gen, (c.cout, c.cin, 3, 3),
                                             (9 * c.cin) ** -0.5, dev,
                                             dtype)})
            elif c.kind == "head":
                out.append({"w": normal_init(gen, (c.cin, c.cout),
                                             c.cin ** -0.5, dev, dtype)})
            else:
                out.append({
                    "s3": _sep_init(gen, c.cin, c.cout, 3, dev, dtype),
                    "s5": _sep_init(gen, c.cin, c.cout, 5, dev, dtype),
                    "pw": normal_init(gen, (c.cout, c.cin, 1, 1),
                                      c.cin ** -0.5, dev, dtype),
                    "scale": torch.ones(c.cout, device=dev, dtype=dtype),
                })
        return out

    def layer_apply(self, i: int, p, x, skips: Dict[str, Any]):
        c = self.layers[i]
        if c.kind == "stem":
            return F.relu(conv2d_same(x, p["w"], stride=2))
        if c.kind == "head":
            return x.mean(dim=(2, 3)) @ p["w"]
        stride = 2 if c.kind == "reduction" else 1
        b3 = _sep_apply(p["s3"], x, stride)
        b5 = _sep_apply(p["s5"], x, stride)
        bp = F.conv2d(max_pool_same(x, 3, stride), p["pw"])
        y = (b3 + b5 + bp) * p["scale"][:, None, None]
        if c.kind == "normal":
            y = y + x
        return F.relu(y)

    def apply_sequential(self, params, x):
        skips: Dict[str, Any] = {}
        for i, p in enumerate(params):
            x = self.layer_apply(i, p, x, skips)
        return x

    def skip_edges(self) -> List[SkipSpec]:
        """None: every cell reads only its predecessor's output."""
        return []

    def total_params(self) -> int:
        return sum(c.param_count() for c in self.layers)

    def conv_flops(self) -> float:
        """Forward conv FLOPs for one sample (:meth:`Cell.conv_flops`)."""
        return sum(c.conv_flops() for c in self.layers)
