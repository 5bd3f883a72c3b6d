"""The port's host plan layer and its isolation from JAX.

* Every ``TaskPlan`` field of ``repro_torch.core.plan.plan_for`` equals the
  reference's, element for element, with and without skip routes.
* No module of ``src/repro_torch`` (nor ``chip_smoke.py``) imports ``jax``
  or anything of ``repro``.
* With ``jax`` made unimportable, ``repro_torch`` still imports and serves
  both ported families (smollm and rwkv6) and runs the U-Net and
  AmoebaNet pipelines on the CPU.
"""
import ast
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro.core import plan as jplan
from repro.core import skip as jskip
from repro_torch.core import plan as tplan_lib
from repro_torch.core.skip import SkipSpec

ROOT = Path(__file__).resolve().parents[1]
GRID = [(1, 1), (4, 2), (8, 4), (3, 4)]


def _assert_same(a, b, path="plan"):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("schedule", ["gpipe_fwd", "gpipe_tasked", "1f1b"])
@pytest.mark.parametrize("m,n", GRID)
def test_plan_equals_reference(schedule, m, n):
    want = jplan.plan_for(schedule, m, n)
    got = tplan_lib.plan_for(schedule, m, n)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    _assert_same(want, got)
    for r in range(n):
        _assert_same(jplan.specialize(want, r), tplan_lib.specialize(got, r),
                     f"specialize[{r}]")


SKIP_CASES = [(sched, m, n) for sched in ("gpipe_fwd", "gpipe_tasked", "1f1b",
                                          "zb", "interleaved:2")
              for m, n in ((4, 2), (8, 4), (3, 4))
              if not (sched.startswith("interleaved") and m % n)]


def _skip_specs(n_stages):
    """A skip with two destinations, and one across a single stage."""
    if n_stages < 3:
        return (jskip.SkipSpec("a", 0, (1,)),)
    return (jskip.SkipSpec("a", 0, (2, n_stages - 1)),
            jskip.SkipSpec("b", 1, (2,)))


@pytest.mark.parametrize("portals", [True, False],
                         ids=["portals", "threaded"])
@pytest.mark.parametrize("schedule,m,n", SKIP_CASES)
def test_plan_with_skips_equals_reference(schedule, m, n, portals):
    """Plans with skip routes, portal or threaded: every field, the routes
    included, equals the reference's (or both refuse the same plan)."""
    v = int(schedule.split(":")[1]) if ":" in schedule else 1
    jspecs = _skip_specs(n * v)
    tspecs = tuple(SkipSpec(s.name, s.src_stage, s.dsts) for s in jspecs)
    try:
        want = jplan.plan_for(schedule, m, n, skips=jspecs, portals=portals)
    except NotImplementedError as e:
        with pytest.raises(NotImplementedError, match="portals=True"):
            tplan_lib.plan_for(schedule, m, n, skips=tspecs,
                               portals=portals)
        assert "portals=True" in str(e)
        return
    got = tplan_lib.plan_for(schedule, m, n, skips=tspecs, portals=portals)
    assert len(got.routes) == sum(len(s.dsts) for s in tspecs)
    _assert_same(want, got)


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert files, "no port sources found"
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"


def test_port_runs_with_jax_unimportable():
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None          # any `import jax` now fails
        sys.path.insert(0, {str(ROOT / "src")!r})
        import torch
        from repro_torch import configs
        from repro_torch.launch.serve import serve
        for arch in ("smollm-360m", "rwkv6-1.6b", "whisper-tiny"):
            res = serve(configs.smoke_arch(arch),
                        configs.smoke_parallel(arch).with_(pipe=2),
                        prompt_len=8, gen=3, batch=2, device="cpu",
                        dtype=torch.float32)
            assert res["tokens"].shape == (2, 3), res["tokens"].shape
            assert bool(torch.isfinite(res["logits"]).all())
        import repro_torch.kernels.wkv6, repro_torch.interop  # noqa: F401
        import repro_torch.launch.train_hetero  # noqa: F401
        from repro_torch.configs.base import ParallelConfig
        from repro_torch.models import pipeline_hetero as PH
        from repro_torch.models.amoebanet import AmoebaConfig, AmoebaNetModel
        from repro_torch.models.unet import UNetConfig, UNetModel
        for model, x in (
                (UNetModel(UNetConfig(B=1, C=4, levels=2, img=16), 2),
                 torch.randn(4, 3, 16, 16)),
                (AmoebaNetModel(AmoebaConfig(L=3, F=8, img=16,
                                             n_classes=5), 2),
                 torch.randn(4, 3, 16, 16))):
            pcfg = ParallelConfig(pipe=2, tp=1, data=1, n_micro=2)
            params = model.init(torch.Generator().manual_seed(0), "cpu")
            prog = PH.build_hetero_program(model, params, pcfg, "cpu")
            with torch.no_grad():
                y = PH.hetero_forward(prog, pcfg, x)
            loss, grads = PH.hetero_grad_call(
                prog, pcfg.with_(schedule="1f1b"))(prog.stage_params, x,
                                                   torch.zeros_like(y))
            assert bool(torch.isfinite(loss)) and len(grads) == 2
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro")
                     and sys.modules[m] is not None)
        assert not bad, bad
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"        # the suite runs several workers at once
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("m,n", GRID)
def test_run_pipeline_runs_each_micro_through_every_stage(m, n):
    """The gpipe_fwd executor on a toy stage (h -> 3 h + stage + 1): every
    micro-batch passes stages 0..n-1 in order, resident state is written on
    each stage's forward tick, and the park high-water is the plan's."""
    import torch

    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core.pipeline import (last_stage_output, microbatch,
                                           run_pipeline, unmicrobatch)

    def stage_apply(params, carry, skips_in, resident, ctx):
        h = ctx.fresh["h"] if ctx.stage == 0 else carry["h"]
        resident["seen"][ctx.micro] += 1
        return {"h": h * params["w"] + ctx.stage + 1}, {}, resident

    cfg = ParallelConfig(pipe=n, tp=1, data=1, n_micro=m)
    x = torch.arange(2 * m, dtype=torch.float64).reshape(2 * m, 1)
    params = {"w": torch.full((n,), 3.0, dtype=torch.float64)}
    resident = {"seen": torch.zeros((n, m), dtype=torch.int64)}
    info = {}
    outs, resident = run_pipeline(stage_apply, params,
                                  microbatch({"h": x}, m), cfg,
                                  devices=["cpu"] * n, resident=resident,
                                  park_info=info)
    want = x.clone()
    for s in range(n):
        want = want * 3 + s + 1
    torch.testing.assert_close(unmicrobatch(last_stage_output(outs))["h"],
                               want)
    assert outs[:-1] == [None] * (n - 1)
    assert bool((resident["seen"] == 1).all())
    assert info["per_stage_park"] == \
        tplan_lib.plan_for("gpipe_fwd", m, n).per_stage_park
