"""The port's kernels: plain versions against the JAX Pallas kernels.

On the CPU each kernel module's plain version is held against the JAX
package's Pallas kernel in interpret mode (and the attention also against
the naive oracles), on the same numpy inputs.  The ``cuda`` cases hold the
Hopper kernels against their plain versions and skip where there is no card;
they need no JAX, so the GPU machine runs them with
``python -m pytest -m cuda tests/test_torch_kernels.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (check_bwd_inputs,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_cuda,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_bwd,
                                         rmsnorm_bwd_cuda, rmsnorm_bwd_plain,
                                         rmsnorm_cuda, rmsnorm_plain)
from repro_torch.kernels.wkv6 import (wkv6, wkv6_bwd, wkv6_bwd_cuda,
                                      wkv6_bwd_plain, wkv6_cuda, wkv6_plain)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# fp32: a different summation order (tests/test_kernels.py's 2e-5 for
# attention, 1e-5 for the norm); bf16: one rounding of the output apart
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
NORM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# WKV on the card (chip_smoke.py's): fp32 (serial form) sums in another
# order; bf16 with T >= 64 (chunked form) splits each fp32 tensor-core
# operand into bf16 hi + lo (~2^-16 relative), so the fp32 state is the sum
# order and that split apart, the bf16 out one rounding of the fp32 result
WKV_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
WKV_STATE_TOL = 1e-4
# backward kernels on the card (chip_smoke.py's): fp32 sums in another order;
# bf16 rounds each gradient once from fp32, so it is held within 2e-2 of
# its own largest magnitude
BWD_FP32_TOL = 1e-3
BWD_BF16_REL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jx():
    """The JAX reference kernels (imported here: the GPU machine has no JAX)."""
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention
    from repro.kernels.rmsnorm import rmsnorm_pallas
    return types.SimpleNamespace(jnp=jax.numpy, ref=jref,
                                 flash_attention=flash_attention,
                                 rmsnorm_pallas=rmsnorm_pallas)


def _pair(jx, a: np.ndarray, dtype: str):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    t = torch.from_numpy(a).to(DTYPES[dtype])
    j = jx.jnp.asarray(a).astype(getattr(jx.jnp, dtype))
    return t, j


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x.astype("float32"), np.float32)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 960), (8, 960), (3, 7, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_vs_pallas(jx, shape, dtype):
    rng = np.random.default_rng(0)
    x, jxx = _pair(jx, rng.normal(size=shape).astype(np.float32) * 2, dtype)
    s, js = _pair(jx, rng.normal(size=shape[-1:]).astype(np.float32) + 1,
                  dtype)
    got = rmsnorm(x, s)                      # CPU tensor -> plain version
    want = jx.rmsnorm_pallas(jxx, js, block_rows=32, interpret=True)
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=NORM_TOL[dtype],
                               atol=NORM_TOL[dtype])
    np.testing.assert_array_equal(_np(ops.rmsnorm(x, s)), _np(got))


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

# (Hq, Hkv, D): GQA 3:1 and 2:1 and MHA at D 64; gemma-2b's MQA 8:1 at D 256
HEADS = [(15, 5, 64), (4, 2, 64), (4, 4, 64), (8, 1, 256)]
# (Sq, Sk, causal, window, q_offset): ragged Sq against 32-blocks, a later
# query chunk (q_offset > 0, Sq < Sk), sliding windows with and without causal
MASKS = [(40, 40, True, 0, 0), (40, 40, False, 0, 0), (40, 40, True, 16, 0),
         (24, 56, True, 0, 32), (24, 56, False, 24, 32)]


def _qkv(hq, hkv, sq, sk, d=64, b=1, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32))


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_vs_pallas(jx, heads, mask, dtype):
    sq, sk, causal, window, q_offset = mask
    hq, hkv, d = heads
    qn, kn, vn = _qkv(hq, hkv, sq, sk, d=d)
    (q, jq), (k, jk), (v, jv) = (_pair(jx, a, dtype) for a in (qn, kn, vn))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = flash_attention(q, k, v, **kw)          # CPU -> plain version
    want = jx.flash_attention(jq, jk, jv, block_q=32, block_k=32,
                              interpret=True, **kw)
    tol = ATTN_TOL[dtype]
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    naive = ref.mha_naive(q, k, v, **kw)
    np.testing.assert_allclose(_np(got), _np(naive), rtol=tol, atol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(
            _np(naive), _np(jx.ref.mha_naive(jq, jk, jv, **kw)), rtol=tol,
            atol=tol)


def test_ops_attention_rejects_traced_forms():
    q, k, v = (torch.zeros(1, 2, 4, 64) for _ in range(3))
    with pytest.raises(NotImplementedError, match="host scalars"):
        ops.attention(q, k, v, kv_len=torch.tensor(3))
    with pytest.raises(NotImplementedError, match="host scalars"):
        ops.attention(q, k, v, causal=torch.tensor(1))
    with pytest.raises(NotImplementedError, match="window as a host int"):
        ops.attention(q, k, v, window=torch.tensor(2))


def test_wrappers_refuse_cpu_tensors_for_the_kernel():
    """The CUDA entry points never run a plain version: CPU input raises."""
    x = torch.ones(2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_cuda(x, torch.ones(64))
    q = torch.zeros(1, 2, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_cuda(q, q, q, q, torch.zeros(2, 64), torch.zeros(1, 2, 64, 64))


# ---------------------------------------------------------------------------
# Hopper kernels against their plain versions (need the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [960, 2048, 448])
@pytest.mark.parametrize("rows", [1, 3, 8, 2048])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_vs_plain(cuda_device, d, rows, dtype):
    """smollm's and rwkv6's widths (compiled for their D) and 448 = 64 x 7,
    which takes the kernel's generic-D form; 3 rows leave a bf16 warp's
    second row empty."""
    g = torch.Generator(device=cuda_device).manual_seed(rows)
    dt = DTYPES[dtype]
    x = torch.randn(rows, d, generator=g, device=cuda_device).to(dt)
    s = (torch.randn(d, generator=g, device=cuda_device) + 1).to(dt)
    before = rmsnorm.launches
    got = rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    np.testing.assert_allclose(_np(got.cpu()), _np(rmsnorm_plain(x, s).cpu()),
                               rtol=NORM_TOL[dtype], atol=NORM_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(15, 5), (4, 4)])
@pytest.mark.parametrize("mask", [(100, 100, True, 0, 0),
                                  (100, 100, False, 128, 0),
                                  (100, 300, True, 0, 200),
                                  (2048, 2048, True, 0, 0),
                                  (4096, 4096, True, 0, 0)])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_vs_plain(cuda_device, heads, mask, d, dtype):
    """Sq = 100 is ragged against both kernels' q tiles (64 fp32, 128 bf16);
    D 256 streams 64-key tiles in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    sq, sk, causal, window, q_offset = mask
    dt = DTYPES[dtype]
    q, k, v = (torch.from_numpy(a).to(cuda_device, dt)
               for a in _qkv(*heads, sq, sk, d=d))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, **kw)
    tol = {"float32": 2e-4, "bfloat16": 2e-2}[dtype]
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 16, 64, 65, 100, 130, 2048])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("s0_kind", ["zero", "random"])
@pytest.mark.parametrize("decay", ["normal", "extreme"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_kernel_vs_plain(cuda_device, T, B, s0_kind, decay, dtype):
    """chip_smoke.py's WKV grid: H = 32, K = V = 64, w fp32 (the path's).
    bf16 with T >= 64 takes the chunked form, the rest the serial form;
    65, 100 and 130 leave a masked tail; extreme decays
    w = exp(-exp(3 N(0, 1))) underflow to w = 0."""
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain einsum
    H, n = 32, 64
    g = torch.Generator(device=cuda_device).manual_seed(T * 10 + B)

    def randn(*shape, scale):
        return torch.randn(*shape, generator=g, device=cuda_device) * scale
    dt = DTYPES[dtype]
    r, k, v = (randn(B, H, T, n, scale=0.5).to(dt) for _ in range(3))
    w = torch.exp(-torch.exp(randn(B, H, T, n, scale=(
        0.5 if decay == "normal" else 3.0))))
    u = randn(H, n, scale=0.5)
    s0 = (randn(B, H, n, n, scale=0.3) if s0_kind == "random"
          else torch.zeros(B, H, n, n, device=cuda_device))
    before = wkv6.launches
    out, state = wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    assert out.dtype == dt and state.dtype == torch.float32
    assert bool(torch.isfinite(out.float()).all())
    want_o, want_s = wkv6_plain(r, k, v, w, u, s0)
    np.testing.assert_allclose(_np(out.cpu()), _np(want_o.cpu()),
                               rtol=WKV_TOL[dtype], atol=WKV_TOL[dtype])
    np.testing.assert_allclose(_np(state.cpu()), _np(want_s.cpu()),
                               rtol=WKV_STATE_TOL, atol=WKV_STATE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 64, 130])
def test_wkv6_kernel_bf16_w_vs_plain(cuda_device, T):
    """w in bf16 (the wrapper's other w dtype) through both forms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    H, n = 32, 64
    g = torch.Generator(device=cuda_device).manual_seed(T)

    def randn(*shape, scale):
        return torch.randn(*shape, generator=g, device=cuda_device) * scale
    r, k, v = (randn(1, H, T, n, scale=0.5).bfloat16() for _ in range(3))
    w = torch.exp(-torch.exp(randn(1, H, T, n, scale=0.5))).bfloat16()
    u = randn(H, n, scale=0.5)
    s0 = randn(1, H, n, n, scale=0.3)
    out, state = wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    want_o, want_s = wkv6_plain(r, k, v, w, u, s0)
    tol = WKV_TOL["bfloat16"]
    np.testing.assert_allclose(_np(out.cpu()), _np(want_o.cpu()), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(_np(state.cpu()), _np(want_s.cpu()),
                               rtol=WKV_STATE_TOL, atol=WKV_STATE_TOL)


def _assert_bwd_close(got, want, dtype, what):
    g, w = _np(got.cpu()), _np(want.cpu())
    assert np.isfinite(g).all(), what
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=BWD_FP32_TOL, atol=BWD_FP32_TOL,
                                   err_msg=what)
    else:
        assert np.abs(g - w).max() <= BWD_BF16_REL * np.abs(w).max(), what


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(15, 5), (4, 4), (15, 3)])
@pytest.mark.parametrize("s", [100, 192, 256, 2048, 4096])
@pytest.mark.parametrize("mask", [(True, 0), (False, 0), (True, 128),
                                  (True, 100)])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_kernel_vs_plain(cuda_device, heads, s, mask, d,
                                             dtype):
    """dq / dk / dv and the forward's lse on the card against the plain
    backward on the same inputs; S = 100 and 192 are ragged against the
    128-row / 128-key tiles, a window of 100 straddles them, GQA 3:1 and 5:1
    sum dk / dv over each kv head's group; at D 256 the bf16 kernels split
    the columns between two warpgroups and the group into q-head slices, and
    the fp32 ones stage D in chunks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    causal, window = mask
    dt = DTYPES[dtype]
    q, k, v = (torch.from_numpy(a).to(cuda_device, dt)
               for a in _qkv(*heads, s, s, d=d, b=2))
    do = torch.from_numpy(_qkv(*heads, s, s, d=d, b=2, seed=1)[0]).to(
        cuda_device, dt)
    kw = dict(causal=causal, window=window)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dt and g.shape == w.shape
        _assert_bwd_close(g, w, dtype, name)
    np.testing.assert_allclose(lse.cpu().numpy(), ref.mha_blocked_fwd(
        q, k, v, **kw)[1].cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(15, 5), (4, 4), (8, 1)])
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_is_bitwise_deterministic(cuda_device, heads, d,
                                                      dtype):
    """No atomics: two calls on the same inputs give the same dq, dk and dv
    bit for bit (the GQA sums run in one block, in a fixed order; bf16 at
    D 256 splits MQA 8:1's group into q-head slices whose fp32 partials are
    added in slice order)."""
    dt = DTYPES[dtype]
    q, k, v = (torch.from_numpy(a).to(cuda_device, dt)
               for a in _qkv(*heads, 1000, 1000, d=d, b=2))
    do = torch.from_numpy(_qkv(*heads, 1000, 1000, d=d, b=2, seed=1)[0]).to(
        cuda_device, dt)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True)
    first = flash_attention_bwd(q, k, v, out, lse, do)
    again = flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    for a, b, name in zip(first, again, ("dq", "dk", "dv")):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("d", [960, 2048, 448])
@pytest.mark.parametrize("rows", [1, 3, 5, 33, 2048, 8192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_kernel_vs_plain(cuda_device, d, rows, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(rows + d)
    dt = DTYPES[dtype]
    x = (torch.randn(rows, d, generator=g, device=cuda_device) * 2).to(dt)
    s = (torch.randn(d, generator=g, device=cuda_device) + 1).to(dt)
    dy = torch.randn(rows, d, generator=g, device=cuda_device).to(dt)
    before = rmsnorm_bwd.launches
    got = rmsnorm_bwd(x, s, dy)
    torch.cuda.synchronize()
    assert rmsnorm_bwd.launches == before + 1
    for g_, w, name in zip(got, rmsnorm_bwd_plain(x, s, dy), ("dx", "dscale")):
        assert g_.dtype == dt and g_.shape == w.shape
        _assert_bwd_close(g_, w, dtype, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_functions_carry_autograd_on_the_card(cuda_device, dtype):
    """The outputs of the attention and RMSNorm Functions carry a grad_fn on
    the card, and their backward runs the backward kernels: the gradients
    through both equal the plain Functions' on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = DTYPES[dtype]
    qn, kn, vn = _qkv(15, 5, 130, 130, d=64)
    xn = np.random.default_rng(3).normal(size=(130, 960)).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda_device):
        launched = (flash_attention_bwd.launches, rmsnorm_bwd.launches)
        q, k, v = (torch.from_numpy(a).to(dev, dt).requires_grad_()
                   for a in (qn, kn, vn))
        x = torch.from_numpy(xn).to(dev, dt).requires_grad_()
        scale = torch.ones(960, device=dev, dtype=dt, requires_grad=True)
        out = flash_attention(q, k, v, causal=True)
        y = rmsnorm(x, scale)
        assert out.grad_fn is not None and y.grad_fn is not None
        loss = (out.float() ** 2).sum() + (y.float() ** 2).sum()
        grads[str(dev)] = torch.autograd.grad(loss, (q, k, v, x, scale))
    assert (flash_attention_bwd.launches, rmsnorm_bwd.launches) == (
        launched[0] + 1, launched[1] + 1)
    for g, w, name in zip(grads[str(cuda_device)], grads["cpu"],
                          ("dq", "dk", "dv", "dx", "dscale")):
        _assert_bwd_close(g, w, dtype, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 16, 64, 65, 100, 130, 256, 1024])
@pytest.mark.parametrize("decay", ["normal", "extreme"])
def test_wkv6_kernel_backward_matches_plain_autograd(cuda_device, dtype, T,
                                                     decay):
    """Under grad the card's WKV-6 runs through the WKV6 Function, whose
    backward launches ``wkv6_bwd``: every gradient (dr, dk, dv, dw, du,
    ds0) against autograd through the plain version on the same card and
    inputs, from a non-zero s0 with a cotangent on the final state; bf16
    with T >= 64 takes the chunked forms, forward and backward, the rest
    the serial ones; several chunks (256, 1024), masked tails (65: a
    1-step tail, 100, 130) and decays that underflow to w = 0."""
    dt = DTYPES[dtype]
    g = torch.Generator(device=cuda_device).manual_seed(T)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device)
    r, k, v = (randn(2, 4, T, 64).to(dt) * 0.5 for _ in range(3))
    w = torch.exp(-torch.exp(randn(2, 4, T, 64)
                             * (0.5 if decay == "normal" else 3.0)))
    u, s0 = randn(4, 64) * 0.5, randn(2, 4, 64, 64) * 0.3
    do, ds = randn(2, 4, T, 64).to(dt), randn(2, 4, 64, 64)
    xs = [x.clone().requires_grad_() for x in (r, k, v, w, u, s0)]
    launched = wkv6_bwd.launches
    out, state = wkv6(*xs)
    got = torch.autograd.grad([out, state], xs, [do, ds])
    torch.cuda.synchronize()
    assert wkv6_bwd.launches == launched + 1
    want = wkv6_bwd_plain(r, k, v, w, u, s0, do, ds)
    for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert a.dtype == b.dtype, name
        _assert_bwd_close(a, b, "float32" if a.dtype == torch.float32
                          else dtype, name)
    with torch.no_grad():
        out, _ = wkv6(*xs)
    assert out.grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("T", [16, 64, 130])
def test_wkv6_kernel_backward_bf16_w_matches_plain_autograd(cuda_device, T):
    """w in bf16 as well (the kernels' other w dtype): both backward forms,
    every gradient against autograd through the plain version, dw in bf16
    held like the other bf16 gradients."""
    g = torch.Generator(device=cuda_device).manual_seed(T + 3)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device)
    r, k, v = (randn(2, 4, T, 64).to(torch.bfloat16) * 0.5 for _ in range(3))
    w = torch.exp(-torch.exp(randn(2, 4, T, 64) * 0.5)).to(torch.bfloat16)
    u, s0 = randn(4, 64) * 0.5, randn(2, 4, 64, 64) * 0.3
    do, ds = randn(2, 4, T, 64).to(torch.bfloat16), randn(2, 4, 64, 64)
    got = wkv6_bwd(r, k, v, w, u, s0, do, ds)
    torch.cuda.synchronize()
    want = wkv6_bwd_plain(r, k, v, w, u, s0, do, ds)
    for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert a.dtype == b.dtype, name
        _assert_bwd_close(a, b, "float32" if a.dtype == torch.float32
                          else "bfloat16", name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,T", [("bfloat16", 130), ("bfloat16", 1024),
                                     ("float32", 130)])
@pytest.mark.parametrize("with_ds", [True, False])
def test_wkv6_kernel_backward_is_bitwise_repeatable(cuda_device, dtype, T,
                                                    with_ds):
    """No atomics in either backward form: two calls on the same inputs give
    the same bits in all six gradients (the training path's 1F1B ==
    gpipe_tasked gate on rwkv6 needs it)."""
    dt = DTYPES[dtype]
    g = torch.Generator(device=cuda_device).manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device)
    r, k, v = (randn(2, 4, T, 64).to(dt) * 0.5 for _ in range(3))
    w = torch.exp(-torch.exp(randn(2, 4, T, 64) * 0.5))
    u, s0 = randn(4, 64) * 0.5, randn(2, 4, 64, 64) * 0.3
    do = randn(2, 4, T, 64).to(dt)
    ds = randn(2, 4, 64, 64) if with_ds else None
    first = wkv6_bwd(r, k, v, w, u, s0, do, ds)
    again = wkv6_bwd(r, k, v, w, u, s0, do, ds)
    for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "ds0"), first,
                          again):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# Around the kernels (CPU)
# ---------------------------------------------------------------------------

def test_backward_wrappers_refuse_cpu_tensors_and_their_contract():
    """The backward entry points never run a plain version: CPU input
    raises; the attention backward kernel takes the training case only."""
    x = torch.ones(2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_bwd_cuda(x, torch.ones(64), x)
    r = torch.zeros(1, 2, 3, 64)
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_bwd_cuda(r, r, r, r, torch.zeros(2, 64),
                      torch.zeros(1, 2, 64, 64), r)
    q = torch.zeros(1, 2, 4, 64)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="q_offset"):
        check_bwd_inputs(q, q, q, q, lse, q, q_offset=2)
    k = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="Sq == Sk"):
        check_bwd_inputs(q, k, k, q, lse, q, q_offset=0)
    with pytest.raises(ValueError, match="lse"):
        check_bwd_inputs(q, q, q, q, lse.double(), q, q_offset=0)
    check_bwd_inputs(q, q, q, q, lse, q, q_offset=0)


def test_wkv6_on_cpu_differentiates_through_the_plain_version():
    """On the CPU the WKV6 Function's backward is the plain one (autograd
    through the sequential recurrence); the rwkv6 CPU tests train through
    it against the JAX oracle."""
    r = torch.randn(1, 2, 5, 8, requires_grad=True)
    w = torch.full((1, 2, 5, 8), 0.9)
    out, _ = wkv6(r, r, r, w, torch.zeros(2, 8), torch.zeros(1, 2, 8, 8))
    assert out.grad_fn is not None


@pytest.mark.parametrize("name, family", [
    ("void (anonymous namespace)::tc::flash_fwd_wgmma_kernel<64>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, int, "
     "int, int, int, float, int, int, int)", "flash_attention (ours)"),
    ("void (anonymous namespace)::simt::flash_fwd_simt_kernel<128>("
     "float const*, float const*, float const*, float*, int, int, int, int, "
     "float, int, int, int)", "flash_attention (ours)"),
    ("void (anonymous namespace)::rmsnorm_kernel<__nv_bfloat16, 960>("
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, int, int, "
     "float)", "rmsnorm (ours)"),
    ("void (anonymous namespace)::rmsnorm_kernel<float, 0>(float const*, "
     "float const*, float*, int, int, float)", "rmsnorm (ours)"),
    ("void (anonymous namespace)::bwd_tc::flash_bwd_dkdv_mma_kernel<64>("
     "__nv_bfloat16 const*, ...)", "flash_attention_bwd (ours)"),
    ("void (anonymous namespace)::bwd_tc::flash_bwd_dkdv_wgmma_kernel<64>("
     "CUtensorMap_st, CUtensorMap_st, ...)", "flash_attention_bwd (ours)"),
    ("void (anonymous namespace)::bwd_tc::flash_bwd_dq_wgmma_kernel<128>("
     "CUtensorMap_st, CUtensorMap_st, ...)", "flash_attention_bwd (ours)"),
    ("(anonymous namespace)::bwd_tc::d256::flash_bwd_dkdv_d256_kernel("
     "CUtensorMap_st, CUtensorMap_st, ...)", "flash_attention_bwd (ours)"),
    ("(anonymous namespace)::bwd_tc::d256::flash_bwd_dkdv_sum_kernel(float "
     "const*, __nv_bfloat16*, __nv_bfloat16*, unsigned long, int)",
     "flash_attention_bwd (ours)"),
    ("(anonymous namespace)::bwd_tc::d256::flash_bwd_dq_d256_kernel("
     "CUtensorMap_st, CUtensorMap_st, ...)", "flash_attention_bwd (ours)"),
    ("void (anonymous namespace)::rmsnorm_bwd_kernel<__nv_bfloat16, 960>("
     "__nv_bfloat16 const*, ...)", "rmsnorm_bwd (ours)"),
    ("void (anonymous namespace)::bwd::flash_bwd_dq_kernel<float, 64>("
     "float const*, ...)", "flash_attention_bwd (ours)"),
    ("void (anonymous namespace)::bwd::flash_bwd_delta_kernel<__nv_bfloat16, "
     "64>(__nv_bfloat16 const*, __nv_bfloat16 const*, float*, int)",
     "flash_attention_bwd (ours)"),
    ("void (anonymous namespace)::rmsnorm_bwd_kernel<__nv_bfloat16>("
     "__nv_bfloat16 const*, ...)", "rmsnorm_bwd (ours)"),
    ("void (anonymous namespace)::rmsnorm_dscale_kernel<float>(float const*, "
     "float*, int, int)", "rmsnorm_bwd (ours)"),
    ("void (anonymous namespace)::wkv6_kernel<__nv_bfloat16, float>(...)",
     "wkv6 (ours)"),
    ("void (anonymous namespace)::wkv6_update_kernel<float>(__nv_bfloat16 "
     "const*, __nv_bfloat16 const*, float const*, float*, float*, int, int)",
     "wkv6 (ours)"),
    ("(anonymous namespace)::wkv6_scan_kernel(float const*, float const*, "
     "float const*, float*, float*, int)", "wkv6 (ours)"),
    ("void (anonymous namespace)::wkv6_out_kernel<float>(__nv_bfloat16 "
     "const*, __nv_bfloat16 const*, __nv_bfloat16 const*, float const*, "
     "float const*, float const*, __nv_bfloat16*, int, int, int)",
     "wkv6 (ours)"),
    ("void (anonymous namespace)::wkv6_serial_kernel<float, float>(float "
     "const*, float const*, float const*, float const*, float const*, "
     "float const*, float*, float*, int, int)", "wkv6 (ours)"),
    ("void (anonymous namespace)::wkv6_serial_kernel<__nv_bfloat16, float, "
     "false>(__nv_bfloat16 const*, ...)", "wkv6 (ours)"),
    ("void (anonymous namespace)::wkv6_serial_kernel<__nv_bfloat16, float, "
     "true>(__nv_bfloat16 const*, ...)", "wkv6_bwd (ours)"),
    ("void (anonymous namespace)::wkv6_ckpt_kernel<__nv_bfloat16, float>("
     "__nv_bfloat16 const*, ...)", "wkv6_bwd (ours)"),
    ("void (anonymous namespace)::wkv6_bwd_rows_kernel<float, float>(float "
     "const*, ...)", "wkv6_bwd (ours)"),
    ("(anonymous namespace)::wkv6_du_kernel(float const*, float*, int, int)",
     "wkv6_bwd (ours)"),
    # the chunked forms: the backward's launches carry a template flag true
    ("void (anonymous namespace)::wkv6_scan_kernel<false, false>(float "
     "const*, float const*, float const*, float*, float*, int)",
     "wkv6 (ours)"),
    ("void (anonymous namespace)::wkv6_out_kernel<__nv_bfloat16, false>("
     "__nv_bfloat16 const*, ...)", "wkv6 (ours)"),
    ("void (anonymous namespace)::wkv6_bwd_update_kernel<float>("
     "__nv_bfloat16 const*, ...)", "wkv6_bwd (ours)"),
    ("void (anonymous namespace)::wkv6_scan_kernel<false, true>(float "
     "const*, float const*, float const*, float*, float*, int)",
     "wkv6_bwd (ours)"),
    ("void (anonymous namespace)::wkv6_scan_kernel<true, true>(float "
     "const*, float const*, float const*, float*, float*, int)",
     "wkv6_bwd (ours)"),
    ("void (anonymous namespace)::wkv6_out_kernel<float, true>("
     "__nv_bfloat16 const*, ...)", "wkv6_bwd (ours)"),
    ("void (anonymous namespace)::wkv6_bwd_chunk_kernel<float>("
     "__nv_bfloat16 const*, __nv_bfloat16 const*, ...)", "wkv6_bwd (ours)"),
    ("(anonymous namespace)::wkv6_du_kernel(float const*, float*, int, int, "
     "int)", "wkv6_bwd (ours)"),
])
def test_profile_labels_the_kernel_symbols(name, family):
    """The trace's kernel names (demangled, as the profiler shows them) land
    in the kernel families that profile_serve reports."""
    from repro_torch.launch.profile_serve import _family
    assert _family(name) == family


@pytest.mark.cuda
def test_profile_summary_agrees_with_the_event_tree(cuda_device):
    """``profile_summary`` reads the profiler's private raw event list; on
    one trace its family sums, kernel count and ranges equal those of the
    public event tree (``prof.events()``, a range's kernels being those of
    its CPU children), kernels outside any range and the backward's
    included."""
    from collections import defaultdict
    from repro_torch.launch.profile_serve import _family, profile_summary
    x = torch.randn(2, 256, 960, device=cuda_device, dtype=torch.bfloat16,
                    requires_grad=True)
    scale = torch.ones(960, device=cuda_device, dtype=torch.bfloat16)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        loss = 0
        for _ in range(3):
            with torch.profiler.record_function("step"):
                y = rmsnorm(x, scale)
                with torch.profiler.record_function("inner"):
                    y = y @ y.transpose(-1, -2)
            loss = loss + y.float().sum()
        loss.backward()
        torch.cuda.synchronize()
    got = profile_summary(prof, 1e3, ("step", "inner"))

    def under(e):
        return list(e.kernels) + [k for c in e.cpu_children for k in under(c)]
    fam, n = defaultdict(float), 0
    ranges = {r: {"device_ms": 0.0, "kernels": 0, "calls": 0}
              for r in ("step", "inner")}
    for e in prof.events():
        if e.is_user_annotation:
            if e.device_type == torch.autograd.DeviceType.CPU \
                    and e.name in ranges:
                ks = under(e)
                ranges[e.name]["device_ms"] += sum(k.duration for k in ks) / 1e3
                ranges[e.name]["kernels"] += len(ks)
                ranges[e.name]["calls"] += 1
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            fam[_family(e.name)] += e.device_time / 1e3
            n += 1
    assert got["device_events"] == n > 0
    assert set(got["by_family_ms"]) == set(fam)
    for f, ms in fam.items():
        assert got["by_family_ms"][f] == pytest.approx(ms, rel=1e-6, abs=1e-6)
    for r, want in ranges.items():
        assert want["calls"] == 3 and want["kernels"] > 0, r
        assert got["ranges"][r]["calls"] == want["calls"], r
        assert got["ranges"][r]["kernels"] == want["kernels"], r
        assert got["ranges"][r]["device_ms"] == pytest.approx(
            want["device_ms"], rel=1e-6, abs=1e-6), r


def test_build_rebuilds_when_a_shared_header_changes(tmp_path, monkeypatch):
    """A library is stale when missing or older than its source or any
    csrc/*.cuh (the kernels share hopper.cuh)."""
    import os
    from repro_torch.kernels import build
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    out.mkdir()
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    src, hdr, lib = csrc / "k.cu", csrc / "common.cuh", out / "libk.so"
    src.write_text("// source")
    hdr.write_text("// header")

    def at(path, t):
        os.utime(path, (t, t))
    at(src, 100)
    at(hdr, 100)
    assert build._stale("k")                  # no library yet
    lib.write_bytes(b"")
    at(lib, 200)
    assert not build._stale("k")
    at(hdr, 300)                              # header edited after the build
    assert build._stale("k")
    at(hdr, 100)
    at(src, 300)                              # source edited after the build
    assert build._stale("k")
    at(src, 100)
    (csrc / "other.cu").write_text("// another kernel's source")
    at(csrc / "other.cu", 400)                # not this library's source
    assert not build._stale("k")
