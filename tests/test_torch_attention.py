"""Flash attention, PyTorch port vs the JAX package.

The port's ``_flash_forward`` / autograd functions on CPU tensors (their
plain versions) are held against the JAX ``flash_attention`` /
``flash_attention_with_lse`` in Pallas interpret mode and against
``_xla_attention``, on the same numpy inputs: out and lse at 2e-5 in
f32, dq/dk/dv at 5e-4 (tests/test_ops.py).  The CUDA kernels K1'-K3' are
held against the plain versions in the ``cuda``-marked tests, which run
only on a card: per (batch*head), the largest error over the largest
|plain value| is at most 2e-2 forward and 5e-2 for gradients in bf16
(dS = P o (dP - delta) cancels), 2e-5 and 5e-4 in f32.  This file
imports jax but not flax, so it also runs on a machine without flax.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The packages' ops/__init__ re-export functions named like the modules.
ja = importlib.import_module("mpi_operator_tpu.ops.attention")
ta = importlib.import_module("mpi_operator_tpu_torch.ops.attention")

F32_TOL = 2e-5
GRAD_TOL = 5e-4
CASES = [(128, True), (128, False), (80, True), (80, False)]


def _inputs(s, seed=0, b=1, h=2, d=64, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d), dtype=np.float32)
            for _ in range(n)]


def _t(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("s,causal", CASES)
def test_forward_matches_jax(s, causal):
    q, k, v = _inputs(s, n=3)
    scale = 1.0 / 8.0
    out, lse = ta._flash_forward(*_t(q, k, v), scale, causal)
    jout, jlse = ja._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), scale, causal, 512, 512,
                                   True)
    xout, xlse = ja._xla_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), scale, causal)
    for want_out, want_lse in ((jout, jlse), (xout, xlse)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                                   atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                                   atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("s,causal", CASES)
def test_grads_match_jax(s, causal):
    """dq, dk, dv through the autograd function (delta computed outside
    the backward, as in JAX) against jax.grad of the interpret-mode
    kernels."""
    q, k, v, g = _inputs(s, seed=1)
    tq, tk, tv = _t(q, k, v, grad=True)
    (ta.flash_attention(tq, tk, tv, None, causal)
     * torch.from_numpy(g)).sum().backward()

    def loss(q, k, v):
        out = ja.flash_attention(q, k, v, None, causal, 512, 512, True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("use_out", [True, False])
def test_with_lse_dlse_path_matches_jax(use_out):
    """flash_attention_with_lse: f32 out and lse, a cotangent on lse
    (folded into delta); with ``use_out=False`` only lse is used, so the
    out cotangent is absent and counts as zero."""
    q, k, v, g = _inputs(80, seed=2)
    gl = np.random.default_rng(3).standard_normal((1, 2, 80)).astype(
        np.float32)
    tq, tk, tv = _t(q, k, v, grad=True)
    out, lse = ta.flash_attention_with_lse(tq, tk, tv, None, True)
    assert out.dtype == lse.dtype == torch.float32
    loss = (lse * torch.from_numpy(gl)).sum()
    if use_out:
        loss = loss + (out * torch.from_numpy(g)).sum()
    loss.backward()

    def jloss(q, k, v):
        out, lse = ja.flash_attention_with_lse(q, k, v, None, True, 512, 512,
                                               True)
        total = jnp.sum(lse * jnp.asarray(gl))
        return total + jnp.sum(out * jnp.asarray(g)) if use_out else total

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_dispatcher_layout_window_and_refusals():
    """attention() on [B, S, H, D]: causal against JAX's, a window takes
    the plain version (no kernel launch on any device), an explicit
    'pallas' window and a mesh are refused, and the CPU launches
    nothing."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 40, 4, 64), dtype=np.float32)
               for _ in range(3))
    before = dict(ta.LAUNCHES)
    for window in (None, 7):
        for impl in ("auto", "pallas", "xla"):
            if window is not None and impl == "pallas":
                with pytest.raises(ValueError, match="banded"):
                    ta.attention(*_t(q, k, v), impl=impl, window=window)
                continue
            got = ta.attention(*_t(q, k, v), impl=impl, window=window)
            want = ja.attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), impl="xla", window=window)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=F32_TOL, rtol=F32_TOL)
    assert ta.LAUNCHES == before
    with pytest.raises(NotImplementedError, match="queue 3"):
        ta.attention(*_t(q, k, v), mesh=object())
    with pytest.raises(ValueError, match="causal"):
        ta.attention(*_t(q, k, v), causal=False, window=7)


# -- on the card ----------------------------------------------------------------

def _head_rel_err(out, ref) -> float:
    """max over (batch, head) of max |out - ref| / max |ref|."""
    o, r = out.float().flatten(2), ref.float().flatten(2)
    err = (o - r).abs().amax(dim=-1)
    mag = r.abs().amax(dim=-1).clamp_min(torch.finfo(torch.float32).tiny)
    return (err / mag).max().item()


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_kernels_match_plain_version(cuda_device, dtype):
    """K1', K2', K3' against the plain versions on the same card inputs,
    causal and not, D 64 and 128, S = 127 (a ragged last tile) and 256,
    plus the dlse path of flash_attention_with_lse."""
    fwd_tol, grad_tol = ((F32_TOL, GRAD_TOL) if dtype == torch.float32
                         else (2e-2, 5e-2))
    for s in (127, 256):
        for d in (64, 128):
            for causal in (True, False):
                q, k, v, g = (torch.from_numpy(a).to(cuda_device, dtype)
                              for a in _inputs(s, seed=s + d, b=2, h=3, d=d))
                scale = d ** -0.5
                before = dict(ta.LAUNCHES)
                out, lse = ta._flash_forward(q, k, v, scale, causal)
                dq, dk, dv = ta._flash_backward(q, k, v, out, lse, g, scale,
                                                causal)
                torch.cuda.synchronize(cuda_device)
                assert all(ta.LAUNCHES[n] == before[n] + 1
                           for n in ta.LAUNCHES)
                ref_out, ref_lse = ta._plain_forward(q, k, v, scale, causal)
                delta = (g.float() * out.float()).sum(-1)
                ref_dq = ta._torch_bwd_dq(q, k, v, g, ref_lse, delta, scale,
                                          causal)
                ref_dk, ref_dv = ta._torch_bwd_dkv(q, k, v, g, ref_lse,
                                                   delta, scale, causal)
                case = (s, d, causal)
                assert _head_rel_err(out, ref_out) <= fwd_tol, case
                assert (lse - ref_lse).abs().max().item() <= 1e-4, case
                for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
                    assert _head_rel_err(got, want) <= grad_tol, case
    # dlse: gradients of sum(out*g) + sum(lse*gl) against autograd
    # through the plain version.
    q, k, v, g = (torch.from_numpy(a).to(cuda_device, dtype)
                  for a in _inputs(127, seed=9, b=1, h=2, d=128))
    gl = torch.randn(1, 2, 127, device=cuda_device)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = ta.flash_attention_with_lse(*leaves, None, True)
    ((out * g.float()).sum() + (lse * gl).sum()).backward()
    plain = [x.clone().float().requires_grad_() for x in (q, k, v)]
    pout, plse = ta._plain_forward(*plain, 128 ** -0.5, True)
    ((pout * g.float()).sum() + (plse * gl).sum()).backward()
    for got, want in zip(leaves, plain):
        assert _head_rel_err(got.grad, want.grad) <= grad_tol
