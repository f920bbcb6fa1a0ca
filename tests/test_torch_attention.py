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
import math
import types

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
# S = 200, 255, 257 and 1 are not multiples of the kernels' 64-row tiles;
# 255 and 257 sit on either side of two 128-row CTAs of the bf16 kernels.
CASES = [(128, True), (128, False), (80, True), (80, False), (200, True),
         (1, True), (255, True), (257, False)]
# bf16 sequence lengths of the card test: around the 64-row tiles of the
# ring and the 128-row tiles the CTAs of the forward and dq own.
CUDA_BF16_SEQS = (1, 63, 64, 65, 127, 128, 129, 200, 255, 256, 257, 383)


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
    # Under a mesh each rank holds its heads (tp is ported:
    # tests/test_torch_tensor_parallel.py) and sp runs the ring
    # (tests/test_torch_ring_attention.py), which refuses a sliding
    # window as the JAX model does; anything but a DeviceMesh is refused.
    from mpi_operator_tpu_torch.parallel.mesh import AXIS_NAMES
    with pytest.raises(NotImplementedError, match="sequence-parallel"):
        ta.attention(*_t(q, k, v), window=7, mesh=types.SimpleNamespace(
            mesh_dim_names=AXIS_NAMES, shape=(1, 1, 1, 1, 1, 2)))
    with pytest.raises(TypeError, match="DeviceMesh"):
        ta.attention(*_t(q, k, v), mesh=object())
    with pytest.raises(ValueError, match="causal"):
        ta.attention(*_t(q, k, v), causal=False, window=7)


# (device, dtype, head_dim, impl, route): "plain", "kernel", "pad" (the
# kernels at the next head_dim they take), or the ValueError raised on
# the card for an input the kernels cannot take.
ROUTES = [
    ("cpu", torch.bfloat16, 128, "auto", "plain"),
    ("cpu", torch.float32, 32, "pallas", "plain"),
    ("cpu", torch.float16, 16, "xla", "plain"),
    ("cuda", torch.bfloat16, 128, "auto", "kernel"),
    ("cuda", torch.float32, 64, "auto", "kernel"),
    ("cuda", torch.bfloat16, 64, "pallas", "kernel"),
    ("cuda", torch.float32, 128, "xla", "plain"),
    ("cuda", torch.bfloat16, 32, "auto", "pad"),
    ("cuda", torch.float32, 16, "auto", "pad"),
    ("cuda", torch.bfloat16, 96, "auto", "pad"),
    ("cuda", torch.float16, 128, "auto", ValueError),
    ("cuda", torch.bfloat16, 256, "auto", ValueError),
    ("cuda", torch.bfloat16, 32, "pallas", ValueError),
    ("cuda", torch.float32, 16, "pallas", ValueError),
    ("cuda", torch.float16, 64, "pallas", ValueError),
    ("cuda", torch.bfloat16, 16, "xla", "plain"),
]


@pytest.mark.parametrize("device,dtype,head_dim,impl,route", ROUTES)
def test_flash_route(device, dtype, head_dim, impl, route):
    """attention()'s choice of path, a pure function of what the input
    is: on the card 'auto' pads a small head_dim to the kernels (as the
    JAX 'auto' runs its kernel at any head_dim on a TPU), an explicit
    'pallas' takes only 64 and 128, and nothing falls back to the plain
    version."""
    if route is ValueError:
        with pytest.raises(ValueError, match="head_dim|bf16"):
            ta.flash_route(device, dtype, head_dim, impl)
    else:
        assert ta.flash_route(device, dtype, head_dim, impl) == route


def test_flash_route_refuses_bad_impl_and_device():
    with pytest.raises(ValueError, match="impl"):
        ta.flash_route("cuda", torch.bfloat16, 128, "triton")
    with pytest.raises(ValueError, match="device"):
        ta.flash_route("meta", torch.bfloat16, 128, "auto")


@pytest.mark.parametrize("head_dim", [16, 32])
def test_auto_head_dims_off_the_kernels_match_jax(head_dim):
    """attention(impl='auto') at a head_dim the kernels do not take as it
    is (the tiny training config's 32) equals the JAX
    attention(impl='auto') on the same inputs, causal, in f32."""
    rng = np.random.default_rng(head_dim)
    q, k, v = (rng.standard_normal((2, 24, 4, head_dim), dtype=np.float32)
               for _ in range(3))
    before = dict(ta.LAUNCHES)
    got = ta.attention(*_t(q, k, v), impl="auto")
    want = ja.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        impl="auto")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert ta.LAUNCHES == before


@pytest.mark.parametrize("head_dim,causal", [(16, True), (32, True),
                                             (32, False), (96, True)])
def test_padded_head_dim_matches_jax(head_dim, causal):
    """The padding that 'auto' applies on the card (zero columns up to the
    kernels' next head_dim, D's own scale, the first D columns kept), run
    here through the plain versions: output and dq, dk, dv equal the JAX
    attention at the unpadded head_dim, f32."""
    rng = np.random.default_rng(head_dim + causal)
    q, k, v, g = (rng.standard_normal((2, 3, 40, head_dim), dtype=np.float32)
                  for _ in range(4))
    tq, tk, tv = _t(q, k, v, grad=True)
    out = ta._flash_padded(tq, tk, tv, causal)
    assert out.shape == tq.shape
    (out * torch.from_numpy(g)).sum().backward()

    def loss(q, k, v):
        o = ja.attention(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                         v.transpose(0, 2, 1, 3), causal, impl="xla")
        return jnp.sum(o.transpose(0, 2, 1, 3) * jnp.asarray(g)), o

    (_, want), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                          has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(want).transpose(0, 2, 1, 3),
                               atol=F32_TOL, rtol=F32_TOL)
    for got, w in zip((tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


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
    causal and not, D 64 and 128; bf16 (the wgmma kernels) at every S of
    CUDA_BF16_SEQS, where the forward is also checked with its f32 output
    (the path of flash_attention_with_lse), f32 at S = 127 (a ragged last
    tile) and 256; plus the dlse path of flash_attention_with_lse.  Every
    case carries an lse cotangent, so dq and dk are not zero at S = 1."""
    fwd_tol, grad_tol = ((F32_TOL, GRAD_TOL) if dtype == torch.float32
                         else (2e-2, 5e-2))
    seqs = (127, 256) if dtype == torch.float32 else CUDA_BF16_SEQS
    for s in seqs:
        for d in (64, 128):
            for causal in (True, False):
                q, k, v, g = (torch.from_numpy(a).to(cuda_device, dtype)
                              for a in _inputs(s, seed=s + d, b=2, h=3, d=d))
                dlse = torch.from_numpy(np.random.default_rng(s).standard_normal(
                    (2, 3, s)).astype(np.float32)).to(cuda_device)
                scale = d ** -0.5
                before = dict(ta.LAUNCHES)
                out, lse = ta._flash_forward(q, k, v, scale, causal)
                dq, dk, dv = ta._flash_backward(q, k, v, out, lse, g, scale,
                                                causal, dlse=dlse)
                torch.cuda.synchronize(cuda_device)
                assert all(ta.LAUNCHES[n] == before[n] + 1
                           for n in ta.LAUNCHES)
                ref_out, ref_lse = ta._plain_forward(q, k, v, scale, causal)
                delta = (g.float() * out.float()).sum(-1) - dlse
                ref_dq = ta._torch_bwd_dq(q, k, v, g, ref_lse, delta, scale,
                                          causal)
                ref_dk, ref_dv = ta._torch_bwd_dkv(q, k, v, g, ref_lse,
                                                   delta, scale, causal)
                case = (s, d, causal)
                assert _head_rel_err(out, ref_out) <= fwd_tol, case
                assert (lse - ref_lse).abs().max().item() <= 1e-4, case
                if dtype == torch.bfloat16:
                    out32, lse32 = ta._flash_forward(q, k, v, scale, causal,
                                                     out_f32=True)
                    assert out32.dtype == torch.float32, case
                    assert _head_rel_err(out32, ref_out) <= fwd_tol, case
                    assert (lse32 - ref_lse).abs().max().item() <= 1e-4, case
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


@pytest.mark.cuda
def test_cuda_forward_is_deterministic(cuda_device):
    """K1' owns its output rows and uses no atomics: two calls on the same
    inputs give bit-identical out and lse, in bf16 (both output types),
    causal and not, D 64 and 128, at a ragged S."""
    for d in (64, 128):
        q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                   for a in _inputs(383, seed=5, b=2, h=3, d=d, n=3))
        for causal in (True, False):
            for out_f32 in (False, True):
                runs = [ta._flash_forward(q, k, v, d ** -0.5, causal,
                                          out_f32=out_f32)
                        for _ in range(2)]
                torch.cuda.synchronize(cuda_device)
                case = (d, causal, out_f32)
                assert torch.equal(runs[0][0], runs[1][0]), case
                assert torch.equal(runs[0][1], runs[1][1]), case


@pytest.mark.cuda
def test_cuda_backward_is_deterministic(cuda_device):
    """K2' and K3' own their output tiles and use no atomics: two calls on
    the same inputs give bit-identical dq, dk and dv, in bf16, causal and
    not, at a ragged S."""
    for causal in (True, False):
        q, k, v, g = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                      for a in _inputs(383, seed=7, b=2, h=3, d=128))
        scale = 128 ** -0.5
        out, lse = ta._flash_forward(q, k, v, scale, causal)
        delta = (g.float() * out.float()).sum(-1)
        runs = [(ta._cuda_bwd_dq(q, k, v, g, lse, delta, scale, causal),
                 *ta._cuda_bwd_dkv(q, k, v, g, lse, delta, scale, causal))
                for _ in range(2)]
        torch.cuda.synchronize(cuda_device)
        for first, second in zip(*runs):
            assert torch.equal(first, second), causal


@pytest.mark.cuda
def test_cuda_register_a_fault_is_caught(cuda_device, tmp_path):
    """A planted fault in the register A fragments of the bf16 kernels
    (the bf16 pairs of an accumulator packed with their two columns
    swapped), built from a copy of the source in a temporary directory,
    must fail the bf16 limit for the forward's out (P of P V) and for dq,
    dk and dv: the card test sees a wrong fragment order."""
    import ctypes
    import subprocess

    from mpi_operator_tpu_torch.ops import _build

    src = (_build.CSRC / "flash_attention.cu").read_text()
    good = "a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);"
    assert good in src
    bad = "a[kk][r] = pack_bf16(d[8 * kk + 2 * r + 1], d[8 * kk + 2 * r]);"
    path = tmp_path / "flash_attention.cu"
    path.write_text(src.replace(good, bad))
    lib = tmp_path / "libflash_attention_fault.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(path)], check=True, capture_output=True)
    q, k, v, g = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                  for a in _inputs(383, seed=11, b=2, h=3, d=128))
    scale = 128 ** -0.5
    out, lse = ta._flash_forward(q, k, v, scale, True)
    delta = (g.float() * out.float()).sum(-1)
    real = ta._bind()
    _build._libs["flash_attention"] = ctypes.CDLL(str(lib))
    try:
        bad_out, _ = ta._flash_forward(q, k, v, scale, True)
        dq = ta._cuda_bwd_dq(q, k, v, g, lse, delta, scale, True)
        dk, dv = ta._cuda_bwd_dkv(q, k, v, g, lse, delta, scale, True)
        torch.cuda.synchronize(cuda_device)
    finally:
        _build._libs["flash_attention"] = real
    ref_out, _ = ta._plain_forward(q, k, v, scale, True)
    assert _head_rel_err(bad_out, ref_out) > 2e-2
    ref_dq = ta._torch_bwd_dq(q, k, v, g, lse, delta, scale, True)
    ref_dk, ref_dv = ta._torch_bwd_dkv(q, k, v, g, lse, delta, scale, True)
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert _head_rel_err(got, want) > 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_auto_small_head_dim_pads_to_the_kernels(cuda_device, dtype):
    """On the card, attention(impl='auto') at head_dim 32 (the tiny
    training config's) launches K1' forward and K2'/K3' backward at
    head_dim 64, and its output and gradients match the plain version at
    head_dim 32; impl='pallas' refuses the same input."""
    fwd_tol, grad_tol = ((F32_TOL, GRAD_TOL) if dtype == torch.float32
                         else (2e-2, 5e-2))
    rng = np.random.default_rng(12)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (2, 40, 4, 32), dtype=np.float32)).to(cuda_device, dtype)
        for _ in range(4))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = dict(ta.LAUNCHES)
    got = ta.attention(q, k, v, impl="auto")
    (got.float() * g.float()).sum().backward()
    torch.cuda.synchronize(cuda_device)
    assert all(ta.LAUNCHES[n] == before[n] + 1 for n in ta.LAUNCHES)
    qp, kp, vp = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    want, _ = ta._torch_attention(qp, kp, vp, 1.0 / math.sqrt(32), True)
    (want.float() * g.transpose(1, 2).float()).sum().backward()
    assert _head_rel_err(got.transpose(1, 2), want) <= fwd_tol
    for x, xp in ((q, qp), (k, kp), (v, vp)):
        assert _head_rel_err(x.grad.transpose(1, 2), xp.grad) <= grad_tol
    with pytest.raises(ValueError, match="head_dim"):
        ta.attention(q, k, v, impl="pallas")
