"""Fused RMSNorm, PyTorch port vs the JAX package.

The port's ``fused_rmsnorm`` / ``rmsnorm`` on CPU tensors (the plain
version of K5') are held against the JAX ``fused_rmsnorm`` in Pallas
interpret mode and against ``_xla_rmsnorm``, on the same numpy inputs:
forward at atol 1e-6 in f32 and 2e-2 in bf16, rstd at 1e-6, gradients
of x and scale through the custom VJPs at 1e-5 in f32 (tests/test_ops.py
holds the JAX kernel to 1e-5 forward and 1e-4 for gradients).  The CUDA
kernel itself is held against the plain version in the ``cuda``-marked
test, which runs only on a card: per row, the largest error over the
largest |plain output| within 2e-5 (f32) and 2e-2 (bf16).  Which of
K5''s two kernels a shape takes (``kernel_variant``) is a pure function,
tested here over every shape of the card test.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.ops.rmsnorm import _rmsnorm_forward as jax_forward
from mpi_operator_tpu.ops.rmsnorm import _xla_rmsnorm
from mpi_operator_tpu.ops.rmsnorm import fused_rmsnorm as jax_fused
from mpi_operator_tpu_torch.ops import fused_rmsnorm, rmsnorm

# The package re-exports the function ``rmsnorm`` under the module's name.
rn = importlib.import_module("mpi_operator_tpu_torch.ops.rmsnorm")

EPS = 1e-5
TOL = {np.float32: 1e-6, "bfloat16": 2e-2}

# Shapes of the card test: (shape, x dtype, scale dtype, the rows
# kernel's vectors per thread that kernel_variant gives, 0 for the
# two-pass kernel).  Rows of 8200, 16396 and 66 bytes are not a whole
# number of 16-byte vectors; 32768 bf16 is 4096 vectors, more than
# 256 x 8; 50,000 rows are far more than the persistent grid's CTAs.
CARD_CASES = [((2, 512, 4096), torch.bfloat16, torch.float32, 2),
              ((64, 4096), torch.float32, torch.float32, 4),
              ((8, 4096), torch.bfloat16, torch.float32, 2),
              ((64, 5120), torch.bfloat16, torch.float32, 4),
              ((16, 8192), torch.bfloat16, torch.float32, 4),
              ((4, 16384), torch.bfloat16, torch.float32, 8),
              ((300, 1024), torch.bfloat16, torch.bfloat16, 1),
              ((7, 2048), torch.float16, torch.float32, 1),
              ((50000, 4096), torch.bfloat16, torch.float32, 2),
              ((4, 32768), torch.bfloat16, torch.float32, 0),
              ((1003, 4100), torch.bfloat16, torch.bfloat16, 0),
              ((37, 4099), torch.float32, torch.float32, 0),
              ((5, 33), torch.float16, torch.float16, 0)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, dtype=np.float32)
    scale = (rng.standard_normal(shape[-1], dtype=np.float32) * 0.1
             + 1.0).astype(np.float32)
    return x, scale


def _jax(x, dtype):
    return jnp.asarray(x, dtype=dtype)


@pytest.mark.parametrize("shape", [(4, 96, 128), (3, 100, 64), (7, 33),
                                   (3, 5120), (2, 8192)],
                         ids=["test_ops", "block_150", "ragged", "d_5120",
                              "d_8192"])
def test_forward_matches_jax_kernel_and_xla_f32(shape):
    """(3, 100, 64) has 300 rows, so the JAX kernel's block drops to 150
    rows; (7, 33) to 7 rows of an odd width; d 5120 and 8192 are widths
    the card takes with 4 vectors a thread."""
    x, scale = _inputs(shape, 0)
    want_kernel, want_rstd = jax_forward(jnp.asarray(x), jnp.asarray(scale),
                                         EPS, True)
    want_xla = _xla_rmsnorm(jnp.asarray(x), jnp.asarray(scale), EPS)
    tx, ts = torch.from_numpy(x), torch.from_numpy(scale)
    got, rstd = rn._forward(tx, ts, EPS)
    for out in (got, fused_rmsnorm(tx, ts, EPS), rmsnorm(tx, ts, EPS),
                rmsnorm(tx, ts, EPS, impl="xla"),
                rmsnorm(tx, ts, EPS, impl="pallas")):
        np.testing.assert_allclose(out.numpy(), np.asarray(want_kernel),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(out.numpy(), np.asarray(want_xla),
                                   atol=1e-6, rtol=0)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(want_rstd),
                               rtol=1e-6, atol=0)
    assert rstd.shape == shape[:-1]


@pytest.mark.parametrize("scale_bf16", [False, True],
                         ids=["scale_f32", "scale_bf16"])
def test_forward_matches_jax_kernel_bf16(scale_bf16):
    x, scale = _inputs((4, 96, 128), 1)
    xj = _jax(x, jnp.bfloat16)
    sj = _jax(scale, jnp.bfloat16 if scale_bf16 else jnp.float32)
    want, _ = jax_forward(xj, sj, EPS, True)
    want = np.asarray(want.astype(jnp.float32))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    ts = torch.from_numpy(scale)
    if scale_bf16:
        ts = ts.to(torch.bfloat16)
    got = fused_rmsnorm(tx, ts, EPS)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)
    np.testing.assert_allclose(rmsnorm(tx, ts, EPS).float().numpy(),
                               np.asarray(_xla_rmsnorm(xj, sj, EPS).astype(
                                   jnp.float32)), atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_jax_custom_vjp(dtype):
    """loss = sum(y^2) through both custom VJPs (the JAX kernel in
    interpret mode), as tests/test_ops.py does for the JAX pair."""
    x, scale = _inputs((2, 64, 64), 2)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16

    def loss(xx, ss):
        return jnp.sum(jax_fused(xx, ss, EPS, True).astype(jnp.float32)
                       ** 2)

    gx, gs = jax.grad(loss, argnums=(0, 1))(_jax(x, jdt), jnp.asarray(scale))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    (fused_rmsnorm(tx, ts, EPS).float() ** 2).sum().backward()
    assert tx.grad.dtype == tdt and ts.grad.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(gx.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    # dscale sums 128 rows of products: its bf16 error grows with them.
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gs),
                               atol=tol, rtol=tol if tol < 1e-2 else 5e-2)


def test_dispatcher_and_cpu_never_launches():
    x, scale = _inputs((3, 32), 4)
    tx, ts = torch.from_numpy(x), torch.from_numpy(scale)
    before = dict(rn.LAUNCHES)
    for impl in ("auto", "pallas", "xla"):
        rmsnorm(tx, ts, impl=impl)
    fused_rmsnorm(tx, ts)
    assert rn.LAUNCHES == before
    with pytest.raises(ValueError, match="impl"):
        rmsnorm(tx, ts, impl="triton")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_rmsnorm(tx.to("meta"), ts.to("meta"))


@pytest.mark.parametrize("case", CARD_CASES,
                         ids=["x".join(map(str, c[0])) + "_" + str(c[1])[6:]
                              for c in CARD_CASES])
def test_kernel_variant_of_card_shapes(case):
    """The kernel each card-test shape takes, for the whole tensor and for
    the view one row in (as the card test launches both), from 256-byte
    aligned allocations; a misaligned x or y always takes the two-pass
    kernel."""
    shape, dtype, _, want = case
    d = shape[-1]
    size = torch.tensor([], dtype=dtype).element_size()
    assert rn.kernel_variant(d, size, 256, 512) == want
    assert rn.kernel_variant(d, size, 256 + d * size, 512) == want
    assert rn.kernel_variant(d, size, 8, 512) == 0
    assert rn.kernel_variant(d, size, 256, 520) == 0
    if want:
        assert d * size // 16 <= rn.ROW_THREADS * want
        assert want == 1 or d * size // 16 > rn.ROW_THREADS * want // 2


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card (K5' has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(cuda_device):
    """K5' against its plain version at every shape of CARD_CASES, each
    launch counted under the kernel kernel_variant names (both kernels
    run)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for shape, dtype, sdtype, vecs in CARD_CASES:
        base = torch.randn((shape[0] + 1,) + shape[1:], generator=gen,
                           device=cuda_device).to(dtype)
        scale = (torch.randn(shape[-1], generator=gen, device=cuda_device)
                 * 0.1 + 1.0).to(sdtype)
        # The whole tensor, and a view one row in (unaligned when the
        # row's bytes are not a multiple of 16).
        for x in (base[:shape[0]], base[1:]):
            before = rn.LAUNCHES["rmsnorm"]
            kernels = dict(rn.VARIANT_LAUNCHES)
            out, rstd = rn._forward(x, scale, EPS)
            torch.cuda.synchronize()
            assert rn.LAUNCHES["rmsnorm"] == before + 1
            kernels[("rows" if vecs else "two_pass")] += 1
            assert rn.VARIANT_LAUNCHES == kernels, (shape, dtype)
            ref, ref_rstd = rn._plain_forward(x, scale, EPS)
            d = shape[-1]
            o, r = out.float().view(-1, d), ref.float().view(-1, d)
            rel = ((o - r).abs().amax(-1) / r.abs().amax(-1)).max().item()
            tol = 2e-5 if dtype == torch.float32 else 2e-2
            assert rel <= tol, (shape, dtype, rel)
            torch.testing.assert_close(rstd, ref_rstd, rtol=2e-5, atol=0)
    before = rn.LAUNCHES["rmsnorm"]
    rmsnorm(base, scale)
    assert rn.LAUNCHES["rmsnorm"] == before + 1
    rmsnorm(base, scale, impl="xla")
    assert rn.LAUNCHES["rmsnorm"] == before + 1
