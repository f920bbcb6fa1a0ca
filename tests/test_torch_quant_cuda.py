"""``QuantLinear`` rounds its output once, on the CPU and on the card.

The JAX ``QuantDenseGeneral`` takes the f32 product of the activation
(cast to ``dtype``) and the int8 weight, scales it and rounds once to
``dtype``.  Each element of ``QuantLinear``'s output must lie within one
rounding of the exact (f64) scaled product: |out - ref| <= 2^-8 |ref|
(bf16's unit roundoff; 2^-24 in f32) plus 1e-5 max|ref| for the order of
the f32 sums.  A product rounded to bf16 before the scale (two
roundings) must break that bound: the check has the power to see it.
The card cases are marked ``cuda`` and skip here; this file imports no
JAX, so it runs on a machine without flax.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mpi_operator_tpu_torch.models.quant import QuantLinear

UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -24}


def _layer(n_in, n_out, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    layer = QuantLinear(n_in, n_out, dtype, device=device)
    layer.weight.copy_(torch.as_tensor(
        rng.integers(-127, 128, (n_out, n_in)), dtype=torch.int8))
    layer.scale.copy_(torch.as_tensor(
        rng.uniform(1e-4, 2e-3, n_out), dtype=torch.float32))
    x = torch.as_tensor(rng.normal(size=(3, 5, n_in)),
                        dtype=torch.float32).to(device)
    return layer, x


def _excess(out, layer, x, dtype):
    """Largest |out - ref| beyond the one-rounding bound, over max|ref|
    (<= 0 when every element is within it)."""
    ref = (x.to(dtype).double().cpu()
           @ layer.weight.double().cpu().T) * layer.scale.double().cpu()
    err = (out.double().cpu() - ref).abs()
    bound = UNIT_ROUNDOFF[dtype] * ref.abs() + 1e-5 * ref.abs().max()
    return ((err - bound).max() / ref.abs().max()).item()


def _two_roundings(layer, x, dtype):
    """The product rounded to ``dtype`` first, then scaled and rounded."""
    out = F.linear(x.to(dtype), layer.weight.to(dtype)).float()
    return (out * layer.scale).to(dtype)


def _check(device, n_in, n_out, dtype):
    layer, x = _layer(n_in, n_out, dtype, device)
    with torch.no_grad():
        out = layer(x)
        assert out.dtype == dtype and out.shape == (3, 5, n_out)
        assert _excess(out, layer, x, dtype) <= 0.0
        if dtype == torch.bfloat16:
            assert _excess(_two_roundings(layer, x, dtype), layer, x,
                           dtype) > 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_quant_linear_rounds_once_on_cpu(dtype):
    _check("cpu", 256, 384, dtype)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_quant_linear_rounds_once_on_the_card(cuda_device, dtype):
    """At the 7B's FFN width: [15, 4096] x [11008, 4096]."""
    _check(cuda_device, 4096, 11008, dtype)
