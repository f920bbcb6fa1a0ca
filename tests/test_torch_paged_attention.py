"""Paged decode attention, PyTorch port vs the JAX package.

The port's ``paged_decode_attention`` on CPU tensors (its plain version)
is held against the JAX function with ``impl="xla"`` and, where the JAX
kernel supports the case, ``impl="pallas", interpret=True`` — the same
numpy inputs through both.  Tolerances as in tests/test_ops.py: 2e-5 in
f32, 2e-2 for a bf16 pool.  The CUDA kernel itself is held against the
plain version in the ``cuda``-marked tests, which run only on a card;
there the tolerance scales with each (row, query head)'s largest output,
which shrinks as rows grow long.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.ops.paged_attention import (
    paged_decode_attention as jax_paged)
from mpi_operator_tpu_torch.models.llama import quantize_kv
from mpi_operator_tpu_torch.ops import paged_attention as pa

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _inputs(b, h, kh, d, page, maxb, seed=0, idle_rows=()):
    """q, pools and a table of disjoint random blocks (block 0 is the
    scratch block; ``idle_rows`` map only it), as numpy f32/int32."""
    rng = np.random.default_rng(seed)
    nb = 1 + b * maxb
    q = rng.standard_normal((b, h, d), dtype=np.float32)
    pk = rng.standard_normal((nb, page, kh, d), dtype=np.float32)
    pv = rng.standard_normal((nb, page, kh, d), dtype=np.float32)
    table = (1 + rng.permutation(b * maxb).reshape(b, maxb)).astype(np.int32)
    for row in idle_rows:
        table[row] = 0
    return q, pk, pv, table


def _port(q, pk, pv, table, lengths, dtype=torch.float32, **kw):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = pa.paged_decode_attention(
        t(q).to(dtype), t(pk).to(dtype), t(pv).to(dtype), t(table),
        torch.tensor(lengths, dtype=torch.int32), **kw)
    return out.float().numpy()


def _jax(q, pk, pv, table, lengths, impl, dtype=jnp.float32, **kw):
    extra = {"interpret": True} if impl == "pallas" else {}
    out = jax_paged(jnp.asarray(q, dtype), jnp.asarray(pk, dtype),
                    jnp.asarray(pv, dtype), jnp.asarray(table),
                    jnp.asarray(lengths, jnp.int32), impl=impl, **extra,
                    **kw)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("h,kh", [(8, 2), (4, 4), (8, 1)])
def test_matches_jax_gqa(h, kh, impl):
    """Nine rows in one call: lengths at, inside and across page
    boundaries, as tests/test_ops.py's three length sets."""
    q, pk, pv, table = _inputs(9, h, kh, 64, 16, 4)
    lens = [1, 17, 64, 16, 32, 5, 64, 15, 48]
    np.testing.assert_allclose(
        _port(q, pk, pv, table, lens),
        _jax(q, pk, pv, table, lens, impl), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_garbage_in_dead_blocks_is_ignored(impl):
    """Tokens at/past each row's length must not reach the output,
    whatever the pool holds there."""
    q, pk, pv, table = _inputs(2, 4, 2, 64, 8, 3, seed=1)
    lens = [9, 3]
    clean = _jax(q, pk, pv, table, lens, "xla")
    for row, length in enumerate(lens):
        for j in range(table.shape[1]):
            start = max(0, length - j * 8)
            pk[table[row, j], start:] = 1e4
            pv[table[row, j], start:] = 1e4
    np.testing.assert_allclose(_port(q, pk, pv, table, lens), clean,
                               atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(_jax(q, pk, pv, table, lens, impl), clean,
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bf16_pool(impl):
    q, pk, pv, table = _inputs(2, 8, 4, 128, 16, 4, seed=3)
    lens = [33, 64]
    np.testing.assert_allclose(
        _port(q, pk, pv, table, lens, dtype=torch.bfloat16),
        _jax(q, pk, pv, table, lens, impl, dtype=jnp.bfloat16),
        atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_int8_pool_with_scales(impl):
    """int8 pools quantized by the port's quantize_kv, scales [NB, page,
    KH] f32: the same int8 values and scales through both packages."""
    q, pk, pv, table = _inputs(3, 8, 2, 64, 16, 4, seed=4)
    k8, ks = quantize_kv(torch.from_numpy(pk))
    v8, vs = quantize_kv(torch.from_numpy(pv))
    lens = [1, 40, 64]
    tq = torch.from_numpy(q)
    out = pa.paged_decode_attention(
        tq, k8, v8, torch.from_numpy(table),
        torch.tensor(lens, dtype=torch.int32), k_scale=ks, v_scale=vs)
    extra = {"interpret": True} if impl == "pallas" else {}
    ref = jax_paged(jnp.asarray(q), jnp.asarray(k8.numpy()),
                    jnp.asarray(v8.numpy()), jnp.asarray(table),
                    jnp.asarray(lens, jnp.int32), impl=impl,
                    k_scale=jnp.asarray(ks.numpy()),
                    v_scale=jnp.asarray(vs.numpy()), **extra)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("window", [1, 5, 20, 100])
def test_sliding_window(window):
    """The JAX kernel has no window (its dispatcher falls back to XLA),
    so the window is held against impl='xla'."""
    q, pk, pv, table = _inputs(3, 8, 2, 64, 16, 4, seed=5)
    lens = [1, 37, 64]
    np.testing.assert_allclose(
        _port(q, pk, pv, table, lens, window=window),
        _jax(q, pk, pv, table, lens, "xla", window=window),
        atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_idle_row_longer_than_table(impl):
    """A retired slot keeps ticking: its length runs past MAXB*page while
    its table row maps only the scratch block.  Live rows are
    unaffected and the idle row attends the whole (scratch) span."""
    q, pk, pv, table = _inputs(3, 8, 2, 64, 16, 4, seed=6, idle_rows=(2,))
    lens = [17, 64, 5000]
    np.testing.assert_allclose(
        _port(q, pk, pv, table, lens),
        _jax(q, pk, pv, table, lens, impl), atol=F32_TOL, rtol=F32_TOL)


def test_rejects_bad_gqa_and_half_scales():
    q, pk, pv, table = _inputs(2, 6, 4, 64, 8, 2)
    t = torch.from_numpy
    lens = torch.tensor([1, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        pa.paged_decode_attention(t(q), t(pk), t(pv), t(table), lens)
    q, pk, pv, table = _inputs(2, 8, 4, 64, 8, 2)
    with pytest.raises(ValueError, match="together"):
        pa.paged_decode_attention(t(q), t(pk), t(pv), t(table), lens,
                                  k_scale=torch.ones(pk.shape[:3]))


def test_cpu_never_launches_and_other_devices_raise():
    """CPU tensors take the plain version (no launch is counted); any
    device other than cpu/cuda is refused."""
    q, pk, pv, table = _inputs(2, 4, 2, 64, 8, 2)
    before = pa.LAUNCHES
    _port(q, pk, pv, table, [3, 9])
    assert pa.LAUNCHES == before
    meta = lambda a: torch.from_numpy(a).to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="device"):
        pa.paged_decode_attention(meta(q), meta(pk), meta(pv), meta(table),
                                  torch.zeros(2, dtype=torch.int32,
                                              device="meta"))


def _head_rel_err(out, ref) -> float:
    """max over (row, query head) of max_d |out - ref| / max_d |ref|."""
    o, r = out.float(), ref.float()
    err = (o - r).abs().amax(dim=-1)
    mag = r.abs().amax(dim=-1).clamp_min(torch.finfo(torch.float32).tiny)
    return (err / mag).max().item()


def _card_case(device, h, kh, d, page, maxb, dtype, lens, int8=False,
               window=None):
    """(kernel output, plain output) for one case on ``device``."""
    q, pk, pv, table = _inputs(3, h, kh, d, page, maxb, idle_rows=(2,))
    dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    tq, tk, tv = dev(q).to(dtype), dev(pk).to(dtype), dev(pv).to(dtype)
    ks = vs = None
    if int8:
        tk, ks = quantize_kv(tk)
        tv, vs = quantize_kv(tv)
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    before = pa.LAUNCHES
    out = pa.paged_decode_attention(tq, tk, tv, dev(table), lengths,
                                    k_scale=ks, v_scale=vs, window=window)
    torch.cuda.synchronize(device)
    assert pa.LAUNCHES == before + 1
    ref = pa._torch_paged(tq, tk, tv, dev(table), lengths, 1.0 / d ** 0.5,
                          k_scale=ks, v_scale=vs, window=window)
    return out, ref


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(cuda_device):
    """K4' on the card against _torch_paged on the same card inputs: f32
    (2e-5), bf16 and f16 (2e-2), int8 with scales, a window, GQA and an
    idle row past the end of its table.  Each tolerance bounds a (row,
    query head)'s largest error relative to its largest output."""
    cases = [
        # h, kh, d, page, maxb, dtype, lens, int8, window, tol
        (8, 2, 64, 16, 4, torch.float32, [1, 17, 5000], False, None,
         F32_TOL),
        (32, 32, 128, 16, 64, torch.bfloat16, [1000, 3, 9999], False, None,
         BF16_TOL),
        (32, 8, 128, 16, 64, torch.bfloat16, [1024, 77, 6000], False, None,
         BF16_TOL),
        (16, 2, 256, 32, 8, torch.float16, [200, 77, 1], False, None,
         BF16_TOL),
        (32, 32, 128, 16, 64, torch.bfloat16, [1000, 3, 9999], True, None,
         BF16_TOL),
        (8, 2, 64, 8, 16, torch.float32, [100, 37, 128], False, 20,
         F32_TOL),
    ]
    for h, kh, d, page, maxb, dtype, lens, int8, window, tol in cases:
        out, ref = _card_case(cuda_device, h, kh, d, page, maxb, dtype, lens,
                              int8=int8, window=window)
        assert _head_rel_err(out, ref) <= tol, (h, kh, d, dtype, int8)


@pytest.mark.cuda
def test_cuda_kernel_on_each_device(cuda_device):
    """Tensors on card i launch on card i even when another card is the
    current one, and the current device is left as it was."""
    count = torch.cuda.device_count()
    for i in range(count):
        other = (i + 1) % count
        with torch.cuda.device(other):
            out, ref = _card_case(torch.device("cuda", i), 32, 8, 128, 16,
                                  64, torch.bfloat16, [1024, 77, 6000])
            assert torch.cuda.current_device() == other
        assert out.device == torch.device("cuda", i)
        assert _head_rel_err(out, ref) <= BF16_TOL
