"""MoE layer of the PyTorch port vs the JAX ``MoEMLP``.

Inputs are made with numpy from a seed; the weights come from the JAX
layer's init and are carried across (router kernel [D, E] -> the f32
``router.weight`` [E, D], the expert stacks as they are).  Held at f32
atol/rtol 2e-5 (output and every gradient) and bf16 2e-2: with drops
at a capacity that overflows, drop-free over more than one chunk of
256 tokens (also against one unchunked block), and the load-balancing
value against the one the JAX layer sows.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.ops import moe as jmoe
from mpi_operator_tpu_torch.ops import moe as tmoe
from mpi_operator_tpu_torch.parallel.mesh import AXIS_NAMES

F32_TOL = 2e-5
BF16_TOL = 2e-2
DIM, FFN, E, K = 32, 64, 4, 2


def _x(b, s, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, DIM)).astype(np.float32)


def _jax_layer(dtype=jnp.float32, **kw):
    return jmoe.MoEMLP(dim=DIM, ffn_dim=FFN, n_experts=E, top_k=K,
                       dtype=dtype, **kw)


def _params(seed=1):
    """The JAX layer's init as numpy arrays."""
    variables = _jax_layer().init(jax.random.PRNGKey(seed),
                                  jnp.zeros((1, 4, DIM), jnp.float32))
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _port(params, dtype=torch.float32, store_dtype=None, **kw):
    layer = tmoe.MoEMLP(DIM, FFN, E, top_k=K, dtype=dtype,
                        store_dtype=store_dtype or torch.float32, **kw)
    with torch.no_grad():
        layer.router.weight.copy_(torch.from_numpy(
            params["router"]["kernel"].T.copy()))
        for name in ("w1", "w3", "w2"):
            getattr(layer, name).copy_(torch.from_numpy(
                np.array(params[name])))
    return layer


def _jax_apply(params, x, dtype=jnp.float32, **kw):
    """(output, sown load-balancing value)."""
    out, aux = _jax_layer(dtype, **kw).apply(
        {"params": params}, jnp.asarray(x), mutable=["losses"])
    (lb,) = aux["losses"]["load_balancing"]
    return np.asarray(out, np.float32), float(lb)


class _Unchunked(tmoe.MoEMLP):
    NO_DROP_CHUNK = 1 << 30


CASES = {
    # 2 x 24 tokens at capacity int(0.5 * 48 * 2 / 4) = 12 slots.
    "drops": dict(shape=(2, 24), kw=dict(capacity_factor=0.5),
                  no_drop=False),
    "capacity_1.25": dict(shape=(3, 20), kw={}, no_drop=False),
    "no_drop": dict(shape=(2, 40), kw={}, no_drop=True),
    # 300 tokens: two chunks of 256, the second padded by 212 rows.
    "no_drop_chunked": dict(shape=(2, 150), kw={}, no_drop=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_output_and_load_balancing_match_jax(case):
    c = CASES[case]
    params, x = _params(), _x(*c["shape"])
    want, want_lb = _jax_apply(params, x, no_drop=c["no_drop"], **c["kw"])
    layer = _port(params, **c["kw"])
    got = layer(torch.from_numpy(x), no_drop=c["no_drop"])
    np.testing.assert_allclose(got.detach().numpy(), want, atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(layer.load_balancing.item(), want_lb,
                               atol=F32_TOL, rtol=F32_TOL)


def test_drops_really_drop():
    """At capacity factor 0.5 some assignments overflow: those tokens'
    outputs differ from the drop-free ones (a dropped token keeps only
    its other expert, or gives zeros)."""
    params, x = _params(), torch.from_numpy(_x(2, 24))
    layer = _port(params, capacity_factor=0.5)
    dropped = layer(x, no_drop=False)
    free = layer(x, no_drop=True)
    differs = ((dropped - free).abs().amax(-1) > 1e-3).sum().item()
    assert 0 < differs < 48, differs


def test_no_drop_chunked_matches_unchunked():
    """The port of tests/test_ops.py::test_moe_no_drop_chunked_matches_
    unchunked: 300 tokens through chunks of 256 equal one block at
    capacity = 300."""
    params, x = _params(), torch.from_numpy(_x(2, 150, seed=2))
    chunked = _port(params)(x, no_drop=True)
    whole = _Unchunked(DIM, FFN, E, top_k=K, dtype=torch.float32)
    whole.load_state_dict(_port(params).state_dict())
    np.testing.assert_allclose(chunked.detach().numpy(),
                               whole(x, no_drop=True).detach().numpy(),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("no_drop", [False, True])
def test_bf16_matches_jax(store, no_drop):
    """bf16 compute over f32 params (training) or bf16-stored stacks
    (serving: the same rounding as flax's cast at use)."""
    params, x = _params(), _x(2, 24, seed=3)
    want, _ = _jax_apply(params, x, dtype=jnp.bfloat16, no_drop=no_drop)
    layer = _port(params, dtype=torch.bfloat16,
                  store_dtype={"f32": torch.float32,
                               "bf16": torch.bfloat16}[store])
    assert layer.router.weight.dtype == torch.float32
    got = layer(torch.from_numpy(x).bfloat16(), no_drop=no_drop)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("case", ["drops", "no_drop_chunked"])
def test_f32_gradients_match_jax(case):
    """Gradients of x and of every weight (router, w1, w3, w2) of
    sum(out * cotangent) against jax.grad of the JAX apply."""
    c = CASES[case]
    params, x = _params(), _x(*c["shape"], seed=4)
    ct = np.random.default_rng(5).standard_normal(x.shape).astype(
        np.float32)
    module = _jax_layer(no_drop=c["no_drop"], **c["kw"])

    def f(p, xx):
        return jnp.sum(module.apply({"params": p}, xx) * ct)

    gp, gx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    layer = _port(params, **c["kw"])
    tx = torch.from_numpy(x).requires_grad_()
    (layer(tx, no_drop=c["no_drop"]) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx),
                               atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(layer.router.weight.grad.numpy(),
                               np.asarray(gp["router"]["kernel"]).T,
                               atol=F32_TOL, rtol=F32_TOL)
    for name in ("w1", "w3", "w2"):
        np.testing.assert_allclose(getattr(layer, name).grad.numpy(),
                                   np.asarray(gp[name]), atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=name)


def test_expert_stack_init_is_truncated_lecun_normal():
    """std 1/sqrt(fan_in) within 2% and nothing past two of the normal's
    standard deviations, as flax's lecun_normal draws a stack."""
    w = torch.empty(4, 256, 512)
    tmoe.init_expert_stack_(w, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(w.std().item(), 1 / 16, rtol=2e-2)
    limit = 2 / 16 / 0.87962566103423978
    assert w.abs().max().item() <= limit * (1 + 1e-6)
    assert w.abs().max().item() > 0.95 * limit
    ref = np.asarray(jax.nn.initializers.lecun_normal(
        in_axis=-2, out_axis=-1, batch_axis=(0,))(
            jax.random.PRNGKey(0), (4, 256, 512), jnp.float32))
    np.testing.assert_allclose(w.std().item(), ref.std(), rtol=2e-2)


def test_mesh_raises_and_load_balancing_before_forward():
    # Over 'ep' MoE is not ported; anything but a DeviceMesh is refused.
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tmoe.MoEMLP(DIM, FFN, E, mesh=types.SimpleNamespace(
            mesh_dim_names=AXIS_NAMES, shape=(1, 1, 1, 2, 1, 1)))
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmoe.MoEMLP(DIM, FFN, E, mesh=object())
    assert tmoe.MoEMLP(DIM, FFN, E, device="cpu").load_balancing is None

