"""The port's MNIST CNN (``mpi_operator_tpu_torch/models/mnist.py``)
against the JAX package's, on the same numpy inputs, with the flax
weights carried over by ``models.params.from_flax_mnist``: the forward
(1e-4; the flatten in (H, W, C) order that ``fc1`` reads), and Adam
steps through the port's ``build_train_step`` against the JAX package's
``build_train_step`` with ``optax.adam`` (``examples/mnist_train.py``'s
step): losses and parameters at 1e-5, save the elements whose gradient
came within rounding of zero at some step, which Adam's normalisation
(lr * m_hat / (sqrt(v_hat) + eps)) moves by up to lr a step whatever the
rounding; those are held to 3 lr, as tests/test_torch_train.py holds
its near-zero ones.  "Within rounding" is a non-zero gradient below
ROUNDING_REL of its tensor's largest: at this seed the two frameworks'
fc1 gradients differ by up to 8.9e-8 (the largest is 0.316 over the
steps), and 13 of fc1's 3,211,264 weights, each with a gradient of 2e-9
to 1.1e-7 at one step (exactly 0 at another), end up to 1.9e-4 apart.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from mpi_operator_tpu.models import mnist as jmnist
from mpi_operator_tpu.models.resnet import cross_entropy_loss
from mpi_operator_tpu.parallel import mesh as jmesh
from mpi_operator_tpu.parallel import train as jtrain
from mpi_operator_tpu_torch.models import mnist as tmnist
from mpi_operator_tpu_torch.models.params import from_flax_mnist
from mpi_operator_tpu_torch.models.resnet import (cross_entropy_loss as
                                                  port_xent)
from mpi_operator_tpu_torch.parallel import train as ttrain

LOGIT_TOL = 1e-4
STEP_TOL = 1e-5
LR = 1e-3
STEPS = 3
ROUNDING_REL = 1e-6


@functools.lru_cache(maxsize=None)
def jax_model():
    model = jmnist.MnistCNN()
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 28, 28, 1)))
    return model, params


def inputs(batch=8, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, (batch,)).astype(np.int32)
    return images, labels


def port_model(params):
    model = tmnist.MnistCNN(device="cpu")
    model.load_state_dict(from_flax_mnist(
        jax.tree_util.tree_map(np.asarray, params)))
    return model


def test_forward_matches_jax():
    model, params = jax_model()
    images, _ = inputs()
    want = jax.jit(model.apply)(params, jnp.asarray(images))
    port = port_model(params)
    got = port(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (8, 10)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_flax_weights_fill_every_tensor():
    _, params = jax_model()
    state = from_flax_mnist(jax.tree_util.tree_map(np.asarray, params))
    port = tmnist.MnistCNN(device="cpu")
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in port.state_dict().items()}
    # The inner tree converts the same.
    assert set(from_flax_mnist(params["params"])) == set(state)


def test_adam_steps_match_jax(steps=STEPS):
    model, params = jax_model()
    images, labels = inputs(seed=1)

    def loss_fn(p, batch):
        imgs, lbls = batch
        return cross_entropy_loss(model.apply(p, imgs), lbls)

    mesh = jmesh.create_mesh(jmesh.MeshConfig(dp=1),
                             devices=jax.devices()[:1])
    with mesh:
        init_fn, step_fn = jtrain.build_train_step(loss_fn, optax.adam(LR),
                                                   mesh, donate=False)
        state = init_fn(params)
        want = []
        for _ in range(steps):
            state, m = step_fn(state, (jnp.asarray(images),
                                       jnp.asarray(labels)))
            want.append(float(m["loss"]))
    want_state = from_flax_mnist(jax.tree_util.tree_map(
        np.asarray, state.params))

    port = port_model(params)
    init, step = ttrain.build_train_step(
        lambda m, b: port_xent(m(b[0]), b[1]), ttrain.adam(LR))
    tstate = init(port)
    batch = (torch.from_numpy(images), torch.from_numpy(labels))
    grads = {n: [] for n, _ in port.named_parameters()}
    got = []
    for _ in range(steps):
        got.append(step(tstate, batch)[1]["loss"].item())
        for n, p in port.named_parameters():
            grads[n].append(p.grad.clone())
    np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=STEP_TOL)
    sound, total = 0, 0
    for name, value in port.state_dict().items():
        ref = want_state[name]
        limit = ROUNDING_REL * max(g.abs().max().item() for g in grads[name])
        near_zero = torch.zeros_like(value, dtype=torch.bool)
        for g in grads[name]:
            near_zero |= (g != 0) & (g.abs() < limit)
        sound += (~near_zero).sum().item()
        total += value.numel()
        np.testing.assert_allclose(value[~near_zero].numpy(),
                                   ref[~near_zero].numpy(),
                                   rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=name)
        assert (value - ref).abs().max().item() <= 3 * LR, name
    assert sound / total > 0.99
