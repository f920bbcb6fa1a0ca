"""The port's ResNet (``mpi_operator_tpu_torch/models/resnet.py``) against
the JAX package's, on the same numpy inputs, with the flax weights
carried over by ``models.params.from_flax_resnet``.

Held (ROADMAP.md's parity rules): flax's "SAME" padding at an even and
an odd size (32 and 33) for the 7x7 stride-2 stem, a first block's 3x3
stride-2 conv and the 3x3 stride-2 max-pool; a tiny ResNet's train-mode
logits (1e-4) and updated ``batch_stats``, its eval-mode logits; three
SGD-momentum steps against JAX's ``value_and_grad`` step of
``examples/resnet_benchmark.py`` (losses, parameters and
``batch_stats`` at 1e-5); the bf16 config at 2e-2; and dp = 2 over gloo
(real processes from ``tests/torch_dist_worker.py``) against JAX's step
on the whole global batch, where a planted BatchNorm with local
statistics must fail the bound.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from jax import lax

from mpi_operator_tpu.models import resnet as jres
from mpi_operator_tpu_torch.models import resnet as tres
from mpi_operator_tpu_torch.models.params import from_flax_resnet
from mpi_operator_tpu_torch.parallel import train as ttrain

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import results, run_scenario  # noqa: E402
from test_torch_distributed import join  # noqa: E402

LOGIT_TOL = 1e-4
STEP_TOL = 1e-5
BF16_TOL = 2e-2
LR, MOMENTUM = 0.01, 0.9
STEPS = 3
DEADLINE_S = 120


def tiny(dtype=jnp.float32, **kw):
    return jres.ResNetConfig(stage_sizes=(1, 1, 1, 1), num_classes=10,
                             width=8, dtype=dtype, **kw)


def tiny_torch(dtype=torch.float32):
    return tres.ResNetConfig(stage_sizes=(1, 1, 1, 1), num_classes=10,
                             width=8, dtype=dtype)


def inputs(batch, size, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (batch,)).astype(np.int32)
    return images, labels


@functools.lru_cache(maxsize=None)
def jax_model(dtype=jnp.float32):
    """The tiny JAX ResNet and its variables (which fit any image size),
    every leaf moved by up to 0.1 so that the statistics and the bn3
    scales are not trivial; jitted and made once per dtype (op by op,
    ``init`` takes half a minute on the CPU)."""
    model = jres.ResNet(tiny(dtype))

    @jax.jit
    def init(key):
        variables = model.init(key, jnp.zeros((1, 8, 8, 3)), train=False)
        leaves, tree = jax.tree_util.tree_flatten(variables)
        keys = jax.random.split(jax.random.fold_in(key, 1), len(leaves))
        return jax.tree_util.tree_unflatten(tree, [
            x + 0.1 * jax.random.uniform(k, x.shape, x.dtype)
            for k, x in zip(keys, leaves)])

    return model, init(jax.random.PRNGKey(1))


def torch_model(variables, cfg, **kw):
    model = tres.ResNet(cfg, device="cpu", **kw)
    model.load_state_dict(from_flax_resnet(
        jax.tree_util.tree_map(np.asarray, variables), cfg))
    return model


def stats_of(model):
    return {k: v for k, v in model.state_dict().items()
            if k.endswith(".mean") or k.endswith(".var")}


def flax_stats(batch_stats):
    return {k: v for k, v in from_flax_resnet(
        {"params": {}, "batch_stats": jax.tree_util.tree_map(
            np.asarray, batch_stats)}).items()}


def jax_steps(model, variables, images, labels, steps=STEPS):
    """``steps`` steps of examples/resnet_benchmark.py's train_step."""
    tx = optax.sgd(LR, momentum=MOMENTUM)
    params, batch_stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)

    @jax.jit
    def train_step(params, batch_stats, opt_state, images, labels):
        def loss_fn(p):
            logits, updates = model.apply(
                {"params": p, "batch_stats": batch_stats}, images,
                train=True, mutable=["batch_stats"])
            return (jres.cross_entropy_loss(logits, labels),
                    updates["batch_stats"])
        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, new_opt = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, new_opt, loss

    losses = []
    for _ in range(steps):
        params, batch_stats, opt_state, loss = train_step(
            params, batch_stats, opt_state, jnp.asarray(images),
            jnp.asarray(labels))
        losses.append(float(loss))
    state = from_flax_resnet(jax.tree_util.tree_map(
        np.asarray, {"params": params, "batch_stats": batch_stats}))
    return losses, state


def jax_apply(model, variables, images, train):
    """The JAX model's forward, jitted (op by op it takes tens of
    seconds on the CPU)."""
    if train:
        fn = jax.jit(lambda v, x: model.apply(v, x, train=True,
                                              mutable=["batch_stats"]))
    else:
        fn = jax.jit(lambda v, x: model.apply(v, x, train=False))
    return fn(variables, jnp.asarray(images))


def port_loss(model, batch):
    images, labels = batch
    return tres.cross_entropy_loss(model(images), labels)


def assert_state_close(got, want, tol=STEP_TOL):
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   rtol=tol, atol=tol, err_msg=name)


# -- padding --------------------------------------------------------------------

@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("kernel,stride", [(7, 2), (3, 2), (1, 2), (3, 1),
                                           (5, 1)])
def test_same_pads_match_lax(size, kernel, stride):
    want = lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]
    assert tres.same_pads(size, kernel, stride) == tuple(want)


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("layer", ["stem", "block_conv2", "max_pool"])
def test_same_padding_layers_match_flax(size, layer):
    rng = np.random.default_rng(size)
    channels = 3 if layer == "stem" else 8
    x = rng.standard_normal((2, size, size, channels)).astype(np.float32)
    if layer == "max_pool":
        want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                            padding="SAME")
        got = tres.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2),
                                 3, 2)
        naive = torch.nn.functional.max_pool2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, padding=1)
    else:
        kernel = 7 if layer == "stem" else 3
        conv = fnn.Conv(8, (kernel, kernel), strides=(2, 2), use_bias=False)
        params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
        want = conv.apply(params, jnp.asarray(x))
        port = tres.Conv(channels, 8, kernel, 2)
        weight = np.array(params["params"]["kernel"]).transpose(3, 2, 0, 1)
        with torch.no_grad():
            port.weight.copy_(torch.from_numpy(weight))
        nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = port(nchw)
        naive = torch.nn.functional.conv2d(nchw, port.weight, stride=2,
                                           padding=kernel // 2)
    want = np.asarray(want).transpose(0, 3, 1, 2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    if size % 2 == 0:
        # torch's symmetric padding shifts the windows at an even size.
        assert np.abs(naive.detach().numpy() - want).max() > 1e-2


# -- forward, statistics, steps -------------------------------------------------

@pytest.mark.parametrize("size", [32, 33])
def test_train_and_eval_logits_and_batch_stats_match_jax(size):
    model, variables = jax_model()
    images, _ = inputs(4, size)
    want, updates = jax_apply(model, variables, images, train=True)
    # Eval mode reads the running statistics, here the updated ones.
    want_eval = jax_apply(model, {"params": variables["params"],
                                  "batch_stats": updates["batch_stats"]},
                          images, train=False)
    port = torch_model(variables, tiny_torch())
    port.train()
    got = port(torch.from_numpy(images))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert_state_close(stats_of(port), flax_stats(updates["batch_stats"]))
    port.eval()
    got_eval = port(torch.from_numpy(images))
    np.testing.assert_allclose(got_eval.detach().numpy(),
                               np.asarray(want_eval), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    # ... and leaves them alone.
    assert_state_close(stats_of(port), flax_stats(updates["batch_stats"]))


def test_carried_weights_fill_every_tensor_and_bn3_starts_at_zero():
    _, variables = jax_model()
    state = from_flax_resnet(jax.tree_util.tree_map(np.asarray, variables),
                             tiny_torch())
    port = tres.ResNet(tiny_torch(), device="cpu")
    assert set(state) == set(port.state_dict())
    for name, value in port.state_dict().items():
        assert tuple(value.shape) == tuple(state[name].shape), name
    tres.init_weights_(port, torch.Generator().manual_seed(0))
    for name, value in port.state_dict().items():
        if name.endswith("bn3.scale"):
            assert not value.any(), name
    # lecun normal: variance 1 / fan_in, as flax's draws.
    w = port.stage2_block0.conv2.weight
    np.testing.assert_allclose(w.var().item(), 1 / w[0].numel(), rtol=0.15)


def test_three_sgd_momentum_steps_match_jax():
    model, variables = jax_model()
    images, labels = inputs(8, 32)
    want_losses, want_state = jax_steps(model, variables, images, labels)
    port = torch_model(variables, tiny_torch())
    init, step = ttrain.build_train_step(port_loss,
                                         ttrain.sgd(LR, momentum=MOMENTUM))
    state = init(port)
    batch = (torch.from_numpy(images), torch.from_numpy(labels))
    losses = [step(state, batch)[1]["loss"].item() for _ in range(STEPS)]
    np.testing.assert_allclose(losses, want_losses, rtol=STEP_TOL,
                               atol=STEP_TOL)
    assert_state_close(port.state_dict(), want_state)
    # The checkpoint carries the running statistics.
    saved = state.state_dict()["model"]
    assert_state_close({k: saved[k] for k in stats_of(port)},
                       {k: want_state[k] for k in stats_of(port)})


def test_bf16_config_matches_jax():
    size = 32
    model, variables = jax_model(jnp.bfloat16)
    images, labels = inputs(4, size)
    want, updates = jax_apply(model, variables, images, train=True)
    port = torch_model(variables, tiny_torch(torch.bfloat16))
    got = port(torch.from_numpy(images))
    assert got.dtype == torch.float32
    scale = np.abs(np.asarray(want)).max()
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() \
        <= BF16_TOL * scale
    assert_state_close(stats_of(port), flax_stats(updates["batch_stats"]),
                       tol=BF16_TOL)


def test_train_flops_count_the_layers_shapes():
    """conv_init 7x7 3->8 at 16x16, then per block 1x1, 3x3, 1x1 and the
    projection at each stage's size, then the head."""
    port = tres.ResNet(tiny_torch(), device="cpu")
    fwd = 2 * 49 * 3 * 8 * 16 * 16
    size, ch = 8, 8                  # after the max-pool
    for stage in range(4):
        f = 8 * 2 ** stage
        out = size if stage == 0 else size // 2
        fwd += 2 * ch * f * size * size          # conv1 at the input size
        fwd += 2 * 9 * f * f * out * out         # conv2 (strided)
        fwd += 2 * f * 4 * f * out * out         # conv3
        fwd += 2 * ch * 4 * f * out * out        # downsample_conv
        size, ch = out, 4 * f
    fwd += 2 * ch * 10
    assert tres.train_flops_per_image(port, 32) == 3 * fwd
    assert port.training


def test_a_mesh_batchnorm_needs_its_group():
    class NoGroup:
        pass
    with pytest.raises(RuntimeError, match="process group"):
        tres.BatchNorm(4, mesh=NoGroup())


def test_resnet_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tres.ResNet(tiny_torch())


# -- dp = 2 over gloo ---------------------------------------------------------

def test_dp2_global_batchnorm_matches_jax_and_local_stats_fail(tmp_path):
    model, variables = jax_model()
    images, labels = inputs(8, 32, seed=5)
    weights = from_flax_resnet(jax.tree_util.tree_map(np.asarray, variables))
    torch.save({"resnet": {"weights": weights,
                           "images": torch.from_numpy(images),
                           "labels": torch.from_numpy(labels),
                           "lr": LR, "momentum": MOMENTUM, "steps": STEPS}},
               tmp_path / "inputs.pt")
    procs = run_scenario("resnet_world2", 2, tmp_path)
    want_losses, want_state = jax_steps(model, variables, images, labels)
    join(procs, str(tmp_path), DEADLINE_S)
    ranks = results("resnet_world2", 2, tmp_path)
    for rank in ranks:
        good = rank["runs"]["global"]
        np.testing.assert_allclose(good["losses"], want_losses,
                                   rtol=STEP_TOL, atol=STEP_TOL)
        assert_state_close(good["state"], want_state)
        bad = rank["runs"]["local_bn_init"]
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(bad["losses"], want_losses,
                                       rtol=STEP_TOL, atol=STEP_TOL)
            assert_state_close(bad["state"], want_state)
    # Every rank computed the same global statistics: no broadcast needed.
    assert_state_close(ranks[0]["runs"]["global"]["state"],
                       ranks[1]["runs"]["global"]["state"], tol=0)
