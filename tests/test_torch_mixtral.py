"""The Mixtral family of the PyTorch port vs the JAX package on
``mixtral_tiny`` (4 experts, top-2, f32).

Weights come from the JAX model's init and cross through
``from_flax_params``; token batches are made with numpy.  Held: the
training forward (capacity-dropping routing) and its per-layer
load-balancing values, the dense prefill and a paged decode step
(drop-free) at logits 1e-4; greedy generation byte-identical (dense and
paged); decode consistent with the model's own forward and the batcher
equal to ``generate`` (the port of
``tests/test_models.py::test_moe_decode_consistent_with_forward``); two
AdamW steps against the JAX step (loss and grad_norm at 1e-5).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpi_operator_tpu.models import llama as jl
from mpi_operator_tpu.parallel import train as jtrain
from mpi_operator_tpu.parallel.mesh import MeshConfig, create_mesh
from mpi_operator_tpu_torch.models import llama as tl
from mpi_operator_tpu_torch.models.params import (from_flax_params,
                                                  init_params,
                                                  load_flax_params,
                                                  share_weights)
from mpi_operator_tpu_torch.ops.moe import MoEMLP
from mpi_operator_tpu_torch.parallel.mesh import AXIS_NAMES
from mpi_operator_tpu_torch.parallel import train as ttrain
from mpi_operator_tpu_torch.serving.batcher import ContinuousBatcher

LOGIT_TOL = 1e-4
STEP_TOL = 1e-5
_JAX = {}


def _jax():
    """(JAX model, {"params": ...}, numpy param tree), built once."""
    if not _JAX:
        model = jl.LlamaModel(jl.mixtral_tiny())
        variables = model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 4), jnp.int32))
        params = {"params": variables["params"]}
        tree = jax.tree_util.tree_map(np.asarray, variables["params"])
        _JAX.update(model=model, params=params, tree=tree)
    return _JAX["model"], _JAX["params"], _JAX["tree"]


def _tokens(seed=0, b=3, s=12):
    return np.random.default_rng(seed).integers(1, 256, (b, s)).astype(
        np.int32)


def _port(dtype=None, **overrides):
    return load_flax_params(_jax()[2], tl.mixtral_tiny(**overrides),
                            device="cpu", dtype=dtype)


def test_presets_match_jax_and_params_cover_every_parameter():
    for name in ("mixtral_tiny", "mixtral_8x7b"):
        j, t = getattr(jl, name)(), getattr(tl, name)()
        for f in ("vocab_size", "dim", "n_layers", "n_heads", "kv_heads",
                  "ffn_dim", "head_dim", "rope_theta", "max_seq_len",
                  "n_experts", "top_k"):
            assert getattr(j, f) == getattr(t, f), (name, f)
    cfg = tl.mixtral_tiny()
    sd = from_flax_params(_jax()[2], cfg)
    model = tl.LlamaModel(cfg, device="cpu")
    assert isinstance(model.layers[0].feed_forward, MoEMLP)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert sd["layers.0.feed_forward.w1"].shape == (4, 128, cfg.ffn_dim)
    assert sd["layers.1.feed_forward.router.weight"].shape == (4, 128)
    # Served from bf16 stacks, the router stays f32.
    bf16 = from_flax_params(_jax()[2], cfg, torch.bfloat16)
    assert bf16["layers.0.feed_forward.w2"].dtype == torch.bfloat16
    assert bf16["layers.0.feed_forward.router.weight"].dtype == \
        torch.float32


def test_training_forward_and_load_balancing_match_jax():
    """decode=False routes at capacity factor 1.25: 48 tokens, 30 slots
    per expert, which this batch overflows in both layers (one expert
    takes 35 and 32 assignments)."""
    jm, params, _ = _jax()
    tokens = _tokens(seed=1, b=4, s=12)
    want, aux = jm.apply(params, jnp.asarray(tokens), mutable=["losses"])
    tm = _port(torch.float32)
    got = tm(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    lb = [float(aux["losses"][f"layers_{i}"]["feed_forward"][
        "load_balancing"][0]) for i in range(tm.config.n_layers)]
    got_lb = [layer.feed_forward.load_balancing.item()
              for layer in tm.layers]
    np.testing.assert_allclose(got_lb, lb, atol=1e-5, rtol=1e-5)
    assert all(v > 0 for v in got_lb)


def test_dense_prefill_logits_match_jax():
    jm, params, _ = _jax()
    prompt = _tokens()
    want, _ = jl._prefill_apply(jm, params["params"], jnp.asarray(prompt))
    tm = _port()
    with torch.inference_mode():
        got = tm(torch.from_numpy(prompt),
                 cache=tl.init_cache(tm.config, 3, "cpu"), decode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_paged_decode_step_logits_match_jax():
    _, params, _ = _jax()
    jm = jl.LlamaModel(jl.mixtral_tiny(page_size=16))
    prompt = _tokens(seed=2)
    _, cache = jl._prefill_and_step(jm, params, jnp.asarray(prompt), 0.0,
                                    1.0)[:2]
    nxt = np.asarray([[7], [11], [200]], np.int32)
    want, _ = jl._prefill_apply_cached(jm, params["params"], cache,
                                       jnp.asarray(nxt))
    tm = _port(page_size=16)
    with torch.inference_mode():
        _, tcache = tl._prefill(tm, torch.from_numpy(prompt), 4)
        got = tm(torch.from_numpy(nxt), cache=tcache, decode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_greedy_generate_byte_identical(layout):
    _, params, _ = _jax()
    extra = {"dense": {}, "paged": dict(page_size=16)}[layout]
    jm = jl.LlamaModel(jl.mixtral_tiny(**extra))
    prompt = _tokens(seed=3)
    want = np.asarray(jl.greedy_generate(jm, params, jnp.asarray(prompt),
                                         12))
    got = tl.greedy_generate(_port(**extra), prompt, 12).numpy()
    np.testing.assert_array_equal(got, want)


def test_moe_decode_consistent_with_forward():
    """Every generated token is the argmax of a teacher-forced
    decode-mode forward over the whole stream (the decode step routes
    drop-free like the prefill), and the serving batcher equals
    generate().  The JAX test's configuration (bf16 compute)."""
    cfg = tl.LlamaConfig(vocab_size=128, dim=64, n_layers=2, n_heads=2,
                         n_kv_heads=1, max_seq_len=64, n_experts=4,
                         top_k=2)
    model = init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    prompts = np.asarray([[5, 3, 8, 1], [7, 6, 2, 9]], np.int32)
    out = tl.greedy_generate(model, prompts, 8).numpy()
    seq = np.concatenate([prompts, out], axis=1)
    with torch.inference_mode():
        full = model(torch.from_numpy(seq[:, :-1]),
                     cache=tl.init_cache(cfg, 2, "cpu"), decode=True)
    assert (full[:, 3:].argmax(-1).numpy() == out).all()
    for page in (0, 16):
        batcher = ContinuousBatcher(model, max_slots=2, page_size=page,
                                    device="cpu").start()
        try:
            for r in range(2):
                got = batcher.submit(prompts[r].tolist(), 8)
                assert got == out[r].tolist(), (page, r, got)
        finally:
            batcher.stop()


def test_two_adamw_steps_match_jax():
    jm, params, tree = _jax()
    tokens = _tokens(seed=4, b=4, s=16)
    mesh = create_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])

    def jloss(p, batch):
        return jl.next_token_loss(jm.apply(p, batch), batch)

    with mesh:
        init_fn, step_fn = jtrain.build_train_step(
            jloss, optax.adamw(3e-4), mesh, donate=False)
        state = init_fn(params)
        want = []
        for _ in range(2):
            state, metrics = step_fn(state, jnp.asarray(tokens))
            want.append((float(metrics["loss"]),
                         float(metrics["grad_norm"])))

    def tloss(model, batch):
        return tl.next_token_loss(model(batch), batch)

    init, step = ttrain.build_train_step(tloss, ttrain.adamw(3e-4))
    tstate = init(_port(torch.float32))
    for want_loss, want_norm in want:
        tstate, metrics = step(tstate, torch.from_numpy(tokens))
        np.testing.assert_allclose(metrics["loss"].item(), want_loss,
                                   atol=STEP_TOL, rtol=STEP_TOL)
        np.testing.assert_allclose(metrics["grad_norm"].item(), want_norm,
                                   atol=STEP_TOL, rtol=STEP_TOL)
    # Every expert stack and router took a gradient.
    for layer in tstate.model.layers:
        ffn = layer.feed_forward
        for p in (ffn.router.weight, ffn.w1, ffn.w3, ffn.w2):
            assert p.grad is not None and p.grad.abs().sum() > 0


def test_share_weights_and_init_params_of_an_moe_model():
    cfg = tl.mixtral_tiny()
    model = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    w1 = model.layers[0].feed_forward.w1
    # Truncated lecun_normal over fan-in D: nothing past 2 sigma.
    assert w1.abs().max().item() <= 2 / cfg.dim ** 0.5 / 0.8796 + 1e-6
    twin = share_weights(model, page_size=16)
    assert twin.layers[0].feed_forward.w1 is w1
    prompt = _tokens(seed=5)
    np.testing.assert_array_equal(tl.greedy_generate(twin, prompt, 6),
                                  tl.greedy_generate(model, prompt, 6))


def test_int8_and_mesh_still_raise_for_moe():
    with pytest.raises(NotImplementedError, match="MoE"):
        tl.mixtral_tiny(weight_dtype="int8")
    # tp is ported (tests/test_torch_tensor_parallel.py); 'ep' is not.
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        MoEMLP(8, 16, 4, mesh=types.SimpleNamespace(
            mesh_dim_names=AXIS_NAMES, shape=(1, 1, 1, 2, 1, 1)))
