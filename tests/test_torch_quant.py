"""Weight-only int8 serving, PyTorch port vs the JAX package.

On the JAX tests' configuration (tests/test_quant.py, f32): the port's
quantization gives the JAX int8 values and scales exactly; the JAX
quantized tree carried over by ``from_flax_params`` gives logits within
1e-4 of the JAX int8 model (f32 model logits, the parity rule), and the
quantized logits stay within 5% of full precision; every serving path
over quantized weights (dense generate, paged batcher, int8 KV, chunked
prefill, speculative, the server's ``weight_dtype="int8"``) gives the
JAX quantized model's greedy tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.models.llama import LlamaConfig as JaxConfig
from mpi_operator_tpu.models.llama import LlamaModel as JaxLlama
from mpi_operator_tpu.models.llama import greedy_generate as jax_greedy
from mpi_operator_tpu.models.quant import quantize_params as jax_quantize
from mpi_operator_tpu_torch.models.llama import (LlamaConfig, LlamaModel,
                                                 greedy_generate)
from mpi_operator_tpu_torch.models.params import (from_flax_params,
                                                  init_params,
                                                  load_flax_params)
from mpi_operator_tpu_torch.models.quant import (QuantLinear,
                                                 quantize_model,
                                                 quantize_params)
from mpi_operator_tpu_torch.serving import ContinuousBatcher, InferenceServer

CFG = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           hidden_dim=128, max_seq_len=128)
PROMPT = [1, 5, 9, 33, 77, 2, 64, 100, 3, 17, 40, 8]


@pytest.fixture(scope="module")
def quant():
    """The JAX full-precision and int8 models and params, and the port's
    full-precision and int8 twins (the int8 twin from the JAX tree)."""
    jcfg = JaxConfig(**CFG, dtype=jnp.float32)
    jm = JaxLlama(jcfg)
    jv = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    jqcfg = dataclasses.replace(jcfg, weight_dtype="int8")
    jq = JaxLlama(jqcfg)
    jqv = {"params": jax_quantize(jv["params"], jqcfg)}
    cfg = LlamaConfig(**CFG, dtype=torch.float32)
    qcfg = dataclasses.replace(cfg, weight_dtype="int8")
    tree = jax.tree_util.tree_map(np.asarray, jv["params"])
    qtree = jax.tree_util.tree_map(np.asarray, jqv["params"])
    return dict(jm=jm, jv=jv, jq=jq, jqv=jqv, cfg=cfg, qcfg=qcfg,
                tree=tree, qtree=qtree,
                tm=load_flax_params(tree, cfg, device="cpu"),
                tq=load_flax_params(qtree, qcfg, device="cpu"))


def _jax_want(q, prompt, n):
    return np.asarray(jax_greedy(q["jq"], q["jqv"],
                                 jnp.asarray([prompt], jnp.int32), n))[0]


def test_int8_values_and_scales_equal_jax(quant):
    """Quantizing the port's state dict gives what the JAX tree carries
    over as, bit for bit; quantize_model gives the same tensors."""
    want = from_flax_params(quant["qtree"], quant["qcfg"])
    got = quantize_params(from_flax_params(quant["tree"], quant["cfg"]),
                          quant["qcfg"])
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    model_sd = quantize_model(quant["tm"]).state_dict()
    for key in want:
        assert torch.equal(model_sd[key], want[key]), key
    wq = want["layers.0.attention.wq.weight"]
    assert wq.dtype == torch.int8 and wq.shape == (64, 64)
    assert want["layers.0.attention.wq.scale"].shape == (64,)      # H*Dh
    assert want["layers.0.attention.wo.scale"].shape == (64,)      # D
    assert want["layers.0.attention.wk.scale"].shape == (32,)      # KH*Dh
    assert want["output.weight"].dtype == torch.int8
    assert want["tok_embeddings.weight"].dtype == torch.float32


def test_round_half_to_even_and_zero_rows():
    """jnp.round and torch.round both round half to even; an all-zero
    row gets scale 1, as in the JAX kernel."""
    from mpi_operator_tpu.models.quant import _quantize_kernel as jax_q
    from mpi_operator_tpu_torch.models.quant import _quantize_kernel

    w = np.array([[127.0, 0.5, 1.5, -2.5, 3.5], [0.0] * 5,
                  [254.0, 1.0, 3.0, -5.0, 7.0]], np.float32)
    q, s = _quantize_kernel(torch.from_numpy(w))
    jq, js = jax_q(jnp.asarray(w.T), 1)        # JAX layout [in, out]
    assert q.tolist() == np.asarray(jq).T.tolist()
    assert s.tolist() == np.asarray(js).tolist()
    assert q[0].tolist() == [127, 0, 2, -2, 4] and s[1].item() == 1.0


def test_per_channel_scale_identity_is_exact():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 16)).astype(np.float32)
    q = rng.integers(-127, 128, (16, 8)).astype(np.float32)
    s = rng.uniform(0.01, 1.0, 8).astype(np.float32)
    np.testing.assert_allclose((x @ q) * s, x @ (q * s), rtol=1e-5)


def test_quantized_logits_match_jax(quant):
    toks = np.random.default_rng(0).integers(1, 128, (2, 24))
    want = np.asarray(quant["jq"].apply(quant["jqv"], jnp.asarray(toks)))
    full = np.asarray(quant["jm"].apply(quant["jv"], jnp.asarray(toks)))
    with torch.no_grad():
        got = quant["tq"](torch.as_tensor(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.abs(full - got).max() / np.abs(full).max() < 0.05
    layer = quant["tq"].layers[0].attention.wq
    assert isinstance(layer, QuantLinear)
    assert layer.weight.dtype == torch.int8
    assert layer.scale.dtype == torch.float32


def test_quant_linear_bf16_matches_jax_layer():
    """In bf16, ``QuantLinear`` against the JAX ``QuantDenseGeneral`` on
    the same int8 weight, scale and input: each element within one bf16
    rounding (2^-8 of its size) plus 1e-5 of the largest for the order
    of the f32 sums."""
    from mpi_operator_tpu.models.quant import QuantDenseGeneral

    rng = np.random.default_rng(3)
    q = rng.integers(-127, 128, (96, 80)).astype(np.int8)       # [in, out]
    s = rng.uniform(1e-3, 1e-2, 80).astype(np.float32)
    x = rng.normal(size=(2, 7, 96)).astype(np.float32)
    want = np.asarray(QuantDenseGeneral(80, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(q), "scale": jnp.asarray(s)}},
        jnp.asarray(x)).astype(jnp.float32))
    layer = QuantLinear(96, 80, torch.bfloat16)
    layer.weight.copy_(torch.as_tensor(q.T.copy()))
    layer.scale.copy_(torch.as_tensor(s))
    with torch.no_grad():
        got = layer(torch.as_tensor(x)).float().numpy()
    bound = 2.0 ** -8 * np.abs(want) + 1e-5 * np.abs(want).max()
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("kwargs", [
    {}, {"page_size": 4}, {"page_size": 4, "kv_cache_dtype": "int8"},
    {"page_size": 4, "prefill_chunk": 4},
    {"page_size": 4, "draft_strategy": "prompt_lookup"}],
    ids=["generate", "paged", "int8_kv", "chunked", "prompt_lookup"])
def test_quantized_serving_paths_equal_jax(quant, kwargs):
    """The int8 model through each serving path gives the JAX int8
    model's greedy tokens (int8 K/V perturbs the logits, so there a full
    length decode and the first token are required, as in the JAX
    test)."""
    want = _jax_want(quant, PROMPT, 10).tolist()
    tq = quant["tq"]
    if not kwargs:
        assert greedy_generate(tq, [PROMPT], 10)[0].tolist() == want
        return
    b = ContinuousBatcher(tq, max_slots=2, device="cpu", **kwargs).start()
    try:
        got = b.submit(PROMPT, 10)
    finally:
        b.stop()
    if kwargs.get("kv_cache_dtype") == "int8":
        assert len(got) == 10 and got[0] == want[0]
    else:
        assert got == want


def test_server_weight_dtype_quantizes(quant):
    """InferenceServer(weight_dtype='int8') swaps in the int8 model and
    decodes as the JAX int8 model; also batched."""
    for slots in (0, 2):
        srv = InferenceServer(quant["tm"], weight_dtype="int8",
                              max_batch_slots=slots, device="cpu").start()
        try:
            assert srv.model.config.weight_dtype == "int8"
            assert srv.model is not quant["tm"]
            got = srv.generate([PROMPT[:4]], max_new_tokens=5)
        finally:
            srv.stop()
        assert got[0] == _jax_want(quant, PROMPT[:4], 5).tolist()


def test_int8_init_and_share(quant):
    """init_params of an int8 config draws full precision and quantizes;
    quantize_model of an int8 model is the model itself."""
    gen = torch.Generator().manual_seed(0)
    q = init_params(quant["qcfg"], gen, device="cpu")
    ref = quantize_model(init_params(quant["cfg"],
                                     torch.Generator().manual_seed(0),
                                     device="cpu"))
    for (k, a), (_, b) in zip(q.state_dict().items(),
                              ref.state_dict().items()):
        assert torch.equal(a, b), k
    assert quantize_model(q) is q


def test_quant_guards(quant):
    with pytest.raises(ValueError, match="weight_dtype"):
        LlamaConfig(vocab_size=8, dim=8, n_layers=1, n_heads=1,
                    weight_dtype="int4")
    with pytest.raises(NotImplementedError, match="MoE"):
        LlamaConfig(vocab_size=8, dim=8, n_layers=1, n_heads=1,
                    n_experts=4, weight_dtype="int8")
    with pytest.raises(NotImplementedError, match="MoE"):
        quantize_params({}, LlamaConfig(vocab_size=8, dim=8, n_layers=1,
                                        n_heads=1, n_experts=4))
    with pytest.raises(NotImplementedError, match="MoE"):
        LlamaModel(LlamaConfig(vocab_size=8, dim=8, n_layers=1, n_heads=1,
                               n_experts=4), device="cpu")
    with pytest.raises(ValueError, match="weight_dtype"):
        InferenceServer(quant["tm"], weight_dtype="int4", device="cpu")
