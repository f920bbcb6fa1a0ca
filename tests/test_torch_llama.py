"""Llama decode path, PyTorch port vs the JAX package on llama2_tiny.

Weights come from the JAX model's init and cross through
``from_flax_params``; prompts are made with numpy.  Logits are held at
f32 atol/rtol 1e-4 (dense prefill and a paged decode step), greedy token
streams must be byte-identical (dense and paged caches).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.models import llama as jl
from mpi_operator_tpu_torch.models import llama as tl
from mpi_operator_tpu_torch.models.params import (from_flax_params,
                                                  init_params,
                                                  load_flax_params)
from mpi_operator_tpu_torch.ops.moe import MoEMLP
from mpi_operator_tpu_torch.parallel.mesh import AXIS_NAMES

LOGIT_TOL = 1e-4
ROPE_SCALING = dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                    original_max_position_embeddings=64)
VARIANTS = {
    "mha": {},
    "gqa": dict(n_kv_heads=2),
    "rope_scaling": dict(rope_scaling=ROPE_SCALING),
}


_JAX_CACHE = {}


def _jax(variant):
    """(variant kwargs, JAX model, JAX variables, numpy param tree),
    built once per variant."""
    if variant not in _JAX_CACHE:
        kw = VARIANTS[variant]
        model = jl.LlamaModel(jl.llama2_tiny(**kw))
        variables = model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 4), jnp.int32))
        tree = jax.tree_util.tree_map(np.asarray, variables["params"])
        _JAX_CACHE[variant] = (kw, model, variables, tree)
    return _JAX_CACHE[variant]


@pytest.fixture(params=sorted(VARIANTS))
def pair(request):
    return _jax(request.param)


def _prompts(seed=0, b=3, s=12):
    """One prompt shape for every test, so each JAX model compiles its
    prefill once."""
    return np.random.default_rng(seed).integers(1, 256, (b, s)).astype(
        np.int32)


def test_from_flax_params_covers_every_parameter(pair):
    kw, _, _, tree = pair
    cfg = tl.llama2_tiny(**kw)
    sd = from_flax_params(tree, cfg)
    model = tl.LlamaModel(cfg, device="cpu")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    # [in, H, D] -> [H*D, in]: row h*D+j of wq is kernel[:, h, j].
    wq = tree["layers_0"]["attention"]["wq"]["kernel"]
    np.testing.assert_array_equal(
        sd["layers.0.attention.wq.weight"].numpy()[5], wq[:, 0, 5])
    wo = tree["layers_0"]["attention"]["wo"]["kernel"]
    np.testing.assert_array_equal(
        sd["layers.0.attention.wo.weight"].numpy()[:, 3], wo[0, 3])


def test_dense_prefill_logits_match_jax(pair):
    kw, model, variables, tree = pair
    prompt = _prompts()
    want, _ = jl._prefill_apply(model, variables["params"],
                                jnp.asarray(prompt))
    tm = load_flax_params(tree, tl.llama2_tiny(**kw), device="cpu")
    cache = tl.init_cache(tm.config, 3, "cpu")
    with torch.inference_mode():
        got = tm(torch.from_numpy(prompt), cache=cache, decode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("variant,kv", [
    ("mha", "auto"), ("gqa", "auto"), ("rope_scaling", "auto"),
    ("mha", "int8"), ("gqa", "int8")])
def test_paged_decode_step_logits_match_jax(variant, kv):
    """Prefill into the canonical paged layout, then one decode step
    through paged decode attention; int8 pools quantize in both."""
    kw, _, variables, tree = _jax(variant)
    jcfg = jl.llama2_tiny(page_size=16, kv_cache_dtype=kv, **kw)
    jm = jl.LlamaModel(jcfg)
    prompt = _prompts(seed=1)
    _, cache = jl._prefill_and_step(jm, variables, jnp.asarray(prompt),
                                    0.0, 1.0)[:2]
    nxt = np.asarray([[7], [11], [200]], np.int32)
    want, _ = jl._prefill_apply_cached(jm, variables["params"], cache,
                                       jnp.asarray(nxt))

    tcfg = tl.llama2_tiny(page_size=16, kv_cache_dtype=kv, **kw)
    tm = load_flax_params(tree, tcfg, device="cpu")
    with torch.inference_mode():
        _, tcache = tl._prefill(tm, torch.from_numpy(prompt), 4)
        got = tm(torch.from_numpy(nxt), cache=tcache, decode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("variant,layout", [
    ("mha", "dense"), ("mha", "paged"), ("mha", "paged_int8"),
    ("gqa", "dense"), ("gqa", "paged"), ("rope_scaling", "paged")])
def test_greedy_generate_byte_identical(variant, layout):
    kw, _, variables, tree = _jax(variant)
    extra = {"dense": {}, "paged": dict(page_size=16),
             "paged_int8": dict(page_size=16, kv_cache_dtype="int8")}[layout]
    jm = jl.LlamaModel(jl.llama2_tiny(**extra, **kw))
    tm = load_flax_params(tree, tl.llama2_tiny(**extra, **kw),
                          device="cpu")
    prompt = _prompts(seed=2)
    want = np.asarray(jl.greedy_generate(jm, variables,
                                         jnp.asarray(prompt), 12))
    got = tl.greedy_generate(tm, prompt, 12).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", ["mha", "gqa"])
def test_generate_ragged_prompts_and_stop_tokens_match_jax(variant):
    kw, model, variables, tree = _jax(variant)
    tm = load_flax_params(tree, tl.llama2_tiny(**kw), device="cpu")
    prompt = _prompts(seed=3)
    lengths = [12, 3, 5]
    want = np.asarray(jl.generate(model, variables, jnp.asarray(prompt), 10,
                                  prompt_lengths=lengths))
    got = tl.generate(tm, prompt, 10, prompt_lengths=lengths).numpy()
    np.testing.assert_array_equal(got, want)
    stop = (int(want[0, 2]), int(want[1, 4]))
    want = np.asarray(jl.generate(model, variables, jnp.asarray(prompt), 10,
                                  prompt_lengths=lengths, stop_tokens=stop))
    got = tl.generate(tm, prompt, 10, prompt_lengths=lengths,
                      stop_tokens=stop).numpy()
    np.testing.assert_array_equal(got, want)


def test_stream_generate_matches_generate():
    tm = init_params(tl.llama2_tiny(), torch.Generator().manual_seed(1),
                     device="cpu")
    prompt = [3, 1, 4, 1, 5]
    want = tl.greedy_generate(tm, [prompt], 9)[0].tolist()
    assert list(tl.stream_generate(tm, prompt, 9)) == want
    stop = (want[3],)
    assert list(tl.stream_generate(tm, prompt, 9, stop_tokens=stop)) == \
        want[:want.index(want[3]) + 1]


def test_quantize_kv_matches_jax():
    x = np.random.default_rng(4).standard_normal((5, 3, 2, 64)).astype(
        np.float32)
    x[0, 0, 0] = 0.0                       # zero vector -> scale 0
    q, s = tl.quantize_kv(torch.from_numpy(x))
    jq, js = jl.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(tl.dequantize_kv(q, s).numpy(),
                               np.asarray(jl.dequantize_kv(jq, js)),
                               rtol=1e-6)


def test_rope_scaling_freqs_match_jax():
    d = 64
    freqs = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float32) / d))
    got = tl._scale_rope_freqs(torch.from_numpy(freqs), ROPE_SCALING)
    want = jl._scale_rope_freqs(jnp.asarray(freqs), ROPE_SCALING)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _support(logits, temp, top_p, top_k):
    """Tokens select_rows may sample for one row, computed in numpy."""
    scaled = logits.astype(np.float64) / temp
    order = np.argsort(-scaled)
    keep = np.ones_like(scaled, bool)
    if top_k:
        keep[order[top_k:]] = False
    if top_p < 1.0:
        kept = order[:top_k] if top_k else order
        p = np.exp(scaled[kept] - scaled[kept].max())
        p /= p.sum()
        n = int(np.searchsorted(np.cumsum(p), top_p)) + 1
        nucleus = np.zeros_like(keep)
        nucleus[kept[:n]] = True
        keep &= nucleus
    return set(np.nonzero(keep)[0].tolist())


def test_select_rows_greedy_and_sampled_support():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 50)).astype(np.float32)
    temps = np.array([0.0, 0.7, 1.3, 1.0], np.float32)
    top_ps = np.array([1.0, 0.8, 1.0, 0.5], np.float32)
    top_ks = np.array([0, 0, 5, 10], np.int32)
    gens = [None] + [torch.Generator().manual_seed(s) for s in (1, 2, 3)]
    support = [_support(logits[i], max(temps[i], 1e-6), top_ps[i],
                        top_ks[i]) for i in range(4)]
    seen = [set() for _ in range(4)]
    for _ in range(300):
        toks = tl.select_rows(torch.from_numpy(logits),
                              torch.from_numpy(temps),
                              torch.from_numpy(top_ps), gens,
                              torch.from_numpy(top_ks)).numpy()
        assert toks[0] == logits[0].argmax()
        for i in range(1, 4):
            seen[i].add(int(toks[i]))
    for i in range(1, 4):
        assert len(support[i]) > 1
        assert seen[i] <= support[i], (i, seen[i] - support[i])
        assert len(seen[i]) > 1          # really sampling
    # Greedy everywhere: argmax in the logits' own dtype, first maximum.
    tied = torch.tensor([[1.0, 3.0, 3.0, 2.0]], dtype=torch.bfloat16)
    assert tl.select_rows(tied, torch.zeros(1), torch.ones(1), [None],
                          torch.zeros(1, dtype=torch.int32)).item() == 1


def test_select_rows_per_row_streams_are_independent():
    """A row's sampled stream depends only on its own generator, not on
    its neighbours' (the JAX batcher's per-slot key invariant)."""
    rng = np.random.default_rng(6)
    logits = torch.from_numpy(rng.standard_normal((3, 40)).astype(
        np.float32))
    ones = torch.ones(3)
    ks = torch.zeros(3, dtype=torch.int32)

    def stream(neighbour_seed):
        gens = [torch.Generator().manual_seed(neighbour_seed),
                torch.Generator().manual_seed(99), None]
        return [tl.select_rows(logits, ones, ones, gens, ks)[1].item()
                for _ in range(20)]

    assert stream(1) == stream(2)


def test_config_validation_matches_jax():
    for bad in (dict(weight_dtype="fp4"), dict(sliding_window=0),
                dict(kv_cache_dtype="fp8"), dict(kv_cache_dtype="int8")):
        with pytest.raises(ValueError):
            jl.llama2_tiny(**bad)
        with pytest.raises(ValueError):
            tl.llama2_tiny(**bad)
    for name in ("llama2_7b", "llama2_tiny", "llama3_8b"):
        j, t = getattr(jl, name)(), getattr(tl, name)()
        for f in ("vocab_size", "dim", "n_layers", "n_heads", "kv_heads",
                  "ffn_dim", "head_dim", "rope_theta", "max_seq_len"):
            assert getattr(j, f) == getattr(t, f), (name, f)
    cfg = tl.llama2_tiny(page_size=16, cache_blocks=4)
    with pytest.raises(ValueError, match="cache_blocks"):
        tl.canonical_block_table(2, cfg, device="cpu")


def test_out_of_slice_paths_raise():
    tm = init_params(tl.llama2_tiny(), torch.Generator().manual_seed(0),
                     device="cpu")
    # The training forward (no cache) is ported: logits [B, S, V].
    assert tm(torch.zeros((1, 4), dtype=torch.int32)).shape == (1, 4, 256)
    # MoE is ported (tests/test_torch_mixtral.py), over tp too
    # (tests/test_torch_tensor_parallel.py) and over 'ep'
    # (tests/test_torch_expert_parallel.py) and over 'pp'
    # (tests/test_torch_moe_pipeline.py: the layer on a pp mesh computes
    # what it computes alone); int8 weights with MoE still raise, and a
    # mesh must be a DeviceMesh.
    assert tl.LlamaModel(tl.llama2_tiny(n_experts=4), device="cpu")(
        torch.zeros((1, 4), dtype=torch.int32)).shape == (1, 4, 256)
    with pytest.raises(NotImplementedError, match="MoE"):
        tl.LlamaModel(tl.llama2_tiny(n_experts=4, weight_dtype="int8"),
                      device="cpu")
    x = torch.randn(1, 4, 128, generator=torch.Generator().manual_seed(0))
    alone = MoEMLP(128, 256, 4, device="cpu")
    on_pp = MoEMLP(128, 256, 4, device="cpu", mesh=types.SimpleNamespace(
        mesh_dim_names=AXIS_NAMES, shape=(1, 1, 2, 1, 1, 1)))
    with torch.no_grad():
        for p in alone.parameters():
            p.normal_(generator=torch.Generator().manual_seed(p.numel()))
    on_pp.load_state_dict(alone.state_dict())
    assert torch.equal(on_pp(x), alone(x))
    with pytest.raises(TypeError, match="DeviceMesh"):
        MoEMLP(128, 256, 4, mesh=object())
    # Weight-only int8 is ported (tests/test_torch_quant.py): the matmul
    # layers hold int8 weights.
    q = tl.LlamaModel(tl.llama2_tiny(weight_dtype="int8"), device="cpu")
    assert q.layers[0].attention.wq.weight.dtype == torch.int8
    with pytest.raises(ValueError, match="max_seq_len"):
        tl.generate(tm, [[1, 2, 3]], 1000)
