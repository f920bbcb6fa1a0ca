"""HF checkpoint conversion of the PyTorch port (``models/convert.py``)
against transformers and against the JAX package's conversion.

Random-init tiny ``LlamaForCausalLM``, ``MistralForCausalLM`` (a window
smaller than the sequence, so it binds) and ``MixtralForCausalLM`` are
built as ``tests/test_hf_parity.py`` builds them; nothing is downloaded.
Held: the port's logits against HF at the JAX tests' tolerances (2e-4;
3e-4 for Mixtral, on the drop-free cached path) and against the JAX
model on the JAX conversion (1e-4); the port's state dict equal to
``from_flax_params`` of the JAX conversion; greedy generation equal to
HF's; unconsumed tensors raise; tied embeddings reuse the table.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from mpi_operator_tpu.models import convert as jconvert  # noqa: E402
from mpi_operator_tpu.models import llama as jl  # noqa: E402
from mpi_operator_tpu_torch.models import convert as tconvert  # noqa: E402
from mpi_operator_tpu_torch.models import llama as tl  # noqa: E402
from mpi_operator_tpu_torch.models.params import (  # noqa: E402
    from_flax_params)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HF_TOL = {"llama": 2e-4, "mistral": 2e-4, "llama3_rope": 2e-4,
          "mixtral": 3e-4}
JAX_TOL = 1e-4


def _hf(kind):
    common = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=128, rms_norm_eps=1e-5,
                  rope_theta=10000.0, tie_word_embeddings=False,
                  attn_implementation="eager")
    if kind == "llama":
        cls, cfg = transformers.LlamaForCausalLM, transformers.LlamaConfig(
            intermediate_size=128, **common)
    elif kind == "llama3_rope":
        cls, cfg = transformers.LlamaForCausalLM, transformers.LlamaConfig(
            intermediate_size=96, **{**common, "rope_theta": 500000.0},
            rope_scaling={"rope_type": "llama3", "factor": 8.0,
                          "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                          "original_max_position_embeddings": 32})
    elif kind == "mistral":
        cls, cfg = (transformers.MistralForCausalLM,
                    transformers.MistralConfig(intermediate_size=128,
                                               sliding_window=8, **common))
    else:
        cls, cfg = (transformers.MixtralForCausalLM,
                    transformers.MixtralConfig(
                        intermediate_size=96, num_local_experts=4,
                        num_experts_per_tok=2, sliding_window=None,
                        **common))
    torch.manual_seed(3)
    return cls(cfg).eval()


_PAIRS = {}


def _pair(kind):
    """(HF model, port config, port model, JAX config, JAX params)."""
    if kind not in _PAIRS:
        hf = _hf(kind)
        sd = hf.state_dict()
        cfg = tconvert.config_from_hf(hf.config)
        convert = (tconvert.convert_hf_mixtral if cfg.n_experts > 1
                   else tconvert.convert_hf_llama)
        model = tl.LlamaModel(cfg, device="cpu")
        model.load_state_dict(convert(sd, cfg))
        jcfg = jconvert.config_from_hf(hf.config, attention_impl="xla")
        jconv = (jconvert.convert_hf_mixtral if jcfg.n_experts > 1
                 else jconvert.convert_hf_llama)
        _PAIRS[kind] = (hf, cfg, model.eval(), jcfg, jconv(sd, jcfg))
    return _PAIRS[kind]


def _port_logits(model, tokens):
    """The cached (drop-free) forward: the path that matches HF's exact
    top-k routing for Mixtral, and the dense prefill otherwise."""
    with torch.inference_mode():
        return model(torch.as_tensor(tokens, dtype=torch.int32),
                     cache=tl.init_cache(model.config, tokens.shape[0],
                                         "cpu"), decode=True).numpy()


@pytest.mark.parametrize("kind", sorted(HF_TOL))
def test_logits_match_hf_and_jax(kind):
    hf, cfg, model, jcfg, jparams = _pair(kind)
    tokens = np.random.default_rng(4).integers(1, 128, (2, 24))
    with torch.no_grad():
        want = hf(torch.as_tensor(tokens)).logits.numpy()
    got = _port_logits(model, tokens)
    tol = HF_TOL[kind]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    if cfg.n_experts <= 1:
        # The training forward too (it routes no experts here).
        with torch.no_grad():
            train = model(torch.as_tensor(tokens)).numpy()
        np.testing.assert_allclose(train, want, atol=tol, rtol=tol)
    jax_logits, _ = jl.LlamaModel(jcfg).apply(
        jparams, jnp.asarray(tokens), decode=True, mutable=["cache"])
    np.testing.assert_allclose(got, np.asarray(jax_logits), atol=JAX_TOL,
                               rtol=JAX_TOL)


@pytest.mark.parametrize("kind", sorted(HF_TOL))
def test_config_and_state_dict_equal_the_jax_conversion(kind):
    hf, cfg, model, jcfg, jparams = _pair(kind)
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "kv_heads",
              "ffn_dim", "norm_eps", "rope_theta", "max_seq_len",
              "sliding_window", "rope_scaling", "n_experts", "top_k"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.dtype == torch.float32
    want = from_flax_params(jparams, cfg)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    if kind == "mistral":
        assert cfg.sliding_window == 8
    if kind == "mixtral":
        assert got["layers.0.feed_forward.w1"].shape == (4, 64, 96)
        assert got["layers.0.feed_forward.router.weight"].dtype == \
            torch.float32
    # bf16 storage: matmul weights rounded, norms and router kept f32.
    convert = (tconvert.convert_hf_mixtral if cfg.n_experts > 1
               else tconvert.convert_hf_llama)
    bf16 = convert(hf.state_dict(), cfg, torch.bfloat16)
    assert bf16["layers.0.attention.wq.weight"].dtype == torch.bfloat16
    assert bf16["norm.scale"].dtype == torch.float32


@pytest.mark.parametrize("kind", ["llama", "mistral", "mixtral"])
def test_greedy_generation_matches_hf(kind):
    hf, _, model, _, _ = _pair(kind)
    prompt = np.array([[1, 5, 9, 33, 77, 2]])
    with torch.no_grad():
        want = hf.generate(torch.as_tensor(prompt), max_new_tokens=12,
                           do_sample=False, pad_token_id=0,
                           eos_token_id=None).numpy()[:, prompt.shape[1]:]
    np.testing.assert_array_equal(tl.greedy_generate(model, prompt,
                                                     12).numpy(), want)


def test_mistral_window_binds():
    """Without the window the logits past it must not match HF: the
    Mistral case really tests the window."""
    hf, cfg, model, _, _ = _pair("mistral")
    tokens = np.random.default_rng(5).integers(1, 128, (2, 24))
    full = tl.LlamaModel(dataclasses.replace(cfg, sliding_window=None),
                         device="cpu")
    full.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = hf(torch.as_tensor(tokens)).logits.numpy()
    assert np.abs(_port_logits(full, tokens)[:, 16:]
                  - want[:, 16:]).max() > 1e-2


@pytest.mark.parametrize("kind", ["llama", "mixtral"])
def test_unconsumed_tensors_raise(kind):
    hf, cfg, _, _, _ = _pair(kind)
    sd = dict(hf.state_dict())
    sd["model.layers.9.self_attn.q_proj.weight"] = \
        sd["model.layers.0.self_attn.q_proj.weight"]
    convert = (tconvert.convert_hf_mixtral if cfg.n_experts > 1
               else tconvert.convert_hf_llama)
    with pytest.raises(ValueError, match="unconverted"):
        convert(sd, cfg)
    with pytest.raises(ValueError, match="n_experts"):
        tconvert.convert_hf_mixtral(hf.state_dict(), dataclasses.replace(
            cfg, n_experts=0))


def test_tied_embeddings_fallback():
    hf, cfg, _, jcfg, _ = _pair("llama")
    sd = {k: v for k, v in hf.state_dict().items() if k != "lm_head.weight"}
    got = tconvert.convert_hf_llama(sd, cfg)
    assert torch.equal(got["output.weight"], got["tok_embeddings.weight"])
    assert got["output.weight"].data_ptr() != \
        got["tok_embeddings.weight"].data_ptr()
    want = from_flax_params(jconvert.convert_hf_llama(sd, jcfg), cfg)
    assert torch.equal(got["output.weight"], want["output.weight"])


def test_convert_module_does_not_import_transformers():
    code = ("import sys; import mpi_operator_tpu_torch.models.convert; "
            "assert 'transformers' not in sys.modules, 'imported'")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=REPO)


@pytest.mark.parametrize("kind", ["llama", "mixtral"])
def test_serving_example_loads_an_hf_checkpoint(tmp_path, kind):
    """examples/llama_serve_torch.py --hf on a saved checkpoint: the demo
    request's 8 greedy tokens equal HF's own greedy generation."""
    import json

    hf = _pair(kind)[0]
    hf.save_pretrained(str(tmp_path))
    hf.config.save_pretrained(str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "examples/llama_serve_torch.py", "--hf",
         str(tmp_path), "--device", "cpu", "--port", "0", "--demo"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    demo = [ln for ln in proc.stdout.splitlines() if ln.startswith("demo:")]
    got = json.loads(demo[0][len("demo:"):])["tokens"][0]
    with torch.no_grad():
        want = hf.generate(torch.as_tensor([[1, 2, 3, 4]]), max_new_tokens=8,
                           do_sample=False, pad_token_id=0,
                           eos_token_id=None)[0, 4:].tolist()
    assert got == want
