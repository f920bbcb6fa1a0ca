"""Speculative decoding and chunked prefill, PyTorch port vs the JAX
package, on llama2_tiny in f32 (argmax ties cannot flip there).

The same weights (JAX init, carried over by ``load_flax_params``) go
through both packages: ``propose_prompt_lookup`` must equal the JAX copy
on every history; ``speculative_generate`` must give the JAX function's
tokens and stats exactly; the speculative batchers (model draft and
prompt lookup, dense and paged) must give the JAX batcher's streams and
``spec_stats`` exactly when requests are submitted one at a time, and
the plain greedy streams under concurrency and sampling neighbours;
chunked prefill must decode as the unchunked path does (greedy and
seeded sampling), with and without a prefix hit.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.models.llama import LlamaModel as JaxLlama
from mpi_operator_tpu.models.llama import llama2_tiny as jax_tiny
from mpi_operator_tpu.models.speculative import (
    speculative_generate as jax_speculative)
from mpi_operator_tpu.serving.batcher import ContinuousBatcher as JaxBatcher
from mpi_operator_tpu.serving.drafts import (
    propose_prompt_lookup as jax_lookup)
from mpi_operator_tpu_torch.models.llama import greedy_generate, llama2_tiny
from mpi_operator_tpu_torch.models.params import (load_flax_params,
                                                  share_weights)
from mpi_operator_tpu_torch.models.speculative import speculative_generate
from mpi_operator_tpu_torch.serving import ContinuousBatcher, InferenceServer
from mpi_operator_tpu_torch.serving.drafts import (DRAFT_STRATEGIES,
                                                   propose_prompt_lookup)

PROMPTS = [[5, 3, 8, 1], [7, 6], [1, 2, 3, 4, 5, 6, 7], [9], [4, 4, 4],
           [2, 7, 1, 8, 2, 8]]


def _draft_cfg(cfg):
    return dataclasses.replace(cfg, n_layers=1, dim=32, n_heads=2,
                               n_kv_heads=2)


@pytest.fixture(scope="module")
def models():
    """(JAX target, its variables, port target, JAX draft, its variables,
    port draft): a draft with different weights, so rejections run."""
    jm = JaxLlama(jax_tiny())
    jv = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    jd = JaxLlama(_draft_cfg(jax_tiny()))
    jdv = jd.init(jax.random.PRNGKey(7), jnp.zeros((1, 4), jnp.int32))

    def port(variables, cfg):
        tree = jax.tree_util.tree_map(np.asarray, variables["params"])
        return load_flax_params(tree, cfg, device="cpu")

    return (jm, jv, port(jv, llama2_tiny()), jd, jdv,
            port(jdv, _draft_cfg(llama2_tiny())))


def _want(model, prompt, n):
    return greedy_generate(model, [prompt], n)[0].tolist()


def _run_all(batcher, reqs):
    outs, errors = [None] * len(reqs), []

    def run(i):
        prompt, n, kwargs = reqs[i]
        try:
            outs[i] = batcher.submit(prompt, n, timeout=120, **kwargs)
        except Exception as exc:
            errors.append((i, exc))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    return outs


# -- prompt lookup ----------------------------------------------------------

def test_propose_prompt_lookup_equals_jax():
    assert DRAFT_STRATEGIES == ("prompt_lookup",)
    edges = [([], 3, {}), ([7], 2, {}), ([1, 2, 3, 1, 2], 3, {}),
             ([5, 6, 7], 2, {}), ([1, 2, 1, 2], 4, {}), ([1, 2, 3], 0, {}),
             ([9, 8, 7] + [1] * 10, 2, dict(max_ngram=3, window=8)),
             ([1, 2, 9, 1, 2, 4, 1, 2], 1, {})]
    for hist, k, kw in edges:
        assert propose_prompt_lookup(hist, k, **kw) == jax_lookup(hist, k,
                                                                  **kw)
    assert propose_prompt_lookup([1, 2, 3, 1, 2], 3) == [3, 1, 2]
    rng = np.random.default_rng(5)
    for _ in range(200):
        hist = rng.integers(0, 6, int(rng.integers(0, 60))).tolist()
        k, n = int(rng.integers(1, 9)), int(rng.integers(1, 5))
        assert propose_prompt_lookup(hist, k, n) == jax_lookup(hist, k, n)


# -- speculative_generate ---------------------------------------------------

@pytest.mark.parametrize("case", ["perfect", "imperfect", "two_rows",
                                  "three_rows", "paged"])
def test_speculative_generate_equals_jax(models, case):
    jm, jv, tm, jd, jdv, td = models
    prompt, n, k = {"perfect": ([[5, 3, 8, 1, 9, 2]], 16, 4),
                    "imperfect": ([[5, 3, 8, 1]], 12, 3),
                    "two_rows": ([[11, 7], [2, 9]], 12, 3),
                    "three_rows": ([[5, 3, 8, 1], [9, 9, 2, 4],
                                    [1, 2, 3, 4]], 10, 2),
                    "paged": ([[5, 3, 8, 1, 2]], 10, 3)}[case]
    if case == "perfect":
        j_draft, t_draft = (jm, jv), tm
    else:
        j_draft, t_draft = (jd, jdv), td
    j_target, t_target = jm, tm
    if case == "paged":
        j_target = JaxLlama(dataclasses.replace(jm.config, page_size=16))
        t_target = share_weights(tm, page_size=16)
    want, want_stats = jax_speculative(j_target, jv, *j_draft,
                                       jnp.asarray(prompt, jnp.int32), n,
                                       draft_len=k, return_stats=True)
    got, stats = speculative_generate(t_target, t_draft, prompt, n,
                                      draft_len=k, return_stats=True)
    assert got.tolist() == np.asarray(want).tolist()
    assert got.tolist() == greedy_generate(tm, prompt, n).tolist()
    assert stats == want_stats
    if case == "perfect":
        assert stats["target_forwards"] <= 1 + -(-15 // 5)


def test_speculative_generate_validation(models):
    _, _, tm, _, _, _ = models
    with pytest.raises(ValueError, match="draft_len"):
        speculative_generate(tm, tm, [[1, 2, 3]], 4, draft_len=0)
    with pytest.raises(ValueError, match="headroom"):
        speculative_generate(tm, tm, [[1, 2, 3]], tm.config.max_seq_len)
    out, stats = speculative_generate(tm, tm, [[1, 2, 3]], 0,
                                      return_stats=True)
    assert out.shape == (1, 0) and stats["rounds"] == 0
    with pytest.raises(ValueError, match="cannot change"):
        share_weights(tm, dim=64)


# -- the speculative batcher ------------------------------------------------

def _batchers(models, kind, page_size):
    """JAX and port batchers of one speculative kind, as the JAX tests
    build them."""
    jm, jv, tm, jd, jdv, td = models
    if kind == "draft":
        jkw = dict(draft_model=jd, draft_variables=jdv, draft_len=3)
        tkw = dict(draft_model=td, draft_len=3)
    elif kind == "self":
        jkw = dict(draft_model=jm, draft_variables=jv, draft_len=3)
        tkw = dict(draft_model=tm, draft_len=3)
    else:
        jkw = tkw = dict(draft_strategy="prompt_lookup", draft_len=4)
    jb = JaxBatcher(jm, jv, max_slots=3, page_size=page_size,
                    pipelined=True, **jkw)
    tb = ContinuousBatcher(tm, max_slots=3, page_size=page_size,
                           pipelined=True, device="cpu", **tkw)
    return jb, tb


@pytest.mark.parametrize("kind,page_size", [("draft", 0), ("draft", 16),
                                            ("self", 16),
                                            ("prompt_lookup", 16)])
def test_speculative_batcher_equals_jax(models, kind, page_size):
    """One request at a time: streams AND spec_stats equal the JAX
    batcher's; then concurrent greedy requests with a sampling neighbour
    (plain-tick interludes) give the plain greedy streams.  Both
    batchers force the serialized loop although pipelining was asked
    for."""
    jb, tb = _batchers(models, kind, page_size)
    tm = models[2]
    assert jb.pipelined is False and tb.pipelined is False
    seq = [([1, 2, 3] * 6, 20), ([9, 8, 7, 9, 8, 7, 9, 8], 12),
           ([5, 3, 8, 1, 9, 2], 12), ([4, 4, 4], 6)]
    jb.start()
    try:
        want = [jb.submit(p, n, timeout=120) for p, n in seq]
        want_stats = dict(jb.spec_stats)
    finally:
        jb.stop()
    tb.start()
    try:
        got = [tb.submit(p, n, timeout=120) for p, n in seq]
        assert got == want
        assert tb.spec_stats == want_stats
        assert tb.spec_stats["spec_ticks"] > 0
        assert tb.spec_stats["plain_ticks"] == 0
        reqs = [(p, 6, {}) for p in PROMPTS]
        reqs.insert(2, ([5, 3, 8, 1], 8, dict(temperature=0.8, seed=42)))
        before = tb.spec_stats["plain_ticks"]
        outs = _run_all(tb, reqs)
        for (prompt, n, kwargs), out in zip(reqs, outs):
            assert len(out) == n
            if not kwargs:
                assert out == _want(tm, prompt, n)
        assert tb.spec_stats["plain_ticks"] > before
        assert tb.fatal_error is None
    finally:
        tb.stop()


def test_draft_catches_up_after_plain_interlude(models):
    """A greedy slot that advanced through plain ticks re-syncs its draft
    cache when speculation resumes: a self-draft then accepts nearly
    everything after the interlude."""
    tm = models[2]
    b = ContinuousBatcher(tm, max_slots=2, draft_model=tm, draft_len=3,
                          device="cpu").start()
    try:
        results = {}

        def sampled():
            results["sampled"] = b.submit([5, 3, 8, 1], 10,
                                          temperature=0.9, seed=11)

        t = threading.Thread(target=sampled)
        t.start()
        time.sleep(0.3)     # let the sampling request claim its slot first
        results["greedy"] = b.submit([5, 3, 8, 1], 24)
        t.join(timeout=120)
        assert len(results["sampled"]) == 10
        assert results["greedy"] == _want(tm, [5, 3, 8, 1], 24)
        st = b.spec_stats
        assert st["plain_ticks"] > 0 and st["spec_ticks"] > 0, st
        assert st["accepted_drafts"] >= st["drafted"] * 0.8, st
    finally:
        b.stop()


def test_speculative_validation_and_headroom(models):
    jm, jv, tm, jd, jdv, td = models
    with pytest.raises(ValueError, match="unknown draft_strategy"):
        ContinuousBatcher(tm, draft_strategy="nope", device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        ContinuousBatcher(tm, draft_strategy="prompt_lookup",
                          draft_model=tm, device="cpu")
    with pytest.raises(ValueError, match="draft_len"):
        ContinuousBatcher(tm, draft_model=tm, draft_len=0, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        ContinuousBatcher(tm, draft_model=load_flax_params(
            jax.tree_util.tree_map(np.asarray, JaxLlama(
                jax_tiny(vocab_size=128)).init(
                    jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))[
                        "params"]), llama2_tiny(vocab_size=128),
            device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="dense-layout"):
        ContinuousBatcher(tm, draft_model=share_weights(tm, page_size=16),
                          device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        ContinuousBatcher(tm, draft_model=share_weights(tm, max_seq_len=64),
                          device="cpu")
    b = ContinuousBatcher(tm, max_slots=1, draft_strategy="prompt_lookup",
                          draft_len=4, device="cpu").start()
    try:
        max_len = tm.config.max_seq_len
        with pytest.raises(ValueError, match="speculation headroom"):
            b.submit([1] * (max_len - 8), 8)
        # Sampling requests never speculate, so no headroom is charged.
        assert len(b.submit([1] * (max_len - 8), 8, temperature=0.8,
                            seed=3)) == 8
        assert len(b.submit([1] * (max_len - 13), 8)) == 8   # 8 + 5 fits
    finally:
        b.stop()


def test_http_server_speculative_paths(models):
    """The server's batched path (draft in the batcher) and its
    non-batched path (speculative_generate for greedy multi-row
    requests) both give the JAX package's greedy tokens."""
    from mpi_operator_tpu.models.llama import (
        greedy_generate as jax_greedy)

    jm, jv, tm, jd, jdv, td = models
    server = InferenceServer(tm, max_batch_slots=2, draft_model=td,
                             device="cpu").start()
    try:
        prompts = [[3, 1, 4], [1, 5, 9, 2, 6]]
        outs = [None, None]

        def gen(i):
            outs[i] = server.generate([prompts[i]], max_new_tokens=5)[0]

        threads = [threading.Thread(target=gen, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for p, out in zip(prompts, outs):
            assert out == np.asarray(jax_greedy(
                jm, jv, jnp.asarray([p], jnp.int32), 5))[0].tolist()
        stats = server.batcher_stats()
        assert stats["spec"]["spec_ticks"] > 0
        assert set(stats["prefix"]) == set()    # dense: no prefix cache
        rows = [[3, 1, 4], [1, 5, 9]]
        want = np.asarray(jax_greedy(jm, jv, jnp.asarray(rows, jnp.int32),
                                     6)).tolist()
        assert server.generate(rows, max_new_tokens=6) == want
        stop = want[0][2]
        cut = server.generate(rows, max_new_tokens=6, stop_tokens=(stop,))
        assert cut[0][:3] == want[0][:3] and set(cut[0][3:]) <= {stop}
    finally:
        server.stop()


# -- chunked prefill --------------------------------------------------------

def test_chunked_prefill_matches_unchunked_and_jax(models):
    """Chunked admission (batch-1 paged forwards sharing the pool) decodes
    as the dense-prefill path does, greedy and seeded sampling, prompt
    lengths off and on the chunk boundary, both KV dtypes; the greedy
    streams equal the JAX chunked batcher's."""
    jm, jv, tm, _, _, _ = models
    rng = np.random.default_rng(17)
    prompts = [list(map(int, rng.integers(1, 256, n)))
               for n in (70, 33, 64, 9)]
    jb = JaxBatcher(jm, jv, max_slots=2, page_size=16,
                    prefill_chunk=32).start()
    try:
        jax_want = [jb.submit(p, 8) for p in prompts]
    finally:
        jb.stop()
    for kv in ("auto", "int8"):
        dense = ContinuousBatcher(tm, max_slots=2, page_size=16,
                                  kv_cache_dtype=kv, device="cpu").start()
        chunked = ContinuousBatcher(tm, max_slots=2, page_size=16,
                                    kv_cache_dtype=kv, prefill_chunk=32,
                                    device="cpu").start()
        try:
            for p, jw in zip(prompts, jax_want):
                want = dense.submit(p, 8)
                assert chunked.submit(p, 8) == want, (kv, len(p))
                if kv == "auto":
                    assert want == jw
            for p in prompts[:2]:
                want = dense.submit(p, 6, temperature=0.8, seed=5)
                assert chunked.submit(p, 6, temperature=0.8, seed=5) == want
        finally:
            dense.stop()
            chunked.stop()


def test_chunked_prefill_with_prefix_cache(models):
    """A resubmitted prefix takes the shared-prefix path, and its
    uncached suffix longer than the chunk goes through the chunk loop."""
    _, _, tm, _, _, _ = models
    rng = np.random.default_rng(23)
    base = list(map(int, rng.integers(1, 256, 48)))
    tail = list(map(int, rng.integers(1, 256, 70)))
    ref = ContinuousBatcher(tm, max_slots=2, page_size=16,
                            device="cpu").start()
    b = ContinuousBatcher(tm, max_slots=2, page_size=16, prefill_chunk=32,
                          device="cpu").start()
    try:
        for batcher in (ref, b):
            batcher.submit(base, 4)
        want = ref.submit(base + tail, 8)
        assert b.submit(base + tail, 8) == want == _want(tm, base + tail, 8)
        assert b.prefix_stats["hit_blocks"] == 3
    finally:
        ref.stop()
        b.stop()


def test_prefill_logits_chunked_equal_dense_and_jax(models):
    """The public prefill entry: last-position logits of a prompt
    prefilled in 32-token chunks (lengths off and on the boundary, and
    one shorter than a chunk) equal the JAX model's over the whole
    prompt within 1e-4 (f32), and every block is returned."""
    jm, jv, tm, _, _, _ = models
    rng = np.random.default_rng(29)
    prompts = [list(map(int, rng.integers(1, 256, n))) for n in (70, 64, 9)]
    b = ContinuousBatcher(tm, max_slots=2, page_size=16, prefill_chunk=32,
                          device="cpu")
    free = b.free_blocks()
    for p in prompts:
        want = np.asarray(jm.apply(jv, jnp.asarray([p], jnp.int32)))[0, -1]
        got = b.prefill_logits(p).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        assert b.free_blocks() == free
    b.start()
    try:
        with pytest.raises(RuntimeError, match="slot 0"):
            b.prefill_logits(prompts[0])
    finally:
        b.stop()
    with pytest.raises(ValueError, match="paged cache"):
        ContinuousBatcher(tm, device="cpu").prefill_logits(prompts[0])


def test_chunked_prefill_guards(models, monkeypatch):
    import mpi_operator_tpu_torch.serving.server as server_module

    tm = models[2]
    with pytest.raises(ValueError, match="prefill_chunk"):
        ContinuousBatcher(tm, prefill_chunk=16, device="cpu")
    with pytest.raises(ValueError, match="kv_prefill_chunk"):
        InferenceServer(tm, kv_prefill_chunk=16, device="cpu")
    with pytest.raises(ValueError, match="draft_strategy"):
        InferenceServer(tm, draft_strategy="prompt_lookup", device="cpu")
    monkeypatch.setattr(server_module, "_swa_chunk_warned", False)
    with pytest.warns(RuntimeWarning, match="kv_prefill_chunk"):
        InferenceServer(share_weights(tm, max_seq_len=4096,
                                      sliding_window=64),
                        device="cpu").stop()
