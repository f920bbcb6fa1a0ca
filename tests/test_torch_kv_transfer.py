"""Disaggregated prefill/decode serving of the PyTorch port against the
JAX package, on llama2_tiny (f32, CPU), page 16.

The port's KV-page wire codec must be byte-compatible with the JAX
package's in both directions (bf16 included, which plain numpy cannot
name); its batcher's export/import must give every verdict the JAX
batcher gives (imported, deduped, and rejected for a digest, a parent,
a shape and an exhausted pool); an import into an idle batcher must not
wait for a tick; and the HTTP handoff, prefill replica -> decode
replica, must serve greedy streams equal to a unified server's, in the
port alone and across the two packages, in bf16-free f32 pools and in
int8 pools.  A fatal batcher error leaves a flight bundle, and a
request's trace context gives both replica spans.
"""

import base64
import json
import os
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.models.llama import LlamaModel as JaxLlama
from mpi_operator_tpu.models.llama import llama2_tiny as jax_tiny
from mpi_operator_tpu.serving import kv_transfer as jax_kv
from mpi_operator_tpu.serving.server import InferenceServer as JaxServer
from mpi_operator_tpu_torch.models.llama import llama2_tiny
from mpi_operator_tpu_torch.models.params import load_flax_params
from mpi_operator_tpu_torch.serving import ContinuousBatcher, InferenceServer
from mpi_operator_tpu_torch.serving import kv_transfer
from mpi_operator_tpu_torch.serving.batcher import prefix_page_digests
from mpi_operator_tpu_torch.telemetry import flight
from mpi_operator_tpu_torch.telemetry.trace import default_tracer

PAGE = 16
# Three full pages plus three tokens: three transferable pages, and a
# suffix of three tokens (never one: a one-token suffix would be a decode
# step of the paged kernel).
PROMPT = [(7 * i) % 250 + 1 for i in range(3 * PAGE + 3)]


@pytest.fixture(scope="module")
def weights():
    """The JAX tiny model and its port twin, same weights."""
    jm = JaxLlama(jax_tiny())
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, variables["params"])
    return jm, variables, load_flax_params(tree, llama2_tiny(), device="cpu")


def _post(url, path, payload, timeout=120):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _torch_server(model, role="unified", kv="auto", blocks=48):
    return InferenceServer(model, max_batch_slots=2, kv_page_size=PAGE,
                           kv_cache_blocks=blocks, kv_cache_dtype=kv,
                           role=role, device="cpu").start()


def _jax_server(jm, variables, role="unified", kv="auto", blocks=48):
    return JaxServer(jm, variables, max_batch_slots=2, kv_page_size=PAGE,
                     kv_cache_blocks=blocks, kv_cache_dtype=kv,
                     role=role).start()


def _greedy(url, prompt, n=8, **extra):
    return _post(url, "/generate", {"tokens": [prompt], "max_new_tokens": n,
                                    "temperature": 0.0, **extra})["tokens"]


# -- wire codec ------------------------------------------------------------

LEAF_CASES = {
    "f32": [("pool_key", torch.float32)],
    "bf16": [("pool_key", torch.bfloat16)],
    "int8": [("pool_key", torch.int8), ("pool_key_scale", torch.float32)],
}


def _leaves(kind, seed=0):
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, dtype in LEAF_CASES[kind]:
        shape = (PAGE, 2, 8) if name == "pool_key" else (PAGE, 2)
        x = torch.randn(shape, generator=gen) * 3
        out[f"layers_0/attention/{name}"] = (
            x.round().clamp(-127, 127).to(dtype) if dtype == torch.int8
            else x.to(dtype))
    return out


def _page(leaves, tokens=None):
    tokens = tokens or list(range(1, PAGE + 1))
    return {"digest": prefix_page_digests(tokens + [0], PAGE)[0],
            "parent": "", "tokens": tokens, "leaves": leaves}


def _bits(t):
    """The raw bytes of a host tensor or numpy array."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(t).tobytes()


@pytest.mark.parametrize("kind", sorted(LEAF_CASES))
def test_codec_round_trip(kind):
    leaves = _leaves(kind)
    wire = kv_transfer.encode_pages([_page(leaves)])
    json.dumps(wire)                      # JSON-safe
    (back,) = kv_transfer.decode_pages(wire)
    for path, leaf in leaves.items():
        got = back["leaves"][path]
        assert got.dtype == leaf.dtype and got.shape == leaf.shape
        assert _bits(got) == _bits(leaf)
    assert kv_transfer.payload_bytes(wire) == len(
        json.dumps({"pages": wire}).encode())


@pytest.mark.parametrize("kind", sorted(LEAF_CASES))
def test_wire_is_byte_compatible_with_jax_both_ways(kind):
    """Port-encoded pages decode in the JAX package to the same bits, and
    JAX-encoded pages (bf16 from jnp) decode in the port; the encoded
    dicts themselves are equal."""
    leaves = _leaves(kind, seed=1)
    page = _page(leaves)
    wire = kv_transfer.encode_pages([page])
    (via_jax,) = jax_kv.decode_pages(wire)
    for path, leaf in leaves.items():
        assert str(via_jax["leaves"][path].dtype) == wire[0]["leaves"][
            path]["dtype"]
        assert _bits(via_jax["leaves"][path]) == _bits(leaf)
    jnp_dtypes = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
                  torch.int8: jnp.int8}
    jax_page = {**page, "leaves": {
        path: jnp.asarray(leaf.float().numpy()).astype(
            jnp_dtypes[leaf.dtype])
        for path, leaf in leaves.items()}}
    jax_wire = jax_kv.encode_pages([jax_page])
    assert jax_wire == wire
    (back,) = kv_transfer.decode_pages(jax_wire)
    for path, leaf in leaves.items():
        assert back["leaves"][path].dtype == leaf.dtype
        assert _bits(back["leaves"][path]) == _bits(leaf)


def test_malformed_pages_are_dropped():
    good = kv_transfer.encode_pages([_page(_leaves("bf16"))])[0]
    bad_dtype = json.loads(json.dumps(good))
    next(iter(bad_dtype["leaves"].values()))["dtype"] = "complex64"
    bad_shape = json.loads(json.dumps(good))
    next(iter(bad_shape["leaves"].values()))["shape"] = [3, 3]
    bad_b64 = json.loads(json.dumps(good))
    next(iter(bad_b64["leaves"].values()))["b64"] = "!!"
    no_tokens = {k: v for k, v in good.items() if k != "tokens"}
    got = kv_transfer.decode_pages([bad_dtype, good, bad_shape, bad_b64,
                                    no_tokens, "junk"])
    assert [p["digest"] for p in got] == [good["digest"]]
    # The dtype map needs no ml_dtypes: "bfloat16" reads as an int16 view.
    raw = np.arange(4, dtype=np.int16)
    leaf = kv_transfer.decode_leaf({
        "b64": base64.b64encode(raw.tobytes()).decode(),
        "dtype": "bfloat16", "shape": [4]})
    assert leaf.dtype == torch.bfloat16
    assert leaf.view(torch.int16).tolist() == raw.tolist()


# -- batcher export/import -------------------------------------------------

def _prefilled(model, prompt=PROMPT, **kw):
    """A started port batcher whose prefix cache holds ``prompt``."""
    b = ContinuousBatcher(model, max_slots=2, page_size=PAGE, device="cpu",
                          **{"cache_blocks": 48, **kw}).start()
    b.submit(prompt, 1, timeout=60)
    return b


def test_export_import_verdicts(weights):
    _, _, tm = weights
    src = _prefilled(tm)
    dst = ContinuousBatcher(tm, max_slots=2, page_size=PAGE, cache_blocks=48,
                            device="cpu").start()
    try:
        digests = prefix_page_digests(PROMPT, PAGE)
        pages = src.export_kv_pages(digests + ["not-a-digest"])
        assert [p["digest"] for p in pages] == digests
        assert [p["parent"] for p in pages] == [""] + digests[:-1]
        assert src.telemetry["kv_pages_exported"].value == 3
        wire = kv_transfer.decode_pages(kv_transfer.encode_pages(pages))

        bad = json.loads(json.dumps(kv_transfer.encode_pages(pages[:1])))
        bad[0]["tokens"][0] += 1            # tokens no longer hash
        assert dst.import_kv_pages(kv_transfer.decode_pages(bad)) == \
            {"imported": 0, "deduped": 0, "rejected": 1}
        # Parent not here yet: the child is rejected.
        assert dst.import_kv_pages(wire[1:2]) == \
            {"imported": 0, "deduped": 0, "rejected": 1}
        leaves = dict(wire[0]["leaves"])
        path = next(iter(leaves))
        leaves[path] = leaves[path][:, :1]
        assert dst.import_kv_pages([{**wire[0], "leaves": leaves}]) == \
            {"imported": 0, "deduped": 0, "rejected": 1}
        assert dst.import_kv_pages(wire) == \
            {"imported": 3, "deduped": 0, "rejected": 0}
        assert dst.import_kv_pages(wire) == \
            {"imported": 0, "deduped": 3, "rejected": 0}
        rejected = dst.telemetry["kv_import_rejected"]
        assert [rejected.get(r) for r in ("digest_mismatch",
                                          "missing_parent", "shape")] == \
            [1, 1, 1]
        assert dst.telemetry["kv_pages_imported"].value == 3
        assert set(dst.prefix_digest()) >= set(digests)
        # Imported blocks are cached at refcount 0, bit-equal to the
        # source's, and a re-export gives the same bytes.
        again = dst.export_kv_pages(digests)
        for a, b in zip(pages, again):
            for p in a["leaves"]:
                assert _bits(a["leaves"][p]) == _bits(b["leaves"][p])
        # The stream over imported pages equals the source's own.
        assert dst.submit(PROMPT, 6, timeout=60) == \
            src.submit(PROMPT, 6, timeout=60)
        assert dst.prefix_stats["hit_blocks"] == 3
    finally:
        src.stop()
        dst.stop()


def test_import_evicts_cached_blocks_but_never_live_ones(weights):
    """Cached refcount-0 blocks are evicted to make room for an import;
    blocks a live slot holds are never taken: with none left, the import
    is rejected as pool_exhausted."""
    _, _, tm = weights
    src = _prefilled(tm)
    pages = src.export_kv_pages(prefix_page_digests(PROMPT, PAGE))
    src.stop()
    other = [(5 * i) % 250 + 2 for i in range(3 * PAGE + 3)]
    # 4 usable blocks: the other prompt leaves 3 cached and 1 free.
    dst = _prefilled(tm, prompt=other, cache_blocks=5)
    try:
        assert dst.import_kv_pages(pages) == \
            {"imported": 3, "deduped": 0, "rejected": 0}
        assert dst.prefix_stats["evicted"] == 2
    finally:
        dst.stop()
    dst = ContinuousBatcher(tm, max_slots=2, page_size=PAGE, cache_blocks=5,
                            device="cpu")
    assert dst._alloc_blocks(0, 4 * PAGE)   # a live slot holds all 4
    held = list(dst._slot_blocks[0])
    dst.start()
    try:
        assert dst.import_kv_pages(pages) == \
            {"imported": 0, "deduped": 0, "rejected": 3}
        rejected = dst.telemetry["kv_import_rejected"]
        assert rejected.get("pool_exhausted") == 1
        assert rejected.get("missing_parent") == 2
        assert dst._slot_blocks[0] == held and dst.free_blocks() == 0
    finally:
        dst.stop()


def test_import_into_an_idle_batcher_does_not_wait_for_a_tick(weights):
    """The scheduler idles on its wait queue; import_kv_pages pokes it,
    so the import runs at once."""
    _, _, tm = weights
    src = _prefilled(tm)
    dst = ContinuousBatcher(tm, max_slots=2, page_size=PAGE, cache_blocks=48,
                            device="cpu").start()
    try:
        pages = src.export_kv_pages(prefix_page_digests(PROMPT, PAGE))
        time.sleep(0.2)                   # let the scheduler go idle
        t0 = time.perf_counter()
        assert dst.import_kv_pages(pages, timeout=5)["imported"] == 3
        assert time.perf_counter() - t0 < 2.0
    finally:
        src.stop()
        dst.stop()
    # poke() wakes a waiter that would otherwise sleep its whole timeout.
    q = dst._queue
    woke = []
    waiter = threading.Thread(target=lambda: woke.append(
        (q.wait_nonempty(30.0), time.perf_counter())))
    waiter.start()
    time.sleep(0.1)
    t0 = time.perf_counter()
    q.poke()
    waiter.join(timeout=10)
    assert not waiter.is_alive()
    assert woke[0][0] is False and woke[0][1] - t0 < 5.0


# -- the HTTP handoff ------------------------------------------------------

def test_http_handoff_matches_unified_and_reships_as_dedup(weights):
    _, _, tm = weights
    prefill = _torch_server(tm, role="prefill")
    decode = _torch_server(tm, role="decode")
    control = _torch_server(tm)
    try:
        reply = _post(prefill.url, "/prefill", {
            "tokens": PROMPT, "transfer": {"url": decode.url, "have": []}})
        assert reply["digests"] == prefix_page_digests(PROMPT, PAGE)
        assert reply["shipped"] == 3 and reply["imported"] == 3
        assert reply["rejected"] == 0 and reply["bytes"] > 0
        assert set(reply["seconds"]) == {"export", "encode", "push",
                                         "wire_decode", "import"}
        assert prefill._batcher.telemetry["dispatches_total"].value == 0
        via_decode = _greedy(decode.url, PROMPT)
        assert via_decode == _greedy(control.url, PROMPT)
        assert decode._batcher.prefix_stats["hit_blocks"] == 3
        again = _post(prefill.url, "/prefill", {
            "tokens": PROMPT,
            "transfer": {"url": decode.url, "have": reply["digests"]}})
        assert again["shipped"] == 0 and again["deduped"] == 3
        # No have-list: the receiver dedups what it already holds.
        again = _post(prefill.url, "/prefill", {
            "tokens": PROMPT, "transfer": {"url": decode.url}})
        assert again["shipped"] == 3 and again["deduped"] == 3
        assert again["imported"] == 0
        state = json.loads(urllib.request.urlopen(
            decode.url + "/fleet-state").read())
        assert state["role"] == "decode" and state["free_blocks"] > 0
        assert set(reply["digests"]) <= set(state["prefix_digests"])
    finally:
        prefill.stop()
        decode.stop()
        control.stop()


@pytest.mark.parametrize("kv", ["auto", "int8"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_cross_framework_handoff_matches_jax_unified(weights, direction, kv):
    """A JAX prefill replica's pages serve a torch decode replica, and
    the other way round: the greedy stream equals the JAX unified
    server's (the same holds for the prefill replica's own second
    /generate over its cached pages)."""
    jm, variables, tm = weights
    if direction == "jax_to_torch":
        prefill = _jax_server(jm, variables, role="prefill", kv=kv)
        decode = _torch_server(tm, role="decode", kv=kv)
    else:
        prefill = _torch_server(tm, role="prefill", kv=kv)
        decode = _jax_server(jm, variables, role="decode", kv=kv)
    control = _jax_server(jm, variables, kv=kv)
    try:
        reply = _post(prefill.url, "/prefill", {
            "tokens": PROMPT, "transfer": {"url": decode.url, "have": []}})
        assert (reply["shipped"], reply["imported"], reply["rejected"]) == \
            (3, 3, 0)
        want = _greedy(control.url, PROMPT)
        assert _greedy(decode.url, PROMPT) == want
        assert _greedy(prefill.url, PROMPT) == want
        assert decode._batcher.prefix_stats["hit_blocks"] == 3
    finally:
        prefill.stop()
        decode.stop()
        control.stop()


# -- flight bundles and spans ----------------------------------------------

def _bundles(root, reason):
    return sorted(d for d in os.listdir(root) if reason in d) \
        if os.path.isdir(root) else []


@pytest.mark.parametrize("phase", ["dispatch", "kv-import"])
def test_fatal_batcher_error_leaves_a_bundle(weights, tmp_path, monkeypatch,
                                             phase):
    _, _, tm = weights
    monkeypatch.setenv(flight.DEBUG_DIR_ENV, str(tmp_path))
    b = ContinuousBatcher(tm, max_slots=2, page_size=PAGE, cache_blocks=48,
                          device="cpu").start()
    try:
        def boom(*args, **kwargs):
            raise RuntimeError("injected device fault")

        if phase == "dispatch":
            b.decode_step = boom
            with pytest.raises(RuntimeError, match="injected device fault"):
                b.submit(PROMPT, 4, timeout=60)
        else:
            src = _prefilled(tm)
            pages = src.export_kv_pages(prefix_page_digests(PROMPT, PAGE))
            src.stop()
            b._scatter_staged = boom
            with pytest.raises(RuntimeError, match="kv-import"):
                b.import_kv_pages(pages, timeout=30)
        assert b._fatal_phase == phase
        (bundle,) = _bundles(tmp_path, "batcher-fatal")
        ring = [json.loads(line) for line in
                open(tmp_path / bundle / "flight.jsonl")]
        fatal = [r for r in ring if r["layer"] == "serving"
                 and r["kind"] == "fatal_error"]
        assert fatal and fatal[-1]["data"]["phase"] == phase
        manifest = json.load(open(tmp_path / bundle / "MANIFEST.json"))
        for name in manifest["artifacts"]:
            assert (tmp_path / bundle / name).is_file(), name
        with pytest.raises(RuntimeError, match="batcher-fatal"):
            b.submit(PROMPT, 2, timeout=10)
    finally:
        b.stop()


def test_replica_spans_and_debug_bundle(weights, tmp_path, monkeypatch):
    """/generate and /prefill with a trace_context emit the replica's
    serve_queue_wait and prefill spans, parented to the carried context;
    GET /debug-bundle freezes them in a bundle's flight.jsonl."""
    _, _, tm = weights
    monkeypatch.setenv(flight.DEBUG_DIR_ENV, str(tmp_path))
    server = _torch_server(tm)
    try:
        _greedy(server.url, PROMPT, 4, trace_context="req-gen-1:4242")
        _post(server.url, "/prefill", {"tokens": PROMPT[:20],
                                       "trace_context": "req-pre-2:77"})
        _greedy(server.url, PROMPT, 2, trace_context="not a context")
        events = default_tracer().events()
        for trace_id, parent in (("req-gen-1", 4242), ("req-pre-2", 77)):
            names = sorted(e["name"] for e in events
                           if e.get("trace_id") == trace_id)
            assert names == ["prefill", "serve_queue_wait"], names
            assert all(e["parent_id"] == parent for e in events
                       if e.get("trace_id") == trace_id)
        with urllib.request.urlopen(server.url + "/debug-bundle") as resp:
            path = json.loads(resp.read())["bundle"]
        assert os.path.dirname(path) == str(tmp_path)
        manifest = json.load(open(os.path.join(path, "MANIFEST.json")))
        for name in manifest["artifacts"]:
            assert os.path.isfile(os.path.join(path, name)), name
        ring = [json.loads(line) for line in
                open(os.path.join(path, "flight.jsonl"))]
        spans = {(r["data"]["name"], r["data"].get("trace_id"))
                 for r in ring if r["kind"] == "span"}
        assert ("prefill", "req-gen-1") in spans
        assert ("serve_queue_wait", "req-pre-2") in spans
    finally:
        server.stop()
