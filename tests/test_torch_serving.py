"""Serving path of the PyTorch port vs the JAX package on llama2_tiny.

The port's paged ContinuousBatcher (3 slots, page 16, 15 cache blocks,
as tests/test_batcher.py) must give concurrent greedy streams
byte-identical to the JAX batcher's and to the port's own generate();
prefix-cache hits, pool exhaustion, the pipelined loop and its
one-transfer-per-tick invariant, the HTTP wire format and the fleet
digests are checked against the same expectations the JAX tests hold.
Also: the port imports no JAX, and its entry points refuse to drift to
the CPU.
"""

import json
import pathlib
import re
import subprocess
import sys
import threading
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.models.llama import LlamaModel as JaxLlama
from mpi_operator_tpu.models.llama import llama2_tiny as jax_tiny
from mpi_operator_tpu.serving.batcher import (
    ContinuousBatcher as JaxBatcher)
from mpi_operator_tpu.serving.batcher import (
    prefix_page_digests as jax_digests)
from mpi_operator_tpu_torch import resolve_device
from mpi_operator_tpu_torch.models.llama import (LlamaModel, generate,
                                                 greedy_generate,
                                                 llama2_tiny)
from mpi_operator_tpu_torch.models.params import (init_params,
                                                  load_flax_params)
from mpi_operator_tpu_torch.serving import ContinuousBatcher, InferenceServer
from mpi_operator_tpu_torch.serving.batcher import prefix_page_digests

REPO = pathlib.Path(__file__).resolve().parents[1]
PROMPTS = [[5, 3, 8, 1], [7, 6], [1, 2, 3, 4, 5, 6, 7], [9], [4, 4, 4],
           [2, 7, 1, 8, 2, 8]]


@pytest.fixture(scope="module")
def weights():
    """The JAX tiny model and its port twin, same weights."""
    jm = JaxLlama(jax_tiny())
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, variables["params"])
    return jm, variables, load_flax_params(tree, llama2_tiny(), device="cpu")


def _run_all(batcher, reqs):
    """Submit every (prompt, n, kwargs) concurrently; outputs in order."""
    outs = [None] * len(reqs)
    errors = []

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
    assert not any(t.is_alive() for t in threads)
    return outs


def _want(model, prompt, n):
    return greedy_generate(model, [prompt], n)[0].tolist()


def test_paged_batcher_matches_jax_batcher_and_generate(weights):
    jm, variables, tm = weights
    reqs = [(p, 8, {}) for p in PROMPTS]
    jb = JaxBatcher(jm, variables, max_slots=3, page_size=16,
                    cache_blocks=15).start()
    try:
        want = _run_all(jb, reqs)
    finally:
        jb.stop()
    tb = ContinuousBatcher(tm, max_slots=3, page_size=16, cache_blocks=15,
                           device="cpu").start()
    try:
        got = _run_all(tb, reqs)
    finally:
        tb.stop()
    assert got == want
    for (prompt, n, _), out in zip(reqs, got):
        assert out == _want(tm, prompt, n)


def test_fill_slots_reserves_through_the_allocator(weights):
    """The profiling hook takes each slot's blocks from the pool, maps
    them in the table and sets the cache index; a decode step then
    advances every slot by one."""
    _, _, tm = weights
    tb = ContinuousBatcher(tm, max_slots=3, page_size=16, cache_blocks=15,
                           device="cpu")
    with pytest.raises(ValueError, match="cannot hold"):
        tb.fill_slots(60, headroom=10)         # 3 x 5 blocks > 14
    tb = ContinuousBatcher(tm, max_slots=3, page_size=16, cache_blocks=15,
                           device="cpu")
    tb.fill_slots(20, headroom=12)             # 2 blocks per slot
    assert tb.free_blocks() == 14 - 6
    mapped = tb._table[:, :2].flatten().tolist()
    assert 0 not in mapped and len(set(mapped)) == 6
    assert tb._table[:, 2:].eq(0).all()
    assert tb._cache_index().tolist() == [20, 20, 20]
    with torch.inference_mode():
        out = tb.decode_step(torch.tensor([1, 2, 3], dtype=torch.int32),
                             torch.zeros(3), torch.ones(3), [None] * 3,
                             torch.zeros(3, dtype=torch.int32))
    assert out.shape == (3,) and out.dtype == torch.int32
    assert tb._cache_index().tolist() == [21, 21, 21]
    tb.start()
    try:
        with pytest.raises(RuntimeError, match="running"):
            tb.fill_slots(20)
    finally:
        tb.stop()


def test_pool_exhaustion_queues_and_recycles(weights):
    """3 in-flight budgets of 4 blocks fill 12 of 14: the pool, not the
    slot count, throttles; accounting returns to fully free."""
    _, _, tm = weights
    tb = ContinuousBatcher(tm, max_slots=3, page_size=16, cache_blocks=15,
                           device="cpu").start()
    try:
        prompt = [3, 1, 4, 1, 5, 9, 2, 6]
        outs = _run_all(tb, [(prompt, 56, {})] * 5)
        assert outs == [_want(tm, prompt, 56)] * 5
        assert sorted(tb._free_blocks) == list(range(1, 15))
        assert tb._slot_blocks == {}
        with pytest.raises(ValueError, match="cache blocks"):
            tb.submit([1, 2, 3], 230)    # 15 blocks > 14-block pool
    finally:
        tb.stop()


def test_prefix_cache_hits_are_token_identical(weights):
    _, _, tm = weights
    tb = ContinuousBatcher(tm, max_slots=2, page_size=16,
                           device="cpu").start()
    try:
        prompt = list(range(1, 41))                 # 2 full blocks
        cold = tb.submit(prompt, 8)
        assert tb.prefix_stats["hit_blocks"] == 0
        warm = tb.submit(prompt, 8)
        assert tb.prefix_stats["hit_blocks"] == 2
        assert cold == warm == _want(tm, prompt, 8)
        other = list(range(1, 17)) + [99] * 20      # shares 1 block
        assert tb.submit(other, 8) == _want(tm, other, 8)
        assert tb.prefix_stats["hit_blocks"] == 3
        s1 = tb.submit(prompt, 6, temperature=0.8, top_p=0.9, seed=42)
        s2 = tb.submit(prompt, 6, temperature=0.8, top_p=0.9, seed=42)
        assert s1 == s2                             # across a hit
        assert tb.telemetry["prefix_hit_blocks"].value == \
            tb.prefix_stats["hit_blocks"]
    finally:
        tb.stop()


def _mixed_requests(n=8):
    """Seeded greedy/sampled/top-k/stop-token mix."""
    rng = np.random.default_rng(23)
    reqs = []
    for i in range(n):
        prompt = list(map(int, rng.integers(1, 256, int(rng.integers(3, 12)))))
        kwargs = {}
        if i % 3 == 1:
            kwargs = dict(temperature=0.8, top_p=0.9, seed=50 + i)
        elif i % 3 == 2:
            kwargs = dict(temperature=0.9, top_k=6, seed=90 + i)
        if i % 4 == 3:
            kwargs["stop_tokens"] = (5,)
        reqs.append((prompt, 10, kwargs))
    return reqs


@pytest.mark.parametrize("kw", [{}, dict(page_size=16, cache_blocks=13)],
                         ids=["dense", "paged-oversubscribed"])
def test_pipelined_streams_match_serialized(weights, kw):
    _, _, tm = weights
    reqs = _mixed_requests()
    outs = {}
    for pipelined in (False, True):
        b = ContinuousBatcher(tm, max_slots=3, pipelined=pipelined,
                              device="cpu", **kw).start()
        try:
            outs[pipelined] = _run_all(b, reqs)
        finally:
            b.stop()
    assert outs[True] == outs[False]
    for (prompt, n, kwargs), out in zip(reqs, outs[True]):
        if kwargs.get("temperature", 0.0) > 0.0:
            assert len(out) <= n
            continue
        want = _want(tm, prompt, n)
        stop = kwargs.get("stop_tokens", ())
        cut = next((j for j, t in enumerate(want) if t in stop),
                   len(want) - 1)
        assert out == want[:cut + 1]


def test_one_transfer_per_tick_and_sampling_isolation(weights):
    """A decode of N tokens costs N-1 ticks, one transfer each; sampled
    streams are seed-deterministic and leave a greedy neighbour as it
    is alone."""
    _, _, tm = weights
    b = ContinuousBatcher(tm, max_slots=4, page_size=16,
                          device="cpu").start()
    try:
        tm_ = b.telemetry
        out = b.submit([3, 1, 4, 1], 12)
        assert len(out) == 12
        assert tm_["ticks_total"].value == 11   # first token: prefill
        assert tm_["transfers_total"].value == tm_["ticks_total"].value
        assert tm_["dispatches_total"].value >= tm_["ticks_total"].value
        prompt = [3, 1, 4, 1, 5]
        a = b.submit(prompt, 6, temperature=0.9, top_p=0.9, seed=42)
        assert a == b.submit(prompt, 6, temperature=0.9, top_p=0.9, seed=42)
        alone = b.submit(prompt, 6)
        both = _run_all(b, [(prompt, 6, dict(temperature=0.9, seed=1)),
                            (prompt, 6, {})])
        assert both[1] == alone == _want(tm, prompt, 6)
        assert tm_["transfers_total"].value == tm_["ticks_total"].value
    finally:
        b.stop()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_http_wire_format_and_fleet_digests(weights):
    from conftest import read_sse

    _, _, tm = weights
    server = InferenceServer(tm, max_batch_slots=2, kv_page_size=16,
                             device="cpu").start()
    try:
        prompt = list(range(3, 40))
        out = _post(server.url + "/generate",
                    {"tokens": [prompt], "max_new_tokens": 5})
        assert out == {"tokens": [_want(tm, prompt, 5)]}
        rows = _post(server.url + "/generate",       # non-batched path
                     {"tokens": [[1, 2, 3], [4, 5]], "max_new_tokens": 4})
        assert rows["tokens"] == generate(tm, [[1, 2, 3], [4, 5, 0]], 4,
                                          prompt_lengths=[3, 2]).tolist()
        events = read_sse(server.url + "/generate",
                          {"tokens": [prompt], "max_new_tokens": 5,
                           "stream": True})
        assert [e["token"] for e in events if "token" in e] == \
            out["tokens"][0]
        assert events[-1] == {"done": True, "tokens": out["tokens"][0]}
        with urllib.request.urlopen(server.url + "/metrics") as resp:
            metrics = resp.read().decode()
        for family in ("serving_ttft_seconds_count", "serving_ticks_total",
                       "serving_d2h_transfers_total",
                       "mpi_operator_build_info"):
            assert family in metrics
        with urllib.request.urlopen(server.url + "/healthz") as resp:
            assert json.loads(resp.read()) == {"status": "ok"}
        with urllib.request.urlopen(server.url + "/fleet-state") as resp:
            state = json.loads(resp.read())
        assert state["page_size"] == 16 and state["slots"] == 2
        assert set(state["prefix_digests"]) == set(jax_digests(prompt, 16))
        # /prefill without a destination only warms this replica's cache.
        warm = _post(server.url + "/prefill", {"tokens": prompt})
        assert warm["digests"] == jax_digests(prompt, 16)
        assert warm["shipped"] == 0 and warm["rejected"] == 0
    finally:
        server.stop()


def test_prefix_digests_byte_identical_to_jax():
    rng = np.random.default_rng(7)
    for n in (1, 16, 17, 33, 100):
        tokens = rng.integers(0, 32000, n).tolist()
        for page in (4, 16):
            assert prefix_page_digests(tokens, page) == \
                jax_digests(tokens, page)
    with pytest.raises(ValueError):
        prefix_page_digests([1, 2], 0)


def test_entry_points_default_to_the_card(weights):
    """device=None means the card: without one, every entry point
    raises instead of drifting to the CPU."""
    _, _, tm = weights
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    calls = [
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: LlamaModel(llama2_tiny()),
        lambda: init_params(llama2_tiny(), torch.Generator()),
        lambda: ContinuousBatcher(tm),
        lambda: InferenceServer(tm, max_batch_slots=1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_out_of_slice_options_raise(weights):
    """A serving mesh takes tp and fsdp (tests/test_torch_tensor_parallel.py):
    dp or sp in it still raise, and anything but a DeviceMesh is
    refused; a disaggregated role needs the paged cache, as in the JAX
    server, and /kv/pages answers 400 on an unpaged replica."""
    from mpi_operator_tpu_torch.parallel.mesh import AXIS_NAMES
    _, _, tm = weights
    for shape in ((2, 1, 1, 1, 1, 1), (1, 1, 1, 1, 1, 2)):
        with pytest.raises(NotImplementedError, match="queue 1 item 3"):
            InferenceServer(tm, device="cpu", mesh=types.SimpleNamespace(
                mesh_dim_names=AXIS_NAMES, shape=shape))
    with pytest.raises(TypeError, match="DeviceMesh"):
        InferenceServer(tm, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="paged KV cache"):
        InferenceServer(tm, device="cpu", role="prefill", kv_page_size=0)
    with pytest.raises(ValueError, match="role"):
        InferenceServer(tm, device="cpu", role="warmish")
    server = InferenceServer(tm, max_batch_slots=1, device="cpu").start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(server.url + "/kv/pages", {"pages": []})
        assert err.value.code == 400
        assert "paged cache" in json.loads(err.value.read())["error"]
    finally:
        server.stop()
    server = InferenceServer(tm, max_batch_slots=1, kv_page_size=16,
                             role="decode", device="cpu").start()
    try:
        assert _post(server.url + "/kv/pages", {"pages": []}) == {
            "imported": 0, "deduped": 0, "rejected": 0,
            "wire_decode_s": pytest.approx(0, abs=5),
            "import_s": pytest.approx(0, abs=5)}
        assert server.fleet_state()["role"] == "decode"
    finally:
        server.stop()
    with pytest.raises(ValueError, match="dense-layout"):
        ContinuousBatcher(load_flax_params(
            jax.tree_util.tree_map(np.asarray, weights[1]["params"]),
            llama2_tiny(page_size=16), device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        ContinuousBatcher(tm, kv_cache_dtype="int8", device="cpu")


_PORT_FILES = sorted(str(p.relative_to(REPO)) for p in
                     (REPO / "mpi_operator_tpu_torch").rglob("*.py")) + [
    "chip_smoke.py", "examples/llama_serve_torch.py",
    "examples/llama_train_torch.py", "examples/torch_pi.py",
    "tools/torch_decode_profile.py"]


def test_port_imports_no_jax_and_serves_the_example_demo():
    """The port, its smoke script and its examples import torch, never
    jax/flax/optax/orbax or mpi_operator_tpu: in a subprocess where those
    cannot be imported, chip_smoke imports, the serving example serves a
    demo request and the training example takes 2 tiny steps on the
    CPU; and no source names the JAX package's modules."""
    code = ("import runpy, sys\n"
            "for name in ('jax', 'flax', 'optax', 'orbax',\n"
            "             'mpi_operator_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import chip_smoke\n"
            "def run(path, *argv):\n"
            "    sys.argv = [path, *argv]\n"
            "    try:\n"
            "        runpy.run_path(path, run_name='__main__')\n"
            "    except SystemExit as exc:\n"
            "        assert exc.code in (0, None), exc.code\n"
            "run('examples/llama_serve_torch.py', '--config', 'tiny',\n"
            "    '--device', 'cpu', '--port', '0', '--demo')\n"
            "run('examples/llama_serve_torch.py', '--config', 'tiny',\n"
            "    '--device', 'cpu', '--port', '0', '--demo',\n"
            "    '--weight-dtype', 'int8', '--prefill-chunk', '2',\n"
            "    '--draft-strategy', 'self', '--draft-len', '3')\n"
            "run('examples/llama_train_torch.py', '--config', 'tiny',\n"
            "    '--device', 'cpu', '--steps', '2', '--seq-len', '32')\n"
            "run('examples/torch_pi.py', '1000', '--device', 'cpu')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    demo = [ln for ln in proc.stdout.splitlines() if ln.startswith("demo:")]
    assert len(demo) == 2
    for line in demo:
        assert len(json.loads(line[len("demo:"):])["tokens"][0]) == 8
    assert any(ln.startswith("tokens/sec: ") for ln in
               proc.stdout.splitlines()), proc.stdout
    assert "workers=1 samples=1000 pi=" in proc.stdout
    banned = re.compile(r"^\s*(import|from)\s+"
                        r"(jax|flax|optax|orbax|mpi_operator_tpu)"
                        r"\b(?!_)|mpi_operator_tpu\.", re.M)
    for rel in _PORT_FILES:
        hit = banned.search((REPO / rel).read_text())
        assert hit is None, (rel, hit and hit.group(0))
