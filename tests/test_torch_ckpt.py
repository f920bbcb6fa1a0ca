"""The port's checkpoint data plane (``mpi_operator_tpu_torch/ckpt``),
framework-free part: a counterpart of each test of tests/test_ckpt.py
but ``test_restore_resharded_allclose_both_directions`` (held across
processes by tests/test_torch_ckpt_resharded.py), on the same states;
then the two packages against each other: the same ids, encodings and
ranges on the same inputs, each reading the other's store (and the JAX
package's ``checkpoints`` verb reading the port's), and the llama2_tiny
TrainState serialized and restored bit for bit at 1-8 shards."""

import os
import shutil
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.ckpt import (BlobFaultBank, BlobStore,
                                         BlobUnavailableError,
                                         BlobWriterKilledError,
                                         MAX_DELTA_DEPTH,
                                         ManifestCheckpointManager,
                                         ShardStreamWriter,
                                         canonical_manifest_bytes,
                                         resolve_chain)
from mpi_operator_tpu_torch.ckpt.blobstore import (BlobStoreCrashedError,
                                                   blob_id_for)
from mpi_operator_tpu_torch.ckpt.manager import (commit_step, fetch_stream,
                                                 rebuild_state,
                                                 serialize_state)
from mpi_operator_tpu_torch.ckpt.manifest import (KIND_DELTA, KIND_FULL,
                                                  chain_complete,
                                                  chunk_spans,
                                                  effective_chunks,
                                                  latest_restorable,
                                                  shard_ranges)
from mpi_operator_tpu_torch.telemetry.metrics import Registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def store_dir():
    d = tempfile.mkdtemp(prefix="test-ckpt-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _state(step=0, n=257, seed=7):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n,)).astype(np.float32),
            "m": np.zeros((n,), np.float32),
            "step": np.int64(step)}


def _bits(tree):
    """Leaf bytes in tree order — the bit-stability comparator."""
    from mpi_operator_tpu_torch.ckpt.manager import _tree_leaves
    return [np.asarray(x).tobytes() for x in _tree_leaves(tree)]


def _mgr(store, job="default/train", **kw):
    kw.setdefault("every", 1)
    kw.setdefault("num_shards", 3)
    kw.setdefault("chunk_bytes", 128)
    kw.setdefault("async_save", False)
    kw.setdefault("registry", Registry())
    return ManifestCheckpointManager(store, job, **kw)


# ---------------------------------------------------------------------------
# Blob store
# ---------------------------------------------------------------------------

def test_put_is_content_addressed_and_dedups():
    store = BlobStore()
    a = store.put(b"hello")
    assert a == blob_id_for(b"hello")
    assert store.get(a) == b"hello"
    before = store.counters["bytes_written"]
    assert store.put(b"hello") == a
    assert store.counters["bytes_written"] == before
    assert store.counters["dedup_hits"] == 1
    assert store.counters["bytes_deduped"] == 5


def test_get_verifies_content_and_missing_blob_raises(store_dir):
    store = BlobStore(root=store_dir)
    bid = store.put(b"payload")
    # Corrupt the stored bytes under the same name: read must refuse.
    path = os.path.join(store_dir, "blobs", bid.replace(":", "-"))
    with open(path, "wb") as f:
        f.write(b"tampered")
    with pytest.raises(BlobUnavailableError):
        store.get(bid)
    with pytest.raises(BlobUnavailableError):
        store.get(blob_id_for(b"never-uploaded"))


def test_crash_is_fail_stop_but_reads_survive():
    store = BlobStore()
    bid = store.put(b"durable")
    store.commit_manifest("default/j", 1, {"step": 1, "kind": "full"})
    store.crash()
    with pytest.raises(BlobStoreCrashedError):
        store.put(b"new")
    with pytest.raises(BlobStoreCrashedError):
        store.commit_manifest("default/j", 2, {})
    # The store models a durable remote: committed facts stay readable.
    assert store.get(bid) == b"durable"
    assert store.manifest_steps("default/j") == [1]


def test_fault_bank_fail_slow_and_after_countdown():
    bank = BlobFaultBank()
    store = BlobStore(fault_bank=bank)
    bank.arm("put", "fail", count=1, after=1)
    store.put(b"a")  # after=1: first put passes silently
    with pytest.raises(BlobUnavailableError):
        store.put(b"b")
    store.put(b"b")  # rule consumed
    bank.arm("put", "slow", delay=3.5)
    t0 = store.now()
    store.put(b"c")
    assert store.now() - t0 >= 3.5  # logical clock advanced, no sleep
    assert bank.applied == {"put:fail": 1, "put:slow": 1}
    assert bank.pending() == 0


def test_torn_manifest_is_invisible_to_readers(store_dir):
    bank = BlobFaultBank()
    store = BlobStore(root=store_dir, fault_bank=bank)
    store.commit_manifest("default/j", 1, {"step": 1, "kind": "full"})
    bank.arm("commit", "torn")
    with pytest.raises(BlobWriterKilledError):
        store.commit_manifest("default/j", 2, {"step": 2, "kind": "full"})
    # Truncated bytes exist at the final name, yet validation hides them.
    torn_path = os.path.join(store_dir, "manifests", "default__j",
                             "step_00000002.json")
    assert os.path.exists(torn_path)
    assert store.counters["torn_manifests"] == 1
    assert store.manifest_steps("default/j") == [1]
    assert store.read_manifest("default/j", 2) is None


def test_directory_and_memory_backends_agree(store_dir):
    body = {"step": 3, "kind": "full", "shards": {"0": {"chunks": {}}}}
    mem, disk = BlobStore(), BlobStore(root=store_dir)
    for store in (mem, disk):
        store.put(b"blob-bytes")
        store.commit_shard_manifest("ns/job", 3, 0, {"shard": 0})
        store.commit_manifest("ns/job", 3, body)
    assert mem.manifest_steps("ns/job") == disk.manifest_steps("ns/job")
    assert mem.read_manifest("ns/job", 3) == disk.read_manifest("ns/job", 3)
    assert mem.shard_manifests("ns/job", 3) == disk.shard_manifests(
        "ns/job", 3)
    assert mem.jobs() == disk.jobs() == ["ns/job"]


# ---------------------------------------------------------------------------
# Manifest format + chains
# ---------------------------------------------------------------------------

def test_shard_ranges_partition_and_chunk_spans_cover():
    ranges = shard_ranges(1000, 3)
    assert ranges[0][0] == 0 and ranges[-1][1] == 1000
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(2))
    spans = chunk_spans(300, 128)
    assert spans == [(0, 128), (128, 256), (256, 300)]
    assert chunk_spans(0, 128) == [(0, 0)]


def test_resolve_chain_walks_deltas_and_bounds_depth():
    store = BlobStore()
    writer = ShardStreamWriter(store, "d/j", 0, chunk_bytes=64)
    data = os.urandom(200)
    writer.write(1, data, KIND_FULL)
    commit_step(store, "d/j", 1, KIND_FULL, 1,
                [{"shape": [200], "dtype": "uint8", "nbytes": 200}],
                200, 64)
    prev = 1
    for step in range(2, 2 + MAX_DELTA_DEPTH):
        data = data[:64] + os.urandom(136)
        writer.write(step, data, KIND_DELTA, base_step=prev)
        commit_step(store, "d/j", step, KIND_DELTA, 1,
                    [{"shape": [200], "dtype": "uint8", "nbytes": 200}],
                    200, 64, base_step=prev, depth=step - 1)
        prev = step
    chain = resolve_chain(store, "d/j", prev)
    assert [m["step"] for m in chain] == list(range(1, prev + 1))
    assert chain[0]["kind"] == KIND_FULL
    assert not chain_complete(store, chain)
    # The first chunk never re-uploaded: the full's blob serves them all.
    view = effective_chunks(chain)
    assert view[0][0]["blob"] == blob_id_for(data[:64])
    # A chain past the compaction bound reads as unreadable, not a walk.
    too_deep = prev + 1
    writer.write(too_deep, data, KIND_DELTA, base_step=prev)
    commit_step(store, "d/j", too_deep, KIND_DELTA, 1,
                [{"shape": [200], "dtype": "uint8", "nbytes": 200}],
                200, 64, base_step=prev, depth=MAX_DELTA_DEPTH + 1)
    assert resolve_chain(store, "d/j", too_deep) is None


def test_latest_restorable_skips_chain_with_missing_blob():
    store = BlobStore()
    mgr = _mgr(store)
    state = _state()
    mgr.save(state, 1)
    state["w"] = state["w"] + 1
    mgr.save(state, 2)
    # Lose one blob referenced only by step 2's delta.
    chain = resolve_chain(store, mgr.job, 2)
    delta_blobs = {ref["blob"] for shard in chain[-1]["shards"].values()
                   for ref in shard["chunks"].values()}
    victim = sorted(delta_blobs)[0]
    del store._blobs[victim]
    assert chain_complete(store, resolve_chain(store, mgr.job, 2))
    step, _ = latest_restorable(store, mgr.job)
    assert step == 1


def test_canonical_manifest_bytes_are_run_stable():
    body = {"b": 2, "a": {"y": [3, 1], "x": None}}
    assert canonical_manifest_bytes(body) == canonical_manifest_bytes(
        {"a": {"x": None, "y": [3, 1]}, "b": 2})
    assert b" " not in canonical_manifest_bytes(body)


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------

def test_serialize_rebuild_roundtrip_bit_stable():
    state = {"w": np.arange(13, dtype=np.float32).reshape(13, 1),
             "b": np.float64(2.5), "step": np.int64(9)}
    layout, stream = serialize_state(state)
    assert sum(e["nbytes"] for e in layout) == len(stream)
    target = {"w": np.zeros((13, 1), np.float32), "b": np.float64(0),
              "step": np.int64(0)}
    rebuilt = rebuild_state(stream, layout, target)
    assert _bits(rebuilt) == _bits(state)
    with pytest.raises(ValueError):
        rebuild_state(stream[:-4], layout, target)
    with pytest.raises(ValueError):
        rebuild_state(stream, layout, {"w": np.zeros((13, 1))})


# ---------------------------------------------------------------------------
# Manager: kind selection, async writer, restore
# ---------------------------------------------------------------------------

def test_full_then_deltas_then_compaction_full():
    store = BlobStore()
    mgr = _mgr(store, full_every=100)  # only the depth bound forces fulls
    state = _state()
    kinds = []
    for step in range(1, MAX_DELTA_DEPTH + 3):
        state["w"] = state["w"] + 0.5
        state["step"] = np.int64(step)
        kinds.append(mgr.save(state, step))
    assert kinds[0] == KIND_FULL
    assert kinds[1:MAX_DELTA_DEPTH + 1] == [KIND_DELTA] * MAX_DELTA_DEPTH
    # Depth bound reached: compaction writes a full again.
    assert kinds[MAX_DELTA_DEPTH + 1] == KIND_FULL
    # Content addressing makes the synthetic full nearly free: only the
    # mutated chunks cost transfer, the rest are dedup hits.
    assert store.counters["dedup_hits"] > 0


def test_full_every_caps_saves_between_fulls():
    store = BlobStore()
    mgr = _mgr(store, full_every=2)
    state = _state()
    kinds = [mgr.save(state, s) for s in range(1, 6)]
    assert kinds == [KIND_FULL, KIND_DELTA, KIND_DELTA,
                     KIND_FULL, KIND_DELTA]


def test_delta_uploads_only_changed_chunks():
    store = BlobStore()
    mgr = _mgr(store, num_shards=1, chunk_bytes=64)
    state = {"w": np.zeros(256, np.uint8)}
    mgr.save(state, 1)
    full_bytes = store.counters["bytes_written"]
    state = {"w": state["w"].copy()}
    state["w"][0] = 1  # dirties exactly one 64-byte chunk
    mgr.save(state, 2)
    delta_bytes = store.counters["bytes_written"] - full_bytes
    assert delta_bytes <= 64
    assert mgr.restore({"w": np.zeros(256, np.uint8)})["w"][0] == 1


def test_restore_empty_store_returns_target_unchanged():
    mgr = _mgr(BlobStore())
    target = _state()
    assert mgr.restore(target) is target
    assert mgr.resume_step() == 0


def test_async_writer_error_is_fatal_loud():
    bank = BlobFaultBank()
    store = BlobStore(fault_bank=bank)
    mgr = _mgr(store, async_save=True)
    bank.arm("commit", "fail")
    mgr.save(_state(), 1)
    mgr._join_inflight()
    with pytest.raises(BlobUnavailableError):
        mgr.save(_state(), 2)
    # Error surfaced once, not sticky forever.
    assert mgr.save(_state(), 2) in (KIND_FULL, KIND_DELTA)
    mgr.drain()
    assert mgr.last_written_step == 2


def test_completed_since_last_poll_latches_once():
    mgr = _mgr(BlobStore())
    assert not mgr.completed_since_last_poll()
    mgr.save(_state(), 1)
    assert mgr.completed_since_last_poll()
    assert not mgr.completed_since_last_poll()


def test_new_manager_adopts_existing_chain_for_deltas():
    store = BlobStore()
    state = _state()
    _mgr(store).save(state, 4)
    # A respawned writer (same layout) deltas against the survivor.
    mgr2 = _mgr(store)
    state["w"] = state["w"] + 1
    assert mgr2.save(state, 5) == KIND_DELTA
    assert mgr2.resume_step() == 5
    # A resharded respawn (different shard count) starts a fresh full.
    mgr3 = _mgr(store, num_shards=2)
    assert mgr3.save(state, 6) == KIND_FULL


def test_metrics_families_follow_saves_and_restores():
    registry = Registry()
    mgr = _mgr(BlobStore(), registry=registry)
    state = _state()
    mgr.save(state, 1)
    mgr.save(state, 2)
    mgr.restore(_state())
    m = mgr.metrics
    assert m["writes"].get("full") == 1 and m["writes"].get("delta") == 1
    assert m["restores"].get("delta") == 1
    assert m["write_seconds"].count == 2
    assert m["restore_seconds"].count == 1
    assert m["bytes"].get("full") > 0
    assert "mpi_operator_ckpt_writes_total" in registry.expose()


# ---------------------------------------------------------------------------
# Crash consistency: kill the writer at EVERY upload/commit boundary
# (as the write-ahead log's crash replay at every acknowledged prefix)
# ---------------------------------------------------------------------------

def _scripted_states(seed=20260816, n_steps=6, n=257):
    """Seeded state trajectory with localized mutation (delta-friendly,
    like optimizer state): regenerated identically per crash trial."""
    rng = np.random.default_rng(seed)
    states = {}
    w = rng.normal(size=(n,)).astype(np.float32)
    m = np.zeros((n,), np.float32)
    for step in range(1, n_steps + 1):
        w = w.copy()
        w[rng.integers(0, n, size=16)] += 1.0
        m = m * np.float32(0.9) + np.float32(step)
        states[step] = {"w": w.copy(), "m": m.copy(),
                        "step": np.int64(step)}
    return states


def _run_writer(store, states, **kw):
    """Drive the save sequence until done or the writer dies."""
    mgr = _mgr(store, full_every=3, **kw)
    for step in sorted(states):
        try:
            mgr.save(states[step], step)
        except BlobWriterKilledError:
            return step
    return None


def test_seeded_writer_kill_at_every_boundary_restores_bit_stable():
    states = _scripted_states()
    # Reference run: count every fault-able writer-side operation.
    ref_store = BlobStore()
    assert _run_writer(ref_store, states) is None
    n_saves = len(ref_store.manifest_steps("default/train"))
    assert n_saves == len(states)
    boundaries = (ref_store.counters["puts"]
                  + n_saves * 3  # commit_shard per shard per save
                  + n_saves)     # job-level commits
    expected_bits = {s: _bits(states[s]) for s in states}

    survivors = set()
    for k in range(boundaries):
        bank = BlobFaultBank()
        bank.arm("*", "kill", after=k)
        store = BlobStore(fault_bank=bank)
        died_at = _run_writer(store, states)
        assert died_at is not None, f"boundary {k} never fired"
        bank.clear()
        latest = latest_restorable(store, "default/train")
        if died_at > 1 or latest is not None:
            # Any commit before the kill must still restore.
            if latest is not None:
                step, chain = latest
                assert step < died_at or step == died_at
                stream = fetch_stream(store, chain)
                restored = rebuild_state(stream, chain[-1]["layout"],
                                         states[step])
                assert _bits(restored) == expected_bits[step], \
                    f"boundary {k}: step {step} not bit-stable"
                survivors.add(step)
        # Committed manifests are all individually restorable too.
        for step in store.manifest_steps("default/train"):
            chain = resolve_chain(store, "default/train", step)
            assert chain is not None and not chain_complete(store, chain)
    # The sweep exercised restores across the whole trajectory.
    assert len(survivors) >= len(states) - 1


def test_torn_commit_at_every_save_falls_back_to_previous_step():
    states = _scripted_states(n_steps=5)
    expected_bits = {s: _bits(states[s]) for s in states}
    for torn_at in range(len(states)):
        bank = BlobFaultBank()
        bank.arm("commit", "torn", after=torn_at)
        store = BlobStore(fault_bank=bank)
        died_at = _run_writer(store, states)
        assert died_at == torn_at + 1
        assert store.counters["torn_manifests"] == 1
        latest = latest_restorable(store, "default/train")
        if torn_at == 0:
            assert latest is None
            continue
        step, chain = latest
        assert step == died_at - 1
        restored = rebuild_state(fetch_stream(store, chain),
                                 chain[-1]["layout"], states[step])
        assert _bits(restored) == expected_bits[step]


# ---------------------------------------------------------------------------
# Preemption notice -> delta checkpoint, via run_train_loop
# ---------------------------------------------------------------------------

def test_preemption_save_is_delta_when_base_exists(tmp_path):
    from mpi_operator_tpu_torch.parallel.train import (
        PREEMPTION_EXIT_CODE, run_train_loop)
    store = BlobStore()
    mgr = _mgr(store, every=2, async_save=True)
    notice = tmp_path / "preempt.notice"

    def step_fn(state, batch):
        step = int(state["step"])
        if step == 2:  # after the step-2 scheduled save (a full) lands
            notice.write_text("preempted\n")
        state = dict(state, step=np.int64(step + 1),
                     w=state["w"] + np.float32(1))
        return state, {}

    def batches():
        while True:
            yield None

    with pytest.raises(SystemExit) as exc:
        run_train_loop(_state(step=0), step_fn, batches(),
                       checkpoint_manager=mgr,
                       preemption_file=str(notice), prefetch=0)
    assert exc.value.code == PREEMPTION_EXIT_CODE
    # The grace-window save chained a DELTA onto the recent base —
    # a preemption almost never pays for a full write.
    steps = store.manifest_steps(mgr.job)
    assert steps[0] == 2
    assert store.read_manifest(mgr.job, steps[0])["kind"] == KIND_FULL
    assert len(steps) == 2
    assert store.read_manifest(mgr.job, steps[-1])["kind"] == KIND_DELTA
    # And the preempted state restores bit-stable for the requeue.
    restored = mgr.restore(_state())
    assert int(restored["step"]) == steps[-1]


def test_preemption_with_no_base_still_writes_full(tmp_path):
    from mpi_operator_tpu_torch.parallel.train import (
        PREEMPTION_EXIT_CODE, run_train_loop)
    store = BlobStore()
    mgr = _mgr(store, every=1000, async_save=True)  # no scheduled save
    notice = tmp_path / "preempt.notice"
    notice.write_text("preempted\n")

    def step_fn(state, batch):
        return dict(state, step=state["step"] + 1), {}

    def batches():
        yield None

    with pytest.raises(SystemExit) as exc:
        run_train_loop(_state(step=0), step_fn, batches(),
                       checkpoint_manager=mgr,
                       preemption_file=str(notice), prefetch=0)
    assert exc.value.code == PREEMPTION_EXIT_CODE
    steps = store.manifest_steps(mgr.job)
    assert len(steps) == 1
    assert store.read_manifest(mgr.job, steps[0])["kind"] == KIND_FULL


def test_fetch_stream_reads_shards_in_parallel():
    store = BlobStore()
    mgr = _mgr(store, num_shards=4)
    state = _state(n=1024)
    mgr.save(state, 1)
    seen = set()
    orig_get = store.get

    def tracking_get(blob_id):
        seen.add(threading.current_thread().name)
        return orig_get(blob_id)

    store.get = tracking_get
    chain = resolve_chain(store, mgr.job, 1)
    stream = fetch_stream(store, chain)
    restored = rebuild_state(stream, chain[-1]["layout"], _state(n=1024))
    assert _bits(restored) == _bits(state)
    assert any(name.startswith("ckpt-restore") for name in seen)


def test_shard_writer_seed_from_store_enables_restart_deltas():
    store = BlobStore()
    writer = ShardStreamWriter(store, "n/j", 0, chunk_bytes=64)
    data = bytes(range(200)) + bytes(56)
    body, uploaded = writer.write(1, data, KIND_FULL)
    commit_step(store, "n/j", 1, KIND_FULL, 1,
                [{"shape": [256], "dtype": "uint8", "nbytes": 256}],
                256, 64)
    assert uploaded == 256
    fresh = ShardStreamWriter(store, "n/j", 0, chunk_bytes=64)
    assert fresh.seed_from_store() == 1
    body, uploaded = fresh.write(2, data[:64] + b"\xff" + data[65:],
                                 KIND_DELTA, base_step=1)
    assert uploaded == 64  # one dirty chunk, the other three skipped
    assert len(body["chunks"]) == 1


# ---------------------------------------------------------------------------
# The two packages against each other
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data", [b"", b"hello", bytes(range(256)) * 37])
def test_blob_ids_equal_jax(data):
    from mpi_operator_tpu.ckpt.blobstore import blob_id_for as jax_blob_id
    assert blob_id_for(data) == jax_blob_id(data)


@pytest.mark.parametrize("body", [
    {"b": 2, "a": {"y": [3, 1], "x": None}},
    {"format": 1, "step": 7, "kind": "delta", "base_step": 6,
     "layout": [{"shape": [3, 4], "dtype": "bfloat16", "nbytes": 24}],
     "shards": {"0": {"chunks": {"0": {"blob": "sha256:00", "nbytes": 1}}}},
     "text": "ünïcode"}])
def test_canonical_manifest_bytes_equal_jax(body):
    from mpi_operator_tpu.ckpt import canonical_manifest_bytes as jax_bytes
    assert canonical_manifest_bytes(body) == jax_bytes(body)


@pytest.mark.parametrize("total,shards", [(0, 1), (1000, 3), (7085660, 4),
                                          (13, 8), (1 << 33, 7)])
def test_shard_ranges_and_chunk_spans_equal_jax(total, shards):
    from mpi_operator_tpu.ckpt.manifest import chunk_spans as jax_spans
    from mpi_operator_tpu.ckpt.manifest import shard_ranges as jax_ranges
    assert shard_ranges(total, shards) == jax_ranges(total, shards)
    for lo, hi in shard_ranges(min(total, 1 << 20), shards):
        for chunk in (1, 64, 1 << 18):
            if (hi - lo) // chunk < 10_000:
                assert chunk_spans(hi - lo, chunk) == \
                    jax_spans(hi - lo, chunk)


def test_serialize_state_of_a_tree_equals_jax():
    from mpi_operator_tpu.ckpt.manager import \
        serialize_state as jax_serialize
    state = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
             "opt": [np.ones(5, np.float64), {"b": np.int32(3),
                                              "a": np.zeros(2, np.uint8)}],
             "step": np.int64(9)}
    assert serialize_state(state) == jax_serialize(state)


def _port_store_with_delta(root):
    """A directory store the port wrote: a full at step 1 and a delta at
    step 2 of a 3-shard state."""
    store = BlobStore(root=root)
    mgr = _mgr(store, job="default/train")
    state = _state()
    mgr.save(state, 1)
    state["w"] = state["w"].copy()
    state["w"][:8] += 1
    assert mgr.save(state, 2) == KIND_DELTA
    return state


def test_jax_reads_a_store_the_port_wrote(store_dir):
    """JAX's resolve_chain, chain_complete and fetch_stream on the port's
    directory store give the port's chain and bytes."""
    from mpi_operator_tpu.ckpt import BlobStore as JaxBlobStore
    from mpi_operator_tpu.ckpt import resolve_chain as jax_resolve
    from mpi_operator_tpu.ckpt.manager import fetch_stream as jax_fetch
    from mpi_operator_tpu.ckpt.manifest import chain_complete as jax_complete
    state = _port_store_with_delta(store_dir)
    port = BlobStore(root=store_dir)
    jax_store = JaxBlobStore(root=store_dir)
    chain = jax_resolve(jax_store, "default/train", 2)
    assert [m["kind"] for m in chain] == [KIND_FULL, KIND_DELTA]
    assert chain == resolve_chain(port, "default/train", 2)
    assert jax_complete(jax_store, chain) == []
    stream = jax_fetch(jax_store, chain)
    assert stream == fetch_stream(port, chain)
    assert stream == serialize_state(state)[1]


def test_port_reads_a_store_the_jax_manager_wrote(store_dir):
    from mpi_operator_tpu.ckpt import BlobStore as JaxBlobStore
    from mpi_operator_tpu.ckpt import \
        ManifestCheckpointManager as JaxManager
    from mpi_operator_tpu.ckpt.manager import \
        serialize_state as jax_serialize
    mgr = JaxManager(JaxBlobStore(root=store_dir), "default/train", every=1,
                     num_shards=3, chunk_bytes=128, async_save=False)
    state = _state()
    mgr.save(state, 1)
    state["m"] = state["m"] + 1
    mgr.save(state, 2)
    port = BlobStore(root=store_dir)
    step, chain = latest_restorable(port, "default/train")
    assert step == 2 and chain[-1]["kind"] == KIND_DELTA
    assert fetch_stream(port, chain) == jax_serialize(state)[1]
    restored = _mgr(port).restore(_state(n=257, seed=0))
    assert _bits(restored) == _bits(state)


def test_jax_checkpoints_verb_reports_a_port_store(store_dir):
    """``python -m mpi_operator_tpu checkpoints NAME --store DIR`` (as
    tests/test_cli.py runs it) on a port store with a full and a delta."""
    _port_store_with_delta(store_dir)
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_operator_tpu", "checkpoints", "train",
         "--store", store_dir], capture_output=True, text=True, timeout=60,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "latest restorable: step 2" in proc.stdout
    assert "full@1 <- delta@2" in proc.stdout


# ---------------------------------------------------------------------------
# A TrainState of the port
# ---------------------------------------------------------------------------

def _tiny_train_state(steps=2, seed=0):
    from mpi_operator_tpu_torch.models import llama as tl
    from mpi_operator_tpu_torch.models.params import init_params
    from mpi_operator_tpu_torch.parallel.train import adamw, build_train_step
    cfg = tl.llama2_tiny()
    model = init_params(cfg, torch.Generator().manual_seed(seed),
                        device="cpu", dtype=torch.float32)
    init, step = build_train_step(
        lambda m, b: tl.next_token_loss(m(b), b), adamw(1e-3))
    state = init(model)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 16)))
    for _ in range(steps):
        state, _ = step(state, tokens)
    return state, step, tokens


def test_train_state_stream_order_and_layout():
    """The step (int64), the parameters in LlamaModel order, each one's
    AdamW entries by key; numpy's dtype names."""
    state, _, _ = _tiny_train_state()
    layout, stream = serialize_state(state)
    names = [n for n, _ in state.model.named_parameters()]
    leaves = state.leaves()
    assert [leaf.name for leaf in leaves] == (
        ["step"] + [f"model.{n}" for n in names] +
        [f"optimizer.{n}.{k}" for n in names
         for k in ("exp_avg", "exp_avg_sq", "step")])
    assert layout[0] == {"shape": [], "dtype": "int64", "nbytes": 8}
    assert np.frombuffer(stream[:8], np.int64)[0] == 2
    assert layout[1]["dtype"] == "float32"
    assert sum(e["nbytes"] for e in layout) == len(stream)


@pytest.mark.parametrize("shards", range(1, 9))
def test_train_state_round_trip_is_bit_stable(shards):
    """llama2_tiny after two AdamW steps, saved at 1-8 shards and restored
    into a fresh state: the same stream, and the next step the same."""
    state, step, tokens = _tiny_train_state()
    layout, stream = serialize_state(state)
    store = BlobStore()
    _mgr(store, num_shards=shards, chunk_bytes=4096).save(state, 2)
    fresh, _, _ = _tiny_train_state(steps=0, seed=1)
    restored = _mgr(store, num_shards=shards).restore(fresh)
    assert restored is fresh and fresh.step == 2
    assert serialize_state(fresh) == (layout, stream)
    _, want = step(state, tokens)
    _, got = step(fresh, tokens)
    assert got["loss"].item() == want["loss"].item()
    # The in-memory path gives the same state.
    again, _, _ = _tiny_train_state(steps=0, seed=2)
    rebuild_state(stream, layout, again)
    assert serialize_state(again) == (layout, stream)


def test_train_loop_saves_and_resumes_a_train_state():
    """run_train_loop over the manager (async), a save every 2 steps: the
    resumed step and state are the last save's."""
    from mpi_operator_tpu_torch.parallel.train import run_train_loop
    state, step, tokens = _tiny_train_state(steps=0)
    store = BlobStore()
    mgr = _mgr(store, every=2, async_save=True, num_shards=2)
    state, done = run_train_loop(state, step, iter([tokens] * 5),
                                 checkpoint_manager=mgr, prefetch=0)
    assert done == 5 and mgr.resume_step() == 4
    assert [store.read_manifest(mgr.job, s)["kind"]
            for s in store.manifest_steps(mgr.job)] == [KIND_FULL,
                                                        KIND_DELTA]
    fresh, _, _ = _tiny_train_state(steps=0, seed=3)
    mgr.restore(fresh)
    assert fresh.step == 4


def test_restore_refuses_another_structure():
    state, _, _ = _tiny_train_state()
    store = BlobStore()
    _mgr(store).save(state, 2)
    with pytest.raises(ValueError):
        _mgr(store).restore(_state())


def test_large_shard_hashed_on_threads_names_each_chunk(store_dir):
    """A shard of 16 MiB or more is hashed on the writer's threads: its
    manifest names each chunk's own blob, in order, and a delta only the
    changed ones."""
    from mpi_operator_tpu_torch.ckpt.manager import PARALLEL_WRITE_BYTES
    data = bytearray(np.random.default_rng(5).integers(
        0, 255, PARALLEL_WRITE_BYTES + 1000, dtype=np.uint8).tobytes())
    store = BlobStore(root=store_dir)
    writer = ShardStreamWriter(store, "n/big", 0, chunk_bytes=1 << 20)
    body, uploaded = writer.write(1, data, KIND_FULL)
    spans = chunk_spans(len(data), 1 << 20)
    assert uploaded == len(data) and body["num_chunks"] == len(spans)
    assert [body["chunks"][str(i)]["blob"] for i in range(len(spans))] == \
        [blob_id_for(bytes(data[lo:hi])) for lo, hi in spans]
    data[5 << 20] ^= 1
    body, uploaded = writer.write(2, data, KIND_DELTA, base_step=1)
    assert list(body["chunks"]) == ["5"] and uploaded == 1 << 20
