"""Checkpoint data-plane writers and the train-loop manager: counterpart
of ``mpi_operator_tpu/ckpt/manager.py`` over ``parallel.train``'s
``TrainState``.

The layers are the JAX module's:

- :func:`serialize_state` / :func:`rebuild_state`: a state as one
  deterministic byte stream plus a layout table (``shape``, ``dtype``
  in numpy's names, ``nbytes`` per leaf).  A ``TrainState``'s leaves are
  ``TrainState.leaves()``: the step (int64), the parameters in
  ``LlamaModel.named_parameters()`` order, each parameter's optimizer
  entries by key, then the model's persistent buffers.  Their order and
  global shapes do not depend on the mesh, so a manifest written on one
  mesh restores on any other.  Other states (dicts, lists and tuples of
  arrays or tensors) flatten as ``jax.tree_util`` flattens them.
- :class:`ShardStreamWriter`, :func:`commit_step`, :func:`fetch_stream`:
  a shard's byte range streamed chunked and content-hashed, the atomic
  job-level commit, the parallel read.
- :class:`ManifestCheckpointManager`: the drop-in for
  ``utils.checkpoint.CheckpointManager`` in ``run_train_loop``.

The process model is torch's: a process drives one card.  Without a
process group (or in a group of one) the manager is the JAX one: one
process materialises the stream and writes all ``num_shards`` shards.
In a group of ``world`` > 1 processes the state's mesh spans the group,
``num_shards`` is ``world`` and shard s is rank s: each rank computes
only its byte range ``shard_ranges(total, world)[s]`` of the one-device
stream, a leaf at a time through its plan's gathers, and writes it
through its own :class:`ShardStreamWriter`; the ranks then agree that
every shard is staged and rank 0 commits (the per-worker protocol of the
JAX module, ``soak/harness.py``).  The bytes are the ones one process
would write, so the manifests name the same blobs.  A restore reads
only the chunks that cover what the rank holds: under FSDP2's dim-0
shards, only its rows.
"""

from __future__ import annotations

import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..telemetry.metrics import default_registry
from .blobstore import BlobStore, blob_id_for
from .manifest import (KIND_DELTA, KIND_FULL, MAX_DELTA_DEPTH,
                       build_manifest, chain_complete, chunk_spans,
                       effective_chunks, latest_restorable, resolve_chain,
                       shard_ranges)

DEFAULT_CHUNK_BYTES = 1 << 18
# Chunks hashed at once by one writing process, fetched at once by one
# restoring process.
WRITE_WORKERS = 8
RESTORE_WORKERS = 8
# A shard at least this large is hashed on WRITE_WORKERS threads.
PARALLEL_WRITE_BYTES = 16 << 20

# numpy's dtype names (ml_dtypes' "bfloat16"), as the JAX layouts name
# them.
_DTYPE_NAMES = {torch.float64: "float64", torch.float32: "float32",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int64: "int64", torch.int32: "int32",
                torch.int16: "int16", torch.int8: "int8",
                torch.uint8: "uint8", torch.bool: "bool"}
_DTYPES = {name: dtype for dtype, name in _DTYPE_NAMES.items()}


def ckpt_metrics(registry=None) -> dict:
    """The data plane's registry families (docs/OBSERVABILITY.md)."""
    registry = registry or default_registry()
    return {
        "registry": registry,
        "writes": registry.counter_vec(
            "mpi_operator_ckpt_writes_total",
            "Checkpoint manifests committed to the blob store, by kind"
            " (full = complete chunk map, delta = changed chunks"
            " chained onto a base)", ["kind"]),
        "bytes": registry.counter_vec(
            "mpi_operator_ckpt_bytes_total",
            "Bytes actually uploaded to the blob store per checkpoint"
            " kind (content-hash dedup excluded — the delta savings are"
            " visible here)", ["kind"]),
        "restores": registry.counter_vec(
            "mpi_operator_ckpt_restores_total",
            "States restored from a manifest chain, by the head"
            " manifest's kind", ["kind"]),
        "write_seconds": registry.histogram(
            "mpi_operator_ckpt_write_seconds",
            "Chunk/hash/upload/commit wall time of one manifest write"
            " (off the step path when async)"),
        "restore_seconds": registry.histogram(
            "mpi_operator_ckpt_restore_seconds",
            "Manifest chain resolve + parallel shard fetch + rebuild"
            " wall time of one restore"),
    }


# ---------------------------------------------------------------------------
# Serialization: state <-> (layout, byte stream)
# ---------------------------------------------------------------------------

def _is_train_state(state) -> bool:
    return hasattr(state, "leaves") and hasattr(state, "optimizer")


def _tree_leaves(tree) -> List[Any]:
    """Leaves in ``jax.tree_util`` order: dict keys sorted, sequences in
    order, None an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _tree_unflatten(tree, leaves):
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(tree)


def _entry(shape, dtype) -> dict:
    nbytes = int(np.prod(shape, dtype=np.int64)) * \
        torch.empty((), dtype=dtype).element_size()
    return {"shape": list(shape), "dtype": _DTYPE_NAMES[dtype],
            "nbytes": nbytes}


def _tensor_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as a flat uint8 tensor on its device."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _array_bytes(leaf) -> Tuple[dict, bytes]:
    if torch.is_tensor(leaf):
        return _entry(tuple(leaf.shape), leaf.dtype), \
            _tensor_bytes(leaf).cpu().numpy().tobytes()
    arr = np.asarray(leaf)
    data = arr.tobytes()
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "nbytes": len(data)}, data


def state_layout(state, entry_keys=None) -> Tuple[list, List[dict]]:
    """(leaves, layout) of a ``TrainState``: its ``leaves()`` and their
    layout entries, known on every rank without touching the data."""
    leaves = state.leaves(entry_keys)
    missing = [leaf.name for leaf in leaves if leaf.dtype is None]
    if missing:
        raise ValueError(f"state holds no {missing[:3]}: nothing to save")
    return leaves, [_entry(leaf.shape, leaf.dtype) for leaf in leaves]


def host_buffer(nbytes: int) -> torch.Tensor:
    """A uint8 host tensor, page-locked when there is a card, so that a
    copy from the card into it does not hold up the host.  It is locked
    in place at its own size (``pin_memory=True`` would round it up to a
    power of two) and unlocked when the tensor goes."""
    buf = torch.empty(nbytes, dtype=torch.uint8)
    if nbytes and torch.cuda.is_available():
        cudart = torch.cuda.cudart()
        err = cudart.cudaHostRegister(buf.data_ptr(), nbytes, 0)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostRegister of {nbytes} bytes: {err}")
        weakref.finalize(buf, cudart.cudaHostUnregister, buf.data_ptr())
    return buf


def stream_range(leaves, layout, lo: int, hi: int,
                 out: Optional[torch.Tensor] = None) -> np.ndarray:
    """Bytes ``[lo, hi)`` of the one-device stream of ``leaves`` (a uint8
    array, over ``out`` when given): every leaf gathered in order (under
    a plan every rank of the mesh calls this, whatever its range), and
    only the bytes that fall in the range copied to the host.  Into
    page-locked memory the copies are asynchronous, so no rank's copies
    hold up the next gathers of the others."""
    host = out[:hi - lo] if out is not None else \
        torch.empty(hi - lo, dtype=torch.uint8)
    off = 0
    for leaf, entry in zip(leaves, layout):
        end = off + entry["nbytes"]
        full = leaf.gather()
        a, b = max(off, lo), min(end, hi)
        if a < b:
            host[a - lo:b - lo].copy_(_tensor_bytes(full)[a - off:b - off],
                                      non_blocking=full.is_cuda)
        del full
        off = end
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return host.numpy()


def serialize_state(state) -> Tuple[List[dict], bytes]:
    """(layout, stream): every leaf materialised to host memory and
    concatenated in order.  Deterministic bytes for identical values.
    For a ``TrainState`` under a plan this is a collective and every
    rank gets the whole stream."""
    if _is_train_state(state):
        leaves, layout = state_layout(state)
        total = sum(e["nbytes"] for e in layout)
        return layout, stream_range(leaves, layout, 0, total).tobytes()
    layout, parts = [], []
    for leaf in _tree_leaves(state):
        entry, data = _array_bytes(leaf)
        layout.append(entry)
        parts.append(data)
    return layout, b"".join(parts)


def _host_tensor(buf, entry: dict, rows=None) -> torch.Tensor:
    """A leaf (or its rows) over ``buf``: a uint8 tensor, or bytes."""
    dtype = _DTYPES[entry["dtype"]]
    shape = list(entry["shape"])
    if rows is not None:
        shape[0] = rows[1] - rows[0]
    if not len(buf):
        return torch.empty(shape, dtype=dtype)
    if not torch.is_tensor(buf):
        if memoryview(buf).readonly:
            buf = bytearray(buf)
        buf = torch.frombuffer(buf, dtype=torch.uint8)
    return buf.view(dtype).reshape(shape)


def _row_bytes(entry: dict) -> int:
    rows = entry["shape"][0] if entry["shape"] else 1
    return entry["nbytes"] // rows if rows else 0


def read_leaf_rows(fetch, off: int, entry: dict, rows=None) -> torch.Tensor:
    """One leaf (or its rows ``(r0, r1)`` of dim 0) of a stream whose
    bytes ``fetch(lo, hi)`` returns (as bytes or a uint8 tensor), the
    leaf starting at ``off``.  The result may share the fetched memory:
    a load copies it before its next read."""
    if rows is None:
        return _host_tensor(fetch(off, off + entry["nbytes"]), entry)
    per = _row_bytes(entry)
    return _host_tensor(fetch(off + rows[0] * per, off + rows[1] * per),
                        entry, rows)


def _leaf_entry_keys(state, layout: List[dict]):
    """The optimizer entry keys a stream of ``layout`` holds for
    ``state``: none (saved before the first step) or those of a step of
    the state's optimizer."""
    from ..parallel.train import optimizer_entry_keys
    held = state.leaves([])
    extra = len(layout) - len(held)
    n_params = sum(leaf.name.startswith("model.") for leaf in held)
    if extra == 0:
        return []
    keys = optimizer_entry_keys(state.optimizer)
    if extra != n_params * len(keys):
        raise ValueError(
            f"target has {len(held)} leaves and {len(keys)} optimizer "
            f"entries a parameter, manifest layout has {len(layout)} — "
            f"structure mismatch")
    return keys


def load_state(state, layout: List[dict], fetch) -> None:
    """Fill ``state`` (a ``TrainState``, on one device or this rank's part
    of a plan) leaf by leaf from the stream ``fetch(lo, hi)`` reads;
    every leaf is held to the layout's shape and type."""
    leaves = state.leaves(_leaf_entry_keys(state, layout))
    if len(leaves) != len(layout):
        raise ValueError(
            f"target has {len(leaves)} leaves, manifest layout has "
            f"{len(layout)} — structure mismatch")
    off = 0
    for leaf, entry in zip(leaves, layout):
        if list(leaf.shape) != entry["shape"] or (
                leaf.dtype is not None and
                _DTYPE_NAMES[leaf.dtype] != entry["dtype"]):
            raise ValueError(f"{leaf.name}: target {list(leaf.shape)} "
                             f"{leaf.dtype}, manifest {entry}")
        leaf.load(lambda rows=None, off=off, entry=entry:
                  read_leaf_rows(fetch, off, entry, rows))
        off += entry["nbytes"]


def rebuild_state(stream: bytes, layout: List[dict], target):
    """Rebuild ``target``'s structure from a restored stream: a
    ``TrainState`` is filled in place (and returned), another state is
    rebuilt as a new tree of arrays (tensors for tensor leaves).
    Bit-stable: the values are the exact bytes the manifest named."""
    total = sum(e["nbytes"] for e in layout)
    if len(stream) < total:
        raise ValueError(f"stream truncated: wanted {total} bytes, got "
                         f"{len(stream)}")
    if len(stream) != total:
        raise ValueError(f"stream has {len(stream) - total} trailing bytes")
    if _is_train_state(target):
        view = memoryview(stream)
        load_state(target, layout, lambda lo, hi: view[lo:hi])
        return target
    leaves = _tree_leaves(target)
    if len(leaves) != len(layout):
        raise ValueError(
            f"target has {len(leaves)} leaves, manifest layout has "
            f"{len(layout)} — structure mismatch")
    out, off = [], 0
    for leaf, entry in zip(leaves, layout):
        chunk = stream[off:off + entry["nbytes"]]
        if torch.is_tensor(leaf):
            out.append(_host_tensor(chunk, entry).clone())
        else:
            out.append(np.frombuffer(chunk, dtype=entry["dtype"]).reshape(
                entry["shape"]).copy())
        off += entry["nbytes"]
    return _tree_unflatten(target, out)


# ---------------------------------------------------------------------------
# Per-shard streaming writer + job-level commit
# ---------------------------------------------------------------------------

class ShardStreamWriter:
    """One worker's half of the protocol: stream MY byte range,
    chunked; upload only what changed; stage my shard manifest.  Keeps
    the previous step's chunk map in memory so a delta write hashes
    locally and touches the store only for changed chunks."""

    def __init__(self, store: BlobStore, job: str, shard: int,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES):
        self.store = store
        self.job = job
        self.shard = shard
        self.chunk_bytes = chunk_bytes
        # chunk index -> blob id of the last committed write (the delta
        # comparison base).  Seed from the store after a restart via
        # seed_from_store().
        self.base_view: Dict[int, str] = {}

    def seed_from_store(self) -> Optional[int]:
        """Adopt the latest restorable manifest's view of this shard
        (a restarted worker deltas against what the store has, not
        against nothing).  Returns the adopted step or None."""
        latest = latest_restorable(self.store, self.job)
        if latest is None:
            return None
        step, chain = latest
        view = effective_chunks(chain).get(self.shard, {})
        self.base_view = {idx: ref["blob"] for idx, ref in view.items()}
        return step

    def write(self, step: int, data, kind: str,
              base_step: Optional[int] = None) -> Tuple[dict, int]:
        """Upload this shard's changed chunks for ``step`` (``data``:
        bytes or a buffer) and stage its shard manifest.  Returns (shard
        manifest body, bytes uploaded).  ``kind=full`` lists (and puts)
        every chunk — puts of unchanged content dedup to zero transfer;
        ``kind=delta`` lists only changed chunks."""
        data = memoryview(data)
        spans = chunk_spans(len(data), self.chunk_bytes)
        pieces = [data[lo:hi] for lo, hi in spans]
        chunks: Dict[str, dict] = {}
        before = self.store.counters["bytes_written"]
        # A large shard's chunks are hashed on WRITE_WORKERS threads
        # (hashlib lets go of the GIL); the store serialises its writes.
        pool = ThreadPoolExecutor(max_workers=WRITE_WORKERS,
                                  thread_name_prefix="ckpt-write") \
            if len(data) >= PARALLEL_WRITE_BYTES else None
        run = pool.map if pool is not None else map
        try:
            if kind == KIND_DELTA:
                ids = list(run(blob_id_for, pieces))
                changed = [i for i, cid in enumerate(ids)
                           if self.base_view.get(i) != cid]
            else:
                changed = list(range(len(pieces)))
            # A full put hashes once: the store returns the content id.
            put = list(run(self.store.put, [pieces[i] for i in changed]))
        finally:
            if pool is not None:
                pool.shutdown()
        new_view = dict(enumerate(ids)) if kind == KIND_DELTA else {}
        for i, cid in zip(changed, put):
            new_view[i] = cid
            chunks[str(i)] = {"blob": cid, "nbytes": len(pieces[i])}
        uploaded = self.store.counters["bytes_written"] - before
        body = {
            "shard": self.shard,
            "num_chunks": len(spans),
            "length": len(data),
            "kind": kind,
            "base_step": base_step if kind == KIND_DELTA else None,
            "chunks": chunks,
        }
        self.store.commit_shard_manifest(self.job, step, self.shard, body)
        self.base_view = new_view
        return body, uploaded


def commit_step(store: BlobStore, job: str, step: int, kind: str,
                num_shards: int, layout: List[dict], total_bytes: int,
                chunk_bytes: int, base_step: Optional[int] = None,
                depth: int = 0) -> dict:
    """The coordinator's half: once every shard manifest for ``step``
    is staged, publish the atomic job-level manifest.  Raises if any
    shard is missing — a partial gang write can never become visible."""
    staged = store.shard_manifests(job, step)
    missing = [s for s in range(num_shards) if s not in staged]
    if missing:
        raise ValueError(
            f"cannot commit {job} step {step}: shard manifests missing "
            f"for shards {missing}")
    body = build_manifest(
        job=job, step=step, kind=kind, num_shards=num_shards,
        layout=layout, total_bytes=total_bytes, chunk_bytes=chunk_bytes,
        shards={s: staged[s] for s in range(num_shards)},
        base_step=base_step, depth=depth)
    store.commit_manifest(job, step, body)
    return body


def fetch_stream(store: BlobStore, chain: List[dict],
                 max_workers: int = 8) -> bytes:
    """Parallel resharded-restore read path: resolve the chain's
    effective chunk view and fetch ALL shards concurrently — restore
    cost scales with state bytes / parallelism, not with gang size or
    chain length."""
    head = chain[-1]
    view = effective_chunks(chain)
    num_shards = head["num_shards"]

    def fetch_shard(shard: int) -> bytes:
        chunks = view.get(shard, {})
        return b"".join(store.get(chunks[idx]["blob"])
                        for idx in sorted(chunks))

    if num_shards == 1:
        return fetch_shard(0)
    with ThreadPoolExecutor(
            max_workers=min(max_workers, num_shards),
            thread_name_prefix="ckpt-restore") as pool:
        parts = list(pool.map(fetch_shard, range(num_shards)))
    return b"".join(parts)


class StreamReader:
    """Byte ranges of a manifest chain's stream, fetching only the chunks
    that cover them, ``RESTORE_WORKERS`` at a time (each verified by the
    store), into one staging buffer that every read reuses: page-locked
    when there is a card, so the caller's copy to it is a DMA.  The last
    chunk is kept, since the next leaf usually starts in it.
    ``fetch(lo, hi)`` (a uint8 view of the staging buffer, valid until
    the next fetch) is what :func:`load_state` reads through."""

    def __init__(self, store: BlobStore, chain: List[dict]):
        head = chain[-1]
        self.store = store
        self.view = effective_chunks(chain)
        self.chunk_bytes = head["chunk_bytes"]
        self.bounds = shard_ranges(head["total_bytes"], head["num_shards"])
        self._last: Tuple[Optional[Tuple[int, int]], bytes] = (None, b"")
        self._pool = ThreadPoolExecutor(max_workers=RESTORE_WORKERS,
                                        thread_name_prefix="ckpt-restore")
        self._stage = torch.empty(0, dtype=torch.uint8)

    def close(self) -> None:
        self._pool.shutdown()

    def _get(self, key: Tuple[int, int]) -> bytes:
        if self._last[0] == key:
            return self._last[1]
        return self.store.get(self.view[key[0]][key[1]]["blob"])

    def fetch(self, lo: int, hi: int) -> torch.Tensor:
        pieces = []          # (stream offset of the chunk, shard, index)
        for shard, (a, b) in enumerate(self.bounds):
            if b <= lo or a >= hi or a == b:
                continue
            first = (max(lo, a) - a) // self.chunk_bytes
            last = (min(hi, b) - 1 - a) // self.chunk_bytes
            pieces += [(a + i * self.chunk_bytes, shard, i)
                       for i in range(first, last + 1)]
        if self._stage.numel() < hi - lo:
            self._stage = None
            self._stage = host_buffer(hi - lo)
        out = self._stage[:hi - lo].numpy()

        def place(piece):
            start, shard, idx = piece
            data = self._get((shard, idx))
            a, b = max(lo, start), min(hi, start + len(data))
            # numpy copies without the GIL: the workers copy in parallel.
            np.copyto(out[a - lo:b - lo], np.frombuffer(
                data, np.uint8, b - a, a - start))
            return data

        datas = list(self._pool.map(place, pieces))
        if pieces:
            self._last = (pieces[-1][1:], datas[-1])
        return self._stage[:hi - lo]


# ---------------------------------------------------------------------------
# Train-loop manager
# ---------------------------------------------------------------------------

class ManifestCheckpointManager:
    """Drop-in for ``utils.checkpoint.CheckpointManager`` over the blob
    store: ``maybe_save``/``save``/``drain``/``restore``/``resume_step``
    plus ``completed_since_last_poll`` all keep their contracts, so
    ``run_train_loop`` (and its preemption checkpoint-then-exit path)
    runs on the data plane unchanged.

    Kind selection (``save(..., kind=None)``): DELTA whenever a recent
    base exists — same serialized size, chain depth under the
    compaction bound, and fewer than ``full_every`` saves since the
    last full; otherwise FULL.  The compaction bound keeps restores at
    O(shards) reads (manifest.MAX_DELTA_DEPTH).

    In a process group of ``world`` > 1, every rank builds the manager
    (it forms a gloo group for the writer threads' agreement) and calls
    ``save`` together (the state's mesh must span the group):
    ``num_shards`` is ``world`` (a ``num_shards`` other than 1 or
    ``world`` raises), each rank writes shard ``rank``, and rank 0
    commits once every rank has staged its own.  A writer failure on any
    rank fails the save on every rank.  ``store`` is then a directory
    store every rank reaches."""

    def __init__(self, store: BlobStore, job: str, every: int = 100,
                 num_shards: int = 1,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 full_every: int = 4,
                 max_delta_depth: int = MAX_DELTA_DEPTH,
                 async_save: bool = True, goodput=None, registry=None):
        self.store = store
        self.job = job
        self.every = every
        self.chunk_bytes = chunk_bytes
        self.full_every = full_every
        self.max_delta_depth = min(max_delta_depth, MAX_DELTA_DEPTH)
        self.async_save = async_save
        self.goodput = goodput
        self.metrics = ckpt_metrics(registry)
        self.rank, self.world = 0, 1
        self._group = None
        if dist.is_initialized() and dist.get_world_size() > 1:
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
            if num_shards not in (1, self.world):
                raise ValueError(
                    f"num_shards={num_shards} in a group of {self.world}: "
                    f"each rank writes its own shard")
            num_shards = self.world
            # The writer thread's own group: the step's collectives go on
            # beside it on the default one.
            self._group = dist.new_group(backend="gloo")
        self.num_shards = num_shards
        own = [self.rank] if self.world > 1 else range(num_shards)
        self._writers = [ShardStreamWriter(store, job, s, chunk_bytes)
                         for s in own]
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._writer_error: Optional[BaseException] = None
        self._completed_since_poll = False
        self._host: Optional[torch.Tensor] = None
        self.last_written_step: Optional[int] = None
        self.last_save_kind: Optional[str] = None
        # Base-chain state for kind selection.
        self._base_step: Optional[int] = None
        self._depth = 0
        self._since_full = 0
        self._base_total: Optional[int] = None
        self._adopt_base()

    def _adopt_base(self) -> None:
        """Chain onto whatever the store already has (a respawned
        writer deltas against the surviving manifests)."""
        latest = latest_restorable(self.store, self.job)
        if latest is None:
            return
        step, chain = latest
        head = chain[-1]
        if (head["num_shards"] != self.num_shards
                or head["chunk_bytes"] != self.chunk_bytes):
            return  # layout changed (resharded restart): next save is full
        self._base_step = step
        self._depth = head["depth"]
        self._base_total = head["total_bytes"]
        view = effective_chunks(chain)
        for writer in self._writers:
            writer.base_view = {
                idx: ref["blob"]
                for idx, ref in view.get(writer.shard, {}).items()}

    # -- async writer machinery (utils/checkpoint.py idiom) ----------------
    def _join_inflight(self) -> None:
        thread = self._thread
        if thread is not None:
            thread.join()

    def _raise_writer_error(self) -> None:
        with self._lock:
            err, self._writer_error = self._writer_error, None
        if err is not None:
            raise err

    def drain(self) -> None:
        """Block until the in-flight write finished; re-raise a stored
        writer failure (fatal-loud, never a silently dead writer)."""
        self._join_inflight()
        self._raise_writer_error()

    def completed_since_last_poll(self) -> bool:
        with self._lock:
            done, self._completed_since_poll = \
                self._completed_since_poll, False
        return done

    @property
    def in_flight(self) -> bool:
        thread = self._thread
        return thread is not None and thread.is_alive()

    # -- kind selection ----------------------------------------------------
    def _choose_kind(self, total_bytes: int) -> str:
        if self._base_step is None or self._base_total != total_bytes:
            return KIND_FULL
        if self._depth >= self.max_delta_depth:
            return KIND_FULL  # compaction: bound the chain
        if self._since_full >= self.full_every:
            return KIND_FULL
        return KIND_DELTA

    # -- save --------------------------------------------------------------
    def maybe_save(self, state, step: int) -> bool:
        if self.every and step % self.every == 0 and step > 0:
            self.save(state, step)
            return True
        return False

    def shard_range(self, total: int) -> Tuple[int, int]:
        """The bytes of the stream this process writes: its shard's in a
        group, the whole stream otherwise."""
        if self.world > 1:
            return shard_ranges(total, self.world)[self.rank]
        return 0, total

    def snapshot(self, state) -> Tuple[List[dict], int, Any]:
        """(layout, total bytes, this process's bytes of the stream): the
        device-to-host copy a save takes on the caller's thread."""
        if not _is_train_state(state):
            layout, stream = serialize_state(state)
            lo, hi = self.shard_range(len(stream))
            return layout, len(stream), bytearray(memoryview(stream)[lo:hi])
        if self.world > 1 and state.plan is not None and \
                state.plan.full_mesh.mesh.numel() != self.world:
            raise ValueError("a per-rank save needs the state's mesh to "
                             "span the process group")
        leaves, layout = state_layout(state)
        total = sum(e["nbytes"] for e in layout)
        lo, hi = self.shard_range(total)
        # The host buffer is kept for the next save (the write that held
        # it has ended by then); one of another size replaces it.
        if self._host is None or self._host.numel() != hi - lo:
            self._host = None
            self._host = host_buffer(hi - lo)
        return layout, total, stream_range(leaves, layout, lo, hi,
                                           self._host)

    def save(self, state, step: int, kind: Optional[str] = None) -> str:
        """Snapshot on the caller thread, chunk/hash/upload/commit on
        the writer thread (async default).  Returns the chosen kind."""
        self._raise_writer_error()
        self._join_inflight()
        self._raise_writer_error()
        if self.goodput is not None:
            with self.goodput.checkpoint_save():
                snap = self.snapshot(state)
        else:
            snap = self.snapshot(state)
        chosen = kind or self._choose_kind(snap[1])
        if not self.async_save:
            self._write(*snap, step, chosen)
            self._raise_writer_error()
            return chosen
        self._thread = threading.Thread(
            target=self._write, args=(*snap, step, chosen),
            name=f"ckpt-manifest-writer-{step}", daemon=True)
        self._thread.start()
        return chosen

    def _agree(self, ok: bool) -> bool:
        """Whether every rank's ``ok`` holds (a gloo all-reduce in a
        group)."""
        if self.world == 1:
            return ok
        flag = torch.tensor([int(ok)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self._group)
        return bool(flag.item())

    def _write(self, layout: List[dict], total: int, data, step: int,
               kind: str) -> None:
        try:
            with self.metrics["write_seconds"].time():
                base = self._base_step if kind == KIND_DELTA else None
                uploaded, error = 0, None
                try:
                    if self.world > 1:
                        pieces = [(self._writers[0], memoryview(data))]
                    else:
                        pieces = [(writer, memoryview(data)[lo:hi])
                                  for writer, (lo, hi) in zip(
                                      self._writers,
                                      shard_ranges(total, self.num_shards))]
                    for writer, piece in pieces:
                        _, nbytes = writer.write(step, piece, kind,
                                                 base_step=base)
                        uploaded += nbytes
                except BaseException as exc:
                    error = exc
                if not self._agree(error is None):
                    raise error or RuntimeError(
                        f"checkpoint step {step}: another rank's shard "
                        f"write failed")
                depth = self._depth + 1 if kind == KIND_DELTA else 0
                if self.rank == 0:
                    try:
                        commit_step(
                            self.store, self.job, step, kind,
                            self.num_shards, layout, total,
                            self.chunk_bytes, base_step=base, depth=depth)
                    except BaseException as exc:
                        error = exc
                if not self._agree(error is None):
                    raise error or RuntimeError(
                        f"checkpoint step {step}: rank 0's commit failed")
            self.metrics["writes"].labels(kind).inc()
            self.metrics["bytes"].labels(kind).inc(uploaded)
            with self._lock:
                self._completed_since_poll = True
                self.last_written_step = step
                self.last_save_kind = kind
                self._base_step = step
                self._depth = depth
                self._base_total = total
                self._since_full = 0 if kind == KIND_FULL \
                    else self._since_full + 1
        except BaseException as exc:  # fatal-loud, re-raised on the loop
            try:
                from ..telemetry import flight
                flight.record("ckpt", "manifest_writer_error", step=step,
                              kind=kind, error=repr(exc))
            # Best-effort telemetry must never mask the stored error.
            except Exception:  # lint: allow[silent-except]
                pass
            with self._lock:
                self._completed_since_poll = True
                self._writer_error = exc

    # -- restore -----------------------------------------------------------
    def resume_step(self) -> int:
        self.drain()
        latest = latest_restorable(self.store, self.job)
        return latest[0] if latest is not None else 0

    def _chain(self, step: Optional[int]) -> Optional[List[dict]]:
        if step is None:
            latest = latest_restorable(self.store, self.job)
            return None if latest is None else latest[1]
        chain = resolve_chain(self.store, self.job, step)
        if chain is None or chain_complete(self.store, chain):
            raise BlobRestoreError(
                f"{self.job} step {step} is not restorable")
        return chain

    def _fill(self, state, chain: List[dict]) -> None:
        reader = StreamReader(self.store, chain)
        try:
            load_state(state, chain[-1]["layout"], reader.fetch)
        finally:
            reader.close()

    def restore(self, target, step: Optional[int] = None):
        """Restore the newest restorable state (or ``step``'s) into
        ``target``: a ``TrainState`` is filled in place, each rank of a
        plan reading only what it holds; another state is rebuilt as host
        arrays.  ``target`` unchanged when the store has nothing for this
        job."""
        self.drain()
        with self.metrics["restore_seconds"].time():
            chain = self._chain(step)
            if chain is None:
                return target
            if _is_train_state(target):
                self._fill(target, chain)
                restored = target
            else:
                stream = fetch_stream(self.store, chain)
                restored = rebuild_state(stream, chain[-1]["layout"], target)
        self.metrics["restores"].labels(chain[-1]["kind"]).inc()
        return restored

    def restore_resharded(self, target, mesh, param_specs=None,
                          shard_update: bool = False,
                          step: Optional[int] = None, model=None,
                          pipeline_schedule: str = "gpipe",
                          microbatches: int = 4, virtual_stages: int = 1,
                          pp_fsdp: bool = False):
        """Restore onto ``mesh`` in one motion: the model is built on the
        meta device and placed by the new mesh's plan (as
        ``parallel.train.reshard_train_state`` places it, with its
        arguments), then each rank fills its own shards from the manifest
        one leaf at a time.  ``target`` (a ``TrainState`` on any mesh, or
        on the meta device) gives the model's class, config and storage
        type (or ``model``: a fresh model for the new mesh) and the
        optimizer's class and hyperparameters.  Every rank of the group
        calls it; returns the restored state on the ranks of ``mesh``,
        None on the others, ``target`` when nothing is restorable."""
        from ..parallel.train import _llama_build, state_on_mesh
        self.drain()
        t0 = time.perf_counter()
        chain = self._chain(step)
        if chain is None:
            return target  # nothing restorable: keep the fresh init
        new = state_on_mesh(
            mesh, _llama_build(target.model),
            (type(target.optimizer), target.optimizer.defaults),
            param_specs, shard_update, model, pipeline_schedule,
            microbatches, virtual_stages, pp_fsdp)
        if new is None:
            return None
        self._fill(new, chain)
        self.metrics["restore_seconds"].observe(time.perf_counter() - t0)
        self.metrics["restores"].labels(chain[-1]["kind"]).inc()
        return new


class BlobRestoreError(Exception):
    """An explicitly requested step could not be restored."""
