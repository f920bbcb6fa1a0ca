"""Simulated content-addressed blob store for the checkpoint data plane:
the port's copy of ``mpi_operator_tpu/ckpt/blobstore.py`` (stdlib only).
Its objects on disk are the JAX module's byte for byte, so each package
reads a store the other wrote.

The store models the object-store half of a checkpoint pipeline the way
``k8s/wal.py`` models the log half: an injectable clock, explicit fault
hooks (slow uploads, failed uploads, a torn manifest at a writer crash),
fail-stop ``crash()`` semantics, and counters a harness can assert on.

Two backends behind one API:

- **memory** (default): a dict — unit tests and benches.
- **directory** (``root=...``): files under ``root/`` — shared by the
  real worker processes of a LocalCluster gang (tools/ckpt_smoke.py,
  the macro-soak's elastic gangs).

Content addressing is the durability contract: a blob's id IS the
SHA-256 of its bytes, so a reader can always verify bit-stability, and
re-uploading unchanged content is a free dedup hit — which is exactly
what makes delta checkpoints cheap (docs/RESILIENCE.md "Checkpoint
data plane").

Manifests are the visibility contract: blobs and per-shard manifests
are staged facts, readable by nobody until the job-level manifest
commits.  A manifest is stored as a checksummed envelope and committed
via tmp+rename; the one deliberately non-atomic path is the injected
``torn`` fault, which leaves truncated bytes at the final name (the
multipart-upload-died-mid-flight shape) — readers validate the
envelope checksum and fall back to the previous committed step, so a
torn manifest is never restored.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

BLOB_PREFIX = "sha256:"

# Manifest object names inside a job's manifest namespace.
_STEP_FMT = "step_{step:08d}"


class BlobError(Exception):
    """Base class for blob-store failures."""


class BlobUnavailableError(BlobError):
    """An upload/download failed (injected fault or missing blob)."""


class BlobWriterKilledError(BlobError):
    """The writer process was killed at an injected boundary (the
    crash-consistency property test's scalpel)."""


class BlobStoreCrashedError(BlobError):
    """The store was ``crash()``-ed; mutating verbs fail-stop."""


class BlobFaultBank:
    """Queued fault rules consulted on every store operation, in the
    mold of ``k8s.apiserver`` fault banks: a chaos injector arms rules,
    the store consumes them, and each rule self-expires after ``count``
    matching operations (skipping the first ``after`` matches).

    Modes: ``fail`` (upload raises BlobUnavailableError), ``slow``
    (upload stalls ``delay`` seconds), ``kill`` (writer dies at the
    boundary — BlobWriterKilledError), ``torn`` (commit writes a
    truncated manifest at the FINAL name, then the writer dies).
    """

    def __init__(self):
        self._rules: List[dict] = []
        self._lock = threading.Lock()
        self.applied: Dict[str, int] = {}

    def arm(self, op: str, mode: str, count: int = 1,
            delay: float = 0.0, after: int = 0) -> None:
        with self._lock:
            self._rules.append({"op": op, "mode": mode, "count": count,
                                "delay": delay, "after": after})

    def pending(self) -> int:
        with self._lock:
            return sum(r["count"] for r in self._rules)

    def clear(self) -> None:
        with self._lock:
            self._rules.clear()

    def check(self, op: str) -> Optional[dict]:
        """Consume (at most) one rule matching ``op``; returns the rule
        to apply or None.  ``after`` counts down silently first."""
        with self._lock:
            for rule in self._rules:
                if rule["op"] not in (op, "*"):
                    continue
                if rule["after"] > 0:
                    rule["after"] -= 1
                    return None
                rule["count"] -= 1
                if rule["count"] <= 0:
                    self._rules.remove(rule)
                key = f"{op}:{rule['mode']}"
                self.applied[key] = self.applied.get(key, 0) + 1
                return rule
        return None


def blob_id_for(data: bytes) -> str:
    return BLOB_PREFIX + hashlib.sha256(data).hexdigest()


def canonical_bytes(body: dict) -> bytes:
    """Canonical JSON encoding: sorted keys, no whitespace, no floats
    of ambiguous repr — the run-twice byte-identity contract for
    manifests rests on this (and on manifests carrying no wallclock)."""
    return json.dumps(body, sort_keys=True,
                      separators=(",", ":")).encode()


def _envelope(body: dict) -> bytes:
    payload = canonical_bytes(body)
    return canonical_bytes({
        "body": body,
        "sha256": hashlib.sha256(payload).hexdigest()})


def _open_envelope(raw: bytes) -> Optional[dict]:
    """Validated manifest body, or None for torn/corrupt bytes."""
    try:
        env = json.loads(raw.decode())
        body = env["body"]
        want = env["sha256"]
    except (ValueError, KeyError, TypeError, UnicodeDecodeError):
        return None
    if hashlib.sha256(canonical_bytes(body)).hexdigest() != want:
        return None
    return body


def _safe_job(job: str) -> str:
    return job.replace("/", "__")


class BlobStore:
    """Content-addressed blobs + committed checkpoint manifests.

    ``clock`` is injectable (seconds-valued callable) and defaults to a
    LOGICAL counter — nothing in the store depends on wall time, so a
    seeded scenario replays byte-identically.  ``fault_bank`` hooks
    every put/get/commit (see :class:`BlobFaultBank`).
    """

    def __init__(self, root: Optional[str] = None,
                 clock: Optional[Callable[[], float]] = None,
                 fault_bank: Optional[BlobFaultBank] = None):
        self.root = root
        self.faults = fault_bank or BlobFaultBank()
        self._logical = 0.0
        self._clock = clock
        self._lock = threading.RLock()
        self._crashed = False
        # Memory backend state (unused when root is set).
        self._blobs: Dict[str, bytes] = {}
        self._manifests: Dict[str, Dict[str, bytes]] = {}
        self.counters = {
            "puts": 0, "dedup_hits": 0, "bytes_written": 0,
            "bytes_deduped": 0, "gets": 0, "bytes_read": 0,
            "manifest_commits": 0, "torn_manifests": 0,
            "failed_puts": 0, "slow_puts": 0, "slow_seconds": 0.0,
        }
        if root is not None:
            os.makedirs(os.path.join(root, "blobs"), exist_ok=True)
            os.makedirs(os.path.join(root, "manifests"), exist_ok=True)

    # -- clock -------------------------------------------------------------
    def now(self) -> float:
        if self._clock is not None:
            return self._clock()
        with self._lock:
            self._logical += 0.001
            return self._logical

    # -- fail-stop ---------------------------------------------------------
    def crash(self) -> None:
        """Fail-stop the store: every subsequent mutating verb raises.
        Committed manifests and blobs stay readable — the store models
        a durable remote; ``crash()`` models losing the WRITER's lease
        on it (wal.py crash idiom)."""
        with self._lock:
            self._crashed = True

    def _check_mutable(self) -> None:
        if self._crashed:
            raise BlobStoreCrashedError("blob store crashed (fail-stop)")

    def _apply_fault(self, op: str) -> Optional[dict]:
        rule = self.faults.check(op)
        if rule is None:
            return None
        if rule["mode"] == "slow":
            self.counters["slow_puts"] += 1
            self.counters["slow_seconds"] += rule["delay"]
            if self._clock is None:
                with self._lock:
                    self._logical += rule["delay"]
            else:
                time.sleep(min(rule["delay"], 2.0))
            return None
        if rule["mode"] == "fail":
            self.counters["failed_puts"] += 1
            raise BlobUnavailableError(f"injected {op} failure")
        if rule["mode"] == "kill":
            raise BlobWriterKilledError(f"writer killed at {op} boundary")
        return rule  # "torn" handled by the commit path

    # -- blobs -------------------------------------------------------------
    def _blob_path(self, blob_id: str) -> str:
        return os.path.join(self.root, "blobs",
                            blob_id.replace(":", "-"))

    def has(self, blob_id: str) -> bool:
        if self.root is None:
            with self._lock:
                return blob_id in self._blobs
        return os.path.exists(self._blob_path(blob_id))

    def put(self, data: bytes) -> str:
        """Upload ``data``; returns its content address.  Re-uploading
        existing content is a dedup hit (0 bytes transferred) — the
        delta-checkpoint economics in one line."""
        self._check_mutable()
        self._apply_fault("put")
        blob_id = blob_id_for(data)
        with self._lock:
            self.counters["puts"] += 1
            if self.has(blob_id):
                self.counters["dedup_hits"] += 1
                self.counters["bytes_deduped"] += len(data)
                return blob_id
            self.counters["bytes_written"] += len(data)
            if self.root is None:
                self._blobs[blob_id] = bytes(data)
            else:
                path = self._blob_path(blob_id)
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
        return blob_id

    def get(self, blob_id: str) -> bytes:
        """Download + verify: the returned bytes always hash to the
        id (bit-stability is checked on every read, not trusted)."""
        self._apply_fault("get")
        if self.root is None:
            with self._lock:
                data = self._blobs.get(blob_id)
        else:
            try:
                with open(self._blob_path(blob_id), "rb") as f:
                    data = f.read()
            except OSError:
                data = None
        if data is None:
            raise BlobUnavailableError(f"blob {blob_id} not in store")
        if blob_id_for(data) != blob_id:
            raise BlobUnavailableError(
                f"blob {blob_id} failed content verification")
        with self._lock:
            self.counters["gets"] += 1
            self.counters["bytes_read"] += len(data)
        return data

    # -- manifests ---------------------------------------------------------
    def _manifest_dir(self, job: str) -> str:
        return os.path.join(self.root, "manifests", _safe_job(job))

    def _manifest_names(self, job: str) -> List[str]:
        if self.root is None:
            with self._lock:
                return sorted(self._manifests.get(_safe_job(job), {}))
        try:
            return sorted(os.listdir(self._manifest_dir(job)))
        except OSError:
            return []

    def _read_object(self, job: str, name: str) -> Optional[bytes]:
        if self.root is None:
            with self._lock:
                return self._manifests.get(_safe_job(job), {}).get(name)
        try:
            with open(os.path.join(self._manifest_dir(job), name),
                      "rb") as f:
                return f.read()
        except OSError:
            return None

    def _write_object(self, job: str, name: str, raw: bytes,
                      torn: bool = False) -> None:
        if self.root is None:
            with self._lock:
                self._manifests.setdefault(_safe_job(job), {})[name] = raw
            return
        directory = self._manifest_dir(job)
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, name)
        if torn:
            # The deliberately non-atomic path: truncated bytes land at
            # the FINAL name (a multipart upload died mid-flight).
            with open(path, "wb") as f:
                f.write(raw)
            return
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(raw)
        os.replace(tmp, path)

    def commit_shard_manifest(self, job: str, step: int, shard: int,
                              body: dict) -> None:
        """Stage one shard's manifest for ``step``.  Invisible to
        readers until the job-level manifest commits."""
        self._check_mutable()
        self._apply_fault("commit_shard")
        name = _STEP_FMT.format(step=step) + f".shard_{shard:04d}.json"
        self._write_object(job, name, _envelope(body))

    def shard_manifests(self, job: str, step: int) -> Dict[int, dict]:
        """Staged shard manifests for ``step`` (commit-protocol view)."""
        prefix = _STEP_FMT.format(step=step) + ".shard_"
        out: Dict[int, dict] = {}
        for name in self._manifest_names(job):
            if not (name.startswith(prefix) and name.endswith(".json")):
                continue
            raw = self._read_object(job, name)
            body = _open_envelope(raw) if raw is not None else None
            if body is None:
                continue
            try:
                shard = int(name[len(prefix):-len(".json")])
            except ValueError:
                continue
            out[shard] = body
        return out

    def commit_manifest(self, job: str, step: int, body: dict) -> None:
        """Atomically publish the job-level manifest for ``step`` —
        THE commit point: before this no reader sees the checkpoint,
        after it every reader sees all of it.  An armed ``torn`` fault
        models the non-atomic store: truncated bytes at the final name,
        then the writer dies."""
        self._check_mutable()
        rule = self._apply_fault("commit")
        raw = _envelope(body)
        name = _STEP_FMT.format(step=step) + ".json"
        if rule is not None and rule["mode"] == "torn":
            cut = max(1, int(len(raw) * 0.6))
            self._write_object(job, name, raw[:cut], torn=True)
            self.counters["torn_manifests"] += 1
            raise BlobWriterKilledError(
                f"writer killed mid-commit of {job} step {step}"
                f" (torn manifest left behind)")
        self._write_object(job, name, raw)
        with self._lock:
            self.counters["manifest_commits"] += 1

    def manifest_steps(self, job: str) -> List[int]:
        """Committed steps whose manifest VALIDATES (torn manifests are
        invisible here by construction)."""
        steps = []
        for name in self._manifest_names(job):
            if not (name.startswith("step_") and name.endswith(".json")
                    and ".shard_" not in name and ".tmp" not in name):
                continue
            try:
                step = int(name[len("step_"):-len(".json")])
            except ValueError:
                continue
            raw = self._read_object(job, name)
            if raw is not None and _open_envelope(raw) is not None:
                steps.append(step)
        return sorted(steps)

    def read_manifest(self, job: str, step: int) -> Optional[dict]:
        raw = self._read_object(job, _STEP_FMT.format(step=step) + ".json")
        if raw is None:
            return None
        return _open_envelope(raw)

    def jobs(self) -> List[str]:
        if self.root is None:
            with self._lock:
                keys = sorted(self._manifests)
        else:
            try:
                keys = sorted(os.listdir(os.path.join(self.root,
                                                      "manifests")))
            except OSError:
                keys = []
        return [k.replace("__", "/") for k in keys]
