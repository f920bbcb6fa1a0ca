"""Checkpoint/resume of a train state: counterpart of
``mpi_operator_tpu/utils/checkpoint.py`` over ``torch.save``.

The state is any object with ``state_dict()`` / ``load_state_dict()``
(``parallel.train.TrainState``: step, model and optimizer).  Two
properties carry over from the JAX module:

- **Atomic commit**: a save writes ``step_NNNNNNNN.tmp-w/state.pt``,
  drops a ``_COMMITTED`` marker, then renames the directory to
  ``step_NNNNNNNN``; :func:`latest_steps` / :func:`restore_checkpoint`
  only ever see whole checkpoints.  Retention also sweeps stale tmp
  directories left by crashed writers.
- **Async saves** (:class:`CheckpointManager`, the default): ``save()``
  copies the state to host memory and hands the write to one background
  writer thread; the loop blocks only when a save finds the previous
  write still running.  A writer failure is recorded on the flight ring,
  dumped as a ``checkpoint-writer-error`` bundle, stored, and re-raised
  at the next save point or ``drain()``.

In a process group a save is collective and rank 0 writes:
``state_dict()`` gathers the full state (``parallel.train.TrainState``
under a mesh: FSDP2 shards and ZeRO chunks), every rank calls it, and
only rank 0 snapshots it to host memory and writes the one directory.
Every rank restores from that directory (``load_state_dict`` places the
full state back onto its shards), so the directory must be shared.
Sharded, manifest-based checkpoints, in which each rank writes and reads
only its own part, are ``ckpt/`` (``ManifestCheckpointManager``).

Saves and restores are ``checkpoint_save`` / ``checkpoint_restore``
spans.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, Optional

import torch

from ..telemetry.goodput import _tensors
from ..telemetry.metrics import default_registry
from ..telemetry.trace import span

COMMIT_MARKER = "_COMMITTED"
STATE_FILE = "state.pt"
TMP_SWEEP_AGE_ENV = "MPI_OPERATOR_CKPT_TMP_SWEEP_AGE_S"
DEFAULT_TMP_SWEEP_AGE_S = 3600.0


def _checkpoint_metrics(registry=None):
    registry = registry or default_registry()
    return {
        "save": registry.histogram(
            "checkpoint_save_seconds", "Checkpoint save wall time"),
        "restore": registry.histogram(
            "checkpoint_restore_seconds", "Checkpoint restore wall time"),
    }


def _async_metrics(registry=None):
    registry = registry or default_registry()
    return {
        "async_saves": registry.counter(
            "checkpoint_async_saves_total",
            "Checkpoint saves handed to the background writer thread"),
        "blocked_seconds": registry.counter(
            "checkpoint_save_blocked_seconds",
            "Train-loop seconds spent blocked waiting for an in-flight"
            " async checkpoint write"),
        "snapshot": registry.histogram(
            "checkpoint_snapshot_seconds",
            "Device-to-host state snapshot wall time (async save)"),
    }


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _tmp_dir(directory: str, step: int) -> str:
    return _step_dir(directory, step) + ".tmp-w"


def _dir_restorable(path: str) -> bool:
    """A final-named directory is restorable when it holds anything: the
    tmp+rename protocol only ever produces whole final directories, so a
    torn write is a ``.tmp-*`` directory (never listed) or an empty one."""
    try:
        return bool(os.listdir(path))
    except OSError:
        return False


def is_committed(directory: str, step: int) -> bool:
    return _dir_restorable(_step_dir(directory, step))


def _sweep_stale_tmp(directory: str) -> None:
    age = float(os.environ.get(TMP_SWEEP_AGE_ENV, DEFAULT_TMP_SWEEP_AGE_S))
    now = time.time()
    for name in os.listdir(directory):
        if not (name.startswith("step_") and ".tmp-" in name):
            continue
        path = os.path.join(directory, name)
        try:
            stale = now - os.path.getmtime(path) >= age
        except OSError:
            continue
        if stale:
            shutil.rmtree(path, ignore_errors=True)


def _to_host(tree):
    """A copy of a state dict with every tensor on the CPU (the snapshot
    must not change when the live state is updated in place)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _payload(state: Any):
    return state if isinstance(state, dict) else state.state_dict()


def is_writer() -> bool:
    """True on the process that writes checkpoints: rank 0 of the
    process group, or the only process."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(directory: str, state: Any, step: int,
                    keep: int = 3) -> str:
    """Save ``state`` (an object with ``state_dict()``, or a state dict)
    at ``step``; atomic: the write lands in ``step_NNNNNNNN.tmp-w`` and is
    renamed into place after the data and the ``_COMMITTED`` marker.
    In a process group every rank calls it and rank 0 writes."""
    path = _step_dir(directory, step)
    tmp = _tmp_dir(directory, step)
    with span("checkpoint_save", step=step), \
            _checkpoint_metrics()["save"].time():
        payload = _payload(state)
        if not is_writer():
            return path
        os.makedirs(directory, exist_ok=True)
        if os.path.isdir(tmp):
            # Crash leftover from a previous attempt at this exact step.
            shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, COMMIT_MARKER), "w") as f:
            f.write(f"step={step}\n")
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        os.rename(tmp, path)
    # Retention: drop the oldest beyond ``keep`` (keep <= 0 keeps all);
    # the step just written is never a candidate.
    if keep > 0:
        for old in latest_steps(directory)[:-keep]:
            if old != step:
                shutil.rmtree(_step_dir(directory, old), ignore_errors=True)
        _sweep_stale_tmp(directory)
    return path


def latest_steps(directory: str) -> list:
    """Sorted committed steps; tmp directories and empty final-named
    directories are never listed."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if not name.startswith("step_") or ".tmp-" in name:
            continue
        try:
            step = int(name.split("_")[1])
        except (IndexError, ValueError):
            continue
        if _dir_restorable(os.path.join(directory, name)):
            steps.append(step)
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = latest_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, target: Any,
                       step: Optional[int] = None) -> Any:
    """Load the newest (or the given) committed step into ``target`` (an
    object with ``load_state_dict``) and return it; ``target`` unchanged
    when no committed checkpoint exists.  An explicitly requested
    uncommitted step raises rather than restoring a torn write."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        return target
    if not is_committed(directory, step):
        raise ValueError(
            f"checkpoint step {step} in {directory} is uncommitted "
            f"(absent, empty, or still under a .tmp dir); refusing to "
            f"restore a torn write")
    with span("checkpoint_restore", step=step), \
            _checkpoint_metrics()["restore"].time():
        payload = torch.load(os.path.join(_step_dir(directory, step),
                                          STATE_FILE), weights_only=True)
        target.load_state_dict(payload)
    return target


class CheckpointManager:
    """Train-loop wrapper, async by default.

    >>> mgr = CheckpointManager(dir, every=100)
    >>> state = mgr.restore(state)           # resume if possible
    >>> for ...: state = ...; mgr.maybe_save(state, step)
    >>> mgr.drain()                          # flush the in-flight write

    Read APIs (``restore``/``resume_step``) drain the writer first, so
    they always observe the newest save."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3,
                 goodput=None, async_save: bool = True, registry=None):
        self.directory = directory
        self.every = every
        self.keep = keep
        self.goodput = goodput
        self.async_save = async_save
        self._metrics = _async_metrics(registry)
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._writer_error: Optional[BaseException] = None
        self._completed_since_poll = False
        self.last_written_step: Optional[int] = None

    def _join_inflight(self, count_blocked: bool) -> None:
        thread = self._thread
        if thread is None:
            return
        start = time.perf_counter()
        thread.join()
        if count_blocked:
            self._metrics["blocked_seconds"].inc(time.perf_counter() - start)

    def _raise_writer_error(self) -> None:
        with self._lock:
            err, self._writer_error = self._writer_error, None
        if err is not None:
            raise err

    def _write(self, host_state, step: int) -> None:
        try:
            save_checkpoint(self.directory, host_state, step, self.keep)
            with self._lock:
                self.last_written_step = step
        except BaseException as exc:  # stored, re-raised on the loop
            try:
                from ..telemetry import flight
                nbytes = sum(t.numel() * t.element_size()
                             for t in _tensors(host_state))
                flight.record("train", "checkpoint_writer_error",
                              step=step, in_flight_bytes=nbytes,
                              error=repr(exc))
                flight.dump_bundle("checkpoint-writer-error")
            # Best-effort telemetry must never mask the stored writer
            # error (re-raised at the next save point).
            except Exception:  # lint: allow[silent-except]
                pass
            with self._lock:
                self._writer_error = exc
        finally:
            with self._lock:
                self._completed_since_poll = True

    def drain(self) -> None:
        """Wait for the in-flight write; re-raise a writer failure."""
        self._join_inflight(count_blocked=False)
        self._raise_writer_error()

    def completed_since_last_poll(self) -> bool:
        """True exactly once after each async write finishes (the train
        loop re-polls the preemption notice on that edge)."""
        with self._lock:
            done, self._completed_since_poll = \
                self._completed_since_poll, False
        return done

    @property
    def in_flight(self) -> bool:
        thread = self._thread
        return thread is not None and thread.is_alive()

    def restore(self, target: Any) -> Any:
        self.drain()
        return restore_checkpoint(self.directory, target)

    def resume_step(self) -> int:
        self.drain()
        return latest_step(self.directory) or 0

    def maybe_save(self, state: Any, step: int) -> bool:
        if self.every and step % self.every == 0 and step > 0:
            self.save(state, step)
            return True
        return False

    def save(self, state: Any, step: int) -> str:
        """Unconditional save, also the preemption path.  Async mode
        returns once the host snapshot is taken."""
        self._raise_writer_error()
        # Never overlap two writes; this is the only wait on the step path.
        self._join_inflight(count_blocked=True)
        self._raise_writer_error()
        if not self.async_save:
            if self.goodput is not None:
                with self.goodput.checkpoint_save():
                    return save_checkpoint(self.directory, state, step,
                                           self.keep)
            return save_checkpoint(self.directory, state, step, self.keep)

        def _snapshot():
            with self._metrics["snapshot"].time():
                payload = _payload(state)      # every rank takes part
                return _to_host(payload) if is_writer() else None

        if self.goodput is not None:
            with self.goodput.checkpoint_save():
                host_state = _snapshot()
        else:
            host_state = _snapshot()
        if host_state is None:
            return _step_dir(self.directory, step)
        self._metrics["async_saves"].inc()
        self._thread = threading.Thread(
            target=self._write, args=(host_state, step),
            name=f"ckpt-writer-{step}", daemon=True)
        self._thread.start()
        return _step_dir(self.directory, step)
