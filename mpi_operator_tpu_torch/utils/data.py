"""Input pipeline helpers: counterpart of ``mpi_operator_tpu/utils/data.py``.
The token file loader is ``native/dataloader.py`` (``NativeTokenLoader``,
which splits the corpus by process); :func:`global_batch_iterator` feeds
each process its own rows of the global batch."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch


class _PrefetchDone:
    pass


class _PrefetchError:
    def __init__(self, exc: BaseException):
        self.exc = exc


def _to_device(item, device):
    if isinstance(item, (tuple, list)):
        return type(item)(_to_device(x, device) for x in item)
    return torch.as_tensor(item).to(device)


def global_batch_iterator(local_batch_fn: Callable[[int], Sequence],
                          mesh, device,
                          steps: Optional[int] = None) -> Iterator:
    """Yield this process's rows of each global batch, on ``device``.

    - local_batch_fn(step) -> tuple of arrays: THIS process's share,
      [global_batch / (dp*fsdp), ...].  Process p holds the rows
      ``parallel.mesh.batch_rows`` names for its mesh coordinate, the
      rows ``jax.make_array_from_process_local_data`` gives it, so no
      host ever holds the global batch.
    - mesh: the process's ``DeviceMesh`` (None: one process, a plain
      copy); every process of one batch shard must feed the same rows:
      ranks that differ only on 'tp' hold the same rows
      (``parallel.mesh.batch_rows``).  'sp', 'ep' and 'pp' above 1 raise.

    Tuples of tensors come out, as the JAX iterator yields tuples of
    global arrays."""
    if mesh is not None:
        from ..parallel.tensor import refuse_axes
        refuse_axes(mesh, "global_batch_iterator")
    step = 0
    while steps is None or step < steps:
        yield tuple(_to_device(arr, device) for arr in local_batch_fn(step))
        step += 1


class DevicePrefetcher:
    """Background batch prefetch.

    Pulls up to ``depth`` batches ahead of the consumer on a daemon
    thread and, when ``device`` is given, copies each batch there on that
    thread (the JAX module's ``device_put`` through ``shardings``), so
    batch assembly and the copy overlap the step in flight.  Source
    exceptions reach the consumer at the position they occurred.
    ``close()`` stops the thread without draining the source."""

    def __init__(self, source, depth: int = 2, device=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._source = iter(source)
        self._device = device
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(
            target=self._run, name="batch-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            for item in self._source:
                if self._device is not None:
                    item = _to_device(item, self._device)
                if not self._put(item):
                    return
            self._put(_PrefetchDone())
        except BaseException as exc:  # noqa: BLE001 — relayed to consumer
            self._put(_PrefetchError(exc))

    def __iter__(self):
        return self

    def __next__(self):
        if self._done or self._stop.is_set():
            raise StopIteration
        item = self._queue.get()
        if isinstance(item, _PrefetchDone):
            self._done = True
            raise StopIteration
        if isinstance(item, _PrefetchError):
            self._done = True
            raise item.exc
        return item

    def close(self) -> None:
        self._stop.set()
        # Unblock a producer parked on a full queue.
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5)


def synthetic_token_batches(batch_per_process: int, seq_len: int,
                            vocab_size: int) -> Callable[[int], tuple]:
    """Deterministic synthetic LM token batches (the same numbers as the
    JAX module's: numpy RandomState(0))."""
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, vocab_size, size=(batch_per_process, seq_len))

    def fn(step: int):
        return (tokens,)

    return fn
