"""Goodput accounting: where does train-loop wall time go?  Counterpart of
``mpi_operator_tpu/telemetry/goodput.py``.

Wall time is attributed to named buckets — productive steps, the first
(warm-up) step, input waits, checkpoint saves and resyncs — and
``summary()`` reports per-bucket seconds and fractions plus the goodput
fraction (productive / total).  Wrap a step function once with
:func:`instrument_step` and it attributes warm-up against productive
time itself.  A change of bucket is recorded on the flight ring
(``goodput_phase``), and the first step is the causal trace's
``compile`` milestone when the process carries a trace context.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Optional

import torch

PRODUCTIVE = "productive"
COMPILE = "compile"
DATA_WAIT = "data_wait"
CHECKPOINT = "checkpoint"
RESYNC = "resync"
OTHER = "other"

GOODPUT_BUCKETS = (PRODUCTIVE, COMPILE, DATA_WAIT, CHECKPOINT, RESYNC,
                   OTHER)


class GoodputTracker:
    """Thread-safe per-bucket wall-time accumulator; ``clock`` is
    injectable for deterministic tests."""

    def __init__(self, registry=None, clock: Callable[[], float]
                 = time.perf_counter, gauge_prefix: str = "train"):
        self._clock = clock
        self._lock = threading.Lock()
        self._seconds = {b: 0.0 for b in GOODPUT_BUCKETS}
        self._steps = 0
        self._gauge = None
        self._step_hist = None
        self._last_bucket: Optional[str] = None
        if registry is not None:
            self._gauge = registry.gauge(
                f"{gauge_prefix}_goodput_fraction",
                "Fraction of accounted wall time spent in productive"
                " train steps")
            self._step_hist = registry.histogram(
                f"{gauge_prefix}_step_seconds",
                "Productive train step wall time")

    def add(self, bucket: str, seconds: float, steps: int = 1) -> None:
        """Attribute ``seconds`` to ``bucket``; ``steps`` (PRODUCTIVE
        only) is how many train steps the window covers."""
        if bucket not in self._seconds:
            raise ValueError(f"unknown goodput bucket {bucket!r}; one of"
                             f" {GOODPUT_BUCKETS}")
        with self._lock:
            self._seconds[bucket] += seconds
            if bucket == PRODUCTIVE:
                self._steps += max(1, steps)
                if self._step_hist is not None:
                    per_step = seconds / max(1, steps)
                    for _ in range(max(1, steps)):
                        self._step_hist.observe(per_step)
            if self._gauge is not None:
                self._gauge.set(self._fraction_locked(PRODUCTIVE))
            transitioned = bucket != self._last_bucket
            self._last_bucket = bucket
        if transitioned:
            from .flight import record as flight_record
            flight_record("train", "goodput_phase", bucket=bucket,
                          seconds=round(seconds, 6))

    @contextlib.contextmanager
    def account(self, bucket: str):
        start = self._clock()
        try:
            yield
        finally:
            self.add(bucket, self._clock() - start)

    def step(self):
        return self.account(PRODUCTIVE)

    def compile(self):
        return self.account(COMPILE)

    def data_wait(self):
        return self.account(DATA_WAIT)

    def checkpoint_save(self):
        return self.account(CHECKPOINT)

    def resync(self):
        return self.account(RESYNC)

    def _fraction_locked(self, bucket: str) -> float:
        total = sum(self._seconds.values())
        return self._seconds[bucket] / total if total > 0 else 0.0

    def summary(self) -> dict:
        """Per-bucket seconds and fractions (summing to ~1.0 over the
        accounted wall time)."""
        with self._lock:
            seconds = dict(self._seconds)
            steps = self._steps
        total = sum(seconds.values())
        fractions = {b: (s / total if total > 0 else 0.0)
                     for b, s in seconds.items()}
        return {
            "total_seconds": total,
            "steps": steps,
            "seconds": seconds,
            "fractions": fractions,
            "goodput": fractions[PRODUCTIVE],
            "steps_per_second": steps / total if total > 0 else 0.0,
        }


# Default sliding-sync period: steps dispatched between host blocks
# (1 = block every step; 0 = only at an explicit ``sync()``).
SYNC_EVERY_ENV = "MPI_OPERATOR_TRAIN_SYNC_EVERY"
DEFAULT_SYNC_EVERY = 32


def _resolve_sync_every(sync_every: Optional[int]) -> int:
    if sync_every is None:
        sync_every = int(os.environ.get(SYNC_EVERY_ENV,
                                        DEFAULT_SYNC_EVERY))
    if sync_every < 0:
        raise ValueError(f"sync_every must be >= 0, got {sync_every}")
    return sync_every


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)


def _block(out):
    """Wait for the work that produces ``out``: synchronise the current
    stream of every card its tensors live on (the JAX module's
    ``block_until_ready``)."""
    devices = {t.device for t in _tensors(out) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return out


def instrument_step(step_fn: Callable, goodput: Optional[GoodputTracker]
                    = None, registry=None,
                    histogram_name: str = "train_step_seconds",
                    sync_every: Optional[int] = None) -> Callable:
    """Wrap a train step function with wall-time attribution.

    The first call blocks on its outputs and goes to the ``compile``
    bucket (kernel builds and library warm-up dominate it).  Later calls
    return without blocking, and every ``sync_every`` steps the wrapper
    blocks on that step's outputs and attributes the window's host wall
    time to ``productive`` as that many steps.  Counters on ``registry``
    (or the process default): ``train_steps_dispatched_total`` (every
    call) and ``train_host_blocks_total`` (every post-warm-up block).
    The wrapper exposes ``sync()`` (flush the open window) and
    ``goodput``."""
    from .metrics import default_registry
    from .trace import default_tracer, env_context

    if goodput is None:
        goodput = GoodputTracker()
    sync_every = _resolve_sync_every(sync_every)
    hist = None
    if registry is not None and goodput._step_hist is None:
        hist = registry.histogram(
            histogram_name, "Train step wall time (post-compile)")
    reg = registry if registry is not None else default_registry()
    dispatched_total = reg.counter(
        "train_steps_dispatched_total",
        "Train steps dispatched through the instrumented step wrapper")
    host_blocks_total = reg.counter(
        "train_host_blocks_total",
        "Post-compile host blocks on in-flight train steps (sliding"
        " goodput syncs + explicit sync() calls)")
    state = {"compiled": False, "pending_seconds": 0.0, "pending_steps": 0,
             "last_out": None}
    lock = threading.Lock()

    def _observe(seconds: float, steps: int) -> None:
        goodput.add(PRODUCTIVE, seconds, steps=steps)
        if hist is not None:
            for _ in range(max(1, steps)):
                hist.observe(seconds / max(1, steps))

    def _flush_locked() -> None:
        if state["pending_steps"]:
            _observe(state["pending_seconds"], state["pending_steps"])
        state["pending_seconds"] = 0.0
        state["pending_steps"] = 0
        state["last_out"] = None

    def wrapped(*args, **kwargs):
        start = goodput._clock()
        out = step_fn(*args, **kwargs)
        dispatched_total.inc()
        with lock:
            if not state["compiled"]:
                state["compiled"] = True
                out = _block(out)
                elapsed = goodput._clock() - start
                goodput.add(COMPILE, elapsed)
                # Causal-trace milestone, parented to the carried job
                # context.  The name is the JAX package's (the analyzer
                # decomposes by name), but nothing is compiled by XLA
                # here: the span is the first step, up to its output on
                # the host, with the CUDA kernels' first-use nvcc builds
                # (ops/_build.py) and library warm-up in it.
                ctx = env_context()
                if ctx is not None:
                    default_tracer().emit("compile",
                                          ts=time.time() - elapsed,
                                          dur=elapsed, ctx=ctx)
                return out
            state["pending_steps"] += 1
            state["last_out"] = out
            boundary = (sync_every >= 1
                        and state["pending_steps"] >= sync_every)
            if boundary:
                out = _block(out)
                host_blocks_total.inc()
            state["pending_seconds"] += goodput._clock() - start
            if boundary:
                _flush_locked()
        return out

    def sync():
        """Block on the last in-flight step and flush the open window;
        returns its outputs, or None when the window is empty."""
        with lock:
            out = state["last_out"]
            if state["pending_steps"] == 0:
                return out
            start = goodput._clock()
            out = _block(out)
            host_blocks_total.inc()
            state["pending_seconds"] += goodput._clock() - start
            _flush_locked()
        return out

    wrapped.goodput = goodput
    wrapped.sync = sync
    wrapped.sync_every = sync_every
    return wrapped
