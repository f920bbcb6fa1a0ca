"""Lightweight span tracing (stdlib only): the port's copy of
``mpi_operator_tpu/telemetry/trace.py``, kept byte-compatible with it so
that contexts, JSONL exports and Chrome traces cross between the two
packages.

Nestable ``with span("checkpoint_save", step=n):`` blocks with
thread-local parenting, collected as plain dict events that round-trip
through JSONL and export to Chrome trace-event format (chrome://tracing
and perfetto read it).

Event schema (one JSON object per line in the JSONL export)::

    {"name": str, "span_id": int, "parent_id": int | null,
     "ts": float wall-clock seconds at start, "dur": float seconds,
     "pid": int, "tid": int, "attrs": {str: json}, "error": str?,
     "trace_id": str?}

Causal tracing: thread-local parenting cannot follow a request across a
queue hop, an HTTP call or a process boundary, so spans also accept an
EXPLICIT :class:`TraceContext` (trace id + parent span id).  The context
travels as a string (``"<trace_id>:<span>"``) in object annotations
(:data:`TRACE_CONTEXT_ANNOTATION`), the worker environment
(:data:`TRACE_CONTEXT_ENV`) and the ``trace_context`` field of a serving
request; :meth:`Tracer.emit` records a retroactively-timed span for
intervals whose boundaries were observed without a live ``with`` block
(queue waits, prefill before the first token).
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass
from collections import deque
from typing import Iterable, List, Optional

# Cross-layer context carriers: the annotation rides MPIJob -> Pod
# objects through the API, the env var rides the pod spec into the
# workload process.  Both keys have the control plane's values
# (mpi_operator_tpu/api/constants.py), so a context stamped there
# decodes in a torch worker.
TRACE_CONTEXT_ANNOTATION = "trace.kubeflow.org/context"
from ..api.constants import TRACE_CONTEXT_ENV  # noqa: E402,F401


@dataclass(frozen=True)
class TraceContext:
    """Explicit span parentage: ``trace_id`` names the causal chain,
    ``span_id`` is the parent span a new span should attach to."""

    trace_id: str
    span_id: int

    def encode(self) -> str:
        return f"{self.trace_id}:{self.span_id}"

    @classmethod
    def decode(cls, raw: Optional[str]) -> Optional["TraceContext"]:
        """Parse a carrier string; None on anything malformed — a
        corrupt annotation must degrade to untraced, never raise."""
        if not raw or not isinstance(raw, str):
            return None
        trace_id, sep, span = raw.rpartition(":")
        if not sep or not trace_id:
            return None
        try:
            return cls(trace_id=trace_id, span_id=int(span))
        except ValueError:
            return None


def job_trace_id(namespace: str, name: str, uid: str = "") -> str:
    """The trace id of one MPIJob lifecycle.  The uid suffix separates
    re-created same-named jobs; matching by name uses the stable
    ``job-<ns>-<name>`` prefix (see critical_path.find_trace)."""
    base = f"job-{namespace}-{name}"
    return f"{base}-{uid[:8]}" if uid else base


def annotation_context(obj) -> Optional[TraceContext]:
    """The trace context carried on an API object's annotations."""
    meta = getattr(obj, "metadata", None)
    annotations = getattr(meta, "annotations", None) or {}
    return TraceContext.decode(annotations.get(TRACE_CONTEXT_ANNOTATION))


def env_context() -> Optional[TraceContext]:
    """The trace context injected into this process's environment (the
    in-pod end of the carrier chain)."""
    return TraceContext.decode(os.environ.get(TRACE_CONTEXT_ENV))


class Tracer:
    """Collects finished spans into a bounded in-memory buffer."""

    def __init__(self, max_events: int = 65536):
        self._events: deque = deque(maxlen=max_events)
        self._lock = threading.Lock()
        # Span ids must be unique ACROSS processes: a worker pod's spans
        # merge into the control plane's trace via flight sidecars, and
        # two counters both starting at 1 would alias parent links.
        # The pid block is 2^40 ids wide — a process would need ~10^12
        # spans to overflow into a neighbor's block, so adjacent-pid
        # collisions are structurally impossible at any realistic rate.
        self._ids = itertools.count(((os.getpid() & 0x3FFFFF) << 40) + 1)
        self._local = threading.local()
        # Completion listeners (flight recorder feed); see add_listener.
        self._listeners: list = []
        # Listener callbacks that raised (they must never fail the
        # traced code, but the drops must be visible).
        self.listener_errors = 0

    def add_listener(self, fn) -> None:
        """Register ``fn(event_dict)`` to run on every span completion
        (after the event lands in the buffer).  Listener errors are
        swallowed — observability must never fail the observed code."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    # -- recording ---------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def allocate_id(self) -> int:
        """Reserve a span id before its event is emitted (root spans
        whose children start streaming before the root completes)."""
        return next(self._ids)

    @contextlib.contextmanager
    def span(self, name: str, ctx: Optional[TraceContext] = None, **attrs):
        """Time the enclosed block as a span.  Yields the (mutable)
        event dict so callers can attach attrs discovered mid-span.

        ``ctx`` overrides thread-local parenting with an explicit
        cross-layer parent; without it, a nested span inherits both the
        parent id and the trace id from the enclosing span."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        event = {
            "name": name,
            "span_id": next(self._ids),
            "parent_id": (ctx.span_id if ctx is not None
                          else parent["span_id"] if parent else None),
            "ts": time.time(),
            "dur": 0.0,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "attrs": dict(attrs),
        }
        trace_id = (ctx.trace_id if ctx is not None
                    else parent.get("trace_id") if parent else None)
        if trace_id:
            event["trace_id"] = trace_id
        start = time.perf_counter()
        stack.append(event)
        try:
            yield event
        except BaseException as exc:
            event["error"] = f"{type(exc).__name__}: {exc}"
            raise
        finally:
            event["dur"] = time.perf_counter() - start
            stack.pop()
            with self._lock:
                self._events.append(event)
                listeners = list(self._listeners)
            for fn in listeners:
                try:
                    fn(event)
                except Exception:
                    # Listeners must never fail the traced code.
                    self.listener_errors += 1

    def emit(self, name: str, ts: float, dur: float,
             ctx: Optional[TraceContext] = None,
             trace_id: Optional[str] = None,
             parent_id: Optional[int] = None,
             span_id: Optional[int] = None, **attrs) -> dict:
        """Record a completed span whose boundaries were measured
        elsewhere (queue waits, pod start latency, admission waits —
        anything observed after the fact rather than with a live
        ``with span():`` block).  Returns the event so callers can
        derive a child :class:`TraceContext` from its span id."""
        event = {
            "name": name,
            "span_id": span_id if span_id is not None else next(self._ids),
            "parent_id": (parent_id if parent_id is not None
                          else ctx.span_id if ctx is not None else None),
            "ts": float(ts),
            "dur": max(0.0, float(dur)),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "attrs": dict(attrs),
        }
        tid = trace_id or (ctx.trace_id if ctx is not None else None)
        if tid:
            event["trace_id"] = tid
        with self._lock:
            self._events.append(event)
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(event)
            except Exception:
                # Listeners must never fail the traced code.
                self.listener_errors += 1
        return event

    def current_span(self) -> Optional[dict]:
        stack = self._stack()
        return stack[-1] if stack else None

    # -- access / export ---------------------------------------------------
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def export_jsonl(self, path_or_file) -> int:
        """Write one JSON object per line; returns the event count."""
        events = self.events()
        if isinstance(path_or_file, (str, os.PathLike)):
            with open(path_or_file, "w") as f:
                return self.export_jsonl(f)
        for event in events:
            path_or_file.write(json.dumps(event) + "\n")
        return len(events)

    def export_chrome_trace(self, path_or_file) -> int:
        events = self.events()
        payload = to_chrome_trace(events)
        if isinstance(path_or_file, (str, os.PathLike)):
            with open(path_or_file, "w") as f:
                json.dump(payload, f)
        else:
            json.dump(payload, path_or_file)
        return len(events)


def read_jsonl(path_or_file) -> List[dict]:
    """Parse a JSONL span export back into event dicts (blank lines
    skipped) — the round-trip partner of ``Tracer.export_jsonl``."""
    if isinstance(path_or_file, (str, os.PathLike)):
        with open(path_or_file) as f:
            return read_jsonl(f)
    if isinstance(path_or_file, (bytes, bytearray)):
        path_or_file = io.StringIO(path_or_file.decode())
    return [json.loads(line) for line in path_or_file if line.strip()]


def to_chrome_trace(events: Iterable[dict]) -> dict:
    """Chrome trace-event ("catapult") JSON: complete events (ph=X) with
    microsecond timestamps, viewable in perfetto / chrome://tracing."""
    trace_events = []
    for e in events:
        args = dict(e.get("attrs") or {})
        if e.get("error"):
            args["error"] = e["error"]
        if e.get("parent_id") is not None:
            args["parent_id"] = e["parent_id"]
        if e.get("trace_id"):
            args["trace_id"] = e["trace_id"]
        trace_events.append({
            "name": e["name"],
            "ph": "X",
            "ts": e["ts"] * 1e6,
            "dur": e["dur"] * 1e6,
            "pid": e.get("pid", 0),
            "tid": e.get("tid", 0),
            "cat": "span",
            "args": args,
        })
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


_DEFAULT_TRACER = Tracer()


def default_tracer() -> Tracer:
    return _DEFAULT_TRACER


def span(name: str, ctx: Optional[TraceContext] = None, **attrs):
    """``with span("reconcile", job=name):`` on the default tracer."""
    return _DEFAULT_TRACER.span(name, ctx=ctx, **attrs)


def context_of(event: dict) -> Optional[TraceContext]:
    """A child context pointing at ``event`` (None when the event
    carries no trace id)."""
    trace_id = event.get("trace_id")
    if not trace_id:
        return None
    return TraceContext(trace_id=trace_id, span_id=event["span_id"])
