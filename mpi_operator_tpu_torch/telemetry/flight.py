"""Flight recorder, the crash-surviving black box: the port's copy of
``mpi_operator_tpu/telemetry/flight.py``.

A postmortem starts from one correlated timeline: which fault fired,
what the control plane did about it, how the gang restarted, and where
the train loop's or the server's wall time went.  Every layer feeds one
bounded, thread-safe ring buffer:

- **controller** — Recorder events and sync errors,
- **kubelet** — pod phase transitions,
- **train** — goodput phase transitions, preemption notices and
  checkpoint writer errors,
- **serving** — batcher ``fatal_error`` and the replica spans,
- **chaos** — fault injections / heals / invariant verdicts,

each entry a monotonic-sequenced record with a stable
``(layer, kind)`` schema::

    {"seq": int, "ts": float, "layer": str, "kind": str, "data": {...}}

On fatal paths (batcher ``fatal_error``, ``run_train_loop`` preemption,
a checkpoint writer error, an unhandled exception via
:func:`install_crash_handler`) and on demand (``GET /debug-bundle``)
:func:`dump_bundle` writes a **black-box bundle** to the debug dir
(``$MPI_OPERATOR_DEBUG_DIR``):

    bundle-<reason>-<pid>-<n>/
      flight.jsonl        the full ring (wall timestamps, all layers)
      events.jsonl        the canonical event section, timestamp-free,
                          so two identical seeded runs produce
                          byte-identical files
      trace.json          merged Chrome trace: spans + flight records in
                          stable per-layer lanes (perfetto/chrome://tracing)
      critical_path.json  one decomposition per causal trace
      metrics.prom        a /metrics exposition snapshot
      job.json            the involved job(s): conditions + last events
      MANIFEST.json       reason + artifact inventory

Worker subprocesses export their ring as a *sidecar* JSONL
(:func:`export_sidecar`, ``$MPI_OPERATOR_FLIGHT_DIR``); the dumper
merges sidecars into the trace, so the training layer appears in the
control plane's bundle: one timeline across processes.  The ring, the
lanes and the files have the JAX package's layout, so a bundle of
either package reads the same way.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Iterable, List, Optional

from .metrics import expose_with_defaults
from .trace import default_tracer

DEBUG_DIR_ENV = "MPI_OPERATOR_DEBUG_DIR"
FLIGHT_DIR_ENV = "MPI_OPERATOR_FLIGHT_DIR"

# Stable lane order for the merged Chrome trace (pid = index + 1).
# New lanes append BEFORE "other": earlier indices are a compatibility
# surface (tests pin controller..chaos to pids 1-5).
LAYERS = ("controller", "kubelet", "train", "serving", "chaos",
          "apiserver", "sched", "other")

# Span-name prefix -> layer lane for tracer events in the merged trace.
_SPAN_LAYERS = (("reconcile", "controller"), ("chaos", "chaos"),
                ("checkpoint", "train"), ("train", "train"),
                ("profile", "train"),
                ("serve_queue_wait", "serving"), ("serv", "serving"),
                ("prefill", "serving"), ("decode", "serving"),
                ("request", "serving"), ("route", "serving"),
                # Causal-trace bootstrap-path spans (critical_path.py).
                ("job_submit", "apiserver"),
                ("queue_wait", "controller"),
                ("time_to_first_step", "controller"),
                ("admission", "sched"), ("placement", "sched"),
                ("pod_start", "kubelet"),
                ("distributed_init", "train"),
                ("compile", "train"), ("first_step", "train"))

# Canonical view field order: no wall-clock fields, stable key order,
# so canonical exports of identical seeded runs diff (and hash) clean.
CANONICAL_FIELDS = ("layer", "kind", "data")


def debug_dir() -> str:
    """Where bundles land: $MPI_OPERATOR_DEBUG_DIR, else a stable
    tempdir subpath (never the CWD — fatal paths run in arbitrary
    working directories)."""
    return os.environ.get(DEBUG_DIR_ENV) or os.path.join(
        tempfile.gettempdir(), "mpi-operator-tpu-debug")


class FlightRecorder:
    """Bounded, thread-safe ring buffer of structured records.

    Overwrite semantics: the ring keeps the most recent ``max_records``
    entries; ``seq`` keeps counting, so ``dropped`` (= seq - len) says
    how much history the crash outlived.
    """

    def __init__(self, max_records: int = 4096):
        self.max_records = max_records
        self._records: deque = deque(maxlen=max_records)
        # Hot lock: every layer records through the ring; blocking while
        # holding it stalls them all.
        self._lock = threading.Lock()
        self._seq = 0

    def record(self, layer: str, kind: str, /, **data) -> dict:
        # layer/kind are positional-only: payloads legitimately carry
        # their own "kind"/"layer" keys (chaos fault fields).
        if layer not in LAYERS:
            layer = "other"
        with self._lock:
            dropped = len(self._records) == self.max_records
            rec = {"seq": self._seq, "ts": round(time.time(), 6),
                   "layer": layer, "kind": kind, "data": data}
            self._seq += 1
            self._records.append(rec)
        if dropped:
            # The ring silently overwrites on wrap; a truncated bundle
            # must be DETECTABLE — counted here, echoed in the
            # flight.jsonl header (see export_jsonl).
            _count_dropped()
        return rec

    # -- access ------------------------------------------------------------
    def records(self, layer: Optional[str] = None) -> List[dict]:
        with self._lock:
            out = list(self._records)
        if layer is not None:
            out = [r for r in out if r["layer"] == layer]
        return out

    @property
    def seq(self) -> int:
        """Total records ever written (survivors + overwritten)."""
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._seq - len(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    # -- export ------------------------------------------------------------
    def export_jsonl(self, path_or_file, extra_records=()) -> int:
        """Header line + ring records (+ caller-supplied extras, e.g.
        export_sidecar's pre-listener tracer spans).  The header's drop
        accounting lets a reader tell a truncated (wrapped) ring from a
        complete one without summing seq gaps; snapshot and counter
        come from ONE lock acquisition so records landing concurrently
        are never misreported as drops, and ``retained`` counts every
        line actually written below it."""
        extra_records = list(extra_records)
        if isinstance(path_or_file, (str, os.PathLike)):
            with open(path_or_file, "w") as f:
                return self.export_jsonl(f, extra_records=extra_records)
        with self._lock:
            records = list(self._records)
            total = self._seq
        header = {"seq": -1, "ts": 0.0, "layer": "other",
                  "kind": "flight_header",
                  "data": {"total": total + len(extra_records),
                           "retained": len(records) + len(extra_records),
                           "dropped": total - len(records),
                           "extra_records": len(extra_records),
                           "max_records": self.max_records}}
        path_or_file.write(json.dumps(header) + "\n")
        for rec in records:
            path_or_file.write(json.dumps(rec) + "\n")
        for rec in extra_records:
            path_or_file.write(json.dumps(rec) + "\n")
        return len(records) + len(extra_records)

    def canonical_records(self, layers: Iterable[str] = ("chaos",)
                          ) -> List[dict]:
        """The reproducible view: no seq (global interleaving is
        scheduler-dependent), no ts — only layers whose feed order is
        deterministic under a seeded plan (chaos by default)."""
        wanted = set(layers)
        return [{k: rec[k] for k in CANONICAL_FIELDS}
                for rec in self.records() if rec["layer"] in wanted]


_DEFAULT = FlightRecorder()
_tracer_wired = False
_wire_lock = threading.Lock()
_dropped_counter = None


def _count_dropped() -> None:
    """mpi_operator_flight_records_dropped_total in the process default
    registry (lazy: the metrics import must not run per record)."""
    global _dropped_counter
    if _dropped_counter is None:
        from .metrics import default_registry
        _dropped_counter = default_registry().counter(
            "mpi_operator_flight_records_dropped_total",
            "Flight-ring records overwritten on wrap (history a bundle"
            " cut now would be missing)")
    _dropped_counter.inc()


def default_recorder() -> FlightRecorder:
    """The process-wide ring; first use wires span completions from the
    default tracer into it (kind="span", layer by span-name prefix)."""
    global _tracer_wired
    if not _tracer_wired:
        with _wire_lock:
            if not _tracer_wired:
                default_tracer().add_listener(_span_listener)
                _tracer_wired = True
    return _DEFAULT


def _span_layer(name: str) -> str:
    for prefix, layer in _SPAN_LAYERS:
        if name.startswith(prefix):
            return layer
    return "other"


def _span_listener(event: dict) -> None:
    data = {"name": event["name"], "dur": event["dur"]}
    if event.get("error"):
        data["error"] = event["error"]
    if event.get("attrs"):
        data["attrs"] = event["attrs"]
    if event.get("trace_id"):
        # Causal-trace spans keep their identity through the ring: the
        # sidecar export is how a worker pod's spans reach the control
        # plane's critical-path analysis (critical_path.py).
        data["trace_id"] = event["trace_id"]
        data["span_id"] = event["span_id"]
        data["parent_id"] = event.get("parent_id")
        data["ts"] = event["ts"]
        data["pid"] = event.get("pid", 0)
    _DEFAULT.record(_span_layer(event["name"]), "span", **data)


def record(layer: str, kind: str, /, **data) -> dict:
    """``flight.record("kubelet", "pod_phase", pod=..., phase=...)`` on
    the default ring."""
    return default_recorder().record(layer, kind, **data)


# ---------------------------------------------------------------------------
# Merged Chrome trace
# ---------------------------------------------------------------------------

def merged_chrome_trace(span_events: Iterable[dict],
                        flight_records: Iterable[dict],
                        extra_records: Iterable[dict] = ()) -> dict:
    """One Chrome trace with a stable lane (pid) per layer.

    Spans render as complete (ph=X) events in the lane their name maps
    to; flight records render as instant (ph=i) events — except records
    carrying a ``seconds``/``dur`` payload, which render as X so phase
    durations are visible.  Chaos records carrying a plan offset
    (``at``) are placed at that deterministic offset instead of wall
    time, so chaos lanes diff cleanly across identical seeded runs.

    Causal-trace spans (carrying a trace id) additionally get **linked
    flows**: a flow arrow (ph=s/f pairs) from each parent span's end to
    its child's start, so one job's create → admit → pod-start →
    first-step chain reads as a connected path across lanes in
    perfetto instead of disconnected rectangles.
    """
    lane = {layer: i + 1 for i, layer in enumerate(LAYERS)}
    trace_events = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": layer}}
        for layer, pid in sorted(lane.items(), key=lambda kv: kv[1])]
    # span_id -> (lane pid, tid, start us, end us, parent_id) for the
    # flow pass below; only causal-trace spans participate.
    traced: dict = {}

    for e in span_events:
        args = dict(e.get("attrs") or {})
        if e.get("error"):
            args["error"] = e["error"]
        if e.get("trace_id"):
            args["trace_id"] = e["trace_id"]
        pid = lane[_span_layer(e["name"])]
        ts_us, dur_us = e["ts"] * 1e6, e["dur"] * 1e6
        trace_events.append({
            "name": e["name"], "ph": "X", "cat": "span",
            "ts": ts_us, "dur": dur_us,
            "pid": pid, "tid": e.get("tid", 0), "args": args})
        if e.get("trace_id") and e.get("span_id") is not None:
            traced[e["span_id"]] = (pid, e.get("tid", 0), ts_us,
                                    ts_us + dur_us, e.get("parent_id"))

    def _add_record(rec, local: bool) -> None:
        if rec.get("kind") == "span":
            if local:
                return  # local spans are already in the tracer events
            # A sidecar (remote-process) span has no local tracer event;
            # render it here or worker spans vanish from the timeline.
            data = dict(rec.get("data") or {})
            name = data.pop("name", "span")
            dur = float(data.pop("dur", 0.0) or 0.0)
            ts = float(data.get("ts", rec.get("ts", 0.0)) or 0.0)
            pid = lane[_span_layer(name)]
            trace_events.append({
                "name": name, "ph": "X", "cat": "span",
                "ts": ts * 1e6, "dur": dur * 1e6,
                "pid": pid, "tid": 0,
                "args": dict(data.get("attrs") or {})})
            if data.get("trace_id") and data.get("span_id") is not None:
                traced[data["span_id"]] = (pid, 0, ts * 1e6,
                                           (ts + dur) * 1e6,
                                           data.get("parent_id"))
            return
        data = dict(rec.get("data") or {})
        layer = rec.get("layer", "other")
        ts = rec.get("ts", 0.0) * 1e6
        if layer == "chaos" and isinstance(data.get("at"), (int, float)):
            ts = float(data["at"]) * 1e6  # plan-relative: deterministic
        dur = data.get("seconds", data.get("dur"))
        ev = {"name": rec.get("kind", "record"), "ph": "i", "cat": "flight",
              "ts": ts, "pid": lane.get(layer, lane["other"]), "tid": 0,
              "s": "t", "args": {"layer": layer, **data}}
        if isinstance(dur, (int, float)):
            ev.update(ph="X", dur=float(dur) * 1e6)
            ev.pop("s")
        trace_events.append(ev)

    for rec in flight_records:
        _add_record(rec, local=True)
    for rec in extra_records:
        _add_record(rec, local=False)

    # Linked flows: parent end -> child start, one arrow per causal
    # edge whose both endpoints are in this trace.  The child span id
    # (globally unique, see Tracer._ids) is the flow id.
    for sid, (pid, tid, ts_us, _end, parent) in sorted(traced.items()):
        if parent is None or parent not in traced:
            continue
        p_pid, p_tid, _p_ts, p_end, _ = traced[parent]
        trace_events.append({
            "name": "causal", "ph": "s", "cat": "trace", "id": sid,
            "pid": p_pid, "tid": p_tid, "ts": p_end})
        trace_events.append({
            "name": "causal", "ph": "f", "bp": "e", "cat": "trace",
            "id": sid, "pid": pid, "tid": tid, "ts": ts_us})
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# Sidecars: cross-process timeline merge
# ---------------------------------------------------------------------------

def export_sidecar(recorder: Optional[FlightRecorder] = None,
                   directory: Optional[str] = None) -> Optional[str]:
    """Write this process's ring as ``flight-<pid>.jsonl`` into the
    shared flight dir so another process's bundle can merge it (workers
    call this on preemption/exit; no-op when no dir is configured).

    Causal-trace spans recorded BEFORE the ring's tracer listener was
    wired (the wiring is lazy on first default_recorder() use) are
    appended from the tracer directly — a worker whose very first
    flight call is this export must not lose its distributed-init/
    compile/first-step milestones."""
    directory = directory or os.environ.get(FLIGHT_DIR_ENV)
    if not directory:
        return None
    recorder = recorder or default_recorder()
    try:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"flight-{os.getpid()}.jsonl")
        extra = []
        if recorder is _DEFAULT:
            in_ring = {r["data"].get("span_id")
                       for r in recorder.records()
                       if r["kind"] == "span"}
            extra = [
                {"seq": -2, "ts": e["ts"],
                 "layer": _span_layer(e["name"]), "kind": "span",
                 "data": {"name": e["name"], "dur": e["dur"],
                          "attrs": e.get("attrs") or {},
                          "trace_id": e["trace_id"],
                          "span_id": e["span_id"],
                          "parent_id": e.get("parent_id"),
                          "ts": e["ts"], "pid": e.get("pid", 0)}}
                for e in default_tracer().events()
                if e.get("trace_id") and e["span_id"] not in in_ring]
        recorder.export_jsonl(path, extra_records=extra)
        return path
    except OSError:
        return None


def _read_sidecars(directory: Optional[str],
                   max_age: float = 3600.0) -> List[dict]:
    directory = directory or os.environ.get(FLIGHT_DIR_ENV)
    if not directory or not os.path.isdir(directory):
        return []
    out: List[dict] = []
    own = f"flight-{os.getpid()}.jsonl"
    now = time.time()
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("flight-") and name.endswith(".jsonl")):
            continue
        if name == own:
            continue  # the dumper's ring is already in the bundle
        path = os.path.join(directory, name)
        try:
            if now - os.path.getmtime(path) > max_age:
                continue  # leftover from an earlier run (pid recycled)
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    rec = json.loads(line)
                    if rec.get("kind") == "flight_header":
                        continue  # export metadata, not a record
                    out.append(rec)
        except (OSError, ValueError):
            continue
    return out


# ---------------------------------------------------------------------------
# Black-box bundles
# ---------------------------------------------------------------------------

_bundle_lock = threading.Lock()
_bundle_count = 0
_bundle_once_keys: set = set()
_in_dump = threading.local()


def job_snapshot(clientset, namespace: Optional[str] = None,
                 name: Optional[str] = None) -> dict:
    """Conditions + last events for the involved job(s) — the
    ``kubectl describe`` evidence, frozen into the bundle."""
    jobs = []
    try:
        if name is not None:
            listed = [clientset.mpi_jobs(namespace or "default").get(name)]
        else:
            listed = clientset.server.list("kubeflow.org/v2beta1", "MPIJob",
                                           namespace)
        all_events = clientset.server.list("v1", "Event", namespace)
    except Exception as exc:
        return {"error": f"{type(exc).__name__}: {exc}", "jobs": []}
    for job in listed:
        jobs.append({
            "name": job.metadata.name,
            "namespace": job.metadata.namespace,
            "uid": job.metadata.uid,
            "conditions": [
                {"type": c.type, "status": c.status, "reason": c.reason,
                 "message": c.message} for c in job.status.conditions],
            "events": [
                {"type": e.type, "reason": e.reason, "message": e.message,
                 "count": e.count}
                for e in all_events
                if e.involved_object.name == job.metadata.name],
        })
    return {"jobs": jobs}


# Metrics plane hook: a zero-arg callable returning the canonical
# alert history (obsplane AlertEngine.canonical_history).  When set,
# every bundle carries an alerts.json artifact — "what paged during
# this incident" rides along with "what happened".
_alert_history_provider = None


def set_alert_history_provider(provider) -> None:
    """Register (or clear, with None) the alert-history source bundles
    embed.  The soak harness points this at its alert engine for the
    run's lifetime."""
    global _alert_history_provider
    _alert_history_provider = provider


def dump_bundle(reason: str,
                directory: Optional[str] = None,
                recorder: Optional[FlightRecorder] = None,
                tracer=None,
                registry=None,
                job_payload: Optional[dict] = None,
                clientset=None,
                namespace: Optional[str] = None,
                job_name: Optional[str] = None,
                canonical_events: Optional[List[dict]] = None,
                include_sidecars: bool = True,
                metrics_text: Optional[str] = None,
                once_key: Optional[str] = None) -> Optional[str]:
    """Write a black-box bundle; returns its path (None when skipped).

    ``once_key`` dedups per process (a crash loop must not fill the
    disk with identical bundles).  ``canonical_events`` overrides the
    canonical section (chaos bundles pass the report's canonical log);
    otherwise the ring's chaos layer is used.  Never raises: the black
    box must not add a second failure to the first.
    """
    if getattr(_in_dump, "active", False):
        return None  # a failure inside the dump must not recurse
    _in_dump.active = True
    try:
        return _dump_bundle_inner(
            reason, directory, recorder, tracer, registry, job_payload,
            clientset, namespace, job_name, canonical_events,
            include_sidecars, metrics_text, once_key)
    except Exception as exc:  # pragma: no cover - last-resort guard
        print(f"flight: bundle dump failed: {exc}", file=sys.stderr)
        return None
    finally:
        _in_dump.active = False


def _slug(text: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "-"
                   for c in text)[:64].strip("-") or "bundle"


def _dump_bundle_inner(reason, directory, recorder, tracer, registry,
                       job_payload, clientset, namespace, job_name,
                       canonical_events, include_sidecars, metrics_text,
                       once_key) -> Optional[str]:
    global _bundle_count
    with _bundle_lock:
        if once_key is not None:
            if once_key in _bundle_once_keys:
                return None
            _bundle_once_keys.add(once_key)
        _bundle_count += 1
        count = _bundle_count
    recorder = recorder or default_recorder()
    tracer = tracer or default_tracer()
    base = directory or debug_dir()
    path = os.path.join(
        base, f"bundle-{_slug(reason)}-{os.getpid()}-{count}")
    os.makedirs(path, exist_ok=True)

    recorder.record("other", "bundle", reason=reason, path=path)

    # 1. flight.jsonl — the full ring.
    recorder.export_jsonl(os.path.join(path, "flight.jsonl"))

    # 2. events.jsonl — the canonical (timestamp-free) event section.
    if canonical_events is None:
        canonical_events = recorder.canonical_records()
    with open(os.path.join(path, "events.jsonl"), "w") as f:
        for ev in canonical_events:
            f.write(json.dumps(ev) + "\n")

    # 3. trace.json — merged per-layer timeline (+ worker sidecars).
    sidecars = _read_sidecars(None) if include_sidecars else []
    trace = merged_chrome_trace(tracer.events(), recorder.records(),
                                sidecars)
    with open(os.path.join(path, "trace.json"), "w") as f:
        json.dump(trace, f)

    # 4. critical_path.json — per-trace bootstrap/TTFT decomposition
    # (telemetry/critical_path.py): the bundle answers "which seconds"
    # without re-running the analyzer.  Sidecar span records are folded
    # in so worker-side milestones (distributed init, compile, first
    # step) appear in the control plane's decomposition.
    from . import critical_path as _cp
    cp_events = list(tracer.events())
    cp_events += _cp.spans_from_flight_records(recorder.records())
    cp_events += _cp.spans_from_flight_records(sidecars)
    seen_spans: set = set()
    cp_unique = []
    for ev in cp_events:
        key = (ev.get("trace_id"), ev.get("span_id"))
        if ev.get("span_id") is not None and key in seen_spans:
            continue
        seen_spans.add(key)
        cp_unique.append(ev)
    with open(os.path.join(path, "critical_path.json"), "w") as f:
        json.dump(_cp.bundle_payload(cp_unique), f, indent=2)

    # 5. metrics.prom — /metrics snapshot (an already-fetched remote
    # exposition wins over the local process registries).
    exposition = (metrics_text if metrics_text is not None
                  else expose_with_defaults(registry))
    with open(os.path.join(path, "metrics.prom"), "w") as f:
        f.write(exposition or "# (no metric families registered)\n")

    # 6. job.json — involved job(s): conditions + last events.
    if job_payload is None and clientset is not None:
        job_payload = job_snapshot(clientset, namespace, job_name)
    with open(os.path.join(path, "job.json"), "w") as f:
        json.dump(job_payload if job_payload is not None
                  else {"jobs": []}, f, indent=2, default=str)

    # 7. alerts.json — the metrics plane's canonical alert history,
    # when an alert engine registered itself (soak harness, smoke).
    # Canonical = timestamp-free and sorted, so two identical seeded
    # runs bundle byte-identical histories.
    alerts = None
    provider = _alert_history_provider
    if provider is not None:
        try:
            alerts = provider()
        # A dying alert engine must not block the bundle dump.
        except Exception:  # lint: allow[silent-except]
            alerts = None
    if alerts is not None:
        with open(os.path.join(path, "alerts.json"), "w") as f:
            json.dump(alerts, f, indent=2, sort_keys=True)
            f.write("\n")

    manifest = {
        "reason": reason,
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "pid": os.getpid(),
        "ring": {"records": len(recorder.records()),
                 "total": recorder.seq,
                 "dropped": recorder.dropped},
        "sidecar_records": len(sidecars),
        "artifacts": (["flight.jsonl", "events.jsonl", "trace.json",
                       "critical_path.json", "metrics.prom", "job.json"]
                      + (["alerts.json"] if alerts is not None else [])),
    }
    with open(os.path.join(path, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return path


# ---------------------------------------------------------------------------
# Crash handler: unhandled exception / atexit
# ---------------------------------------------------------------------------

_crash_installed = False


def install_crash_handler(directory: Optional[str] = None,
                          registry=None) -> None:
    """Chain into ``sys.excepthook`` / ``threading.excepthook`` so an
    unhandled exception dumps a bundle before the process dies, and
    register an atexit hook that dumps when a layer flagged a fatal
    (:func:`flag_fatal`) that never surfaced as an exception.

    ``registry`` may be a Registry or a zero-arg callable resolved at
    dump time — the operator app creates its metrics registry lazily
    (on winning leadership), after the handler must already be armed.
    """
    global _crash_installed
    if _crash_installed:
        return
    _crash_installed = True
    prev_hook = sys.excepthook
    prev_thread_hook = threading.excepthook

    def _registry():
        try:
            return registry() if callable(registry) else registry
        # Crash path: a failing late-bound registry thunk must never
        # mask the real crash being dumped.
        except Exception:  # lint: allow[silent-except]
            return None

    def _hook(exc_type, exc, tb):
        if not issubclass(exc_type, (KeyboardInterrupt, SystemExit)):
            record("other", "unhandled_exception",
                   type=exc_type.__name__, error=str(exc))
            dump_bundle(f"crash-{exc_type.__name__}", directory=directory,
                        registry=_registry(), once_key="crash")
        prev_hook(exc_type, exc, tb)

    def _thread_hook(args):
        if args.exc_type is not None and not issubclass(
                args.exc_type, SystemExit):
            record("other", "unhandled_exception",
                   type=args.exc_type.__name__, error=str(args.exc_value),
                   thread=getattr(args.thread, "name", ""))
            dump_bundle(f"crash-{args.exc_type.__name__}",
                        directory=directory, registry=_registry(),
                        once_key=f"thread-crash-{args.exc_type.__name__}")
        prev_thread_hook(args)

    sys.excepthook = _hook
    threading.excepthook = _thread_hook

    import atexit

    def _atexit_dump():
        if _fatal_flags and "crash" not in _bundle_once_keys:
            dump_bundle(f"atexit-{_fatal_flags[0]}", directory=directory,
                        registry=_registry(), once_key="atexit")

    atexit.register(_atexit_dump)


_fatal_flags: List[str] = []


def flag_fatal(reason: str, **data) -> None:
    """Mark the process as dying for ``reason``: records it and arms
    the atexit dump (for fatal paths that exit without an exception)."""
    record("other", "fatal", reason=reason, **data)
    _fatal_flags.append(_slug(reason))
