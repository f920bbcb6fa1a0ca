"""Critical-path analyzer over causal traces: the port's copy of
``mpi_operator_tpu/telemetry/critical_path.py``.

Given the span events every layer recorded against one
:class:`~.trace.TraceContext`, reconstruct the span DAG, validate it (no
orphans, no cycles), compute the critical path, and emit a
**decomposition table** whose segments telescope: each segment is the
gap between consecutive milestone completions, so the segments sum
EXACTLY to the measured wall time of the trace.

Two trace shapes are understood:

- **job** (root span ``job_submit``, trace id ``job-<ns>-<name>-…``):
  MPIJob create → controller queue wait → gang placement/admission →
  pod start → distributed init → compile → first step.  In a torch
  worker, ``compile`` is the first train step (kernel builds and
  library warm-up, not an XLA compile) and ``first_step`` the first
  step whose output reached the host.
- **request** (root span ``request``, trace id ``req-…``): router
  accept → route decision → replica queue wait → prefill → first
  token.

Consumed by the flight-recorder bundle (``critical_path.json``).  Events
come from the local tracer, from flight-ring ``span`` records
(cross-process sidecars: the worker's train-side spans), or from span
JSONL exports; :func:`collect_events` merges all three.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

from .trace import default_tracer

JOB_ROOT = "job_submit"
REQUEST_ROOT = "request"

# Bootstrap-path milestones in pipeline order.  Each entry is
# (span name, reducer): "first" takes the earliest completion of that
# span name in the trace (the job's first dequeue), "last" the latest
# (the member that gated the gang — the last pod to start, the slowest
# worker's compile).  A missing milestone is skipped; its time is
# absorbed into the next present segment, so the telescoping sum is
# preserved no matter which layers reported.
JOB_MILESTONES: Tuple[Tuple[str, str], ...] = (
    ("queue_wait", "first"),
    ("placement", "last"),
    ("admission", "last"),
    ("pod_start", "last"),
    ("distributed_init", "last"),
    ("compile", "last"),
    ("first_step", "last"),
)
# Fallback terminal milestone when no worker reported a first step
# (pure control-plane workloads): the controller's Running flip.
JOB_FALLBACK_END = "time_to_first_step"

REQUEST_MILESTONES: Tuple[Tuple[str, str], ...] = (
    ("route", "first"),
    ("serve_queue_wait", "last"),
    ("prefill", "last"),
    ("request_ttft", "last"),
)


def _span_end(event: dict) -> float:
    return float(event.get("ts", 0.0)) + float(event.get("dur", 0.0))


# ---------------------------------------------------------------------------
# Event collection
# ---------------------------------------------------------------------------

def spans_from_flight_records(records: Iterable[dict]) -> List[dict]:
    """Convert flight-ring ``span`` records (the sidecar/cross-process
    carrier) back into span event dicts.  Only records carrying a
    trace id are causal-trace material; the rest are timeline noise."""
    out = []
    for rec in records:
        if rec.get("kind") != "span":
            continue
        data = rec.get("data") or {}
        if not data.get("trace_id"):
            continue
        out.append({
            "name": data.get("name", "span"),
            "span_id": data.get("span_id"),
            "parent_id": data.get("parent_id"),
            "ts": data.get("ts", rec.get("ts", 0.0)),
            "dur": float(data.get("dur", 0.0) or 0.0),
            "pid": data.get("pid", 0),
            "tid": 0,
            "attrs": dict(data.get("attrs") or {}),
            "trace_id": data["trace_id"],
        })
    return out


def _read_span_files(paths: Iterable[str]) -> List[dict]:
    """Span events from JSONL files: either raw span exports
    (``Tracer.export_jsonl``) or flight sidecars (``flight-*.jsonl``),
    distinguished per line by shape."""
    events: List[dict] = []
    for path in paths:
        try:
            with open(path) as f:
                lines = [json.loads(line) for line in f if line.strip()]
        except (OSError, ValueError):
            continue
        for obj in lines:
            if "span_id" in obj and "name" in obj:
                events.append(obj)
            elif obj.get("kind") == "span":
                events.extend(spans_from_flight_records([obj]))
    return events


def collect_events(tracer=None, sidecar_dir: Optional[str] = None,
                   extra_files: Iterable[str] = ()) -> List[dict]:
    """Everything known about causal traces in this process: the local
    tracer's events, worker sidecar rings under ``sidecar_dir``
    (default ``$MPI_OPERATOR_FLIGHT_DIR``), and any explicit span/
    sidecar JSONL files.  Duplicate span ids (a sidecar re-read next
    to the live ring) keep the first occurrence."""
    from .flight import FLIGHT_DIR_ENV
    tracer = tracer or default_tracer()
    events = list(tracer.events())
    sidecar_dir = sidecar_dir or os.environ.get(FLIGHT_DIR_ENV)
    files = list(extra_files)
    if sidecar_dir and os.path.isdir(sidecar_dir):
        own = f"flight-{os.getpid()}.jsonl"
        for name in sorted(os.listdir(sidecar_dir)):
            if name.startswith("flight-") and name.endswith(".jsonl") \
                    and name != own:
                files.append(os.path.join(sidecar_dir, name))
    events.extend(_read_span_files(files))
    seen, unique = set(), []
    for e in events:
        key = (e.get("trace_id"), e.get("span_id"))
        if e.get("span_id") is not None and key in seen:
            continue
        seen.add(key)
        unique.append(e)
    return unique


def traces(events: Iterable[dict]) -> Dict[str, List[dict]]:
    """Group events by trace id (untraced spans are dropped)."""
    out: Dict[str, List[dict]] = {}
    for e in events:
        tid = e.get("trace_id")
        if tid:
            out.setdefault(tid, []).append(e)
    return out


def find_trace(events, target: str,
               namespace: str = "default") -> Optional[str]:
    """Resolve a user-facing target (job name, ``req-N``, or a full
    trace id) to a trace id present in ``events`` (an event list, or
    an already-grouped ``traces()`` dict).  Job names match the stable
    ``job-<ns>-<name>`` id with exactly the uid token appended — job
    "train" must never resolve to job "train-2"'s trace — and the
    newest (highest root ts) wins when a job was re-created."""
    by_id = events if isinstance(events, dict) else traces(events)
    if target in by_id:
        return target
    job_prefix = f"job-{namespace}-{target}-"
    exact = f"job-{namespace}-{target}"
    candidates = [tid for tid in by_id
                  if tid == exact
                  or (tid.startswith(job_prefix)
                      and "-" not in tid[len(job_prefix):])]
    if not candidates:
        return None
    def newest(tid: str) -> float:
        return min(float(e.get("ts", 0.0)) for e in by_id[tid])
    return max(candidates, key=newest)


# ---------------------------------------------------------------------------
# DAG validation
# ---------------------------------------------------------------------------

def orphan_spans(spans: List[dict]) -> List[dict]:
    """Spans whose parent id does not resolve inside the same trace
    (the propagation invariant: every non-root span's parent exists)."""
    ids = {s["span_id"] for s in spans}
    return [s for s in spans
            if s.get("parent_id") is not None
            and s["parent_id"] not in ids]


def has_cycle(spans: List[dict]) -> bool:
    by_id = {s["span_id"]: s for s in spans}
    for s in spans:
        seen = set()
        cur = s
        while cur is not None:
            sid = cur["span_id"]
            if sid in seen:
                return True
            seen.add(sid)
            cur = by_id.get(cur.get("parent_id"))
    return False


def critical_path(spans: List[dict],
                  tail: Optional[dict] = None) -> List[dict]:
    """The chain of spans from the root to ``tail`` (default: the
    LAST-finishing span) — the spans whose completion gated the
    trace's end-to-end wall time.  Returned root-first."""
    if not spans:
        return []
    by_id = {s["span_id"]: s for s in spans}
    if tail is None:
        tail = max(spans, key=_span_end)
    path, seen = [], set()
    cur = tail
    while cur is not None and cur["span_id"] not in seen:
        path.append(cur)
        seen.add(cur["span_id"])
        cur = by_id.get(cur.get("parent_id"))
    return list(reversed(path))


# ---------------------------------------------------------------------------
# Decomposition
# ---------------------------------------------------------------------------

def trace_kind(spans: List[dict]) -> Optional[str]:
    names = {s["name"] for s in spans}
    if JOB_ROOT in names:
        return "job"
    if REQUEST_ROOT in names:
        return "request"
    return None


def _milestones(spans: List[dict], plan: Tuple[Tuple[str, str], ...],
                horizon: Optional[float] = None) -> List[tuple]:
    """Milestone completion times per the plan's reducers.  ``horizon``
    bounds the decomposed interval: spans completing after it belong to
    a LATER episode of the same trace (a gang-restart replacement pod's
    ``pod_start``, a second incarnation's ``compile``) and must not
    drag a milestone past the trace's terminal — they are excluded."""
    by_name: Dict[str, List[dict]] = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    out = []
    for name, reducer in plan:
        group = by_name.get(name)
        if not group:
            continue
        ends = [_span_end(s) for s in group]
        if horizon is not None:
            ends = [e for e in ends if e <= horizon + 1e-9]
        if not ends:
            continue
        out.append((name, min(ends) if reducer == "first" else max(ends)))
    return out


def _terminal_end(spans: List[dict], kind: str) -> Optional[float]:
    """The trace's terminal-milestone completion: first_step (fallback:
    the controller's Running flip) for jobs, first token for requests.
    Earliest completion wins — later same-named spans are re-runs."""
    names = ([("first_step",), (JOB_FALLBACK_END,)] if kind == "job"
             else [("request_ttft",)])
    for candidates in names:
        ends = [_span_end(s) for s in spans if s["name"] in candidates]
        if ends:
            return min(ends)
    return None


def decompose(spans: List[dict]) -> Optional[dict]:
    """The critical-path decomposition table for one trace.

    Segments telescope between consecutive milestone completions
    starting at the root span's start, so ``sum(segments) == total``
    EXACTLY.
    Returns None when the trace has no recognizable root.
    """
    kind = trace_kind(spans)
    if kind is None:
        return None
    root_name = JOB_ROOT if kind == "job" else REQUEST_ROOT
    roots = [s for s in spans if s["name"] == root_name]
    t0 = min(float(s["ts"]) for s in roots)
    plan = JOB_MILESTONES if kind == "job" else REQUEST_MILESTONES
    horizon = _terminal_end(spans, kind)
    milestones = _milestones(spans, plan, horizon=horizon)
    if kind == "job" and not any(n == "first_step" for n, _ in milestones):
        fallback = _milestones(spans, ((JOB_FALLBACK_END, "last"),),
                               horizon=horizon)
        if fallback:
            milestones.append(("running", fallback[0][1]))
    present = {s["name"] for s in spans}
    missing = [name for name, _ in plan if name not in present]
    segments = []
    prev = t0
    for name, end in milestones:
        segments.append({"name": name, "seconds": end - prev})
        prev = end
    total = prev - t0
    # Walk the critical path back from the span that closed the LAST
    # milestone (post-milestone spans — late reconciles, the request's
    # own completion — did not gate the decomposed interval).
    tail = None
    if milestones:
        tail_name, tail_end = milestones[-1]
        if tail_name == "running":
            tail_name = JOB_FALLBACK_END
        ended = [s for s in spans if s["name"] == tail_name
                 and abs(_span_end(s) - tail_end) < 1e-9]
        tail = ended[0] if ended else None
    path = critical_path(spans, tail=tail)
    return {
        "trace_id": spans[0].get("trace_id"),
        "kind": kind,
        "t0": t0,
        "end": prev,
        "total_s": total,
        "segments": segments,
        "missing_milestones": missing,
        "orphans": len(orphan_spans(spans)),
        "cyclic": has_cycle(spans),
        "spans": len(spans),
        "critical_path": [s["name"] for s in path],
    }


def render(decomp: dict) -> str:
    """The human table (the JAX package's ``trace`` CLI verb prints
    the same)."""
    lines = [f"trace {decomp['trace_id']}  kind={decomp['kind']}  "
             f"spans={decomp['spans']}  orphans={decomp['orphans']}",
             f"total {decomp['total_s']:.4f}s "
             f"(critical path: {' -> '.join(decomp['critical_path'])})",
             f"{'SEGMENT':20} {'SECONDS':>10} {'SHARE':>7}"]
    total = decomp["total_s"] or 1.0
    for seg in decomp["segments"]:
        lines.append(f"{seg['name']:20} {seg['seconds']:>10.4f} "
                     f"{100.0 * seg['seconds'] / total:>6.1f}%")
    ssum = sum(seg["seconds"] for seg in decomp["segments"])
    lines.append(f"{'sum':20} {ssum:>10.4f} "
                 f"{100.0 * ssum / total:>6.1f}%")
    if decomp["missing_milestones"]:
        lines.append("missing milestones: "
                     + ", ".join(decomp["missing_milestones"]))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Canonical (timestamp-free) form
# ---------------------------------------------------------------------------

def canonical(spans: List[dict]) -> dict:
    """A deterministic, timestamp-free view of one trace for the
    byte-stability check (two runs of the same seeded scenario compare
    these, serialized).

    Span ids, timestamps, durations, pids and run-variable attrs are
    all stripped; repeated structural edges (a job reconciled N times
    emits N ``queue_wait`` spans, N varying run to run) collapse into
    one — what remains is exactly the causal STRUCTURE: which span
    names parented which, and which milestones the decomposition saw,
    in pipeline order.
    """
    by_id = {s["span_id"]: s for s in spans}
    edges = set()
    for s in spans:
        parent = by_id.get(s.get("parent_id"))
        edges.add((s["name"], parent["name"] if parent else None))
    decomp = decompose(spans)
    return {
        "kind": decomp["kind"] if decomp else None,
        "edges": sorted(["%s<-%s" % (child, parent or "")
                         for child, parent in edges]),
        "segments": [seg["name"] for seg in decomp["segments"]]
        if decomp else [],
        "orphans": len(orphan_spans(spans)),
    }


def canonical_bytes(spans: List[dict]) -> bytes:
    return json.dumps(canonical(spans), sort_keys=True,
                      separators=(",", ":")).encode()


# ---------------------------------------------------------------------------
# Bundle artifact
# ---------------------------------------------------------------------------

def bundle_payload(events: Iterable[dict]) -> dict:
    """The ``critical_path.json`` artifact every flight bundle carries:
    one decomposition per recognizable trace in the event set."""
    out = {}
    for tid, spans in sorted(traces(events).items()):
        decomp = decompose(spans)
        if decomp is not None:
            decomp = dict(decomp)
            decomp["segments"] = [
                {"name": seg["name"],
                 "seconds": round(seg["seconds"], 6)}
                for seg in decomp["segments"]]
            decomp["total_s"] = round(decomp["total_s"], 6)
            out[tid] = decomp
    return out
