"""Causal-trace spans, the critical-path analyzer and the flight recorder
of the PyTorch port against the JAX package's modules, on the same
inputs; and the training hooks that feed them (preemption bundle and
sidecar, the ``compile`` and ``first_step`` milestones, goodput phase
records, checkpoint spans and the writer-error bundle)."""

import json
import os

import numpy as np
import pytest
import torch

from mpi_operator_tpu.telemetry import critical_path as jax_cp
from mpi_operator_tpu.telemetry import flight as jax_flight
from mpi_operator_tpu.telemetry import trace as jax_trace
from mpi_operator_tpu_torch.parallel.train import run_train_loop
from mpi_operator_tpu_torch.telemetry import critical_path as cp
from mpi_operator_tpu_torch.telemetry import flight, trace
from mpi_operator_tpu_torch.telemetry.goodput import (GoodputTracker,
                                                      instrument_step)
from mpi_operator_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                     restore_checkpoint,
                                                     save_checkpoint)

CARRIERS = [None, "", "garbage", ":5", "id:", "id:notanint", 7,
            "job-default-x-abc123:42", "a:b:3"]


@pytest.mark.parametrize("raw", CARRIERS, ids=repr)
def test_trace_context_decodes_as_jax(raw):
    """Malformed carriers give None (never a raise), as in JAX; good
    ones round-trip."""
    got, want = trace.TraceContext.decode(raw), \
        jax_trace.TraceContext.decode(raw)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.trace_id, got.span_id) == (want.trace_id, want.span_id)
        assert trace.TraceContext.decode(got.encode()) == got
    assert trace.TRACE_CONTEXT_ENV == jax_trace.TRACE_CONTEXT_ENV
    assert trace.TRACE_CONTEXT_ANNOTATION == \
        jax_trace.TRACE_CONTEXT_ANNOTATION


def test_explicit_context_overrides_thread_local_parent():
    tr = trace.Tracer()
    ctx = trace.TraceContext("t-1", 999)
    with tr.span("outer"):
        with tr.span("hop", ctx=ctx) as hop:
            with tr.span("child") as child:
                pass
    assert (hop["parent_id"], hop["trace_id"]) == (999, "t-1")
    assert (child["parent_id"], child["trace_id"]) == (hop["span_id"], "t-1")
    with pytest.raises(ValueError):
        with tr.span("fails"):
            raise ValueError("boom")
    assert tr.events()[-1]["error"] == "ValueError: boom"


def test_retroactive_emit_and_reserved_ids():
    tr = trace.Tracer()
    rid = tr.allocate_id()
    child = tr.emit("route", ts=1.0, dur=-0.5,
                    ctx=trace.TraceContext("t", rid), job="a/b")
    root = tr.emit("request", ts=1.0, dur=1.0, trace_id="t", span_id=rid)
    assert child["dur"] == 0.0 and child["attrs"] == {"job": "a/b"}
    assert child["parent_id"] == root["span_id"] == rid
    assert trace.context_of(root) == trace.TraceContext("t", rid)
    assert cp.orphan_spans(tr.events()) == []


def _seeded_spans(seed=0, kind="job"):
    """A bootstrap-path (job) or request trace with seeded timings."""
    rng = np.random.default_rng(seed)
    names = ([("job_submit", None), ("queue_wait", 1), ("reconcile", 1),
              ("placement", 1), ("admission", 1), ("pod_start", 1),
              ("distributed_init", 1), ("compile", 1), ("first_step", 1)]
             if kind == "job" else
             [("request", None), ("route", 1), ("serve_queue_wait", 1),
              ("prefill", 1), ("request_ttft", 1)])
    tid = "job-default-j-xyz" if kind == "job" else "req-7"
    t, out = 10.0, []
    for i, (name, parent) in enumerate(names, start=1):
        dur = float(rng.uniform(0.01, 1.0))
        out.append({"name": name, "span_id": i, "parent_id": parent,
                    "ts": t, "dur": dur, "pid": 1, "tid": 1,
                    "attrs": {"i": i}, "trace_id": tid})
        t += dur * float(rng.uniform(0.3, 1.0))
    return out


@pytest.mark.parametrize("kind", ["job", "request"])
def test_critical_path_and_chrome_trace_match_jax(kind):
    spans = _seeded_spans(3, kind)
    got, want = cp.decompose(spans), jax_cp.decompose(spans)
    assert got == want
    assert sum(s["seconds"] for s in got["segments"]) == got["total_s"]
    assert got["orphans"] == 0 and not got["cyclic"]
    assert cp.canonical_bytes(spans) == jax_cp.canonical_bytes(spans)
    assert cp.bundle_payload(spans) == jax_cp.bundle_payload(spans)
    assert cp.render(got) == jax_cp.render(want)
    assert trace.to_chrome_trace(spans) == jax_trace.to_chrome_trace(spans)


def test_merged_chrome_trace_lanes_match_jax():
    assert flight.LAYERS == jax_flight.LAYERS
    assert flight._SPAN_LAYERS == jax_flight._SPAN_LAYERS
    spans = _seeded_spans(1) + [
        {"name": "checkpoint_save", "span_id": 50, "ts": 11.0, "dur": 0.5,
         "tid": 3, "attrs": {"step": 4}},
        {"name": "serve_queue_wait", "span_id": 51, "ts": 11.2, "dur": 0.1,
         "tid": 3, "attrs": {}, "error": "x", "trace_id": "req-1"}]
    records = [{"seq": 0, "ts": 11.0, "layer": "train",
                "kind": "goodput_phase", "data": {"seconds": 0.25}},
               {"seq": 1, "ts": 11.5, "layer": "serving",
                "kind": "fatal_error", "data": {"phase": "dispatch"}},
               {"seq": 2, "ts": 11.6, "layer": "chaos", "kind": "inject",
                "data": {"at": 3.0}}]
    sidecar = [{"seq": -2, "ts": 12.0, "layer": "train", "kind": "span",
                "data": {"name": "first_step", "dur": 0.2, "ts": 12.0,
                         "trace_id": "job-default-j-xyz", "span_id": 77,
                         "parent_id": 1, "attrs": {}}}]
    got = flight.merged_chrome_trace(spans, records, sidecar)
    assert got == jax_flight.merged_chrome_trace(spans, records, sidecar)
    lanes = {e["args"]["name"]: e["pid"] for e in got["traceEvents"]
             if e["ph"] == "M"}
    assert lanes == {name: i + 1 for i, name in enumerate(jax_flight.LAYERS)}


def _bundle_dirs(root, reason):
    return sorted(d for d in os.listdir(root) if reason in d) \
        if os.path.isdir(root) else []


def _check_manifest(path):
    manifest = json.load(open(os.path.join(path, "MANIFEST.json")))
    for name in manifest["artifacts"]:
        assert os.path.isfile(os.path.join(path, name)), name
    return manifest


def test_dump_bundle_writes_its_manifest_and_dedups(tmp_path):
    rec = flight.FlightRecorder(max_records=4)
    for i in range(6):
        rec.record("serving", "tick", i=i)
    rec.record("nonsense", "x")
    tr = trace.Tracer()
    tr.emit("request", ts=1.0, dur=1.0, trace_id="req-9", span_id=5)
    path = flight.dump_bundle("unit-test", directory=str(tmp_path),
                              recorder=rec, tracer=tr)
    manifest = _check_manifest(path)
    assert manifest["artifacts"] == [
        "flight.jsonl", "events.jsonl", "trace.json", "critical_path.json",
        "metrics.prom", "job.json"]
    assert manifest["reason"] == "unit-test"
    assert manifest["ring"]["dropped"] == rec.dropped > 0
    header = json.loads(open(os.path.join(path, "flight.jsonl")).readline())
    assert header["kind"] == "flight_header" and header["data"]["dropped"]
    assert rec.records()[-2]["layer"] == "other"   # unknown layer
    assert json.load(open(os.path.join(path, "job.json"))) == {"jobs": []}
    assert "req-9" in json.load(open(os.path.join(path,
                                                  "critical_path.json")))
    key = "torch-trace-test-once"
    first = flight.dump_bundle("dup", directory=str(tmp_path), recorder=rec,
                               once_key=key)
    again = flight.dump_bundle("dup", directory=str(tmp_path), recorder=rec,
                               once_key=key)
    assert first is not None and again is None


def test_preemption_leaves_a_bundle_and_a_sidecar(tmp_path, monkeypatch):
    debug, side = tmp_path / "debug", tmp_path / "side"
    monkeypatch.setenv(flight.DEBUG_DIR_ENV, str(debug))
    monkeypatch.setenv(flight.FLIGHT_DIR_ENV, str(side))
    notice = tmp_path / "preempt.notice"
    notice.write_text("preempted\n")
    state, step = run_train_loop(
        state=0, step_fn=lambda s, b: (s + 1, {}), batches=iter(range(10)),
        preemption_file=str(notice), exit_on_preemption=False, prefetch=0)
    assert step == 0
    (bundle,) = _bundle_dirs(debug, "train-preemption")
    _check_manifest(os.path.join(debug, bundle))
    sidecars = [f for f in os.listdir(side) if f.startswith("flight-")]
    assert sidecars
    records = [json.loads(line) for line in open(side / sidecars[0])]
    assert any(r["layer"] == "train" and r["kind"] == "preemption"
               and r["data"]["exit_code"] == 143 for r in records)
    # The sidecar reads as the JAX package reads one.
    assert jax_flight._read_sidecars(str(side)) == \
        flight._read_sidecars(str(side))


def test_compile_and_first_step_spans_under_a_job_context(monkeypatch):
    ctx = trace.TraceContext("job-default-torch-ctx", 31337)
    monkeypatch.setenv(trace.TRACE_CONTEXT_ENV, ctx.encode())
    goodput = GoodputTracker()
    step = instrument_step(lambda s, b: (s + 1, {"loss": torch.ones(())}),
                           goodput=goodput, sync_every=1)
    run_train_loop(state=0, step_fn=step, batches=iter(range(3)),
                   prefetch=0)
    spans = [e for e in trace.default_tracer().events()
             if e.get("trace_id") == ctx.trace_id]
    assert sorted(e["name"] for e in spans) == ["compile", "first_step"]
    assert all(e["parent_id"] == ctx.span_id for e in spans)
    first = next(e for e in spans if e["name"] == "first_step")
    assert first["attrs"] == {"step": 1}
    phases = [r["data"]["bucket"] for r in flight.default_recorder().records(
        "train") if r["kind"] == "goodput_phase"]
    assert phases[-2:] == ["compile", "productive"]
    # No context: no milestone.
    monkeypatch.delenv(trace.TRACE_CONTEXT_ENV)
    before = len(trace.default_tracer().events())
    run_train_loop(state=0, step_fn=lambda s, b: (s, {}),
                   batches=iter(range(2)), prefetch=0)
    assert not [e for e in trace.default_tracer().events()[before:]
                if e["name"] == "first_step"]


class _State:
    def __init__(self, value=0.0):
        self.w = torch.full((3,), value)

    def state_dict(self):
        return {"w": self.w}

    def load_state_dict(self, payload):
        self.w = payload["w"]


def test_checkpoint_spans_and_writer_error_bundle(tmp_path, monkeypatch):
    monkeypatch.setenv(flight.DEBUG_DIR_ENV, str(tmp_path / "debug"))
    save_checkpoint(str(tmp_path / "ckpt"), _State(2.0), 5)
    restored = restore_checkpoint(str(tmp_path / "ckpt"), _State())
    assert restored.w.tolist() == [2.0] * 3
    names = [(e["name"], e["attrs"]) for e in
             trace.default_tracer().events()[-2:]]
    assert names == [("checkpoint_save", {"step": 5}),
                     ("checkpoint_restore", {"step": 5})]
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("a file where the checkpoint directory should be")
    mgr = CheckpointManager(str(blocker), every=1)
    mgr.save(_State(1.0), 1)
    with pytest.raises(OSError):
        mgr.drain()
    (bundle,) = _bundle_dirs(tmp_path / "debug", "checkpoint-writer-error")
    ring = [json.loads(line) for line in
            open(tmp_path / "debug" / bundle / "flight.jsonl")]
    err = [r for r in ring if r["kind"] == "checkpoint_writer_error"]
    assert err and err[-1]["data"]["step"] == 1
    assert err[-1]["data"]["in_flight_bytes"] == 12
