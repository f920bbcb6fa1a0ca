"""Minimal inference HTTP server, with the JAX package's wire format.

Counterpart of ``mpi_operator_tpu/serving/server.py``:

    POST /generate {"tokens": [[...]], "max_new_tokens": 8,
                    "temperature": 0.0, "top_p": 1.0, "top_k": 0,
                    "seed": null, "stop": [...], "eos_token_id": null}
      -> {"tokens": [[...]]}
    POST /generate {..., "stream": true}   -> text/event-stream (SSE),
      one data event per token, then {"done": true, "tokens": [...]}
    GET /healthz
    GET /metrics      -> Prometheus text (serving registry + process
      default registry)
    GET /fleet-state  -> queue depth, slots, the prefix-cache digest
      index, role, model and free pool blocks
    GET /debug-bundle -> {"bundle": path}: a flight-recorder bundle of
      this process, dumped on demand
    POST /prefill {"tokens": [...], "transfer": {"url": ..., "have": [...]},
                   "trace_context": ...}
      -> {"digests": [...], "shipped", "deduped", "imported", "rejected",
          "bytes", "seconds"}: the prefill stage of a disaggregated
      request, its pages pushed to the decode replica at ``url``
    POST /kv/pages {"pages": [...]} -> {"imported", "deduped", "rejected"}:
      install pages another replica pushed (serving/kv_transfer.py)

A ``trace_context`` on /generate or /prefill (``"<trace_id>:<span_id>"``)
parents the replica's ``serve_queue_wait`` and ``prefill`` spans.

With ``max_batch_slots > 0`` single-sequence requests share decode ticks
through the continuous batcher (paged with ``kv_page_size > 0``, chunked
prefill with ``kv_prefill_chunk``, speculative with ``draft_model`` or
``draft_strategy``); multi-row requests, and every request when batching
is off, go through ``generate()`` on the dense cache, or through
``speculative_generate`` for greedy requests when a draft model is set.
``weight_dtype="int8"`` quantizes the model's matmul weights up front.
The card is a serial resource behind one device lock shared with the
batcher.  ``role`` ("unified", "prefill" or "decode") only changes what
the replica advertises at /fleet-state: either role serves either verb.

Serving over a mesh (``mesh=``: a ``parallel.mesh`` mesh whose axes
above 1 are ``tp`` and ``fsdp``, one process per card, every rank
constructing the server): the model is this rank's shard, its tp shard
cut again over fsdp, each block gathered over fsdp just before it runs
(``parallel/fsdp_serve.py``; a whole model, or one that holds its tp
shards whole, is cut here, by ``llama_param_specs``, as the JAX server
places its params).  The paged pool holds this rank's KV heads (cut over
tp only), and K4' runs on them on every rank.  Every rank of the mesh
runs the continuous batcher in lock-step (``serving/mirror.py``); mesh
rank 0 alone binds the HTTP front end and takes requests, the others
serve until it stops (``join()``).  It needs the batcher (multi-row
requests are served row by row through it).  Either role works over
the mesh, at any tp and fsdp: mesh rank 0 alone runs /prefill, /kv/pages
and /fleet-state, and a page it exports or imports carries every KV head
(the JAX wire's layout; the ranks move their head chunks in lock-step,
fsdp replica 0 for an export, every replica for an import,
``serving/batcher.py``), so a replica hands pages to a replica of any
layout, the JAX package's included.  Not ported yet
(NotImplementedError, ROADMAP.md queue 1 item 3, entry 3.5): dp, sp and
ep in a serving mesh.
"""

from __future__ import annotations

import json
import threading
import time
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..telemetry import flight
from ..telemetry.metrics import (Registry, expose_with_defaults,
                                 new_serving_metrics, record_build_info)
from ..telemetry.trace import TraceContext

# Sliding-window attention takes the materialized-score path, so an
# S-token prefill allocates an O(S^2) f32 score matrix; past this prompt
# length that dominates unless chunked prefill bounds it.
_SWA_PROMPT_THRESHOLD = 2048
_swa_chunk_warned = False


def _warn_swa_unchunked(cfg) -> None:
    global _swa_chunk_warned
    if _swa_chunk_warned:
        return
    _swa_chunk_warned = True
    warnings.warn(
        f"sliding_window={cfg.sliding_window} with "
        f"max_seq_len={cfg.max_seq_len} and kv_prefill_chunk=0: SWA "
        f"uses the materialized-score attention path, so a long-prompt "
        f"prefill allocates O(S^2) activation memory. Set "
        f"kv_prefill_chunk (e.g. 512) to bound it.",
        RuntimeWarning, stacklevel=3)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def _respond(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        server: "InferenceServer" = self.server.inference  # type: ignore
        if self.path == "/healthz":
            fatal = getattr(server._batcher, "fatal_error", None)
            if fatal is not None:
                self._respond(503, {"status": "failed",
                                    "error": str(fatal)})
            else:
                self._respond(200, {"status": "ok"})
        elif self.path == "/metrics":
            body = expose_with_defaults(server.telemetry_registry).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/fleet-state":
            self._respond(200, server.fleet_state())
        elif self.path == "/debug-bundle":
            # On-demand black box: freeze the flight ring and the metrics
            # of a live server without stopping it.
            path = flight.dump_bundle(
                "serving-on-demand", registry=server.telemetry_registry)
            if path is None:
                self._respond(500, {"error": "bundle dump failed"})
            else:
                self._respond(200, {"bundle": path})
        else:
            self._respond(404, {"error": "not found"})

    def _read_json(self) -> dict:
        length = int(self.headers.get("Content-Length", "0"))
        return json.loads(self.rfile.read(length))

    def do_POST(self):
        if self.path == "/prefill":
            return self._prefill()
        if self.path == "/kv/pages":
            return self._kv_pages()
        if self.path != "/generate":
            return self._respond(404, {"error": "not found"})
        server: "InferenceServer" = self.server.inference  # type: ignore
        try:
            req = self._read_json()
            tokens = req["tokens"]
            stop = req.get("stop") or []  # null = unset
            if req.get("eos_token_id") is not None:
                stop = list(stop) + [req["eos_token_id"]]
            kwargs = dict(
                max_new_tokens=int(req.get("max_new_tokens", 16)),
                temperature=float(req.get("temperature", 0.0)),
                top_p=float(req.get("top_p", 1.0)),
                top_k=int(req.get("top_k") or 0),
                seed=req.get("seed"),
                stop_tokens=tuple(map(int, stop)),
                trace_ctx=TraceContext.decode(req.get("trace_context")))
            if req.get("stream"):
                return self._stream(server, tokens, kwargs)
            out = server.generate(tokens, **kwargs)
            self._respond(200, {"tokens": out})
        except Exception as exc:
            self._respond(400, {"error": str(exc)})

    def _prefill(self) -> None:
        """POST /prefill: the prefill stage of a disaggregated request.
        Prefill the prompt into this replica's paged pool (the request
        retires at admission, so no decode step runs here), then push
        the pages the destination decode replica is missing."""
        server: "InferenceServer" = self.server.inference  # type: ignore
        try:
            req = self._read_json()
            transfer = req.get("transfer") or {}
            out = server.prefill(
                [int(t) for t in req["tokens"]],
                dest_url=transfer.get("url"), have=transfer.get("have"),
                trace_ctx=TraceContext.decode(req.get("trace_context")))
            self._respond(200, out)
        except Exception as exc:
            self._respond(400, {"error": str(exc)})

    def _kv_pages(self) -> None:
        """POST /kv/pages: install content-addressed KV pages pushed by
        a prefill replica (best-effort: rejected pages are prefilled
        here by the next /generate).  The reply adds this side's seconds
        of wire decoding and of the import."""
        server: "InferenceServer" = self.server.inference  # type: ignore
        try:
            from . import kv_transfer
            req = self._read_json()
            b = server._batcher
            if b is None or b.page_size <= 0:
                return self._respond(400, {
                    "error": "KV-page import requires the paged cache "
                             "(kv_page_size > 0)"})
            t0 = time.perf_counter()
            pages = kv_transfer.decode_pages(req.get("pages") or [])
            t1 = time.perf_counter()
            out = b.import_kv_pages(pages)
            out.update(wire_decode_s=t1 - t0,
                       import_s=time.perf_counter() - t1)
            self._respond(200, out)
        except Exception as exc:
            self._respond(400, {"error": str(exc)})

    def _stream(self, server: "InferenceServer", tokens, kwargs) -> None:
        """SSE: one `data: {"token": t}` event per generated token, then
        `data: {"done": true, "tokens": [...]}`."""
        it = server.stream(tokens, **kwargs)
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def emit(payload: dict) -> None:
            chunk = f"data: {json.dumps(payload)}\n\n".encode()
            self.wfile.write(f"{len(chunk):x}\r\n".encode() + chunk
                             + b"\r\n")
            self.wfile.flush()

        produced = []
        try:
            try:
                for tok in it:
                    produced.append(tok)
                    emit({"token": tok})
                emit({"done": True, "tokens": produced})
            except (BrokenPipeError, ConnectionResetError):
                # Client went away mid-stream: closing the iterator
                # cancels the batcher slot.
                raise
            except Exception as exc:
                emit({"error": str(exc)})
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            self.close_connection = True
        finally:
            it.close()


def _rows(tokens):
    """One sequence or a batch of variable-length sequences -> rows."""
    if hasattr(tokens, "tolist"):
        tokens = tokens.tolist()
    tokens = list(tokens)
    if tokens and isinstance(tokens[0], (list, tuple)):
        rows = [list(map(int, r)) for r in tokens]
    else:
        rows = [list(map(int, tokens))]
    if any(not r for r in rows):
        raise ValueError("empty prompt")
    return rows


class InferenceServer:
    """HTTP front end over a port LlamaModel.  Loopback by default:
    /generate is unauthenticated and compute-expensive."""

    def __init__(self, model, host: str = "127.0.0.1", port: int = 0,
                 max_batch_slots: int = 0, mesh=None,
                 kv_page_size: int = 0, kv_cache_blocks: int = 0,
                 kv_prefix_cache: bool = True, kv_cache_dtype: str = "auto",
                 draft_model=None, draft_strategy: Optional[str] = None,
                 draft_len: int = 4, prompt_lookup_ngram: int = 3,
                 kv_prefill_chunk: int = 0, weight_dtype: str = "auto",
                 pipelined: bool = True,
                 telemetry_registry: Optional[Registry] = None,
                 role: str = "unified", model_name: str = "",
                 device=None, tp_timeout_s: float = 120.0):
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(
                f"role must be 'unified', 'prefill' or 'decode', "
                f"got {role!r}")
        if role != "unified" and kv_page_size <= 0:
            # The handoff IS the paged pool: without it there is nothing
            # to transfer.
            raise ValueError(
                f"role={role!r} (disaggregated serving) requires a "
                f"paged KV cache (kv_page_size > 0); unpaged replicas "
                f"can only serve unified")
        tp = fsdp = None
        if mesh is not None:
            from ..parallel.tensor import TensorParallel, refuse_axes
            sizes = refuse_axes(mesh, "InferenceServer",
                                allowed=("tp", "fsdp"), entry="3.5")
            tp = TensorParallel.of(mesh)
            fsdp = sizes["fsdp"]
            if max_batch_slots <= 0:
                raise ValueError("serving over a mesh runs through the "
                                 "continuous batcher (max_batch_slots > 0)")
        if weight_dtype not in ("auto", "int8"):
            raise ValueError(f"weight_dtype must be 'auto' or 'int8', "
                             f"got {weight_dtype!r}")
        if kv_page_size > 0 and max_batch_slots <= 0:
            raise ValueError(
                "kv_page_size requires continuous batching "
                "(max_batch_slots > 0); the non-batched path uses the "
                "dense cache")
        if kv_cache_dtype != "auto" and kv_page_size <= 0:
            raise ValueError(
                f"kv_cache_dtype={kv_cache_dtype!r} requires "
                f"kv_page_size > 0 (only the paged pool is quantized)")
        if draft_strategy is not None and max_batch_slots <= 0:
            raise ValueError(
                "draft_strategy requires continuous batching "
                "(max_batch_slots > 0); the non-batched path speculates "
                "via draft_model only")
        if kv_prefill_chunk > 0 and max_batch_slots <= 0:
            raise ValueError(
                "kv_prefill_chunk requires continuous batching "
                "(max_batch_slots > 0); the non-batched path prefills "
                "whole prompts through the dense cache")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, server on "
                             f"{self.device}")
        if tp is not None and (model.tp.size != tp.size or (
                fsdp > 1 and model.fsdp_serve is None)):
            if model.tp.size not in (1, tp.size):
                raise ValueError(f"model holds tp={model.tp.size} shards, "
                                 f"the mesh has tp={tp.size}")
            # The caller's whole model stays theirs to drop.
            from ..models.params import shard_model
            model = shard_model(model, mesh)
        if weight_dtype == "int8" and model.config.weight_dtype != "int8":
            # Weight-only int8: quantize the matmul weights up front
            # (models/quant.py).  The caller must drop its own reference
            # to the full-precision model, or both copies stay resident.
            from ..models.quant import quantize_model
            model = quantize_model(model)
        cfg = model.config
        if (cfg.sliding_window is not None
                and cfg.max_seq_len > _SWA_PROMPT_THRESHOLD
                and kv_prefill_chunk <= 0):
            _warn_swa_unchunked(cfg)
        self.model = model
        # Speculative decoding of greedy requests on the non-batched
        # path; the batcher gets the draft too.
        self.draft_model = draft_model
        self.role = role
        self.model_name = model_name
        self._lock = threading.Lock()   # the card is single-flight
        self.telemetry_registry = telemetry_registry or Registry()
        self.telemetry = new_serving_metrics(self.telemetry_registry)
        record_build_info()
        # Wire the tracer into the flight ring now, so the replica's spans
        # are in the ring a /debug-bundle freezes.
        flight.default_recorder()
        self._batcher = None
        self.mirror = None
        if tp is not None and tp.size * fsdp > 1:
            from .mirror import TickMirror, serving_ranks
            self.mirror = TickMirror(serving_ranks(mesh),
                                     timeout_s=tp_timeout_s)
        if max_batch_slots > 0:
            from .batcher import ContinuousBatcher
            self._batcher = ContinuousBatcher(
                model, max_slots=max_batch_slots, device_lock=self._lock,
                page_size=kv_page_size, cache_blocks=kv_cache_blocks,
                prefix_cache=kv_prefix_cache, kv_cache_dtype=kv_cache_dtype,
                draft_model=draft_model, draft_strategy=draft_strategy,
                draft_len=draft_len, prompt_lookup_ngram=prompt_lookup_ngram,
                prefill_chunk=kv_prefill_chunk, pipelined=pipelined,
                telemetry_registry=self.telemetry_registry,
                device=self.device, mirror=self.mirror)
        self._http = None
        self.port = None
        if self.is_leader:
            self._http = ThreadingHTTPServer((host, port), _Handler)
            self._http.inference = self  # type: ignore[attr-defined]
            self.port = self._http.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def is_leader(self) -> bool:
        """Whether this rank takes requests: always, but for the ranks
        past 0 of a serving group (fsdp x tp)."""
        return self.mirror is None or self.mirror.leader

    # -- inference ---------------------------------------------------------
    def generate(self, tokens, max_new_tokens: int = 16,
                 temperature: float = 0.0, top_p: float = 1.0,
                 seed=None, stop_tokens=(), top_k: int = 0,
                 trace_ctx=None) -> list:
        try:
            with self.telemetry["request_seconds"].time():
                return self._generate(tokens, max_new_tokens, temperature,
                                      top_p, seed, stop_tokens, top_k,
                                      trace_ctx)
        finally:
            self.telemetry["requests_total"].inc()

    def _generator(self, seed, temperature):
        if temperature <= 0.0 or seed is None:
            return None
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _generate(self, tokens, max_new_tokens, temperature, top_p, seed,
                  stop_tokens, top_k, trace_ctx) -> list:
        from ..models.llama import generate

        rows = _rows(tokens)
        if self._batcher is not None and len(rows) == 1:
            return [self._batcher.submit(
                rows[0], max_new_tokens, temperature=temperature,
                top_p=top_p, seed=seed, stop_tokens=stop_tokens,
                top_k=top_k, trace_ctx=trace_ctx)]
        if self.mirror is not None:
            # A serving group: every forward must run on every rank, so
            # the rows go through the batcher, each in its own slot, and
            # come back in generate()'s shape (rows past their stop
            # token repeat it up to the longest).
            outs = self._batcher.submit_many(
                rows, max_new_tokens, temperature=temperature, top_p=top_p,
                seed=seed, stop_tokens=stop_tokens, top_k=top_k,
                trace_ctx=trace_ctx)
            width = max(len(o) for o in outs)
            return [o + o[-1:] * (width - len(o)) for o in outs]
        # Right-pad to a rectangle; each row decodes from its own end.
        lengths = [len(r) for r in rows]
        width = max(lengths)
        prompt = [r + [0] * (width - len(r)) for r in rows]
        ragged = len(set(lengths)) > 1
        # The non-batched path speculates with a fixed draft_len of 4, as
        # the JAX server does; both models bound the window, and a
        # request that only fits the target decodes plainly.
        draft_len = 4
        spec_fits = all(width + max_new_tokens + draft_len + 1
                        <= m.config.max_seq_len
                        for m in (self.model, self.draft_model)
                        if m is not None)
        speculate = (self.draft_model is not None and temperature <= 0.0
                     and not ragged and spec_fits)
        with self._lock:
            if speculate:
                from ..models.speculative import speculative_generate
                out = speculative_generate(self.model, self.draft_model,
                                           prompt, max_new_tokens,
                                           draft_len=draft_len)
            else:
                out = generate(self.model, prompt, max_new_tokens,
                               temperature=temperature, top_p=top_p,
                               generator=self._generator(seed, temperature),
                               prompt_lengths=lengths if ragged else None,
                               stop_tokens=stop_tokens, top_k=top_k)
        if stop_tokens and speculate:
            # The speculative path decodes the full budget; cutting at the
            # first stop token is the same as stopping there.
            from ..models.llama import fill_after_stop
            return fill_after_stop(out.cpu().numpy().astype(np.int64),
                                   stop_tokens).tolist()
        return out.cpu().tolist()

    def stream(self, tokens, max_new_tokens: int = 16,
               temperature: float = 0.0, top_p: float = 1.0, seed=None,
               stop_tokens=(), top_k: int = 0, trace_ctx=None):
        """Yield generated ids one at a time for ONE sequence (the SSE
        source): through the batcher when enabled, else per decode step
        under the device lock so a slow consumer never holds the card."""
        start = time.perf_counter()
        try:
            yield from self._stream(tokens, max_new_tokens, temperature,
                                    top_p, seed, stop_tokens, top_k,
                                    trace_ctx)
        finally:
            self.telemetry["request_seconds"].observe(
                time.perf_counter() - start)
            self.telemetry["requests_total"].inc()

    def _stream(self, tokens, max_new_tokens, temperature, top_p, seed,
                stop_tokens, top_k, trace_ctx):
        from ..models.llama import stream_generate

        rows = _rows(tokens)
        if len(rows) != 1:
            raise ValueError("streaming supports one sequence")
        if self._batcher is not None:
            yield from self._batcher.submit_iter(
                rows[0], max_new_tokens, temperature=temperature,
                top_p=top_p, seed=seed, stop_tokens=stop_tokens,
                top_k=top_k, trace_ctx=trace_ctx)
            return
        gen = stream_generate(
            self.model, rows[0], max_new_tokens, temperature=temperature,
            top_p=top_p, generator=self._generator(seed, temperature),
            stop_tokens=stop_tokens, top_k=top_k)
        start = time.perf_counter()
        last = None
        try:
            while True:
                with self._lock:
                    try:
                        tok = next(gen)
                    except StopIteration:
                        return
                now = time.perf_counter()
                if last is None:
                    self.telemetry["ttft_seconds"].observe(now - start)
                else:
                    self.telemetry["token_latency_seconds"].observe(
                        now - last)
                last = now
                yield tok
        finally:
            gen.close()

    def prefill(self, tokens, dest_url: Optional[str] = None,
                have=None, trace_ctx=None) -> dict:
        """Disaggregated prefill stage: put the prompt's full pages into
        this replica's prefix cache (a greedy budget-1 submit retires at
        admission, so no decode step runs here), then push the pages
        ``dest_url`` is missing over the KV-transfer channel.  Returns
        the prompt's chain digests and the transfer's accounting; with
        ``dest_url=None`` it only warms this replica's cache."""
        from . import kv_transfer
        from .batcher import prefix_page_digests
        b = self._batcher
        if b is None or b.page_size <= 0:
            raise ValueError(
                "prefill stage requires the paged cache "
                "(max_batch_slots > 0 and kv_page_size > 0)")
        rows = [int(t) for t in tokens]
        if not rows:
            raise ValueError("empty prompt")
        digests = prefix_page_digests(rows, b.page_size)
        with self.telemetry["request_seconds"].time():
            # The emitted token is discarded: the decode replica derives
            # it again from the transferred pages (K/V depends only on
            # the token prefix).
            b.submit(rows, 1, temperature=0.0, seed=0, trace_ctx=trace_ctx)
        out = {"digests": digests, "shipped": 0, "deduped": 0,
               "imported": 0, "rejected": 0, "bytes": 0}
        if dest_url and digests:
            out.update(kv_transfer.transfer_pages(
                b, digests, dest_url, have=have))
        return out

    def fleet_state(self) -> dict:
        """The GET /fleet-state payload: queue depth and slot occupancy,
        the prefix-cache digest index, identity and free pool blocks."""
        b = self._batcher
        if b is None:
            return {"healthy": True, "queue_depth": 0, "active_slots": 0,
                    "slots": 0, "page_size": 0, "prefix_digests": [],
                    "role": self.role, "model": self.model_name,
                    "free_blocks": 0}
        return {
            "healthy": b.fatal_error is None,
            "queue_depth": b._queue.qsize(),
            "active_slots": int(b.telemetry["active_slots"].value),
            "slots": b.max_slots,
            "page_size": b.page_size,
            "prefix_digests": b.prefix_digest(),
            "role": self.role,
            "model": self.model_name,
            "free_blocks": b.free_blocks(),
        }

    def prefill_logits(self, tokens):
        """A prompt's last-position logits [V] as admission prefills it
        (``ContinuousBatcher.prefill_logits``; paged cache, before
        ``start()`` or after ``stop()``/``join()``).  Under tp every rank
        calls it with the same tokens (the forward is collective) and
        gets the whole logits."""
        return self._batcher.prefill_logits(tokens)

    def batcher_stats(self) -> dict:
        """Copies of the batcher's counters: ``spec`` (speculation
        rounds, plain ticks, drafted and accepted tokens) and ``prefix``
        (prefix-cache lookups and hits; empty without the paged cache).
        Empty without a batcher."""
        b = self._batcher
        if b is None:
            return {}
        return {"spec": dict(b.spec_stats),
                "prefix": dict(getattr(b, "prefix_stats", {}))}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "InferenceServer":
        if self._batcher is not None:
            self._batcher.start()
        if self._http is not None:
            self._thread = threading.Thread(
                target=self._http.serve_forever, daemon=True,
                name="inference")
            self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        """A follower of a serving group serves until rank 0 stops the group:
        wait for that (or ``timeout`` seconds); raise the error that
        stopped it, if one did."""
        if self._batcher is not None:
            self._batcher.join(timeout)

    def stop(self) -> None:
        """Stop serving.  On rank 0 of a serving group this stops
        every rank (at their next turn); on the others it waits for
        that."""
        if self._batcher is not None:
            self._batcher.stop()
        if self._http is None:
            return
        if self._thread is not None:
            self._http.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._http.server_close()
        # Break the server <-> handler-server cycle, so a stopped server's
        # model and KV cache are freed with its last reference, not at a
        # later garbage collection.
        self._http.inference = None

    @property
    def url(self) -> str:
        if self._http is None:
            raise RuntimeError(f"serving rank {self.mirror.rank} "
                               f"serves no HTTP: rank 0 does")
        return f"http://127.0.0.1:{self.port}"
