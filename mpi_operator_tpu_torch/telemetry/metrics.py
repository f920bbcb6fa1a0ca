"""Prometheus-style metrics registry (stdlib only): the port's own copy
of what serving uses from ``mpi_operator_tpu/telemetry/metrics.py``.

Counter, Gauge, Histogram and their labeled vectors, a get-or-create
Registry, text exposition in the Prometheus 0.0.4 format, the process
build-info series and the serving metric set, with the JAX package's
metric names.  All reads and writes are lock-protected.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

# Latency-oriented default buckets (seconds).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


def _escape_label_value(value) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _format_labels(names: Sequence[str], values: Sequence) -> str:
    return ",".join(f'{n}="{_escape_label_value(v)}"'
                    for n, v in zip(names, values))


class Counter:
    """Monotonic counter."""

    def __init__(self, name: str, help_text: str,
                 registry: Optional["Registry"] = None):
        self.name = name
        self.help = help_text
        self._value = 0.0
        self._lock = threading.Lock()
        if registry is not None:
            registry.register(self)

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    _TYPE = "counter"

    def expose(self) -> str:
        return (f"# HELP {self.name} {self.help}\n"
                f"# TYPE {self.name} {self._TYPE}\n"
                f"{self.name} {self.value}\n")


class Gauge(Counter):
    """Value that can go up and down."""

    _TYPE = "gauge"

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value


class Histogram:
    """Cumulative-bucket histogram with ``time()`` convenience."""

    def __init__(self, name: str, help_text: str,
                 registry: Optional["Registry"] = None,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_text
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")
        self._counts = [0] * len(self.buckets)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()
        if registry is not None:
            registry.register(self)

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            self._count += 1
            # Per-bucket (non-cumulative) counts; snapshot()/expose()
            # accumulate into the Prometheus cumulative form.
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self._counts[i] += 1
                    break

    def time(self):
        """``with hist.time(): ...`` observes the block's wall time."""
        return _HistogramTimer(self)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> dict:
        """Cumulative bucket counts keyed by upper bound, plus sum/count."""
        with self._lock:
            cumulative, acc = {}, 0
            for bound, c in zip(self.buckets, self._counts):
                acc += c
                cumulative[bound] = acc
            return {"buckets": cumulative, "sum": self._sum,
                    "count": self._count}

    _TYPE = "histogram"

    def expose(self) -> str:
        snap = self.snapshot()
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        for bound, cum in snap["buckets"].items():
            lines.append(f'{self.name}_bucket{{le="{bound}"}} {cum}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {snap["count"]}')
        lines.append(f'{self.name}_sum {snap["sum"]}')
        lines.append(f'{self.name}_count {snap["count"]}')
        return "\n".join(lines) + "\n"


class _HistogramTimer:
    def __init__(self, histogram: Histogram):
        self._histogram = histogram

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._histogram.observe(time.perf_counter() - self._start)
        return False


class _Vec:
    """Shared machinery for labeled metric families."""

    _TYPE = "untyped"

    def __init__(self, name: str, help_text: str, label_names: Sequence[str],
                 registry: Optional["Registry"] = None, **child_kwargs):
        self.name = name
        self.help = help_text
        self.label_names = list(label_names)
        self._children: Dict[tuple, object] = {}
        self._lock = threading.Lock()
        self._child_kwargs = child_kwargs
        if registry is not None:
            registry.register(self)

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values):
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name} expects {len(self.label_names)} label "
                f"values, got {len(values)}")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def remove(self, *values) -> None:
        with self._lock:
            self._children.pop(tuple(str(v) for v in values), None)

    def _items(self) -> Iterable[tuple]:
        with self._lock:
            return sorted(self._children.items())

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self._TYPE}"]
        for key, child in self._items():
            lines.extend(self._expose_child(key, child))
        return "\n".join(lines) + "\n"

    def _expose_child(self, key, child):
        raise NotImplementedError


class CounterVec(_Vec):
    _TYPE = "counter"

    def _new_child(self) -> Counter:
        return Counter(self.name, self.help)

    def get(self, *values) -> float:
        with self._lock:
            child = self._children.get(tuple(str(v) for v in values))
        return child.value if child is not None else 0.0

    def _expose_child(self, key, child):
        labels = _format_labels(self.label_names, key)
        yield f"{self.name}{{{labels}}} {child.value}"


class GaugeVec(CounterVec):
    _TYPE = "gauge"

    def _new_child(self) -> Gauge:
        return Gauge(self.name, self.help)


class HistogramVec(_Vec):
    _TYPE = "histogram"

    def _new_child(self) -> Histogram:
        return Histogram(self.name, self.help,
                         buckets=self._child_kwargs.get(
                             "buckets", DEFAULT_BUCKETS))

    def _expose_child(self, key, child):
        labels = _format_labels(self.label_names, key)
        snap = child.snapshot()
        for bound, cum in snap["buckets"].items():
            yield (f'{self.name}_bucket{{{labels},le="{bound}"}} {cum}')
        yield f'{self.name}_bucket{{{labels},le="+Inf"}} {snap["count"]}'
        yield f'{self.name}_sum{{{labels}}} {snap["sum"]}'
        yield f'{self.name}_count{{{labels}}} {snap["count"]}'


class Registry:
    """Named metric collection with get-or-create helpers."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._order: list = []
        self._lock = threading.Lock()

    def register(self, metric) -> None:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is metric:
                return
            if existing is not None:
                raise ValueError(
                    f"metric {metric.name!r} already registered")
            self._metrics[metric.name] = metric
            self._order.append(metric)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def _get_or_create(self, cls, name: str, help_text: str, **kwargs):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}, not {cls.__name__}")
                return existing
            metric = cls(name, help_text, **kwargs)
            self._metrics[name] = metric
            self._order.append(metric)
            return metric

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get_or_create(Counter, name, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help_text)

    def histogram(self, name: str, help_text: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help_text,
                                   buckets=buckets)

    def counter_vec(self, name: str, help_text: str,
                    label_names: Sequence[str]) -> CounterVec:
        return self._get_or_create(CounterVec, name, help_text,
                                   label_names=label_names)

    def gauge_vec(self, name: str, help_text: str,
                  label_names: Sequence[str]) -> GaugeVec:
        return self._get_or_create(GaugeVec, name, help_text,
                                   label_names=label_names)

    def histogram_vec(self, name: str, help_text: str,
                      label_names: Sequence[str],
                      buckets: Sequence[float] = DEFAULT_BUCKETS
                      ) -> HistogramVec:
        return self._get_or_create(HistogramVec, name, help_text,
                                   label_names=label_names, buckets=buckets)

    def expose(self) -> str:
        with self._lock:
            metrics = list(self._order)
        return "".join(m.expose() for m in metrics)


_DEFAULT_REGISTRY = Registry()


def default_registry() -> Registry:
    """The process-wide registry (training counters, build info)."""
    return _DEFAULT_REGISTRY

# Prometheus-convention process start (epoch seconds at import).
_PROCESS_START_TIME = time.time()


def _build_info_values() -> Tuple[str, str, str]:
    """(port version, torch version, CUDA version or 'none')."""
    import torch

    from .. import __version__
    return __version__, torch.__version__, torch.version.cuda or "none"


def record_build_info(registry: Optional[Registry] = None) -> None:
    """Publish ``mpi_operator_build_info`` (port version, torch and CUDA
    versions; value always 1) and
    ``mpi_operator_process_start_time_seconds`` into the process default
    registry, which :func:`expose_with_defaults` appends to every
    ``/metrics`` endpoint."""
    reg = registry or _DEFAULT_REGISTRY
    reg.gauge(
        "mpi_operator_process_start_time_seconds",
        "Epoch seconds this process started (Prometheus convention)"
    ).set(_PROCESS_START_TIME)
    vec = reg.gauge_vec(
        "mpi_operator_build_info",
        "Build identity of this process: port version, torch version,"
        " CUDA version; value is always 1",
        ("version", "torch", "cuda"))
    vec.labels(*_build_info_values()).set(1)


def expose_with_defaults(registry: Optional[Registry] = None) -> str:
    """Exposition for a ``/metrics`` endpoint: the app registry's
    families followed by the process default registry's (skipped when
    they are the same object)."""
    parts = []
    if registry is not None:
        parts.append(registry.expose())
    if registry is not _DEFAULT_REGISTRY:
        parts.append(_DEFAULT_REGISTRY.expose())
    return "".join(parts)


def new_serving_metrics(registry: Registry) -> dict:
    """The inference-server metric set, shared by InferenceServer and
    ContinuousBatcher (get-or-create: safe to call from both)."""
    return {
        "registry": registry,
        "queue_depth": registry.gauge(
            "serving_queue_depth",
            "Requests waiting for a batcher slot"),
        "active_slots": registry.gauge(
            "serving_active_slots",
            "Batcher slots currently decoding"),
        "batch_size": registry.histogram(
            "serving_batch_size",
            "Active slots per decode tick",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128)),
        "ttft_seconds": registry.histogram(
            "serving_ttft_seconds",
            "Time from request admission to first emitted token"),
        "token_latency_seconds": registry.histogram(
            "serving_token_latency_seconds",
            "Inter-token latency during decode"),
        "request_seconds": registry.histogram(
            "serving_request_seconds",
            "End-to-end /generate request latency"),
        "requests_total": registry.counter(
            "serving_requests_total",
            "Generation requests served (streamed and non-streamed,"
            " including errored/aborted)"),
        # Decode hot-path economics: ticks, device dispatches and
        # device->host token fetches are counted so the one-transfer-
        # per-tick invariant is asserted, not assumed.
        "ticks_total": registry.counter(
            "serving_ticks_total",
            "Decode ticks processed (plain and speculative)"),
        "dispatches_total": registry.counter(
            "serving_decode_dispatches_total",
            "Device computations dispatched by the tick loop"
            " (decode steps)"),
        "transfers_total": registry.counter(
            "serving_d2h_transfers_total",
            "Device-to-host token fetches performed by the tick loop"),
        "pipeline_depth": registry.gauge(
            "serving_pipeline_depth",
            "Decode steps dispatched but not yet fetched"),
        "queue_wait_seconds": registry.histogram_vec(
            "mpi_operator_serve_queue_wait_seconds",
            "Wait from submit to batcher admission; path=deferred for"
            " requests that waited out a pool-exhaustion deferral",
            label_names=("path",)),
        # Prefix-cache economics: the content-addressed paged block
        # cache's hit/eviction accounting (the batcher's prefix_stats
        # dict holds the same numbers for direct inspection).
        "prefix_lookups": registry.counter(
            "mpi_operator_serve_prefix_lookups_total",
            "Prompt-prefix cache lookups at paged admission"),
        "prefix_hit_blocks": registry.counter(
            "mpi_operator_serve_prefix_hit_blocks_total",
            "Cached full prompt blocks reused instead of prefilled"),
        "prefix_hit_tokens": registry.counter(
            "mpi_operator_serve_prefix_hit_tokens_total",
            "Prompt tokens whose K/V came from the prefix cache"),
        "prefix_evicted": registry.counter(
            "mpi_operator_serve_prefix_evicted_total",
            "Refcount-0 cached prefix blocks evicted under pool"
            " pressure"),
        # Disaggregated prefill/decode: the paged KV-transfer protocol's
        # replica-side accounting (serving/kv_transfer.py), under the
        # JAX package's exposition names.
        "kv_pages_exported": registry.counter(
            "mpi_operator_serve_kv_pages_exported_total",
            "KV pages exported by this replica for transfer to a"
            " decode replica (disaggregated serving)"),
        "kv_pages_imported": registry.counter(
            "mpi_operator_serve_kv_pages_imported_total",
            "KV pages imported into this replica's pool from a"
            " prefill replica (disaggregated serving)"),
        "kv_import_rejected": registry.counter_vec(
            "mpi_operator_serve_kv_import_rejected_total",
            "KV-page imports rejected, by reason (digest mismatch,"
            " missing parent chain, pool exhausted, shape/dtype"
            " mismatch, duplicate)",
            label_names=("reason",)),
    }
