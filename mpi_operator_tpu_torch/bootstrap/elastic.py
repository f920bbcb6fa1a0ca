"""Elastic host discovery, the workload-side consumer of the
controller's discover_hosts.sh artifact: the port's own copy of
``mpi_operator_tpu/bootstrap/elastic.py`` (framework-free), on the
port's metrics registry.

Parity with the Horovod elastic flow (reference
proposals/elastic-horovod.md:21-30: horovodrun polls
/etc/mpi/discover_hosts.sh).  The controller regenerates the script from
*running* worker pods on every sync; this module parses it and watches it
for membership changes so workloads can react (re-form the world at a
checkpoint boundary: ``examples/elastic_train_torch.py``).
"""

from __future__ import annotations

import os
import time
from typing import Iterator, List, Optional

from ..telemetry.metrics import default_registry

DISCOVER_SCRIPT = "discover_hosts.sh"


def _elastic_metrics(registry=None):
    """Get-or-create the elastic counters on `registry` (default: the
    process default registry, so they ride any /metrics endpoint the
    process serves)."""
    registry = registry or default_registry()
    return {
        "resyncs": registry.counter(
            "elastic_resyncs_total",
            "Membership changes observed by watch_hosts (world"
            " re-forms at a checkpoint boundary)"),
        "restarts": registry.counter(
            "elastic_restarts_total",
            "Workload restarts recorded via record_restart()"),
        "hosts": registry.gauge(
            "elastic_hosts", "Current discovered host count"),
        "read_errors": registry.counter(
            "elastic_read_errors_total",
            "discover_hosts.sh reads that failed (partition /"
            " volume refresh in flight); membership is held, not"
            " flapped to empty"),
    }


def record_restart(registry=None) -> None:
    """Count a workload restart (call at process start when resuming
    from a checkpoint after preemption/rescheduling)."""
    _elastic_metrics(registry)["restarts"].inc()


def discover_hosts_path() -> Optional[str]:
    """Locate the mounted discover_hosts.sh: the declared mount path
    (/etc/mpi) on a real cluster, or the kubelet's sandboxed remap
    (K_MOUNT_* env) on the local runtime."""
    for key, val in os.environ.items():
        if key.startswith("K_MOUNT_") and not key.startswith("K_MOUNT_PATH_"):
            candidate = os.path.join(val, DISCOVER_SCRIPT)
            if os.path.exists(candidate):
                return candidate
    legacy = "/etc/mpi/" + DISCOVER_SCRIPT
    return legacy if os.path.exists(legacy) else None


def _read_hosts(path: Optional[str]) -> Optional[List[str]]:
    """Parse the script, or None when it cannot be read at all — the
    distinction watch_hosts needs: an *empty* script is a legitimate
    zero-member world (the controller wrote it), an *unreadable* one is
    a partition / mid-refresh volume and says nothing about
    membership."""
    if path is None:
        return None
    hosts: List[str] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line.startswith("echo "):
                    hosts.append(line[len("echo "):].strip())
    except OSError:
        return None
    return hosts


def current_hosts(path: Optional[str] = None) -> List[str]:
    """Parse the script's `echo <fqdn>` lines into a host list."""
    return _read_hosts(path or discover_hosts_path()) or []


def watch_hosts(path: Optional[str] = None, poll: float = 1.0,
                stop=None, registry=None) -> Iterator[List[str]]:
    """Yield the host list whenever membership changes (poll-based, like
    horovodrun's discovery loop).  Yields the initial membership first.
    Each change after the initial yield counts as an elastic resync.

    Partition-tolerant: a failed read (script unreadable — control
    plane partitioned, ConfigMap volume mid-refresh) HOLDS the last
    known membership instead of yielding [].  Flapping to empty would
    tear the world down at the next checkpoint boundary and re-form it
    when the partition heals — two full gang restarts for a fault that
    changed nothing (counted in elastic_read_errors_total instead)."""
    explicit_path = path
    metrics = _elastic_metrics(registry)
    last: Optional[List[str]] = None
    first = True
    while stop is None or not stop.is_set():
        # Re-resolve each poll when not pinned: the mount may appear
        # after startup (kubelet materializes volumes asynchronously).
        current = explicit_path or discover_hosts_path()
        if current is None:
            # No channel at all (no mount, no explicit path): a
            # legitimate empty world, not a read failure.
            hosts: Optional[List[str]] = []
        else:
            hosts = _read_hosts(current)
            if hosts is None:
                # Unreadable channel = partition, even on the FIRST
                # poll (a worker restarting mid-partition must wait for
                # a successful read, not boot into an empty world).
                metrics["read_errors"].inc()
        if hosts is not None and hosts != last:
            last = hosts
            metrics["hosts"].set(len(hosts))
            if not first:
                metrics["resyncs"].inc()
            first = False
            yield hosts
        time.sleep(poll)
