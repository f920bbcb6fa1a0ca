"""``torch.distributed`` bootstrap from the operator's injected env:
counterpart of ``mpi_operator_tpu/bootstrap/distributed.py``.

The controller injects ``JAX_COORDINATOR_ADDRESS`` (process 0's
``host:port``), ``JAX_PROCESS_ID`` and ``JAX_NUM_PROCESSES`` into every
pod; :func:`initialize_from_env` forms the process group from them:
process 0 hosts the TCP store at the coordinator address, every process
connects to it, and the group forms over NCCL on the card (gloo when the
caller asks for the CPU).  One process drives one card, the card of its
local rank.
"""

from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch

from ..api import constants
from ..device import resolve_device


@dataclass
class ProcessEnv:
    coordinator_address: str
    process_id: int
    num_processes: int
    local_device_count: int
    # Multislice identity (spec.slices > 1); slice_id is -1 outside a
    # multislice job.
    num_slices: int = 1
    slice_id: int = -1

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    @property
    def is_multislice(self) -> bool:
        return self.num_slices > 1


def process_env() -> Optional[ProcessEnv]:
    """Parse the injected env; None when running outside an MPIJob."""
    addr = os.environ.get(constants.JAX_COORDINATOR_ADDRESS_ENV)
    if not addr:
        return None
    return ProcessEnv(
        coordinator_address=addr,
        process_id=int(os.environ.get(constants.JAX_PROCESS_ID_ENV, "0")),
        num_processes=int(os.environ.get(constants.JAX_NUM_PROCESSES_ENV,
                                         "1")),
        local_device_count=int(os.environ.get(
            constants.JAX_LOCAL_DEVICE_COUNT_ENV, "0")),
        num_slices=int(os.environ.get(
            constants.MEGASCALE_NUM_SLICES_ENV, "1")),
        slice_id=int(os.environ.get(
            constants.MEGASCALE_SLICE_ID_ENV, "-1")))


def submit_time() -> Optional[float]:
    """Epoch seconds at which the MPIJob was submitted (injected by the
    controller as MPIJOB_SUBMIT_TIME); None outside an operator-run pod."""
    raw = os.environ.get(constants.MPIJOB_SUBMIT_TIME_ENV)
    return float(raw) if raw else None


def launch_latency_seconds() -> Optional[float]:
    """Seconds elapsed since job submission (None outside an MPIJob).
    Call right after the first collective completes to measure
    submit -> first all-reduce."""
    t0 = submit_time()
    return None if t0 is None else time.time() - t0


def local_device(env: ProcessEnv, device=None) -> torch.device:
    """This process's device: the CPU when ``device`` names it, else the
    card of ``LOCAL_RANK`` (default: process id modulo the visible
    cards)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else \
        env.process_id % torch.cuda.device_count()
    return torch.device("cuda", index)


def initialize_from_env(timeout_seconds: float = 120.0, device=None,
                        collective_timeout_seconds: Optional[float] = None
                        ) -> Optional[ProcessEnv]:
    """Form the default process group from the injected env (no-op
    outside an MPIJob or for a single process, as the JAX version).

    On the card the process first takes its card (:func:`local_device`,
    ``torch.cuda.set_device``) so its NCCL communicator lands there, and
    the group forms over NCCL bound to that card; ``device="cpu"`` forms
    it over gloo.  Retries (0.1 s doubling to 1 s) while the coordinator
    comes up, each attempt on a fresh store, until ``timeout_seconds``;
    the wait is the causal-trace span ``distributed_init``, parented to
    the job context in ``MPI_OPERATOR_TRACE_CONTEXT``.

    The store is made here rather than by ``init_method="tcp://..."``,
    which would give the group's collectives the connect deadline as
    their timeout too; ``collective_timeout_seconds`` sets theirs (default:
    torch's), after which a collective that a peer never joined fails
    (NCCL's watchdog ends the process) instead of waiting on."""
    env = process_env()
    if env is None or env.num_processes <= 1:
        return env
    if env.local_device_count > 1:
        raise NotImplementedError(
            f"{constants.JAX_LOCAL_DEVICE_COUNT_ENV}="
            f"{env.local_device_count}: a torch process drives one card; "
            f"GPU-shaped control-plane env is ROADMAP.md queue 1 item 7")
    import torch.distributed as dist

    from ..telemetry.trace import env_context, span

    dev = local_device(env, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    host, _, port = env.coordinator_address.rpartition(":")
    deadline = time.monotonic() + timeout_seconds
    last_err: Optional[Exception] = None
    delay = 0.1  # quick first retries (the coordinator is usually a
    with span("distributed_init", ctx=env_context(),
              process_id=env.process_id,
              num_processes=env.num_processes):
        while time.monotonic() < deadline:  # fraction of a second behind
            remaining = datetime.timedelta(
                seconds=max(deadline - time.monotonic(), 0.1))
            try:
                store = dist.TCPStore(
                    host, int(port), env.num_processes,
                    is_master=env.is_coordinator, timeout=remaining)
                extra = {} if collective_timeout_seconds is None else {
                    "timeout": datetime.timedelta(
                        seconds=collective_timeout_seconds)}
                dist.init_process_group(
                    "nccl" if dev.type == "cuda" else "gloo", store=store,
                    rank=env.process_id, world_size=env.num_processes,
                    device_id=dev if dev.type == "cuda" else None, **extra)
                return env
            except Exception as exc:  # coordinator not up yet
                last_err = exc
                if dist.is_initialized():
                    dist.destroy_process_group()
                time.sleep(delay)
                delay = min(delay * 2, 1.0)
        raise TimeoutError(
            f"torch.distributed.init_process_group did not connect to "
            f"{env.coordinator_address} within {timeout_seconds}s: "
            f"{last_err}")
