"""Workload-side bootstrap (the in-pod half of the operator's contract)."""

from .distributed import (ProcessEnv, initialize_from_env,  # noqa: F401
                          launch_latency_seconds, local_device, process_env,
                          submit_time)
