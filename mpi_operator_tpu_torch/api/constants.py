"""Names of the environment the operator's controller injects into a
worker pod: the port's own copy of the workload-side entries of
``mpi_operator_tpu/api/constants.py`` (the operator is the same, so the
names are too).

A torch worker reads the JAX-named variables: ``JAX_COORDINATOR_ADDRESS``
is the ``host:port`` of process 0, where the port's process group keeps
its TCP store.
"""

# Process-group formation (bootstrap/distributed.py).
JAX_COORDINATOR_ADDRESS_ENV = "JAX_COORDINATOR_ADDRESS"
JAX_COORDINATOR_PORT_ENV = "JAX_COORDINATOR_PORT"
JAX_PROCESS_ID_ENV = "JAX_PROCESS_ID"
JAX_NUM_PROCESSES_ENV = "JAX_NUM_PROCESSES"
JAX_LOCAL_DEVICE_COUNT_ENV = "JAX_LOCAL_DEVICE_COUNT"
DEFAULT_JAX_COORDINATOR_PORT = 8476
# Epoch seconds of the job's submission: launch-to-first-all-reduce.
MPIJOB_SUBMIT_TIME_ENV = "MPIJOB_SUBMIT_TIME"

# Multislice identity, injected when spec.slices > 1.
MEGASCALE_COORDINATOR_ADDRESS_ENV = "MEGASCALE_COORDINATOR_ADDRESS"
MEGASCALE_NUM_SLICES_ENV = "MEGASCALE_NUM_SLICES"
MEGASCALE_SLICE_ID_ENV = "MEGASCALE_SLICE_ID"
DEFAULT_MEGASCALE_PORT = 8477

# The gang scheduler's topology surface (parallel/mesh.py
# placement_from_env).
PLACEMENT_ENV = "MPI_OPERATOR_PLACEMENT"
SLICE_NAME_ENV = "MPI_OPERATOR_SLICE"
CHIP_COORDS_ENV = "MPI_OPERATOR_CHIP_COORDS"
NUM_SLICES_ENV = "MPI_OPERATOR_NUM_SLICES"

# The job's causal-trace context (telemetry/trace.py env_context).
TRACE_CONTEXT_ENV = "MPI_OPERATOR_TRACE_CONTEXT"
