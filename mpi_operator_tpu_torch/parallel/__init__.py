"""Training of the port, on one device or over a DeviceMesh of processes
(``mesh``: the six-axis mesh; ``train``: the step, its ZeRO update and
hierarchical all-reduce, FSDP2 sharding, the live re-shard, the
pipeline plan; ``tensor``: Megatron tensor parallelism over tp, the pair
over ep, the sp ring's exchange; ``pipeline``: GPipe, 1F1B and
interleaved 1F1B over pp)."""

from .mesh import MeshConfig, create_mesh  # noqa: F401
from .train import (TrainState, adam, adamw,  # noqa: F401
                    build_train_step, reshard_train_state, run_train_loop,
                    sgd)
