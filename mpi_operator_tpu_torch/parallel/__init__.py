"""Training of the port, on one device or over a (dp, fsdp, tp)
DeviceMesh of processes (``mesh``: the six-axis mesh; ``train``: the
step, its ZeRO update and hierarchical all-reduce, FSDP2 sharding;
``tensor``: Megatron tensor parallelism over tp).  Meshes with sp, ep or
pp above 1 wait for ROADMAP.md queue 1 item 3."""

from .mesh import MeshConfig, create_mesh  # noqa: F401
from .train import (TrainState, adamw, build_train_step,  # noqa: F401
                    run_train_loop)
