"""Training of the port on one device (sharded training: ROADMAP.md
queue 1 item 3)."""

from .train import (TrainState, adamw, build_train_step,  # noqa: F401
                    run_train_loop)
