"""Training utilities of the port: input prefetch and checkpoints."""

from .checkpoint import CheckpointManager  # noqa: F401
from .data import DevicePrefetcher, synthetic_token_batches  # noqa: F401
