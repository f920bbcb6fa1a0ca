"""Model serving over the KV-cache decode path (the batcher and the HTTP
server; the fleet layer is not ported yet)."""

from .batcher import ContinuousBatcher  # noqa: F401
from .server import InferenceServer  # noqa: F401
