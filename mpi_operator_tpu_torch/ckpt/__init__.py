"""Checkpoint data plane: counterpart of ``mpi_operator_tpu/ckpt/``
(docs/RESILIENCE.md "Checkpoint data plane").

Each rank streams its own byte range of the one-device state to a
content-addressed blob store (:mod:`blobstore`, the JAX package's store
byte for byte: each package reads the other's), manifests make torn
uploads invisible (:mod:`manifest`), delta checkpoints upload only
changed chunks, and ``restore_resharded`` places the state on any mesh
``parallel.train.reshard_train_state`` takes, each rank reading only
what it holds (:mod:`manager`).
"""

from .blobstore import (BlobError, BlobFaultBank, BlobStore,
                        BlobUnavailableError, BlobWriterKilledError)
from .manifest import (MAX_DELTA_DEPTH, canonical_manifest_bytes,
                       resolve_chain)
from .manager import ManifestCheckpointManager, ShardStreamWriter

__all__ = [
    "BlobError", "BlobFaultBank", "BlobStore", "BlobUnavailableError",
    "BlobWriterKilledError", "MAX_DELTA_DEPTH",
    "canonical_manifest_bytes", "resolve_chain",
    "ManifestCheckpointManager", "ShardStreamWriter",
]
