"""PyTorch/CUDA port of the mpi_operator_tpu workload stack.

A package of its own beside ``mpi_operator_tpu`` (the JAX reference,
which it never imports).  Module names mirror the JAX package so each
counterpart is easy to find: ``models/llama.py``, ``ops/attention.py``,
``ops/paged_attention.py``, ``parallel/train.py``, ``serving/batcher.py``,
``serving/server.py``, ``telemetry/metrics.py``, ``utils/checkpoint.py``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :func:`device.resolve_device`); the hot-path
kernels are hand-written CUDA C++ for Hopper under ``ops/csrc/``.
"""

from .device import resolve_device  # noqa: F401

__version__ = "0.1.0"
