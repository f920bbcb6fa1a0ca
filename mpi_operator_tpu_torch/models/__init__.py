"""Llama decode path in PyTorch (counterpart of mpi_operator_tpu/models)."""
