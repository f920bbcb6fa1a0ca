"""Kernels of the port: each module holds a wrapper that launches a
hand-written CUDA kernel for tensors on the card and a plain PyTorch
version of the same function for tensors on the CPU.  ``moe.py`` (the
MoE layer) and ``fused_xent.py`` hold no kernel: their JAX counterparts
compute outside any Pallas kernel too."""

from .attention import flash_attention  # noqa: F401
from .attention import flash_attention_with_lse  # noqa: F401
from .paged_attention import paged_decode_attention  # noqa: F401
from .rmsnorm import fused_rmsnorm, rmsnorm  # noqa: F401
