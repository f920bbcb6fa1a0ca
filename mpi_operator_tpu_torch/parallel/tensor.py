"""Tensor parallelism over the ``tp`` axis of the port's ``DeviceMesh``:
Megatron's conjugate pair of autograd functions and the helpers that
cut and join the shards ``models.llama.llama_param_specs`` names.

One process drives one card, so a rank holds plain local tensors (its
``torch.chunk`` of each ``tp`` dimension), not DTensors: the model runs
column-parallel products (``wq``/``wk``/``wv``/``w1``/``w3``, the
vocab-parallel head) on a replicated input and row-parallel ones
(``wo``/``w2``) whose partial outputs one all-reduce sums.

- :func:`copy_to_tp`: identity forward, all-reduce of the gradient
  backward (the input of a column-parallel region);
- :func:`reduce_from_tp`: all-reduce forward, identity backward (the
  output of a row-parallel region);
- :func:`gather_from_tp`: all-gather along a dim forward, this rank's
  chunk of the gradient backward (the vocab-parallel logits).

The all-reduces of partial products sum in f32 and round once to the
activation dtype (``reduce_from_tp``); JAX's GSPMD sums the partials in
the dot's output dtype.  Every rank receives the same bits from NCCL's
and gloo's collectives, so the replicated activations stay identical on
every rank of the group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from .mesh import AXIS_NAMES

# Where each refused axis waits (ROADMAP.md queue 1 item 3).
_POINTERS = {
    "sp": "sequence parallelism (ring attention, the sp batch iterator)",
    "ep": "MoE over an 'ep' axis",
    "pp": "pipeline parallelism",
}


def axis_sizes(mesh) -> dict:
    """{axis: size} of a six-axis mesh (``parallel.mesh.create_mesh``);
    TypeError for anything else."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None or tuple(names) != AXIS_NAMES:
        raise TypeError(f"expected a DeviceMesh with the axes {AXIS_NAMES} "
                        f"(parallel.mesh.create_mesh), got {mesh!r}")
    return dict(zip(AXIS_NAMES, tuple(mesh.shape)))


def refuse_axes(mesh, what: str, allowed=("dp", "fsdp", "tp")) -> dict:
    """The mesh's axis sizes; NotImplementedError naming the ROADMAP
    item of any axis above 1 that ``what`` does not take."""
    sizes = axis_sizes(mesh)
    for axis, n in sizes.items():
        if n > 1 and axis not in allowed:
            why = _POINTERS.get(axis, f"'{axis}' here")
            raise NotImplementedError(
                f"{what} over a mesh with {axis}={n} is not ported yet: "
                f"ROADMAP.md queue 1 item 3 (multi-GPU parallelism, "
                f"{why})")
    return sizes


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """This rank's place on the ``tp`` axis: its size, its index and the
    group of its ``tp`` neighbours (None when size is 1)."""
    size: int = 1
    rank: int = 0
    group: Any = None
    mesh: Any = None

    @classmethod
    def of(cls, mesh) -> "TensorParallel":
        if mesh is None:
            return cls()
        n = axis_sizes(mesh)["tp"]
        if n == 1:
            return cls(mesh=mesh)
        return cls(n, mesh.get_local_rank("tp"), mesh.get_group("tp"), mesh)

    def __deepcopy__(self, memo):          # groups are not copyable
        return self

    def chunk(self, full: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's ``torch.chunk`` of ``full`` along ``dim`` (all of
        it when ``dim`` is None or size is 1)."""
        if dim is None or self.size == 1:
            return full
        return full.chunk(self.size, dim=dim)[self.rank]

    def gather(self, local: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """The full tensor of every rank's ``local`` chunk along ``dim``
        (a collective; ``local`` itself when ``dim`` is None or size is
        1)."""
        if dim is None or self.size == 1:
            return local
        parts = [torch.empty_like(local) for _ in range(self.size)]
        dist.all_gather(parts, local.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        if self.size > 1:
            dist.all_reduce(t, group=self.group)
        return t


def tp_dim(spec) -> Optional[int]:
    """The dim of a ``llama_param_specs`` entry that 'tp' cuts, or None."""
    return next((d for d, axis in enumerate(spec) if axis == "tp"), None)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # Each rank's gradient covers only its shard's use of the input:
        # their sum (in f32, one rounding) is the input's gradient.
        g = grad.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(g, group=ctx.tp.group)
        return g.to(grad.dtype), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        # A copy: the input is not summed in place.
        y = x.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(y, group=tp.group)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        # The gathered tensor is replicated, so is its gradient: each
        # rank keeps its own chunk.
        return ctx.tp.chunk(grad, ctx.dim).contiguous(), None, None


def copy_to_tp(x, tp: TensorParallel):
    """Identity forward; the gradient all-reduced over ``tp`` (in f32)."""
    return x if tp.size == 1 else _CopyToTP.apply(x, tp)


def reduce_from_tp(x, tp: TensorParallel):
    """Sum of every rank's partial ``x`` over ``tp``, in f32 and rounded
    once to x's dtype; identity backward."""
    return x if tp.size == 1 else _ReduceFromTP.apply(x, tp)


def gather_from_tp(x, tp: TensorParallel, dim: int = -1):
    """Every rank's chunk joined along ``dim`` (exact); the gradient's
    own chunk backward."""
    return x if tp.size == 1 else _GatherFromTP.apply(x, tp, dim % x.dim())
