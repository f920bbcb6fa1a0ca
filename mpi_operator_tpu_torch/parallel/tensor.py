"""Tensor parallelism over the ``tp`` axis of the port's ``DeviceMesh``:
Megatron's conjugate pair of autograd functions and the helpers that
cut and join the shards ``models.llama.llama_param_specs`` names.  The
same pair serves expert parallelism over ``ep`` (:class:`ExpertParallel`:
the MoE input and gates enter through :func:`copy_to_ep`, the partial
combines leave through :func:`reduce_from_ep`), and
:class:`SequenceParallel` names a rank's place on ``sp`` (ring
attention, ``ops/ring_attention.py``).  :func:`refuse_pp_mix` keeps
pipelines (``parallel/pipeline.py``) to dp and fsdp.

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

def axis_sizes(mesh) -> dict:
    """{axis: size} of a six-axis mesh (``parallel.mesh.create_mesh``);
    TypeError for anything else."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None or tuple(names) != AXIS_NAMES:
        raise TypeError(f"expected a DeviceMesh with the axes {AXIS_NAMES} "
                        f"(parallel.mesh.create_mesh), got {mesh!r}")
    return dict(zip(AXIS_NAMES, tuple(mesh.shape)))


def refuse_axes(mesh, what: str, allowed=AXIS_NAMES) -> dict:
    """The mesh's axis sizes; NotImplementedError naming the ROADMAP
    item (queue 1 item 3) of any axis above 1 that ``what`` does not
    take."""
    sizes = axis_sizes(mesh)
    for axis, n in sizes.items():
        if n > 1 and axis not in allowed:
            raise NotImplementedError(
                f"{what} over a mesh with {axis}={n} is not ported yet: "
                f"ROADMAP.md queue 1 item 3 (multi-GPU parallelism, "
                f"'{axis}' in {what})")
    return sizes


def refuse_pp_mix(mesh, what: str) -> dict:
    """The mesh's axis sizes; ValueError when pp > 1 meets tp, sp or ep
    above 1.  The pipeline stages run ``LlamaBlock`` without a mesh, as
    the JAX package's do (``models/llama_pipeline.py:45-56``), so those
    axes would only repeat each stage's work: pipelines compose with dp
    and fsdp."""
    sizes = axis_sizes(mesh)
    mixed = [a for a in ("tp", "sp", "ep") if sizes[a] > 1]
    if sizes["pp"] > 1 and mixed:
        raise ValueError(
            f"{what}: pp={sizes['pp']} with "
            f"{', '.join(f'{a}={sizes[a]}' for a in mixed)}: the pipeline "
            f"stages run their blocks without a mesh (as the JAX "
            f"package's stages do), so {'/'.join(mixed)} would only repeat "
            f"each stage's work; combine pp with dp and fsdp")
    return sizes


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """This rank's place on the ``tp`` axis (``AXIS``; another axis when
    ``of`` names it): its size, its index and the group of its
    neighbours on the axis (None when size is 1)."""
    size: int = 1
    rank: int = 0
    group: Any = None
    mesh: Any = None
    AXIS = "tp"

    @classmethod
    def of(cls, mesh, axis: Optional[str] = None) -> "TensorParallel":
        """This rank's place on ``axis`` (default ``AXIS``) of ``mesh``."""
        axis = axis or cls.AXIS
        if mesh is None:
            return cls()
        n = axis_sizes(mesh)[axis]
        if n == 1:
            return cls(mesh=mesh)
        return cls(n, mesh.get_local_rank(axis), mesh.get_group(axis), mesh)

    def peer(self, shift: int) -> int:
        """The global rank ``shift`` places along the axis (a ring)."""
        return dist.get_global_rank(self.group,
                                    (self.rank + shift) % self.size)

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

    def gather_to_first(self, local: torch.Tensor) -> Optional[list]:
        """Every rank's ``local`` (one shape and dtype on every rank), in
        rank order, on rank 0 of the axis; None on the others.  One
        ``gather`` over the group (``[local]`` when size is 1)."""
        if self.size == 1:
            return [local]
        parts = ([torch.empty_like(local) for _ in range(self.size)]
                 if self.rank == 0 else None)
        dist.gather(local.contiguous(), parts,
                    dst=dist.get_global_rank(self.group, 0), group=self.group)
        return parts

    def scatter_from_first(self, parts: Optional[list],
                           like: torch.Tensor) -> torch.Tensor:
        """This rank's tensor of rank 0's ``parts`` (one a rank, in rank
        order, each of ``like``'s shape and dtype; None on the others).
        One ``scatter`` over the group (``parts[0]`` when size is 1)."""
        if self.size == 1:
            return parts[0]
        out = torch.empty_like(like)
        dist.scatter(out, [p.contiguous() for p in parts]
                     if self.rank == 0 else None,
                     src=dist.get_global_rank(self.group, 0),
                     group=self.group)
        return out


class ExpertParallel(TensorParallel):
    """This rank's place on ``ep``: it holds experts
    [rank*E/size, (rank+1)*E/size) of every MoE layer."""
    AXIS = "ep"


class SequenceParallel(TensorParallel):
    """This rank's place on ``sp``: it holds token columns
    [rank*S/size, (rank+1)*S/size) (``parallel.mesh.seq_cols``)."""
    AXIS = "sp"


def ring_shift(tensors, par: TensorParallel, shift: int = 1):
    """Each tensor to the rank ``shift`` places on along ``par``'s axis
    (a ring), and that of the rank ``shift`` places back in its place:
    one batched ``isend``/``irecv`` exchange over the axis group (the
    JAX ``ppermute``; the peers are global ranks, so they hold however
    the other axes lay the ranks out)."""
    dst, src = par.peer(shift), par.peer(-shift)
    received = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, buf in zip(tensors, received):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, par.group))
        ops.append(dist.P2POp(dist.irecv, buf, src, par.group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return received


def tp_dim(spec, axis: str = "tp") -> Optional[int]:
    """The dim of a ``llama_param_specs`` entry that ``axis`` cuts, or
    None."""
    return next((d for d, a in enumerate(spec) if a == axis), None)


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


# The same pair over 'ep' (the group of an ExpertParallel).
copy_to_ep = copy_to_tp
reduce_from_ep = reduce_from_tp


def gather_from_tp(x, tp: TensorParallel, dim: int = -1):
    """Every rank's chunk joined along ``dim`` (exact); the gradient's
    own chunk backward."""
    return x if tp.size == 1 else _GatherFromTP.apply(x, tp, dim % x.dim())
