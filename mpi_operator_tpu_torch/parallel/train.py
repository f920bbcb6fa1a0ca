"""Training step and preemption-aware loop, on one device or over a
``DeviceMesh`` of processes.  Counterpart of
``mpi_operator_tpu/parallel/train.py``.

JAX's ``TrainState`` holds params and optax state as immutable trees and
its jitted step returns new ones.  Here the state holds the model and a
``torch.optim`` optimizer, and the step updates both in place (one copy
of the weights and moments, not two).  JAX derives the step's
collectives from sharding annotations; here the mesh plans name them:
:class:`_ReplicatedPlan` (replicated parameters, gradients reduced on
flat f32 buckets, optionally hierarchical and with a ZeRO update) and
:class:`_ShardedPlan` (FSDP2 ``fully_shard`` over ``fsdp``).

Either plan composes with tensor parallelism over ``tp`` and expert
parallelism over ``ep``: the model is built sharded (``LlamaModel(mesh=)``:
Megatron shards over tp, each MoE layer's experts over ep), the plans
reduce gradients over the batch ranks (dp x fsdp) that share a tp and
ep index (the ep ranks of a batch shard see the same tokens, and
``copy_to_ep`` makes the gradients of replicated leaves identical on
them), the gradient norm sums a sharded leaf's squares over its groups
and a replicated one once, and a checkpoint joins the shards into the
one-device format (and cuts them again on restore).

Under sequence parallelism over ``sp`` the parameters are replicated
over sp and each sp rank's loss is its share of the global mean
(``models.llama.next_token_loss``), so the gradients are summed over sp
while dp and fsdp keep their mean, and the reported loss is the sp sum.
:func:`reshard_train_state` moves a live state onto another mesh, a
pipeline's too.

Over ``pp`` (:class:`_PipelinePlan`) each rank trains its
``models.llama_pipeline.LlamaStage`` through the schedule the caller
picks (``parallel/pipeline.py``): GPipe under autograd, or the fused
(loss, gradients) of 1F1B and interleaved 1F1B; each stage's gradients
are averaged over the dp x fsdp ranks that hold it.
"""

from __future__ import annotations

import inspect
import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from .tensor import ExpertParallel, TensorParallel, refuse_pp_mix, tp_dim


@dataclass
class TrainState:
    """Step count, model and optimizer; ``state_dict()`` is what a
    checkpoint holds.  Under a mesh, ``plan`` makes it the full state on
    every rank that writes (a collective: every rank calls it) and
    ``load_state_dict`` places a full state back onto the shards."""
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    plan: Any = None

    def state_dict(self) -> dict:
        if self.plan is not None:
            return {"step": self.step, **self.plan.state_dict(self)}
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, payload: dict) -> None:
        if self.plan is not None:
            self.plan.load_state_dict(self, payload)
        else:
            self.model.load_state_dict(payload["model"])
            self.optimizer.load_state_dict(payload["optimizer"])
        self.step = int(payload["step"])

    def leaves(self, entry_keys=None) -> list:
        """The one-device state as :class:`Leaf` s, one tensor at a time,
        in the checkpoint stream's order (``ckpt.manager``): the step
        (int64), the parameters in ``LlamaModel.named_parameters()``
        order (the model's own order for another model), each
        parameter's optimizer entries (``entry_keys``: (key, whether it
        is parameter-shaped) pairs, default those the optimizer holds,
        by key), then the model's persistent buffers.  Global shapes
        and order do not depend on the mesh.  Under a plan, every rank
        of the mesh calls each leaf's ``gather`` in this order (the
        plan's gathers are collectives); ``load`` fills only this rank's
        part and touches no other rank."""
        io = self.plan if self.plan is not None else _LocalLeaves()
        if entry_keys is None:
            entry_keys = _held_entry_keys(self.optimizer)
        out = [Leaf("step", (), torch.int64,
                    lambda: torch.tensor(self.step, dtype=torch.int64),
                    lambda read: setattr(self, "step", int(read())))]
        params = io.leaf_params(self)
        for name, shape, dtype in params:
            out.append(Leaf(f"model.{name}", shape, dtype,
                            _bind(io.gather_leaf, self, name, None),
                            _bind(io.load_leaf, self, name, None, True)))
        for name, shape, _ in params:
            for key, shaped in entry_keys:
                out.append(Leaf(
                    f"optimizer.{name}.{key}", shape if shaped else (),
                    io.entry_dtype(self, name, key),
                    _bind(io.gather_leaf, self, name, key),
                    _bind(io.load_leaf, self, name, key, shaped)))
        for name, buf in _persistent_buffers(self.model):
            out.append(Leaf(f"buffer.{name}", tuple(buf.shape), buf.dtype,
                            buf.detach, _bind(_load_whole, buf)))
        return out


@dataclass
class Leaf:
    """One tensor of the one-device state (``TrainState.leaves``): its
    name, global shape and type (None: not held yet, as a fresh
    optimizer's entries), ``gather()`` -> the whole tensor on this
    rank's device, and ``load(read)``, which fills this rank's part from
    ``read(rows=None)``: the whole one-device tensor on the host, or only
    its rows ``(r0, r1)`` of dim 0 where the rank holds a contiguous
    stretch of them."""
    name: str
    shape: tuple
    dtype: Optional[torch.dtype]
    gather: Callable[[], torch.Tensor]
    load: Callable[[Callable], None]


def _bind(fn, *args):
    return lambda *rest: fn(*args, *rest)


def _held_entry_keys(optimizer) -> list:
    """(key, parameter-shaped) of the tensors in one optimizer entry, by
    key ([] before the first step)."""
    entry = next(iter(optimizer.state.values()), {})
    return sorted((k, v.dim() > 0) for k, v in entry.items()
                  if torch.is_tensor(v))


def optimizer_entry_keys(optimizer) -> list:
    """:func:`_held_entry_keys` of one step of ``optimizer``'s class and
    hyperparameters on a 2-element parameter (on the CPU): what a fresh
    optimizer will hold."""
    accepted = inspect.signature(type(optimizer).__init__).parameters
    kwargs = {k: v for k, v in optimizer.defaults.items()
              if k in accepted and k not in ("fused", "capturable")}
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.zeros(2)
    probe = type(optimizer)([p], **kwargs)
    probe.step()
    return _held_entry_keys(probe)


def _persistent_buffers(model):
    for prefix, module in model.named_modules():
        for name, buf in module._buffers.items():
            if buf is not None and \
                    name not in module._non_persistent_buffers_set:
                yield (f"{prefix}.{name}" if prefix else name), buf


@torch.no_grad()
def _load_whole(dst: torch.Tensor, read) -> None:
    dst.copy_(read())


def _entry_value(value: torch.Tensor, param, optimizer) -> torch.Tensor:
    """An optimizer entry placed as ``Optimizer.load_state_dict`` places
    it: a scalar stays on the host unless the optimizer is fused or
    capturable, anything else goes to the parameter's device."""
    if value.dim() == 0 and not any(
            g.get("fused") or g.get("capturable")
            for g in optimizer.param_groups):
        return value.clone()
    return value.to(param.device, copy=True)


def _dtensor_rows(param) -> Optional[tuple]:
    """Rows (r0, r1) of dim 0 that this rank holds of a DTensor that is
    sharded on dim 0 only (FSDP2's ``Shard(0)``, the ``torch.chunk``
    split), else None."""
    from torch.distributed.tensor import Shard
    start, length = 0, param.shape[0] if param.dim() else 0
    for mesh_dim, placement in enumerate(param.placements):
        if not isinstance(placement, Shard):
            continue
        if placement.dim != 0:
            return None
        n = param.device_mesh.size(mesh_dim)
        k = param.device_mesh.get_local_rank(mesh_dim)
        size = -(-length // n)
        start += min(k * size, length)
        length = max(0, min(size, length - k * size))
    return start, start + length


class _LocalLeaves:
    """:meth:`TrainState.leaves` of a state on one device (no plan)."""

    @staticmethod
    def _param(state, name):
        return dict(state.model.named_parameters())[name]

    def leaf_params(self, state):
        return [(n, tuple(p.shape), p.dtype)
                for n, p in state.model.named_parameters()]

    def entry_dtype(self, state, name, key):
        value = state.optimizer.state.get(self._param(state, name), {}).get(
            key)
        return value.dtype if torch.is_tensor(value) else None

    def gather_leaf(self, state, name, key):
        p = self._param(state, name)
        return (p if key is None else state.optimizer.state[p][key]).detach()

    @torch.no_grad()
    def load_leaf(self, state, name, key, shaped, read):
        p = self._param(state, name)
        if key is None:
            p.copy_(read())
        else:
            state.optimizer.state[p][key] = _entry_value(read(), p,
                                                         state.optimizer)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> Callable[[Any], torch.optim.Optimizer]:
    """Counterpart of ``optax.adamw``, with optax's defaults (torch's own
    weight decay default is 1e-2): a factory build_train_step calls on
    the model's parameters.

    optax:  p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)
    torch:  p <- p * (1 - lr * wd);  p <- p - lr * m_hat / (sqrt(v_hat)
            + eps)
    which is the same update: the Adam term does not depend on p."""
    def make(params):
        return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2),
                                 eps=eps, weight_decay=weight_decay)
    return make


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Callable[[Any], torch.optim.Optimizer]:
    """Counterpart of ``optax.adam``: :func:`adamw` without weight
    decay (the same m_hat / (sqrt(v_hat) + eps) step)."""
    return adamw(learning_rate, b1, b2, eps, weight_decay=0.0)


def sgd(learning_rate: float, momentum: float = 0.0
        ) -> Callable[[Any], torch.optim.Optimizer]:
    """Counterpart of ``optax.sgd(learning_rate, momentum)``.

    optax:  t <- g + momentum * t  (t = 0 at init);  p <- p - lr * t
    torch:  b <- g at the first step, then momentum * b + g;  p <- p -
            lr * b  (dampening 0, no Nesterov), the same sequence."""
    def make(params):
        return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                               dampening=0.0, nesterov=False)
    return make


def optax_global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


# ---------------------------------------------------------------------------
# Mesh plans: which collectives a step runs
# ---------------------------------------------------------------------------

# Elements of one flat f32 bucket (256 MiB): the transient buffer of a
# collective is bounded by it whatever the model's size.
BUCKET_ELEMENTS = 1 << 26


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axis_ranks(mesh, axes):
    """The ranks of each group that varies over ``axes`` (in mesh order)
    with every other coordinate fixed: a [groups, group size] list."""
    names = list(mesh.mesh_dim_names)
    keep = [names.index(a) for a in axes]
    rest = [d for d in range(len(names)) if d not in keep]
    ranks = mesh.mesh.permute(*rest, *keep)
    return ranks.reshape(-1, ranks[(0,) * len(rest)].numel()).tolist()


class _AxesGroup:
    """A sum over several mesh axes at once: one all-reduce over the
    default group when the axes span every rank of it, else one over
    each axis above 1 in turn (the mesh's own groups; no group is made
    here, so a plan can be built on the members of a mesh alone)."""

    def __init__(self, mesh, axes):
        sizes = _axis_sizes(mesh)
        self.size = 1
        for a in axes:
            self.size *= sizes[a]
        if self.size == dist.get_world_size() == mesh.mesh.numel():
            self.groups = [None]
        else:
            self.groups = [mesh.get_group(a) for a in axes if sizes[a] > 1]

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        for group in self.groups:
            dist.all_reduce(t, group=group)
        return t


def _ssq_split(tensors, kinds) -> torch.Tensor:
    """Sums of squares by how a tensor is cut, f32 [4]: index bit 0 set
    for the tp-sharded tensors, bit 1 for the ep-sharded ones."""
    parts = [torch.zeros((), dtype=torch.float32,
                         device=tensors[0].device) for _ in range(4)]
    for t, kind in zip(tensors, kinds):
        parts[kind] = parts[kind] + \
            torch.linalg.vector_norm(t, dtype=torch.float32).square()
    return torch.stack(parts)


def _shard_norm(ssq: torch.Tensor, tp: TensorParallel,
                ep: ExpertParallel) -> torch.Tensor:
    """The global norm from :func:`_ssq_split`'s sums: each sharded kind
    summed over the groups that cut it, a replicated one counted once."""
    for bit, par in ((1, tp), (2, ep)):
        if par.size > 1:
            cut = torch.tensor([bool(k & bit) for k in range(4)],
                               device=ssq.device)
            part = torch.where(cut, ssq, torch.zeros_like(ssq))
            par.all_reduce_(part)
            ssq = torch.where(cut, part, ssq)
    return ssq.sum().sqrt()


class _Layout:
    """The 'tp' and 'ep' dims of each trainable parameter (by name and by
    index in ``model.parameters()``), from the param specs."""

    def __init__(self, model, specs, tp: TensorParallel,
                 ep: ExpertParallel):
        self.tp, self.ep = tp, ep
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self.names = [n for n, _ in named]
        self.dims = {n: (tp_dim(specs[n]) if tp.size > 1 else None,
                         tp_dim(specs[n], "ep") if ep.size > 1 else None)
                     for n in self.names}
        self.kinds = [(d is not None) + 2 * (e is not None)
                      for d, e in (self.dims[n] for n in self.names)]
        self.sharded = tp.size > 1 or ep.size > 1

    def _name(self, name_or_index):
        return name_or_index if isinstance(name_or_index, str) else \
            self.names[name_or_index]

    def gather(self, name_or_index, value):
        """The full tensor of a parameter-shaped chunk (collective)."""
        d, e = self.dims.get(self._name(name_or_index), (None, None))
        return self.ep.gather(self.tp.gather(value, d), e)

    def cut(self, name_or_index, value):
        d, e = self.dims.get(self._name(name_or_index), (None, None))
        if d is None and e is None:
            return value
        return self.ep.chunk(self.tp.chunk(value, d), e).clone()

    def full_shape(self, name, shape) -> tuple:
        """The one-device shape of a parameter-shaped chunk's ``shape``."""
        d, e = self.dims.get(name, (None, None))
        shape = list(shape)
        for dim, par in ((d, self.tp), (e, self.ep)):
            if dim is not None:
                shape[dim] *= par.size
        return tuple(shape)


def _buckets(sizes, cap: int = BUCKET_ELEMENTS):
    """Consecutive index groups of ``sizes`` whose sums stay within
    ``cap`` (a larger single entry gets a group of its own)."""
    group, total = [], 0
    for i, n in enumerate(sizes):
        if group and total + n > cap:
            yield group
            group, total = [], 0
        group.append(i)
        total += n
    if group:
        yield group


def _first_divisible_dim(shape, n: int) -> Optional[int]:
    """The first dim of ``shape`` divisible by ``n`` (``graft_spec``'s
    choice of the ZeRO dim on a replicated leaf), or None."""
    return next((d for d, size in enumerate(shape)
                 if size > 0 and size % n == 0), None)


def _chunk(t: torch.Tensor, d: int, n: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s chunk of ``t`` along dim ``d`` of ``n``, with that
    dim first (a view)."""
    return t.movedim(d, 0).chunk(n)[rank]


class _RankMajor:
    """Tensors laid out for a collective over ``n`` ranks: tensor t's
    chunk r (along its dim ``dims[t]``) lies in the r-th contiguous 1/n
    of the flat buffer, so ``reduce_scatter_tensor`` hands rank r its
    chunks of every tensor and ``all_gather_into_tensor`` puts them
    back."""

    def __init__(self, shapes, dims, n: int):
        self.n = n
        self.dims = dims
        # A chunk in the layout it is packed in: the sharded dim first.
        self.chunk_shapes = [
            (s[d] // n,) + tuple(s[:d]) + tuple(s[d + 1:])
            for s, d in zip(shapes, dims)]
        self.sizes = [torch.Size(c).numel() for c in self.chunk_shapes]
        self.per_rank = sum(self.sizes)

    def pack(self, tensors) -> torch.Tensor:
        return torch.cat([t.float().movedim(d, 0).reshape(self.n, -1)
                          for t, d in zip(tensors, self.dims)],
                         dim=1).reshape(-1)

    def chunks(self, shard: torch.Tensor):
        """Views of one rank's chunk of each tensor in a [per_rank]
        buffer."""
        return [piece.view(shape) for piece, shape in
                zip(shard.split(self.sizes), self.chunk_shapes)]

    @torch.no_grad()
    def unpack(self, flat: torch.Tensor, tensors) -> None:
        parts = flat.view(self.n, self.per_rank).split(self.sizes, dim=1)
        for t, d, part in zip(tensors, self.dims, parts):
            t.movedim(d, 0).copy_(part.reshape(t.movedim(d, 0).shape))


def _all_reduce_mean(tensors, world: int, group: _AxesGroup) -> None:
    """Replace each tensor by its sum over ``group`` divided by ``world``,
    on flat f32 buckets."""
    for bucket in _buckets([t.numel() for t in tensors]):
        flat = torch.cat([tensors[i].float().reshape(-1) for i in bucket])
        group.all_reduce_(flat)
        if world != 1:
            flat /= world
        for i, piece in zip(bucket, flat.split([tensors[i].numel()
                                                for i in bucket])):
            tensors[i].copy_(piece.view(tensors[i].shape))


class _ReplicatedPlan:
    """Replicated parameters on every rank of a (dp, fsdp) mesh; each rank
    takes its rows of the batch, and the gradients are averaged over all
    of them with explicit collectives on flat f32 buckets:

    - flat: one all-reduce over every batch rank;
    - hierarchical (``ici`` > 1): reduce-scatter over ``ici_axis`` (one
      node: NVLink), all-reduce of that 1/ici shard over ``dp`` (across
      nodes), all-gather over ``ici_axis``;
    - ZeRO (``shard_update``, dp > 1, arXiv:2004.13336): the optimizer
      holds only this rank's chunk of each parameter, so its state lives
      sharded from step 0: the gradients are reduce-scattered over
      ``dp`` and all-reduced over the other batch axis, AdamW updates the
      chunk, and the updated chunks are all-gathered into the
      parameters.  Combined with the hierarchical schedule the update
      takes the intra-node shards directly: reduce-scatter over
      ``ici_axis``, all-reduce over dp, update, all-gather over
      ``ici_axis``.

    A chunk is cut along the parameter's first dim divisible by the
    group's size; a parameter with no such dim stays whole and is
    all-reduced, as ``graft_spec`` leaves it replicated.  Under sp the
    sums run over the sp group too (the gradients are summed over sp,
    not averaged)."""

    def __init__(self, mesh, zero: bool, hier: bool, ici_axis: str,
                 specs=None):
        sizes = _axis_sizes(mesh)
        self.full_mesh = mesh
        self.device = _mesh_device(mesh)
        self.world = sizes["dp"] * sizes["fsdp"]       # batch ranks
        self.grads = _AxesGroup(mesh, ("dp", "fsdp", "sp"))
        self.tp = TensorParallel.of(mesh)
        self.ep = ExpertParallel.of(mesh)
        self.specs = specs
        self.layout = None
        self.zero = zero
        # The collectives' pair: the group the buckets are scattered
        # over, and the axes that then reduce the scattered shard.
        if hier:
            scatter, other = ici_axis, "dp"
        else:
            scatter, other = "dp", "fsdp"
        self.scatter = (mesh.get_group(scatter), sizes[scatter])
        self.other = _AxesGroup(mesh, (other, "sp"))
        self.split = zero or hier
        self.layouts = []          # (indices, _RankMajor) per bucket
        self.whole = []            # indices reduced whole
        self.masters = {}          # index -> this rank's chunk (ZeRO)

    def place(self, model):
        return model

    def optimizer(self, model, factory):
        params = [p for p in model.parameters() if p.requires_grad]
        self.layout = _Layout(model, self.specs, self.tp, self.ep)
        group, n = self.scatter
        dims = {i: _first_divisible_dim(p.shape, n)
                for i, p in enumerate(params)} if self.split else {}
        chunked = [i for i in range(len(params)) if dims.get(i) is not None]
        self.whole = [i for i in range(len(params)) if i not in chunked]
        self.layouts = [
            (idx, _RankMajor([params[i].shape for i in idx],
                             [dims[i] for i in idx], n))
            for idx in (
                [chunked[j] for j in b]
                for b in _buckets([params[i].numel() for i in chunked]))]
        if not self.zero:
            return factory(params)
        rank = dist.get_rank(group)
        for idx, layout in self.layouts:
            for i, d in zip(idx, layout.dims):
                self.masters[i] = torch.nn.Parameter(
                    _chunk(params[i].detach(), d, n, rank).clone(
                        memory_format=torch.contiguous_format))
        return factory([self.masters.get(i, p)
                        for i, p in enumerate(params)])

    def reduce(self, params) -> None:
        """Gradients (each rank's mean over its rows) -> the mean over
        every batch rank (summed over sp): in ``p.grad``, or in the
        masters' ``grad`` under ZeRO."""
        group, n = self.scatter
        if not self.split:
            _all_reduce_mean([p.grad for p in params], self.world,
                             self.grads)
            return
        for idx, layout in self.layouts:
            flat = layout.pack([params[i].grad for i in idx])
            shard = flat.new_empty(layout.per_rank)
            dist.reduce_scatter_tensor(shard, flat, group=group)
            self.other.all_reduce_(shard)
            shard /= self.world
            if self.zero:
                for i, chunk in zip(idx, layout.chunks(shard)):
                    self.masters[i].grad = chunk.to(params[i].dtype)
                    params[i].grad = None
            else:
                dist.all_gather_into_tensor(flat, shard, group=group)
                layout.unpack(flat, [params[i].grad for i in idx])
        _all_reduce_mean([params[i].grad for i in self.whole], self.world,
                         self.grads)

    def grad_norm(self, params) -> torch.Tensor:
        if self.layout.sharded:
            return self._shard_grad_norm(params)
        if not self.zero:
            return optax_global_norm([p.grad for p in params])
        group, _ = self.scatter
        split = optax_global_norm([m.grad for m in self.masters.values()])
        split = split.square()
        dist.all_reduce(split, group=group)
        whole = [params[i].grad for i in self.whole]
        if whole:
            split = split + optax_global_norm(whole).square()
        return split.sqrt()

    def _shard_grad_norm(self, params) -> torch.Tensor:
        kinds = self.layout.kinds
        if not self.zero:
            return _shard_norm(_ssq_split([p.grad for p in params], kinds),
                               self.tp, self.ep)
        split = _ssq_split([m.grad for m in self.masters.values()],
                           [kinds[i] for i in self.masters])
        dist.all_reduce(split, group=self.scatter[0])
        if self.whole:
            split = split + _ssq_split([params[i].grad for i in self.whole],
                                       [kinds[i] for i in self.whole])
        return _shard_norm(split, self.tp, self.ep)

    @torch.no_grad()
    def after_step(self, params) -> None:
        """ZeRO: all-gather the updated chunks into the parameters."""
        if not self.zero:
            return
        group, n = self.scatter
        for idx, layout in self.layouts:
            shard = torch.cat([self.masters[i].float().reshape(-1)
                               for i in idx])
            flat = shard.new_empty(n * layout.per_rank)
            dist.all_gather_into_tensor(flat, shard, group=group)
            layout.unpack(flat, [params[i] for i in idx])

    def _chunk_layout(self, i):
        for idx, layout in self.layouts:
            if i in idx:
                return layout, idx.index(i)
        raise KeyError(i)

    def state_dict(self, state) -> dict:
        """The full state, as one device's optimizer over
        ``model.parameters()`` would hold it: ZeRO chunks of the moments
        are all-gathered, tp and ep shards joined (every rank takes
        part)."""
        optim = state.optimizer.state_dict()
        # Its per-parameter entries are the optimizer's live dicts: the
        # gathers below replace tensors in copies of them.
        optim["state"] = {
            i: {key: (self.gather_leaf(state, self.layout.names[i], key)
                      if torch.is_tensor(value) and value.dim() else value)
                for key, value in e.items()}
            for i, e in optim["state"].items()}
        model = state.model.state_dict()
        if self.layout.sharded:
            lay = self.layout
            model = {k: lay.gather(k, v) for k, v in model.items()}
        return {"model": model, "optimizer": optim}

    @torch.no_grad()
    def load_state_dict(self, state, payload: dict) -> None:
        model, optim = payload["model"], payload["optimizer"]
        if self.layout.sharded:
            lay = self.layout
            model = {k: lay.cut(k, v) for k, v in model.items()}
            optim = {"param_groups": optim["param_groups"],
                     "state": {i: {key: (lay.cut(i, v) if torch.is_tensor(v)
                                         and v.dim() else v)
                                   for key, v in entry.items()}
                               for i, entry in optim["state"].items()}}
        state.model.load_state_dict(model)
        if self.zero:
            group, n = self.scatter
            rank = dist.get_rank(group)
            params = [p for p in state.model.parameters() if p.requires_grad]
            optim = {"param_groups": optim["param_groups"],
                     "state": dict(optim["state"])}
            for i, master in self.masters.items():
                layout, k = self._chunk_layout(i)
                d = layout.dims[k]
                master.copy_(_chunk(params[i], d, n, rank))
                entry = dict(optim["state"].get(i, {}))
                for key, value in entry.items():
                    if torch.is_tensor(value) and value.dim() and \
                            value.shape == params[i].shape:
                        entry[key] = _chunk(value, d, n, rank).clone()
                optim["state"][i] = entry
        state.optimizer.load_state_dict(optim)

    # -- one tensor at a time (TrainState.leaves) ---------------------------
    def leaf_params(self, state):
        params = [p for p in state.model.parameters() if p.requires_grad]
        return [(n, self.layout.full_shape(n, p.shape), p.dtype)
                for n, p in zip(self.layout.names, params)]

    def _holder(self, state, i):
        params = [p for p in state.model.parameters() if p.requires_grad]
        return params[i], self.masters.get(i, params[i])

    def entry_dtype(self, state, name, key):
        _, holder = self._holder(state, self.layout.names.index(name))
        value = state.optimizer.state.get(holder, {}).get(key)
        return value.dtype if torch.is_tensor(value) else None

    @torch.no_grad()
    def gather_leaf(self, state, name, key):
        """The whole tensor on every rank: a ZeRO chunk all-gathered over
        the scatter group, a tp or ep shard over its group."""
        i = self.layout.names.index(name)
        param, holder = self._holder(state, i)
        t = param if key is None else state.optimizer.state[holder][key]
        if key is not None and i in self.masters and t.dim():
            group, n = self.scatter
            layout, k = self._chunk_layout(i)
            full = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
            dist.all_gather_into_tensor(full, t.contiguous(), group=group)
            t = full.movedim(0, layout.dims[k])
        if self.layout.sharded and t.dim():
            t = self.layout.gather(i, t)
        return t.detach()

    @torch.no_grad()
    def load_leaf(self, state, name, key, shaped, read):
        i = self.layout.names.index(name)
        param, holder = self._holder(state, i)
        value = read()
        if self.layout.sharded and value.dim():
            value = self.layout.cut(i, value)
        d = None                              # the ZeRO chunk's dim
        if i in self.masters:
            group, n = self.scatter
            layout, k = self._chunk_layout(i)
            d, rank = layout.dims[k], dist.get_rank(group)
        if key is None:
            param.copy_(value)
            if d is not None:
                holder.copy_(_chunk(param, d, n, rank))
            return
        if d is not None and value.dim():
            value = _chunk(value, d, n, rank)
        state.optimizer.state[holder][key] = _entry_value(
            value.contiguous(), holder, state.optimizer)


class _ShardedPlan:
    """Parameters sharded over ``fsdp`` with FSDP2 ``fully_shard``: one
    unit per block (each child of the model's ``nn.ModuleList``s) and the
    root.  FSDP2 shards every parameter of a unit on dim 0 (the JAX spec
    names dim 1 for some; numerics do not depend on it) and reduces the
    gradients inside the backward: with dp > 1 over the 2-D (dp, fsdp)
    mesh, replicated over dp (HSDP: reduce-scatter over fsdp, then
    all-reduce of the shard over dp, which is the hierarchical
    schedule).  With ``shard_update`` and dp > 1 the parameters and
    optimizer state are sharded over every batch rank (dp x fsdp), the
    JAX ZeRO plan's optimizer-state sharding.  Under sp each rank's
    gradient shard is then summed over the sp group: an HSDP replicate
    dim over sp would average it."""

    def __init__(self, mesh, zero: bool, specs=None):
        from torch.distributed.device_mesh import DeviceMesh
        sizes = _axis_sizes(mesh)
        self.full_mesh = mesh
        self.device = _mesh_device(mesh)
        self.world = sizes["dp"] * sizes["fsdp"]       # batch ranks
        self.grads = _AxesGroup(mesh, ("dp", "fsdp", "sp"))
        self.sp = _AxesGroup(mesh, ("sp",))
        self.tp = TensorParallel.of(mesh)
        self.ep = ExpertParallel.of(mesh)
        self.specs = specs
        self.layout = None
        if sizes["dp"] == 1:
            self.mesh, self.norm_group = mesh["fsdp"], mesh.get_group("fsdp")
        elif zero:
            # Every batch rank of this rank's place on the other axes
            # (all ranks without them).
            self.mesh = DeviceMesh(
                mesh.device_type, _axis_ranks(mesh, ("dp", "fsdp")),
                mesh_dim_names=("others", "batch"))["batch"]
            self.norm_group = self.mesh.get_group()
        else:
            self.mesh = mesh["dp", "fsdp"]
            self.norm_group = mesh.get_group("fsdp")

    def place(self, model):
        from torch.distributed.fsdp import fully_shard
        for module in list(model.modules()):
            if isinstance(module, torch.nn.ModuleList):
                for block in module:
                    fully_shard(block, mesh=self.mesh)
        fully_shard(model, mesh=self.mesh)
        return model

    def optimizer(self, model, factory):
        self.layout = _Layout(model, self.specs, self.tp, self.ep)
        return factory(model.parameters())

    def reduce(self, params) -> None:
        """FSDP2 reduced the gradients over the batch ranks in the
        backward; under sp each rank's shards are summed over sp."""
        if self.sp.size > 1:
            _all_reduce_mean([p.grad.to_local() for p in params], 1,
                             self.sp)

    def grad_norm(self, params) -> torch.Tensor:
        if self.layout.sharded:
            ssq = _ssq_split([p.grad.to_local() for p in params],
                             self.layout.kinds)
            dist.all_reduce(ssq, group=self.norm_group)
            return _shard_norm(ssq, self.tp, self.ep)
        local = optax_global_norm([p.grad.to_local() for p in params])
        ssq = local.square()
        dist.all_reduce(ssq, group=self.norm_group)
        return ssq.sqrt()

    def after_step(self, params) -> None:
        """FSDP2 all-gathers the shards in the next forward."""

    def _options(self):
        from torch.distributed.checkpoint.state_dict import StateDictOptions
        return StateDictOptions(full_state_dict=True, cpu_offload=True)

    def state_dict(self, state) -> dict:
        """The full model and optimizer state on rank 0 (empty elsewhere;
        every rank takes part): ``torch.distributed.checkpoint``'s
        ``get_state_dict``, its optimizer state keyed by parameter
        name."""
        from torch.distributed.checkpoint.state_dict import get_state_dict
        if self.layout.sharded:
            return self._tp_state_dict(state)
        model, optim = get_state_dict(state.model, state.optimizer,
                                      options=self._options())
        return {"model": model, "optimizer": optim}

    @torch.no_grad()
    def _tp_state_dict(self, state) -> dict:
        """get_state_dict's full form (optimizer state keyed by parameter
        name), one tensor at a time (:meth:`gather_leaf`), kept (on the
        host) by rank 0 alone."""
        keep = dist.get_rank() == 0

        def full(name, key):
            t = self.gather_leaf(state, name, key)
            return t.cpu() if keep else None

        opt = state.optimizer
        names = {id(p): n for n, p in state.model.named_parameters()}
        model = {n: full(n, None) for n in names.values()}
        optim = {"state": {}, "param_groups": []}
        for group in opt.param_groups:
            optim["param_groups"].append(
                {**{k: v for k, v in group.items() if k != "params"},
                 "params": [names[id(p)] for p in group["params"]]})
            for p in group["params"]:
                optim["state"][names[id(p)]] = {
                    k: full(names[id(p)], k) if torch.is_tensor(v) else v
                    for k, v in opt.state.get(p, {}).items()}
        if not keep:
            return {}
        return {"model": model, "optimizer": optim}

    def load_state_dict(self, state, payload: dict) -> None:
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions, set_state_dict)
        model, optim = payload["model"], payload["optimizer"]
        if self.layout.sharded:
            lay = self.layout
            model = {k: lay.cut(k, v) for k, v in model.items()}
            optim = {"param_groups": optim["param_groups"],
                     "state": {n: {k: (lay.cut(n, v) if torch.is_tensor(v)
                                       and v.dim() else v)
                                   for k, v in entry.items()}
                               for n, entry in optim["state"].items()}}
        set_state_dict(state.model, state.optimizer,
                       model_state_dict=model, optim_state_dict=optim,
                       options=StateDictOptions(full_state_dict=True))

    # -- one tensor at a time (TrainState.leaves) ---------------------------
    def leaf_params(self, state):
        return [(n, self.layout.full_shape(n, p.shape), p.dtype)
                for n, p in state.model.named_parameters()
                if p.requires_grad]

    def entry_dtype(self, state, name, key):
        p = dict(state.model.named_parameters())[name]
        value = state.optimizer.state.get(p, {}).get(key)
        return value.dtype if torch.is_tensor(value) else None

    @torch.no_grad()
    def gather_leaf(self, state, name, key):
        """The whole tensor on every rank: FSDP2's shard made whole
        (``full_tensor``, an all-gather over the plan's mesh), then over
        tp and ep."""
        from torch.distributed.tensor import DTensor
        p = dict(state.model.named_parameters())[name]
        t = p if key is None else state.optimizer.state[p][key]
        t = t.full_tensor() if isinstance(t, DTensor) else t
        if self.layout.sharded and t.dim():
            t = self.layout.gather(name, t)
        return t.detach()

    @torch.no_grad()
    def load_leaf(self, state, name, key, shaped, read):
        """This rank's FSDP2 shard of the leaf: with no tp or ep, only
        its rows are read."""
        from torch.distributed.tensor import DTensor
        from ..models.params import _local_part
        p = dict(state.model.named_parameters())[name]
        if not shaped:
            state.optimizer.state[p][key] = _entry_value(
                read(), p.to_local(), state.optimizer)
            return
        rows = None if self.layout.sharded else _dtensor_rows(p)
        if rows is not None:
            local = read(rows)
        else:
            value = read()
            if self.layout.sharded:
                value = self.layout.cut(name, value)
            local = _local_part(value, p)
        if key is None:
            p.to_local().copy_(local)
        else:
            state.optimizer.state[p][key] = DTensor.from_local(
                local.to(p.device, copy=True).contiguous(), p.device_mesh,
                p.placements, run_check=False, shape=p.shape,
                stride=p.stride())


class _PipelinePlan:
    """A pipeline over ``pp`` (with dp and fsdp): the model is this
    rank's ``LlamaStage``; ``schedule`` "gpipe" runs the loss function
    (``models.llama_pipeline.pipeline_loss``) under autograd and "1f1b"
    the fused ``pipeline_loss_and_grads_1f1b`` (``virtual_stages`` > 1:
    interleaved), as the JAX example's ``loss_fn`` and ``f1_step``.

    Each stage's gradients are averaged over its dp x fsdp ranks (the
    fused schedule averages them itself, as JAX's ``_collect_1f1b``);
    with ``pp_fsdp`` the stage's matrices are its fsdp chunks, gathered
    once a step, their f32 gradients reduce-scattered.  The loss is the
    last stage's on every rank, the gradient norm the global one (every
    leaf once: a chunk's squares summed over fsdp, the stages' over pp),
    and a checkpoint is the one-device state dict on the mesh's lowest
    rank (rank 0 of a mesh over the whole group; every rank of the mesh
    calls ``TrainState.state_dict()``; a restore cuts it onto the
    stages)."""

    fused = False

    def __init__(self, mesh, schedule: str, microbatches: int,
                 virtual_stages: int, pp_fsdp: bool):
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"pipeline_schedule must be 'gpipe' or '1f1b', "
                             f"got {schedule!r}")
        if virtual_stages > 1 and schedule != "1f1b":
            raise ValueError("virtual_stages > 1 runs the interleaved 1F1B "
                             "schedule: pass pipeline_schedule='1f1b'")
        sizes = _axis_sizes(mesh)
        self.mesh = self.full_mesh = mesh
        self.device = _mesh_device(mesh)
        self.world = sizes["dp"] * sizes["fsdp"]        # batch ranks
        self.grads = _AxesGroup(mesh, ("dp", "fsdp"))
        self.dp = _AxesGroup(mesh, ("dp",))
        self.pp = _AxesGroup(mesh, ("pp",))
        self.fsdp_group = mesh.get_group("fsdp") if sizes["fsdp"] > 1 \
            else None
        self.tp, self.ep = TensorParallel(), ExpertParallel()
        self.schedule, self.microbatches = schedule, microbatches
        self.virtual_stages, self.pp_fsdp = virtual_stages, pp_fsdp
        self.fused = schedule == "1f1b"
        self.stage = None

    def place(self, model):
        pp = _axis_sizes(self.mesh)["pp"]
        if not hasattr(model, "chunks") or model.n_stages != pp or \
                model.virtual_stages != self.virtual_stages or \
                model.fsdp_shard != self.pp_fsdp:
            raise ValueError(
                f"a pipeline over pp={pp} trains this rank's stage: "
                f"LlamaStage(config, mesh=, virtual_stages="
                f"{self.virtual_stages}, fsdp_shard={self.pp_fsdp})")
        self.stage = model
        return model

    def optimizer(self, model, factory):
        return factory([p for p in model.parameters() if p.requires_grad])

    def loss_and_grads(self, model, batch):
        """The 1F1B step's (loss, parameters with their gradients)."""
        from ..models.llama_pipeline import pipeline_loss_and_grads_1f1b
        loss, grads = pipeline_loss_and_grads_1f1b(
            model, batch, self.mesh, self.microbatches,
            virtual_stages=self.virtual_stages, fsdp_shard=self.pp_fsdp)
        params = []
        for name, p in model.named_parameters():
            p.grad = grads[name].to(p.dtype)
            params.append(p)
        return loss, params

    def reduce(self, params) -> None:
        """GPipe: each rank's gradients (its rows' mean) -> the mean over
        the batch ranks; an fsdp chunk's gradient left the all-gather's
        backward as the fsdp sum, so it is summed over dp only."""
        chunks = set(id(p) for n, p in self.stage.named_parameters()
                     if n in self.stage.fsdp_dims)
        whole = [p.grad for p in params if id(p) not in chunks]
        _all_reduce_mean(whole, self.world, self.grads)
        _all_reduce_mean([p.grad for p in params if id(p) in chunks],
                         self.world, self.dp)

    def grad_norm(self, params) -> torch.Tensor:
        dims = self.stage.fsdp_dims
        names = {id(p): n for n, p in self.stage.named_parameters()}
        split = [p.grad for p in params if names[id(p)] in dims]
        whole = [p.grad for p in params if names[id(p)] not in dims]
        ssq = torch.zeros((), dtype=torch.float32, device=self.device)
        if split:
            ssq = optax_global_norm(split).square()
        if self.fsdp_group is not None:
            dist.all_reduce(ssq, group=self.fsdp_group)
        if whole:
            ssq = ssq + optax_global_norm(whole).square()
        return self.pp.all_reduce_(ssq).sqrt()

    def after_step(self, params) -> None:
        pass

    def state_dict(self, state) -> dict:
        """The one-device model and optimizer state on the mesh's lowest
        rank, on the host (empty elsewhere; every rank of the mesh takes
        part): the stages' tensors joined over pp and fsdp one at a
        time, the optimizer's entries re-keyed by the one-device
        parameter index."""
        from ..models.llama import LlamaModel
        from ..models.params import gather_stage_state_dict
        stage, opt = self.stage, state.optimizer
        dst = int(self.mesh.mesh.min())
        model = gather_stage_state_dict(stage, dst=dst)
        names = [n for n, _ in LlamaModel(stage.config,
                                          device="meta").named_parameters()]
        own = {id(p): n for n, p in stage.named_parameters()}
        first = next(iter(opt.state.values()), {})
        # Moments are parameter-shaped and joined like the parameters;
        # a scalar entry (AdamW's step) is the same for every parameter.
        moments = [k for k, v in first.items() if torch.is_tensor(v)
                   and v.dim()]
        joined = {k: gather_stage_state_dict(stage, {
            own[id(p)]: entry[k] for p, entry in opt.state.items()},
            dst=dst) for k in moments}
        if dist.get_rank() != dst:
            return {}
        optim = {"state": {i: {k: (joined[k][n] if k in joined else
                                   (v.clone() if torch.is_tensor(v) else v))
                               for k, v in first.items()}
                           for i, n in enumerate(names)} if first else {},
                 "param_groups": [{**{k: v for k, v in g.items()
                                      if k != "params"},
                                   "params": list(range(len(names)))}
                                  for g in opt.param_groups]}
        return {"model": model, "optimizer": optim}

    @torch.no_grad()
    def load_state_dict(self, state, payload: dict) -> None:
        from ..models.llama import LlamaModel
        stage = self.stage
        stage.load_full_state_dict(payload["model"])
        index = {n: i for i, (n, _) in enumerate(LlamaModel(
            stage.config, device="meta").named_parameters())}
        optim = payload["optimizer"]
        entries = {}
        for j, (name, p) in enumerate(stage.named_parameters()):
            entry = optim["state"].get(index[name], {})
            entries[j] = {k: (stage.fsdp_part(name, v).clone()
                              if torch.is_tensor(v) and v.dim() else v)
                          for k, v in entry.items()}
        groups = [{**{k: v for k, v in g.items() if k != "params"},
                   "params": list(range(len(entries)))}
                  for g in optim["param_groups"]]
        state.optimizer.load_state_dict({"state": entries,
                                         "param_groups": groups})

    # -- one tensor at a time (TrainState.leaves) ---------------------------
    @staticmethod
    def _kind(name) -> bool:
        # The two storage kinds of a stage (models.params's join).
        return name.endswith((".scale", ".router.weight"))

    def leaf_params(self, state):
        from ..models.llama import LlamaModel
        if getattr(self, "_shapes", None) is None:
            self._shapes = [(n, tuple(p.shape)) for n, p in LlamaModel(
                self.stage.config, device="meta").named_parameters()]
        kinds = {self._kind(n): p.dtype
                 for n, p in self.stage.named_parameters()}
        return [(n, shape, kinds[self._kind(n)]) for n, shape in self._shapes]

    def _own_entry(self, state, key, name):
        """This stage's optimizer entry ``key`` of parameter ``name`` when
        the stage holds it, else of one of its parameters of the same
        storage kind (every stage holds both kinds)."""
        own = dict(self.stage.named_parameters())
        p = own[name] if name in own else next(
            q for n, q in own.items() if self._kind(n) == self._kind(name))
        value = state.optimizer.state.get(p, {}).get(key)
        return value if torch.is_tensor(value) else None

    def entry_dtype(self, state, name, key):
        value = self._own_entry(state, key, name)
        return value.dtype if value is not None else None

    @torch.no_grad()
    def gather_leaf(self, state, name, key):
        """The whole tensor on every rank: the owning stage's fsdp chunks
        gathered, then broadcast over pp; a scalar entry (AdamW's step)
        is the same for every parameter and is this stage's own."""
        from ..models.params import gather_stage_tensor
        from .pipeline import _Place
        own = dict(self.stage.named_parameters())
        shape, dtype = next((s, d) for n, s, d in self.leaf_params(state)
                            if n == name)
        tensor = own.get(name)
        if key is not None:
            value = self._own_entry(state, key, name)
            if not value.dim():
                return value.detach().clone()
            tensor, dtype = (value if name in own else None), value.dtype
        if getattr(self, "_place", None) is None:
            self._place = _Place(self.mesh)
        return gather_stage_tensor(self.stage, name, tensor, shape, dtype,
                                   self._place)

    @torch.no_grad()
    def load_leaf(self, state, name, key, shaped, read):
        """Only the stage that holds ``name`` reads it (its fsdp part)."""
        own = dict(self.stage.named_parameters())
        if name not in own:
            return
        p = own[name]
        value = read()
        if value.dim():
            value = self.stage.fsdp_part(name, value)
        if key is None:
            p.copy_(value)
        else:
            state.optimizer.state[p][key] = _entry_value(
                value.contiguous(), p, state.optimizer)


def _init_state(plan, model, optimizer, init_weights=None) -> TrainState:
    """A TrainState at step 0: under a plan the model is placed first (a
    model on the meta device is then allocated on the mesh's device) and
    filled by ``init_weights`` before the optimizer is made."""
    if plan is not None:
        for par in (plan.tp, plan.ep):
            held = getattr(getattr(model, par.AXIS, None), "size", 1)
            if held != par.size:
                raise ValueError(
                    f"the model holds {par.AXIS}={held} shards, the mesh "
                    f"has {par.AXIS}={par.size}: build it with "
                    f"LlamaModel(mesh=)")
        model = plan.place(model)
        if any(p.is_meta for p in model.parameters()):
            model.to_empty(device=plan.device)
    if init_weights is not None:
        init_weights(model)
    make = optimizer if plan is None else \
        (lambda params: plan.optimizer(model, optimizer))
    return TrainState(step=0, model=model,
                      optimizer=make(model.parameters()), plan=plan)


def _mesh_plan(mesh, param_specs, shard_update, hierarchical_allreduce,
               ici_axis, pipeline=None):
    sizes = refuse_pp_mix(mesh, "build_train_step")
    if sizes["pp"] > 1:
        return _PipelinePlan(mesh, **pipeline)
    for axis, what in (("tp", "tensor"), ("ep", "expert")):
        if sizes[axis] > 1 and param_specs is None:
            raise ValueError(f"{what} parallelism ({axis} > 1) needs "
                             f"param_specs (models.llama.llama_param_specs):"
                             f" they name the dims the model's shards cut")
    zero = shard_update and sizes["dp"] > 1
    if param_specs is not None and sizes["fsdp"] > 1 and any(
            "fsdp" in spec for spec in param_specs.values()):
        return _ShardedPlan(mesh, zero, param_specs)
    hier = hierarchical_allreduce and sizes.get(ici_axis, 1) > 1
    return _ReplicatedPlan(mesh, zero, hier, ici_axis, param_specs)


def build_train_step(loss_fn: Callable, optimizer, mesh=None,
                     param_specs=None, remat: bool = False,
                     accum_steps: int = 1, shard_update: bool = False,
                     hierarchical_allreduce: bool = False,
                     ici_axis: str = "fsdp", goodput=None,
                     telemetry_registry=None,
                     sync_every: Optional[int] = None,
                     pipeline_schedule: str = "gpipe",
                     microbatches: int = 4, virtual_stages: int = 1,
                     pp_fsdp: bool = False):
    """Build (init_fn, step_fn), on one device or over ``mesh``.

    - loss_fn(model, batch) -> scalar loss; batch is a tensor (or a tuple
      of tensors) whose dim 0 is the batch: under a mesh, this rank's
      rows of the global batch (``parallel.mesh.batch_rows``; the batch
      is sharded over (dp, fsdp)).
    - optimizer: a factory over the parameters (:func:`adamw`).
    - mesh: a ``parallel.mesh.create_mesh`` DeviceMesh; the metrics are
      then those of the global batch (the loss mean and the gradients
      are averaged over every batch rank).  Under sp > 1 the batch holds
      this rank's token columns too (``parallel.mesh.seq_cols``), the
      loss_fn returns the rank's share of the global mean
      (``next_token_loss(..., sp=model.sp)``), and loss and gradients
      are summed over sp.
    - param_specs: ``models.llama.llama_param_specs``; with fsdp > 1 the
      parameters are sharded over it (:class:`_ShardedPlan`), else
      replicated (:class:`_ReplicatedPlan`).  With tp or ep > 1 (needs
      param_specs) the model must be built on the same mesh
      (``LlamaModel(mesh=)``: its tp and ep shards).
    - shard_update / hierarchical_allreduce / ici_axis: the ZeRO update
      and the hierarchical gradient schedule (see the plans); a 1-sized
      dp is the plain update and a 1-sized ``ici_axis`` the flat
      schedule, as on one device (no mesh).
    - remat: run the loss under activation checkpointing.
    - accum_steps: >1 runs the batch as that many microbatches under one
      update, with the strided split of the JAX step (row r goes to
      microbatch r % accum_steps); loss and gradients are the mean over
      microbatches, accumulated in f32 (in the parameters' type under
      FSDP2).  Under a mesh the global batch must divide by
      accum_steps x dp*fsdp, and gradients are reduced once, after the
      last microbatch.
    - goodput / telemetry_registry: wrap step_fn in
      ``telemetry.goodput.instrument_step`` (sync every ``sync_every``).
    - pipeline_schedule / microbatches / virtual_stages / pp_fsdp (the
      JAX example's --pipeline-schedule, --microbatches,
      --virtual-stages, --pp-fsdp): with pp > 1 in ``mesh`` the model is
      this rank's ``models.llama_pipeline.LlamaStage`` (built with the
      same ``virtual_stages`` and ``fsdp_shard=pp_fsdp``), the batch this
      batch shard's rows (the same on every pp rank).  "gpipe" runs
      ``loss_fn`` (None: ``pipeline_loss`` over ``microbatches``) under
      autograd; "1f1b" the fused ``pipeline_loss_and_grads_1f1b`` (its
      own next-token loss: ``loss_fn`` must be None), interleaved when
      ``virtual_stages`` > 1.  pp with tp, sp or ep, accum_steps,
      shard_update, hierarchical_allreduce or remat raises ValueError,
      as does pp_fsdp without pp.

    init_fn(model, init_weights=None) -> TrainState: under a mesh the
    model is placed first (sharded by FSDP2; a model on the meta device
    is then allocated on the mesh's device) and ``init_weights(model)``
    fills it before the optimizer is made (``models.params.init_params_``
    fills each rank's shard).  step_fn(state, batch) -> (state, metrics)
    with ``loss`` and ``grad_norm`` (of the gradients before the update)
    as f32 device scalars, read by nobody unless asked; it runs the
    collectives of the state's plan, so it also steps a state that
    :func:`reshard_train_state` moved onto this mesh."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    pp = 1 if mesh is None else refuse_pp_mix(mesh, "build_train_step")["pp"]
    if pp_fsdp and pp <= 1:
        raise ValueError(
            "pp_fsdp shards PIPELINE stage weights; without pp > 1 there are "
            "no stages (fsdp with param_specs already shards the "
            "non-pipeline path)")
    if pp > 1:
        if accum_steps > 1:
            raise ValueError(
                "accum_steps applies to the non-pipeline path; pipeline "
                "schedules already stream `microbatches` per optimizer "
                "update (raise that instead)")
        for flag, on in (("shard_update", shard_update),
                         ("hierarchical_allreduce", hierarchical_allreduce),
                         ("remat", remat)):
            if on:
                raise ValueError(
                    f"{flag} does not apply under pp: the pipeline plan "
                    f"averages each stage over dp x fsdp (pp_fsdp shards "
                    f"its state) and the 1F1B B slot recomputes each stage")
        if pipeline_schedule == "1f1b" and loss_fn is not None:
            raise ValueError("the 1F1B schedule fuses its own next-token "
                             "loss: pass loss_fn=None")
        if loss_fn is None:
            from ..models.llama_pipeline import pipeline_loss

            def loss_fn(model, batch):
                return pipeline_loss(model, batch, mesh, microbatches,
                                     fsdp_shard=pp_fsdp)
    plan = None
    batch_shards = 1
    if mesh is not None:
        plan = _mesh_plan(mesh, param_specs, shard_update,
                          hierarchical_allreduce, ici_axis,
                          pipeline={"schedule": pipeline_schedule,
                                    "microbatches": microbatches,
                                    "virtual_stages": virtual_stages,
                                    "pp_fsdp": pp_fsdp})
        batch_shards = plan.world
    fsdp = isinstance(plan, _ShardedPlan)
    run_loss = loss_fn
    if remat:
        def run_loss(model, batch):
            return checkpoint(loss_fn, model, batch, use_reentrant=False)

    def init_fn(model, init_weights: Optional[Callable] = None):
        return _init_state(plan, model, optimizer, init_weights)

    def split(batch, i):
        if isinstance(batch, (tuple, list)):
            return type(batch)(split(x, i) for x in batch)
        if batch.shape[0] % accum_steps:
            if plan is None:
                raise ValueError(f"batch dim {batch.shape[0]} not divisible"
                                 f" by accum_steps {accum_steps}")
            raise ValueError(
                f"batch dim {batch.shape[0] * batch_shards} not divisible by"
                f" accum_steps {accum_steps} x batch shards {batch_shards}"
                f" (dp*fsdp)")
        return batch[i::accum_steps]

    def grads_of(state, batch):
        params = [p for p in state.model.parameters() if p.requires_grad]
        if accum_steps == 1:
            loss = run_loss(state.model, batch)
            loss.backward()
            return loss.detach().float(), params
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=params[0].device)
        if fsdp:
            # FSDP2 accumulates the unsharded gradients itself and
            # reduces once, in the last microbatch's backward.
            for i in range(accum_steps):
                state.model.set_requires_gradient_sync(
                    i == accum_steps - 1)
                loss = run_loss(state.model, split(batch, i))
                loss.backward()
                loss_sum += loss.detach().float()
            for p in params:
                p.grad /= accum_steps
            return loss_sum / accum_steps, params
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        for i in range(accum_steps):
            loss = run_loss(state.model, split(batch, i))
            loss.backward()
            loss_sum += loss.detach().float()
            for a, p in zip(acc, params):
                a += p.grad.float()
                p.grad = None
        for a, p in zip(acc, params):
            p.grad = (a / accum_steps).to(p.dtype)
        return loss_sum / accum_steps, params

    def step_fn(state: TrainState, batch):
        plan = state.plan
        state.optimizer.zero_grad(set_to_none=True)
        if getattr(plan, "fused", False):
            # 1F1B: the schedule's loss and gradients are global already.
            loss, params = plan.loss_and_grads(state.model, batch)
            grad_norm = plan.grad_norm(params)
            state.optimizer.step()
            state.step += 1
            return state, {"loss": loss, "grad_norm": grad_norm}
        loss, params = grads_of(state, batch)
        if plan is None:
            grad_norm = optax_global_norm([p.grad for p in params])
        else:
            plan.reduce(params)
            # The tp and ep ranks of a batch shard computed the same
            # loss; the sp ranks' shares sum to it.
            plan.grads.all_reduce_(loss)
            loss /= plan.world
            grad_norm = plan.grad_norm(params)
        state.optimizer.step()
        if plan is not None:
            plan.after_step(params)
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm}

    if goodput is not None or telemetry_registry is not None:
        from ..telemetry.goodput import instrument_step
        step_fn = instrument_step(step_fn, goodput=goodput,
                                  registry=telemetry_registry,
                                  sync_every=sync_every)
    return init_fn, step_fn


# ---------------------------------------------------------------------------
# Live re-shard onto another mesh
# ---------------------------------------------------------------------------

def _model_class(model):
    """The model's own class (FSDP2 wraps it in a subclass)."""
    from torch.distributed.fsdp import FSDPModule
    return next(c for c in type(model).__mro__
                if issubclass(c, torch.nn.Module)
                and not issubclass(c, FSDPModule))


def _rekey_optimizer(optim: dict, names, by_name: bool) -> dict:
    """An optimizer state dict keyed by parameter index (one optimizer
    over ``model.parameters()``) or by parameter name (the full form of
    ``torch.distributed.checkpoint``'s ``get_state_dict``), in the form
    ``by_name`` asks for."""
    index = {n: i for i, n in enumerate(names)}

    def key(k):
        if by_name:
            return names[k] if isinstance(k, int) else k
        return index[k] if isinstance(k, str) else k

    return {"state": {key(k): v for k, v in optim["state"].items()},
            "param_groups": [{**g, "params": [key(k) for k in g["params"]]}
                             for g in optim["param_groups"]]}


def _map_tensors(tree, fn):
    """``tree`` (nested dicts, lists and tuples) with ``fn(leaf)`` in
    place of each tensor and of each ``("tensor", shape, dtype)``
    placeholder of one, in one traversal order."""
    if torch.is_tensor(tree) or (isinstance(tree, tuple) and len(tree) == 3
                                 and tree[0] == "tensor"):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def _comm_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _llama_build(model):
    """What rebuilds a Llama model or pipeline stage on another mesh:
    (its class, config and storage type), or None for another model."""
    from ..models.llama import LlamaModel
    from ..models.llama_pipeline import LlamaStage
    cls = _model_class(model)
    if not issubclass(cls, (LlamaModel, LlamaStage)):
        return None
    held = model.tok_embeddings if hasattr(model, "tok_embeddings") else \
        model.output if hasattr(model, "output") else \
        next(iter(model.layers.children())).attention.wq
    return cls, model.config, held.weight.dtype


def reshard_train_state(state: Optional[TrainState], mesh,
                        param_specs=None, shard_update: bool = False,
                        model=None, pipeline_schedule: str = "gpipe",
                        microbatches: int = 4, virtual_stages: int = 1,
                        pp_fsdp: bool = False) -> Optional[TrainState]:
    """Move a live TrainState onto another mesh (the gang after an
    elastic resize) at the SAME step: counterpart of the JAX
    ``reshard_train_state``.  Pure data movement, no arithmetic:

    - the old plan gathers the state into the one-device format
      (``TrainState.state_dict()``, a collective over the old mesh,
      entered by its ranks only);
    - the lowest rank that holds it broadcasts it, with what builds the
      model and the optimizer (the model's config and storage type, the
      optimizer's class and hyperparameters), over the default group,
      which spans both meshes;
    - every rank of the new mesh builds the model on the meta device:
      with pp > 1 in the new mesh its ``LlamaStage``
      (``virtual_stages``, ``fsdp_shard=pp_fsdp``), else a
      ``LlamaModel`` (its tp and ep shards), whichever the old state
      held; or it takes ``model``, a fresh model of its own for the new
      mesh, which a model that is not a Llama needs.  It places the
      model through the new mesh's plan (``param_specs``,
      ``shard_update`` and the pipeline arguments as
      ``build_train_step`` takes them; the flat gradient schedule) and
      loads the state through that plan's ``load_state_dict``, the
      optimizer's entries keyed by ``LlamaModel``'s parameter order on
      both sides.

    Every rank of the default group calls it: ``state`` is the live
    state on the ranks of the old mesh and None elsewhere (ranks outside
    the old mesh hold nothing until the grow), ``mesh`` the new mesh
    (``parallel.mesh.create_mesh(..., ranks=)``), built by every rank.
    Returns the moved state on the ranks of the new mesh, None on the
    others.  ``build_train_step``'s step function on the new mesh (with
    the same pipeline arguments) steps it: it runs the state's plan.  A
    new mesh that is not the whole group cannot take the FSDP2 plan with
    ``shard_update`` and dp > 1: that plan forms a group of its own,
    which every rank must join."""
    rank, world = dist.get_rank(), dist.get_world_size()
    payload = state.state_dict() if state is not None else None
    holds = bool(payload) and bool(payload.get("model"))
    comm = _comm_device()
    first = torch.tensor([rank if holds else world], device=comm)
    dist.all_reduce(first, op=dist.ReduceOp.MIN)
    src = int(first.item())
    if src == world:
        raise RuntimeError("reshard_train_state: no rank holds the state "
                           "(pass the live TrainState on the old mesh)")
    meta = [None]
    tensors = []

    def keep(t):
        tensors.append(t)
        return ("tensor", tuple(t.shape), t.dtype)

    if rank == src:
        meta = [{"model": _llama_build(state.model),
                 "optimizer": (type(state.optimizer),
                               state.optimizer.defaults),
                 "tree": _map_tensors(payload, keep)}]
    dist.broadcast_object_list(meta, src=src)
    meta = meta[0]
    if rank != src:
        def fresh(leaf):
            tensors.append(torch.empty(leaf[1], dtype=leaf[2], device=comm))
            return tensors[-1]

        payload = _map_tensors(meta["tree"], fresh)
    for t in tensors:
        dist.broadcast(t.to(comm) if rank == src else t, src=src)
    new = state_on_mesh(mesh, meta["model"], meta["optimizer"],
                        param_specs, shard_update, model, pipeline_schedule,
                        microbatches, virtual_stages, pp_fsdp)
    if new is None:
        return None
    if isinstance(new.plan, _PipelinePlan):
        # The stage's optimizer entries are keyed by the one-device index.
        from ..models.llama import LlamaModel
        names = [n for n, _ in LlamaModel(new.model.config,
                                          device="meta").named_parameters()]
    else:
        names = [n for n, p in new.model.named_parameters()
                 if p.requires_grad]
    payload["optimizer"] = _rekey_optimizer(
        payload["optimizer"], names, isinstance(new.plan, _ShardedPlan))
    new.load_state_dict(payload)
    return new


def state_on_mesh(mesh, build, optimizer, param_specs=None,
                  shard_update: bool = False, model=None,
                  pipeline_schedule: str = "gpipe", microbatches: int = 4,
                  virtual_stages: int = 1, pp_fsdp: bool = False
                  ) -> Optional[TrainState]:
    """A step-0 TrainState on ``mesh`` for a state to be loaded into, as
    :func:`reshard_train_state` and ``ckpt``'s ``restore_resharded`` make
    it (None off the mesh): the model built on the meta device from
    ``build`` (what ``_llama_build`` gives: with pp > 1 in the mesh a
    ``LlamaStage``, else a ``LlamaModel``) or ``model``, placed and
    allocated by the mesh's plan (the arguments as ``build_train_step``
    takes them), left unfilled, with ``optimizer`` ((class,
    hyperparameters)) over it holding no entries yet."""
    if mesh.get_coordinate() is None:
        return None
    sizes = _axis_sizes(mesh)
    if mesh.mesh.numel() != dist.get_world_size() and shard_update and \
            sizes["dp"] > 1 and param_specs is not None and \
            sizes["fsdp"] > 1:
        raise NotImplementedError(
            "a state on a part of the group with FSDP2 and shard_update "
            "over dp > 1 (that plan forms a group of its own)")
    from ..models.llama import LlamaModel
    from ..models.llama_pipeline import LlamaStage
    if model is None:
        if build is None:
            raise ValueError("a model that is not a LlamaModel or "
                             "LlamaStage needs model= on the new mesh")
        cls, config, store = build
        if sizes["pp"] > 1:
            model = LlamaStage(config, mesh=mesh,
                               virtual_stages=virtual_stages,
                               fsdp_shard=pp_fsdp, device="meta",
                               store_dtype=store)
        else:
            cls = LlamaModel if issubclass(cls, LlamaStage) else cls
            model = cls(config, device="meta", store_dtype=store, mesh=mesh)
    optim_cls, defaults = optimizer
    accepted = inspect.signature(optim_cls.__init__).parameters
    kwargs = {k: v for k, v in defaults.items() if k in accepted}
    plan = _mesh_plan(mesh, param_specs, shard_update, False, "fsdp",
                      pipeline={"schedule": pipeline_schedule,
                                "microbatches": microbatches,
                                "virtual_stages": virtual_stages,
                                "pp_fsdp": pp_fsdp})
    return _init_state(plan, model, lambda params: optim_cls(params,
                                                             **kwargs))


# ---------------------------------------------------------------------------
# Preemption-aware training loop
# ---------------------------------------------------------------------------

# The kubelet exports the pod's notice-file path here; the file's
# existence IS the notice.
PREEMPTION_NOTICE_ENV = "K_PREEMPTION_NOTICE_FILE"

# Retryable under RestartPolicy=ExitCode (128-255): 128 + SIGTERM.
PREEMPTION_EXIT_CODE = 143

RESIZE_NOTICE_ENV = "K_RESIZE_NOTICE_FILE"


def preemption_notice_path() -> Optional[str]:
    """Where this process's preemption notice appears (None when no
    channel is configured)."""
    path = os.environ.get(PREEMPTION_NOTICE_ENV)
    if path:
        return path
    sandbox = os.environ.get("K_SANDBOX_DIR")
    if sandbox:
        return os.path.join(sandbox, "preemption.notice")
    return None


def preemption_requested(path: Optional[str] = None) -> bool:
    path = path or preemption_notice_path()
    return bool(path) and os.path.exists(path)


def resize_notice_path() -> Optional[str]:
    """Where this process's elastic-resize notice appears (None when no
    channel is configured)."""
    path = os.environ.get(RESIZE_NOTICE_ENV)
    if path:
        return path
    sandbox = os.environ.get("K_SANDBOX_DIR")
    if sandbox:
        return os.path.join(sandbox, "resize.notice")
    return None


def resize_requested(path: Optional[str] = None) -> Optional[int]:
    """The target worker count of a delivered resize notice, or None
    when there is no (parsable) notice."""
    path = path or resize_notice_path()
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None


def _first_step_span(t0: float, metrics, step: int) -> None:
    """Causal-trace terminal milestone: the first step of this
    incarnation, parented to the job context in the worker's env.  The
    step is asynchronous on the card (``step_fn`` returns once it is
    queued), so the span closes when the step's metrics have reached the
    host, not at the enqueue."""
    from ..telemetry.goodput import _block
    from ..telemetry.trace import default_tracer, env_context
    ctx = env_context()
    if ctx is None:
        return
    _block(metrics)
    default_tracer().emit("first_step", ts=t0, dur=time.time() - t0,
                          ctx=ctx, step=step)


class _NoticePoller:
    """At most one stat of the notice file per step, none once seen.

    In a process group the save on a notice is collective, so every rank
    must stop at the same step: :meth:`agreed` ORs the ranks' notices
    with one all-reduce on a CPU (gloo) group, which does not wait for
    the card."""

    def __init__(self, path: Optional[str]):
        self._path = path
        self._seen = False
        self.stats = 0
        self._agree = dist.is_initialized() and dist.get_world_size() > 1
        self._group = None                  # the default group: gloo
        if self._agree and dist.get_backend() != "gloo":
            self._group = dist.new_group(backend="gloo")

    def poll(self) -> bool:
        if self._seen:
            return True
        if not self._path:
            return False
        self.stats += 1
        self._seen = os.path.exists(self._path)
        return self._seen

    def agreed(self) -> bool:
        seen = self.poll()
        if not self._agree:
            return seen
        flag = torch.tensor([int(seen)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._group)
        self._seen = bool(flag.item())
        return self._seen


def run_train_loop(state, step_fn, batches, checkpoint_manager=None,
                   max_steps: Optional[int] = None, start_step: int = 0,
                   preemption_file: Optional[str] = None,
                   exit_on_preemption: bool = True,
                   on_metrics: Optional[Callable] = None,
                   prefetch: int = 2):
    """Drive ``step_fn`` over ``batches`` with checkpointing and a
    checkpoint-then-exit on preemption.

    Each step: run it, let the checkpoint manager save on its schedule,
    then poll the preemption notice once (re-polling right after an
    async write completes); one poll before the first step too.  In a
    process group the ranks agree on each poll (any rank's notice stops
    all of them at the same step).  On a notice the loop checkpoints at
    once (collectively: every rank takes part, rank 0 writes), drains
    the writer and raises SystemExit(143), so the restarted job resumes
    from this step
    (``exit_on_preemption=False`` returns instead).  ``prefetch`` batches
    are pulled ahead on a thread (utils.data.DevicePrefetcher; 0
    disables).  On every exit path the step function's open goodput
    window is flushed (``step_fn.sync()``) and the writer drained.
    Returns ``(state, step)``."""
    step = start_step
    poller = _NoticePoller(preemption_file or preemption_notice_path())

    def drain_checkpoints():
        if checkpoint_manager is not None:
            checkpoint_manager.drain()

    def handle_preemption(saved_this_step: bool):
        # A checkpoint failure must not abort the exit protocol: any exit
        # other than 143 turns a retryable preemption into a failure.
        ckpt_error = None
        if checkpoint_manager is not None and not saved_this_step:
            try:
                checkpoint_manager.save(state, step)
            except Exception:
                # Likely a stored writer error re-raised at the save
                # point; raising cleared it, so retry once.
                try:
                    checkpoint_manager.save(state, step)
                except Exception as exc:
                    ckpt_error = exc
        if ckpt_error is None:
            try:
                drain_checkpoints()
            except Exception as exc:
                ckpt_error = exc
        # Black-box the exit: record the preemption on the flight ring,
        # export it as a sidecar (so the control plane's bundle gets a
        # train lane), and dump this process's own bundle; SystemExit
        # never reaches sys.excepthook, so this is the only chance.
        from ..telemetry import flight
        flight.record("train", "preemption", step=step,
                      checkpointed=(checkpoint_manager is not None
                                    and ckpt_error is None),
                      checkpoint_error=(repr(ckpt_error)
                                        if ckpt_error is not None else None),
                      exit_code=PREEMPTION_EXIT_CODE)
        flight.export_sidecar()
        flight.dump_bundle("train-preemption")
        if exit_on_preemption:
            raise SystemExit(PREEMPTION_EXIT_CODE)

    source = batches
    prefetcher = None
    if prefetch and prefetch > 0:
        from ..utils.data import DevicePrefetcher
        source = prefetcher = DevicePrefetcher(batches, depth=prefetch)

    save_completed = None
    if checkpoint_manager is not None:
        save_completed = checkpoint_manager.completed_since_last_poll
    try:
        if poller.agreed():
            handle_preemption(saved_this_step=False)
            return state, step
        for batch in source:
            if max_steps is not None and step >= max_steps:
                break
            first = step == start_step
            if first:
                first_t0 = time.time()
            state, metrics = step_fn(state, batch)
            step += 1
            if first:
                _first_step_span(first_t0, metrics, step)
            if on_metrics is not None:
                on_metrics(step, metrics)
            saved = False
            if checkpoint_manager is not None:
                saved = checkpoint_manager.maybe_save(state, step)
                if save_completed():
                    poller.poll()
            if poller.agreed():
                handle_preemption(saved_this_step=saved)
                return state, step
    finally:
        if prefetcher is not None:
            prefetcher.close()
        # Normal exit is as durable as the preemption path; an exception
        # already unwinding takes precedence over one raised here.
        unwinding = sys.exc_info()[0] is not None
        sync_error = None
        sync = getattr(step_fn, "sync", None)
        if sync is not None:
            try:
                sync()
            except BaseException as exc:
                if not unwinding:
                    sync_error = exc
        try:
            drain_checkpoints()
        except BaseException:
            if not unwinding and sync_error is None:
                raise
        if sync_error is not None:
            raise sync_error
    return state, step
