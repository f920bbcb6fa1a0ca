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

Either plan composes with tensor parallelism over ``tp``: the model is
built tp-sharded (``LlamaModel(mesh=)``), the plans reduce gradients
over the batch ranks (dp x fsdp) that share a tp index, the gradient
norm sums a tp-sharded leaf's squares over the tp group and a replicated
one once, and a checkpoint joins the tp shards into the one-device
format (and cuts them again on restore).  Meshes with ``sp``, ``ep`` or
``pp`` above 1 wait for ROADMAP.md queue 1 item 3.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from .tensor import TensorParallel, refuse_axes, tp_dim


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


def _batch_ranks(mesh):
    """Per tp index, the ranks that hold the batch shards (dp x fsdp)
    beside it: a [tp, dp*fsdp] list of lists."""
    tp = _axis_sizes(mesh)["tp"]
    return mesh.mesh.reshape(-1, tp).T.tolist()


def _batch_group(mesh):
    """The group of this rank's batch ranks: the default group without
    tp; otherwise one subgroup per tp index (made on every rank)."""
    if _axis_sizes(mesh)["tp"] == 1:
        return None
    group, _ = dist.new_subgroups_by_enumeration(_batch_ranks(mesh))
    return group


def _ssq_split(tensors, sharded) -> torch.Tensor:
    """[sum of squares over the tp-sharded tensors, over the others],
    f32 [2]."""
    parts = [torch.zeros((), dtype=torch.float32,
                         device=tensors[0].device) for _ in range(2)]
    for t, cut in zip(tensors, sharded):
        parts[0 if cut else 1] = parts[0 if cut else 1] + \
            torch.linalg.vector_norm(t, dtype=torch.float32).square()
    return torch.stack(parts)


def _tp_norm(ssq: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The global norm from :func:`_ssq_split`'s pair: the tp-sharded
    squares summed over the tp group, the replicated ones once."""
    cut = ssq[0:1].clone()
    tp.all_reduce_(cut)
    return (cut[0] + ssq[1]).sqrt()


class _TPLayout:
    """The 'tp' dim of each trainable parameter (by name and by index in
    ``model.parameters()``), from the param specs."""

    def __init__(self, model, specs, tp: TensorParallel):
        self.tp = tp
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self.names = [n for n, _ in named]
        self.dims = {n: (tp_dim(specs[n]) if tp.size > 1 else None)
                     for n in self.names}
        self.sharded = [self.dims[n] is not None for n in self.names]

    def gather(self, name_or_index, value):
        """The full tensor of a parameter-shaped tp chunk (collective)."""
        name = name_or_index if isinstance(name_or_index, str) else \
            self.names[name_or_index]
        return self.tp.gather(value, self.dims.get(name))

    def cut(self, name_or_index, value):
        name = name_or_index if isinstance(name_or_index, str) else \
            self.names[name_or_index]
        d = self.dims.get(name)
        return value if d is None else self.tp.chunk(value, d).clone()


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


def _all_reduce_mean(tensors, world: int, group=None) -> None:
    """Replace each tensor by its mean over the ``world`` ranks of
    ``group`` (default: every rank), on flat f32 buckets."""
    for bucket in _buckets([t.numel() for t in tensors]):
        flat = torch.cat([tensors[i].float().reshape(-1) for i in bucket])
        dist.all_reduce(flat, group=group)
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
    all-reduced, as ``graft_spec`` leaves it replicated."""

    def __init__(self, mesh, zero: bool, hier: bool, ici_axis: str,
                 specs=None):
        sizes = _axis_sizes(mesh)
        self.device = _mesh_device(mesh)
        self.world = sizes["dp"] * sizes["fsdp"]       # batch ranks
        self.batch_group = _batch_group(mesh)
        self.tp = TensorParallel.of(mesh)
        self.specs = specs
        self.layout = None
        self.zero = zero
        # The collectives' pair: the group the buckets are scattered
        # over, and the group that then reduces the scattered shard.
        if hier:
            scatter, other = ici_axis, "dp"
        else:
            scatter, other = "dp", "fsdp"
        self.scatter = (mesh.get_group(scatter), sizes[scatter])
        self.other = (mesh.get_group(other), sizes[other])
        self.split = zero or hier
        self.layouts = []          # (indices, _RankMajor) per bucket
        self.whole = []            # indices reduced whole
        self.masters = {}          # index -> this rank's chunk (ZeRO)

    def place(self, model):
        return model

    def optimizer(self, model, factory):
        params = [p for p in model.parameters() if p.requires_grad]
        self.layout = _TPLayout(model, self.specs, self.tp)
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
        every batch rank: in ``p.grad``, or in the masters' ``grad``
        under ZeRO."""
        group, n = self.scatter
        other, n_other = self.other
        if not self.split:
            _all_reduce_mean([p.grad for p in params], self.world,
                             self.batch_group)
            return
        for idx, layout in self.layouts:
            flat = layout.pack([params[i].grad for i in idx])
            shard = flat.new_empty(layout.per_rank)
            dist.reduce_scatter_tensor(shard, flat, group=group)
            if n_other > 1:
                dist.all_reduce(shard, group=other)
            shard /= self.world
            if self.zero:
                for i, chunk in zip(idx, layout.chunks(shard)):
                    self.masters[i].grad = chunk.to(params[i].dtype)
                    params[i].grad = None
            else:
                dist.all_gather_into_tensor(flat, shard, group=group)
                layout.unpack(flat, [params[i].grad for i in idx])
        _all_reduce_mean([params[i].grad for i in self.whole], self.world,
                         self.batch_group)

    def grad_norm(self, params) -> torch.Tensor:
        if self.tp.size > 1:
            return self._tp_grad_norm(params)
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

    def _tp_grad_norm(self, params) -> torch.Tensor:
        cut = self.layout.sharded
        if not self.zero:
            return _tp_norm(_ssq_split([p.grad for p in params], cut),
                            self.tp)
        split = _ssq_split([m.grad for m in self.masters.values()],
                           [cut[i] for i in self.masters])
        dist.all_reduce(split, group=self.scatter[0])
        if self.whole:
            split = split + _ssq_split([params[i].grad for i in self.whole],
                                       [cut[i] for i in self.whole])
        return _tp_norm(split, self.tp)

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
        are all-gathered (every rank takes part)."""
        optim = state.optimizer.state_dict()
        # Its per-parameter entries are the optimizer's live dicts: the
        # gathers below replace tensors in copies of them.
        optim["state"] = {i: dict(e) for i, e in optim["state"].items()}
        if self.zero:
            group, n = self.scatter
            for i, master in self.masters.items():
                layout, k = self._chunk_layout(i)
                d = layout.dims[k]
                for key, value in optim["state"].get(i, {}).items():
                    if torch.is_tensor(value) and \
                            value.shape == master.shape:
                        full = value.new_empty(
                            (n * value.shape[0],) + tuple(value.shape[1:]))
                        dist.all_gather_into_tensor(full, value.contiguous(),
                                                    group=group)
                        optim["state"][i][key] = full.movedim(0, d)
        model = state.model.state_dict()
        if self.tp.size > 1:
            lay = self.layout
            model = {k: lay.gather(k, v) for k, v in model.items()}
            for i, entry in optim["state"].items():
                for key, value in entry.items():
                    if torch.is_tensor(value) and value.dim():
                        entry[key] = lay.gather(i, value)
        return {"model": model, "optimizer": optim}

    @torch.no_grad()
    def load_state_dict(self, state, payload: dict) -> None:
        model, optim = payload["model"], payload["optimizer"]
        if self.tp.size > 1:
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
    JAX ZeRO plan's optimizer-state sharding."""

    def __init__(self, mesh, zero: bool, specs=None):
        from torch.distributed.device_mesh import DeviceMesh
        sizes = _axis_sizes(mesh)
        self.device = _mesh_device(mesh)
        self.world = sizes["dp"] * sizes["fsdp"]       # batch ranks
        self.batch_group = _batch_group(mesh)
        self.tp = TensorParallel.of(mesh)
        self.specs = specs
        self.layout = None
        if sizes["dp"] == 1:
            self.mesh, self.norm_group = mesh["fsdp"], mesh.get_group("fsdp")
        elif zero:
            # Every batch rank of this tp index (all ranks without tp).
            self.mesh = DeviceMesh(
                mesh.device_type, _batch_ranks(mesh),
                mesh_dim_names=("tp_index", "batch"))["batch"]
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
        self.layout = _TPLayout(model, self.specs, self.tp)
        return factory(model.parameters())

    def reduce(self, params) -> None:
        """FSDP2 reduced the gradients in the backward."""

    def grad_norm(self, params) -> torch.Tensor:
        if self.tp.size > 1:
            ssq = _ssq_split([p.grad.to_local() for p in params],
                             self.layout.sharded)
            dist.all_reduce(ssq, group=self.norm_group)
            return _tp_norm(ssq, self.tp)
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
        if self.tp.size > 1:
            return self._tp_state_dict(state)
        model, optim = get_state_dict(state.model, state.optimizer,
                                      options=self._options())
        return {"model": model, "optimizer": optim}

    @torch.no_grad()
    def _tp_state_dict(self, state) -> dict:
        """get_state_dict's full form (optimizer state keyed by parameter
        name), one tensor at a time: each FSDP2 shard made whole over
        fsdp, then over tp, and kept (on the host) by rank 0 alone."""
        from torch.distributed.tensor import DTensor

        lay, keep = self.layout, dist.get_rank() == 0

        def full(name, t):
            t = t.full_tensor() if isinstance(t, DTensor) else t
            t = lay.gather(name, t) if t.dim() else t
            return t.detach().cpu() if keep else None

        opt = state.optimizer
        names = {id(p): n for n, p in state.model.named_parameters()}
        model = {n: full(n, p) for n, p in state.model.named_parameters()}
        optim = {"state": {}, "param_groups": []}
        for group in opt.param_groups:
            optim["param_groups"].append(
                {**{k: v for k, v in group.items() if k != "params"},
                 "params": [names[id(p)] for p in group["params"]]})
            for p in group["params"]:
                optim["state"][names[id(p)]] = {
                    k: full(names[id(p)], v) if torch.is_tensor(v) else v
                    for k, v in opt.state.get(p, {}).items()}
        if not keep:
            return {}
        return {"model": model, "optimizer": optim}

    def load_state_dict(self, state, payload: dict) -> None:
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions, set_state_dict)
        model, optim = payload["model"], payload["optimizer"]
        if self.tp.size > 1:
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


def _mesh_plan(mesh, param_specs, shard_update, hierarchical_allreduce,
               ici_axis):
    sizes = refuse_axes(mesh, "build_train_step")
    if sizes["tp"] > 1 and param_specs is None:
        raise ValueError("tensor parallelism (tp > 1) needs param_specs "
                         "(models.llama.llama_param_specs): they name the "
                         "dims the model's shards cut")
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
                     sync_every: Optional[int] = None):
    """Build (init_fn, step_fn), on one device or over ``mesh``.

    - loss_fn(model, batch) -> scalar loss; batch is a tensor (or a tuple
      of tensors) whose dim 0 is the batch: under a mesh, this rank's
      rows of the global batch (``parallel.mesh.batch_rows``; the batch
      is sharded over (dp, fsdp)).
    - optimizer: a factory over the parameters (:func:`adamw`).
    - mesh: a ``parallel.mesh.create_mesh`` DeviceMesh; the metrics are
      then those of the global batch (the loss mean and the gradients
      are averaged over every batch rank).
    - param_specs: ``models.llama.llama_param_specs``; with fsdp > 1 the
      parameters are sharded over it (:class:`_ShardedPlan`), else
      replicated (:class:`_ReplicatedPlan`).  With tp > 1 (needs
      param_specs) the model must be built on the same mesh
      (``LlamaModel(mesh=)``: its tp shards).
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

    init_fn(model, init_weights=None) -> TrainState: under a mesh the
    model is placed first (sharded by FSDP2; a model on the meta device
    is then allocated on the mesh's device) and ``init_weights(model)``
    fills it before the optimizer is made (``models.params.init_params_``
    fills each rank's shard).  step_fn(state, batch) -> (state, metrics)
    with ``loss`` and ``grad_norm`` (of the gradients before the update)
    as f32 device scalars, read by nobody unless asked."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    plan = None
    batch_shards = 1
    if mesh is not None:
        plan = _mesh_plan(mesh, param_specs, shard_update,
                          hierarchical_allreduce, ici_axis)
        batch_shards = plan.world
    fsdp = isinstance(plan, _ShardedPlan)
    run_loss = loss_fn
    if remat:
        def run_loss(model, batch):
            return checkpoint(loss_fn, model, batch, use_reentrant=False)

    def init_fn(model, init_weights: Optional[Callable] = None):
        if plan is not None:
            held = getattr(getattr(model, "tp", None), "size", 1)
            if held != plan.tp.size:
                raise ValueError(
                    f"the model holds tp={held} shards, the mesh has "
                    f"tp={plan.tp.size}: build it with LlamaModel(mesh=)")
            model = plan.place(model)
            if any(p.is_meta for p in model.parameters()):
                model.to_empty(device=plan.device)
        if init_weights is not None:
            init_weights(model)
        make = optimizer if plan is None else \
            (lambda params: plan.optimizer(model, optimizer))
        return TrainState(step=0, model=model,
                          optimizer=make(model.parameters()), plan=plan)

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
        state.optimizer.zero_grad(set_to_none=True)
        loss, params = grads_of(state, batch)
        if plan is None:
            grad_norm = optax_global_norm([p.grad for p in params])
        else:
            plan.reduce(params)
            # The tp ranks of a batch shard computed the same loss.
            dist.all_reduce(loss, group=plan.batch_group)
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
