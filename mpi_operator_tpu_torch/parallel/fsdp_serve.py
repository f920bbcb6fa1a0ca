"""Serving weights over the ``fsdp`` axis: each rank holds 1/fsdp of every
matmul weight and gathers a block's weights just before the block runs.

The JAX server places its params by ``llama_param_specs`` on any mesh
(``mpi_operator_tpu/serving/server.py:308-318``): 'fsdp' cuts the matmul
dim opposite 'tp' (``models/llama.py`` ``llama_param_specs``), and XLA
gathers each weight where a product needs it.  The port does the same by
hand, in the style of ``parallel/tensor.py``: plain local tensors and an
explicit group, no DTensors and no FSDP2 (``fully_shard`` takes one
parameter dtype a module, never shards buffers such as ``QuantLinear``'s
int8 weight and scale, and gathers for a backward that serving never
runs).

A model is cut in *units*: the embedding, each block, the head.  A
unit's cut tensors (every ``llama_param_specs`` entry with a mesh axis:
the matmul weights, the int8 weights and their scales, the expert
stacks, the embedding; after the tp and ep cut) are laid end to end, one
flat run per dtype, padded to a multiple of fsdp, and rank r keeps chunk
r of each run (``flat_<dtype>``, a buffer of the unit's module, so the
rank's ``state_dict()`` is what it holds).  The norm scales and the MoE
router stay whole on every rank, as the JAX spec ``P(None)`` keeps them.
The gather is exact, so cutting flat rather than on the spec's dim
changes no number.

Each unit's modules read their weights from gather buffers: the blocks
alternate between two sets of buffers (block i reads set i % 2), the
embedding and the head have one set each.  A forward calls
:meth:`ServingFSDP.ready` before each unit, which waits for that unit's
gather (the embedding's is issued there) and issues the next unit's:
one ``all_gather_into_tensor`` a dtype over the fsdp group, on a side
stream on the card (after the main stream's work so far, so the
buffer's last reader, two blocks back, is done), whose event the main
stream waits on.  So the next block's gather runs under this block's
products.  On the CPU the gathers run in line.  Every rank issues the
same gathers in the same order.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

from .tensor import TensorParallel


def is_cut(spec) -> bool:
    """Whether ``fsdp`` serving cuts a ``llama_param_specs`` entry: every
    tensor that a mesh axis cuts (norm scales and the router are
    replicated, ``P(None)``)."""
    return any(a is not None for a in spec)


def unit_of(name: str) -> str:
    """The unit a parameter name belongs to: ``tok_embeddings``,
    ``layers.<i>`` or ``output``."""
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "layers" else parts[0]


def flat_name(dtype: torch.dtype) -> str:
    """The buffer name of a unit's flat shard of ``dtype``."""
    return "flat_" + str(dtype).rsplit(".", 1)[-1]


class FlatLayout:
    """Where each cut tensor lies in its unit's flat run of its dtype:
    ``runs[(unit, dtype)]`` is (padded numel, [(name, shape, offset)]),
    ``where[name]`` is (unit, dtype, offset, shape), in the order of the
    entries (``llama_param_specs`` order)."""

    def __init__(self, entries, n: int):
        self.n = n
        self.runs: Dict[tuple, list] = {}
        self.where: Dict[str, tuple] = {}
        for name, shape, dtype in entries:
            key = (unit_of(name), dtype)
            run = self.runs.setdefault(key, [0, []])
            run[1].append((name, tuple(shape), run[0]))
            self.where[name] = (key[0], dtype, run[0], tuple(shape))
            run[0] += math.prod(shape)
        for run in self.runs.values():
            run[0] = -(-run[0] // n) * n

    def chunk(self, key) -> int:
        return self.runs[key][0] // self.n


def layout_of(tensors: dict, cfg, n: int) -> FlatLayout:
    """The layout of the cut tensors among ``tensors`` (name -> tensor,
    this rank's tp/ep shards) for an fsdp axis of ``n`` ranks."""
    from ..models.llama import llama_param_specs
    specs = llama_param_specs(cfg)
    return FlatLayout([(k, tuple(tensors[k].shape), tensors[k].dtype)
                       for k, spec in specs.items()
                       if k in tensors and is_cut(spec)], n)


def flat_shards(state: dict, cfg, fsdp: TensorParallel) -> dict:
    """This fsdp rank's part of a tp/ep-cut state dict: the uncut tensors
    whole, and ``<unit>.flat_<dtype>``: chunk ``fsdp.rank`` of each
    unit's flat run (the state dict of a serving model at fsdp > 1)."""
    layout = layout_of(state, cfg, fsdp.size)
    out = {k: v for k, v in state.items() if k not in layout.where}
    for (unit, dtype), (total, items) in layout.runs.items():
        c = total // fsdp.size
        lo, hi = fsdp.rank * c, (fsdp.rank + 1) * c
        shard = torch.zeros(c, dtype=dtype, device=state[items[0][0]].device)
        for name, shape, off in items:
            n = math.prod(shape)
            a, b = max(off, lo), min(off + n, hi)
            if a < b:
                shard[a - lo:b - lo] = state[name].reshape(-1)[a - off:b - off]
        out[f"{unit}.{flat_name(dtype)}"] = shard
    return out


class ServingFSDP:
    """The fsdp side of a serving ``LlamaModel`` (``LlamaModel(mesh=,
    serving=True)`` with fsdp > 1): its layout, its gather buffers and
    the views of them that the modules read.  Built on the model's meta
    modules before they are placed: each cut tensor leaves its module's
    parameters or buffers and becomes a plain attribute, a view of a
    gather buffer, and each unit's module gains its ``flat_<dtype>``
    buffers (meta, placed with the model)."""

    def __init__(self, model, mesh, device):
        self.par = TensorParallel.of(mesh, "fsdp")
        self.device = torch.device(device)
        self.model = model
        named = dict(model.named_parameters())
        named.update(model.named_buffers())
        self.layout = layout_of(named, model.config, self.par.size)
        self.order = ["tok_embeddings"] + [
            f"layers.{i}" for i in range(model.config.n_layers)] + ["output"]
        # One set of gather buffers a kind; blocks alternate two.
        self.buffers: Dict[str, Dict[torch.dtype, torch.Tensor]] = {}
        for (unit, dtype), (total, _) in self.layout.runs.items():
            bufs = self.buffers.setdefault(self.kind(unit), {})
            if dtype not in bufs:
                bufs[dtype] = torch.empty(total, dtype=dtype,
                                          device=self.device)
        self.views = []
        for name, (unit, dtype, off, shape) in self.layout.where.items():
            owner, _, attr = name.rpartition(".")
            module = model.get_submodule(owner)
            module._parameters.pop(attr, None)
            module._buffers.pop(attr, None)
            buf = self.buffers[self.kind(unit)][dtype]
            view = buf[off:off + math.prod(shape)].view(shape)
            object.__setattr__(module, attr, view)
            self.views.append(view)
        for unit, dtype in self.layout.runs:
            model.get_submodule(unit).register_buffer(
                flat_name(dtype), torch.empty(
                    self.layout.chunk((unit, dtype)), dtype=dtype,
                    device="meta"))
        self.stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(device=self.device)
            self.events = {kind: torch.cuda.Event()
                           for kind in self.buffers}
        self.pending: Dict[int, Optional[object]] = {}

    def __deepcopy__(self, memo):       # shared by share_weights' twins
        return self

    def kind(self, unit: str) -> str:
        """The set of gather buffers ``unit`` reads."""
        if unit.startswith("layers."):
            return f"block{int(unit.split('.')[1]) % 2}"
        return unit

    def shard(self, unit: str, dtype) -> torch.Tensor:
        """This rank's flat shard of ``unit``'s ``dtype`` run."""
        return getattr(self.model.get_submodule(unit), flat_name(dtype))

    def resident_bytes(self) -> dict:
        """Bytes this rank holds: its flat shards, its uncut tensors (norm
        scales, routers) and its gather buffers."""
        shards = sum(self.shard(u, d).numel() * d.itemsize
                     for u, d in self.layout.runs)
        whole = sum(t.numel() * t.element_size() for name, t in
                    self.model.state_dict().items()
                    if ".flat_" not in name)
        buffers = sum(b.numel() * b.element_size()
                      for bufs in self.buffers.values()
                      for b in bufs.values())
        return {"shards": shards, "whole": whole, "buffers": buffers}

    # -- the gathers ------------------------------------------------------
    def _issue(self, k: int) -> None:
        unit = self.order[k]
        kind = self.kind(unit)
        pairs = [(self.buffers[kind][d], self.shard(unit, d))
                 for (u, d) in self.layout.runs if u == unit]
        if self.stream is None:
            for buf, shard in pairs:
                self._all_gather(buf, shard)
            self.pending[k] = None
            return
        # The buffer's last reader was enqueued on the main stream.
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            for buf, shard in pairs:
                self._all_gather(buf, shard)
            done = self.events[kind]
            done.record()
        self.pending[k] = done

    def _all_gather(self, buf: torch.Tensor, shard: torch.Tensor) -> None:
        """Every rank's ``shard`` into ``buf``, in rank order (on the
        current stream)."""
        dist.all_gather_into_tensor(buf, shard, group=self.par.group)

    def ready(self, k: int) -> None:
        """Before unit ``k`` (0 the embedding, 1..L the blocks, L + 1 the
        head) runs: wait for its gather, then issue unit k + 1's.  Unit
        0 starts a forward: its gather is issued here (a gather left
        pending by a forward that stopped early is dropped: its buffers
        are written again before they are read)."""
        if k == 0:
            self.pending.clear()
            self._issue(0)
        done = self.pending.pop(k)
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)
        if k + 1 < len(self.order):
            self._issue(k + 1)

    def gathered(self, unit: str) -> dict:
        """``unit``'s cut tensors, gathered now (name -> a view of its
        gather buffer, valid until that buffer's next gather), outside a
        forward."""
        k = self.order.index(unit)
        self.pending.clear()
        self._issue(k)
        self.pending.pop(k)
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
        kind = self.kind(unit)
        return {name: self.buffers[kind][dtype][off:off + math.prod(shape)]
                .view(shape)
                for name, (u, dtype, off, shape) in self.layout.where.items()
                if u == unit}

    def place(self, name: str, value: torch.Tensor) -> None:
        """Write this rank's part of cut tensor ``name`` (``value``: its
        tp/ep shard, whole over fsdp) into its flat shard."""
        unit, dtype, off, shape = self.layout.where[name]
        shard = self.shard(unit, dtype)
        c = shard.numel()
        lo = self.par.rank * c
        n = math.prod(shape)
        a, b = max(off, lo), min(off + n, lo + c)
        if a < b:
            shard[a - lo:b - lo].copy_(value.reshape(-1)[a - off:b - off])
