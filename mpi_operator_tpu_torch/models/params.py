"""Weights for the port's LlamaModel: conversion from the JAX model's
param tree, and seeded random initialisation on the device.

Flax ``DenseGeneral`` kernels are laid out [in, ...out] (``wq``/``wk``/
``wv`` [dim, H, D], ``wo`` [H, D, dim], ``w1``/``w3`` [dim, F], ``w2``
[F, dim], ``output`` [dim, V]); a torch ``nn.Linear`` weight is
[out, in].  An MoE layer (``ops/moe.py``) maps ``router/kernel``
[dim, E] to an f32 ``router.weight`` [E, dim] and keeps the expert
stacks ``w1``/``w3`` [E, dim, F] and ``w2`` [E, F, dim] in their own
layout, the one its batched products take.  Matmul weights, expert
stacks and the embedding are stored in ``config.dtype`` for serving
(flax casts its f32 params to it at every use) or, given
``dtype=torch.float32``, in f32 for training; norm scales and the router
stay f32.  A quantized tree (``quantize_params`` of the JAX package:
``{kernel: int8, scale: f32}`` per matmul) keeps its int8 weights and
f32 scales, for a ``weight_dtype="int8"`` config.

``share_weights`` gives a model with another runtime configuration (a
paged layout, another ``max_seq_len``) over the same tensors, without a
copy; a self-draft for speculative decoding needs not even that: the
batcher takes the target itself as ``draft_model``.

Tensor and expert parallelism: ``llama_param_specs`` names the dim of
each tensor that 'tp' cuts and the expert dim that 'ep' cuts.
``shard_state_dict`` keeps a rank's ``torch.chunk`` of a full state dict
on it (``from_flax_params`` gives the full one), ``gather_state_dict``
joins every rank's chunks back (a collective), ``shard_model`` and the
``mesh=`` of ``load_flax_params`` and ``init_params`` build a rank's
shard, and ``init_params_`` draws each tensor in full and keeps the
rank's part, so random weights at a seed are the one-card weights cut
up.  A pipeline rank's ``LlamaStage`` takes the same draws (every draw of
the one-card model is made, the stage keeps its own), its part of a JAX
tree (``from_flax_params(stage=)``), and ``gather_stage_state_dict``
joins every stage's tensors into the one-device state dict.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops.moe import init_expert_stack_
from ..parallel.tensor import ExpertParallel, TensorParallel, tp_dim
from .llama import LlamaConfig, LlamaModel, llama_param_specs

_LINEARS = {"attention": ("wq", "wk", "wv", "wo"),
            "feed_forward": ("w1", "w2", "w3")}


def _linear_weight(kernel: np.ndarray, name: str) -> np.ndarray:
    """DenseGeneral kernel -> nn.Linear weight [out, in]."""
    if name == "wo":                     # [H, D, dim] -> [dim, H*D]
        return kernel.reshape(-1, kernel.shape[-1]).T
    return kernel.reshape(kernel.shape[0], -1).T   # [in, ...out]


def from_flax_params(tree, cfg: LlamaConfig,
                     dtype: Optional[torch.dtype] = None, stage=None
                     ) -> Dict[str, torch.Tensor]:
    """The JAX LlamaModel's ``params`` (nested dicts of numpy arrays; a
    ``{"params": ...}`` wrapper is accepted) -> the port's state dict on
    the CPU.  ``dtype`` (default ``cfg.dtype``) is the storage type of
    the matmul weights and the embedding.  A quantized matmul
    (``{kernel: int8, scale: f32}``) gives ``<layer>.weight`` int8
    [out, in] and ``<layer>.scale`` f32 [out]: the JAX scale covers the
    kernel's output dims, flattened in the weight's row order.  With
    ``stage`` (a ``models.llama_pipeline.LlamaStage``) only what the
    stage holds: its ``layers_i``, and the embedding or the norm and head
    where it holds them (``LlamaStage.load_full_state_dict`` loads it)."""
    if "params" in tree:
        tree = tree["params"]
    dtype = dtype or cfg.dtype
    layers = range(cfg.n_layers) if stage is None else stage.layer_ids
    embedding = stage is None or stage.holds_embedding
    head = stage is None or stage.holds_head

    def t(arr, dt):
        return torch.from_numpy(np.array(arr, dtype=np.float32,
                                         order="C")).to(dt)

    def linear(sd, key, node, name):
        kernel = np.asarray(node["kernel"])
        if "scale" not in node:
            sd[key + ".weight"] = t(_linear_weight(kernel, name), dtype)
            return
        sd[key + ".weight"] = torch.from_numpy(np.ascontiguousarray(
            _linear_weight(kernel, name)).astype(np.int8))
        sd[key + ".scale"] = t(np.asarray(node["scale"]).reshape(-1),
                               torch.float32)

    sd = {}
    if embedding:
        sd["tok_embeddings.weight"] = t(tree["tok_embeddings"]["embedding"],
                                        dtype)
    if head:
        sd["norm.scale"] = t(tree["norm"]["scale"], cfg.param_dtype)
        linear(sd, "output", tree["output"], "output")
    for i in layers:
        layer = tree[f"layers_{i}"]
        for group, names in _LINEARS.items():
            if group == "feed_forward" and cfg.n_experts > 1:
                ffn, key = layer[group], f"layers.{i}.{group}"
                sd[key + ".router.weight"] = t(
                    np.asarray(ffn["router"]["kernel"]).T, cfg.param_dtype)
                for name in names:
                    sd[f"{key}.{name}"] = t(ffn[name], dtype)
                continue
            for name in names:
                linear(sd, f"layers.{i}.{group}.{name}", layer[group][name],
                       name)
        for norm in ("attention_norm", "ffn_norm"):
            sd[f"layers.{i}.{norm}.scale"] = t(layer[norm]["scale"],
                                               cfg.param_dtype)
    return sd


def shard_state_dict(state: Dict[str, torch.Tensor], cfg: LlamaConfig,
                     tp: TensorParallel,
                     ep: ExpertParallel = ExpertParallel()
                     ) -> Dict[str, torch.Tensor]:
    """This rank's part of a full state dict: each tensor's
    ``torch.chunk`` on the dims ``llama_param_specs`` puts on 'tp' (an
    int8 weight's ``.scale`` follows its output dim) and on 'ep' (the
    expert stacks' dim 0), the rest whole."""
    specs = llama_param_specs(cfg)
    return {k: ep.chunk(tp.chunk(v, tp_dim(specs.get(k, ()))),
                        tp_dim(specs.get(k, ()), "ep")).contiguous()
            for k, v in state.items()}


def gather_state_dict(state: Dict[str, torch.Tensor], cfg: LlamaConfig,
                      tp: TensorParallel,
                      ep: ExpertParallel = ExpertParallel()
                      ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_state_dict` (a collective over the tp
    and ep groups: every rank calls it and gets the full tensors)."""
    specs = llama_param_specs(cfg)
    return {k: ep.gather(tp.gather(v, tp_dim(specs.get(k, ()))),
                         tp_dim(specs.get(k, ()), "ep"))
            for k, v in state.items()}


def shard_model(model: LlamaModel, mesh) -> LlamaModel:
    """This rank's tensor- and expert-parallel shard of a whole
    (one-card) model, on its device, with its store dtype; the caller
    frees the whole model."""
    sharded = LlamaModel(model.config, device=model.device,
                         store_dtype=model.tok_embeddings.weight.dtype,
                         mesh=mesh)
    sharded.load_state_dict(shard_state_dict(
        model.state_dict(), model.config, sharded.tp, sharded.ep))
    return sharded.eval()


def load_flax_params(tree, cfg: LlamaConfig, device=None,
                     dtype: Optional[torch.dtype] = None,
                     mesh=None) -> LlamaModel:
    """A LlamaModel on ``device`` holding the JAX model's weights, its
    matmul weights and embedding stored in ``dtype`` (default
    ``cfg.dtype``; ``cfg.param_dtype`` for training); under a ``mesh``
    with tp or ep > 1, this rank's shard of them."""
    model = LlamaModel(cfg, device=device, store_dtype=dtype, mesh=mesh)
    model.load_state_dict(shard_state_dict(
        from_flax_params(tree, cfg, dtype), cfg, model.tp, model.ep))
    return model.eval()


@torch.no_grad()
def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None, dtype: Optional[torch.dtype] = None,
                mesh=None) -> LlamaModel:
    """A seeded random LlamaModel built on ``device``: normal weights
    with std 1/sqrt(fan_in) (the embedding std 1), MoE expert stacks as
    flax's truncated ``lecun_normal`` draws them (``ops/moe.py``), norm
    scales 1, matmul weights and embedding stored in ``dtype`` (default
    ``cfg.dtype``).  The values are drawn in f32 on the generator's
    device, which must be ``device``.  Under a ``mesh`` with tp or ep > 1
    the model is this rank's shard of the one-card model at the seed."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    if cfg.weight_dtype == "int8":
        # Drawn at full precision, then quantized (models/quant.py).
        from .quant import quantize_model
        return quantize_model(init_params(
            dataclasses.replace(cfg, weight_dtype="auto"), generator,
            device=dev, dtype=dtype, mesh=mesh))
    model = LlamaModel(cfg, device=dev, store_dtype=dtype, mesh=mesh)
    return init_params_(model, generator).eval()


def _local_part(full: torch.Tensor, param) -> torch.Tensor:
    """This rank's part of a DTensor parameter's full value: each
    ``Shard(d)`` placement keeps the ``torch.chunk`` the rank's index on
    that mesh dim names (DTensor's own split; a rank past the last chunk
    holds none)."""
    from torch.distributed.tensor import Shard
    for mesh_dim, placement in enumerate(param.placements):
        if isinstance(placement, Shard):
            d = placement.dim
            chunks = full.chunk(param.device_mesh.size(mesh_dim), dim=d)
            k = param.device_mesh.get_local_rank(mesh_dim)
            full = chunks[k] if k < len(chunks) else full.narrow(d, 0, 0)
    return full


@torch.no_grad()
def init_params_(model: LlamaModel, generator: torch.Generator
                 ) -> LlamaModel:
    """Fill ``model``'s parameters in place with the draws of
    :func:`init_params`, in its order.  A parameter that is a shard
    (over 'tp' or 'ep', and/or a DTensor of FSDP2) receives only this
    rank's part: each draw is made in full on the generator's device, one
    parameter at a time, and the rank keeps its part (the tp and ep
    chunks, then FSDP2's), so no rank ever holds the whole model and
    every rank's weights equal ``init_params``' for the seed."""
    from torch.distributed.tensor import DTensor
    if hasattr(model, "chunks"):                   # a pipeline stage
        return _init_stage_(model, generator)
    tp, ep = model.tp, model.ep
    specs = llama_param_specs(model.config)
    for name, p in model.named_parameters():
        fsdp = isinstance(p, DTensor)
        d = tp_dim(specs[name]) if tp.size > 1 else None
        e = tp_dim(specs[name], "ep") if ep.size > 1 else None
        shape = list(p.shape)
        if d is not None:
            shape[d] *= tp.size
        if e is not None:
            shape[e] *= ep.size
        full = p if not fsdp and d is None and e is None else torch.empty(
            shape, dtype=p.dtype, device=generator.device)
        if name.endswith(".scale"):
            full.fill_(1.0)
        elif p.dim() == 3:               # an MoE expert stack [E, in, out]
            init_expert_stack_(full, generator)
        else:
            std = 1.0 if name == "tok_embeddings.weight" else \
                1.0 / math.sqrt(shape[1])
            full.copy_(torch.randn(shape, generator=generator,
                                   device=generator.device,
                                   dtype=torch.float32).mul_(std))
        part = ep.chunk(tp.chunk(full, d), e)
        if fsdp:
            p.to_local().copy_(_local_part(part, p))
        elif d is not None or e is not None:
            p.copy_(part)
    return model


def _init_stage_(stage, generator: torch.Generator):
    """:func:`init_params_` of a ``LlamaStage``: every draw of the
    one-device model is made, in its order, and the stage keeps those of
    the parameters it holds (their fsdp chunks under ``fsdp_shard``), so
    a pipeline at a seed trains the one-card weights."""
    own = dict(stage.named_parameters())
    whole = LlamaModel(stage.config, device="meta")
    for name, meta in whole.named_parameters():
        p = own.get(name)
        if name.endswith(".scale"):                # no draw
            if p is not None:
                p.fill_(1.0)
            continue
        shape = tuple(meta.shape)
        if meta.dim() == 3:              # an MoE expert stack [E, in, out]
            full = init_expert_stack_(torch.empty(
                shape, device=generator.device), generator)
        else:
            std = 1.0 if name == "tok_embeddings.weight" else \
                1.0 / math.sqrt(shape[1])
            full = torch.randn(shape, generator=generator,
                               device=generator.device,
                               dtype=torch.float32).mul_(std)
        if p is not None:
            p.copy_(stage.fsdp_part(name, full))
    return stage


def gather_stage_state_dict(stage, tensors: Optional[dict] = None,
                            device="cpu", dst: Optional[int] = None
                            ) -> Dict[str, torch.Tensor]:
    """The one-device state dict (``LlamaModel``'s names, shapes and
    order) joined from every pp rank's ``LlamaStage``: ``tensors``
    (default: the stage's parameters) maps this stage's names to tensors
    in its layout (its fsdp chunks under ``fsdp_shard``), such as the
    gradients of ``pipeline_loss_and_grads_1f1b`` or the optimizer's
    moments.  A collective over the stage's fsdp and pp groups: every
    rank calls it and every rank gets the whole, on ``device``; with
    ``dst`` (a global rank) only that rank does, one tensor at a time,
    and the others get {}.  Every matrix shares one type, and the norm
    scales and MoE routers another (``param_dtype``; every stage holds
    blocks, so every stage holds both kinds), so the receivers know what
    each message holds."""
    from ..parallel.pipeline import _gather_fsdp, _Place
    from .llama_pipeline import layer_owner
    if tensors is None:
        tensors = dict(stage.named_parameters())
    cfg = stage.config
    place = _Place(stage.mesh)
    keep = dst is None or dist.get_rank() == dst
    # Under dst, only dst's pp group moves the tensors (the fsdp gathers
    # run on every rank of the owning stage).
    moves = dst is None or place.group is None or \
        dst in dist.get_process_group_ranks(place.group)

    def kind(name):
        return name.endswith((".scale", ".router.weight"))

    kinds = {kind(n): t.dtype for n, t in tensors.items()}
    whole = LlamaModel(cfg, device="meta")
    out = {}
    for name, meta in whole.named_parameters():
        owner = layer_owner(name, cfg.n_layers, stage.n_stages,
                            stage.virtual_stages)
        if owner == stage.stage:
            t = tensors[name].detach()
            d = stage.fsdp_dims.get(name, -1)
            if d >= 0:
                t = _gather_fsdp(t, d, place)
            buf = t.to(place.device).contiguous()
        elif moves:
            buf = torch.empty(meta.shape, dtype=kinds[kind(name)],
                              device=place.device)
        if not moves:
            continue
        if place.n > 1:
            dist.broadcast(buf, src=place.global_rank(owner),
                           group=place.group)
        if keep:
            out[name] = buf.to(device)
    return out


# Configuration fields that shape no tensor: a model that differs from
# another only in these can hold the other's tensors.
_RUNTIME_FIELDS = frozenset({"page_size", "cache_blocks", "kv_cache_dtype",
                             "max_seq_len", "attention_impl", "remat",
                             "sliding_window"})


def share_weights(model: LlamaModel, **overrides) -> LlamaModel:
    """A LlamaModel with ``model.config`` changed by ``overrides`` (only
    fields that shape no tensor: page_size, cache_blocks, kv_cache_dtype,
    max_seq_len, attention_impl, remat, sliding_window) whose parameters
    and buffers ARE
    ``model``'s: no copy, no new device memory."""
    bad = set(overrides) - _RUNTIME_FIELDS
    if bad:
        raise ValueError(f"share_weights cannot change {sorted(bad)}: they "
                         f"shape the tensors")
    cfg = dataclasses.replace(model.config, **overrides)
    memo = {id(t): t for t in itertools.chain(model.parameters(),
                                              model.buffers())}
    twin = copy.deepcopy(model, memo)
    for module in twin.modules():
        if hasattr(module, "config"):
            module.config = cfg
    return twin


# ---------------------------------------------------------------------------
# The image models (models/resnet.py, models/mnist.py)
# ---------------------------------------------------------------------------

def _flax_image_state(tree) -> Dict[str, torch.Tensor]:
    """A flax conv/dense/BatchNorm tree -> the port's state dict: each
    leaf at its path joined by dots, an HWIO conv kernel as an OIHW
    ``weight``, a dense [in, out] kernel as a [out, in] ``weight``; a
    BatchNorm's ``scale``/``bias`` and ``mean``/``var`` keep their
    names."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if hasattr(node, "items"):
            for key, value in node.items():
                walk(value, path + (key,))
            return
        value = np.array(node, dtype=np.float32)
        if path[-1] == "kernel":
            path = path[:-1] + ("weight",)
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 \
                else value.T
        out[".".join(path)] = torch.from_numpy(np.ascontiguousarray(value))

    walk(tree, ())
    return out


def from_flax_resnet(variables, cfg=None) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` of the JAX ResNet (numpy or
    JAX arrays) -> a state dict for ``models.resnet.ResNet``: weights
    and running statistics, in f32.  ``cfg`` (a ResNetConfig), when
    given, is checked against the tree's block count."""
    state = _flax_image_state(variables["params"])
    state.update(_flax_image_state(variables.get("batch_stats", {})))
    if cfg is not None:
        blocks = {k.split(".")[0] for k in state if k.startswith("stage")}
        if len(blocks) != sum(cfg.stage_sizes):
            raise ValueError(f"the tree holds {len(blocks)} blocks, the "
                             f"config {sum(cfg.stage_sizes)}")
    return state


def from_flax_mnist(params) -> Dict[str, torch.Tensor]:
    """The JAX MnistCNN's params (``model.init``'s ``{"params": ...}``
    or the inner tree) -> a state dict for ``models.mnist.MnistCNN``."""
    return _flax_image_state(params.get("params", params))
