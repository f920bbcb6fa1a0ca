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

Tensor parallelism: ``llama_param_specs`` names the dim of each tensor
that 'tp' cuts.  ``shard_state_dict`` keeps a rank's ``torch.chunk`` of
a full state dict on it, ``gather_state_dict`` joins every rank's
chunks back (a collective), ``shard_model`` and the ``mesh=`` of
``load_flax_params`` and ``init_params`` build a rank's shard, and
``init_params_`` draws each tensor in full and keeps the rank's part, so
random weights at a seed are the one-card weights cut up.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import math
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.moe import init_expert_stack_
from ..parallel.tensor import TensorParallel, tp_dim
from .llama import LlamaConfig, LlamaModel, llama_param_specs

_LINEARS = {"attention": ("wq", "wk", "wv", "wo"),
            "feed_forward": ("w1", "w2", "w3")}


def _linear_weight(kernel: np.ndarray, name: str) -> np.ndarray:
    """DenseGeneral kernel -> nn.Linear weight [out, in]."""
    if name == "wo":                     # [H, D, dim] -> [dim, H*D]
        return kernel.reshape(-1, kernel.shape[-1]).T
    return kernel.reshape(kernel.shape[0], -1).T   # [in, ...out]


def from_flax_params(tree, cfg: LlamaConfig,
                     dtype: Optional[torch.dtype] = None
                     ) -> Dict[str, torch.Tensor]:
    """The JAX LlamaModel's ``params`` (nested dicts of numpy arrays; a
    ``{"params": ...}`` wrapper is accepted) -> the port's state dict on
    the CPU.  ``dtype`` (default ``cfg.dtype``) is the storage type of
    the matmul weights and the embedding.  A quantized matmul
    (``{kernel: int8, scale: f32}``) gives ``<layer>.weight`` int8
    [out, in] and ``<layer>.scale`` f32 [out]: the JAX scale covers the
    kernel's output dims, flattened in the weight's row order."""
    if "params" in tree:
        tree = tree["params"]
    dtype = dtype or cfg.dtype

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

    sd = {"tok_embeddings.weight": t(tree["tok_embeddings"]["embedding"],
                                     dtype),
          "norm.scale": t(tree["norm"]["scale"], cfg.param_dtype)}
    linear(sd, "output", tree["output"], "output")
    for i in range(cfg.n_layers):
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
                     tp: TensorParallel) -> Dict[str, torch.Tensor]:
    """This rank's part of a full state dict: each tensor's
    ``torch.chunk`` on the dim ``llama_param_specs`` puts on 'tp' (an
    int8 weight's ``.scale`` follows its output dim), the rest whole."""
    specs = llama_param_specs(cfg)
    return {k: tp.chunk(v, tp_dim(specs.get(k, ()))).contiguous()
            for k, v in state.items()}


def gather_state_dict(state: Dict[str, torch.Tensor], cfg: LlamaConfig,
                      tp: TensorParallel) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_state_dict` (a collective over the tp
    group: every rank calls it and gets the full tensors)."""
    specs = llama_param_specs(cfg)
    return {k: tp.gather(v, tp_dim(specs.get(k, ())))
            for k, v in state.items()}


def shard_model(model: LlamaModel, mesh) -> LlamaModel:
    """This rank's tensor-parallel shard of a whole (one-card) model,
    on its device, with its store dtype; the caller frees the whole
    model."""
    sharded = LlamaModel(model.config, device=model.device,
                         store_dtype=model.tok_embeddings.weight.dtype,
                         mesh=mesh)
    sharded.load_state_dict(shard_state_dict(
        model.state_dict(), model.config, sharded.tp))
    return sharded.eval()


def load_flax_params(tree, cfg: LlamaConfig, device=None,
                     dtype: Optional[torch.dtype] = None,
                     mesh=None) -> LlamaModel:
    """A LlamaModel on ``device`` holding the JAX model's weights, its
    matmul weights and embedding stored in ``dtype`` (default
    ``cfg.dtype``; ``cfg.param_dtype`` for training); under a ``mesh``
    with tp > 1, this rank's tensor-parallel shard of them."""
    model = LlamaModel(cfg, device=device, store_dtype=dtype, mesh=mesh)
    model.load_state_dict(shard_state_dict(
        from_flax_params(tree, cfg, dtype), cfg, model.tp))
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
    device, which must be ``device``.  Under a ``mesh`` with tp > 1 the
    model is this rank's shard of the one-card model at the seed."""
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
    (tensor-parallel over 'tp', and/or a DTensor of FSDP2) receives only
    this rank's part: each draw is made in full on the generator's
    device, one parameter at a time, and the rank keeps its part (the tp
    chunk, then FSDP2's), so no rank ever holds the whole model and every
    rank's weights equal ``init_params``' for the seed."""
    from torch.distributed.tensor import DTensor
    tp = model.tp
    specs = llama_param_specs(model.config)
    for name, p in model.named_parameters():
        fsdp = isinstance(p, DTensor)
        d = tp_dim(specs[name]) if tp.size > 1 else None
        shape = list(p.shape)
        if d is not None:
            shape[d] *= tp.size
        full = p if not fsdp and d is None else torch.empty(
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
        part = tp.chunk(full, d)
        if fsdp:
            p.to_local().copy_(_local_part(part, p))
        elif d is not None:
            p.copy_(part)
    return model


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
