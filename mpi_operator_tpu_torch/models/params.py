"""Weights for the port's LlamaModel: conversion from the JAX model's
param tree, and seeded random initialisation on the device.

Flax ``DenseGeneral`` kernels are laid out [in, ...out] (``wq``/``wk``/
``wv`` [dim, H, D], ``wo`` [H, D, dim], ``w1``/``w3`` [dim, F], ``w2``
[F, dim], ``output`` [dim, V]); a torch ``nn.Linear`` weight is
[out, in].  Matmul weights and the embedding are stored in
``config.dtype`` for serving (flax casts its f32 params to it at every
use) or, given ``dtype=torch.float32``, in f32 for training; norm scales
stay f32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from .llama import LlamaConfig, LlamaModel

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
    the matmul weights and the embedding."""
    if "params" in tree:
        tree = tree["params"]
    dtype = dtype or cfg.dtype

    def t(arr, dt):
        return torch.from_numpy(np.array(arr, dtype=np.float32,
                                         order="C")).to(dt)

    sd = {"tok_embeddings.weight": t(tree["tok_embeddings"]["embedding"],
                                     dtype),
          "norm.scale": t(tree["norm"]["scale"], cfg.param_dtype),
          "output.weight": t(_linear_weight(
              np.asarray(tree["output"]["kernel"]), "output"), dtype)}
    for i in range(cfg.n_layers):
        layer = tree[f"layers_{i}"]
        for group, names in _LINEARS.items():
            for name in names:
                kernel = np.asarray(layer[group][name]["kernel"])
                sd[f"layers.{i}.{group}.{name}.weight"] = t(
                    _linear_weight(kernel, name), dtype)
        for norm in ("attention_norm", "ffn_norm"):
            sd[f"layers.{i}.{norm}.scale"] = t(layer[norm]["scale"],
                                               cfg.param_dtype)
    return sd


def load_flax_params(tree, cfg: LlamaConfig, device=None,
                     dtype: Optional[torch.dtype] = None) -> LlamaModel:
    """A LlamaModel on ``device`` holding the JAX model's weights, its
    matmul weights and embedding stored in ``dtype`` (default
    ``cfg.dtype``; ``cfg.param_dtype`` for training)."""
    model = LlamaModel(cfg, device=device, store_dtype=dtype)
    model.load_state_dict(from_flax_params(tree, cfg, dtype))
    return model.eval()


@torch.no_grad()
def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None, dtype: Optional[torch.dtype] = None
                ) -> LlamaModel:
    """A seeded random LlamaModel built on ``device``: normal weights
    with std 1/sqrt(fan_in) (the embedding std 1), norm scales 1, matmul
    weights and embedding stored in ``dtype`` (default ``cfg.dtype``).
    The values are drawn in f32 on the generator's device, which must be
    ``device``."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    model = LlamaModel(cfg, device=dev, store_dtype=dtype)
    for name, p in model.named_parameters():
        if name.endswith(".scale"):
            p.fill_(1.0)
            continue
        std = 1.0 if name == "tok_embeddings.weight" else \
            1.0 / math.sqrt(p.shape[1])
        p.copy_(torch.randn(p.shape, generator=generator, device=dev,
                            dtype=torch.float32).mul_(std))
    return model.eval()
