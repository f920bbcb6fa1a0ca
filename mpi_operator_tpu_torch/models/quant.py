"""Weight-only int8 quantization for serving: counterpart of
``mpi_operator_tpu/models/quant.py``.

Scheme: symmetric per-output-channel int8.  For a matmul weight,
scale[out] = max|w[out, :]| / 127 over the input features and
q = round(w / scale) (round half to even, as ``jnp.round``), clipped to
[-127, 127].  Because the scale is per OUTPUT channel,
x @ dequant(q) == (x @ q) * scale, so ``QuantLinear`` multiplies by the
int8 weight and applies the scale to the product afterwards.  Weight
only: activations stay in ``config.dtype``; embeddings and norms stay
full precision; K/V quantization is separate (``kv_cache_dtype``).

The JAX layer takes the product in f32 (``preferred_element_type``),
scales it and rounds once to ``dtype``.  ``QuantLinear`` does the same on
every device: the activation cast to ``dtype`` and the int8 weight are
both exact in f32, so their f32 product, scaled and rounded once, is
the JAX layer's output up to the order of the f32 sums.  The price is
an f32 copy of the weight at each call (a fused int8 kernel would read
the int8 weight once).

Under tensor parallelism a rank quantizes its own shard.  A row of a
column-parallel weight is whole on its rank; a row of a row-parallel one
(``wo``, ``w2``: input dim on 'tp') is cut over the ranks, so its amax is
the maximum over the tp group: every rank then holds the one-card int8
values and scales of its part.  A serving model over fsdp
(``parallel/fsdp_serve.py``) is quantized one unit at a time: the unit's
tp shard gathered over fsdp, quantized as above, and cut flat again, so
a rank never holds more than one unit whole.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

# Linear layers that hold a quantized weight (the JAX package's
# _QUANT_KERNELS; the port's weights are [out, in], one contracting dim).
_QUANT_LINEARS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "output")


class QuantLinear(nn.Module):
    """Bias-free linear layer over an int8 weight [out, in] with an f32
    scale per output row (``QuantDenseGeneral``).  Both are buffers: an
    int8 tensor cannot be a trainable parameter, and a quantized model
    is for serving only."""

    def __init__(self, n_in: int, n_out: int, compute_dtype, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.register_buffer("weight", torch.zeros(
            (n_out, n_in), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            (n_out,), dtype=torch.float32, device=device))

    def forward(self, x):
        out = F.linear(x.to(self.compute_dtype).float(), self.weight.float())
        return (out * self.scale).to(self.compute_dtype)


def _quantize_kernel(w, tp=None):
    """w [out, in] -> (int8 q [out, in], f32 scale [out]); with ``tp``
    (a ``TensorParallel``) the amax of each row is taken over the tp
    group, for a weight whose input dim it cuts."""
    wf = w.float()
    amax = wf.abs().amax(dim=1)
    if tp is not None and tp.size > 1:
        import torch.distributed as dist
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=tp.group)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def _is_quant_weight(key: str) -> bool:
    parts = key.split(".")
    return (len(parts) >= 2 and parts[-1] == "weight"
            and parts[-2] in _QUANT_LINEARS)


def quantize_params(state_dict: Dict[str, torch.Tensor], config,
                    tp=None) -> Dict[str, torch.Tensor]:
    """A full-precision LlamaModel state dict -> the weight_dtype='int8'
    model's: every matmul weight becomes ``<layer>.weight`` int8 and
    ``<layer>.scale`` f32 [out]; embeddings and norms are kept.  With
    ``tp`` (a ``TensorParallel``), ``state_dict`` is this rank's shard
    (a collective over the tp group)."""
    if config.n_experts > 1:
        raise NotImplementedError(
            "weight-only int8 does not cover MoE expert stacks yet")
    from ..parallel.tensor import tp_dim
    from .llama import llama_param_specs
    specs = llama_param_specs(config)
    out = {}
    for key, value in state_dict.items():
        if _is_quant_weight(key):
            q, s = _quantize_kernel(
                value, tp if tp_dim(specs[key]) == 1 else None)
            out[key] = q
            out[key[:-len("weight")] + "scale"] = s
        else:
            out[key] = value
    return out


@torch.no_grad()
def quantize_model(model):
    """The weight_dtype='int8' twin of a full-precision LlamaModel, on its
    device (the model itself when it is already int8).  The caller frees
    the full-precision model."""
    from .llama import LlamaModel

    if model.config.weight_dtype == "int8":
        return model
    qcfg = dataclasses.replace(model.config, weight_dtype="int8")
    qmodel = LlamaModel(qcfg, device=model.device,
                        store_dtype=model.tok_embeddings.weight.dtype,
                        mesh=model.mesh, serving=model.fsdp_serve is not None)
    fs = model.fsdp_serve
    if fs is None:
        qmodel.load_state_dict(quantize_params(model.state_dict(), qcfg,
                                               model.tp))
        return qmodel.eval()
    for name, p in model.named_parameters():        # the norm scales
        qmodel.get_parameter(name).copy_(p)
    for unit in fs.order:
        for name, t in quantize_params(fs.gathered(unit), qcfg,
                                       model.tp).items():
            qmodel.fsdp_serve.place(name, t)
    return qmodel.eval()
