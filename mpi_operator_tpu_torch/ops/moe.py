"""Mixture-of-Experts SwiGLU layer: counterpart of
``mpi_operator_tpu/ops/moe.py``, on one device or tensor-parallel.

GShard/Switch static dispatch, as the JAX layer computes it: the router
picks each token's top-k experts, one-hot tensors place every kept
(token, expert) pair at a position of that expert's buffer [E, C, D]
(the dispatch tensor [T, E, C]), the experts run as batched products
over the stacked weights, and each token's expert outputs are summed
weighted by its gates.  Everything is einsums and ``bmm``: the JAX layer
runs no Pallas kernel here, and a gather/scatter dispatch would add in
float atomics on the card (``index_add_``), whose order changes from run
to run; the one-hot products keep a training step bit-identical.  The
combine picks each assignment's row by a one-hot product and sums the
gated top-k rows in f32 (``_dispatch``), which is the JAX combine einsum
with f32 accumulation and keeps a token's output independent of the
other tokens served with it.

``no_drop`` (the JAX module attribute) is an argument of ``forward``
here: the model passes it exactly when a KV cache is passed (the JAX
``decode=True``).  Capacity is then the token count, so no assignment
can overflow; over more than ``NO_DROP_CHUNK`` tokens the routing runs
per chunk of that size at capacity = chunk (exact, since routing is per
token).  Without it, capacity is ``max(1, int(capacity_factor * T * k /
E))`` and the assignments past it are dropped (a training tradeoff).

The Switch load-balancing value, which the JAX layer sows into the
``losses`` collection, is the attribute ``load_balancing`` of the layer
after each forward: E * sum(frac of tokens whose first choice is e *
mean router probability of e), computed when read, from the routing of
the last forward and still attached to its autograd graph
(``last_routing``: the expert indices [T, K] and router probabilities
[T, E]).  Training does not add it to the loss, as the JAX example drops
that collection.

Under tensor parallelism (``mesh=`` with tp > 1; the JAX specs w1/w3
P("ep", "fsdp", "tp"), w2 P("ep", "tp", "fsdp")) each rank holds the
chunk of every expert's hidden units F/tp: ``w1``/``w3`` [E, D, F/tp],
``w2`` [E, F/tp, D].  The router stays replicated in f32, so every rank
routes the same tokens to the same experts from the same input, and the
combine is linear in the expert outputs: the ranks' f32 combines are
summed by one all-reduce before the single rounding.  In training the
gates enter the expert products through ``copy_to_tp``, so the router
sees the whole gradient of its gates.  MoE over 'ep' raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tensor import (TensorParallel, copy_to_tp, reduce_from_tp,
                               refuse_axes)


class MoEMLP(nn.Module):
    """Top-k routed SwiGLU experts on [B, S, D] activations.

    Parameters: ``router.weight`` [E, D] in ``param_dtype`` (f32: the JAX
    router is ``Dense(dtype=f32)`` on f32 inputs, kept f32 even where the
    matmul weights are bf16), and the expert stacks ``w1``/``w3``
    [E, D, F] and ``w2`` [E, F, D] in ``store_dtype``, cast to ``dtype``
    at every use as flax casts its params; F/tp hidden units of each
    under a ``mesh`` with tp > 1.  A mesh with ep > 1 raises
    NotImplementedError, an object that is not a mesh TypeError."""

    # Token-chunk size of drop-free dispatch (the JAX NO_DROP_CHUNK): the
    # [T, E, C] one-hots stay linear in T instead of [T, E, T].
    NO_DROP_CHUNK = 256

    def __init__(self, dim: int, ffn_dim: int, n_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype=torch.bfloat16, store_dtype=None,
                 param_dtype=torch.float32, mesh=None, device=None):
        super().__init__()
        if mesh is not None:
            refuse_axes(mesh, "MoEMLP")
        self.tp = tp = TensorParallel.of(mesh)
        if ffn_dim % tp.size:
            raise ValueError(f"ffn_dim {ffn_dim} not divisible by "
                             f"tp={tp.size}")
        ffn_dim //= tp.size
        store = store_dtype or dtype
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.router = nn.Linear(dim, n_experts, bias=False, device=device,
                                dtype=param_dtype)
        self.w1 = nn.Parameter(torch.empty(n_experts, dim, ffn_dim,
                                           device=device, dtype=store))
        self.w3 = nn.Parameter(torch.empty(n_experts, dim, ffn_dim,
                                           device=device, dtype=store))
        self.w2 = nn.Parameter(torch.empty(n_experts, ffn_dim, dim,
                                           device=device, dtype=store))
        self.last_routing = None

    @property
    def load_balancing(self):
        """The last forward's Switch load-balancing value (f32 scalar),
        or None before the first forward."""
        if self.last_routing is None:
            return None
        idx, probs = self.last_routing
        frac = F.one_hot(idx[:, 0], self.n_experts).float().mean(0)
        return self.n_experts * (frac * probs.mean(0)).sum()

    def forward(self, x, no_drop: bool = False):
        b, s, d = x.shape
        tokens, k = b * s, self.top_k
        xf = x.reshape(tokens, d)

        # Router in f32 (TF32 off, torch's default for matmuls).
        probs = torch.softmax(F.linear(xf.float(), self.router.weight), -1)
        # jax.lax.top_k puts the lower index first on a tie; torch.topk
        # does not promise it.  A tie needs two equal f32 probabilities,
        # which real inputs do not give.  The padded rows of drop-free
        # chunks take expert 0 twice (the JAX padding) after every real
        # token of their chunk: they cannot displace one, and are cut.
        gate, idx = torch.topk(probs, k, dim=-1)                 # [T, K]
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        self.last_routing = (idx, probs)

        w1, w3, w2 = (w.to(self.dtype) for w in (self.w1, self.w3, self.w2))
        # The expert products run on this rank's hidden units.
        xf, gate = copy_to_tp(xf, self.tp), copy_to_tp(gate, self.tp)
        chunk = self.NO_DROP_CHUNK
        if no_drop and tokens > chunk:
            # Pad to whole chunks; padded rows route somewhere and are
            # sliced off.  The chunks run in order (JAX: lax.map).
            pad = -tokens % chunk
            xf_p = F.pad(xf, (0, 0, 0, pad))
            gate_p = F.pad(gate, (0, 0, 0, pad))
            idx_p = F.pad(idx, (0, 0, 0, pad))
            out = torch.cat([
                self._dispatch(xf_p[i:i + chunk], gate_p[i:i + chunk],
                               idx_p[i:i + chunk], chunk, w1, w3, w2)
                for i in range(0, tokens + pad, chunk)])[:tokens]
        else:
            capacity = tokens if no_drop else max(
                1, int(self.capacity_factor * tokens * k / self.n_experts))
            out = self._dispatch(xf, gate, idx, capacity, w1, w3, w2)
        out = reduce_from_tp(out, self.tp).to(self.dtype)
        return out.reshape(b, s, d).to(x.dtype)

    def _dispatch(self, xf, gate, idx, capacity: int, w1, w3, w2):
        """GShard dispatch, expert products and combine for one block of
        T tokens at ``capacity`` slots per expert -> [T, D] in f32 (this
        rank's part under tp), rounded by the caller."""
        t, k, e, dt = xf.shape[0], self.top_k, self.n_experts, self.dtype
        onehot = F.one_hot(idx, e)                               # [T, K, E]
        # Position of each assignment in its expert's buffer: a cumsum
        # over the token-major [T*K, E] one-hot (k inside t), minus 1.
        position = ((onehot.reshape(t * k, e).cumsum(0).reshape(t, k, e)
                     - 1) * onehot).sum(-1)                      # [T, K]
        keep = position < capacity                               # drops
        # one_hot of a position past capacity is all zeros (jax.nn.one_hot)
        pos_onehot = (position[..., None] == torch.arange(
            capacity, device=xf.device)).to(dt)                  # [T, K, C]
        masked = onehot.to(dt) * keep[..., None].to(dt)
        # sel[t, k] is one-hot over the E*C buffer slots: where assignment
        # (t, k) sits, zeros if it was dropped.  The JAX dispatch tensor
        # [T, E, C] is its sum over k (a token routes an expert once).
        sel = torch.einsum("tke,tkc->tkec", masked, pos_onehot)
        disp = sel.sum(1)                                        # [T, E, C]
        expert_in = torch.einsum("td,tec->ecd", xf.to(dt), disp)  # [E, C, D]
        h = F.silu(torch.bmm(expert_in, w1)) * torch.bmm(expert_in, w3)
        expert_out = torch.bmm(h, w2)                            # [E, C, D]
        # Combine: each assignment's output row is picked by a one-hot
        # product (one nonzero term per sum, exact in any order), then
        # weighted by its gate rounded to dtype (as JAX rounds it) and
        # the top_k terms summed in f32 and rounded once: the JAX combine
        # einsum with f32 accumulation.  A token's output thus does not
        # depend on where the buffers place it (with which other tokens
        # it is served), as one [T, E*C] product of gated one-hots would,
        # which sums its terms in the order of the kernel's tiles.
        picked = torch.einsum("tkec,ecd->tkd", sel, expert_out)  # [T, K, D]
        return (gate.to(dt).float()[..., None] * picked.float()).sum(1)


def init_expert_stack_(w: torch.Tensor, generator: torch.Generator):
    """Fill an expert stack [E, fan_in, fan_out] as flax's
    ``lecun_normal(in_axis=-2, out_axis=-1, batch_axis=(0,))`` draws it:
    a normal truncated to two standard deviations, scaled to variance
    1/fan_in (the truncation's std 0.8796... divided out).  Drawn in f32
    on the generator's device, which must be ``w``'s."""
    std = 1.0 / math.sqrt(w.shape[-2]) / 0.87962566103423978
    lo, hi = (0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in (-2, 2))
    u = torch.rand(w.shape, generator=generator, device=w.device,
                   dtype=torch.float32)
    z = u.mul_(hi - lo).add_(lo).mul_(2).sub_(1).erfinv_()
    w.copy_(z.mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std))
    return w
