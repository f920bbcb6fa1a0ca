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
mean router probability of e) over this rank's tokens, computed when
read from the routing of the last forward (``last_routing``: the expert
indices [T, K] and router probabilities [T, E]), which is kept detached:
a routing kept attached from a checkpoint's recompute would hold the
recomputed layer's activations until the next step.  Training does not
add it to the loss, as the JAX example drops that collection.

Under tensor parallelism (``mesh=`` with tp > 1; the JAX specs w1/w3
P("ep", "fsdp", "tp"), w2 P("ep", "tp", "fsdp")) each rank holds the
chunk of every expert's hidden units F/tp: ``w1``/``w3`` [E, D, F/tp],
``w2`` [E, F/tp, D].  The router stays replicated in f32, so every rank
routes the same tokens to the same experts from the same input, and the
combine is linear in the expert outputs: the ranks' f32 combines are
summed by one all-reduce before the single rounding.  In training the
gates enter the expert products through ``copy_to_tp``, so the router
sees the whole gradient of its gates.

Under expert parallelism (``mesh=`` with ep > 1; the JAX layer's
``_constrain_expert`` puts the expert buffers [E, C, D] on 'ep') each
rank holds experts [rank*E/ep, (rank+1)*E/ep) of the stacks.  The batch
is sharded over (dp, fsdp) only, so the ep ranks of a batch shard hold
the same tokens: every rank computes the whole routing (the router is
replicated, and the capacity positions come from the cumsum over all
experts, so the drops are the JAX layer's), dispatches to its own
experts only, and the ranks' f32 partial combines are summed by one
all-reduce over ep (``reduce_from_ep``) before the single rounding.
The input and the gates enter through ``copy_to_ep``, so each reaches
its whole gradient.  ep x tp composes: E over ep, F over tp.

When the tokens are sharded over the mesh (the batch over dp and fsdp,
the sequence over sp) the capacity and the drops are over the global
tokens, as the JAX layer sees the global batch, while each rank routes
and dispatches its own tokens only.  The ranks exchange, per row of
their tokens, how many assignments each expert took (one small integer
all-gather per axis), so each assignment learns its position in the
global token order (JAX's [B, S] flattened): the capacity C counts the
global tokens, and an assignment is dropped exactly when the JAX layer
drops it.  The kept assignments of an expert are the first of the
rank's own, so they take the first slots of a local buffer of min(C, T)
slots (T the rank's tokens): a rank's memory and expert products stop
growing with the number of batch and sequence ranks once C passes T.
A serving model (``batch_replicated``) holds the same batch on every
fsdp rank, so its capacity counts one copy of the tokens, as on one
card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tensor import (ExpertParallel, SequenceParallel,
                               TensorParallel, copy_to_ep, copy_to_tp,
                               reduce_from_ep, reduce_from_tp)


class MoEMLP(nn.Module):
    """Top-k routed SwiGLU experts on [B, S, D] activations.

    Parameters: ``router.weight`` [E, D] in ``param_dtype`` (f32: the JAX
    router is ``Dense(dtype=f32)`` on f32 inputs, kept f32 even where the
    matmul weights are bf16), and the expert stacks ``w1``/``w3``
    [E, D, F] and ``w2`` [E, F, D] in ``store_dtype``, cast to ``dtype``
    at every use as flax casts its params; F/tp hidden units of each
    under a ``mesh`` with tp > 1, E/ep experts with ep > 1.  The JAX
    layer takes any mesh and constrains only its expert buffers over
    'ep'; so does this one: a mesh's pp axis changes nothing (a pipeline
    stage builds its layers without a mesh, so each counts its capacity
    over the rows of one microbatch of its batch shard, as the JAX
    stages inside ``shard_map`` do).  ``batch_replicated``: the batch is
    the same on every fsdp rank (a serving model), so fsdp does not shard
    the tokens.  An object that is not a mesh raises TypeError."""

    # Token-chunk size of drop-free dispatch (the JAX NO_DROP_CHUNK): the
    # [T, E, C] one-hots stay linear in T instead of [T, E, T].
    NO_DROP_CHUNK = 256

    def __init__(self, dim: int, ffn_dim: int, n_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype=torch.bfloat16, store_dtype=None,
                 param_dtype=torch.float32, mesh=None, device=None,
                 batch_replicated: bool = False):
        super().__init__()
        self.tp = tp = TensorParallel.of(mesh)
        self.ep = ep = ExpertParallel.of(mesh)
        # The axes that shard the tokens: the columns over sp, the rows
        # over fsdp inside dp.
        self.token_shards = (SequenceParallel.of(mesh),
                             TensorParallel.of(None if batch_replicated
                                               else mesh, "fsdp"),
                             TensorParallel.of(mesh, "dp"))
        if ffn_dim % tp.size:
            raise ValueError(f"ffn_dim {ffn_dim} not divisible by "
                             f"tp={tp.size}")
        if n_experts % ep.size:
            raise ValueError(f"n_experts {n_experts} not divisible by "
                             f"ep={ep.size}")
        ffn_dim //= tp.size
        local = n_experts // ep.size
        # This rank's experts: [lo, lo + local).
        self.experts = (ep.rank * local, (ep.rank + 1) * local)
        store = store_dtype or dtype
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.router = nn.Linear(dim, n_experts, bias=False, device=device,
                                dtype=param_dtype)
        self.w1 = nn.Parameter(torch.empty(local, dim, ffn_dim,
                                           device=device, dtype=store))
        self.w3 = nn.Parameter(torch.empty(local, dim, ffn_dim,
                                           device=device, dtype=store))
        self.w2 = nn.Parameter(torch.empty(local, ffn_dim, dim,
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
        self.last_routing = (idx, probs.detach())

        w1, w3, w2 = (w.to(self.dtype) for w in (self.w1, self.w3, self.w2))
        # The expert products run on this rank's experts and hidden units.
        xf, gate = (copy_to_ep(copy_to_tp(t, self.tp), self.ep)
                    for t in (xf, gate))
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
        elif no_drop:
            out = self._dispatch(xf, gate, idx, tokens, w1, w3, w2)
        else:
            shards = math.prod(par.size for par in self.token_shards)
            capacity = max(1, int(self.capacity_factor * tokens * shards
                                  * k / self.n_experts))
            offset = self._global_offsets(idx, b) if shards > 1 else None
            out = self._dispatch(xf, gate, idx, capacity, w1, w3, w2,
                                 offset)
        out = reduce_from_ep(reduce_from_tp(out, self.tp), self.ep)
        return out.to(self.dtype).reshape(b, s, d).to(x.dtype)

    def _global_offsets(self, idx, rows: int):
        """[T, E]: what to add to the rank's own cumsum of each expert's
        assignments to get their positions in the global token order.
        For a row j of the rank's tokens: the assignments that the
        global order puts before the row's first token here (every
        earlier row of the global batch, then the columns of the sp
        ranks before this one), less the rank's own before row j."""
        e = self.n_experts
        counts = F.one_hot(idx, e).reshape(rows, -1, e).sum(1)   # [B, E]
        sp, fsdp, dp = self.token_shards
        every = counts
        for par in self.token_shards:              # -> [dp, fsdp, sp, B, E]
            every = par.gather(every[None], 0)
        ordered = every.permute(0, 1, 3, 2, 4)     # the global row order
        before = (ordered.reshape(-1, e).cumsum(0)
                  - ordered.reshape(-1, e)).reshape(ordered.shape)
        mine = before[dp.rank, fsdp.rank, :, sp.rank]             # [B, E]
        offset = mine - (counts.cumsum(0) - counts)
        return offset.repeat_interleave(idx.shape[0] // rows, 0)

    def _dispatch(self, xf, gate, idx, capacity: int, w1, w3, w2,
                  offset=None):
        """GShard dispatch, expert products and combine for one block of
        T tokens at ``capacity`` per expert -> [T, D] in f32 (this rank's
        part under tp and ep), rounded by the caller.  ``offset`` [T, E]
        places the assignments in the global token order
        (``_global_offsets``); None when the block is all the tokens."""
        t, k, e, dt = xf.shape[0], self.top_k, self.n_experts, self.dtype
        onehot = F.one_hot(idx, e)                               # [T, K, E]
        # Position of each assignment among its expert's: a cumsum over
        # the token-major [T*K, E] one-hot (k inside t), minus 1.
        cum = onehot.reshape(t * k, e).cumsum(0).reshape(t, k, e)
        slot = ((cum - 1) * onehot).sum(-1)                      # [T, K]
        position = slot if offset is None else \
            slot + (offset[:, None] * onehot).sum(-1)
        keep = position < capacity                               # drops
        # The kept assignments of an expert are the first of the block's
        # (positions grow with slots), so each sits at its slot, below
        # min(C, T): a token routes an expert once.  one_hot of a slot
        # past them is all zeros (jax.nn.one_hot).
        pos_onehot = (slot[..., None] == torch.arange(
            min(capacity, t), device=xf.device)).to(dt)          # [T, K, C]
        lo, hi = self.experts
        masked = (onehot.to(dt) * keep[..., None].to(dt))[:, :, lo:hi]
        # sel[t, k] is one-hot over this rank's E*C buffer slots: where
        # assignment (t, k) sits, zeros if it was dropped or its expert
        # lives on another ep rank.  The JAX dispatch tensor [T, E, C] is
        # its sum over k (a token routes an expert once).
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
