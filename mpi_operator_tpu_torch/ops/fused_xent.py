"""Fused next-token cross-entropy: the [N, V] logits never materialize.
Counterpart of ``mpi_operator_tpu/ops/fused_xent.py``.

The loss streams vocab chunks: the forward folds an online (max, sumexp)
pair in f32 and picks the gold logit chunk by chunk; the backward
recomputes each chunk's logits and forms dlogits = (softmax - onehot) *
g / N.  Memory on the activation side drops from [N, V] to [N, chunk].
This is not a kernel (the JAX package wrote none either): the chunk
products are plain matrix products.

Under tensor parallelism (``tp``: the model's ``TensorParallel``, the
classifier vocabulary-parallel, each rank holding columns
[rank*V/tp, (rank+1)*V/tp)) each rank folds its own columns; the ranks'
maxima, rescaled sums and gold logits are then combined by three
all-reduces (Megatron's vocab-parallel cross-entropy, the reductions
GSPMD inserts for the JAX function), and the backward sums the ranks'
input gradients.  The value is the unsharded one up to the order of the
f32 sums.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

NEG_INF = -1e30


def _num_chunks(vocab: int, chunk: int) -> int:
    if vocab % chunk != 0:
        raise ValueError(f"vocab_size {vocab} not divisible by "
                         f"chunk {chunk}")
    return vocab // chunk


def _chunk_logits(x, w, c: int, chunk: int):
    """f32 logits of vocab chunk c: (x @ w[:, chunk c]) in x's dtype,
    then cast, as ``jnp.dot(x, wc).astype(f32)``."""
    return (x @ w[:, c * chunk:(c + 1) * chunk]).float()


class _FusedSoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, targets, chunk, tp):
        n = x.shape[0]
        m = torch.full((n,), NEG_INF, dtype=torch.float32, device=x.device)
        s = torch.zeros((n,), dtype=torch.float32, device=x.device)
        gold = torch.zeros((n,), dtype=torch.float32, device=x.device)
        # Targets relative to this rank's first column.
        tgt = targets.long() - (tp.rank * w.shape[1] if tp else 0)
        for c in range(_num_chunks(w.shape[1], chunk)):
            logits = _chunk_logits(x, w, c, chunk)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            # Rescale the running sum onto the new max (online logsumexp).
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(-1)
            m = m_new
            local = tgt - c * chunk
            inside = (local >= 0) & (local < chunk)
            picked = logits.gather(-1, local.clamp(0, chunk - 1)[:, None])
            gold = torch.where(inside, picked[:, 0], gold)
        if tp:
            # One rank holds each row's gold column; the others add 0.
            m_all = m.clone()
            dist.all_reduce(m_all, op=dist.ReduceOp.MAX, group=tp.group)
            s = s * torch.exp(m - m_all)
            dist.all_reduce(s, group=tp.group)
            dist.all_reduce(gold, group=tp.group)
            m = m_all
        logz = m + torch.log(s)
        ctx.save_for_backward(x, w, tgt, logz)
        ctx.chunk, ctx.tp = chunk, tp
        return (logz - gold).mean()

    @staticmethod
    def backward(ctx, g):
        x, w, tgt, logz = ctx.saved_tensors
        chunk = ctx.chunk
        n = x.shape[0]
        scale = (g / n).float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = []
        for c in range(_num_chunks(w.shape[1], chunk)):
            p = torch.exp(_chunk_logits(x, w, c, chunk) - logz[:, None])
            local = tgt - c * chunk
            inside = (local >= 0) & (local < chunk)
            onehot = torch.zeros_like(p)
            onehot.scatter_(-1, local.clamp(0, chunk - 1)[:, None],
                            inside[:, None].float())
            dl = ((p - onehot) * scale).to(x.dtype)
            dx += (dl @ w[:, c * chunk:(c + 1) * chunk].t()).float()
            dw.append(x.t() @ dl)                     # [D, chunk]
        if ctx.tp:
            # Each rank's columns give part of every row's gradient.
            dist.all_reduce(dx, group=ctx.tp.group)
        return (dx.to(x.dtype), torch.cat(dw, dim=1).to(w.dtype), None,
                None, None)


def fused_softmax_xent(x, w, targets, chunk: int = 4096, tp=None):
    """Mean cross-entropy of rows ``x`` [N, D] against ``targets`` [N]
    under the classifier ``w`` [D, V] — numerically
    ``mean(logsumexp((x @ w).float()) - take(logits, targets))`` with the
    logits materialized ``chunk`` columns at a time.  The products run
    in x's dtype; returns a scalar f32.  With ``tp`` (a
    ``TensorParallel`` of size > 1), ``w`` is this rank's [D, V/tp]
    columns and ``chunk`` divides V/tp (a collective over the group)."""
    return _FusedSoftmaxXent.apply(
        x, w, targets, chunk, tp if tp is not None and tp.size > 1 else None)


def fused_next_token_loss(hidden, out_kernel, tokens, chunk: int = 4096,
                          tp=None):
    """Shifted next-token mean cross-entropy from the PRE-head hidden
    states [B, S, D] (the model called with ``return_hidden=True``) and
    the output projection [D, V] (``model.output.weight`` transposed,
    cast to ``dtype``; this rank's columns under ``tp``, the model's
    ``TensorParallel``), with no [B, S, V] tensor."""
    b, s, d = hidden.shape
    x = hidden[:, :-1].reshape(b * (s - 1), d)
    targets = tokens[:, 1:].reshape(b * (s - 1))
    return fused_softmax_xent(x, out_kernel, targets, chunk, tp)
