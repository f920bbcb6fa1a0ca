"""Ring attention over the 'sp' axis: counterpart of
``mpi_operator_tpu/ops/ring_attention.py``.

Sequence (context) parallelism for long sequences: each sp rank holds
the token columns [i*S/sp, (i+1)*S/sp) of q, k and v.  The queries stay
put while the K/V chunks travel round the ring (``n - 1`` rotations, no
wasted last one), and each chunk's attention is folded into a running
f32 (output, logsumexp) pair through the logsumexp composition of the
JAX ``_ring_body``.  No rank ever holds the [S, S] scores or the whole
sequence's K/V.

Causal dispatch by chunk position, as in JAX: the diagonal chunk (the
rank's own) attends causally, chunks behind it attend in full, and
chunks ahead of it are skipped.  JAX folds a skipped chunk as (zeros,
lse ``MASK_VALUE``), which leaves the pair unchanged bit for bit, and
its first fold onto (zeros, ``MASK_VALUE``) gives the diagonal chunk's
pair itself; so here a skipped chunk launches nothing and the first
chunk's pair is taken as it is.  The causal ring is unbalanced: sp rank
r computes r + 1 chunks.

Each chunk runs K1' (``impl="flash"``: ``ops/attention.py``'s forward
with an f32 output, the JAX ``_chunk_flash``) or the plain f32 product
(``"dense"``, the JAX ``_chunk_dense``); on the CPU both take the plain
version.  A head dim the kernels do not take (below 64) is zero-padded
to the next one at the original dim's scale, as ``attention`` pads it.

``jax.lax.ppermute`` becomes one batched ``isend``/``irecv`` exchange
over the sp group per rotation (``parallel.tensor.ring_shift``).
Autograd does not differentiate through point-to-point sends, so the
ring is one ``torch.autograd.Function``: its backward rotates the K/V
chunks again, with f32 dK/dV accumulators travelling beside them, and
runs K2' and K3' on every chunk that the forward computed, with the
final (output, lse) pair: P of a chunk recomputed from the global lse
is the chunk's part of the global softmax, so dQ sums over the chunks
and dK/dV of a chunk need nothing from the others.  That is the
gradient JAX's autodiff of its fold takes through the per-chunk lse
cotangents, in another order of f32 sums.  The backward's collectives
run on every rank of the ring in the same order (one ring backward per
layer), also when activation checkpointing runs the forward again.
"""

from __future__ import annotations

import math

import torch

from ..parallel.tensor import SequenceParallel, ring_shift
from . import attention as fa


def _chunk_forward(q, k, v, scale: float, causal: bool, impl: str):
    """(out f32, lse f32) of one chunk on [B, H, S/sp, D]."""
    if impl == "flash":
        return fa._flash_forward(q, k, v, scale, causal, out_f32=True)
    return fa._plain_forward(q, k, v, scale, causal)


def _chunk_backward(q, k, v, dout, lse, delta, scale: float, causal: bool,
                    impl: str):
    """(dq, dk, dv) of one chunk from the ring's (lse, delta): K2' and
    K3' on the card under ``impl="flash"``, else their plain versions."""
    if impl == "flash" and fa._on(q) == "cuda":
        return (fa._cuda_bwd_dq(q, k, v, dout, lse, delta, scale, causal),
                *fa._cuda_bwd_dkv(q, k, v, dout, lse, delta, scale,
                                  causal))
    return (fa._torch_bwd_dq(q, k, v, dout, lse, delta, scale, causal),
            *fa._torch_bwd_dkv(q, k, v, dout, lse, delta, scale, causal))


@torch.no_grad()
def _fold(o, lse, o_c, lse_c):
    """The JAX fold: compose two normalized partials through their
    logsumexps (``o`` is updated in place)."""
    m = torch.maximum(lse, lse_c)
    w_prev = torch.exp(lse - m)
    w_new = torch.exp(lse_c - m)
    norm = w_prev + w_new
    norm_safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    o.mul_((w_prev / norm_safe)[..., None]).add_(
        o_c * (w_new / norm_safe)[..., None])
    return o, m + torch.log(norm_safe)


def _computed(t: int, rank: int, n: int, causal: bool):
    """(whether rotation step ``t`` brings a chunk this rank attends to,
    whether that chunk is the diagonal one)."""
    src = (rank - t) % n
    return (not causal or src <= rank), (causal and src == rank)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sp, scale, causal, impl):
        n, rank = sp.size, sp.rank
        o = lse = None
        k_cur, v_cur = k, v
        for t in range(n):
            attend, diagonal = _computed(t, rank, n, causal)
            if attend:
                o_c, lse_c = _chunk_forward(q, k_cur, v_cur, scale,
                                            diagonal, impl)
                o, lse = (o_c, lse_c) if o is None else \
                    _fold(o, lse, o_c, lse_c)
            if t < n - 1:
                k_cur, v_cur = ring_shift([k_cur, v_cur], sp)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sp, ctx.scale, ctx.causal, ctx.impl = sp, scale, causal, impl
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        sp, scale, causal, impl = ctx.sp, ctx.scale, ctx.causal, ctx.impl
        n, rank = sp.size, sp.rank
        dout = dout.to(q.dtype).contiguous()
        delta = (dout.float() * out.float()).sum(-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        k_cur, v_cur = k, v
        for t in range(n):
            attend, diagonal = _computed(t, rank, n, causal)
            if attend:
                dq_c, dk_c, dv_c = _chunk_backward(
                    q, k_cur, v_cur, dout, lse, delta, scale, diagonal,
                    impl)
                dq += dq_c.float()
                dk += dk_c.float()
                dv += dv_c.float()
            # The accumulators travel with their chunk; after the last
            # step one more rotation brings each home.
            if t < n - 1:
                k_cur, v_cur, dk, dv = ring_shift([k_cur, v_cur, dk, dv],
                                                  sp)
            elif n > 1:
                dk, dv = ring_shift([dk, dv], sp)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def ring_attention(q, k, v, mesh, axis_name: str = "sp",
                   causal: bool = True, impl: str = "dense"):
    """Sequence-parallel attention on this rank's [B, S/sp, H, D] shards
    of q, k and v (its rows and heads under dp/fsdp/tp, its columns
    under sp) -> its shard of the attention of the global tensors, in
    q's dtype; differentiable.

    impl: 'dense' (the plain f32 product per chunk) or 'flash' (K1' per
    chunk, K2'/K3' in the backward, on the card; bf16 or f32, head dims
    up to 128, smaller ones padded).  ``mesh``: a ``parallel.mesh``
    mesh; every rank of its sp group calls this together."""
    if axis_name != "sp":
        raise ValueError(f"ring attention runs over 'sp', got {axis_name!r}")
    if impl not in ("dense", "flash"):
        raise ValueError(f"impl must be 'dense' or 'flash', got {impl!r}")
    if not q.shape == k.shape == v.shape:
        raise ValueError(f"ring_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"one shape [B, S/sp, H, D] (GQA repeated)")
    sp = SequenceParallel.of(mesh)
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if impl == "flash" and fa.flash_route(fa._on(q), q.dtype, d,
                                          "auto") == "pad":
        width = next(n for n in fa._HEAD_DIMS if n > d)
        qt, kt, vt = (torch.nn.functional.pad(x, (0, width - d))
                      for x in (qt, kt, vt))
    out = _RingAttention.apply(qt.contiguous(), kt.contiguous(),
                               vt.contiguous(), sp, scale, causal, impl)
    return out[..., :d].transpose(1, 2)
