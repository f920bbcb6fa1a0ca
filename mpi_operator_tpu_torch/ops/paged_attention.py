"""Paged decode attention: single-query attention over a block-pooled KV
cache.  Counterpart of ``mpi_operator_tpu/ops/paged_attention.py``.

``paged_decode_attention`` takes the plain PyTorch version
(``_torch_paged``, the counterpart of ``_xla_paged``) for tensors on the
CPU, and launches the hand-written CUDA kernel K4'
(``csrc/paged_attention.cu``) for tensors on the card, or raises.  There
is no fallback from the card to the plain version.

Layout, as in the JAX package: q [B, H, D]; pools [NB, page, KH, D];
block_table [B, MAXB] int32; lengths [B] int32 (valid tokens per row,
including the one just written); int8 pools carry scales [NB, page, KH]
f32 with x = q_int8 * scale.
"""

from __future__ import annotations

import ctypes
import math

import torch

# K4' launches by the wrapper (one per call that reached the card).
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.int8: 3}


def _torch_paged(q, pool_k, pool_v, block_table, lengths, scale,
                 k_scale=None, v_scale=None, window=None):
    """Plain version: dense gather + masked f32 softmax (the spec K4'
    is tested against)."""
    b, h, d = q.shape
    _, page, kh, _ = pool_k.shape
    maxb = block_table.shape[1]
    g = h // kh
    tbl = block_table.long()
    k_all = pool_k[tbl].reshape(b, maxb * page, kh, d)
    v_all = pool_v[tbl].reshape(b, maxb * page, kh, d)
    if k_scale is not None:
        k_all = k_all.float() * k_scale[tbl].reshape(
            b, maxb * page, kh)[..., None]
        v_all = v_all.float() * v_scale[tbl].reshape(
            b, maxb * page, kh)[..., None]
    if g > 1:
        k_all = k_all.repeat_interleave(g, dim=2)
        v_all = v_all.repeat_interleave(g, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float() * scale, k_all.float())
    pos = torch.arange(maxb * page, device=q.device)
    mask = pos[None, :] < lengths[:, None]                  # [B, L]
    if window is not None:
        # Query position is lengths-1; keys in [lengths - window, lengths).
        mask &= pos[None, :] >= lengths[:, None] - window
    s = s.masked_fill(~mask[:, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p, v_all.float())
    return out.to(q.dtype)


def _bind():
    from ._build import load

    lib = load("paged_attention")
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                       ci, ctypes.c_float, ci, ci, ci, vp]
        fn.restype = ci
        lib.paged_decode_smem_bytes.argtypes = [ci, ci, ci, ci]
        lib.paged_decode_smem_bytes.restype = ctypes.c_size_t
        lib.paged_decode_error_string.argtypes = [ci]
        lib.paged_decode_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_decode_attention (CUDA): {msg}")


def _cuda_paged(q, pool_k, pool_v, block_table, lengths, scale,
                k_scale=None, v_scale=None, window=None):
    """Launch K4' on q's device, on that device's current stream.
    Raises on anything the kernel does not take; never computes on
    another path."""
    global LAUNCHES
    b, h, d = q.shape
    nb, page, kh, _ = pool_k.shape
    int8 = k_scale is not None
    tensors = [q, pool_k, pool_v, block_table, lengths]
    if int8:
        tensors += [k_scale, v_scale]
    for t in tensors:
        _check(t.device == q.device, f"tensor on {t.device}, q on {q.device}")
        _check(t.is_contiguous(), "every input must be contiguous")
    _check(q.dtype in (torch.float32, torch.bfloat16, torch.float16),
           f"q dtype {q.dtype}")
    _check(pool_k.dtype == pool_v.dtype and pool_k.dtype in _DTYPE_CODES,
           f"pool dtypes {pool_k.dtype}/{pool_v.dtype}")
    _check((pool_k.dtype == torch.int8) == int8,
           "int8 pools need k_scale/v_scale, other pools take none")
    _check(pool_v.shape == pool_k.shape and pool_k.shape[3] == d,
           "pool shapes")
    if int8:
        _check(k_scale.dtype == v_scale.dtype == torch.float32
               and tuple(k_scale.shape) == (nb, page, kh)
               and tuple(v_scale.shape) == (nb, page, kh),
               "scales must be f32 [NB, page, KH]")
    _check(block_table.dtype == torch.int32 and block_table.dim() == 2
           and block_table.shape[0] == b,
           "block_table must be int32 [B, MAXB]")
    _check(lengths.dtype == torch.int32 and tuple(lengths.shape) == (b,),
           "lengths must be int32 [B]")
    _check(d % 32 == 0 and d <= 256, f"head_dim {d} must be a multiple "
           f"of 32 up to 256")
    g = h // kh
    _check(g * d <= 8192, f"group {g} x head_dim {d} exceeds 8192")
    for t in (q, pool_k, pool_v):
        _check(t.data_ptr() % 16 == 0, "q and pools must be 16-byte aligned")
    _check(window is None or window >= 1, f"window {window}")
    lib = _bind()
    pool_code = _DTYPE_CODES[pool_k.dtype]
    _check(lib.paged_decode_smem_bytes(g, d, block_table.shape[1],
                                       pool_code) > 0,
           f"group {g} x head_dim {d} x {block_table.shape[1]} table "
           f"entries exceed the kernel's shared memory")
    out = torch.empty_like(q)
    # The kernel launches on the current device: make it q's, so a
    # model on a card that is not the current one launches there.
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_decode_attention(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            k_scale.data_ptr() if int8 else None,
            v_scale.data_ptr() if int8 else None,
            block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, kh, g, d, page, block_table.shape[1], float(scale),
            int(window or 0), _DTYPE_CODES[q.dtype], pool_code, stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"{lib.paged_decode_error_string(rc).decode()}")
    LAUNCHES += 1
    return out


def paged_decode_attention(q, pool_k, pool_v, block_table, lengths,
                           scale=None, k_scale=None, v_scale=None,
                           window=None):
    """One decode step of attention against a paged KV pool.

    - q: [B, H, D] — this step's queries.
    - pool_k / pool_v: [NB, page, KH, D] shared block pools.
    - block_table: [B, MAXB] int32 — logical block j of row b lives in
      pool block ``block_table[b, j]``.
    - lengths: [B] int32 — valid tokens per row including the one just
      written (positions at and past a row's length are masked; a
      length past MAXB*page reads no further than the table's end).
    - k_scale / v_scale: [NB, page, KH] f32, present iff the pools are
      int8.
    - window: sliding window; keys in [length - window, length).

    CPU tensors take the plain version; CUDA tensors launch K4'."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    h = q.shape[1]
    kh = pool_k.shape[2]
    if h % kh:
        raise ValueError(f"n_heads {h} not a multiple of kv_heads {kh}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale go together")
    if q.device.type == "cpu":
        return _torch_paged(q, pool_k, pool_v, block_table, lengths, scale,
                            k_scale=k_scale, v_scale=v_scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    return _cuda_paged(q, pool_k, pool_v, block_table, lengths, scale,
                       k_scale=k_scale, v_scale=v_scale, window=window)
