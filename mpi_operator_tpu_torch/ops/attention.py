"""Causal flash attention: counterpart of ``mpi_operator_tpu/ops/attention.py``.

The forward and both backward passes run as the hand-written CUDA kernels
of ``csrc/flash_attention.cu`` for tensors on the card:

- K1' ``flash_fwd``     (replaces ``_flash_fwd_kernel``),
- K2' ``flash_bwd_dq``  (replaces ``_flash_bwd_dq_kernel``),
- K3' ``flash_bwd_dkv`` (replaces ``_flash_bwd_dkv_kernel``).

For tensors on the CPU each wrapper takes its plain PyTorch version
instead (the same arithmetic on whole [S, S] matrices); there is no
fallback from the card to the plain version.  ``flash_attention`` and
``flash_attention_with_lse`` are ``torch.autograd.Function``s over the
wrappers; ``attention`` is the dispatcher on the model layout
[B, S, H, D].  The kernels take [B, H, S, D] (contiguous, head_dim 64 or
128, bf16 or f32; ``attention`` zero-pads smaller head dims) and any S: the ragged last tile is masked, where the
JAX kernel needs a block size that divides S.  In bf16, K1', K2' and K3'
are ``wgmma`` kernels for ``sm_90a`` (the source's header gives the
design); they use no atomics, so two calls on the same inputs give the
same bits.
"""

from __future__ import annotations

import ctypes
import math

import torch

# Launches of each kernel by its wrapper (one per call that reached the
# card); the plain versions on the CPU count nothing.
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

# Finite "minus infinity" of the JAX kernel (_MASK_VALUE): masked scores
# give exp() == 0 without inf/NaN; also the lse of an empty row.
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


# -- plain versions -----------------------------------------------------------

def _scores(q, k, scale: float, causal: bool, window=None):
    """f32 scores [B, H, S, S] with masked entries at -inf (the mask of
    ``_xla_attention``)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    if causal:
        q_pos = torch.arange(q.shape[2], device=q.device)
        k_pos = torch.arange(k.shape[2], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        s = s.masked_fill(~mask, float("-inf"))
    return s


def _plain_forward(q, k, v, scale: float, causal: bool, window=None):
    """(out f32, lse f32) on [B, H, S, D]: the plain version of K1'."""
    s = _scores(q, k, scale, causal, window)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()), lse


def _torch_attention(q, k, v, scale: float, causal: bool, window=None):
    """Plain attention returning (out in q's dtype, lse f32), the
    counterpart of ``_xla_attention``: the spec the kernels are tested
    against, differentiable by autograd."""
    out, lse = _plain_forward(q, k, v, scale, causal, window)
    return out.to(q.dtype), lse


def _plain_probs_grads(q, k, v, dout, lse, delta, scale: float,
                       causal: bool):
    """(P, dS) f32 [B, H, S, S], recomputed from the saved lse as the
    backward kernels do."""
    s = _scores(q, k, scale, causal)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta[..., None])


def _torch_bwd_dq(q, k, v, dout, lse, delta, scale: float, causal: bool):
    """Plain version of K2': dQ = dS K * scale, in q's dtype."""
    _, ds = _plain_probs_grads(q, k, v, dout, lse, delta, scale, causal)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale).to(
        q.dtype)


def _torch_bwd_dkv(q, k, v, dout, lse, delta, scale: float, causal: bool):
    """Plain version of K3': (dK = dS^T Q * scale, dV = P^T dO)."""
    p, ds = _plain_probs_grads(q, k, v, dout, lse, delta, scale, causal)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# -- kernels ------------------------------------------------------------------

def _bind():
    from ._build import load

    lib = load("flash_attention")
    if lib.flash_fwd.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, cf, ci, ci,
                                  ci, vp]
        lib.flash_bwd_dq.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                     cf, ci, ci, vp]
        lib.flash_bwd_dkv.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                      ci, cf, ci, ci, vp]
        for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv):
            fn.restype = ci
        lib.flash_error_string.argtypes = [ci]
        lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(name: str, tensors, q) -> None:
    def check(cond, msg):
        if not cond:
            raise ValueError(f"{name} (CUDA): {msg}")

    check(q.dim() == 4, f"q must be [B, H, S, D], got {tuple(q.shape)}")
    check(q.dtype in _DTYPE_CODES, f"dtype {q.dtype} (bf16 or f32)")
    check(q.shape[-1] in _HEAD_DIMS, f"head_dim {q.shape[-1]} (64 or 128)")
    for t in tensors:
        check(t.device == q.device, f"tensor on {t.device}, q on {q.device}")
        check(t.is_contiguous(), "every input must be contiguous")
        check(t.data_ptr() % 16 == 0, "inputs must be 16-byte aligned")
    for t in tensors[:4]:
        check(t.shape == q.shape and t.dtype == q.dtype,
              "q, k, v (and dout) need one shape and dtype")


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_bind().flash_error_string(rc).decode()}")
    LAUNCHES[name] += 1


def _cuda_forward(q, k, v, scale: float, causal: bool, out_f32: bool):
    _check_inputs("flash_fwd", [q, k, v], q)
    b, h, s, d = q.shape
    lib = _bind()
    out = torch.empty(q.shape, dtype=torch.float32 if out_f32 else q.dtype,
                      device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    # Launch on q's device, so tensors on a card that is not the current
    # one are computed there.
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_fwd", lib.flash_fwd, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), lse.data_ptr(), b * h, s, d,
                float(scale), int(causal), _DTYPE_CODES[q.dtype],
                int(out_f32), stream)
    return out, lse


def _cuda_bwd_dq(q, k, v, dout, lse, delta, scale: float, causal: bool):
    _check_inputs("flash_bwd_dq", [q, k, v, dout, lse, delta], q)
    b, h, s, d = q.shape
    lib = _bind()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_bwd_dq", lib.flash_bwd_dq, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), b * h, s, d, float(scale),
                int(causal), _DTYPE_CODES[q.dtype], stream)
    return dq


def _cuda_bwd_dkv(q, k, v, dout, lse, delta, scale: float, causal: bool):
    _check_inputs("flash_bwd_dkv", [q, k, v, dout, lse, delta], q)
    b, h, s, d = q.shape
    lib = _bind()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_bwd_dkv", lib.flash_bwd_dkv, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, s, d,
                float(scale), int(causal), _DTYPE_CODES[q.dtype], stream)
    return dk, dv


def _on(t) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention: unsupported device {t.device}")
    return t.device.type


def _flash_forward(q, k, v, scale: float, causal: bool,
                   out_f32: bool = False):
    """q, k, v [B, H, S, D] -> (out [B, H, S, D] in q's dtype, or f32
    when ``out_f32``; lse [B, H, S] f32).  K1' on the card."""
    if _on(q) == "cpu":
        out, lse = _plain_forward(q, k, v, scale, causal)
        return out if out_f32 else out.to(q.dtype), lse
    return _cuda_forward(q, k, v, scale, causal, out_f32)


def _flash_backward(q, k, v, out, lse, dout, scale: float, causal: bool,
                    dlse=None):
    """(dq, dk, dv) on [B, H, S, D].  delta = rowsum(dO o O) - dlse is
    computed here in f32, outside the kernels, as the JAX package does
    (d lse_i / d s_ij = p_ij folds the lse cotangent into delta).  K2'
    and K3' on the card; the cotangent is made contiguous and cast to
    q's dtype before the launch."""
    delta = (dout.float() * out.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    if _on(q) == "cpu":
        dq = _torch_bwd_dq(q, k, v, dout, lse, delta, scale, causal)
        dk, dv = _torch_bwd_dkv(q, k, v, dout, lse, delta, scale, causal)
        return dq, dk, dv
    dout = dout.to(q.dtype).contiguous()
    lse, delta = lse.contiguous(), delta.contiguous()
    dq = _cuda_bwd_dq(q, k, v, dout, lse, delta, scale, causal)
    dk, dv = _cuda_bwd_dkv(q, k, v, dout, lse, delta, scale, causal)
    return dq, dk, dv


def _scale_of(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = _flash_forward(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, out, lse, dout, ctx.scale,
                                     ctx.causal)
        return dq, dk, dv, None, None


class _FlashAttentionWithLse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = _flash_forward(q, k, v, scale, causal, out_f32=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:                  # only lse was used
            dout = torch.zeros_like(out)
        dq, dk, dv = _flash_backward(q, k, v, out, lse, dout, ctx.scale,
                                     ctx.causal, dlse=dlse)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, scale=None, causal: bool = True):
    """Flash attention on [B, H, S, D] tensors; differentiable."""
    return _FlashAttention.apply(q, k, v, _scale_of(q, scale), causal)


def flash_attention_with_lse(q, k, v, scale=None, causal: bool = True):
    """(out f32, lse f32) on [B, H, S, D] — the composable form ring
    attention folds across chunks; differentiable including lse (a
    missing lse cotangent counts as zero)."""
    return _FlashAttentionWithLse.apply(q, k, v, _scale_of(q, scale),
                                        causal)


def flash_route(device_type: str, dtype, head_dim: int, impl: str) -> str:
    """How ``attention`` computes: "plain" (the plain version), "kernel"
    (K1'-K3' as they are) or "pad" (K1'-K3' at the next head_dim of
    ``_HEAD_DIMS``, the input zero-padded to it).

    CPU tensors and 'xla' take the plain version.  On the card 'pallas'
    takes the kernels' own head dims, 64 and 128; 'auto' also pads any
    smaller head_dim (the tiny configs' 16 and 32), as the JAX 'auto'
    runs its kernel on a TPU at any head_dim.  Under 'auto' and 'pallas'
    a CUDA tensor never takes the plain version: what the kernels cannot
    take (a dtype other than bf16 or f32, a head_dim above 128, 'pallas'
    off 64 and 128) raises ValueError."""
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"impl must be 'auto', 'pallas' or 'xla', got "
                         f"{impl!r}")
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention: unsupported device "
                         f"{device_type}")
    if device_type == "cpu" or impl == "xla":
        return "plain"
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"attention(impl={impl!r}) on the card: the "
                         f"kernels take bf16 or f32, got {dtype}")
    if head_dim in _HEAD_DIMS:
        return "kernel"
    if impl == "auto" and head_dim < _HEAD_DIMS[-1]:
        return "pad"
    raise ValueError(f"attention(impl={impl!r}) on the card: the kernels "
                     f"take head_dim 64 or 128 ('auto' pads smaller ones), "
                     f"got head_dim {head_dim}")


def _flash_padded(q, k, v, causal: bool):
    """``flash_attention`` on [B, H, S, D] at a head_dim below 128 that is
    not one of ``_HEAD_DIMS``, through the kernels at the next of them.
    Zero columns add nothing to a score and give zero output columns, so
    with D's own scale the first D columns are the result; autograd drops
    the padding's gradients."""
    d = q.shape[-1]
    width = next(n for n in _HEAD_DIMS if n > d)
    qp, kp, vp = (torch.nn.functional.pad(x, (0, width - d))
                  for x in (q, k, v))
    out = flash_attention(qp, kp, vp, 1.0 / math.sqrt(d), causal)
    return out[..., :d]


def attention(q, k, v, causal: bool = True, impl: str = "auto",
              mesh=None, window=None):
    """Dispatcher on [B, S, H, D] (model layout).

    impl: 'auto' and 'pallas' launch the kernels for tensors on the
    card, 'auto' zero-padding a head_dim below 128 to the next one they
    take; 'xla' asks for the plain version.  Tensors on the CPU always
    take the plain version; inputs the kernels cannot take raise
    (``flash_route``).  ``window`` (sliding-window attention, causal
    only) takes the plain version on every device: like the JAX package,
    there is no banded kernel, and an explicit 'pallas' is refused.

    ``mesh`` (a ``parallel.mesh`` mesh; the JAX version's shard_map with
    the batch over (dp, fsdp) and the heads over tp): one process drives
    one card, so q, k and v are already this rank's rows and its H/tp
    heads, and the kernels run on them as they are.  The mesh is checked
    (its axes; q, k and v holding the same heads).  With sp > 1 they are
    also this rank's token columns [B, S/sp, H/tp, D], and its shard of
    the attention of the global tensors comes out through
    ``ops/ring_attention.py`` ('auto' and 'pallas' run the ring on the
    kernels, 'xla' on the plain product); a ``window`` then raises
    NotImplementedError, as the JAX model refuses sliding windows under
    ring attention."""
    sp = 1
    if mesh is not None:
        from ..parallel.mesh import AXIS_NAMES
        from ..parallel.tensor import refuse_axes
        sp = refuse_axes(mesh, "attention", allowed=AXIS_NAMES)["sp"]
        if not q.shape[:3] == k.shape[:3] == v.shape[:3]:
            raise ValueError(
                f"attention(mesh=): q {tuple(q.shape)}, k {tuple(k.shape)} "
                f"and v {tuple(v.shape)} must hold this rank's rows and "
                f"heads alike [B/(dp*fsdp), S, H/tp, D] (GQA repeated)")
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"impl must be 'auto', 'pallas' or 'xla', got "
                         f"{impl!r}")
    if window is not None:
        if not causal:
            raise ValueError("window requires causal attention")
        if impl == "pallas":
            raise ValueError(
                "sliding-window attention runs on the plain path; "
                "impl='pallas' has no banded kernel yet")
        impl = "xla"
    route = flash_route(_on(q), q.dtype, q.shape[-1], impl)
    if sp > 1:
        if window is not None:
            raise NotImplementedError(
                "sliding_window + sequence-parallel ring attention is not "
                "supported; run SWA models with sp=1")
        from .ring_attention import ring_attention
        return ring_attention(q, k, v, mesh, causal=causal,
                              impl="dense" if impl == "xla" else "flash")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if route == "plain":
        out, _ = _torch_attention(qt, kt, vt, 1.0 / math.sqrt(q.shape[-1]),
                                  causal, window=window)
    elif route == "pad":
        out = _flash_padded(qt, kt, vt, causal)
    else:
        out = flash_attention(qt.contiguous(), kt.contiguous(),
                              vt.contiguous(), None, causal)
    return out.transpose(1, 2)
