"""Fused RMSNorm: counterpart of ``mpi_operator_tpu/ops/rmsnorm.py``.

The forward runs as the hand-written CUDA kernel K5' (``csrc/rmsnorm.cu``,
replaces ``_rmsnorm_kernel``) for tensors on the card, and as its plain
PyTorch version for tensors on the CPU; there is no fallback from the
card to the plain version.  ``fused_rmsnorm`` is a
``torch.autograd.Function`` whose backward is the JAX package's ``_bwd``
in plain PyTorch from the saved rstd (the JAX package has no backward
kernel).  ``rmsnorm`` is the dispatcher.

No model calls it: the port's ``RMSNorm`` module computes the norm
inline, as the JAX model does.
"""

from __future__ import annotations

import ctypes

import torch

# K5' launches by the wrapper (one per call that reached the card); the
# plain version on the CPU counts nothing.
LAUNCHES = {"rmsnorm": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _plain_forward(x, scale, eps: float):
    """(y in x's type, rstd [...] f32): the plain version of what K5'
    writes, in f32 arithmetic."""
    xf = x.float()
    rstd = torch.rsqrt(xf.pow(2).mean(-1) + eps)
    return ((xf * rstd[..., None]) * scale.float()).to(x.dtype), rstd


def _plain_rmsnorm(x, scale, eps: float):
    """Plain version, the counterpart of ``_xla_rmsnorm``."""
    return _plain_forward(x, scale, eps)[0]


def _bind():
    from ._build import load

    lib = load("rmsnorm")
    if lib.rmsnorm_forward.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rmsnorm_forward.argtypes = [vp, vp, vp, vp, ctypes.c_longlong,
                                        ci, ctypes.c_float, ci, ci, ci, vp]
        lib.rmsnorm_forward.restype = ci
        lib.rmsnorm_error_string.argtypes = [ci]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_forward(x, scale, eps: float):
    """Launch K5' on x's device, on that device's current stream.  Raises
    on anything the kernel does not take; never computes on another
    path."""
    def check(cond, msg):
        if not cond:
            raise ValueError(f"rmsnorm (CUDA): {msg}")

    check(x.dtype in _DTYPE_CODES, f"dtype {x.dtype} (f32, bf16 or f16)")
    d = x.shape[-1]
    check(x.dim() >= 1 and d >= 1 and x.numel() > 0, "empty input")
    check(tuple(scale.shape) == (d,), f"scale shape {tuple(scale.shape)}, "
          f"want ({d},)")
    check(scale.device == x.device, f"scale on {scale.device}, x on "
          f"{x.device}")
    if scale.dtype not in (torch.float32, x.dtype):
        scale = scale.float()
    rows = x.numel() // d
    check(rows < 2 ** 31, f"{rows} rows")
    x2 = x.contiguous().view(rows, d)
    scale = scale.contiguous()
    y = torch.empty_like(x2)
    rstd = torch.empty((rows,), dtype=torch.float32, device=x.device)
    vec = int(x2.data_ptr() % 16 == y.data_ptr() % 16)
    lib = _bind()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.rmsnorm_forward(
            x2.data_ptr(), scale.data_ptr(), y.data_ptr(), rstd.data_ptr(),
            rows, d, float(eps), _DTYPE_CODES[x.dtype],
            int(scale.dtype == torch.float32), vec, stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: "
                           f"{lib.rmsnorm_error_string(rc).decode()}")
    LAUNCHES["rmsnorm"] += 1
    return y.view(x.shape), rstd.view(x.shape[:-1])


def _forward(x, scale, eps: float):
    """(y, rstd): K5' on the card, the plain version on the CPU."""
    if x.device.type == "cpu":
        return _plain_forward(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    return _cuda_forward(x, scale, eps)


class _FusedRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        out, rstd = _forward(x, scale, eps)
        ctx.save_for_backward(x, scale, rstd)
        return out

    @staticmethod
    def backward(ctx, g):
        """The JAX package's ``_bwd``: f32 from the saved rstd."""
        x, scale, rstd = ctx.saved_tensors
        xf, gf, sf = x.float(), g.float(), scale.float()
        r = rstd[..., None]
        xhat = xf * r
        dscale = (gf * xhat).sum(dim=tuple(range(x.dim() - 1)))
        gs = gf * sf
        dx = r * (gs - xhat * (gs * xhat).sum(-1, keepdim=True)
                  / x.shape[-1])
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def fused_rmsnorm(x, scale, eps: float = 1e-5):
    """RMSNorm on [..., d] with learned scale [d]; differentiable."""
    return _FusedRMSNorm.apply(x, scale, eps)


def rmsnorm(x, scale, eps: float = 1e-5, impl: str = "auto"):
    """Dispatcher, as the JAX package's: 'auto' is ``fused_rmsnorm`` for
    tensors on the card (K5') and the plain version elsewhere; 'pallas'
    is ``fused_rmsnorm`` (its forward is the plain version on the CPU);
    'xla' is the plain version."""
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"impl must be 'auto', 'pallas' or 'xla', got "
                         f"{impl!r}")
    if impl == "auto":
        impl = "pallas" if x.device.type == "cuda" else "xla"
    if impl == "pallas":
        return fused_rmsnorm(x, scale, eps)
    return _plain_rmsnorm(x, scale, eps)
