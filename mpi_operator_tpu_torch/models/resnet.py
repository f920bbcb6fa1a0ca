"""ResNet v1.5 (50/101) in PyTorch: counterpart of
``mpi_operator_tpu/models/resnet.py``, the throughput benchmark's model
(``tf_cnn_benchmarks --model=resnet101 --batch_size=64
--variable_update=horovod`` in the reference's job spec).

Images come in NHWC, as the JAX model takes them; ``x.permute(0, 3, 1,
2)`` of an NHWC tensor is an NCHW tensor in ``channels_last`` layout at
no copy, the layout cuDNN is fastest in, and every layer keeps it.
Weights are f32 (``param_dtype``) and cast to ``dtype`` (bf16 by
default) at every use, as flax's ``dtype`` does; logits are f32.

What the layers keep of flax:

- ``padding="SAME"`` pads (low, high) as ``lax.padtype_to_pads`` does
  (:func:`same_pads`): asymmetric for the 7x7 stride-2 stem at an even
  size (2, 3), the 3x3 stride-2 conv of a first block (0, 1) and the
  3x3 stride-2 max-pool (0, 1, with -inf), where torch's symmetric
  ``padding=`` would shift every output.
- :class:`BatchNorm` is flax's ``nn.BatchNorm(momentum=0.9,
  epsilon=1e-5)``: batch statistics reduced in f32, the biased variance
  (flax's ``mean(x^2) - mean(x)^2``; one Welford pass on one rank), the
  running averages
  ``ra = 0.9 ra + 0.1 stat`` (torch's ``F.batch_norm`` would keep the
  unbiased variance), the running statistics in eval mode, and a zero
  initial scale on each block's ``bn3``.  The JAX examples jit the step
  over a dp-sharded batch, so ``jnp.mean`` there reduces over the global
  batch (whatever the JAX docstring says of per-replica statistics);
  built with a mesh, a BatchNorm here does the same over the mesh's
  batch ranks (dp x fsdp): one all-reduce of the per-channel sums of x
  and x^2 and the count forward, one of the two per-channel gradient
  sums backward.
- Parameter and buffer names follow the flax tree (``conv_init``,
  ``bn_init``, ``stage{s}_block{b}.conv1`` ... ``downsample_bn``,
  ``head``; a BatchNorm's ``scale``, ``bias``, ``mean``, ``var``), so
  ``models.params.from_flax_resnet`` only transposes the kernels.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

_NHW = (0, 2, 3)                 # the reduced dims of an NCHW tensor
MOMENTUM = 0.9                   # flax nn.BatchNorm(momentum=0.9,
EPSILON = 1e-5                   #                   epsilon=1e-5)


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int]
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32


def resnet50_config(**kw) -> ResNetConfig:
    return ResNetConfig(stage_sizes=(3, 4, 6, 3), **kw)


def resnet101_config(**kw) -> ResNetConfig:
    return ResNetConfig(stage_sizes=(3, 4, 23, 3), **kw)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of one spatial dim under "SAME", as
    ``lax.padtype_to_pads``: the output has ceil(size / stride)
    positions and the odd pad goes to the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0):
    """``x`` padded for a SAME window, or (x, symmetric pad) when torch's
    own ``padding=`` gives the same result."""
    (h0, h1), (w0, w1) = (same_pads(n, kernel, stride) for n in x.shape[-2:])
    if h0 == h1 and w0 == w1 and value == 0.0:
        return x, (h0, w0)
    return F.pad(x, (w0, w1, h0, h1), value=value), (0, 0)


def max_pool_same(x: torch.Tensor, kernel: int, stride: int):
    """``nn.max_pool(x, (k, k), strides=(s, s), padding="SAME")``: -inf
    where flax pads."""
    x, _ = _same(x, kernel, stride, value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


class Conv(nn.Module):
    """``nn.Conv(features, (k, k), strides=(s, s))`` with flax's "SAME"
    padding on NCHW tensors: an OIHW weight (and bias) in
    ``param_dtype``, cast to ``dtype`` with the input at every call."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 bias: bool = False, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(torch.empty(
            out_ch, in_ch, kernel, kernel, dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(
            out_ch, dtype=param_dtype, device=device)) if bias else None

    def forward(self, x):
        x, padding = _same(x.to(self.dtype), self.kernel, self.stride)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias, self.stride,
                        padding)


class Dense(nn.Module):
    """``nn.Dense(features)``: a [out, in] weight (the transposed flax
    kernel) and a bias in ``param_dtype``, computed in ``dtype``."""

    def __init__(self, n_in: int, n_out: int, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(n_out, n_in,
                                               dtype=param_dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(n_out, dtype=param_dtype,
                                             device=device))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


def batch_group(mesh):
    """The sum over a mesh's batch ranks (dp x fsdp) that a BatchNorm's
    statistics take, or None when the mesh has one batch rank (its
    statistics are then the global ones).  Raises when the mesh's process
    group is missing or this rank is off the mesh: a BatchNorm built with
    a mesh never computes local statistics."""
    from ..parallel.mesh import BATCH_AXES
    from ..parallel.train import _AxesGroup

    if not dist.is_initialized():
        raise RuntimeError("a BatchNorm built with a mesh needs the mesh's "
                           "process group: call initialize_from_env first")
    if mesh.get_coordinate() is None:
        raise RuntimeError(f"rank {dist.get_rank()} is not on the mesh it "
                           f"builds a BatchNorm for")
    group = _AxesGroup(mesh, BATCH_AXES)
    return group if group.size > 1 else None


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode batch norm over the batch of ``group`` (this rank's
    batch when None), computed in f32 and returned in ``dtype``, with the
    batch mean and biased variance (not differentiable) beside it.

    Forward: this rank's mean and biased variance in one pass
    (``var_mean``); under a group, one all-reduce of the per-channel
    [sum x, sum x^2] and the count gives the global ones (flax's
    mean(x^2) - mean(x)^2, clipped at 0).  Backward: y = xhat * scale +
    bias, xhat = (x - mean) * rstd, so
    dx = scale * rstd * (dy - sum(dy) / N - xhat * sum(dy * xhat) / N)
    with both sums over the global batch of N positions (one all-reduce);
    dscale and dbias keep this rank's sums, which the train step averages
    over the batch ranks like every other gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, group, dtype):
        var, mean = torch.var_mean(x.float(), _NHW, correction=0)
        count = x.numel() // x.shape[1]
        if group is not None:
            sums = torch.cat([mean, var + mean * mean,
                              mean.new_ones(1)]) * count
            group.all_reduce_(sums)
            channels = x.shape[1]
            count = sums[-1]
            mean = sums[:channels] / count
            var = torch.clamp(sums[channels:2 * channels] / count
                              - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + EPSILON)
        y = torch.addcmul(_channel(bias), x - _channel(mean),
                          _channel(rstd * scale))
        ctx.save_for_backward(x, mean, rstd, scale)
        ctx.group, ctx.count = group, count
        ctx.mark_non_differentiable(mean, var)
        return y.to(dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, rstd, scale = ctx.saved_tensors
        xhat = (x - _channel(mean)) * _channel(rstd)
        dbias = dy.sum(_NHW, dtype=torch.float32)
        dscale = (dy * xhat).sum(_NHW)
        sums = torch.stack([dbias, dscale])
        if ctx.group is not None:
            ctx.group.all_reduce_(sums)
        k = scale * rstd
        sums = sums / ctx.count
        dx = torch.addcmul(_channel(-k * sums[0]),
                           torch.addcmul(dy, xhat, _channel(-sums[1])),
                           _channel(k))
        return dx.to(x.dtype), dscale, dbias, None, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=MOMENTUM, epsilon=EPSILON)`` over the
    channels of an NCHW tensor: batch statistics in train mode (over the
    global batch of ``mesh``'s batch ranks when built with one), the
    running ones in eval mode; f32 statistics and arithmetic, output in
    ``dtype``."""

    def __init__(self, features: int, dtype=torch.float32,
                 param_dtype=torch.float32, zero_scale: bool = False,
                 mesh=None, device=None):
        super().__init__()
        self.dtype = dtype
        init = torch.zeros if zero_scale else torch.ones
        self.scale = nn.Parameter(init(features, dtype=param_dtype,
                                       device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype,
                                             device=device))
        self.register_buffer("mean", torch.zeros(features,
                                                 dtype=torch.float32,
                                                 device=device))
        self.register_buffer("var", torch.ones(features, dtype=torch.float32,
                                               device=device))
        self.group = None if mesh is None else batch_group(mesh)

    def forward(self, x):
        if not self.training:
            mul = torch.rsqrt(self.var + EPSILON) * self.scale
            return ((x.float() - _channel(self.mean)) * _channel(mul)
                    + _channel(self.bias)).to(self.dtype)
        y, mean, var = _BatchNormTrain.apply(x, self.scale, self.bias,
                                             self.group, self.dtype)
        with torch.no_grad():                # m * ra + (1 - m) * stat
            self.mean.lerp_(mean, 1 - MOMENTUM)
            self.var.lerp_(var, 1 - MOMENTUM)
        return y


class BottleneckBlock(nn.Module):
    def __init__(self, in_ch: int, filters: int, strides: int,
                 cfg: ResNetConfig, mesh=None, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                  device=device)

        def norm(n, **extra):
            return BatchNorm(n, mesh=mesh, **kw, **extra)

        self.conv1 = Conv(in_ch, filters, 1, **kw)
        self.bn1 = norm(filters)
        self.conv2 = Conv(filters, filters, 3, strides, **kw)
        self.bn2 = norm(filters)
        self.conv3 = Conv(filters, filters * 4, 1, **kw)
        self.bn3 = norm(filters * 4, zero_scale=True)
        # flax adds the projection where the residual's shape differs.
        self.downsample = in_ch != filters * 4 or strides != 1
        if self.downsample:
            self.downsample_conv = Conv(in_ch, filters * 4, 1, strides, **kw)
            self.downsample_bn = norm(filters * 4)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """Images [B, H, W, 3] -> f32 logits [B, num_classes].  ``mesh``: the
    training mesh, whose batch ranks every BatchNorm reduces over."""

    def __init__(self, config: ResNetConfig, mesh=None, device=None):
        super().__init__()
        dev = torch.device("meta") if str(device) == "meta" else \
            resolve_device(device)
        cfg = self.config = config
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=dev)
        self.conv_init = Conv(3, cfg.width, 7, 2, **kw)
        self.bn_init = BatchNorm(cfg.width, mesh=mesh, **kw)
        self.block_names = []
        channels = cfg.width
        for stage, count in enumerate(cfg.stage_sizes):
            for block in range(count):
                name = f"stage{stage}_block{block}"
                strides = 2 if stage > 0 and block == 0 else 1
                filters = cfg.width * 2 ** stage
                self.add_module(name, BottleneckBlock(
                    channels, filters, strides, cfg, mesh, dev))
                self.block_names.append(name)
                channels = filters * 4
        self.head = Dense(channels, cfg.num_classes, **kw)

    def forward(self, images):
        x = images.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = max_pool_same(x, 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.head(x.mean(dim=(2, 3))).float()


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """flax's default kernel init: a normal truncated at two standard
    deviations, of variance 1 / fan_in after the truncation."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        torch.nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                    generator=generator)


def init_weights_(model: nn.Module, generator: torch.Generator):
    """flax's initialisers on a ResNet or MnistCNN in place: lecun normal
    kernels (in module order), zero biases, BatchNorm scales of one (zero
    on ``bn3``, set at construction), running mean 0 and variance 1.
    The draws follow flax's distributions, not its bits."""
    for module in model.modules():
        if isinstance(module, (Conv, Dense)):
            lecun_normal_(module.weight, generator)
            if module.bias is not None:
                with torch.no_grad():
                    module.bias.zero_()
    return model


def train_flops_per_image(model: nn.Module, image_size: int) -> float:
    """3 x the forward's 2 * k^2 * C_in * C_out * H_out * W_out over every
    Conv, plus 2 * C_in * C_out of every Dense, counted from the layers'
    own output shapes on one image (a forward in eval mode, under
    no_grad; the model's mode is restored)."""
    total = [0]

    def count(module, _inputs, out):
        if isinstance(module, Conv):
            k2 = module.kernel ** 2
            total[0] += 2 * k2 * module.weight.shape[1] * out[0].numel()
        else:
            total[0] += 2 * module.weight.numel()

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (Conv, Dense))]
    was_training = model.training
    param = next(model.parameters())
    try:
        model.eval()
        with torch.no_grad():
            model(torch.zeros(1, image_size, image_size, 3,
                              device=param.device))
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    return 3.0 * total[0]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor):
    """mean(logsumexp(logits) - logits[label]) in f32."""
    logits = logits.float()
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()
