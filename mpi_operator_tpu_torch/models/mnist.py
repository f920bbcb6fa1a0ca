"""MNIST CNN (Horovod TF MNIST example parity: two conv layers and two
dense layers trained data-parallel): counterpart of
``mpi_operator_tpu/models/mnist.py``.

The 5x5 convs pad (2, 2) ("SAME" at stride 1), the max-pools are
"VALID", and ``fc1`` reads the flatten of an NHWC tensor: the model
flattens in (H, W, C) order, so the flax kernel only transposes
(``models.params.from_flax_mnist``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .resnet import Conv, Dense


class MnistCNN(nn.Module):
    """Images [B, 28, 28, 1] -> f32 logits [B, 10]."""

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__()
        dev = torch.device("meta") if str(device) == "meta" else \
            resolve_device(device)
        kw = dict(dtype=dtype, device=dev)
        self.conv1 = Conv(1, 32, 5, bias=True, **kw)
        self.conv2 = Conv(32, 64, 5, bias=True, **kw)
        self.fc1 = Dense(7 * 7 * 64, 1024, **kw)
        self.fc2 = Dense(1024, 10, **kw)

    def forward(self, images):
        x = images.permute(0, 3, 1, 2)          # NHWC -> channels_last NCHW
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (H, W, C)
        x = F.relu(self.fc1(x))
        return self.fc2(x).float()
