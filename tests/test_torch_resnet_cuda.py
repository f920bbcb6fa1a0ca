"""The port's ResNet on the card against the same model on the CPU
(``chip_smoke.py`` phase 13 (a) as a test): a tiny ResNet (stage sizes
(1, 1, 1, 1), width 16, 10 classes) at 32 x 32 in f32, its train-mode
logits (1e-4), the running statistics its forward leaves and three
SGD-momentum steps through ``build_train_step`` (losses, weights and
statistics at 1e-5), with TF32 off; and the bf16 config's logits within
2e-2 of the largest.  The cases are marked ``cuda`` and skip here; this
file imports no JAX.
"""

import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.models import resnet as tres
from mpi_operator_tpu_torch.parallel import train as ttrain

SEED = 11
LOGIT_TOL, STEP_TOL, BF16_TOL = 1e-4, 1e-5, 2e-2


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def config(dtype):
    return tres.ResNetConfig(stage_sizes=(1, 1, 1, 1), num_classes=10,
                             width=16, dtype=dtype)


def inputs(batch=8):
    rng = np.random.default_rng(SEED)
    return (torch.as_tensor(rng.standard_normal((batch, 32, 32, 3),
                                                dtype=np.float32)),
            torch.as_tensor(rng.integers(0, 10, (batch,))))


def run(device, weights, dtype=torch.float32, steps=3):
    images, labels = (t.to(device) for t in inputs())
    model = tres.ResNet(config(dtype), device=device)
    model.load_state_dict(weights)
    logits = model(images).detach().cpu()
    stats = {k: v.cpu().clone() for k, v in model.state_dict().items()
             if k.endswith((".mean", ".var"))}
    model.load_state_dict(weights)
    init, step = ttrain.build_train_step(
        lambda m, b: tres.cross_entropy_loss(m(b[0]), b[1]),
        ttrain.sgd(0.01, momentum=0.9))
    state = init(model)
    losses = [step(state, (images, labels))[1]["loss"].item()
              for _ in range(steps)]
    return logits, stats, losses, {k: v.cpu().clone() for k, v in
                                   model.state_dict().items()}


def weights_for(dtype):
    return tres.init_weights_(tres.ResNet(config(dtype), device="cpu"),
                              torch.Generator().manual_seed(SEED)
                              ).state_dict()


@pytest.mark.cuda
def test_cuda_tiny_resnet_matches_cpu(cuda_device):
    weights = weights_for(torch.float32)
    want = run("cpu", weights)
    got = run(cuda_device, weights)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for k, v in want[1].items():
        np.testing.assert_allclose(got[1][k].numpy(), v.numpy(),
                                   rtol=STEP_TOL, atol=STEP_TOL, err_msg=k)
    np.testing.assert_allclose(got[2], want[2], rtol=STEP_TOL, atol=STEP_TOL)
    for k, v in want[3].items():
        np.testing.assert_allclose(got[3][k].numpy(), v.numpy(),
                                   rtol=STEP_TOL, atol=STEP_TOL, err_msg=k)


@pytest.mark.cuda
def test_cuda_bf16_tiny_resnet_logits_match_cpu(cuda_device):
    weights = weights_for(torch.bfloat16)
    want = run("cpu", weights, torch.bfloat16, steps=1)[0]
    got = run(cuda_device, weights, torch.bfloat16, steps=1)[0]
    assert (got - want).abs().max().item() <= \
        BF16_TOL * want.abs().max().item()
