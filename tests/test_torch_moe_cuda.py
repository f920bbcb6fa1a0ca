"""The MoE layer and a ``mixtral_tiny`` model on the card against the
plain path on the CPU.

The layer in bf16 over bf16 stacks (the serving layout), drop-free over
two chunks and with drops, within bf16's 2e-2; a ``mixtral_tiny`` f32
model's paged greedy generation byte-identical to the CPU's, and two
AdamW steps through the flash kernels (K1'-K3' launched once per layer
and step) with loss and grad_norm within 1e-4.  The cases are marked
``cuda`` and skip here; this file imports no JAX, so it runs on a
machine without flax.
"""

import importlib

import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.models import llama as tl
from mpi_operator_tpu_torch.models.params import init_params
from mpi_operator_tpu_torch.ops.moe import MoEMLP
from mpi_operator_tpu_torch.parallel import train as ttrain

fa = importlib.import_module("mpi_operator_tpu_torch.ops.attention")
SEED = 11


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_moe_layer_matches_cpu(cuda_device):
    gen = torch.Generator().manual_seed(SEED)
    cpu = MoEMLP(64, 128, 4, dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / 8)
    card = MoEMLP(64, 128, 4, dtype=torch.bfloat16, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 150, 64, generator=gen).bfloat16()
    for no_drop in (True, False):
        want = cpu(x, no_drop=no_drop).float()
        got = card(x.to(cuda_device), no_drop=no_drop).float().cpu()
        torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(card.load_balancing.cpu(),
                                   cpu.load_balancing, atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.cuda
def test_cuda_mixtral_tiny_generate_and_train_match_cpu(cuda_device):
    cfg = tl.mixtral_tiny(page_size=16)
    cpu = init_params(cfg, torch.Generator().manual_seed(SEED),
                      device="cpu", dtype=torch.float32)
    card = tl.LlamaModel(cfg, device=cuda_device, store_dtype=torch.float32)
    card.load_state_dict(cpu.state_dict())
    prompt = np.random.default_rng(SEED).integers(1, cfg.vocab_size, (3, 20))
    want = tl.generate(cpu, prompt, 10, prompt_lengths=[20, 7, 13])
    got = tl.generate(card, prompt, 10, prompt_lengths=[20, 7, 13]).cpu()
    assert torch.equal(got, want)

    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, 64)))
    rows = []
    for model, batch in ((cpu, tokens), (card, tokens.to(cuda_device))):
        init, step = ttrain.build_train_step(
            lambda m, b: tl.next_token_loss(m(b), b), ttrain.adamw(3e-4))
        state = init(model)
        before = dict(fa.LAUNCHES)
        metrics = []
        for _ in range(2):
            state, m = step(state, batch)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        rows.append(metrics)
        launched = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
    assert all(n == 2 * cfg.n_layers for n in launched.values()), launched
    np.testing.assert_allclose(rows[1], rows[0], atol=1e-4, rtol=1e-4)
