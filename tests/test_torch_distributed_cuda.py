"""Data-parallel training of the port across cards (NCCL) against one
card.

Needs at least two CUDA cards: marked ``cuda``, skipped with fewer (and
here, on the CPU).  This file imports no JAX, so it runs on the card's
machine: ``python -m pytest -m cuda tests/test_torch_distributed_cuda.py``.
Two ranks (``tests/torch_dist_worker.py ... cuda``) form an NCCL group
from the operator's env and take three AdamW steps of llama2_tiny in
f32 at dp = 2; one process on card 0 takes the same steps on the whole
batch.  Losses, grad norms and parameters agree at 1e-5 (the CPU tests'
``STEP_TOL``; elements whose gradient came within rounding of zero are
held to 3 lr).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.models import llama as tl
from mpi_operator_tpu_torch.models.params import init_params
from mpi_operator_tpu_torch.parallel import train as ttrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
STEP_TOL = 1e-5
LR = 3e-4


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL across cards)")


@pytest.mark.cuda
def test_cuda_dp2_matches_one_card(two_cards, tmp_path):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tl.llama2_tiny(dim=128, n_heads=2)      # head_dim 64
    weights = init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu", dtype=torch.float32).state_dict()
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 64)))
    torch.save({"config": {"dim": 128, "n_heads": 2}, "weights": weights,
                "tokens": tokens}, tmp_path / "inputs.pt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, "cuda_dp", str(tmp_path), "cuda"],
        env=dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                 JAX_PROCESS_ID=str(r), JAX_NUM_PROCESSES="2"), cwd=REPO)
        for r in range(2)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0, 0]
    got = [torch.load(tmp_path / f"cuda_dp.rank{r}.pt", weights_only=False)
           for r in range(2)]

    model = tl.LlamaModel(cfg, device="cuda", store_dtype=torch.float32)
    model.load_state_dict(weights)
    init, step = ttrain.build_train_step(
        lambda m, b: tl.next_token_loss(m(b), b), ttrain.adamw(LR))
    state = init(model)
    want, smallest = [], {n: torch.full_like(p, float("inf"))
                          for n, p in model.named_parameters()}
    for _ in range(3):
        state, m = step(state, tokens.cuda())
        want.append((m["loss"].item(), m["grad_norm"].item()))
        for n, p in state.model.named_parameters():
            smallest[n] = torch.minimum(smallest[n], p.grad.abs())
    for res in got:
        assert res["backend"] == "nccl"
        np.testing.assert_allclose(res["dp"]["metrics"], want,
                                   atol=STEP_TOL, rtol=STEP_TOL)
        for n, p in state.model.named_parameters():
            ref = p.detach().cpu()
            sound = ((smallest[n] == 0) | (smallest[n] >= 1e-7)).cpu()
            np.testing.assert_allclose(res["dp"]["params"][n][sound].numpy(),
                                       ref[sound].numpy(), atol=STEP_TOL,
                                       rtol=STEP_TOL, err_msg=n)
            assert (res["dp"]["params"][n] - ref).abs().max() <= 3 * LR
