"""Serving of the port across two cards (NCCL) against one card: tensor
parallel, and the weights cut over fsdp.

Needs at least two CUDA cards: marked ``cuda``, skipped with fewer (and
here, on the CPU).  This file imports no JAX, so it runs on the card's
machine: ``python -m pytest -m cuda
tests/test_torch_tensor_parallel_cuda.py``.  Two ranks
(``tests/torch_dist_worker.py tp_cuda_serving DIR cuda``) serve
llama2_tiny in bf16 (weights from a seed, head dim 64) at tp = 2 through
``InferenceServer(mesh=)`` with the paged pool; rank 0 also serves the
one-card model.  Held: each prompt's prefill logits within 5e-2 of the
largest one-card logit (bf16 partial sums, one f32 all-reduce), the
greedy streams equal to one card's, and on each rank K4' launches ==
decode steps x n_layers (K4' runs on the rank's heads).  At fsdp = 2
(``tests/torch_dist_worker.py fsdp_cuda_gather DIR cuda``) each unit
gathered over NCCL equals the plain cut of the one-card weights bit for
bit, and the logits, streams and K4' launches are held the same way.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
LOGIT_LIMIT = 5e-2          # chip_smoke.py's tensor-parallel phase


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL across cards)")


def _two_ranks(scenario, tmp_path):
    """Run ``scenario`` on two ranks (one card each); their results."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, n).tolist() for n in (5, 17, 40, 90)]
    torch.save({"config": {"dim": 128, "n_heads": 2}, "prompts": prompts},
               tmp_path / "inputs.pt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, scenario, str(tmp_path), "cuda"],
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
    return [torch.load(tmp_path / f"{scenario}.rank{r}.pt",
                       weights_only=False) for r in range(2)]


@pytest.mark.cuda
def test_cuda_fsdp2_gather_is_the_plain_cut(two_cards, tmp_path):
    got = _two_ranks("fsdp_cuda_gather", tmp_path)
    for res in got:
        assert res["backend"] == "nccl"
        assert res["units_equal"] and res["units"] == 4
        assert res["gather_ms"] > 0
        one = res["one_logits"]
        err = ((res["logits"] - one).abs().amax(-1)
               / one.abs().amax(-1)).max().item()
        assert err <= LOGIT_LIMIT, err
        assert res["steps"] > 0
        assert res["launches"] == res["steps"] * res["n_layers"]
    assert got[0]["streams"] == got[0]["one_streams"]


@pytest.mark.cuda
def test_cuda_tp2_serving_matches_one_card(two_cards, tmp_path):
    got = _two_ranks("tp_cuda_serving", tmp_path)
    one = got[0]["one_logits"]
    for res in got:
        assert res["backend"] == "nccl"
        err = ((res["logits"] - one).abs().amax(-1)
               / one.abs().amax(-1)).max().item()
        assert err <= LOGIT_LIMIT, err
        assert res["steps"] > 0
        assert res["launches"] == res["steps"] * res["n_layers"]
    assert got[0]["streams"] == got[0]["one_streams"]
