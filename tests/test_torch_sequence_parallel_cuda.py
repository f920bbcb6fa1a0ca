"""Ring attention of the port across two cards (NCCL) on the flash
kernels, against the plain version of the same ring.

Needs at least two CUDA cards: marked ``cuda``, skipped with fewer (and
here, on the CPU).  This file imports no JAX, so it runs on the card's
machine: ``python -m pytest -m cuda
tests/test_torch_sequence_parallel_cuda.py``.  Two ranks
(``tests/torch_dist_worker.py sp_cuda_ring DIR cuda``) run
``ring_attention`` at sp = 2 on bf16 q, k, v [2, 2 x 1024, 8, 128]
from a seed, with ``impl="flash"`` and with ``impl="dense"`` (the plain
f32 product per chunk).  Held on each rank: the output and dq, dk, dv
of the flash ring within chip_smoke.py's bf16 flash limits of the plain
ring's (per (row, head), the largest error over the largest |plain
value|: 2e-2 forward, 5e-2 gradients), and K1', K2' and K3' each
launched r + 1 times on sp rank r (the causal ring: the diagonal chunk
and the chunks behind it; the chunk ahead launches nothing).
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
FWD_LIMIT, GRAD_LIMIT = 2e-2, 5e-2      # chip_smoke.FLASH_LIMITS, bf16


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL across cards)")


def _rel_err(got, want):
    """Per (row, head) of [B, S, H, D], the largest error over the
    largest |want|; the worst."""
    err = (got - want).abs().amax(dim=(1, 3))
    return (err / want.abs().amax(dim=(1, 3))).max().item()


@pytest.mark.cuda
def test_cuda_ring_attention_on_the_flash_kernels(two_cards, tmp_path):
    torch.save({"shape": (2, 2048, 8, 128)}, tmp_path / "inputs.pt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, "sp_cuda_ring", str(tmp_path), "cuda"],
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
    for r in range(2):
        res = torch.load(tmp_path / f"sp_cuda_ring.rank{r}.pt",
                         weights_only=False)
        assert res["sp_rank"] == r
        assert res["launches"] == {"flash_fwd": r + 1, "flash_bwd_dq": r + 1,
                                   "flash_bwd_dkv": r + 1}
        assert _rel_err(*res["out"]) <= FWD_LIMIT
        for got, want in res["grads"]:
            assert _rel_err(got, want) <= GRAD_LIMIT
