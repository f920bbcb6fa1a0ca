"""The 1F1B pipeline of the port across two cards (NCCL) through the flash
kernels, against the plain attention on the same pipeline.

Needs at least two CUDA cards: marked ``cuda``, skipped with fewer (and
here, on the CPU).  This file imports no JAX, so it runs on the card's
machine: ``python -m pytest -m cuda tests/test_torch_pipeline_cuda.py``.
Two ranks (``tests/torch_dist_worker.py pp_cuda DIR cuda``) run
``pipeline_loss_and_grads_1f1b`` at pp = 2 on a 4-layer llama2_tiny in
bf16 (f32 weights from the port's ``init_params`` at a seed), M = 4
microbatches of one row, once with ``attention_impl="xla"`` (the plain
attention) and once with ``"auto"`` (K1'-K3', the head dim 32 padded to
64).  Held on each rank: the loss within 2e-2 and every gradient leaf,
joined from both stages, within 5e-2 of its largest |plain value|
(chip_smoke.py's bf16 flash limits), and K1' launched 2·M·L/P times
(each F slot and each B slot's recompute), K2' and K3' M·L/P times.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
LOSS_LIMIT, GRAD_LIMIT = 2e-2, 5e-2     # chip_smoke.FLASH_LIMITS, bf16
M, N_LAYERS, WORLD = 4, 4, 2


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL across cards)")


@pytest.mark.cuda
def test_cuda_1f1b_runs_on_the_flash_kernels(two_cards, tmp_path):
    from mpi_operator_tpu_torch.models import llama as tl
    from mpi_operator_tpu_torch.models.params import init_params
    cfg = tl.llama2_tiny(n_layers=N_LAYERS)
    weights = init_params(cfg, torch.Generator().manual_seed(9), device="cpu",
                          dtype=torch.float32).state_dict()
    tokens = torch.randint(0, cfg.vocab_size, (M, 256),
                           generator=torch.Generator().manual_seed(10))
    torch.save({"pp_config": {"n_layers": N_LAYERS}, "pp_weights": weights,
                "pp_tokens": tokens, "pp_m": M}, tmp_path / "inputs.pt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, "pp_cuda", str(tmp_path), "cuda"],
        env=dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                 JAX_PROCESS_ID=str(r), JAX_NUM_PROCESSES=str(WORLD)),
        cwd=REPO) for r in range(WORLD)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0] * WORLD
    per_stage = M * N_LAYERS // WORLD
    for r in range(WORLD):
        res = torch.load(tmp_path / f"pp_cuda.rank{r}.pt", weights_only=False)
        assert res["stage"] == r
        flash, plain = res["runs"]["auto"], res["runs"]["xla"]
        assert flash["launches"] == {"flash_fwd": 2 * per_stage,
                                     "flash_bwd_dq": per_stage,
                                     "flash_bwd_dkv": per_stage}
        assert plain["launches"] == {k: 0 for k in plain["launches"]}
        assert abs(flash["loss"] - plain["loss"]) <= \
            LOSS_LIMIT * abs(plain["loss"])
        assert flash["grads"].keys() == plain["grads"].keys()
        for name, want in plain["grads"].items():
            err = (flash["grads"][name] - want).abs().max()
            assert err <= GRAD_LIMIT * want.abs().max(), name
