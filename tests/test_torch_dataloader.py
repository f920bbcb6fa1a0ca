"""The port's native token loader against the JAX package's.

Both wrap ``native/tpudata.cpp`` (the port builds its own copy under
``build/torch_native/``).  On the same token file, seed and process
split, the two give the same batches, over more than one epoch.  The
training example's ``--data`` runs 2 steps on the CPU through the
loader (the port of ``tests/test_examples.py::
test_llama_train_native_data_loader``), also with ``--config
mixtral-tiny``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from mpi_operator_tpu.native import dataloader as jdl
from mpi_operator_tpu_torch.native import dataloader as tdl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 1000-token file: 31 windows of 32 (the remainder dropped)."""
    path = str(tmp_path_factory.mktemp("tokens") / "corpus.bin")
    tdl.write_token_file(path, np.random.default_rng(0).integers(
        0, 256, 1000))
    return path


@pytest.mark.parametrize("process_id,num_processes,seed",
                         [(0, 1, 0), (0, 1, 7), (1, 3, 5), (2, 3, 5)])
def test_batches_equal_the_jax_loader(corpus, process_id, num_processes,
                                      seed):
    kw = dict(seq_len=32, batch=4, process_id=process_id,
              num_processes=num_processes, seed=seed)
    with tdl.NativeTokenLoader(corpus, **kw) as got, \
            jdl.NativeTokenLoader(corpus, **kw) as want:
        assert got.num_windows == want.num_windows
        local = got.num_windows // num_processes
        steps = 3 * local // 4 + 1            # past the second epoch
        for _ in range(steps):
            np.testing.assert_array_equal(got.next_batch(),
                                          want.next_batch())
        assert got.epoch == want.epoch >= 2


def test_write_token_file_matches_and_loader_guards(corpus, tmp_path,
                                                    monkeypatch):
    tokens = np.arange(70) % 13
    a, b = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    tdl.write_token_file(a, tokens)
    jdl.write_token_file(b, tokens)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert tdl.PROCESS_ID_ENV == "JAX_PROCESS_ID"
    assert tdl.NUM_PROCESSES_ENV == "JAX_NUM_PROCESSES"
    # The process split defaults to the operator's env.
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with tdl.NativeTokenLoader(corpus, seq_len=32, batch=2) as env, \
            tdl.NativeTokenLoader(corpus, seq_len=32, batch=2,
                                  process_id=1, num_processes=2) as named:
        np.testing.assert_array_equal(env.next_batch(), named.next_batch())
    loader = tdl.NativeTokenLoader(corpus, seq_len=32, batch=2)
    loader.close()
    with pytest.raises(RuntimeError, match="closed"):
        loader.next_batch()
    with pytest.raises(RuntimeError, match="cannot open"):
        tdl.NativeTokenLoader(str(tmp_path / "missing.bin"), 32, 2)
    assert tdl.library_path().parent.name == "torch_native"
    assert tdl.library_path().exists()


@pytest.mark.parametrize("config", ["tiny", "mixtral-tiny"])
def test_training_example_reads_data(corpus, config):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PROCESS_ID", "JAX_NUM_PROCESSES")}
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples",
                                      "llama_train_torch.py"),
         "--config", config, "--device", "cpu", "--steps", "2",
         "--seq-len", "32", "--batch", "2", "--data", corpus],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    loss = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("tokens/sec: ")]
    assert loss and np.isfinite(float(loss[0].split("loss=")[1]))
