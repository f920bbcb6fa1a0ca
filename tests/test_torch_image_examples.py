"""The port's image-workload examples as MPIJob workers on the CPU:
``examples/resnet_benchmark_torch.py``, ``examples/mnist_train_torch.py``
and ``examples/elastic_train_torch.py`` started as real processes with
the operator's env and ``--device cpu`` (gloo), over one and two
processes, each job joined with a deadline; their output lines are the
JAX scripts'.  The elastic job scales 2 -> 1 through the discover-hosts
artifact and ends through a stop file, as tests/test_examples.py drives
the JAX one, with ResNet-50 at 32 x 32; the MLP workload re-forms in one
process and resumes from its checkpoint.
"""

import os
import re
import subprocess
import sys
import time

import pytest
import torch

from mpi_operator_tpu.utils.waiters import wait_until

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import REPO, join, launch  # noqa: E402

EXAMPLES = os.path.join(REPO, "examples")
DEADLINE_S = 150


def run(script, world, out_dir, *argv, **env):
    procs = launch([sys.executable, os.path.join(EXAMPLES, script),
                    "--device", "cpu", *argv], world, str(out_dir), **env)
    return join(procs, str(out_dir), DEADLINE_S)[0]


@pytest.mark.parametrize("world", [1, 2])
def test_resnet_benchmark_prints_images_per_second(tmp_path, world):
    out = run("resnet_benchmark_torch.py", world, tmp_path, "--model",
              "resnet50", "--image-size", "32", "--batch-per-device", "2",
              "--steps", "2", "--warmup", "1")
    total = re.search(r"total images/sec: (\S+)", out)
    chip = re.search(r"images/sec/chip: (\S+)", out)
    assert total and chip, out
    assert float(total.group(1)) > 0
    assert abs(float(chip.group(1)) * world - float(total.group(1))) < 0.02
    assert f"model=resnet50 world={world} " in out, out
    # The CPU prints no device metrics.
    assert "peak_memory_gb=n/a train_mfu=n/a" in out, out


@pytest.mark.parametrize("world", [1, 2])
def test_mnist_train_prints_the_jax_lines(tmp_path, world):
    out = run("mnist_train_torch.py", world, tmp_path, "--steps", "12",
              "--batch-per-device", "8")
    first = re.search(r"step=0 loss=(\S+)", out)
    done = re.search(rf"done processes={world} devices={world} "
                     rf"final_loss=(\S+)", out)
    assert first and "step=10 loss=" in out and done, out
    assert re.search(r"goodput=\S+ compile_s=\S+ steps_per_s=\S+", out), out
    assert float(done.group(1)) < float(first.group(1)), out


@pytest.mark.parametrize("script", ["resnet_benchmark_torch.py",
                                    "mnist_train_torch.py",
                                    "elastic_train_torch.py"])
def test_examples_without_a_card_or_device_cpu_raise(tmp_path, script):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    out = subprocess.run([sys.executable, os.path.join(EXAMPLES, script),
                          "--ckpt-dir", str(tmp_path)]
                         if script.startswith("elastic") else
                         [sys.executable, os.path.join(EXAMPLES, script)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr, out.stderr


def _pump(log_path, marker, deadline):
    """rank 0's log once it holds ``marker`` (by ``deadline``)."""
    def text():
        return open(log_path).read() if os.path.exists(log_path) else ""

    return wait_until(lambda: marker in text() and text(),
                      timeout=max(deadline - time.monotonic(), 0.1),
                      interval=0.1, desc=repr(marker), on_timeout=text)


def test_elastic_resnet50_scales_two_to_one(tmp_path):
    mpi_dir = tmp_path / "mpi"
    mpi_dir.mkdir()
    hosts = mpi_dir / "discover_hosts.sh"
    hosts.write_text("#!/bin/sh\necho h0\necho h1\n")
    stop = tmp_path / "stop"
    procs = launch([sys.executable, os.path.join(EXAMPLES,
                                                 "elastic_train_torch.py"),
                    "--device", "cpu", "--model", "resnet50",
                    "--image-size", "32", "--batch", "4", "--steps", "500",
                    "--poll", "0.05", "--ckpt-dir", str(tmp_path / "ckpt"),
                    "--stop-file", str(stop)], 2, str(tmp_path),
                   K_MOUNT_MPI=str(mpi_dir))
    log0 = str(tmp_path / "rank0.log")
    deadline = time.monotonic() + DEADLINE_S
    try:
        _pump(log0, "ELASTIC-TRAIN-START world=2 resume=None", deadline)
        hosts.write_text("#!/bin/sh\necho h0\n")     # scale down 2 -> 1
        text = _pump(log0, "WORLD-CHANGE", deadline)
        changed = re.search(r"WORLD-CHANGE step=(\d+) old=2 new=1 "
                            r"restored=True", text)
        assert changed, text
        time.sleep(0.5)                 # a few steps on the new world
    finally:
        stop.write_text("")
        out = join(procs, str(tmp_path), DEADLINE_S)[0]
    ok = re.search(r"ELASTIC-TRAIN-OK steps=(\d+) worlds=2->1 "
                   r"final_loss=(\S+)", out)
    assert ok, out
    assert int(ok.group(1)) > int(changed.group(1))
    assert float(ok.group(2)) == float(ok.group(2))      # not nan


def test_elastic_mlp_reforms_and_resumes_in_one_process(tmp_path):
    mpi_dir = tmp_path / "mpi"
    mpi_dir.mkdir()
    hosts = mpi_dir / "discover_hosts.sh"
    hosts.write_text("#!/bin/sh\necho h0\n")
    stop = tmp_path / "stop"
    argv = [sys.executable, os.path.join(EXAMPLES, "elastic_train_torch.py"),
            "--device", "cpu", "--model", "mlp", "--steps", "400",
            "--poll", "0.02", "--ckpt-dir", str(tmp_path / "ckpt"),
            "--stop-file", str(stop)]
    procs = launch(argv, 1, str(tmp_path), K_MOUNT_MPI=str(mpi_dir))
    deadline = time.monotonic() + DEADLINE_S
    try:
        _pump(str(tmp_path / "rank0.log"), "ELASTIC-TRAIN-START world=1",
              deadline)
        hosts.write_text("#!/bin/sh\necho h0\necho h1\n")   # 1 -> 2 hosts
        _pump(str(tmp_path / "rank0.log"), "WORLD-CHANGE", deadline)
    finally:
        stop.write_text("")
        out = join(procs, str(tmp_path), DEADLINE_S)[0]
    changed = re.search(r"WORLD-CHANGE step=(\d+) old=1 new=2 "
                        r"restored=True", out)
    assert changed and "worlds=1->2" in out, out
    # A restart resumes from the checkpoint the change wrote.
    stop.unlink()
    again = tmp_path / "again"
    again.mkdir()
    out = join(launch(argv[:argv.index("--steps") + 1]
                      + [str(int(changed.group(1)) + 3)]
                      + argv[argv.index("--steps") + 2:], 1, str(again),
                      K_MOUNT_MPI=str(mpi_dir)), str(again), DEADLINE_S)[0]
    assert f"resume={changed.group(1)}" in out, out
    assert f"ELASTIC-TRAIN-OK steps={int(changed.group(1)) + 3} " \
           f"worlds=2 " in out, out
