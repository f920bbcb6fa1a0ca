#!/usr/bin/env python
"""Data-parallel MNIST training of the PyTorch port: counterpart of
examples/mnist_train.py (Horovod TF MNIST parity) as an MPIJob
workload.  Every process joins the group the operator's env describes
(``bootstrap.initialize_from_env``: NCCL on the cards, gloo with
``--device cpu``), gradients are averaged over dp, and the step runs
through ``build_train_step`` with Adam and the goodput tracker.

    python examples/mnist_train_torch.py [--steps 50] [--device cpu]

Synthetic data (each process draws its own batch from a generator seeded
by its rank).  Rank 0 prints ``step=N loss=X`` every 10 steps, then
``goodput=... compile_s=... steps_per_s=...`` and ``done processes=N
devices=N final_loss=X``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch-per-device", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--device", default=None,
                        help="default: this process's card; 'cpu' for gloo")
    args = parser.parse_args()

    import torch
    import torch.distributed as dist

    from mpi_operator_tpu_torch import resolve_device
    from mpi_operator_tpu_torch.bootstrap import initialize_from_env
    from mpi_operator_tpu_torch.models.mnist import MnistCNN
    from mpi_operator_tpu_torch.models.resnet import (cross_entropy_loss,
                                                      init_weights_)
    from mpi_operator_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from mpi_operator_tpu_torch.parallel.train import adam, build_train_step
    from mpi_operator_tpu_torch.telemetry.goodput import GoodputTracker
    from mpi_operator_tpu_torch.telemetry.metrics import default_registry

    initialize_from_env(device=args.device)
    device = resolve_device(args.device)
    grouped = dist.is_initialized()
    rank = dist.get_rank() if grouped else 0
    world = dist.get_world_size() if grouped else 1
    mesh = create_mesh(MeshConfig(dp=-1), device.type) if grouped else None

    model = init_weights_(MnistCNN(device=device),
                          torch.Generator(device=device).manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(rank)
    images = torch.randn((args.batch_per_device, 28, 28, 1), generator=gen,
                         device=device)
    labels = torch.randint(0, 10, (args.batch_per_device,), generator=gen,
                           device=device)

    def loss_fn(model, batch):
        return cross_entropy_loss(model(batch[0]), batch[1])

    goodput = GoodputTracker(registry=default_registry())
    init_fn, step_fn = build_train_step(loss_fn, adam(args.lr), mesh,
                                        goodput=goodput)
    state = init_fn(model)
    for step in range(args.steps):
        state, metrics = step_fn(state, (images, labels))
        if rank == 0 and step % 10 == 0:
            print(f"step={step} loss={metrics['loss'].item():.4f}",
                  flush=True)
    # Flush the open goodput window so the summary accounts every step.
    step_fn.sync()
    if rank == 0:
        summary = goodput.summary()
        print(f"goodput={summary['goodput']:.3f}"
              f" compile_s={summary['seconds']['compile']:.3f}"
              f" steps_per_s={summary['steps_per_second']:.1f}")
        print(f"done processes={world} devices={world}"
              f" final_loss={metrics['loss'].item():.4f}", flush=True)
    if grouped:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
