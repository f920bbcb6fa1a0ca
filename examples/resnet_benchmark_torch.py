#!/usr/bin/env python
"""ResNet throughput benchmark of the PyTorch port: counterpart of
examples/resnet_benchmark.py (tensorflow-benchmarks parity:
``tf_cnn_benchmarks --model=resnet101 --batch_size=64
--variable_update=horovod``).  Synthetic ImageNet, SGD 0.01 with momentum
0.9, bf16 compute over f32 weights, data-parallel over every process of
the job (one card each), each BatchNorm over the global batch.

    python examples/resnet_benchmark_torch.py [--model resnet101]
        [--batch-per-device 64] [--steps 20] [--warmup 5]
    python examples/resnet_benchmark_torch.py --device cpu \\
        --model resnet50 --image-size 32 --batch-per-device 2 --steps 2

Every process joins the group the operator's env describes
(``bootstrap.initialize_from_env``: NCCL on the cards, gloo with
``--device cpu``).  The global batch (``--batch-per-device`` x
processes) is drawn from seed 0 on every rank, which keeps its rows.
Rank 0 prints the JAX script's ``total images/sec:`` and
``images/sec/chip:`` lines, then ``ms_per_step=`` (host clock between
synchronised steps), ``peak_memory_gb=`` and ``train_mfu=`` (3 x the
forward's convolution and head FLOPs, counted from the model's shapes,
over the bf16 peak of 989 TFLOP/s); the CPU has no device metrics and
prints ``n/a`` for the last two.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_BF16_FLOPS = 989e12          # one H100 SXM, dense bf16


def benchmark(model_name: str = "resnet101", batch_per_device: int = 64,
              steps: int = 20, warmup: int = 5, image_size: int = 224,
              device=None, mesh=None, seed: int = 1) -> dict:
    """Train ``warmup`` + ``steps`` steps on one fixed synthetic batch;
    weights from ``seed`` (the same on every rank).  Returns the losses,
    the timed window's ms per step and images/s over the mesh, peak
    device memory (None on the CPU) and the training FLOPs an image."""
    import torch
    import torch.distributed as dist

    from mpi_operator_tpu_torch import resolve_device
    from mpi_operator_tpu_torch.models.resnet import (ResNet,
                                                      cross_entropy_loss,
                                                      init_weights_,
                                                      resnet50_config,
                                                      resnet101_config,
                                                      train_flops_per_image)
    from mpi_operator_tpu_torch.parallel.mesh import batch_rows
    from mpi_operator_tpu_torch.parallel.train import build_train_step, sgd

    device = resolve_device(device)
    world = 1 if mesh is None else mesh.mesh.numel()
    cfg = (resnet101_config() if model_name == "resnet101"
           else resnet50_config())
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = ResNet(cfg, mesh=mesh, device=device)
    init_weights_(model, torch.Generator(device=device).manual_seed(seed))
    flops_per_image = train_flops_per_image(model, image_size)

    gen = torch.Generator(device=device).manual_seed(0)
    batch = batch_per_device * world
    images = torch.randn((batch, image_size, image_size, 3), generator=gen,
                         device=device).to(torch.bfloat16)
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen,
                           device=device)
    if mesh is not None:
        rows = batch_rows(tuple(mesh.shape), mesh.get_coordinate(), batch)
        images, labels = images[rows], labels[rows]

    def loss_fn(model, batch):
        return cross_entropy_loss(model(batch[0]), batch[1])

    init, step = build_train_step(loss_fn, sgd(0.01, momentum=0.9),
                                  mesh=mesh)
    state = init(model)
    losses = []
    for _ in range(warmup):
        state, metrics = step(state, (images, labels))
        losses.append(metrics["loss"])
    losses[-1].item()               # the warm-up ends on the device
    if mesh is not None:
        dist.barrier()
    start = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, (images, labels))
        losses.append(metrics["loss"])
    losses[-1].item()
    elapsed = time.perf_counter() - start
    return {"model": model_name, "world": world, "image_size": image_size,
            "batch_per_device": batch_per_device,
            "losses": [loss.item() for loss in losses],
            "step_ms": elapsed / steps * 1e3,
            "images_per_s": batch * steps / elapsed,
            "peak_bytes": (torch.cuda.max_memory_allocated()
                           if device.type == "cuda" else None),
            "train_flops_per_image": flops_per_image,
            "state": state}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="resnet101",
                        choices=["resnet50", "resnet101"])
    parser.add_argument("--batch-per-device", type=int, default=64)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--device", default=None,
                        help="default: this process's card; 'cpu' for gloo")
    args = parser.parse_args()

    import torch
    import torch.distributed as dist

    from mpi_operator_tpu_torch import resolve_device
    from mpi_operator_tpu_torch.bootstrap import initialize_from_env
    from mpi_operator_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    initialize_from_env(device=args.device)
    device = resolve_device(args.device)
    grouped = dist.is_initialized()
    mesh = create_mesh(MeshConfig(dp=-1), device.type) if grouped else None
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    out = benchmark(args.model, args.batch_per_device, args.steps,
                    args.warmup, args.image_size, device, mesh)
    if not grouped or dist.get_rank() == 0:
        total = out["images_per_s"]
        print(f"total images/sec: {total:.2f}")
        print(f"images/sec/chip: {total / out['world']:.2f}")
        if out["peak_bytes"] is None:
            device_metrics = "peak_memory_gb=n/a train_mfu=n/a"
        else:
            mfu = (out["train_flops_per_image"] * args.batch_per_device
                   / (out["step_ms"] / 1e3) / PEAK_BF16_FLOPS)
            device_metrics = (f"peak_memory_gb={out['peak_bytes'] / 1e9:.2f}"
                              f" train_mfu={mfu:.4f}")
        print(f"model={args.model} world={out['world']} ms_per_step="
              f"{out['step_ms']:.2f} {device_metrics} "
              f"final_loss={out['losses'][-1]:.4f}", flush=True)
    if grouped:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
