#!/usr/bin/env python3
"""Profile ResNet training steps of the PyTorch port on the CUDA card.

    python3 tools/torch_image_profile.py [--model resnet101]
        [--batch-per-device 64] [--image-size 224] [--steps 3]

Builds the model (bf16 compute over f32 weights, ``channels_last``,
``cudnn.benchmark``) with weights from a seeded generator on the card,
takes five warm SGD-momentum steps on a fixed synthetic batch, then
measures: the host time one step takes to enqueue (``step_fn`` returning,
no synchronise), the wall clock of ``steps`` steps with a final
synchronise, and the device time per step by kernel family from
torch.profiler (convolutions and matmuls, reductions, the rest of the
elementwise work and copies, NCCL, the optimizer).  Prints the card
line and one JSON object.  Needs the card; imports nothing of JAX.

Over several cards, one process per card with the operator's env
(``JAX_COORDINATOR_ADDRESS``, ``JAX_PROCESS_ID``, ``JAX_NUM_PROCESSES``):

    for r in 0 1 2 3; do JAX_COORDINATOR_ADDRESS=127.0.0.1:29500 \\
        JAX_PROCESS_ID=$r JAX_NUM_PROCESSES=4 python3 \\
        tools/torch_image_profile.py & done; wait

each process trains at dp = the process count (every BatchNorm over the
global batch) and prints its own line: the slowest rank sets the step.
An NCCL kernel's device time includes the time it waits for its peers.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Kernel-name fragments of each family, first match wins.
FAMILIES = (("nccl", ("nccl",)),
            ("optimizer", ("multi_tensor",)),
            ("conv_matmul", ("xmma", "implicit", "cudnn", "gemm", "nvjet",
                             "cutlass")),
            ("reductions", ("reduce_kernel",)),
            ("elementwise_copies", ("elementwise", "copy", "memset")))


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet101",
                    choices=["resnet50", "resnet101"])
    ap.add_argument("--batch-per-device", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_image_profile: needs a CUDA card", file=sys.stderr)
        return 1

    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mpi_operator_tpu_torch.bootstrap import initialize_from_env
    from mpi_operator_tpu_torch.models.resnet import (ResNet,
                                                      cross_entropy_loss,
                                                      init_weights_,
                                                      resnet50_config,
                                                      resnet101_config)
    from mpi_operator_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from mpi_operator_tpu_torch.parallel.train import build_train_step, sgd

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    initialize_from_env()
    grouped = dist.is_initialized()
    rank = dist.get_rank() if grouped else 0
    world = dist.get_world_size() if grouped else 1
    mesh = create_mesh(MeshConfig(dp=world)) if grouped else None
    torch.backends.cudnn.benchmark = True
    cfg = (resnet101_config() if args.model == "resnet101"
           else resnet50_config())
    model = init_weights_(ResNet(cfg, mesh=mesh, device="cuda"),
                          torch.Generator("cuda").manual_seed(1))
    gen = torch.Generator("cuda").manual_seed(rank)
    batch = (torch.randn((args.batch_per_device, args.image_size,
                          args.image_size, 3), generator=gen,
                         device="cuda").to(torch.bfloat16),
             torch.randint(0, cfg.num_classes, (args.batch_per_device,),
                           generator=gen, device="cuda"))
    init, step = build_train_step(
        lambda m, b: cross_entropy_loss(m(b[0]), b[1]),
        sgd(0.01, momentum=0.9), mesh=mesh)
    state = init(model)

    def settle():
        torch.cuda.synchronize()
        if grouped:
            dist.barrier()

    for _ in range(5):
        state, _ = step(state, batch)
    settle()
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    enqueue = time.perf_counter() - t0
    settle()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.steps
    settle()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    # Kernels only (an annotation row also carries its kernels' time).
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    per_step = {}
    for e in kernels:
        fam = family(e.key)
        per_step[fam] = per_step.get(fam, 0.0) + \
            e.self_device_time_total / args.steps / 1e3
    device_ms = sum(per_step.values())
    top = sorted(((e.key, e.self_device_time_total / args.steps / 1e3,
                   e.count // args.steps) for e in kernels),
                 key=lambda k: -k[1])[:8]
    print(card, flush=True)
    print(json.dumps({
        "card": card, "rank": rank, "world": world, "model": args.model,
        "batch_per_device": args.batch_per_device,
        "image_size": args.image_size,
        "wall_ms_per_step": wall * 1e3,
        "host_enqueue_ms_per_step": enqueue * 1e3,
        "device_busy_ms_per_step": device_ms,
        "device_idle_share": 1.0 - device_ms / (wall * 1e3),
        "kernels_per_step": sum(e.count for e in kernels) / args.steps,
        "device_ms_per_step_by_family": per_step,
        "top_kernels_ms_per_step": [
            {"name": k[:80], "ms": ms, "calls": c} for k, ms, c in top]}),
        flush=True)
    if grouped:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
