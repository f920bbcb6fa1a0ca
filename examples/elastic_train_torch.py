#!/usr/bin/env python
"""Elastic training of the PyTorch port: re-form the world at checkpoint
boundaries.  Counterpart of examples/elastic_train.py (the answer to
Elastic Horovod: horovodrun polls discover_hosts.sh and, on a membership
change, rebuilds the all-reduce ring from a checkpoint).

    python examples/elastic_train_torch.py --ckpt-dir DIR [--model mlp|resnet50]
        [--steps 60] [--batch 32] [--image-size 32] [--device cpu]

One process per card joins the group the operator's env describes
(``bootstrap.initialize_from_env``: NCCL on the cards, gloo with
``--device cpu``).  At every step boundary rank 0 reads the membership
artifact (``bootstrap.elastic.current_hosts``) and the stop file and
broadcasts both, so every rank sees the same world at the same step.
The data-parallel mesh spans the first ``dp`` ranks, dp the largest
divisor of the global ``--batch`` within the world and the processes;
ranks outside it wait at the step boundary.  When the world changes:

    1. the state is saved (``utils/checkpoint.py``) on the old mesh,
    2. the mesh is rebuilt for the new world,
    3. a fresh state on the new mesh restores the checkpoint and trains
       on (a ResNet's state carries its running statistics).

Rank 0 prints the JAX script's lines:
    ELASTIC-TRAIN-START world=<k> resume=<step or None>
    WORLD-CHANGE step=<n> old=<k> new=<m> restored=True
    ELASTIC-TRAIN-OK steps=<n> worlds=<k1>-><k2>... final_loss=<x>
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_mlp_workload(device):
    """Toy regression MLP: the fast re-forming path."""
    import torch
    from torch import nn

    from mpi_operator_tpu_torch.models.resnet import Dense
    from mpi_operator_tpu_torch.parallel.train import sgd

    def build(mesh):
        return nn.Sequential(Dense(16, 64, device=device), nn.ReLU(),
                             Dense(64, 16, device=device))

    def loss_fn(model, batch):
        x, y = batch
        return ((model(x) - y) ** 2).mean()

    def batch(gen, n):
        return (torch.randn((n, 16), generator=gen, device=device),
                torch.randn((n, 16), generator=gen, device=device))

    return build, loss_fn, batch, sgd(0.05)


def make_resnet50_workload(device, image_size: int):
    """The tracked elastic configuration (Elastic Horovod ResNet-50): the
    same save -> re-mesh -> restore loop around a ResNet-50 classifier,
    bf16 compute, each BatchNorm over the mesh's global batch."""
    import torch

    from mpi_operator_tpu_torch.models.resnet import (ResNet,
                                                      cross_entropy_loss,
                                                      resnet50_config)
    from mpi_operator_tpu_torch.parallel.train import sgd

    cfg = resnet50_config()

    def build(mesh):
        return ResNet(cfg, mesh=mesh, device=device)

    def loss_fn(model, batch):
        return cross_entropy_loss(model(batch[0]), batch[1])

    def batch(gen, n):
        return (torch.randn((n, image_size, image_size, 3), generator=gen,
                            device=device).to(torch.bfloat16),
                torch.randint(0, cfg.num_classes, (n,), generator=gen,
                              device=device))

    return build, loss_fn, batch, sgd(0.05, momentum=0.9)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--batch", type=int, default=32,
                        help="global batch, split over the mesh")
    parser.add_argument("--model", choices=("mlp", "resnet50"),
                        default="mlp",
                        help="mlp: fast path; resnet50: the tracked elastic "
                             "config")
    parser.add_argument("--image-size", type=int, default=32,
                        help="resnet50 input size (224 on the cards)")
    parser.add_argument("--ckpt-dir", required=True)
    parser.add_argument("--poll", type=float, default=0.2,
                        help="seconds between steps (membership cadence)")
    parser.add_argument("--stop-file", default=None,
                        help="finish gracefully once this file exists")
    parser.add_argument("--device", default=None,
                        help="default: this process's card; 'cpu' for gloo")
    args = parser.parse_args()

    import torch
    import torch.distributed as dist

    from mpi_operator_tpu_torch import resolve_device
    from mpi_operator_tpu_torch.bootstrap import elastic, initialize_from_env
    from mpi_operator_tpu_torch.models.resnet import init_weights_
    from mpi_operator_tpu_torch.parallel.mesh import (MeshConfig, batch_rows,
                                                      create_mesh)
    from mpi_operator_tpu_torch.parallel.train import build_train_step
    from mpi_operator_tpu_torch.utils.checkpoint import (latest_step,
                                                         restore_checkpoint,
                                                         save_checkpoint)

    initialize_from_env(device=args.device)
    device = resolve_device(args.device)
    grouped = dist.is_initialized()
    rank = dist.get_rank() if grouped else 0
    processes = dist.get_world_size() if grouped else 1
    if args.model == "resnet50":
        build, loss_fn, make_batch, optimizer = make_resnet50_workload(
            device, args.image_size)
    else:
        build, loss_fn, make_batch, optimizer = make_mlp_workload(device)

    def membership():
        """(world, stop) as rank 0 reads them, on every rank."""
        hosts = stop = 0
        if rank == 0:
            hosts = max(1, len(elastic.current_hosts()))
            stop = int(bool(args.stop_file)
                       and os.path.exists(args.stop_file))
        agreed = torch.tensor([hosts, stop], dtype=torch.int64,
                              device=device)
        if grouped:
            dist.broadcast(agreed, 0)
        return int(agreed[0]), bool(agreed[1])

    def carve(world: int):
        """dp: the largest divisor of the global batch within the world
        and the processes; the mesh over ranks [0, dp) (every rank takes
        part in building it)."""
        cap = max(1, min(world, processes))
        dp = max(d for d in range(1, cap + 1) if args.batch % d == 0)
        mesh = create_mesh(MeshConfig(dp=dp), device.type,
                           ranks=list(range(dp))) if grouped else None
        return dp, mesh

    def fresh_state(mesh):
        """A state at step 0 on ``mesh``, weights from seed 0, and its
        step."""
        model = init_weights_(build(mesh),
                              torch.Generator(device=device).manual_seed(0))
        init, step = build_train_step(loss_fn, optimizer, mesh=mesh)
        return init(model), step

    world, _ = membership()
    dp, mesh = carve(world)
    member = rank < dp
    state, train = fresh_state(mesh) if member else (None, None)
    resume = latest_step(args.ckpt_dir)
    if resume is not None and member:
        restore_checkpoint(args.ckpt_dir, state, step=resume)
    done = resume or 0
    worlds = [world]
    if rank == 0:
        print(f"ELASTIC-TRAIN-START world={world} resume={resume}",
              flush=True)
    loss = None
    while done < args.steps:
        new_world, stop = membership()
        if stop:
            break
        if new_world != world:
            # Checkpoint boundary: save on the old world, rebuild the mesh
            # for the new one, restore onto it.
            if member:
                save_checkpoint(args.ckpt_dir, state, step=done)
            if grouped:
                dist.barrier()          # the step directory is committed
            dp, mesh = carve(new_world)
            member = rank < dp
            state, train = fresh_state(mesh) if member else (None, None)
            if member:
                restore_checkpoint(args.ckpt_dir, state, step=done)
            if rank == 0:
                print(f"WORLD-CHANGE step={done} old={world} "
                      f"new={new_world} restored=True", flush=True)
            world = new_world
            worlds.append(world)
        if member:
            gen = torch.Generator(device=device).manual_seed(7 + done)
            x, y = make_batch(gen, args.batch)
            if mesh is not None:
                rows = batch_rows(tuple(mesh.shape), mesh.get_coordinate(),
                                  args.batch)
                x, y = x[rows], y[rows]
            state, metrics = train(state, (x, y))
            loss = metrics["loss"]
        done += 1
        time.sleep(args.poll)   # training cadence; lets membership move

    if rank == 0:
        final = float("nan") if loss is None else loss.item()
        print(f"ELASTIC-TRAIN-OK steps={state.step} "
              f"worlds={'->'.join(str(w) for w in worlds)} "
              f"final_loss={final:.4f}", flush=True)
    if grouped:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
