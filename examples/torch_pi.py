#!/usr/bin/env python
"""torch-pi: Monte-Carlo pi with one all-reduce across the process group,
the PyTorch port's counterpart of examples/jax_pi.py.

    python examples/torch_pi.py [SAMPLES] [--device cpu]

The process forms its group from the operator's env
(``bootstrap.initialize_from_env``: NCCL on the card, gloo with
``--device cpu``), draws SAMPLES points per rank from a generator seeded
by its rank, and one all-reduce(SUM) of [inside, samples] in f64 gives
pi.  Rank 0 prints ``workers=N samples=... pi=...`` and, when the
operator launched the job, ``launch_to_first_allreduce_seconds=...``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("samples", nargs="?", type=int, default=1_000_000)
    parser.add_argument("--device", default=None,
                        help="default: this process's card; 'cpu' for gloo")
    args = parser.parse_args()

    import torch
    import torch.distributed as dist

    from mpi_operator_tpu_torch import resolve_device
    from mpi_operator_tpu_torch.bootstrap import (initialize_from_env,
                                                  launch_latency_seconds)

    initialize_from_env(device=args.device)
    grouped = dist.is_initialized()
    rank = dist.get_rank() if grouped else 0
    world = dist.get_world_size() if grouped else 1
    device = resolve_device(args.device)

    gen = torch.Generator(device=device).manual_seed(rank)
    pts = torch.rand((args.samples, 2), generator=gen, device=device)
    inside = ((pts * pts).sum(dim=-1) <= 1.0).sum()
    totals = torch.stack([inside.double(), torch.tensor(
        float(args.samples), dtype=torch.float64, device=device)])
    # The one global collective (MPI_Reduce parity).
    if grouped:
        dist.all_reduce(totals)
    inside_all, samples_all = totals.tolist()

    pi = 4.0 * inside_all / samples_all
    if rank == 0:
        print(f"workers={world} samples={int(samples_all)} pi={pi:.6f}")
        latency = launch_latency_seconds()
        if latency is not None:
            print(f"launch_to_first_allreduce_seconds={latency:.3f}")
    sys.stdout.flush()
    if grouped:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
