#!/usr/bin/env python3
"""Profile training steps of the PyTorch port on the CUDA card.

    python3 tools/torch_train_profile.py [--n-layers 8] [--batch 2]
        [--seq-len 4096] [--steps 3]

Builds llama2_7b at full width (``--n-layers`` of its 32 layers) with
f32 weights from a seeded generator on the card, takes two warm AdamW
steps on a fixed batch, then times ``steps`` steps: wall clock with a
final synchronise, and device busy time from torch.profiler (the sum of
kernel self times).  Prints the card line and one JSON object with the
device time per step grouped by kernel family (flash kernels, matmuls,
optimizer, the rest) and the top kernels.  Needs the card; imports
nothing of JAX.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Kernel-name fragments of each family (the rest is elementwise work,
# reductions, copies and casts).
FAMILIES = (("flash_fwd", ("flash_fwd",)),
            ("flash_bwd", ("flash_bwd",)),
            ("matmul", ("gemm", "nvjet", "cutlass", "sm90_xmma")),
            ("adamw", ("multi_tensor",)))


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: needs a CUDA card", file=sys.stderr)
        return 1

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mpi_operator_tpu_torch.models.llama import (llama2_7b,
                                                     next_token_loss)
    from mpi_operator_tpu_torch.models.params import init_params
    from mpi_operator_tpu_torch.parallel.train import adamw, build_train_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cfg = dataclasses.replace(llama2_7b(), n_layers=args.n_layers)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        args.seed), device="cuda", dtype=cfg.param_dtype)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.seq_len),
                           device="cuda")

    def loss_fn(model, batch):
        return next_token_loss(model(batch), batch)

    init, step = build_train_step(loss_fn, adamw(3e-4))
    state = init(model)
    for _ in range(2):
        state, _ = step(state, tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, _ = step(state, tokens)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            state, _ = step(state, tokens)
        torch.cuda.synchronize()
    # Kernels only: an operator row, or a user annotation such as the
    # optimizer's step, also carries its kernels' device time, so summing
    # every row would count that time twice.
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
                 key=lambda k: -k[1])[:10]
    print(json.dumps({
        "card": card, "model": "llama2_7b", "n_layers": cfg.n_layers,
        "batch": args.batch, "seq_len": args.seq_len,
        "wall_ms_per_step": wall * 1e3,
        "device_busy_ms_per_step": device_ms,
        "device_idle_share": 1.0 - device_ms / (wall * 1e3),
        "device_ms_per_step_by_family": per_step,
        "top_kernels_ms_per_step": [
            {"name": k[:80], "ms": ms, "calls": c} for k, ms, c in top]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
