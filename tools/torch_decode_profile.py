#!/usr/bin/env python3
"""Profile one decode step of the PyTorch port on the CUDA card.

    python3 tools/torch_decode_profile.py [--config 7b] [--slots 8]
        [--contexts 128 1024] [--steps 20]

Builds the model from a seeded generator on the card (random weights),
fills every slot of a paged ContinuousBatcher to the given context
length (``ContinuousBatcher.fill_slots``), then times ``steps`` decode
steps three ways: wall clock with a final synchronise, host time to
enqueue them, and device busy time from
torch.profiler (the sum of kernel self times).  Prints the card line
and one JSON object per context with the top kernels by device time and
K4''s device ms per step (its split and merge kernels together).
Needs the card; imports nothing of JAX.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="7b", choices=["7b", "llama3-8b"])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--contexts", type=int, nargs="+", default=[128, 1024])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_profile: needs a CUDA card", file=sys.stderr)
        return 1

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mpi_operator_tpu_torch.models.llama import llama2_7b, llama3_8b
    from mpi_operator_tpu_torch.models.params import init_params
    from mpi_operator_tpu_torch.serving.batcher import ContinuousBatcher

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cfg = {"7b": llama2_7b, "llama3-8b": llama3_8b}[args.config]()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        args.seed), device="cuda")
    n, page = args.slots, args.page_size
    for ctx in args.contexts:
        batcher = ContinuousBatcher(model, max_slots=n, page_size=page,
                                    device="cuda")
        # Each timed step advances every slot by one token.
        batcher.fill_slots(ctx, headroom=3 + 2 * args.steps)
        with torch.inference_mode():
            tokens = torch.randint(1, cfg.vocab_size, (n,),
                                   dtype=torch.int32, device="cuda")
            temps = torch.zeros(n, device="cuda")
            top_ps = torch.ones(n, device="cuda")
            top_ks = torch.zeros(n, dtype=torch.int32, device="cuda")

            def step():
                return batcher.decode_step(tokens, temps, top_ps,
                                           [None] * n, top_ks)

            for _ in range(3):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step()
            host = (time.perf_counter() - t0) / args.steps
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / args.steps
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(args.steps):
                    step()
                torch.cuda.synchronize()
        # Kernels only: an operator row (aten::mm) also carries the device
        # time of the kernels it launched, so summing every row would
        # count that time twice.
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        device = sum(e.self_device_time_total for e in kernels) \
            / args.steps / 1e6
        # K4' is two kernels (split over the sequence, then the merge).
        paged = sum(e.self_device_time_total for e in kernels
                    if "paged_split_kernel" in e.key
                    or "paged_merge_kernel" in e.key) / args.steps / 1e3
        top = sorted(((e.key, e.self_device_time_total / args.steps / 1e3,
                       e.count // args.steps) for e in kernels),
                     key=lambda k: -k[1])[:8]
        print(json.dumps({
            "card": card, "config": args.config, "slots": n,
            "context": ctx, "wall_ms_per_step": wall * 1e3,
            "host_enqueue_ms_per_step": host * 1e3,
            "device_busy_ms_per_step": device * 1e3,
            "device_idle_share": 1.0 - device / wall,
            "paged_attention_ms_per_step": paged,
            "top_kernels_ms_per_step": [
                {"name": k[:80], "ms": ms, "calls": c}
                for k, ms, c in top]}), flush=True)
        del batcher
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
