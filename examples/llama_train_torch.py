#!/usr/bin/env python
"""Llama training on one device with the PyTorch port: the counterpart of
examples/llama_train.py without a mesh.

    python examples/llama_train_torch.py --config tiny --device cpu --steps 2
    python examples/llama_train_torch.py --config 7b --n-layers 8 --batch 2 \\
        --seq-len 4096 --steps 5                      # on the card

Prints ``tokens/sec: N loss=L`` after a warm-up step.  Sharded training
(--dp/--fsdp/--tp/--sp/--pp/--ep), the Mixtral configs and the native
token loader (--data) are not ported yet.
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="tiny",
                        choices=["tiny", "7b", "mixtral-tiny",
                                 "mixtral-8x7b"])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--seq-len", type=int, default=0,
                        help="0 = config max_seq_len")
    parser.add_argument("--n-layers", type=int, default=0,
                        help="override the config's layer count")
    for axis in ("dp", "fsdp", "tp", "sp", "pp", "ep"):
        parser.add_argument(f"--{axis}", type=int, default=1)
    parser.add_argument("--data", default="")
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--fused-xent", action="store_true",
                        help="chunked-vocab fused cross-entropy: the"
                             " [B,S,V] logits tensor never materializes")
    parser.add_argument("--xent-chunk", type=int, default=4000,
                        help="vocab chunk width for --fused-xent (must"
                             " divide vocab_size)")
    parser.add_argument("--accum-steps", type=int, default=1)
    parser.add_argument("--checkpoint-dir", default="")
    parser.add_argument("--checkpoint-every", type=int, default=50)
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' for the plain"
                             " path")
    args = parser.parse_args()

    if args.config.startswith("mixtral"):
        raise SystemExit("the Mixtral configs (MoE) are not ported yet: "
                         "ROADMAP.md queue 1")
    mesh = {a: getattr(args, a) for a in ("dp", "fsdp", "tp", "sp", "pp",
                                          "ep")}
    if any(v != 1 for v in mesh.values()):
        raise SystemExit(f"mesh flags {mesh} need sharded training, not "
                         f"ported yet: ROADMAP.md queue 3")
    if args.data:
        raise SystemExit("--data (the native token loader) is not ported "
                         "yet: ROADMAP.md queue 1")

    import numpy as np
    import torch

    from mpi_operator_tpu_torch import resolve_device
    from mpi_operator_tpu_torch.models.llama import (llama2_7b, llama2_tiny,
                                                     next_token_loss)
    from mpi_operator_tpu_torch.models.params import init_params
    from mpi_operator_tpu_torch.ops.fused_xent import fused_next_token_loss
    from mpi_operator_tpu_torch.parallel.train import (adamw,
                                                       build_train_step)

    device = resolve_device(args.device)
    cfg = {"7b": llama2_7b, "tiny": llama2_tiny}[args.config](
        remat=args.remat)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    seq = args.seq_len or cfg.max_seq_len
    gen = torch.Generator(device=device).manual_seed(1)
    model = init_params(cfg, gen, device=device, dtype=cfg.param_dtype)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, seq)), device=device)

    if args.fused_xent:
        # A chunk that does not divide the vocab falls back to one
        # full-width chunk (correct, just unfused).
        chunk = args.xent_chunk if cfg.vocab_size % args.xent_chunk == 0 \
            else cfg.vocab_size

        def loss_fn(model, batch):
            hidden = model(batch, return_hidden=True)
            kernel = model.output.weight.to(cfg.dtype).t()
            return fused_next_token_loss(hidden, kernel, batch, chunk=chunk)
    else:
        def loss_fn(model, batch):
            return next_token_loss(model(batch), batch)

    mgr = None
    if args.checkpoint_dir:
        from mpi_operator_tpu_torch.utils import CheckpointManager
        mgr = CheckpointManager(args.checkpoint_dir,
                                every=args.checkpoint_every)
    init_fn, step_fn = build_train_step(loss_fn, adamw(3e-4),
                                        accum_steps=args.accum_steps)
    state = init_fn(model)
    try:
        if mgr is not None:
            state = mgr.restore(state)   # resume after suspend/preemption
            if state.step:
                print(f"resumed from step {state.step}")
        state, metrics = step_fn(state, tokens)          # warm-up
        float(metrics["loss"])
        start = time.perf_counter()
        for _ in range(args.steps):
            state, metrics = step_fn(state, tokens)
            if mgr is not None:
                mgr.maybe_save(state, state.step)
        final_loss = float(metrics["loss"])
        elapsed = time.perf_counter() - start
    finally:
        if mgr is not None:
            mgr.drain()       # finish the in-flight async checkpoint write
    tokens_per_sec = args.batch * seq * args.steps / elapsed
    print(f"device {device} layers={cfg.n_layers} batch={args.batch} "
          f"seq={seq}")
    print(f"tokens/sec: {tokens_per_sec:.0f} loss={final_loss:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
