#!/usr/bin/env python
"""Llama training with the PyTorch port: the counterpart of
examples/llama_train.py, on one device or over a (dp, fsdp, tp) mesh of
processes.

    python examples/llama_train_torch.py --config tiny --device cpu --steps 2
    python examples/llama_train_torch.py --config 7b --n-layers 8 --batch 2 \\
        --seq-len 4096 --steps 5                      # on the card
    python examples/llama_train_torch.py --config mixtral-8x7b \\
        --n-layers 2 --batch 1 --seq-len 4096 --steps 3   # MoE, on the card
    python examples/llama_train_torch.py --config mixtral-tiny --device cpu \\
        --steps 2 --seq-len 32 --data corpus.bin      # the native loader

Under the operator (or by hand, with JAX_COORDINATOR_ADDRESS,
JAX_PROCESS_ID and JAX_NUM_PROCESSES set per process) the processes form
a group (NCCL on the cards, gloo with ``--device cpu``) and train over
the mesh --dp x --fsdp x --tp (dp -1: every remaining process;
--num-slices puts dp across slices), with the parameters sharded over
fsdp and cut over tp (Megatron) through ``llama_param_specs``; each rank
builds the model on the meta device and fills only its shard.
``--batch`` is the rows of one batch shard: the global batch is batch x
dp x fsdp (the tp ranks of a shard share its rows).  Rank 0 prints the ``mesh dp=...``
line and ``tokens/sec: N loss=L`` (global tokens, after a warm-up
step).  ``--data`` streams each process's rows from a flat int32 token
file (``native.write_token_file``) through the native loader, which
splits the corpus by process; without it every step trains on one fixed
random batch.  --sp/--pp/--ep above 1 wait for ROADMAP.md queue 1 item
3 (multi-GPU parallelism).
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
    parser.add_argument("--batch", type=int, default=2,
                        help="rows per batch shard (dp x fsdp shards)")
    parser.add_argument("--seq-len", type=int, default=0,
                        help="0 = config max_seq_len")
    parser.add_argument("--n-layers", type=int, default=0,
                        help="override the config's layer count")
    parser.add_argument("--dp", type=int, default=-1)
    for axis in ("fsdp", "tp", "sp", "pp", "ep"):
        parser.add_argument(f"--{axis}", type=int, default=1)
    parser.add_argument("--num-slices", type=int, default=0,
                        help="0 = auto from MEGASCALE_NUM_SLICES; >1 puts"
                             " dp across slices")
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
                             " path (gloo between processes)")
    args = parser.parse_args()

    wider = {a: getattr(args, a) for a in ("sp", "pp", "ep")
             if getattr(args, a) != 1}
    if wider:
        raise SystemExit(f"mesh flags {wider} need sharded training over "
                         f"those axes, not ported yet: ROADMAP.md queue 1 "
                         f"item 3")

    import numpy as np
    import torch
    import torch.distributed as dist

    from mpi_operator_tpu_torch import resolve_device
    from mpi_operator_tpu_torch.api.constants import MEGASCALE_NUM_SLICES_ENV
    from mpi_operator_tpu_torch.bootstrap import initialize_from_env
    from mpi_operator_tpu_torch.models.llama import (LlamaModel, llama2_7b,
                                                     llama2_tiny,
                                                     llama_param_specs,
                                                     mixtral_8x7b,
                                                     mixtral_tiny,
                                                     next_token_loss)
    from mpi_operator_tpu_torch.models.params import (init_params,
                                                      init_params_)
    from mpi_operator_tpu_torch.native import dataloader
    from mpi_operator_tpu_torch.ops.fused_xent import fused_next_token_loss
    from mpi_operator_tpu_torch.parallel.mesh import (AXIS_NAMES, MeshConfig,
                                                      batch_rows,
                                                      create_multislice_mesh)
    from mpi_operator_tpu_torch.parallel.train import (adamw,
                                                       build_train_step)
    from mpi_operator_tpu_torch.utils.data import (DevicePrefetcher,
                                                   global_batch_iterator)

    initialize_from_env(device=args.device)
    device = resolve_device(args.device)
    grouped = dist.is_initialized()
    rank = dist.get_rank() if grouped else 0
    world = dist.get_world_size() if grouped else 1
    mesh_cfg = MeshConfig(dp=args.dp, fsdp=args.fsdp, tp=args.tp)
    shape = dict(zip(AXIS_NAMES, mesh_cfg.resolve(world)))
    shards = shape["dp"] * shape["fsdp"]
    mesh = None
    if grouped:
        num_slices = args.num_slices or int(
            os.environ.get(MEGASCALE_NUM_SLICES_ENV, "1"))
        mesh = create_multislice_mesh(mesh_cfg, num_slices, device.type)
    cfg = {"7b": llama2_7b, "tiny": llama2_tiny,
           "mixtral-tiny": mixtral_tiny,
           "mixtral-8x7b": mixtral_8x7b}[args.config](remat=args.remat)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    seq = args.seq_len or cfg.max_seq_len
    gen = torch.Generator(device=device).manual_seed(1)
    if mesh is None:
        model = init_params(cfg, gen, device=device, dtype=cfg.param_dtype)
        init_weights = None
    else:
        # Placed (sharded) before it is filled: no rank holds it whole.
        model = LlamaModel(cfg, device="meta", store_dtype=cfg.param_dtype,
                           mesh=mesh)

        def init_weights(model):
            init_params_(model, gen)

    if args.fused_xent:
        # A chunk that does not divide the (rank's) vocab falls back to
        # one full-width chunk (correct, just unfused).
        vocab = cfg.vocab_size // shape["tp"]
        chunk = args.xent_chunk if vocab % args.xent_chunk == 0 else vocab

        def loss_fn(model, batch):
            hidden = model(batch, return_hidden=True)
            kernel = model.output.weight.to(cfg.dtype).t()
            return fused_next_token_loss(hidden, kernel, batch, chunk=chunk,
                                         tp=model.tp)
    else:
        def loss_fn(model, batch):
            return next_token_loss(model(batch), batch)

    mgr = None
    if args.checkpoint_dir:
        from mpi_operator_tpu_torch.utils import CheckpointManager
        mgr = CheckpointManager(args.checkpoint_dir,
                                every=args.checkpoint_every)
    init_fn, step_fn = build_train_step(
        loss_fn, adamw(3e-4), mesh=mesh,
        param_specs=llama_param_specs(cfg) if mesh is not None else None,
        accum_steps=args.accum_steps)
    state = init_fn(model, init_weights)
    loader = prefetch = None
    if args.data:
        # Each process streams its own part of the corpus (the loader
        # splits it by process) and feeds its own rows; the batches are
        # copied to the device on the prefetch thread.  Both are closed
        # in the finally below.
        loader = dataloader.NativeTokenLoader(args.data, seq_len=seq,
                                              batch=args.batch)
        prefetch = DevicePrefetcher(global_batch_iterator(
            lambda step: (loader.next_batch(),), mesh, device))

        def next_tokens():
            return next(prefetch)[0]
    else:
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (args.batch * shards, seq))
        if mesh is not None:
            tokens = tokens[batch_rows(tuple(mesh.shape),
                                       mesh.get_coordinate(), len(tokens))]
        tokens = torch.as_tensor(tokens, device=device)

        def next_tokens():
            return tokens
    try:
        if mgr is not None:
            state = mgr.restore(state)   # resume after suspend/preemption
            if state.step and rank == 0:
                print(f"resumed from step {state.step}")
        state, metrics = step_fn(state, next_tokens())   # warm-up
        float(metrics["loss"])
        start = time.perf_counter()
        for _ in range(args.steps):
            state, metrics = step_fn(state, next_tokens())
            if mgr is not None:
                mgr.maybe_save(state, state.step)
        final_loss = float(metrics["loss"])
        elapsed = time.perf_counter() - start
    finally:
        if mgr is not None:
            mgr.drain()       # finish the in-flight async checkpoint write
        if prefetch is not None:
            prefetch.close()
        if loader is not None:
            loader.close()
    tokens_per_sec = args.batch * shards * seq * args.steps / elapsed
    if rank == 0:
        print(" ".join(["mesh"] + [f"{a}={n}" for a, n in shape.items()])
              + f" processes={world}")
        print(f"device {device} layers={cfg.n_layers} batch="
              f"{args.batch * shards} seq={seq}")
        print(f"tokens/sec: {tokens_per_sec:.0f} loss={final_loss:.4f}")
    if grouped:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
