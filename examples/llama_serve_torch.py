#!/usr/bin/env python
"""Serve a Llama/Mixtral-family model over HTTP with the PyTorch/CUDA port.

Continuous batching over a paged KV cache with prefix caching, optional
int8 KV, weight-only int8, chunked prefill, speculative decoding (the
model as its own draft, or prompt lookup), stop tokens and SSE
streaming; decode attention runs through the port's hand-written CUDA
kernel.  Weights are random, made on the device from ``--seed``, or
loaded from a HuggingFace Llama, Mistral or Mixtral checkpoint
(``--hf``; bf16 on the card, f32 on the CPU).

    # llama2_7b on the card, 8 slots, one demo request:
    python examples/llama_serve_torch.py --config 7b --slots 8 --demo

    # int8 weights, 512-token prefill chunks, prompt-lookup drafts:
    python examples/llama_serve_torch.py --config 7b --weight-dtype int8 \
        --prefill-chunk 512 --draft-strategy prompt_lookup --demo

    # tiny model on the CPU (the plain PyTorch path), dense or MoE:
    python examples/llama_serve_torch.py --config tiny --device cpu --demo
    python examples/llama_serve_torch.py --config mixtral-tiny \
        --device cpu --demo

    # an HF checkpoint directory (Llama, Mistral or Mixtral):
    python examples/llama_serve_torch.py --hf /path/to/checkpoint --demo

    # a disaggregated pair (same --seed, so the same weights): a decode
    # replica, a prefill replica, then prefill on one, decode on the other
    python examples/llama_serve_torch.py --role decode --port 8081 &
    python examples/llama_serve_torch.py --role prefill --port 8080 &
    curl -s localhost:8080/prefill -d '{"tokens": [1,2,3,...],
      "transfer": {"url": "http://127.0.0.1:8081", "have": []}}'
    curl -s localhost:8081/generate -d '{"tokens": [[1,2,3,...]]}'

    # tensor parallel over 4 cards, one process per card, each given the
    # operator's env (JAX_COORDINATOR_ADDRESS, JAX_PROCESS_ID,
    # JAX_NUM_PROCESSES); rank 0 serves HTTP, the others follow it:
    python examples/llama_serve_torch.py --config 7b --slots 8 --tp 4

    # the weights cut over fsdp too (each card holds a quarter of every
    # matmul weight and gathers each block as it runs): 4 processes
    python examples/llama_serve_torch.py --config 7b --slots 8 \
        --fsdp 2 --tp 2

    # on the CPU, two processes (gloo): fsdp = 2
    python examples/llama_serve_torch.py --config tiny --device cpu \
        --fsdp 2 --demo

    # a disaggregated pair at tp = 2 each: two jobs of two processes (each
    # job its own operator env and coordinator), the same --seed; the
    # pages rank 0 of the prefill job ships carry every KV head, so the
    # decode side may be a job of any --tp (or the JAX package's server)
    python examples/llama_serve_torch.py --config 7b --tp 2 \
        --role decode --port 8081 &          # per process of job 1
    python examples/llama_serve_torch.py --config 7b --tp 2 \
        --role prefill --port 8080 &         # per process of job 2

    # then:
    curl -s localhost:8080/generate -d \
      '{"tokens": [[1,2,3]], "max_new_tokens": 16, "eos_token_id": 2}'
"""

import argparse
import json
import os
import signal
import sys
import threading
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CONFIGS = ("tiny", "7b", "llama3-8b", "mixtral-tiny", "mixtral-8x7b")


def load_hf(path: str, dev):
    """An HF checkpoint directory through the port's converter (the
    weights in bf16 on the card, f32 on the CPU)."""
    import torch
    from transformers import AutoConfig, AutoModelForCausalLM

    from mpi_operator_tpu_torch.models.convert import (config_from_hf,
                                                       convert_hf_llama,
                                                       convert_hf_mixtral)
    from mpi_operator_tpu_torch.models.llama import LlamaModel

    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    cfg = config_from_hf(AutoConfig.from_pretrained(path), dtype=dtype)
    with torch.no_grad():
        state = AutoModelForCausalLM.from_pretrained(path).state_dict()
    convert = convert_hf_mixtral if cfg.n_experts > 1 else convert_hf_llama
    model = LlamaModel(cfg, device=dev)
    model.load_state_dict(convert(state, cfg))
    return model.eval()


def build_model(config_name: str, device, seed: int, hf: str = "",
                mesh=None):
    """The model, or under ``mesh`` this rank's shard of it (tp, then
    fsdp; an HF checkpoint is loaded whole and cut by the server)."""
    import torch

    from mpi_operator_tpu_torch import resolve_device
    from mpi_operator_tpu_torch.models.llama import (llama2_7b, llama2_tiny,
                                                     llama3_8b, mixtral_8x7b,
                                                     mixtral_tiny)
    from mpi_operator_tpu_torch.models.params import init_params

    dev = resolve_device(device)
    if hf:
        return load_hf(hf, dev)
    cfg = {"tiny": llama2_tiny, "7b": llama2_7b, "llama3-8b": llama3_8b,
           "mixtral-tiny": mixtral_tiny,
           "mixtral-8x7b": mixtral_8x7b}[config_name]()
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(cfg, gen, device=dev, mesh=mesh)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="tiny", choices=CONFIGS,
                    help="model configuration (random weights) when "
                         "no --hf is given")
    ap.add_argument("--hf", default="",
                    help="HuggingFace checkpoint dir (Llama, Mistral or "
                         "Mixtral)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--slots", type=int, default=4,
                    help="continuous-batching slots (0 = single-flight)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="paged KV block size (with --slots > 0)")
    ap.add_argument("--kv-cache-dtype", default="auto",
                    choices=["auto", "int8"])
    ap.add_argument("--role", default="unified",
                    choices=["unified", "prefill", "decode"],
                    help="disaggregated serving role (advertised at "
                         "/fleet-state; needs --slots > 0)")
    ap.add_argument("--weight-dtype", default="auto",
                    choices=["auto", "int8"],
                    help="int8: weight-only int8 matmul weights")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill width (with --slots > 0)")
    ap.add_argument("--draft-strategy", default="",
                    choices=["", "self", "prompt_lookup"],
                    help="speculative decoding: 'self' (the model is its "
                         "own draft, no second copy of the weights) or "
                         "'prompt_lookup' (training-free, --slots > 0)")
    ap.add_argument("--draft-len", type=int, default=4,
                    help="draft tokens per speculation round")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks: one process per card, "
                         "started with the operator's env; rank 0 serves "
                         "HTTP")
    ap.add_argument("--fsdp", type=int, default=1,
                    help="ranks the weights are cut over besides --tp: "
                         "each block is gathered as it runs; --tp x "
                         "--fsdp processes")
    ap.add_argument("--demo", action="store_true",
                    help="send one demo request, print it, and exit")
    args = ap.parse_args()

    from mpi_operator_tpu_torch.serving import InferenceServer

    if args.kv_cache_dtype != "auto" and args.slots <= 0:
        raise SystemExit(
            "--kv-cache-dtype needs continuous batching (--slots > 0); "
            "the single-flight path uses the dense cache")
    mesh = None
    world = args.tp * args.fsdp
    if world > 1:
        import torch.distributed as dist

        from mpi_operator_tpu_torch import resolve_device
        from mpi_operator_tpu_torch.bootstrap import initialize_from_env
        from mpi_operator_tpu_torch.parallel.mesh import (MeshConfig,
                                                          create_mesh)
        initialize_from_env(device=args.device)
        if not dist.is_initialized() or dist.get_world_size() != world:
            raise SystemExit(f"--tp {args.tp} --fsdp {args.fsdp} needs "
                             f"{world} processes started with the "
                             f"operator's env (JAX_COORDINATOR_ADDRESS, "
                             f"JAX_PROCESS_ID, JAX_NUM_PROCESSES)")
        mesh = create_mesh(MeshConfig(dp=1, fsdp=args.fsdp, tp=args.tp),
                           resolve_device(args.device).type)
    model = build_model(args.config, args.device, args.seed, args.hf, mesh)
    if args.weight_dtype == "int8":
        # Quantize here and drop the full-precision model, so only the
        # int8 weights stay resident.
        from mpi_operator_tpu_torch.models.quant import quantize_model
        model = quantize_model(model)
    page = args.page_size if args.slots > 0 else 0
    draft = model if args.draft_strategy == "self" else None
    strategy = ("prompt_lookup" if args.draft_strategy == "prompt_lookup"
                else None)
    server = InferenceServer(
        model, host=args.host, port=args.port, max_batch_slots=args.slots,
        kv_page_size=page, kv_cache_dtype=args.kv_cache_dtype,
        role=args.role, model_name=args.hf or args.config,
        draft_model=draft, draft_strategy=strategy,
        draft_len=args.draft_len, kv_prefill_chunk=args.prefill_chunk,
        device=model.device, mesh=mesh).start()
    if not server.is_leader:
        # A follower of the serving group: serves until rank 0 stops.
        server.join()
        server.stop()
        return 0
    print(f"serving on {server.url}  (config={args.hf or args.config}, "
          f"device={model.device}, role={args.role}, "
          f"slots={args.slots}, page={page}, "
          f"kv={args.kv_cache_dtype}, weights={args.weight_dtype}, "
          f"prefill_chunk={args.prefill_chunk}, "
          f"draft={args.draft_strategy or 'off'})", flush=True)
    try:
        if args.demo:
            req = urllib.request.Request(
                server.url + "/generate",
                data=json.dumps({"tokens": [[1, 2, 3, 4]],
                                 "max_new_tokens": 8}).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(req, timeout=600) as resp:
                print("demo:", resp.read().decode(), flush=True)
            return 0
        stopped = threading.Event()
        signal.signal(signal.SIGTERM, lambda *a: stopped.set())
        try:
            while not stopped.wait(timeout=1.0):
                pass
        except KeyboardInterrupt:
            pass
        return 0
    finally:
        server.stop()


if __name__ == "__main__":
    raise SystemExit(main())
