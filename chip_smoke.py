#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mpi_operator_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases 12      # a subset (with 2 and 7)

Phases, in order; any failure exits non-zero and no phase is caught and
continued.  ``--phases`` runs the build and the phases named (3, 4, 5,
6, 7, 9, 10, 11, 12, 13), each with the phases it is checked against (9
and 10 with 5, 12 with 7), and prints no kernels line.  Every run prints
each phase's seconds on the line "phase seconds: {...}":

1. card      the card's name and power limit (nvidia-smi), the torch and
             CUDA versions and `nvcc --version`.
2. build     the three kernel sources under mpi_operator_tpu_torch/ops/csrc/
             (paged_attention.cu, flash_attention.cu, rmsnorm.cu), each by
             its own nvcc, started together; each kernel's -Xptxas -v
             register / shared-memory / spill report is printed (a wgmma
             kernel with spill bytes fails the run), and the count of
             HGMMA (wgmma) instructions that cuobjdump -sass finds in each
             bf16 flash kernel (forward, dQ, dK/dV), which must not be 0.
3. kernels   each kernel against its plain PyTorch version on the card.
             K4' (paged decode attention: a split kernel and a merge
             kernel) at the serving path's shapes (PAGED_CASES): per
             (row, query head), the largest error over the largest
             |plain output| is at most 2e-2 in bf16 and 2e-5 in f32, a
             second call gives the same bits, and a planted fault (one
             table entry pointing at another block) must exceed the
             limit; each case prints its split plan, share of its bound
             and host us (median of 7 runs of 200 calls).  K1'-K3'
             (flash attention forward, dQ, dK/dV) at the training
             shape (2 x 32 heads x 4096 x 128, bf16, causal) and
             non-causal, S = 4095, D = 64, f32, phase 11's ring chunk
             (1 x 32 x 8192 x 128, non-causal: a chunk behind the
             diagonal) and flash_attention_with_lse with an lse
             cotangent, causal and not: per
             (batch, head), the largest error over the largest |plain
             value| is at most 2e-2 forward and 5e-2 for gradients in
             bf16, 2e-5 and 5e-4 in f32; a planted fault (key block 0 of
             one head replaced by block 10, given to the kernels only)
             must exceed each limit, and a second call of K1', K2' and
             K3' on the training shape's inputs must give bit-identical
             out, lse, dq, dk and dv.  K5' (fused RMSNorm) at the
             training shape (8192 x 4096, bf16 and f32), the decode shape
             (8 x 4096), widths 5120, 8192 and 32768 and ragged rows (d
             4100 and 4099), each case naming the K5' kernel its shape
             takes (rows or two-pass; both must run): per row, the
             largest error over the largest |plain output| is at most
             2e-2 in bf16 and 2e-5 in f32, rstd within 2e-5; a planted
             fault (one row normalised with a scale 5% too large) must
             exceed it; then K5''s own path, rmsnorm(impl="auto") and
             fused_rmsnorm forward and backward, with its launches
             counted.  Kernels are timed by CUDA-graph replay between
             CUDA events (device time; the wrapper's host time is printed
             apart), beside their bound (bytes over 3.35 TB/s or
             operations over the type's peak rate, whichever is larger),
             the plain version's time and the library call's:
             scaled_dot_product_attention's forward and backward for
             K1'-K3', torch.nn.functional.rms_norm for K5'; each kernel
             also prints its share of its bound, the flash kernels their
             achieved TFLOP/s, K5' the time of a device copy of the same
             bytes.
4. parity    tiny f32 models on the card equal the plain path on the CPU,
             the dense llama2_tiny and the MoE mixtral_tiny (4 experts,
             top-2): paged greedy generate, and two AdamW train steps
             through the flash kernels (loss and grad_norm at 1e-4).
             Then examples/llama_train_torch.py takes 2 steps on the card
             with its defaults (--config tiny, head_dim 32, which
             attention(impl="auto") zero-pads to the flash kernels' 64)
             and with --config mixtral-tiny --data over a token file
             written by write_token_file (the native loader); each exits
             0 with a finite loss and K1'-K3' each launch once per layer
             and step.
5. serving   llama2_7b at full width and depth (32 layers, dim 4096),
             random bf16 weights from a seeded generator on the card,
             served through InferenceServer(max_batch_slots=8,
             kv_page_size=16) over HTTP: each prompt first alone on a
             server without prefix cache (the reference), then 8
             concurrent greedy /generate requests of mixed prompt lengths
             plus one SSE stream, then a prefix-sharing pair.  Checked:
             every response's token count, concurrent == alone, the SSE
             stream == alone, transfers == ticks, and the paged attention
             kernel's launches == decode steps x n_layers.  Then, on the
             same model, each server freed before the next:
             speculation   4 slots, draft_len 4: the model as its own
                           draft (4 greedy prompts of 64-1000 tokens),
                           and prompt lookup (4 prompts that quote a
                           200-token span twice, beside one sampling
                           request); acceptance printed; every token of
                           every stream, speculative and plain, replayed
                           on its own context through width-1 steps: it
                           must be the replay's argmax or short of it
                           by less than the measured step-vs-wide logit
                           error (a bf16 near-tie); K4' launches ==
                           plain ticks x n_layers.  Two planted faults
                           in the verify (emission shifted by one
                           position, verify index one past the stream)
                           must each fail that check.
             chunked       prefill_chunk 512 on the serving prompts:
                           last-position logits against the unchunked
                           prefill within 5e-2 of the largest logit, and
                           a planted fault (a last chunk that ignores
                           the earlier chunks) beyond it; first tokens
                           against the streams alone; K4' launches ==
                           decode steps x n_layers.
             int8          the weights quantized (weight-only int8) and
                           the bf16 copy freed; 8 slots through K4'.
                           Printed: peak memory beside the bf16 serving
                           phase's in the same run, mean inter-token
                           latency, the logits' error
                           against the bf16 weights on one prompt
                           (checked below 0.2).
             disagg (5e)   the bf16 7B again (32 layers, from SEED): a
                           prefill replica and a decode replica,
                           InferenceServer(role="prefill"/"decode", 8
                           slots, page 16, kv_cache_blocks 512: 4 GiB of
                           pool each).  For the serving prompts of 100,
                           700 and 2000 tokens, each with its own
                           trace_context: POST /prefill to the prefill
                           replica, which ships the prompt's pages to the
                           decode replica (POST /kv/pages), then a
                           streamed /generate of 32 tokens on the decode
                           replica, then the same /generate on the
                           prefill replica over its own cached pages (the
                           reference).  Checked per prompt: shipped ==
                           imported == pages, 0 rejected; the decode
                           replica's prefix hits rose by the pages; the
                           prefill replica ran 0 decode steps and 0 K4'
                           launches in its /prefill; K4' launches on the
                           decode replica == its decode steps x 32; the
                           decode stream == the reference, token for
                           token.  Then: the decode replica's own export
                           of the pages has the prefill replica's bytes;
                           a /prefill that names its pages as present
                           ships 0 and dedups all; the tracer holds each
                           context's serve_queue_wait and prefill spans,
                           parented to it; GET /debug-bundle writes every
                           artifact its MANIFEST.json names, with the
                           spans in flight.jsonl.  The same again in int8
                           KV pools on the 700-token prompt.  Printed:
                           pages, raw and wire bytes, the /prefill ms
                           split into export, encode, push, the
                           receiver's wire decoding and import, the
                           handoff GB/s, TTFT of the decode replica
                           beside the reference's, peak memory.
             moe (5f)      mixtral_8x7b at full width (dim 4096, FFN
                           14336, 8 experts top-2, 8 kv heads: K4' at GQA
                           groups of 4), 16 of 32 layers (47.0 GB of bf16
                           weights; 32 would take 93.4), random weights
                           from SEED, through the same serving run as the
                           7B (alone, then concurrent, SSE, prefix pair).
                           Checked as the 7B (counts, concurrent ==
                           alone, K4' launches == decode steps x 16) and
                           peak memory < 80 GB.  Printed: TTFT, mean
                           inter-token latency, output tokens/s, peak
                           memory and the share of routed assignments
                           per expert (every expert must get some).
6. training  llama2_7b at full width, 8 of 32 layers, batch 2 x 4096
             tokens, f32 parameters and AdamW state, bf16 compute: one
             warm step and 5 more through run_train_loop(build_train_step)
             after the serving model is freed.  Printed: step ms,
             tokens/s, train_mfu, losses, peak memory, goodput.  Checked:
             finite losses, the last below the first, K1'/K2'/K3'
             launches == 6 steps x 8 layers each, peak memory < 80 GB.
             Then the phase runs once more: its six losses must be
             bit-identical to the first run's.
   moe (6b)  mixtral_8x7b at full width, 2 of 32 layers, batch 1 x 4096
             tokens (capacity 1280 per expert), f32 parameters and AdamW
             state, bf16 compute: one warm step and 3 more, then the
             phase once more.  Checked as above (K1'/K2'/K3' launches ==
             4 steps x 2 layers, peak < 80 GB, the losses of the two runs
             bit-identical).  train_mfu counts attention, the top-2 of 8
             experts, the router and the head.
7. distributed  one process per visible card (at most 4), each given
             the operator's env (JAX_COORDINATOR_ADDRESS on a free local
             port, JAX_PROCESS_ID, JAX_NUM_PROCESSES, MPIJOB_SUBMIT_TIME)
             and forming its NCCL group through
             bootstrap.initialize_from_env (at one card, a one-rank
             group); a rank that fails or outlives its deadline fails the
             run.  (a) examples/torch_pi.py, 10^7 points a rank: rank 0
             prints workers=world, |pi - π| < 0.01 and the
             launch-to-first-all-reduce seconds.  (b) with two cards or
             more: llama2_tiny in f32, 3 AdamW steps at dp = world with
             shard_update and at fsdp = world through llama_param_specs,
             losses, grad norms and parameters equal to card 0 alone on
             the same global batch at 1e-5 (an element whose gradient
             came within rounding of zero at 3 lr), and a planted fault
             (rank 1 keeps its own gradient chunk instead of the
             reduced one) that must fail the check; at one card it
             prints that (b) needs two.  (c) llama2_7b at full width,
             fsdp = world, 4 x world layers (16 of 32 at four cards;
             cut from 8 a card to pay for phase 12 (c), (d)), 1 x
             4096 tokens a rank, f32 parameters and AdamW state, bf16
             compute, built on the meta device and each rank filling
             only its shard: one warm-up step and 3 more, twice, with
             growable allocator segments (PYTORCH_CUDA_ALLOC_CONF=
             expandable_segments:True unless the caller set it).
             Printed per rank: ms per step (and each step's), tokens/s
             per card, train_mfu, peak memory, allocator retries, and
             whether the two runs' losses are bit-identical.  Checked:
             K1'/K2'/K3' launches == 4 x layers on each rank, finite
             losses, peak < 80 GB.  (d) in the same processes: the
             checkpoint data plane.  llama2_7b at full width with one
             layer a card (world layers), fsdp = world, 1 x 4096 tokens
             a rank, bf16 over f32 state: 2 steps, a save of step 2
             through ckpt.ManifestCheckpointManager into a directory
             store in a temp dir (each rank its own range of the
             one-device stream; at one card one process writes 4
             shards), 2 more steps (the straight run), then
             restore_resharded onto dp = 2 x fsdp = 2 (four cards; dp =
             2 at two, the same mesh at one) and the same 2 steps; the
             store is removed after.  Checked: the per-leaf sha256 of
             each rank's range after the restore equals the one before
             the save; the restored run's losses within 1e-3 relative of
             the straight run's (bit-equal at one card); K1'/K2'/K3'
             launches == 6 steps x layers on each rank; each rank's host
             peak (/proc/self/statm on a thread) during the save within
             its range and during the restore within its new shard, plus
             the largest leaf plus 1 GB; and a planted restore in which
             rank 1 (rank 0 at one card) reads every leaf one row off
             must change a digest.  Printed per rank: the free disk, the
             save's seconds on the step path (snapshot) and off it
             (write), the restore's, GB written and read and their GB/s,
             host peaks and bounds, launches, and the part's seconds.
9. tensor parallel  one process per card (4, 2 or 1), NCCL, each
             forming its group from the operator's env.  First, in this
             process on card 0, the one-card references: the 7B from
             SEED, each serving prompt's prefill logits
             (InferenceServer.prefill_logits) and, over each prompt and
             its stream from phase 5, the one-card top-2 logit gap at
             every position.  (a) llama2_7b, all 32 layers, bf16, drawn
             as each rank's tp shard of the SEED weights, served at tp =
             world through InferenceServer(mesh=) (8 slots, page 16, no
             prefix cache; rank 0 on HTTP, the others in lock-step).
             Checked: the prefill logits of every prompt against one
             card, largest difference over largest |logit| <= 5e-2, and
             a planted fault (rank 1 keeps its own partial of layer 0's
             wo all-reduce) beyond it; each prompt alone, then all
             concurrently with an SSE stream: concurrent == alone, the
             streams equal phase 5's or first differ where the one-card
             top-2 gap is below the measured logit error; on every rank
             K4' launches == decode steps x 32 and peak < 80 GB.  (b)
             with two cards or more, mixtral_8x7b at TP_MOE_LAYERS (8)
             of 32 layers (cut from 32 to pay for phase 12 (c), (d)), tp
             = world, the same run: concurrent == alone, K4' launches ==
             steps x layers on every rank, every expert routed, peak <
             80 GB; at one card it prints that the model needs two.  (c)
             with two cards or more: llama2_tiny f32, 3 AdamW steps at
             tp = world (and at fsdp = 2 x tp = 2 at four cards) against
             card 0 alone at 1e-5, and a planted fault (rank 1 keeps its
             own input gradient at every copy-to-tp) that must fail;
             then llama2_7b at full width, fsdp = 2 x tp = 2 with 32
             layers (tp = 2 with 16 layers at two cards), 1 x 4096 tokens
             a batch shard, 1 warm-up + 3 steps, twice: K1'-K3' launches
             == 4 x layers on every rank, the two runs' losses
             bit-identical, peak < 80 GB.  (d) with four cards, in the
             same processes: disaggregated prefill/decode across two tp
             groups of one world, ranks 0-1 a prefill replica and ranks
             2-3 a decode replica (create_mesh(ranks=)), llama2_7b at 32
             layers in bf16 from SEED on each, 512-block pools, 8 slots,
             page 16; rank 0 drives /prefill with the decode replica as
             destination, then 32 greedy new tokens on the decode
             replica, for the 100-, 700- and 2,000-token prompts (bf16
             pools) and, on a second pair over the same models, the
             700-token prompt (int8 pools).  A page carries every KV
             head: the prefill ranks gather theirs to rank 0, the decode
             replica's rank 0 scatters each rank its chunk.  Checked:
             every full page imported, none rejected; a second ship
             all deduped; the decode replica hit every page (it
             prefilled only the tail); on ranks 2 and 3 the imported
             pool rows are that rank's head chunk of the wire pages
             (digests, scales too); the decode replica's logits over
             the imported pages (prefill_logits after the stop) within
             5e-2 of one card, its streams equal phase 5's or first
             differ below that error; K4' launches == decode steps x 32
             on ranks 2 and 3 and none on ranks 0 and 1; peak < 80 GB;
             and a planted fault, the decode replica installing each
             rank the other's head chunk (the 300-token prompt), must
             fail the rows and exceed 5e-2.  At fewer than four cards it
             prints that it needs four.  Printed: TTFT, inter-token
             latency, tokens/s, peak per rank; ms a step, tokens/s a
             card and train_mfu; per prompt the handoff's seconds
             (export gather, codec, push, import scatter) and GB/s, the
             decode replica's TTFT and tokens/s, and (d)'s seconds.
11. sequence / expert parallel  one process per card (4 or 2; at one
             card it prints that it needs two), NCCL.  (a) llama2_tiny
             f32, 3 AdamW steps at sp = world through ring attention on
             K1'-K3' (ring_impl="flash"; at four cards also fsdp = 2 x
             sp = 2) and mixtral_tiny at ep = 2 (dp the rest; at four
             cards also fsdp = 2 x ep = 2), against card 0 alone at
             1e-5; each run again with a planted fault that must fail
             (sp: rank 1's RoPE positions not offset; ep: rank 1 keeps
             its own partial combine); reshard_train_state grown from
             card 0 to two ranks and shrunk back at step 2 of 4: within
             1e-5 of the straight run on two ranks, each moved state
             bit-equal to the state before its move.  (b) llama2_7b at
             full width, 16 of 32 layers at fsdp = 2 x sp = 2 (cut
             from 32 to pay for phase 12 (c), (d); 8 layers at sp = 2
             on two cards), 1 x 16384 tokens a batch shard
             (8192 a rank), bf16 compute, the ring on the flash kernels,
             1 warm-up + 3 steps, twice; then the ring's forward and
             backward at the layer's shape, and one K/V rotation, timed
             by CUDA events.  (c) mixtral_8x7b at full width, 8 of 32
             layers at fsdp = 2 x ep = 2 (4 layers at ep = 2 on two
             cards), 1 x 4096 tokens a batch shard, the same steps.
             Both under activation checkpointing (without it a rank ran
             out of memory in each).  Checked: on sp rank r, K1'-K3'
             each launch steps x layers x (r + 1) times (the causal
             ring; K1' twice that: remat runs each forward again), in
             (c) steps x layers (K1' twice that); finite losses,
             bit-identical over the two runs; peak < 80 GB on every
             rank; every expert
             routed.  Printed per rank: ms a step, tokens/s a card,
             train_mfu (the formula of training, over the global
             tokens), peak, the ring's ms a layer and share of the step.
12. pipeline parallel  one process per card (4 or 2; at one card it
             prints that it needs two), NCCL, which runs (a) and (d),
             then (b) and (c).  (a) llama2_tiny f32 at 4
             layers, M = 4: GPipe and 1F1B at pp = 4, 1F1B at dp = 2 x
             pp = 2, interleaved 1F1B (V = 2) at fsdp = 2 x pp = 2 with
             the stages' matrices sharded (two cards: GPipe and 1F1B at
             pp = 2): the loss at 2e-5 and every gradient leaf, joined
             from the stages, at rtol 2e-4 / atol 2e-5 of the sequential
             model on card 0 (tests/test_pipeline.py's bounds), then 3
             AdamW steps at 1e-5 as phase 7 (b); a planted fault (rank 1
             files received activations under the wrong ring slot) must
             fail.  (b) llama2_7b at full width, PP_LAYERS_PER_CARD (4)
             layers a card (16 at four cards; cut from 8 a card to pay
             for (c) and (d)), pp = cards, M = 8 microbatches of 1 x
             4096 tokens, bf16 compute, f32 weights and AdamW, each
             stage built on the meta device and filled with the one-card
             draws for SEED: 1F1B, then interleaved 1F1B (V = 2), one
             warm-up + 3 steps, twice each; then 1F1B on phase 7 (c)'s
             weights and global batch (its 4 x cards layers, M =
             cards), 3 steps.  Checked on
             every rank: K1' launches == 2 x M x layers a stage a step
             (each F slot and each B slot's recompute), K2' and K3' ==
             M x layers a stage a step, finite losses, bit-identical
             over the two runs, peak < 80 GB; the first loss within
             1e-4 relative of phase 7 (c)'s and the next two within
             1e-3.  Printed per rank: ms a step (and each step's),
             tokens/s a card, train_mfu (no credit for the recompute),
             peak, allocator retries, the F and B slots' device ms (CUDA
             events) and the idle share they leave of each step, beside
             the tables' bubble (event-driven: (P-1)/(M+P-1) for 1F1B)
             and its lock-step value (each tick as long as its busiest
             rank).  (c) mixtral_8x7b at full width, PP_MOE_LAYERS of 32
             layers (2 a stage at four cards), pp = cards, 1F1B, M = 8
             microbatches of 1 x 4096 tokens, bf16 over f32 weights and
             AdamW, one warm-up + 3 steps, twice: as (b), and every
             expert routed on every stage (its layers' last forward).
             (d) mixtral_tiny f32 at 4 layers, M = 4: 1F1B at pp = 4, at
             dp = 2 x pp = 2 and at fsdp = 2 x pp = 2 with pp_fsdp (two
             cards: pp = 2) against card 0 running the same chunks (each
             MoE layer counts its capacity over one microbatch of a batch
             shard, as the JAX stages do), at (a)'s bounds; a planted
             fault (pp stage 1's MoE layers count their capacity over
             every batch shard's microbatch) must fail.  Then
             reshard_train_state of a llama2_tiny 1F1B state at pp =
             cards, moved before step 2 of 4 onto fsdp = 2 x pp = 2 and
             onto dp = cards: the moved state bit-equal to the state
             before the move, the losses within 1e-5 of the straight
             run.  Each part's seconds (rank 0) are printed.
13. image workloads  (a) a tiny ResNet (stage sizes (1, 1, 1, 1), width
             16, 10 classes, f32, 32 x 32, 8 images from SEED) on card 0
             against the CPU: train-mode logits at 1e-4, the running
             statistics of that forward and 3 SGD-momentum steps (losses,
             weights, statistics) at 1e-5.  (b) ResNet-101 at 224 x 224,
             1000 classes, 64 images, bf16 compute over f32 weights,
             channels_last, cudnn.benchmark, SGD 0.01 momentum 0.9
             through examples/resnet_benchmark_torch.py's benchmark(): 5
             warm-up + 20 steps, twice from SEED.  Checked: finite
             losses, the two runs' first loss within 1e-6 relative and
             the later ones within 1e-2 (cuDNN may pick other
             algorithms), peak < 80 GB.  Printed: images/s, ms a step,
             peak GB and train_mfu (3 x the forward's 2 k^2 C_in C_out
             H_out W_out over the convolutions and the head, counted
             from the model's shapes, over 989 TFLOP/s).  (c) with two
             cards or more, one process per card (NCCL, `chip_smoke.py
             image-rank DIR`): the tiny ResNet at dp = cards, 8 rows a
             card, every BatchNorm over the global batch, against card 0
             alone on the global batch at 1e-5, and a planted fault
             (bn_init with local statistics) that must fail; then
             ResNet-101 at 64 a card as (b): finite losses, peak < 80
             GB, and every weight and BatchNorm buffer bit-identical
             over the ranks (sha256); printed per rank and in total.  At
             one card it prints that (c) needs two.  (d)
             examples/elastic_train_torch.py --model resnet50 at 224, 64
             a card, one process per card: the discover_hosts.sh file
             goes from cards to cards / 2 hosts and back (at one card it
             stays at one), then a stop file ends it; checked: both
             WORLD-CHANGE ... restored=True lines in order, the step
             count going on across them, ELASTIC-TRAIN-OK with a finite
             final loss.  (e) examples/mnist_train_torch.py on card 0:
             its done line and a final loss below the first.
10. profile  after every measured phase, the serving phase's concurrent
             prompts on a fresh server of the same shape, once to warm
             up and once under torch.profiler: K4''s device ms per
             decode step (its split and merge kernels) and its share of
             the device's busy time.

Then it prints the phase seconds line, the card line and one
{"kernels": [...]} JSON line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import os
import re
import shutil
import subprocess
import tempfile
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SEED = 1234
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM device memory
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12, torch.int8: 1979e12}
SERVE_NEW_TOKENS = 32
SERVE_PROMPT_LENS = (5, 17, 40, 100, 300, 700, 1200, 2000)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    replayed once to warm up and once between CUDA events, so the
    Python wrapper's host time does not enter the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up outside capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200, rounds: int = 1) -> float:
    """Host time of one call (launch overhead of the Python wrapper):
    the median over ``rounds`` runs of ``iters`` calls each (the host's
    clock is shared with other work, so one run can be far off)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - t0) / iters * 1e6)
        torch.cuda.synchronize()
    return sorted(times)[len(times) // 2]


# -- phase 3: kernels --------------------------------------------------------

def head_rel_err(out, ref) -> float:
    """max over (row, query head) of max_d |out - ref| / max_d |ref|.
    A row's outputs shrink as its length grows (an average over more
    tokens), so an absolute limit would let faults in long rows pass."""
    o, r = out.float(), ref.float()
    err = (o - r).abs().amax(dim=-1)
    mag = r.abs().amax(dim=-1).clamp_min(torch.finfo(torch.float32).tiny)
    return (err / mag).max().item()


def paged_inputs(gen, b, h, kh, d, page, maxb, dtype, lens, int8, idle):
    """Pools, a table of disjoint random blocks per live row (block 0 is
    scratch), lengths; the last row is an idle slot when ``idle``."""
    from mpi_operator_tpu_torch.models.llama import quantize_kv

    dev = torch.device("cuda")
    nb = 1 + b * maxb
    q = torch.randn(b, h, d, generator=gen, device=dev).to(dtype)
    pk = torch.randn(nb, page, kh, d, generator=gen, device=dev).to(dtype)
    pv = torch.randn(nb, page, kh, d, generator=gen, device=dev).to(dtype)
    ks = vs = None
    if int8:
        pk, ks = quantize_kv(pk)
        pv, vs = quantize_kv(pv)
    table = (1 + torch.randperm(b * maxb, generator=gen, device=dev)
             ).reshape(b, maxb).to(torch.int32)
    if idle:
        table[-1] = 0
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, pk, pv, table.contiguous(), lengths, ks, vs


def paged_bound(q, pk, table, lengths, ks, window):
    """Least time for this call's data: live K/V (+ scales) read once,
    q read and out written once; operations 4*H*D per live token."""
    page, kh, d = pk.shape[1], pk.shape[2], pk.shape[3]
    maxb = table.shape[1]
    tbl = table.cpu().numpy()
    touched = np.zeros((pk.shape[0], page), bool)
    live_tokens = 0
    for row, length in enumerate(lengths.cpu().numpy().tolist()):
        hi = min(length, maxb * page)
        lo = max(0, length - window) if window else 0
        pos = np.arange(lo, hi)
        touched[tbl[row, pos // page], pos % page] = True
        live_tokens += len(pos)
    tok_bytes = 2 * kh * d * pk.element_size()
    if ks is not None:
        tok_bytes += 2 * kh * 4
    nbytes = (int(touched.sum()) * tok_bytes + 2 * q.numel() * q.element_size()
              + table.numel() * 4 + lengths.numel() * 4)
    ops = 4 * live_tokens * q.shape[1] * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[pk.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


MIXED7 = [4096, 3000, 2048, 1500, 1024, 517, 100, 5000]   # last idle
MIXED8 = [8192, 6000, 4096, 2500, 1024, 333, 17, 9000]    # last idle
# K4' cases: name, b, h, kh, d, page, maxb, dtype, lens, int8, idle, window
PAGED_CASES = [
    ("llama2_7b", 8, 32, 32, 128, 16, 256, torch.bfloat16, MIXED7, False,
     True, None),
    ("llama3_8b_gqa", 8, 32, 8, 128, 16, 512, torch.bfloat16, MIXED8, False,
     True, None),
    ("llama2_7b_int8", 8, 32, 32, 128, 16, 256, torch.bfloat16, MIXED7, True,
     True, None),
    ("llama2_7b_window", 8, 32, 32, 128, 16, 256, torch.bfloat16, MIXED7,
     False, True, 1024),
    ("llama2_7b_uniform", 8, 32, 32, 128, 16, 256, torch.bfloat16,
     [2048] * 8, False, False, None),
    ("f32_gqa", 4, 8, 2, 64, 16, 64, torch.float32, [1024, 700, 17, 1],
     False, False, None),
    # The shard shapes of tensor-parallel serving (phase 9): a rank's
    # query and KV heads of llama2_7b at tp 4 and 2 (the decode replica
    # of (d), bf16 and int8 pools), mixtral_8x7b at tp 4 and 2.
    ("llama2_7b_tp4", 8, 8, 8, 128, 16, 256, torch.bfloat16, MIXED7, False,
     True, None),
    ("llama2_7b_tp2", 8, 16, 16, 128, 16, 256, torch.bfloat16, MIXED7, False,
     True, None),
    ("llama2_7b_tp2_int8", 8, 16, 16, 128, 16, 256, torch.bfloat16, MIXED7,
     True, True, None),
    ("mixtral_tp4", 8, 8, 2, 128, 16, 256, torch.bfloat16, MIXED7, False,
     True, None),
    ("mixtral_tp2", 8, 16, 4, 128, 16, 256, torch.bfloat16, MIXED7, False,
     True, None),
]


def paged_case(gen, case):
    """(inputs, kernel call, plain call) of one PAGED_CASES entry."""
    from mpi_operator_tpu_torch.ops import paged_attention as pa

    (_, b, h, kh, d, page, maxb, dtype, lens, int8, idle, window) = case
    q, pk, pv, table, lengths, ks, vs = paged_inputs(
        gen, b, h, kh, d, page, maxb, dtype, lens, int8, idle)
    scale = 1.0 / d ** 0.5

    def kern(tbl=table):
        return pa.paged_decode_attention(q, pk, pv, tbl, lengths,
                                         k_scale=ks, v_scale=vs,
                                         window=window)

    def plain():
        return pa._torch_paged(q, pk, pv, table, lengths, scale,
                               k_scale=ks, v_scale=vs, window=window)

    bound = paged_bound(q, pk, table, lengths, ks, window)
    return (q, pk, table, lengths), kern, plain, bound


def kernel_phase():
    from mpi_operator_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    for case in PAGED_CASES:
        name, dtype = case[0], case[7]
        (q, pk, table, lengths), kern, plain, (bound_ms, bound_by) = \
            paged_case(gen, case)
        out = kern()
        again = kern()
        torch.cuda.synchronize()
        ref = plain()
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        err = (out.float() - ref.float()).abs().max().item()
        rel = head_rel_err(out, ref)
        if not torch.isfinite(out.float()).all():
            raise SystemExit(f"kernel case {name}: non-finite output")
        if not rel <= tol:
            raise SystemExit(f"kernel case {name}: error {rel} of the "
                             f"largest output exceeds tolerance {tol}")
        if not torch.equal(out, again):
            raise SystemExit(f"kernel case {name}: two calls differ")
        fault = None
        if name == "llama2_7b":
            # Negative control: one live page of the 4096-token row read
            # from another row's block must fail the limit.
            bad = table.clone()
            bad[0, 100] = table[1, 100]
            fault = head_rel_err(kern(bad), ref)
            if not fault > tol:
                raise SystemExit(f"kernel case {name}: a planted one-page "
                                 f"fault ({fault}) passes tolerance {tol}")
        plan = pa.split_plan(q.shape[0], pk.shape[2],
                             q.shape[1] // pk.shape[2], q.shape[2],
                             pk.shape[1], table.shape[1])
        ms = time_ms(kern, iters=20)
        plain_ms = time_ms(plain, iters=3)
        results[name] = dict(max_abs_err=err, max_rel_err=rel, tol=tol,
                             planted_fault_rel_err=fault,
                             bitwise_repeat=True, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, bound_share=bound_ms / ms,
                             host_us=host_us(kern, rounds=7),
                             split_plan=plan._asdict())
        print(f"kernel paged_decode_attention[{name}]: "
              + json.dumps(results[name]), flush=True)
        del q, pk, table, lengths, out, again, ref, kern, plain
        torch.cuda.empty_cache()
    return results


# -- phase 4: tiny-model parity -----------------------------------------------

def parity_phase():
    """Tiny f32 models (dense llama2_tiny and MoE mixtral_tiny): paged
    greedy generate on the card equals the plain path on the CPU."""
    from mpi_operator_tpu_torch.models.llama import (generate, llama2_tiny,
                                                     mixtral_tiny)
    from mpi_operator_tpu_torch.models.params import init_params

    for name, preset in (("tiny", llama2_tiny),
                         ("mixtral_tiny", mixtral_tiny)):
        cfg = preset(page_size=16)
        cpu_model = init_params(cfg, torch.Generator().manual_seed(SEED),
                                device="cpu")
        card_model = type(cpu_model)(cfg, device="cuda")
        card_model.load_state_dict(cpu_model.state_dict())
        prompt = np.random.default_rng(SEED).integers(1, cfg.vocab_size,
                                                      (4, 21))
        lengths = [21, 9, 16, 3]
        want = generate(cpu_model, prompt, 12, prompt_lengths=lengths)
        got = generate(card_model, prompt, 12, prompt_lengths=lengths).cpu()
        if not torch.equal(want, got):
            raise SystemExit(f"{name} paged generate: card {got.tolist()} "
                             f"!= cpu {want.tolist()}")
        print(f"parity: {name} f32 paged generate, card == cpu (4 rows x "
              f"12 tokens)", flush=True)


# -- phase 5: serving -------------------------------------------------------

def post(url, payload, timeout=600):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def read_sse(url, payload, timeout=600):
    """POST and parse an SSE response -> (events, seconds to first
    token event)."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    events, ttft = [], None
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if resp.headers["Content-Type"] != "text/event-stream":
            raise SystemExit("SSE response has the wrong content type")
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(json.loads(line[len("data: "):]))
                if ttft is None and "token" in events[-1]:
                    ttft = time.perf_counter() - t0
                if events[-1].get("done") or events[-1].get("error"):
                    break
    return events, ttft


def run_concurrently(fns):
    results = [None] * len(fns)
    errors = []

    def run(i):
        try:
            results[i] = fns[i]()
        except Exception as exc:  # surfaced below, after every join
            errors.append((i, repr(exc)))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(t.is_alive() for t in threads):
        raise SystemExit(f"concurrent requests failed: {errors}")
    return results


def serving_model():
    """llama2_7b at full width and depth, random bf16 weights from SEED,
    on the card."""
    from mpi_operator_tpu_torch.models.llama import llama2_7b
    from mpi_operator_tpu_torch.models.params import init_params

    cfg = llama2_7b()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    torch.cuda.synchronize()
    print(f"serving: llama2_7b random init ({cfg.n_layers} layers, dim "
          f"{cfg.dim}, {cfg.dtype}) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return model


def serving_phase(card: str, model, model_name: str = "llama2_7b"):
    """Returns the K4' launches of the run, the prompts, each prompt's
    stream alone, the inter-token latency, the peak memory and the
    printed stats."""
    from mpi_operator_tpu_torch.ops import paged_attention as pa
    from mpi_operator_tpu_torch.serving import InferenceServer
    from mpi_operator_tpu_torch.serving.batcher import prefix_page_digests

    cfg = model.config
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in SERVE_PROMPT_LENS]
    stream_prompt = rng.integers(1, cfg.vocab_size, 64).tolist()
    base = rng.integers(1, cfg.vocab_size, 48).tolist()     # 3 full pages
    pair = [base + rng.integers(1, cfg.vocab_size, 10).tolist(),
            base + rng.integers(1, cfg.vocab_size, 7).tolist()]
    n_new = SERVE_NEW_TOKENS

    # Reference: every prompt alone, on a server without prefix cache.
    ref_server = InferenceServer(model, max_batch_slots=8, kv_page_size=16,
                                 kv_prefix_cache=False,
                                 device="cuda").start()
    try:
        alone = [post(ref_server.url + "/generate",
                      {"tokens": [p], "max_new_tokens": n_new})["tokens"][0]
                 for p in prompts + [stream_prompt]]
    finally:
        ref_server.stop()
    del ref_server
    gc.collect()
    torch.cuda.empty_cache()

    server = InferenceServer(model, max_batch_slots=8, kv_page_size=16,
                             device="cuda").start()
    try:
        tm = server.telemetry
        torch.cuda.reset_peak_memory_stats()
        pa.LAUNCHES = 0
        t0 = time.perf_counter()
        fns = [lambda p=p: post(server.url + "/generate",
                                {"tokens": [p], "max_new_tokens": n_new})
               for p in prompts]
        fns.append(lambda: read_sse(server.url + "/generate",
                                    {"tokens": [stream_prompt],
                                     "max_new_tokens": n_new,
                                     "stream": True}))
        results = run_concurrently(fns)
        wall = time.perf_counter() - t0
        pair_out = [post(server.url + "/generate",
                         {"tokens": [p], "max_new_tokens": n_new})[
                             "tokens"][0] for p in pair]
        launches = pa.LAUNCHES
        dispatches = tm["dispatches_total"].value
        ticks = tm["ticks_total"].value
        transfers = tm["transfers_total"].value
        peak = torch.cuda.max_memory_allocated()
        prefix = server.batcher_stats()["prefix"]
        fleet = json.loads(get(server.url + "/fleet-state"))
        metrics = get(server.url + "/metrics")
        ttft = tm["ttft_seconds"]
        itl = tm["token_latency_seconds"]
    finally:
        server.stop()

    outs = [r["tokens"][0] for r in results[:-1]]
    events, sse_ttft = results[-1]
    streamed = [e["token"] for e in events if "token" in e]
    if not events or not events[-1].get("done"):
        raise SystemExit(f"SSE stream did not finish: {events[-1:]}")
    for name, toks in [*zip(map(str, SERVE_PROMPT_LENS), outs),
                       ("sse", streamed), ("pair-a", pair_out[0]),
                       ("pair-b", pair_out[1])]:
        if len(toks) != n_new:
            raise SystemExit(f"request {name}: {len(toks)} tokens, "
                             f"expected {n_new}")
    for n, got, want in zip(SERVE_PROMPT_LENS, outs, alone):
        if got != want:
            raise SystemExit(f"prompt of {n} tokens: concurrent stream "
                             f"{got} != alone {want}")
    if streamed != alone[-1]:
        raise SystemExit(f"SSE stream {streamed} != alone {alone[-1]}")
    if transfers != ticks:
        raise SystemExit(f"transfers {transfers} != ticks {ticks}")
    if launches != dispatches * cfg.n_layers or launches == 0:
        raise SystemExit(f"paged attention launches {launches} != decode "
                         f"steps {dispatches} x {cfg.n_layers}")
    hit = prefix["hit_blocks"]
    if hit < 3:
        raise SystemExit(f"prefix-sharing pair hit {hit} cached blocks, "
                         f"expected >= 3")
    want_digests = set(prefix_page_digests(pair[0], 16))
    if not want_digests <= set(fleet["prefix_digests"]):
        raise SystemExit("/fleet-state lacks the pair's prefix digests")
    if "serving_ttft_seconds_count" not in metrics:
        raise SystemExit("/metrics lacks serving_ttft_seconds")
    total = sum(len(o) for o in outs) + len(streamed)
    stats = {
        "card": card, "model": model_name, "n_layers": cfg.n_layers,
        "slots": 8,
        "page_size": 16,
        "concurrent_requests": len(fns), "new_tokens_each": n_new,
        "prompt_lens": list(SERVE_PROMPT_LENS),
        "concurrent_wall_s": wall,
        "output_tokens_per_s": total / wall,
        "ttft_mean_s": ttft.sum / ttft.count,
        "sse_client_ttft_s": sse_ttft,
        "inter_token_latency_mean_s": itl.sum / itl.count,
        "decode_steps": dispatches, "ticks": ticks, "transfers": transfers,
        "paged_attention_launches": launches,
        "prefix_hit_blocks": hit,
        "max_memory_allocated_bytes": peak,
    }
    print("serving: " + json.dumps(stats), flush=True)
    return {"launches": launches, "prompts": prompts, "alone": alone,
            "itl_mean_s": stats["inter_token_latency_mean_s"],
            "peak_bytes": peak, "stats": stats}


# -- phase 5e: disaggregated prefill/decode ----------------------------------

DISAGG_PROMPT_LENS = (100, 700, 2000)     # of SERVE_PROMPT_LENS
DISAGG_BLOCKS = 512                       # 4 GiB of bf16 pool per replica


def page_bytes(pages):
    """Raw KV bytes of exported pages (every pool leaf of every page)."""
    return sum(leaf.numel() * leaf.element_size()
               for p in pages for leaf in p["leaves"].values())


def disagg_run(card: str, model, prompts, kv: str):
    """One prefill/decode replica pair (see the module docstring, 5e)
    over ``prompts``, with pools of ``kv``; returns its stats and the
    decode replica's K4' launches."""
    from mpi_operator_tpu_torch.ops import paged_attention as pa
    from mpi_operator_tpu_torch.serving import InferenceServer
    from mpi_operator_tpu_torch.serving.batcher import prefix_page_digests
    from mpi_operator_tpu_torch.telemetry.trace import (TraceContext,
                                                        default_tracer)

    cfg = model.config
    tracer = default_tracer()
    common = dict(max_batch_slots=8, kv_page_size=16,
                  kv_cache_blocks=DISAGG_BLOCKS, kv_cache_dtype=kv,
                  model_name="llama2_7b", device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prefill = InferenceServer(model, role="prefill", **common).start()
    decode = InferenceServer(model, role="decode", **common).start()
    ptm, dtm = prefill.telemetry, decode.telemetry
    rows, contexts, decode_launches = [], [], 0
    try:
        for prompt in prompts:
            n = len(prompt)
            digests = prefix_page_digests(prompt, 16)
            ctx = TraceContext(f"req-disagg-{kv}-{n}", tracer.allocate_id())
            contexts.append(ctx)
            hit0 = decode.batcher_stats()["prefix"]["hit_blocks"]
            launches0, steps0 = pa.LAUNCHES, ptm["dispatches_total"].value
            t0 = time.perf_counter()
            reply = post(prefill.url + "/prefill", {
                "tokens": prompt, "trace_context": ctx.encode(),
                "transfer": {"url": decode.url, "have": []}})
            prefill_s = time.perf_counter() - t0
            if pa.LAUNCHES != launches0 or \
                    ptm["dispatches_total"].value != steps0:
                raise SystemExit(
                    f"disagg {kv} {n}: the prefill replica ran "
                    f"{ptm['dispatches_total'].value - steps0} decode steps"
                    f" and {pa.LAUNCHES - launches0} K4' launches")
            if not (reply["shipped"] == reply["imported"] == len(digests)
                    and reply["rejected"] == 0
                    and reply["digests"] == digests):
                raise SystemExit(f"disagg {kv} {n}: handoff {reply}")
            launches0, steps0 = pa.LAUNCHES, dtm["dispatches_total"].value
            events, ttft = read_sse(decode.url + "/generate", {
                "tokens": [prompt], "max_new_tokens": SERVE_NEW_TOKENS,
                "stream": True, "trace_context": ctx.encode()})
            launches = pa.LAUNCHES - launches0
            steps = dtm["dispatches_total"].value - steps0
            decode_launches += launches
            gained = decode.batcher_stats()["prefix"]["hit_blocks"] - hit0
            ref_events, ref_ttft = read_sse(prefill.url + "/generate", {
                "tokens": [prompt], "max_new_tokens": SERVE_NEW_TOKENS,
                "stream": True})
            got = [e["token"] for e in events if "token" in e]
            want = [e["token"] for e in ref_events if "token" in e]
            if gained != len(digests):
                raise SystemExit(f"disagg {kv} {n}: the decode replica hit "
                                 f"{gained} cached pages, expected "
                                 f"{len(digests)} (self-prefill fallback?)")
            if launches != steps * cfg.n_layers or launches == 0:
                raise SystemExit(f"disagg {kv} {n}: K4' launches {launches}"
                                 f" != decode steps {steps} x "
                                 f"{cfg.n_layers}")
            if len(got) != SERVE_NEW_TOKENS or got != want:
                raise SystemExit(f"disagg {kv} {n}: decode stream {got} != "
                                 f"reference {want}")
            sec = reply["seconds"]
            handoff = sec["export"] + sec["encode"] + sec["push"]
            rows.append({
                "prompt_len": n, "pages": len(digests),
                "wire_bytes": reply["bytes"],
                "prefill_ms": prefill_s * 1e3,
                "export_ms": sec["export"] * 1e3,
                "encode_ms": sec["encode"] * 1e3,
                "push_ms": sec["push"] * 1e3,
                "receiver_wire_decode_ms": sec["wire_decode"] * 1e3,
                "receiver_import_ms": sec["import"] * 1e3,
                "handoff_ms": handoff * 1e3,
                "decode_ttft_s": ttft, "reference_ttft_s": ref_ttft,
                "decode_steps": steps, "k4_launches": launches})

        # Byte integrity: the decode replica's pool holds what was sent.
        raw = 0
        for prompt, row in zip(prompts, rows):
            digests = prefix_page_digests(prompt, 16)
            sent = prefill._batcher.export_kv_pages(digests)
            held = decode._batcher.export_kv_pages(digests)
            if [p["digest"] for p in held] != digests or any(
                    not torch.equal(a["leaves"][k].view(torch.uint8),
                                    b["leaves"][k].view(torch.uint8))
                    for a, b in zip(sent, held) for k in a["leaves"]):
                raise SystemExit(f"disagg {kv}: the decode replica's pages "
                                 f"of the {len(prompt)}-token prompt differ "
                                 f"from the prefill replica's")
            row["raw_kv_bytes"] = page_bytes(sent)
            row["handoff_gb_per_s"] = (row["raw_kv_bytes"]
                                       / row["handoff_ms"] / 1e6)
            raw += row["raw_kv_bytes"]
        # Dedup: pages the destination names as present are not sent.
        digests = prefix_page_digests(prompts[0], 16)
        again = post(prefill.url + "/prefill", {
            "tokens": prompts[0],
            "transfer": {"url": decode.url, "have": digests}})
        if again["shipped"] != 0 or again["deduped"] != len(digests):
            raise SystemExit(f"disagg {kv}: re-ship was not pure dedup: "
                             f"{again}")
        # Spans: one serve_queue_wait and one prefill per replica request.
        events = tracer.events()
        for ctx in contexts:
            names = sorted(e["name"] for e in events
                           if e.get("trace_id") == ctx.trace_id
                           and e.get("parent_id") == ctx.span_id)
            if names != ["prefill", "prefill", "serve_queue_wait",
                         "serve_queue_wait"]:
                raise SystemExit(f"disagg {kv}: spans of {ctx.trace_id}: "
                                 f"{names}")
        bundle = json.loads(get(decode.url + "/debug-bundle"))["bundle"]
        with open(os.path.join(bundle, "MANIFEST.json")) as f:
            artifacts = json.load(f)["artifacts"]
        missing = [a for a in artifacts
                   if not os.path.isfile(os.path.join(bundle, a))]
        with open(os.path.join(bundle, "flight.jsonl")) as f:
            ring = [json.loads(line) for line in f]
        in_ring = {r["data"].get("trace_id") for r in ring
                   if r["kind"] == "span"
                   and r["data"]["name"] in ("prefill", "serve_queue_wait")}
        if missing or not {c.trace_id for c in contexts} <= in_ring:
            raise SystemExit(f"disagg {kv}: bundle {bundle} lacks "
                             f"{missing} or the serving spans")
        peak = torch.cuda.max_memory_allocated()
    finally:
        prefill.stop()
        decode.stop()
    stats = {"card": card, "model": "llama2_7b", "n_layers": cfg.n_layers,
             "kv_cache_dtype": kv, "slots": 8, "page_size": 16,
             "kv_cache_blocks": DISAGG_BLOCKS, "prompts": rows,
             "raw_kv_bytes": raw,
             "wire_bytes": sum(r["wire_bytes"] for r in rows),
             "pages": sum(r["pages"] for r in rows),
             "handoff_gb_per_s": raw / sum(r["handoff_ms"] for r in rows)
             / 1e6,
             "bundle_artifacts": artifacts,
             "max_memory_allocated_bytes": peak}
    return stats, decode_launches


def disagg_phase(card: str, model, serve):
    """Phase 5e: the bf16 pools over the three prompts, then int8 pools
    over the 700-token prompt (K4''s int8-pool path inside a model)."""
    from mpi_operator_tpu_torch.telemetry import flight

    os.environ.setdefault(flight.DEBUG_DIR_ENV,
                          os.path.join(HERE, "build", "debug-bundles"))
    by_len = dict(zip(SERVE_PROMPT_LENS, serve["prompts"]))
    bf16, launches = disagg_run(card, model,
                                [by_len[n] for n in DISAGG_PROMPT_LENS],
                                "auto")
    int8, int8_launches = disagg_run(card, model, [by_len[700]], "int8")
    print("disagg: " + json.dumps({"bf16_pools": bf16, "int8_pools": int8}),
          flush=True)
    return {"launches": launches, "int8_launches": int8_launches}


# -- phase 5f: MoE serving ---------------------------------------------------

MOE_SERVE_LAYERS = 16        # of 32: 47.0 GB of bf16 weights (93.4 at 32)


def moe_serving_phase(card: str):
    """mixtral_8x7b at full width, 16 of 32 layers, random bf16 weights
    from SEED on the card, through serving_phase (each prompt alone,
    then concurrently, K4' at GQA groups of 4); also the share of routed
    (token, expert) assignments per expert over the phase, every row the
    model routes (prefill tokens and decode rows, idle slots included),
    counted by forward hooks on the MoE layers."""
    import dataclasses

    from mpi_operator_tpu_torch.models.llama import mixtral_8x7b
    from mpi_operator_tpu_torch.models.params import init_params

    cfg = dataclasses.replace(mixtral_8x7b(), n_layers=MOE_SERVE_LAYERS)
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    torch.cuda.synchronize()
    print(f"moe serving: mixtral_8x7b random init ({cfg.n_layers} of 32 "
          f"layers, dim {cfg.dim}, {cfg.n_experts} experts top-"
          f"{cfg.top_k}, {cfg.dtype}) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    experts = torch.arange(cfg.n_experts, device="cuda")
    hits = []

    def count(module, inputs, output):
        # A comparison, not bincount: no host sync on the serving path.
        idx = module.last_routing[0]
        hits.append((idx[..., None] == experts).sum((0, 1)))

    hooks = [layer.feed_forward.register_forward_hook(count)
             for layer in model.layers]
    try:
        serve = serving_phase(card, model, model_name="mixtral_8x7b")
    finally:
        for h in hooks:
            h.remove()
    routed = torch.stack(hits).sum(0).double()
    share = (routed / routed.sum()).tolist()
    peak = serve["peak_bytes"]
    stats = {k: serve["stats"][k] for k in (
        "ttft_mean_s", "inter_token_latency_mean_s", "output_tokens_per_s",
        "decode_steps", "paged_attention_launches",
        "max_memory_allocated_bytes")}
    stats.update(card=card, model="mixtral_8x7b",
                 reduced=f"n_layers {cfg.n_layers} of 32",
                 routed_share_per_expert=share)
    print("moe serving: " + json.dumps(stats), flush=True)
    if not peak < 80e9:
        raise SystemExit(f"moe serving: peak memory {peak} bytes")
    if min(share) <= 0:
        raise SystemExit(f"moe serving: an expert routed nothing: {share}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return serve


def serving_profile_phase(prompts):
    """K4''s device time per decode step on the serving path: the
    serving phase's concurrent prompts on a server of the same shape (a
    fresh model from SEED), once to warm up and once under
    torch.profiler; the self device time of K4''s two kernels (split and
    merge) over the decode steps of that window, beside all kernels'
    device time.  It runs after every measured phase, so the profiler's
    host cost reaches none of their numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mpi_operator_tpu_torch.serving import InferenceServer

    model = serving_model()
    server = InferenceServer(model, max_batch_slots=8, kv_page_size=16,
                             device="cuda").start()
    fns = [lambda p=p: post(server.url + "/generate",
                            {"tokens": [p],
                             "max_new_tokens": SERVE_NEW_TOKENS})
           for p in prompts]
    try:
        run_concurrently(fns)
        steps0 = server.telemetry["dispatches_total"].value
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_concurrently(fns)
            torch.cuda.synchronize()
        steps = server.telemetry["dispatches_total"].value - steps0
    finally:
        server.stop()
    del server, model
    gc.collect()
    torch.cuda.empty_cache()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    k4 = sum(e.self_device_time_total for e in kernels
             if "paged_split_kernel" in e.key
             or "paged_merge_kernel" in e.key) / 1e3
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if steps <= 0 or k4 <= 0:
        raise SystemExit(f"serving profile: {steps} decode steps, K4' "
                         f"device time {k4} ms")
    result = {"decode_steps": steps,
              "paged_attention_ms_per_step": k4 / steps,
              "device_busy_ms_per_step": busy / steps,
              "paged_attention_share_of_device": k4 / busy}
    print("serving profile: " + json.dumps(result), flush=True)
    return result


# -- phase 5b: speculative decoding -------------------------------------------

SPEC_SLOTS = 4
SPEC_DRAFT_LEN = 4
SPEC_PROMPT_LENS = (64, 250, 600, 1000)


def generate_all(url, prompts, n_new, extra=None):
    """Every prompt as its own concurrent /generate request; with
    ``extra`` (prompt, request options), one more request beside them.
    Returns the token lists in order, ``extra``'s last."""
    fns = [lambda p=p: post(url + "/generate",
                            {"tokens": [p], "max_new_tokens": n_new})[
                                "tokens"][0] for p in prompts]
    if extra is not None:
        prompt, options = extra
        fns.append(lambda: post(url + "/generate", {
            "tokens": [prompt], "max_new_tokens": n_new, **options})[
                "tokens"][0])
    return run_concurrently(fns)


def step_and_wide_logits(model, prompt, stream):
    """f32 logits [len(stream), V] of the positions that chose
    ``stream``'s tokens, computed two ways: width-1 paged decode steps
    through K4' (the program of a plain tick) and one forward over the
    whole sequence (the kind of program a verify is)."""
    from mpi_operator_tpu_torch.models.llama import _prefill, init_cache
    from mpi_operator_tpu_torch.models.params import share_weights

    dev = model.device

    def ids(tokens):
        return torch.tensor([tokens], dtype=torch.int32, device=dev)

    paged = share_weights(model, page_size=16)
    with torch.inference_mode():
        logits, cache = _prefill(paged, ids(prompt), len(stream))
        narrow = [logits[0, -1].float()]
        for tok in stream[:-1]:
            narrow.append(paged(ids([tok]), cache=cache,
                                decode=True)[0, -1].float())
        seq = prompt + stream[:-1]
        wide = model(ids(seq), cache=init_cache(model.config, 1, dev,
                                                max_len=len(seq)),
                     decode=True)[0, len(prompt) - 1:].float()
    return torch.stack(narrow), wide


def stream_gaps(model, prompt, stream):
    """On the stream's own context: per position, the step logits' top
    value minus the logit of the token the stream chose there (0 where
    it chose the argmax), and the largest |step - wide| logit
    difference."""
    step, wide = step_and_wide_logits(model, prompt, stream)
    if not (torch.isfinite(step).all() and torch.isfinite(wide).all()):
        raise SystemExit("speculative: non-finite logits")
    chosen = torch.tensor(stream, device=step.device)[:, None]
    gaps = step.max(dim=-1).values - step.gather(1, chosen)[:, 0]
    return gaps.tolist(), (step - wide).abs().max().item()


def tie_failures(prompts, streams, gaps, logit_err):
    """Every token the streams chose where the step argmax is ahead of
    it by at least the logit error: a choice no rounding explains."""
    return [{"prompt_len": len(p), "position": j, "token": s[j], "gap": g}
            for p, s, gs in zip(prompts, streams, gaps)
            for j, g in enumerate(gs) if not g < logit_err]


def speculation_check(model, prompts, refs, outs, ref_gaps):
    """Speculative streams against the plain batcher's, every token of
    both.  Each stream is replayed on its own context through width-1
    paged steps (the program of a plain tick); each token it chose must
    be the replay's argmax, or short of it by less than the logit error:
    the largest |step - wide| difference of the two kinds of program
    (a width-1 step, a full forward like a verify) over every stream.
    In bf16 a near-tie can flip either way, and the plain batcher's
    batch of 4 sums the products in another order than the replay's
    batch of 1, so the rule holds for the reference streams too.
    Returns the statistics and the failures."""
    for ref, got in zip(refs, outs):
        if len(got) != len(ref):
            raise SystemExit(f"speculative: {len(got)} tokens, reference "
                             f"{len(ref)}")
    out_gaps = [stream_gaps(model, p, s) for p, s in zip(prompts, outs)]
    logit_err = max(e for _, e in ref_gaps + out_gaps)
    fails = (tie_failures(prompts, refs, [g for g, _ in ref_gaps], logit_err)
             + tie_failures(prompts, outs, [g for g, _ in out_gaps],
                            logit_err))
    first_diff = [next((j for j, (a, b) in enumerate(zip(got, ref))
                        if a != b), None) for ref, got in zip(refs, outs)]
    return {"logit_err": logit_err,
            "flips": sum(j is not None for j in first_diff),
            "first_differing_position": first_diff,
            "tokens_checked": 2 * sum(len(s) for s in outs),
            "largest_gap": max(max(g) for g, _ in ref_gaps + out_gaps),
            "near_ties": sum(0 < x for g, _ in ref_gaps + out_gaps
                             for x in g)}, fails


# Planted speculation faults, each a ContinuousBatcher that must fail
# the speculation check.
SPEC_FAULTS = ("emit_next_position", "verify_index_off_by_one")


def faulty_batcher(kind, model, **kwargs):
    """A speculative batcher with one planted fault in its verify.
    emit_next_position: the argmax of position j+1 stands for position
    j's, so acceptance and emission are shifted by one.
    verify_index_off_by_one: the verify reads and writes from one past
    the committed stream, a hole in every row's context."""
    from mpi_operator_tpu_torch.models.llama import _set_cache_index
    from mpi_operator_tpu_torch.serving import ContinuousBatcher

    class Faulty(ContinuousBatcher):
        def _verify_and_accept(self, *args):
            target = self.model

            def planted(tokens, cache, **kw):
                if kind == "verify_index_off_by_one":
                    idx = cache["layers_0"]["attention"]["cache_index"]
                    cache = _set_cache_index(cache, idx + 1)
                logits = target(tokens, cache=cache, **kw)
                if kind == "emit_next_position":
                    logits = torch.cat([logits[:, 1:], logits[:, -1:]], 1)
                return logits

            self.model = planted
            try:
                return super()._verify_and_accept(*args)
            finally:
                self.model = target

    return Faulty(model, **kwargs)


def speculative_phase(card: str, model):
    """Self-draft (the target is its own draft: no second copy of the
    weights, a dense draft cache of its own) and prompt-lookup
    speculation, 4 slots, draft_len 4, through InferenceServer over
    HTTP; every token of every stream held to the tie rule of
    ``speculation_check``.  The prompt-lookup run has one sampling
    request beside the greedy ones, which forces plain ticks: K4'
    launches == plain ticks x n_layers in both runs (the verify and the
    draft never reach K4').  Then each planted fault of SPEC_FAULTS, on
    the self-draft prompts, must fail the same check."""
    from mpi_operator_tpu_torch.ops import paged_attention as pa
    from mpi_operator_tpu_torch.serving import InferenceServer

    cfg = model.config
    n_new = SERVE_NEW_TOKENS
    rng = np.random.default_rng(SEED + 4)
    self_prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
                    for n in SPEC_PROMPT_LENS]
    # Prompts that repeat: a 200-token span quoted, then quoted again up
    # to its middle, so the n-gram lookup finds the continuation.
    lookup_prompts = []
    for n in (20, 60, 100, 150):
        span = rng.integers(1, cfg.vocab_size, 200).tolist()
        lookup_prompts.append(rng.integers(1, cfg.vocab_size, n).tolist()
                              + span
                              + rng.integers(1, cfg.vocab_size, 10).tolist()
                              + span[:100])
    sampled = (rng.integers(1, cfg.vocab_size, 48).tolist(),
               {"temperature": 0.8, "seed": 7})
    common = dict(max_batch_slots=SPEC_SLOTS, kv_page_size=16,
                  device=model.device)

    ref_server = InferenceServer(model, **common).start()
    try:
        refs = generate_all(ref_server.url, self_prompts + lookup_prompts,
                            n_new)
    finally:
        ref_server.stop()
    del ref_server
    gc.collect()
    torch.cuda.empty_cache()
    ref_gaps = [stream_gaps(model, p, r)
                for p, r in zip(self_prompts + lookup_prompts, refs)]

    results = {}
    for name, kwargs, prompts, extra in (
            ("self_draft", dict(draft_model=model), self_prompts, None),
            ("prompt_lookup", dict(draft_strategy="prompt_lookup"),
             lookup_prompts, sampled)):
        server = InferenceServer(model, draft_len=SPEC_DRAFT_LEN, **common,
                                 **kwargs).start()
        try:
            torch.cuda.reset_peak_memory_stats()
            pa.LAUNCHES = 0
            t0 = time.perf_counter()
            outs = generate_all(server.url, prompts, n_new, extra)
            wall = time.perf_counter() - t0
            launches = pa.LAUNCHES
            st = server.batcher_stats()["spec"]
            itl = server.telemetry["token_latency_seconds"]
            peak = torch.cuda.max_memory_allocated()
        finally:
            server.stop()
        del server
        gc.collect()
        torch.cuda.empty_cache()
        if extra is not None:
            if len(outs[-1]) != n_new:
                raise SystemExit(f"{name}: the sampling request gave "
                                 f"{len(outs[-1])} tokens")
            outs = outs[:-1]
            if not st["plain_ticks"] > 0:
                raise SystemExit(f"{name}: a sampling request forced no "
                                 f"plain tick: {st}")
        if not st["spec_ticks"] > 0:
            raise SystemExit(f"{name}: no speculation round ran: {st}")
        if launches != st["plain_ticks"] * cfg.n_layers:
            raise SystemExit(f"{name}: K4' launches {launches} != plain "
                             f"ticks {st['plain_ticks']} x {cfg.n_layers}")
        lo = 0 if name == "self_draft" else len(self_prompts)
        check, fails = speculation_check(
            model, prompts, refs[lo:lo + len(prompts)], outs,
            ref_gaps[lo:lo + len(prompts)])
        if fails:
            raise SystemExit(f"{name}: tokens chosen beyond a near-tie "
                             f"(logit error {check['logit_err']}): {fails}")
        results[name] = {
            "card": card, "model": "llama2_7b", "slots": SPEC_SLOTS,
            "draft_len": SPEC_DRAFT_LEN,
            "prompt_lens": [len(p) for p in prompts],
            "sampling_requests": int(extra is not None),
            "new_tokens_each": n_new, "spec_stats": st,
            "acceptance": st["accepted_drafts"] / max(1, st["drafted"]),
            "paged_attention_launches": launches, "wall_s": wall,
            "inter_token_latency_mean_s": itl.sum / max(1, itl.count),
            "max_memory_allocated_bytes": peak, **check}
        print(f"speculative[{name}]: " + json.dumps(results[name]),
              flush=True)

    planted = {}
    for kind in SPEC_FAULTS:
        b = faulty_batcher(kind, model, max_slots=SPEC_SLOTS, page_size=16,
                           draft_model=model, draft_len=SPEC_DRAFT_LEN,
                           device=model.device).start()
        try:
            outs = run_concurrently([lambda p=p: b.submit(p, n_new)
                                     for p in self_prompts])
        finally:
            b.stop()
        del b
        gc.collect()
        torch.cuda.empty_cache()
        check, fails = speculation_check(model, self_prompts,
                                         refs[:len(self_prompts)], outs,
                                         ref_gaps[:len(self_prompts)])
        planted[kind] = {"failing_tokens": len(fails),
                         "largest_gap": check["largest_gap"],
                         "logit_err": check["logit_err"],
                         "flips": check["flips"]}
        if not fails:
            raise SystemExit(f"speculative: the planted fault {kind} "
                             f"passed the check: {planted[kind]}")
    print("speculative[planted_faults]: " + json.dumps(planted), flush=True)
    results["planted_faults"] = planted
    return results


# -- phase 5c: chunked prefill ------------------------------------------------

PREFILL_CHUNK = 512
# Last-position logits of the chunked prefill against the unchunked one,
# largest difference over the largest |logit|: bf16 storage of K/V and
# activations, summed in another order across 32 layers.
CHUNK_LOGIT_LIMIT = 5e-2


def last_logit_errs(model, prompts, chunked_logits):
    """Per prompt length, the largest |chunked - dense| last-position
    logit difference over the dense prefill's largest |logit|."""
    from mpi_operator_tpu_torch.models.llama import init_cache

    dev = model.device
    errs = {}
    with torch.inference_mode():
        for prompt, chunked in zip(prompts, chunked_logits):
            ids = torch.tensor([prompt], dtype=torch.int32, device=dev)
            dense = model(ids, cache=init_cache(model.config, 1, dev,
                                                max_len=len(prompt)),
                          decode=True)[0, -1].float()
            errs[len(prompt)] = ((chunked.float() - dense).abs().max()
                                 / dense.abs().max()).item()
    return errs


def chunked_phase(card: str, model, serve):
    """The serving phase's prompts (5-2000 tokens) through chunked
    prefill (512-token batch-1 paged forwards, the batcher's
    ``prefill_logits``): last-position logits against the unchunked
    dense prefill within CHUNK_LOGIT_LIMIT.  A planted fault, a last
    chunk that ignores the earlier chunks (the last chunk prefilled
    alone: RoPE scores depend only on relative positions), must exceed
    the limit.  Then the same prompts as concurrent requests to
    InferenceServer(kv_prefill_chunk=512): first tokens and streams
    against the serving phase's streams alone, K4' launches == decode
    steps x n_layers."""
    from mpi_operator_tpu_torch.ops import paged_attention as pa
    from mpi_operator_tpu_torch.serving import (ContinuousBatcher,
                                                InferenceServer)

    cfg = model.config
    prompts, alone = serve["prompts"], serve["alone"]
    dev = model.device
    b = ContinuousBatcher(model, max_slots=1, page_size=16,
                          prefill_chunk=PREFILL_CHUNK, device=dev)
    errs = last_logit_errs(model, prompts,
                           [b.prefill_logits(p) for p in prompts])
    long = [p for p in prompts if len(p) > PREFILL_CHUNK]
    fault = last_logit_errs(model, long, [
        b.prefill_logits(p[(len(p) - 1) // PREFILL_CHUNK * PREFILL_CHUNK:])
        for p in long])
    del b
    gc.collect()
    torch.cuda.empty_cache()
    if not all(e <= CHUNK_LOGIT_LIMIT for e in errs.values()):
        raise SystemExit(f"chunked: last-position logits {errs} exceed "
                         f"{CHUNK_LOGIT_LIMIT} of the largest logit")
    if not max(fault.values()) > CHUNK_LOGIT_LIMIT:
        raise SystemExit(f"chunked: the planted fault (a last chunk that "
                         f"ignores the earlier ones) gave {fault}, within "
                         f"{CHUNK_LOGIT_LIMIT}")

    server = InferenceServer(model, max_batch_slots=8, kv_page_size=16,
                             kv_prefill_chunk=PREFILL_CHUNK,
                             device=dev).start()
    try:
        tm = server.telemetry
        torch.cuda.reset_peak_memory_stats()
        pa.LAUNCHES = 0
        outs = generate_all(server.url, prompts, SERVE_NEW_TOKENS)
        launches = pa.LAUNCHES
        dispatches = tm["dispatches_total"].value
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.stop()
    del server
    gc.collect()
    torch.cuda.empty_cache()
    if any(len(o) != SERVE_NEW_TOKENS for o in outs):
        raise SystemExit(f"chunked: token counts {[len(o) for o in outs]}")
    # A last chunk of one token is a width-1 forward: it runs on K4' too.
    single = sum(1 for p in prompts
                 if len(p) > PREFILL_CHUNK and len(p) % PREFILL_CHUNK == 1)
    if launches != (dispatches + single) * cfg.n_layers or launches == 0:
        raise SystemExit(f"chunked: K4' launches {launches} != (decode "
                         f"steps {dispatches} + one-token chunks {single})"
                         f" x {cfg.n_layers}")
    stats = {
        "card": card, "model": "llama2_7b", "prefill_chunk": PREFILL_CHUNK,
        "prompt_lens": [len(p) for p in prompts],
        "last_logit_rel_err": errs, "limit": CHUNK_LOGIT_LIMIT,
        "planted_fault_rel_err": fault,
        "first_tokens_agree": sum(o[0] == a[0] for o, a in zip(outs, alone)),
        "streams_agree": sum(o == a for o, a in zip(outs, alone)),
        "requests": len(prompts), "decode_steps": dispatches,
        "paged_attention_launches": launches,
        "max_memory_allocated_bytes": peak}
    print("chunked: " + json.dumps(stats), flush=True)
    return stats


# -- phase 5d: weight-only int8 -------------------------------------------------

INT8_LOGIT_LIMIT = 0.2


def int8_logits(model, prompt):
    """f32 logits [len(prompt), V] of one dense forward, on the CPU."""
    from mpi_operator_tpu_torch.models.llama import init_cache

    dev = model.device
    ids = torch.tensor([prompt], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        return model(ids, cache=init_cache(model.config, 1, dev,
                                           max_len=len(prompt)),
                     decode=True)[0].float().cpu()


def int8_phase(card: str, qmodel, ref_logits, prompt, serve):
    """The quantized 7B (the bf16 copy already freed) serves the serving
    phase's prompts, 8 slots, through K4'.  Checked: the logits of one
    prompt against the bf16 weights' (largest difference over the
    largest |logit| below INT8_LOGIT_LIMIT, a guard against a wrong
    scale layout, which gives errors near 1), token counts, K4' launches
    == decode steps x n_layers.  Printed: peak memory beside the bf16
    phase's, mean inter-token latency."""
    from mpi_operator_tpu_torch.ops import paged_attention as pa
    from mpi_operator_tpu_torch.serving import InferenceServer

    cfg = qmodel.config
    q_logits = int8_logits(qmodel, prompt)
    rel = ((q_logits - ref_logits).abs().max()
           / ref_logits.abs().max()).item()
    top1 = (q_logits.argmax(-1) == ref_logits.argmax(-1)).float().mean()
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       list(qmodel.parameters()) + list(qmodel.buffers()))
    torch.cuda.reset_peak_memory_stats()
    server = InferenceServer(qmodel, max_batch_slots=8, kv_page_size=16,
                             device=qmodel.device).start()
    try:
        tm = server.telemetry
        pa.LAUNCHES = 0
        t0 = time.perf_counter()
        outs = generate_all(server.url, serve["prompts"], SERVE_NEW_TOKENS)
        wall = time.perf_counter() - t0
        launches = pa.LAUNCHES
        dispatches = tm["dispatches_total"].value
        itl = tm["token_latency_seconds"]
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.stop()
    del server
    if any(len(o) != SERVE_NEW_TOKENS for o in outs):
        raise SystemExit(f"int8: token counts {[len(o) for o in outs]}")
    if launches != dispatches * cfg.n_layers or launches == 0:
        raise SystemExit(f"int8: K4' launches {launches} != decode steps "
                         f"{dispatches} x {cfg.n_layers}")
    if not (torch.isfinite(q_logits).all() and rel < INT8_LOGIT_LIMIT):
        raise SystemExit(f"int8: logits error {rel} against bf16 weights "
                         f"(limit {INT8_LOGIT_LIMIT})")
    stats = {
        "card": card, "model": "llama2_7b", "weight_dtype": "int8",
        "slots": 8, "weight_bytes": weight_bytes,
        "logit_rel_err_vs_bf16": rel, "top1_agree_vs_bf16": top1.item(),
        "logit_prompt_len": len(prompt),
        "max_memory_allocated_bytes": peak,
        "bf16_serving_peak_bytes_this_run": serve["peak_bytes"],
        "inter_token_latency_mean_s": itl.sum / itl.count,
        "bf16_inter_token_latency_mean_s": serve["itl_mean_s"],
        "concurrent_wall_s": wall, "decode_steps": dispatches,
        "paged_attention_launches": launches,
        "first_tokens_agree_vs_bf16": sum(
            o[0] == a[0] for o, a in zip(outs, serve["alone"]))}
    print("int8: " + json.dumps(stats), flush=True)
    return stats


# -- phase 3b: flash attention kernels ---------------------------------------

FLASH_LIMITS = {torch.bfloat16: (2e-2, 5e-2), torch.float32: (2e-5, 5e-4)}


def bh_rel_err(out, ref) -> float:
    """max over (batch, head) of max |out - ref| / max |ref| on
    [B, H, S, ...] tensors."""
    o, r = out.float().flatten(2), ref.float().flatten(2)
    err = (o - r).abs().amax(dim=-1)
    mag = r.abs().amax(dim=-1).clamp_min(torch.finfo(torch.float32).tiny)
    return (err / mag).max().item()


def event_ms(fn, iters: int) -> float:
    """Device time of one call between CUDA events, without a graph (for
    the plain versions and the library yardstick, which allocate)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


FLASH_PRODUCTS = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}


def flash_flops(b, h, s, d, causal):
    """{kernel: flops}: 2 per multiply-add of each product over the
    unmasked (q, k) pairs (S and P V forward; S, dP, dQ for dq; S, dP,
    dV, dK for dkv)."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    return {name: 2 * products * pairs * d
            for name, products in FLASH_PRODUCTS.items()}


def flash_bounds(b, h, s, d, dtype, causal):
    """{kernel: (bound ms, bound_by)}: each input read once and each
    output written once over 3.35 TB/s; the products' flops over the
    type's peak."""
    tile = b * h * s * d * torch.tensor([], dtype=dtype).element_size()
    rows = b * h * s * 4
    nbytes = {"flash_fwd": 3 * tile + tile + rows,
              "flash_bwd_dq": 4 * tile + 2 * rows + tile,
              "flash_bwd_dkv": 4 * tile + 2 * rows + 2 * tile}
    out = {}
    for name, flops in flash_flops(b, h, s, d, causal).items():
        t_ops = flops / PEAK_OPS[dtype] * 1e3
        t_bytes = nbytes[name] / HBM_BYTES_PER_S * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def flash_case(fa, gen, name, b, h, s, d, dtype, causal, timed=False):
    """K1', K2', K3' against their plain versions at one shape; with
    ``timed``, a planted fault and the times of kernel, plain version
    and SDPA."""
    dev = torch.device("cuda")
    q, k, v, g = (torch.randn(b, h, s, d, generator=gen, device=dev)
                  .to(dtype) for _ in range(4))
    scale = d ** -0.5
    fwd_tol, grad_tol = FLASH_LIMITS[dtype]
    out, lse = fa._flash_forward(q, k, v, scale, causal)
    delta = (g.float() * out.float()).sum(-1)
    dq = fa._cuda_bwd_dq(q, k, v, g, lse, delta, scale, causal)
    dk, dv = fa._cuda_bwd_dkv(q, k, v, g, lse, delta, scale, causal)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa._plain_forward(q, k, v, scale, causal)
    ref_dq = fa._torch_bwd_dq(q, k, v, g, ref_lse, delta, scale, causal)
    ref_dk, ref_dv = fa._torch_bwd_dkv(q, k, v, g, ref_lse, delta, scale,
                                       causal)
    errs = {"flash_fwd": bh_rel_err(out, ref_out),
            "flash_bwd_dq": bh_rel_err(dq, ref_dq),
            "flash_bwd_dkv": max(bh_rel_err(dk, ref_dk),
                                 bh_rel_err(dv, ref_dv))}
    abs_errs = {"flash_fwd": (out.float() - ref_out).abs().max().item(),
                "flash_bwd_dq": (dq.float() - ref_dq.float()).abs().max()
                .item(),
                "flash_bwd_dkv": max(
                    (dk.float() - ref_dk.float()).abs().max().item(),
                    (dv.float() - ref_dv.float()).abs().max().item())}
    lse_err = (lse - ref_lse).abs().max().item()
    for kern, err in errs.items():
        tol = fwd_tol if kern == "flash_fwd" else grad_tol
        if not (err <= tol and torch.isfinite(torch.tensor(err))):
            raise SystemExit(f"flash case {name}: {kern} error {err} of the "
                             f"largest value exceeds {tol}")
    if not lse_err <= 1e-3:
        raise SystemExit(f"flash case {name}: lse error {lse_err}")
    result = {"shape": [b, h, s, d], "dtype": str(dtype), "causal": causal,
              "rel_err": errs, "max_abs_err": abs_errs, "lse_err": lse_err}
    if timed:
        # K1', K2' and K3' own their output tiles (no atomics): a second
        # call on the same inputs must give the same bits.
        again = (*fa._flash_forward(q, k, v, scale, causal),
                 fa._cuda_bwd_dq(q, k, v, g, lse, delta, scale, causal),
                 *fa._cuda_bwd_dkv(q, k, v, g, lse, delta, scale, causal))
        names = ("out", "lse", "dq", "dk", "dv")
        same = {n: torch.equal(x, y)
                for n, x, y in zip(names, (out, lse, dq, dk, dv), again)}
        if not all(same.values()):
            raise SystemExit(f"flash case {name}: outputs differ between "
                             f"two calls on the same inputs: {same}")
        result["bitwise_repeat"] = same
        del again
        # Negative control: key block 0 of head 0 replaced by block 10,
        # given to the kernels only, must fail every limit.
        bad = k.clone()
        bad[0, 0, :64] = k[0, 0, 640:704]
        f_out, f_lse = fa._flash_forward(q, bad, v, scale, causal)
        f_dq = fa._cuda_bwd_dq(q, bad, v, g, lse, delta, scale, causal)
        f_dk, f_dv = fa._cuda_bwd_dkv(q, bad, v, g, lse, delta, scale,
                                      causal)
        faults = {"flash_fwd": bh_rel_err(f_out, ref_out),
                  "flash_bwd_dq": bh_rel_err(f_dq, ref_dq),
                  "flash_bwd_dkv": max(bh_rel_err(f_dk, ref_dk),
                                       bh_rel_err(f_dv, ref_dv))}
        for kern, err in faults.items():
            tol = fwd_tol if kern == "flash_fwd" else grad_tol
            if not err > tol:
                raise SystemExit(f"flash case {name}: a planted fault "
                                 f"({err}) passes {kern}'s limit {tol}")
        result["planted_fault_rel_err"] = faults
        del bad, f_out, f_lse, f_dq, f_dk, f_dv
        kerns = {
            "flash_fwd": lambda: fa._flash_forward(q, k, v, scale, causal),
            "flash_bwd_dq": lambda: fa._cuda_bwd_dq(
                q, k, v, g, lse, delta, scale, causal),
            "flash_bwd_dkv": lambda: fa._cuda_bwd_dkv(
                q, k, v, g, lse, delta, scale, causal)}
        plains = {
            "flash_fwd": lambda: fa._plain_forward(q, k, v, scale, causal),
            "flash_bwd_dq": lambda: fa._torch_bwd_dq(
                q, k, v, g, ref_lse, delta, scale, causal),
            "flash_bwd_dkv": lambda: fa._torch_bwd_dkv(
                q, k, v, g, ref_lse, delta, scale, causal)}
        del ref_out, ref_dq, ref_dk, ref_dv
        torch.cuda.empty_cache()
        result["ms"] = {n: time_ms(fn, iters=10) for n, fn in kerns.items()}
        result["host_us"] = {n: host_us(fn, iters=50)
                             for n, fn in kerns.items()}
        result["plain_ms"] = {n: event_ms(fn, iters=2)
                              for n, fn in plains.items()}
        sdpa = torch.nn.functional.scaled_dot_product_attention
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        result["sdpa_fwd_ms"] = event_ms(
            lambda: sdpa(*leaves, is_causal=causal), iters=10)
        sdpa_out = sdpa(*leaves, is_causal=causal)
        result["sdpa_bwd_ms"] = event_ms(
            lambda: torch.autograd.grad(sdpa_out, leaves, g,
                                        retain_graph=True), iters=10)
        result["bounds"] = flash_bounds(b, h, s, d, dtype, causal)
        flops = flash_flops(b, h, s, d, causal)
        result["tflops"] = {n: flops[n] / ms / 1e9
                            for n, ms in result["ms"].items()}
        result["bound_share"] = {n: result["bounds"][n][0] / ms
                                 for n, ms in result["ms"].items()}
        del leaves, sdpa_out
    print(f"kernel flash[{name}]: " + json.dumps(result), flush=True)
    torch.cuda.empty_cache()
    return result


def flash_lse_case(fa, gen, causal: bool = True):
    """flash_attention_with_lse with an lse cotangent (dlse folded into
    delta) against autograd through the plain version; causal (the
    diagonal chunk of a ring) or not (the chunks behind it)."""
    dev = torch.device("cuda")
    q, k, v, g = (torch.randn(1, 8, 1024, 128, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    gl = torch.randn(1, 8, 1024, generator=gen, device=dev)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = fa.flash_attention_with_lse(*leaves, None, causal)
    ((out * g.float()).sum() + (lse * gl).sum()).backward()
    plain = [x.clone().float().requires_grad_() for x in (q, k, v)]
    pout, plse = fa._plain_forward(*plain, 128 ** -0.5, causal)
    ((pout * g.float()).sum() + (plse * gl).sum()).backward()
    errs = [bh_rel_err(out, pout)] + [bh_rel_err(a.grad, b.grad)
                                      for a, b in zip(leaves, plain)]
    limits = [FLASH_LIMITS[torch.bfloat16][0]] + \
        [FLASH_LIMITS[torch.bfloat16][1]] * 3
    name = "with_lse_dlse" + ("" if causal else "_non_causal")
    if not all(e <= t for e, t in zip(errs, limits)):
        raise SystemExit(f"flash_attention_with_lse with dlse (causal="
                         f"{causal}): errors {errs} exceed {limits}")
    print(f"kernel flash[{name}]: out/dq/dk/dv rel err {errs}", flush=True)
    return errs


def flash_phase():
    from mpi_operator_tpu_torch.ops import attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, b, h, s, d, dtype, causal, timed
        ("llama2_7b_train", 2, 32, 4096, 128, bf16, True, True),
        ("non_causal", 1, 32, 2048, 128, bf16, False, False),
        ("ragged_4095", 1, 32, 4095, 128, bf16, True, False),
        ("head_dim_64", 1, 32, 4096, 64, bf16, True, False),
        ("f32", 1, 8, 1024, 64, f32, True, False),
        # A chunk behind the diagonal in phase 11's ring: S/sp = 8192.
        ("ring_chunk_8192", 1, 32, 8192, 128, bf16, False, False),
    ]
    results = {c[0]: flash_case(fa, gen, *c) for c in cases}
    results["with_lse_dlse"] = flash_lse_case(fa, gen)
    results["with_lse_dlse_non_causal"] = flash_lse_case(fa, gen, False)
    return results


# -- phase 3c: fused RMSNorm ---------------------------------------------------

RMSNORM_EPS = 1e-5
RMSNORM_LIMITS = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
RSTD_LIMIT = 2e-5


def rmsnorm_bound(rows, d, dtype, scale_dtype):
    """x read once, y written once, scale read once, rstd written once
    over 3.35 TB/s; about 4 f32 operations per element over the f32
    peak; the larger of the two."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * rows * d * size
              + d * torch.tensor([], dtype=scale_dtype).element_size()
              + rows * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * rows * d / PEAK_OPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def rmsnorm_case(rn, gen, name, shape, dtype, scale_dtype, timed):
    """K5' against its plain version at one shape: per row, the largest
    error over the largest |plain output|, and rstd's relative error.
    With ``timed``: a planted fault (row 0 normalised with a scale 5% too
    large) must exceed the limit; kernel, plain and library times."""
    dev = torch.device("cuda")
    d = shape[-1]
    rows = int(np.prod(shape[:-1]))
    # Rows of different magnitudes, so a per-row fault cannot hide.
    x = (torch.randn(shape, generator=gen, device=dev)
         * torch.rand(shape[:-1] + (1,), generator=gen, device=dev)
         .mul(8).add(0.1)).to(dtype)
    scale = (torch.randn(d, generator=gen, device=dev) * 0.1 + 1.0
             ).to(scale_dtype)
    tol = RMSNORM_LIMITS[dtype]
    before = dict(rn.VARIANT_LAUNCHES)
    out, rstd = rn._cuda_forward(x, scale, RMSNORM_EPS)
    torch.cuda.synchronize()
    # The kernel this shape took: one launch, counted under its name.
    took = [n for n in before if rn.VARIANT_LAUNCHES[n] != before[n]]
    row_vecs = rn.kernel_variant(d, x.element_size(), x.data_ptr(),
                                 out.data_ptr())
    if took != ["rows" if row_vecs else "two_pass"]:
        raise SystemExit(f"rmsnorm case {name}: launched {took}, "
                         f"kernel_variant gave {row_vecs}")
    ref, ref_rstd = rn._plain_forward(x, scale, RMSNORM_EPS)
    if not torch.isfinite(out.float()).all():
        raise SystemExit(f"rmsnorm case {name}: non-finite output")
    rel = head_rel_err(out.view(rows, d), ref.view(rows, d))
    rstd_rel = ((rstd - ref_rstd).abs() / ref_rstd).max().item()
    if not (rel <= tol and rstd_rel <= RSTD_LIMIT):
        raise SystemExit(f"rmsnorm case {name}: row error {rel} (limit "
                         f"{tol}), rstd error {rstd_rel} (limit "
                         f"{RSTD_LIMIT})")
    result = {"shape": list(shape), "dtype": str(dtype),
              "scale_dtype": str(scale_dtype), "max_rel_err": rel,
              "max_abs_err": (out.float() - ref.float()).abs().max().item(),
              "rstd_rel_err": rstd_rel, "tol": tol, "kernel": took[0],
              "row_vecs": row_vecs}
    bound_ms, bound_by = rmsnorm_bound(rows, d, dtype, scale_dtype)
    result.update(bound_ms=bound_ms, bound_by=bound_by)
    if timed:
        x2 = x.view(rows, d)
        bad = out.view(rows, d).clone()
        bad[0] = rn._cuda_forward(x2[:1], scale * 1.05, RMSNORM_EPS)[0][0]
        fault = head_rel_err(bad, ref.view(rows, d))
        if not fault > tol:
            raise SystemExit(f"rmsnorm case {name}: a planted fault "
                             f"({fault}) passes the limit {tol}")
        result["planted_fault_rel_err"] = fault
        lib_scale = scale.to(dtype)
        result["ms"] = time_ms(
            lambda: rn._cuda_forward(x, scale, RMSNORM_EPS), iters=50)
        result["plain_ms"] = event_ms(
            lambda: rn._plain_forward(x, scale, RMSNORM_EPS), iters=10)
        # The library yardstick takes its weight in x's type.
        result["library_ms"] = time_ms(
            lambda: torch.nn.functional.rms_norm(x, (d,), lib_scale,
                                                 RMSNORM_EPS), iters=50)
        # A device copy of the same bytes (x read once, y written once):
        # what a streaming kernel reaches on this card, beside the bound.
        result["copy_ms"] = time_ms(lambda: out.copy_(x), iters=50)
        result["host_us"] = host_us(
            lambda: rn._cuda_forward(x, scale, RMSNORM_EPS))
        result["bound_share"] = bound_ms / result["ms"]
    print(f"kernel rmsnorm[{name}]: " + json.dumps(result), flush=True)
    del x, out, ref
    torch.cuda.empty_cache()
    return result


def rmsnorm_path(rn):
    """K5's main path, its public entry points, at the training shape:
    ``rmsnorm(impl="auto")`` forward, and ``fused_rmsnorm`` forward and
    backward (the custom VJP).  Checked against autograd through the
    plain version in f32.  Returns the launches counted in this run."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    shape, d = (2, 4096, 4096), 4096
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    scale = torch.randn(d, generator=gen, device="cuda") * 0.1 + 1.0
    g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    leaf_x = x.clone().requires_grad_()
    leaf_s = scale.clone().requires_grad_()
    rn.LAUNCHES["rmsnorm"] = 0
    y_auto = rn.rmsnorm(x, scale, RMSNORM_EPS)
    y = rn.fused_rmsnorm(leaf_x, leaf_s, RMSNORM_EPS)
    y.backward(g)
    torch.cuda.synchronize()
    launches = rn.LAUNCHES["rmsnorm"]
    px = x.float().requires_grad_()
    ps = scale.clone().requires_grad_()
    ref = rn._plain_rmsnorm(px, ps, RMSNORM_EPS)
    ref.backward(g.float())
    errs = {"y_auto": head_rel_err(y_auto.view(-1, d), ref.view(-1, d)),
            "y": head_rel_err(y.view(-1, d), ref.view(-1, d)),
            "dx": head_rel_err(leaf_x.grad.view(-1, d),
                               px.grad.view(-1, d)),
            "dscale": ((leaf_s.grad - ps.grad).abs().max()
                       / ps.grad.abs().max()).item()}
    limits = {"y_auto": 2e-2, "y": 2e-2, "dx": 5e-2, "dscale": 5e-2}
    print(f"rmsnorm path: launches {launches}, errors {errs} (limits "
          f"{limits})", flush=True)
    if launches != 2:
        raise SystemExit(f"rmsnorm path: {launches} K5' launches, want 2 "
                         f"(rmsnorm auto + fused_rmsnorm forward)")
    if not all(errs[k] <= limits[k] for k in errs):
        raise SystemExit(f"rmsnorm path: errors {errs} exceed {limits}")
    return launches


def rmsnorm_phase():
    import importlib

    # The package re-exports the function ``rmsnorm`` under the module's
    # name, so the module is fetched by its full name.
    rn = importlib.import_module("mpi_operator_tpu_torch.ops.rmsnorm")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, shape, dtype, scale dtype, timed
        ("train_bf16", (2, 4096, 4096), bf16, f32, True),
        ("train_f32", (2, 4096, 4096), f32, f32, True),
        ("decode_bf16", (8, 1, 4096), bf16, f32, True),
        ("wide_5120", (1024, 5120), bf16, f32, False),
        ("wide_8192", (1024, 8192), bf16, f32, False),
        ("wide_32768", (64, 32768), bf16, f32, False),
        ("ragged_bf16", (1003, 4100), bf16, bf16, False),
        ("ragged_f32", (37, 4099), f32, f32, False),
    ]
    results = {c[0]: rmsnorm_case(rn, gen, *c) for c in cases}
    kernels = {r["kernel"] for r in results.values()}
    if kernels != {"rows", "two_pass"}:
        raise SystemExit(f"rmsnorm: both K5' kernels must run, ran "
                         f"{kernels}")
    results["launches"] = rmsnorm_path(rn)
    return results


def rmsnorm_entry(results):
    main_case = results["train_bf16"]
    cases = {n: r for n, r in results.items() if isinstance(r, dict)}
    return {
        "name": "rmsnorm",
        "route": "cuda",
        "source": "mpi_operator_tpu_torch/ops/csrc/rmsnorm.cu",
        "replaces": "mpi_operator_tpu/ops/rmsnorm.py:20",
        "launches": results["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in cases.values()),
        "max_rel_err": {n: r["max_rel_err"] for n, r in cases.items()},
        "planted_fault_rel_err": main_case["planted_fault_rel_err"],
        "ms": main_case["ms"],
        "host_us": main_case["host_us"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "bound_share": main_case["bound_share"],
        "copy_ms": main_case["copy_ms"],
        "kernel_by_case": {n: r["kernel"] for n, r in cases.items()},
        "f32": {k: results["train_f32"][k] for k in
                ("ms", "plain_ms", "library_ms", "copy_ms", "bound_ms",
                 "bound_share")},
        "decode": {k: results["decode_bf16"][k] for k in
                   ("ms", "plain_ms", "library_ms", "copy_ms", "bound_ms",
                    "bound_share")},
    }


# -- phase 4b: training parity -------------------------------------------------

def train_parity_phase(preset_name="llama2_tiny"):
    """A tiny f32 model's first two train steps through the kernels on the
    card equal the plain path on the CPU (loss and grad_norm at 1e-4):
    the dense llama2_tiny, or the MoE mixtral_tiny."""
    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.models.llama import next_token_loss
    from mpi_operator_tpu_torch.models.params import init_params
    from mpi_operator_tpu_torch.ops import attention as fa
    from mpi_operator_tpu_torch.parallel.train import adamw, build_train_step

    # head_dim 64 (the kernels take 64 or 128), GQA, a ragged sequence.
    cfg = getattr(llama, preset_name)(dim=128, n_heads=2, n_kv_heads=1)
    cpu_model = init_params(cfg, torch.Generator().manual_seed(SEED),
                            device="cpu", dtype=torch.float32)
    card_model = type(cpu_model)(cfg, device="cuda",
                                 store_dtype=torch.float32)
    card_model.load_state_dict(cpu_model.state_dict())
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, 80)))

    def loss_fn(model, batch):
        return next_token_loss(model(batch), batch)

    metrics = []
    for model, batch in ((cpu_model, tokens), (card_model, tokens.cuda())):
        init, step = build_train_step(loss_fn, adamw(3e-4))
        state = init(model)
        before = dict(fa.LAUNCHES)
        rows = []
        for _ in range(2):
            state, m = step(state, batch)
            rows.append((m["loss"].item(), m["grad_norm"].item()))
        metrics.append(rows)
        launched = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
    if any(n != 2 * cfg.n_layers for n in launched.values()):
        raise SystemExit(f"training parity: kernel launches {launched}, "
                         f"expected {2 * cfg.n_layers} each")
    for (cl, cn), (gl, gn) in zip(*metrics):
        if not (abs(cl - gl) <= 1e-4 * max(1.0, abs(cl))
                and abs(cn - gn) <= 1e-4 * max(1.0, abs(cn))):
            raise SystemExit(f"training parity: card {metrics[1]} != cpu "
                             f"{metrics[0]}")
    print(f"parity: {preset_name} f32 training, 2 AdamW steps, card "
          f"{metrics[1]} == cpu {metrics[0]} (loss, grad_norm) at 1e-4",
          flush=True)


# -- phase 6: training -----------------------------------------------------------

# Per model: layers of 32, batch, sequence, steps (one warm + the rest
# timed).  f32 weights, gradients and two Adam moments (16 B a parameter)
# set the cut: llama2_7b 30.1 GB at 8 layers; mixtral_8x7b 3.16 B
# parameters (50.6 GB) at 2 layers, whose saved MoE activations at
# capacity 1280 add about 1.5 GB a layer.
TRAIN_CONFIGS = {
    "llama2_7b": dict(layers=8, batch=2, seq=4096, steps=6),
    "mixtral_8x7b": dict(layers=2, batch=1, seq=4096, steps=4),
}


def training_phase(card: str, name: str = "llama2_7b"):
    """A model at full width, cut to TRAIN_CONFIGS' layers, f32
    parameters and AdamW state, bf16 compute, through
    run_train_loop(build_train_step(...)) with the flash kernels.
    train_mfu counts the matmul parameters that do useful work: for MoE
    attention, the top-k of the experts, the router and the head (not
    the dispatch products or capacity padding)."""
    import dataclasses

    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.models.llama import next_token_loss
    from mpi_operator_tpu_torch.models.params import init_params
    from mpi_operator_tpu_torch.ops import attention as fa
    from mpi_operator_tpu_torch.parallel.train import (adamw,
                                                       build_train_step,
                                                       run_train_loop)
    from mpi_operator_tpu_torch.telemetry.goodput import GoodputTracker
    from mpi_operator_tpu_torch.telemetry.metrics import Registry

    run = TRAIN_CONFIGS[name]
    cfg = dataclasses.replace(getattr(llama, name)(), n_layers=run["layers"])
    batch, seq, n_steps = run["batch"], run["seq"], run["steps"]
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda", dtype=cfg.param_dtype)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (batch, seq)), device="cuda")

    def loss_fn(model, batch):
        return next_token_loss(model(batch), batch)

    registry = Registry()
    goodput = GoodputTracker(registry=registry)
    init, step = build_train_step(loss_fn, adamw(3e-4), goodput=goodput,
                                  telemetry_registry=registry, sync_every=1)
    state = init(model)
    losses, stamps = [], []

    def on_metrics(i, metrics):
        # sync_every=1: the step has finished when this runs.
        stamps.append(time.perf_counter())
        losses.append(metrics["loss"].item())

    for kernel in fa.LAUNCHES:
        fa.LAUNCHES[kernel] = 0
    t0 = time.perf_counter()
    state, steps = run_train_loop(state, step, (tokens for _ in range(
        n_steps)), max_steps=n_steps, on_metrics=on_metrics)
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    warm_s = stamps[0] - t0
    step_s = (stamps[-1] - stamps[0]) / (len(stamps) - 1)
    n_tokens = batch * seq
    flops = train_flops(cfg, batch, seq)
    stats = {
        "card": card, "model": name, "n_layers": cfg.n_layers,
        "reduced": f"n_layers {cfg.n_layers} of 32", "batch": batch,
        "seq_len": seq, "params": n_params, "steps": steps,
        "losses": losses, "warm_step_s": warm_s, "step_ms": step_s * 1e3,
        "tokens_per_s": n_tokens / step_s,
        "train_mfu": flops / step_s / PEAK_OPS[torch.bfloat16],
        "flops_per_step": flops, "max_memory_allocated_bytes": peak,
        "kernel_launches": launches, "goodput": goodput.summary(),
    }
    print(f"training[{name}]: " + json.dumps(stats), flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"training: losses {losses} are not finite and "
                         f"falling")
    want = n_steps * cfg.n_layers
    if any(n != want for n in launches.values()):
        raise SystemExit(f"training: kernel launches {launches}, expected "
                         f"{want} each (steps x layers)")
    if not peak < 80e9:
        raise SystemExit(f"training: peak memory {peak} bytes")
    return launches, losses


def train_example_phase(moe_data: bool = False):
    """examples/llama_train_torch.py on the card, 2 steps after its
    warm-up step, run in this process: with its defaults (--config tiny,
    f32, head_dim 32, which attention(impl="auto") zero-pads to the flash
    kernels' 64), or with ``moe_data`` as --config mixtral-tiny --data
    over a token file written by write_token_file (the native loader).
    It must exit 0 and print a finite loss, and K1'-K3' must each launch
    once per layer and step."""
    import contextlib
    import importlib.util
    import io
    import tempfile

    from mpi_operator_tpu_torch.models.llama import llama2_tiny
    from mpi_operator_tpu_torch.native import write_token_file
    from mpi_operator_tpu_torch.ops import attention as fa

    path = os.path.join(HERE, "examples", "llama_train_torch.py")
    spec = importlib.util.spec_from_file_location("llama_train_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    tmp = tempfile.TemporaryDirectory()
    extra, label = [], "tiny defaults"
    if moe_data:
        corpus = os.path.join(tmp.name, "corpus.bin")
        write_token_file(corpus, np.random.default_rng(SEED).integers(
            0, llama2_tiny().vocab_size, 64 * llama2_tiny().max_seq_len))
        extra = ["--config", "mixtral-tiny", "--data", corpus]
        label = "mixtral-tiny --data"
    argv, sys.argv = sys.argv, [path, "--steps", "2", *extra]
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = example.main()
    finally:
        sys.argv = argv
        tmp.cleanup()
    launches = dict(fa.LAUNCHES)
    text = out.getvalue()
    found = re.search(r"tokens/sec: (\S+) loss=(\S+)", text)
    if rc != 0 or not found or not np.isfinite(float(found.group(2))):
        raise SystemExit(f"training example failed ({rc}):\n{text[-2000:]}")
    want = 3 * llama2_tiny().n_layers          # warm-up + 2 steps
    if any(n != want for n in launches.values()):
        raise SystemExit(f"training example: flash launches {launches}, "
                         f"want {want} each (3 steps x n_layers)")
    print(f"train example ({label}, on the card): "
          f"{text.strip().splitlines()[-2]} | {found.group(0)} | "
          f"flash launches {json.dumps(launches)}", flush=True)
    return launches


def training_repeat_phase(card: str, losses, name: str = "llama2_7b"):
    """The training phase once more on the same card: the flash kernels
    and the MoE one-hot dispatch use no atomics, so the losses must be
    bit-identical."""
    gc.collect()
    torch.cuda.empty_cache()
    _, again = training_phase(card, name)
    print(f"training[{name}, repeat]: losses {again}, identical: "
          f"{again == losses}", flush=True)
    if again != losses:
        raise SystemExit(f"training: a second run gave losses {again}, the "
                         f"first {losses}")


# -- phase 7: distributed -------------------------------------------------------

DIST_MAX_WORLD = 4
DIST_PI_SAMPLES = 10_000_000
DIST_LAYERS_PER_CARD = 4          # (c): 4 x world layers of llama2_7b
                                  # (16 at four cards: cut from 8 a card
                                  # to pay for phase 12 (c), (d))
DIST_STEPS = 4                    # one warm-up + 3 timed
DIST_PARITY_STEPS = 3
DIST_STEP_TOL = 1e-5              # tests/test_torch_train.py STEP_TOL
DIST_LR = 3e-4
DIST_DEADLINE_S = 600


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_REMOVALS = []


def ckpt_store(out_dir: str) -> str:
    """Phase 7 (d)'s checkpoint store, in the phase's directory."""
    return os.path.join(out_dir, "ckpt-store")


def remove_later(path: str) -> None:
    """Remove ``path`` on a thread of this process, beside the phases
    that follow; ``main`` waits for it before it exits."""
    t = threading.Thread(target=shutil.rmtree, args=(path, True))
    t.start()
    _REMOVALS.append(t)


def run_ranks(argv, world: int, what: str, deadline_s: float,
              logs_dir: str):
    """``world`` processes, one per card, each with the operator's env
    (coordinator on a free local port, its process id, the process count,
    the submit time); their output goes to files in ``logs_dir``.  A rank
    that fails, or ranks that outlive the deadline, fail the run, and
    every rank still running is killed.  Returns each rank's output."""
    port, submit = free_port(), time.time()
    procs = []
    for rank in range(world):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_PROCESS_ID=str(rank), JAX_NUM_PROCESSES=str(world),
                   MPIJOB_SUBMIT_TIME=repr(submit))
        # Phase (c) runs near the card's memory: the default caching
        # allocator frees and re-mallocs there every step (6 retries in
        # 3 steps, each slower than the last, on four H100 80GB HBM3 at
        # 700 W), growable segments do not.
        env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
        log = open(os.path.join(logs_dir, f"rank{rank}.log"), "w")
        procs.append((log, subprocess.Popen(argv, env=env, stdout=log,
                                            stderr=subprocess.STDOUT,
                                            cwd=HERE)))
    end = time.monotonic() + deadline_s
    try:
        # A rank that fails leaves the others waiting in a collective:
        # stop at the first failure, not at the deadline.
        while time.monotonic() < end:
            codes = [proc.poll() for _, proc in procs]
            if all(c == 0 for c in codes) or any(c for c in codes):
                break
            time.sleep(0.5)
    finally:
        for log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    texts = [open(os.path.join(logs_dir, f"rank{r}.log")).read()
             for r in range(world)]
    codes = [proc.returncode for _, proc in procs]
    if any(codes):
        raise SystemExit(f"distributed {what}: ranks exited {codes}:\n" +
                         "\n".join(f"--- rank {r}\n{t[-4000:]}"
                                    for r, t in enumerate(texts)))
    return texts


def dist_loss(model, batch):
    from mpi_operator_tpu_torch.models.llama import next_token_loss
    return next_token_loss(model(batch), batch)


def dist_parity_inputs(world: int, preset: str = "llama2_tiny",
                       n_layers: int = 0):
    """A tiny model's f32 weights from SEED (llama2_tiny, or
    mixtral_tiny; ``n_layers`` overrides its depth) and a global batch of
    2 rows per card, the same in every process."""
    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.models.params import init_params
    cfg = getattr(llama, preset)(**({"n_layers": n_layers} if n_layers
                                    else {}))
    weights = init_params(cfg, torch.Generator().manual_seed(SEED),
                          device="cpu", dtype=torch.float32).state_dict()
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2 * world, 128)))
    return cfg, weights, tokens


def dist_parity_run(world: int, fsdp: bool, fault: bool):
    """One rank of phase (b): DIST_PARITY_STEPS AdamW steps at dp = world
    with shard_update, or at fsdp = world through llama_param_specs.
    ``fault`` plants one rank's gradients skipping the reduction: rank 1
    takes part in the reduce-scatter and keeps its own chunk."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from mpi_operator_tpu_torch.models.llama import (LlamaModel,
                                                     llama_param_specs)
    from mpi_operator_tpu_torch.parallel.mesh import (MeshConfig,
                                                      batch_rows,
                                                      create_mesh)
    from mpi_operator_tpu_torch.parallel.train import adamw, build_train_step

    cfg, weights, tokens = dist_parity_inputs(world)
    mesh = create_mesh(MeshConfig(dp=1, fsdp=world) if fsdp
                       else MeshConfig(dp=world))
    init, step = build_train_step(
        dist_loss, adamw(DIST_LR), mesh=mesh,
        param_specs=llama_param_specs(cfg) if fsdp else None,
        shard_update=not fsdp)
    model = LlamaModel(cfg, device="cuda", store_dtype=torch.float32)
    model.load_state_dict(weights)
    state = init(model)
    rows = tokens[batch_rows(tuple(mesh.shape), mesh.get_coordinate(),
                             len(tokens))].cuda()
    real = dist.reduce_scatter_tensor
    if fault and dist.get_rank() == 1:
        def skipped(output, input, group=None, **kw):
            work = real(output, input, group=group, **kw)
            n = input.numel() // output.numel()
            output.copy_(input.view(n, -1)[dist.get_rank(group)] * n)
            return work
        dist.reduce_scatter_tensor = skipped
    try:
        metrics = []
        for _ in range(DIST_PARITY_STEPS):
            state, m = step(state, rows)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
    finally:
        dist.reduce_scatter_tensor = real
    params = {n: (p.full_tensor() if isinstance(p, DTensor) else p)
              .detach().cpu() for n, p in state.model.named_parameters()}
    return metrics, params


def dist_full_width_run(world: int):
    """One rank of phase (c): llama2_7b at full width, 4 x world layers,
    fsdp = world through llama_param_specs, 1 x 4096 tokens a rank, bf16
    compute, f32 parameters and AdamW state.  The model is built on the
    meta device, sharded, then each rank fills only its shard with
    init_params' draws for SEED."""
    import dataclasses

    import torch.distributed as dist

    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.models.params import init_params_
    from mpi_operator_tpu_torch.ops import attention as fa
    from mpi_operator_tpu_torch.parallel.mesh import (MeshConfig,
                                                      batch_rows,
                                                      create_mesh)
    from mpi_operator_tpu_torch.parallel.train import adamw, build_train_step

    cfg = dataclasses.replace(llama.llama2_7b(),
                              n_layers=DIST_LAYERS_PER_CARD * world)
    seq = cfg.max_seq_len
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = create_mesh(MeshConfig(dp=1, fsdp=world))
    init, step = build_train_step(dist_loss, adamw(3e-4), mesh=mesh,
                                  param_specs=llama.llama_param_specs(cfg))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    state = init(llama.LlamaModel(cfg, device="meta",
                                  store_dtype=cfg.param_dtype),
                 init_weights=lambda m: init_params_(m, gen))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    local_params = sum(p.to_local().numel() if hasattr(p, "to_local")
                       else p.numel() for p in state.model.parameters())
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (world, seq))
    rows = torch.as_tensor(tokens[batch_rows(
        tuple(mesh.shape), mesh.get_coordinate(), world)], device="cuda")
    for kernel in fa.LAUNCHES:
        fa.LAUNCHES[kernel] = 0
    losses, stamps = [], []
    dist.barrier()
    for _ in range(DIST_STEPS):
        state, metrics = step(state, rows)
        losses.append(metrics["loss"].item())     # waits for the step
        stamps.append(time.perf_counter())
    launches = dict(fa.LAUNCHES)
    step_s = (stamps[-1] - stamps[0]) / (len(stamps) - 1)
    peak = torch.cuda.max_memory_allocated()
    # cudaMalloc retries after freeing the cache (each one syncs the
    # card): what a step near the memory limit pays.
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    flops = train_flops(cfg, 1, seq)
    del state
    return {"n_layers": cfg.n_layers, "fsdp": world, "tokens_per_rank": seq,
            "local_params": local_params, "init_s": init_s,
            "losses": losses, "step_ms": step_s * 1e3,
            "each_step_ms": [(b - a) * 1e3 for a, b in zip(stamps,
                                                          stamps[1:])],
            "alloc_retries": retries,
            "tokens_per_s_per_card": seq / step_s,
            "train_mfu": flops / step_s / PEAK_OPS[torch.bfloat16],
            "peak_bytes": peak, "launches": launches}


DIST_CKPT_CHUNK_BYTES = 16 << 20   # (d): 16 MiB chunks, ~200 a rank
DIST_CKPT_LOSS_TOL = 1e-3          # (d) at two cards or more: phase 12
                                   # (b)'s bound against phase 7 (c)
DIST_CKPT_HOST_SLACK = 1 << 30     # (d): host bound = range + leaf + 1 GB


class HostPeak:
    """This process's resident set, sampled from /proc/self/statm on a
    thread every 2 ms: the growth of its peak over the resident set at
    start (``growth``, after ``stop``)."""

    def __init__(self):
        self._page = os.sysconf("SC_PAGE_SIZE")
        self.base = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _run(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, self._rss())

    def stop(self) -> int:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())
        self.growth = self.peak - self.base
        return self.growth


def ckpt_range_digests(layout, lo: int, buf) -> dict:
    """sha256 of each leaf's bytes inside a rank's range ``[lo, lo +
    len(buf))`` of the one-device stream, by leaf index (hashed on 8
    threads)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor
    view, pieces, off = memoryview(buf), {}, 0
    for i, entry in enumerate(layout):
        a, b = max(off, lo), min(off + entry["nbytes"], lo + len(view))
        if a < b:
            pieces[i] = view[a - lo:b - lo]
        off += entry["nbytes"]
    with ThreadPoolExecutor(8) as pool:
        hashes = pool.map(lambda v: hashlib.sha256(v).hexdigest(),
                          pieces.values())
        return dict(zip(pieces, hashes))


def ckpt_state_digests(state, mgr, buf) -> dict:
    """:func:`ckpt_range_digests` of the range of ``state``'s stream that
    ``mgr`` writes on this rank, copied into ``buf`` first (a collective
    over the state's mesh: every leaf is gathered)."""
    from mpi_operator_tpu_torch.ckpt.manager import state_layout, stream_range
    leaves, layout = state_layout(state)
    lo, hi = mgr.shard_range(sum(e["nbytes"] for e in layout))
    return ckpt_range_digests(layout, lo, stream_range(leaves, layout, lo,
                                                       hi, buf))


def ckpt_shifted_rows(real):
    """A planted fault: ``read_leaf_rows`` that reads the rows of every
    leaf of two rows or more (all of them where it reads the whole leaf)
    one row later."""
    def read(fetch, off, entry, rows=None):
        if not entry["shape"] or entry["shape"][0] < 2:
            return real(fetch, off, entry, rows)
        r0, r1 = rows if rows is not None else (0, entry["shape"][0])
        return real(fetch, off, entry, (r0 + 1, r1 + 1))
    return read


def local_state_bytes(state) -> int:
    """Bytes of this rank's parameters and optimizer entries."""
    total = 0
    for t in list(state.model.parameters()) + [
            v for e in state.optimizer.state.values() for v in e.values()
            if torch.is_tensor(v)]:
        t = t.to_local() if hasattr(t, "to_local") else t
        total += t.numel() * t.element_size()
    return total


def dist_ckpt_run(world: int, out_dir: str):
    """One rank of phase (d): llama2_7b at full width with ``world``
    layers, fsdp = world, 1 x 4096 tokens a rank, bf16 compute over f32
    state; 2 steps, a save of step 2 through ManifestCheckpointManager
    into a directory store (``ckpt_store(out_dir)``; each rank its own
    range; one process and 4 shards at one card), 2 more steps (the straight run), then
    restore_resharded onto dp = 2 x fsdp = 2 (four cards; dp = 2 at two,
    the same mesh at one) and the same 2 steps; then a restore in which
    this rank, if it is rank 1 (rank 0 at one card), reads every leaf one
    row off.  Returns the losses, the per-leaf digests of this rank's
    range before the save, after the restore and after the planted one,
    the seconds, bytes and host peaks, and the K1'-K3' launches."""
    import shutil

    import torch.distributed as dist

    from mpi_operator_tpu_torch.ckpt import BlobStore, manager as ckpt
    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.models.params import init_params_
    from mpi_operator_tpu_torch.ops import attention as fa
    from mpi_operator_tpu_torch.parallel.mesh import (MeshConfig,
                                                      batch_rows,
                                                      create_mesh)
    from mpi_operator_tpu_torch.parallel.train import (TrainState, adamw,
                                                       build_train_step)
    from mpi_operator_tpu_torch.telemetry.metrics import Registry

    def free_device():
        gc.collect()
        torch.cuda.empty_cache()

    t_part = time.perf_counter()
    stamps = {}

    def mark(name):
        stamps[name] = time.perf_counter() - t_part - sum(stamps.values())

    rank = dist.get_rank()
    cfg = dataclasses.replace(llama.llama2_7b(), n_layers=world)
    specs = llama.llama_param_specs(cfg)
    seq = cfg.max_seq_len
    free_device()
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                  (world, seq))

    def stepper(mesh):
        _, step = build_train_step(dist_loss, adamw(DIST_LR), mesh=mesh,
                                   param_specs=specs)
        rows = torch.as_tensor(tokens[batch_rows(
            tuple(mesh.shape), mesh.get_coordinate(), world)],
            device="cuda")
        return lambda state: step(state, rows)

    def run(step, state, n):
        losses = []
        for _ in range(n):
            state, metrics = step(state)
            losses.append(metrics["loss"].item())
        return state, losses

    mesh = create_mesh(MeshConfig(dp=1, fsdp=world))
    init, _ = build_train_step(dist_loss, adamw(DIST_LR), mesh=mesh,
                               param_specs=specs)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state = init(llama.LlamaModel(cfg, device="meta",
                                  store_dtype=cfg.param_dtype),
                 init_weights=lambda m: init_params_(m, gen))
    step = stepper(mesh)
    mark("init")
    for kernel in fa.LAUNCHES:
        fa.LAUNCHES[kernel] = 0
    state, first = run(step, state, 2)
    mark("steps 1-2")

    # One store for every rank, in the phase's directory: the phase
    # removes it whether or not the ranks succeed.
    root = ckpt_store(out_dir)
    if rank == 0:
        os.makedirs(root)
    dist.barrier()
    out = {"disk_free_gb": shutil.disk_usage(root).free / 1e9,
           "store": root}
    try:
        store = BlobStore(root=root)
        registry = Registry()
        mgr = ckpt.ManifestCheckpointManager(
            store, "smoke/llama2_7b", every=2,
            num_shards=4 if world == 1 else world,
            chunk_bytes=DIST_CKPT_CHUNK_BYTES, registry=registry)
        snaps = []
        real_snapshot = mgr.snapshot

        def kept(state):
            snaps.append(real_snapshot(state))
            return snaps[-1]

        mgr.snapshot = kept
        dist.barrier()
        mark("store")
        peak = HostPeak()
        t0 = time.perf_counter()
        if not mgr.maybe_save(state, 2):
            raise SystemExit("distributed (d): no save at step 2")
        out["snapshot_s"] = time.perf_counter() - t0
        state, straight = run(step, state, 2)
        mgr.drain()
        out["host_peak_save"] = peak.stop()
        layout, total, data = snaps.pop()
        lo, hi = mgr.shard_range(total)
        out["range_bytes"] = hi - lo
        out["total_bytes"] = total
        out["largest_leaf"] = max(e["nbytes"] for e in layout)
        out["write_s"] = registry.get(
            "mpi_operator_ckpt_write_seconds").sum
        out["bytes_written"] = store.counters["bytes_written"]
        mark("save, steps 3-4")
        out["before"] = ckpt_range_digests(layout, lo, data)
        # The snapshot's page-locked buffer carries the later digests.
        digest_buf = torch.from_numpy(data)
        del data
        mark("digest before")

        # What the restores build from: the model and optimizer on the
        # meta device.
        meta = llama.LlamaModel(cfg, device="meta",
                                store_dtype=cfg.param_dtype)
        target = TrainState(0, meta, adamw(DIST_LR)(meta.parameters()))
        new_mesh = mesh if world == 1 else create_mesh(
            MeshConfig(dp=2, fsdp=world // 2))
        new_step = stepper(new_mesh)
        restores, real_read = {}, ckpt.read_leaf_rows
        mark("restore set-up")
        for planted in (False, True):
            tag = "planted " if planted else ""
            if planted and rank == (1 if world > 1 else 0):
                ckpt.read_leaf_rows = ckpt_shifted_rows(real_read)
            read0 = store.counters["bytes_read"]
            dist.barrier()
            peak = HostPeak()
            t0 = time.perf_counter()
            try:
                moved = mgr.restore_resharded(target, new_mesh,
                                              param_specs=specs)
                torch.cuda.synchronize()
            finally:
                ckpt.read_leaf_rows = real_read
            restores[planted] = {
                "restore_s": time.perf_counter() - t0,
                "host_peak": peak.stop(),
                "shard_bytes": local_state_bytes(moved),
                "bytes_read": store.counters["bytes_read"] - read0,
                "plan": type(moved.plan).__name__}
            mark(tag + "restore")
            restores[planted]["digests"] = ckpt_state_digests(
                moved, mgr, digest_buf)
            mark(tag + "digest")
            if not planted:
                del state
                free_device()
                moved, out["restored"] = run(new_step, moved, 2)
                mark("restored steps 3-4")
            del moved
            free_device()
    finally:
        # The store is removed off the clock, by the smoke's own process
        # while the next phases run (``remove_later``).
        dist.barrier()
    out.update({"n_layers": cfg.n_layers, "world": world,
                "num_shards": mgr.num_shards, "first": first,
                "straight": straight, "restore": restores[False],
                "planted": restores[True],
                "launches": dict(fa.LAUNCHES), "steps": 6,
                "part_s": time.perf_counter() - t_part})
    mark("clean-up")
    out["stages_s"] = stamps
    out["after"] = out["restore"].pop("digests")
    out["planted_digests"] = out["planted"].pop("digests")
    return out


def distributed_rank(out_dir: str) -> int:
    """A child of the distributed phase: phase (b) when there are two
    cards or more, then phase (c) twice (the determinism check across
    two runs at this world size), then phase (d)."""
    import torch.distributed as dist

    from mpi_operator_tpu_torch.bootstrap import initialize_from_env

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = initialize_from_env()
    if not dist.is_initialized():
        # One card: initialize_from_env forms no group for one process
        # (as the JAX version); the mesh needs one, so a 1-rank NCCL
        # group forms here.
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1,
                                device_id=torch.device("cuda", 0))
    rank, world = dist.get_rank(), dist.get_world_size()
    result = {"rank": rank, "world": world, "env_processes":
              env.num_processes, "backend": dist.get_backend(),
              "card": torch.cuda.current_device()}
    if world >= 2:
        runs = {"dp_zero": dist_parity_run(world, fsdp=False, fault=False),
                "fsdp": dist_parity_run(world, fsdp=True, fault=False),
                "dp_zero_fault": dist_parity_run(world, fsdp=False,
                                                 fault=True)}
        result["parity_metrics"] = {k: v[0] for k, v in runs.items()}
        if rank == 0:
            torch.save({k: v[1] for k, v in runs.items()},
                       os.path.join(out_dir, "parity.pt"))
    result["full_width"] = [dist_full_width_run(world) for _ in range(2)]
    result["ckpt"] = dist_ckpt_run(world, out_dir)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()
    return 0


def dist_parity_failures(metrics, params, ref_metrics, ref_params,
                         smallest):
    """What in a run differs from the one-card reference beyond
    DIST_STEP_TOL (an element whose gradient came within rounding of
    zero moves by up to lr a step: held to 3 lr, as the CPU tests)."""
    bad = []
    for (loss, norm), (rl, rn) in zip(metrics, ref_metrics):
        for got, want in ((loss, rl), (norm, rn)):
            if abs(got - want) > DIST_STEP_TOL * (1 + abs(want)):
                bad.append(f"metric {got} vs {want}")
    for name, ref in ref_params.items():
        err = (params[name] - ref).abs()
        sound = (smallest[name] == 0) | (smallest[name] >= 1e-7)
        if (err[sound] > DIST_STEP_TOL * (1 + ref[sound].abs())).any() \
                or err.max().item() > 3 * DIST_LR:
            bad.append(f"{name} max err {err.max().item():.3g}")
    return bad


def dist_parity_reference(world: int, preset: str = "llama2_tiny",
                          n_layers: int = 0, loss_fn=None):
    """The same steps in this process on card 0, on the whole global
    batch (``loss_fn``, default ``dist_loss``): metrics, parameters and
    the smallest |gradient| per element."""
    from mpi_operator_tpu_torch.models.llama import LlamaModel
    from mpi_operator_tpu_torch.parallel.train import adamw, build_train_step

    cfg, weights, tokens = dist_parity_inputs(world, preset, n_layers)
    model = LlamaModel(cfg, device="cuda", store_dtype=torch.float32)
    model.load_state_dict(weights)
    init, step = build_train_step(loss_fn or dist_loss, adamw(DIST_LR))
    state = init(model)
    metrics, smallest = [], {n: torch.full_like(p, float("inf")) for n, p
                             in model.named_parameters()}
    for _ in range(DIST_PARITY_STEPS):
        state, m = step(state, tokens.cuda())
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
        for n, p in state.model.named_parameters():
            smallest[n] = torch.minimum(smallest[n], p.grad.abs())
    params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    return metrics, params, {n: v.cpu() for n, v in smallest.items()}


def distributed_phase(card: str):
    """Phase 7: one process per card (at most DIST_MAX_WORLD), NCCL.  (a)
    examples/torch_pi.py; (b) with two cards or more, llama2_tiny f32 at
    dp = world (ZeRO) and fsdp = world against card 0 alone, and a
    planted fault that must fail; (c) llama2_7b at full width, fsdp =
    world, 4 x world layers; (d) the checkpoint data plane: llama2_7b,
    world layers, saved per rank and restored onto another mesh
    (:func:`dist_ckpt_run`, :func:`ckpt_report`)."""
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="chip-smoke-dist-")
    gc.collect()
    torch.cuda.empty_cache()
    world = min(torch.cuda.device_count(), DIST_MAX_WORLD)
    print(f"distributed: world {world} (one process per card, "
          f"{'NCCL' if world > 1 else 'one rank'}); {card}", flush=True)

    texts = run_ranks([sys.executable, os.path.join(
        HERE, "examples", "torch_pi.py"), str(DIST_PI_SAMPLES)], world,
        "pi", 300, out_dir)
    found = re.search(r"workers=(\d+) samples=(\d+) pi=(\S+)", texts[0])
    latency = re.search(r"launch_to_first_allreduce_seconds=(\S+)",
                        texts[0])
    if not found or int(found.group(1)) != world or not latency or \
            abs(float(found.group(3)) - np.pi) >= 0.01:
        raise SystemExit(f"distributed (a) pi: {texts[0][-2000:]}")
    print(f"distributed (a) pi: {found.group(0)} (|pi - π| = "
          f"{abs(float(found.group(3)) - np.pi):.2e}) "
          f"launch_to_first_allreduce_seconds={latency.group(1)}",
          flush=True)

    try:
        run_ranks([sys.executable, os.path.abspath(__file__),
                   "distributed-rank", out_dir], world, "train",
                  DIST_DEADLINE_S, out_dir)
    finally:
        # (d)'s store, off the clock: beside the phases that follow.
        remove_later(ckpt_store(out_dir))
    ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
             for r in range(world)]
    if any(r["world"] != world or (world > 1 and r["backend"] != "nccl")
           or r["card"] != r["rank"] for r in ranks):
        raise SystemExit(f"distributed: ranks formed {ranks}")

    if world >= 2:
        ref_metrics, ref_params, smallest = dist_parity_reference(world)
        got = torch.load(os.path.join(out_dir, "parity.pt"))
        verdict = {}
        for name, params in got.items():
            bad = [f for r in ranks for f in dist_parity_failures(
                r["parity_metrics"][name], params, ref_metrics, ref_params,
                smallest)]
            verdict[name] = bad
        if verdict["dp_zero"] or verdict["fsdp"] or \
                not verdict["dp_zero_fault"]:
            raise SystemExit(f"distributed (b) parity: {verdict}")
        print(f"distributed (b) parity: llama2_tiny f32, "
              f"{DIST_PARITY_STEPS} AdamW steps, dp={world} (shard_update) "
              f"and fsdp={world} == card 0 alone at {DIST_STEP_TOL}; "
              f"planted fault caught ({verdict['dp_zero_fault'][:2]})",
              flush=True)
    else:
        print("distributed (b) parity: needs two cards; this machine "
              "shows one", flush=True)

    stats = []
    for r in ranks:
        first, again = r["full_width"]
        want = DIST_STEPS * first["n_layers"]
        if any(n != want for n in first["launches"].values()) or \
                not all(np.isfinite(first["losses"])) or \
                not first["peak_bytes"] < 80e9:
            raise SystemExit(f"distributed (c) rank {r['rank']}: {first}")
        stats.append({**first, "rank": r["rank"],
                      "losses_repeat": again["losses"],
                      "repeat_identical": again["losses"] ==
                      first["losses"]})
    print(f"distributed (c) llama2_7b full width, fsdp={world}, "
          f"{stats[0]['n_layers']} layers, 1 x 4096 tokens a rank: "
          + json.dumps({"card": card, "world": world, "ranks": stats}),
          flush=True)
    ckpt = ckpt_report(card, [r["ckpt"] for r in ranks])
    return {"world": world, "launches_rank0": stats[0]["launches"],
            "losses": stats[0]["losses"],
            "ckpt_launches_rank0": ckpt["ranks"][0]["launches"]}


def ckpt_report(card: str, runs):
    """Phase 7 (d)'s checks over every rank's :func:`dist_ckpt_run`, and
    its line."""
    bad, ranks = [], []
    for rank, c in enumerate(runs):
        want = c["steps"] * c["n_layers"]
        if any(n != want for n in c["launches"].values()):
            bad.append(f"rank {rank} launches {c['launches']} != {want}")
        if c["after"] != c["before"]:
            bad.append(f"rank {rank}: restored digests differ")
        losses = c["first"] + c["straight"] + c["restored"]
        if not all(np.isfinite(losses)):
            bad.append(f"rank {rank}: losses {losses}")
        for got, want in zip(c["restored"], c["straight"]):
            if (got != want) if c["world"] == 1 else \
                    abs(got - want) > DIST_CKPT_LOSS_TOL * abs(want):
                bad.append(f"rank {rank}: restored loss {got} vs {want}")
        slack = c["largest_leaf"] + DIST_CKPT_HOST_SLACK
        bounds = {"save": c["range_bytes"] + slack,
                  "restore": c["restore"]["shard_bytes"] + slack}
        for what, peak in (("save", c["host_peak_save"]),
                           ("restore", c["restore"]["host_peak"])):
            if peak > bounds[what]:
                bad.append(f"rank {rank}: host peak {peak} during the "
                           f"{what} > {bounds[what]}")
        gb = 1e9
        ranks.append({
            "rank": rank, "disk_free_gb": c["disk_free_gb"],
            "snapshot_s": c["snapshot_s"], "write_s": c["write_s"],
            "restore_s": c["restore"]["restore_s"],
            "written_gb": c["bytes_written"] / gb,
            "write_gb_per_s": c["bytes_written"] / gb / c["write_s"],
            "read_gb": c["restore"]["bytes_read"] / gb,
            "read_gb_per_s": c["restore"]["bytes_read"] / gb
            / c["restore"]["restore_s"],
            "range_gb": c["range_bytes"] / gb,
            "restore_plan": c["restore"]["plan"],
            "host_peak_save_gb": c["host_peak_save"] / gb,
            "host_bound_save_gb": bounds["save"] / gb,
            "host_peak_restore_gb": c["restore"]["host_peak"] / gb,
            "host_bound_restore_gb": bounds["restore"] / gb,
            "losses": losses, "launches": c["launches"],
            "part_s": c["part_s"], "stages_s": c["stages_s"]})
    if not any(c["planted_digests"] != c["before"] for c in runs):
        bad.append("the planted row-offset restore left every digest "
                   "equal")
    c = runs[0]
    if bad:
        print("distributed (d) checkpoint FAILED: " + json.dumps(
            {"card": card, "ranks": ranks}), flush=True)
        raise SystemExit(f"distributed (d) checkpoint: {bad}")
    print(f"distributed (d) checkpoint: llama2_7b full width, "
          f"{c['n_layers']} layers, fsdp={c['world']}, saved as "
          f"{c['num_shards']} shards of {c['total_bytes'] / 1e9:.3f} GB, "
          f"restored onto {c['restore']['plan']}: digests equal, planted "
          f"fault caught; part seconds (max over ranks) "
          f"{max(r['part_s'] for r in ranks):.1f}: "
          + json.dumps({"card": card, "ranks": ranks}), flush=True)
    return {"ranks": ranks}


# -- phase 9: tensor parallel ---------------------------------------------------

TP_LOGIT_LIMIT = 5e-2             # as phase 5c: the same bf16 products,
                                  # summed in another order (see tp_phase)
TP_DEADLINE_S = 900
TP_STEPS = 4                      # one warm-up + 3 timed
TP_DEVICE = "cuda"                # the ranks' device (a CPU dry run: "cpu")
TP_MOE_LAYERS = 8                 # (b): of 32, cut to pay for phase 12
                                  # (c) and (d) (PERF.md section 4)
PR9_FSDP4 = "fsdp=4, 32 layers: 655-666 ms a step, 6,150-6,250 tokens/s a card"
TP_DISAGG_FAULT_LEN = 300         # (d): the planted fault's prompt
TP_DISAGG_INT8_LEN = 700          # (d): the int8 pools' prompt
TP_DISAGG_BUDGET_S = 120          # (d): printed beside its seconds
TP_FSDP_BUDGET_S = 60             # (e): printed beside its seconds
TP_FSDP_NEW_TOKENS = 16           # (e): the first 16 of each of phase
                                  # 5's streams, to fit its budget
NVLINK_BYTES_PER_S = 450e9        # (e): NVLink 4 on an H100 SXM, one
                                  # direction (18 links x 25 GB/s)


def tp_world() -> int:
    """Ranks of phase 9: 4, 2 or 1 (tp must divide the heads)."""
    cards = torch.cuda.device_count()
    return 4 if cards >= 4 else (2 if cards >= 2 else 1)


def serving_prompts(vocab: int):
    """The serving phase's prompts (SERVE_PROMPT_LENS) and its 64-token
    SSE prompt, from SEED."""
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, vocab, n).tolist() for n in SERVE_PROMPT_LENS]
    return prompts, rng.integers(1, vocab, 64).tolist()


def tp_group():
    """This process's NCCL group (initialize_from_env; at one card a
    one-rank group, as the distributed phase forms it)."""
    import torch.distributed as dist

    from mpi_operator_tpu_torch.bootstrap import initialize_from_env

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_from_env(collective_timeout_seconds=600)
    if not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1,
                                device_id=torch.device("cuda", 0))
    return dist.get_rank(), dist.get_world_size()


def tp_mesh(**axes):
    from mpi_operator_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    return create_mesh(MeshConfig(dp=1, **axes), TP_DEVICE)


def tp_serve_run(server, prompts, stream_prompt, n_new):
    """Rank 0 of a tp server: each prompt alone (one request at a time),
    then all of them at once with the SSE stream.  Returns the streams
    and the serving stats of the concurrent run."""
    tm = server.telemetry
    alone = [post(server.url + "/generate",
                  {"tokens": [p], "max_new_tokens": n_new})["tokens"][0]
             for p in prompts + [stream_prompt]]
    t0 = time.perf_counter()
    ttft0, itl0 = ((h.sum, h.count) for h in (tm["ttft_seconds"],
                                               tm["token_latency_seconds"]))
    fns = [lambda p=p: post(server.url + "/generate",
                            {"tokens": [p], "max_new_tokens": n_new})
           for p in prompts]
    fns.append(lambda: read_sse(server.url + "/generate",
                                {"tokens": [stream_prompt],
                                 "max_new_tokens": n_new, "stream": True}))
    results = run_concurrently(fns)
    wall = time.perf_counter() - t0
    events, _ = results[-1]
    concurrent = [r["tokens"][0] for r in results[:-1]] + [
        [e["token"] for e in events if "token" in e]]
    ttft, itl = tm["ttft_seconds"], tm["token_latency_seconds"]
    return {"alone": alone, "concurrent": concurrent,
            "concurrent_wall_s": wall,
            "output_tokens_per_s": sum(map(len, concurrent)) / wall,
            "ttft_mean_s": (ttft.sum - ttft0[0]) / (ttft.count - ttft0[1]),
            "inter_token_latency_mean_s":
                (itl.sum - itl0[0]) / (itl.count - itl0[1])}


def timed_gathers(fs):
    """Wrap the gathers of ``fs`` (a ``ServingFSDP``) with CUDA events on
    the stream each runs on, as ``swapped_gathers`` wraps them; returns a
    function that restores them and gives the events' summed ms.  A span
    starts when the side stream reaches the gather (after the main
    stream's hand-off), so it holds the wait for the peer rank."""
    real = fs._all_gather
    spans = []

    def gather(buf, shard):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        real(buf, shard)
        end.record()
        spans.append((start, end))
    fs._all_gather = gather

    def finish() -> float:
        fs._all_gather = real
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in spans)
    return finish


def kernel_overlap(trace_path: str, steps: int) -> dict:
    """From a ``torch.profiler`` chrome trace: the ms a step of the NCCL
    kernels off the main stream (the gathers' side stream; the main
    stream is the one with the most time of other kernels, the tp
    all-reduces among them), of the main stream's kernels, and of the
    side stream's NCCL time that main-stream kernels run under, and the
    share of that NCCL time nothing covers (exposed)."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel" and "dur" in e]
    busy = {}
    for e in events:
        if "nccl" not in e.get("name", "").lower():
            stream = e.get("args", {}).get("stream")
            busy[stream] = busy.get(stream, 0.0) + float(e["dur"])
    main = max(busy, key=busy.get) if busy else None
    side, other = [], []
    for e in events:
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e.get("args", {}).get("stream") == main:
            other.append(span)
        elif "nccl" in e.get("name", "").lower():
            side.append(span)
    merged = []                       # the main stream's busy intervals
    for a, b in sorted(other):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    covered = sum(max(0.0, min(b, d) - max(a, c))
                  for a, b in side for c, d in merged)
    side_us = sum(b - a for a, b in side)
    return {"side_nccl_kernels": len(side),
            "side_nccl_ms_per_step": side_us / steps / 1e3,
            "main_stream_kernels_ms_per_step":
                sum(b - a for a, b in merged) / steps / 1e3,
            "side_nccl_under_main_kernels_ms_per_step":
                covered / steps / 1e3,
            "side_nccl_exposed_share": (1.0 - covered / side_us)
            if side_us else None}


def decode_timing(model, mirror=None, context: int = 128, steps: int = 20):
    """Host and wall ms of one 8-slot decode step of ``model`` at
    ``context`` cached tokens (a fresh batcher's ``decode_step`` after
    ``fill_slots``; every rank of a serving group in lock-step), under tp
    the ms of one turn's exchange of host records (``mirror``), and with
    the weights cut over fsdp the ms a step of the gathers' CUDA-event
    spans (``timed_gathers``: peer waits included) and, from a
    ``torch.profiler`` trace of a few steps, of the NCCL kernels and of
    their part that compute kernels run under (``kernel_overlap``)."""
    from mpi_operator_tpu_torch.serving import ContinuousBatcher

    b = ContinuousBatcher(model, max_slots=8, page_size=16,
                          prefix_cache=False, device=model.device,
                          mirror=mirror)
    b.fill_slots(context)
    dev = model.device
    args = (torch.zeros(8, dtype=torch.int32, device=dev),
            torch.zeros(8, device=dev), torch.ones(8, device=dev),
            [None] * 8, torch.zeros(8, dtype=torch.int32, device=dev))
    out = {"context": context, "slots": 8}
    with torch.inference_mode():
        for _ in range(3):
            b.decode_step(*args)
        torch.cuda.synchronize()
        host = 0.0
        t0 = time.perf_counter()
        for _ in range(steps):
            t1 = time.perf_counter()
            b.decode_step(*args)
            host += time.perf_counter() - t1
        torch.cuda.synchronize()
        out["wall_ms_per_step"] = (time.perf_counter() - t0) / steps * 1e3
        out["host_ms_per_step"] = host / steps * 1e3
        fs = model.fsdp_serve
        if fs is not None:
            # Timed apart: the events cost host time of their own.
            finish = timed_gathers(fs)
            for _ in range(steps):
                b.decode_step(*args)
            out["gather_span_ms_per_step_incl_peer_wait"] = \
                finish() / steps
            from torch.profiler import ProfilerActivity, profile
            traced = 5
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(traced):
                    b.decode_step(*args)
                torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                out["trace"] = kernel_overlap(path, traced)
        if mirror is not None:
            t0 = time.perf_counter()
            for _ in range(steps):
                mirror.exchange(0, {"stop": False, "new": [], "cancel": []})
            out["exchange_ms"] = (time.perf_counter() - t0) / steps * 1e3
    del b
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_serve(world: int, rank: int, refs, moe: bool):
    """One rank of phase 9 (a) (llama2_7b) or (b) (mixtral_8x7b): the
    model built as this rank's tp shard from SEED, a tp server (8 slots,
    page 16, no prefix cache), (a) the prefill logits of every prompt and
    a planted fault, then rank 0 drives the serving run while the others
    follow.  K4' launches and decode steps are counted on every rank
    over the server's life."""
    from mpi_operator_tpu_torch.models.llama import llama2_7b, mixtral_8x7b
    from mpi_operator_tpu_torch.models.params import init_params
    from mpi_operator_tpu_torch.ops import paged_attention as pa
    from mpi_operator_tpu_torch.parallel.tensor import reduce_from_tp
    from mpi_operator_tpu_torch.serving import InferenceServer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = mixtral_8x7b(n_layers=TP_MOE_LAYERS) if moe else llama2_7b()
    mesh = tp_mesh(tp=world)
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=TP_DEVICE).manual_seed(SEED),
                        device=TP_DEVICE, mesh=mesh)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "weight_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters())}
    hits, hooks = [], []
    if moe:
        experts = torch.arange(cfg.n_experts, device=TP_DEVICE)

        def count(module, inputs, output):
            idx = module.last_routing[0]
            hits.append((idx[..., None] == experts).sum((0, 1)))

        hooks = [layer.feed_forward.register_forward_hook(count)
                 for layer in model.layers]
    server = InferenceServer(model, mesh=mesh, max_batch_slots=8,
                             kv_page_size=16, kv_prefix_cache=False,
                             device=TP_DEVICE, tp_timeout_s=600)
    prompts, stream_prompt = refs["prompts"], refs["stream_prompt"]
    if not moe:
        out["logits"] = torch.stack([server.prefill_logits(p)
                                     for p in prompts]).float().cpu()
        if world > 1:
            # Planted fault: rank 1 takes part in every wo all-reduce but
            # keeps its own partial product.
            def kept_own(attn):
                def out(o):
                    partial = attn.wo(o.reshape(o.shape[0], o.shape[1], -1))
                    reduce_from_tp(partial, attn.tp)
                    return partial
                return out

            attns = [layer.attention for layer in model.layers]
            if rank == 1:
                for attn in attns:
                    attn._out = kept_own(attn)
            out["fault_logits"] = server.prefill_logits(
                prompts[3]).float().cpu()
            if rank == 1:
                for attn in attns:
                    del attn._out
    steps0 = server.telemetry["dispatches_total"].value
    pa.LAUNCHES = 0
    server.start()
    try:
        if server.is_leader:
            out["run"] = tp_serve_run(server, prompts, stream_prompt,
                                      SERVE_NEW_TOKENS)
    finally:
        if server.is_leader:
            server.stop()
        else:
            server.join(timeout=TP_DEADLINE_S)
            server.stop()
    torch.cuda.synchronize()
    out.update(launches=pa.LAUNCHES,
               decode_steps=server.telemetry["dispatches_total"].value
               - steps0, n_layers=cfg.n_layers,
               peak_bytes=torch.cuda.max_memory_allocated())
    if server.mirror is not None:
        out["exchange_ms_per_turn"] = (server.mirror.seconds * 1e3
                                       / server.mirror.turns)
    for h in hooks:
        h.remove()
    if moe:
        routed = torch.stack(hits).sum(0).double()
        out["routed_share"] = (routed / routed.sum()).tolist()
    del server
    gc.collect()
    torch.cuda.empty_cache()
    if not moe:
        from mpi_operator_tpu_torch.serving.mirror import (TickMirror,
                                                          serving_ranks)
        out["decode_timing"] = decode_timing(
            model, TickMirror(serving_ranks(mesh)) if world > 1 else None)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_parity_run(world: int, fsdp: int, fault: bool):
    """Phase 9 (c) parity, one rank: llama2_tiny f32, DIST_PARITY_STEPS
    AdamW steps at fsdp x tp = world from the one-card weights cut by
    llama_param_specs; the full parameters after.  ``fault``: rank 1
    takes part in every copy-to-tp all-reduce of the backward but keeps
    its own input gradient."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from mpi_operator_tpu_torch.models.llama import (LlamaModel,
                                                     llama_param_specs)
    from mpi_operator_tpu_torch.models.params import (gather_state_dict,
                                                      shard_state_dict)
    from mpi_operator_tpu_torch.parallel import tensor as tpm
    from mpi_operator_tpu_torch.parallel.mesh import batch_rows
    from mpi_operator_tpu_torch.parallel.train import adamw, build_train_step

    cfg, weights, tokens = dist_parity_inputs(world)
    mesh = tp_mesh(fsdp=fsdp, tp=world // fsdp)
    model = LlamaModel(cfg, device=TP_DEVICE, store_dtype=torch.float32,
                       mesh=mesh)
    model.load_state_dict(shard_state_dict(weights, cfg, model.tp))
    init, step = build_train_step(dist_loss, adamw(DIST_LR), mesh=mesh,
                                  param_specs=llama_param_specs(cfg))
    state = init(model)
    rows = tokens[batch_rows(tuple(mesh.shape), mesh.get_coordinate(),
                             len(tokens))].to(TP_DEVICE)
    real = tpm._CopyToTP.backward
    if fault and dist.get_rank() == 1:
        def kept_own(ctx, grad):
            real(ctx, grad)
            return grad, None
        tpm._CopyToTP.backward = staticmethod(kept_own)
    try:
        metrics = []
        for _ in range(DIST_PARITY_STEPS):
            state, m = step(state, rows)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
    finally:
        tpm._CopyToTP.backward = real
    local = {n: (p.full_tensor() if isinstance(p, DTensor) else p).detach()
             for n, p in state.model.named_parameters()}
    params = {n: t.cpu() for n, t in gather_state_dict(
        local, cfg, state.model.tp).items()}
    return metrics, params


def tp_full_width_run(world: int):
    """Phase 9 (c) full width, one rank: llama2_7b with all 32 layers at
    fsdp = 2 x tp = 2 (world 4), or 16 layers at tp = 2 (world 2); built
    on the meta device, each rank drawing its shard; 1 x 4096 tokens a
    batch shard, f32 parameters and AdamW state, bf16 compute."""
    import dataclasses

    import torch.distributed as dist

    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.models.params import init_params_
    from mpi_operator_tpu_torch.ops import attention as fa
    from mpi_operator_tpu_torch.parallel.mesh import batch_rows
    from mpi_operator_tpu_torch.parallel.train import adamw, build_train_step

    fsdp = 2 if world >= 4 else 1
    cfg = dataclasses.replace(llama.llama2_7b(),
                              n_layers=32 if world >= 4 else 16)
    seq = cfg.max_seq_len
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = tp_mesh(fsdp=fsdp, tp=world // fsdp)
    init, step = build_train_step(dist_loss, adamw(3e-4), mesh=mesh,
                                  param_specs=llama.llama_param_specs(cfg))
    gen = torch.Generator(device=TP_DEVICE).manual_seed(SEED)
    state = init(llama.LlamaModel(cfg, device="meta",
                                  store_dtype=cfg.param_dtype, mesh=mesh),
                 init_weights=lambda m: init_params_(m, gen))
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (fsdp, seq))
    rows = torch.as_tensor(tokens[batch_rows(
        tuple(mesh.shape), mesh.get_coordinate(), fsdp)], device=TP_DEVICE)
    for kernel in fa.LAUNCHES:
        fa.LAUNCHES[kernel] = 0
    losses, stamps = [], []
    dist.barrier()
    for _ in range(TP_STEPS):
        state, metrics = step(state, rows)
        losses.append(metrics["loss"].item())
        stamps.append(time.perf_counter())
    launches = dict(fa.LAUNCHES)
    step_s = (stamps[-1] - stamps[0]) / (len(stamps) - 1)
    flops = fsdp * train_flops(cfg, 1, seq)
    peak = torch.cuda.max_memory_allocated()
    del state
    return {"n_layers": cfg.n_layers, "fsdp": fsdp, "tp": world // fsdp,
            "tokens_per_batch_shard": seq, "losses": losses,
            "step_ms": step_s * 1e3,
            "each_step_ms": [(b - a) * 1e3 for a, b in zip(stamps,
                                                          stamps[1:])],
            "tokens_per_s_per_card": fsdp * seq / step_s / world,
            "train_mfu": flops / step_s / (world * PEAK_OPS[torch.bfloat16]),
            "alloc_retries": torch.cuda.memory_stats().get(
                "num_alloc_retries", 0),
            "peak_bytes": peak, "launches": launches}


def head_chunk_digests(pages, tp: int):
    """Per rank r of a tp group, one digest of head chunk r (dim 1) of
    every wire leaf of ``pages``, page by page, leaves by path."""
    hashes = [hashlib.blake2b(digest_size=16) for _ in range(tp)]
    for page in pages:
        for path in sorted(page["leaves"]):
            for r, part in enumerate(page["leaves"][path].chunk(tp, dim=1)):
                hashes[r].update(part.contiguous().view(torch.uint8)
                                 .numpy().tobytes())
    return [h.hexdigest() for h in hashes]


def pool_rows_digest(batcher, digests) -> str:
    """One digest of this rank's pool rows of the pages ``digests`` name,
    in the order of ``head_chunk_digests``."""
    by_digest = {d: b for b, d in batcher._block_digest.items()}
    idx = torch.tensor([by_digest[d] for d in digests],
                       device=batcher.device)
    rows = {path: leaf.index_select(0, idx).cpu()
            for path, leaf in batcher._pool_leaves()}
    h = hashlib.blake2b(digest_size=16)
    for i in range(len(digests)):
        for path in sorted(rows):
            h.update(rows[path][i].contiguous().view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()


def tp_disagg_round(rank, mesh, model, kv, prompts, fault_prompt, coord):
    """One prefill/decode pair of (d): ranks 0-1 the prefill replica,
    ranks 2-3 the decode replica, each a tp = 2 server over ``model``
    with ``kv`` pools.  Rank 0 drives every prompt through /prefill (the
    decode replica as destination) and 32 greedy tokens on the decode
    replica; with ``fault_prompt`` a second ship is all dedup, then the
    decode replica's rank 0 scatters the chunks swapped for that prompt.
    Rank 0 re-exports the pages and takes each rank's head-chunk digest;
    the decode ranks, after the stop, their rows' digests and their
    last-position logits over the imported pages."""
    import torch.distributed as dist

    from mpi_operator_tpu_torch.ops import paged_attention as pa
    from mpi_operator_tpu_torch.serving import InferenceServer
    from mpi_operator_tpu_torch.serving.batcher import prefix_page_digests

    role = "decode" if rank >= 2 else "prefill"
    pa.LAUNCHES = 0
    server = InferenceServer(model, mesh=mesh, role=role, max_batch_slots=8,
                             kv_page_size=16, kv_cache_blocks=DISAGG_BLOCKS,
                             kv_cache_dtype=kv, model_name="llama2_7b",
                             device=TP_DEVICE, tp_timeout_s=600).start()
    urls = [None] * dist.get_world_size()
    dist.all_gather_object(urls, server.url if server.is_leader else None,
                           group=coord)
    ship = list(prompts) + ([fault_prompt] if fault_prompt else [])
    out = {"kv_cache_dtype": kv, "prompts": []}
    if rank == 0:
        for prompt in prompts:
            out["prompts"].append(tp_disagg_handoff(urls, prompt))
        if fault_prompt:
            again = post(urls[0] + "/prefill", {
                "tokens": prompts[0], "transfer": {"url": urls[2]}})
            out["reship"] = {k: again[k] for k in (
                "shipped", "deduped", "imported", "rejected")}
    dist.barrier(group=coord)
    if fault_prompt and rank == 2:
        real = server._batcher._head_chunks
        server._batcher._head_chunks = lambda rows: real(rows)[::-1]
    dist.barrier(group=coord)
    if rank == 0:
        if fault_prompt:
            out["fault"] = tp_disagg_handoff(urls, fault_prompt)
        t0 = time.perf_counter()
        out["wire"] = []
        for prompt in ship:
            pages = server._batcher.export_kv_pages(
                prefix_page_digests(prompt, 16))
            out["wire"].append({"pages": len(pages),
                                "raw_kv_bytes": page_bytes(pages),
                                "chunks": head_chunk_digests(pages, 2)})
        out["wire_digest_s"] = time.perf_counter() - t0
    dist.barrier(group=coord)
    if fault_prompt and rank == 2:
        del server._batcher._head_chunks
    if TP_DEVICE == "cuda":
        torch.cuda.synchronize()
    out.update(launches=pa.LAUNCHES,
               decode_steps=server.telemetry["dispatches_total"].value,
               prefix_hit_blocks=server.batcher_stats()["prefix"][
                   "hit_blocks"],
               page_record_bytes=server.mirror.page_record_bytes,
               exchange_ms_per_turn=(server.mirror.seconds * 1e3
                                     / max(1, server.mirror.turns)))
    if server.is_leader:
        server.stop()
    else:
        server.join(timeout=TP_DEADLINE_S)
        server.stop()
    logits = None
    if rank >= 2:
        out["rows"] = [pool_rows_digest(server._batcher,
                                        prefix_page_digests(p, 16))
                       for p in ship]
        logits = torch.stack([server.prefill_logits(p)
                              for p in ship]).float().cpu()
    del server
    gc.collect()
    if TP_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out, logits


def tp_disagg_handoff(urls, prompt):
    """Rank 0 of (d): one prompt's /prefill into the decode replica and
    its 32-token SSE stream there."""
    t0 = time.perf_counter()
    reply = post(urls[0] + "/prefill", {
        "tokens": prompt, "transfer": {"url": urls[2], "have": []}})
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    events, ttft = read_sse(urls[2] + "/generate", {
        "tokens": [prompt], "max_new_tokens": SERVE_NEW_TOKENS,
        "stream": True})
    stream_s = time.perf_counter() - t0
    got = [e["token"] for e in events if "token" in e]
    sec = reply["seconds"]
    return {"prompt_len": len(prompt), "digests": len(reply["digests"]),
            **{k: reply[k] for k in ("shipped", "deduped", "imported",
                                     "rejected", "bytes")},
            "prefill_s": prefill_s, "export_gather_s": sec["export"],
            "codec_s": sec["encode"] + sec["wire_decode"],
            "encode_s": sec["encode"], "push_s": sec["push"],
            "receiver_wire_decode_s": sec["wire_decode"],
            "import_scatter_s": sec["import"],
            "handoff_s": sec["export"] + sec["encode"] + sec["push"],
            "stream": got, "decode_ttft_s": ttft,
            "decode_tokens_per_s": len(got) / stream_s}


def tp_disagg(world: int, rank: int, refs, out_dir: str):
    """Phase 9 (d), one rank of four: two tp = 2 groups of one world
    (ranks 0-1 prefill, 2-3 decode), llama2_7b at 32 layers drawn as
    each rank's shard of the SEED weights; the bf16 round over
    DISAGG_PROMPT_LENS with the planted fault, then the int8 round over
    the 700-token prompt on new servers over the same models.  The
    decode ranks' logits go to ``out_dir`` from rank 2."""
    import torch.distributed as dist

    from mpi_operator_tpu_torch.models.llama import llama2_7b
    from mpi_operator_tpu_torch.models.params import init_params
    from mpi_operator_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    t_start = time.perf_counter()
    gc.collect()
    if TP_DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    # Host hand-offs (URLs, barriers) beside the servers' own groups.
    coord = dist.new_group(backend="gloo")
    meshes = [create_mesh(MeshConfig(dp=1, tp=2), TP_DEVICE, ranks=r)
              for r in ([0, 1], [2, 3])]
    cfg = llama2_7b()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=TP_DEVICE).manual_seed(
        SEED), device=TP_DEVICE, mesh=meshes[rank // 2])
    out = {"init_s": time.perf_counter() - t0, "n_layers": cfg.n_layers,
           "weight_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters())}
    by_len = dict(zip(SERVE_PROMPT_LENS, refs["prompts"]))
    bf16, logits = tp_disagg_round(
        rank, meshes[rank // 2], model, "auto",
        [by_len[n] for n in DISAGG_PROMPT_LENS], by_len[TP_DISAGG_FAULT_LEN],
        coord)
    int8, int8_logits = tp_disagg_round(rank, meshes[rank // 2], model,
                                        "int8", [by_len[TP_DISAGG_INT8_LEN]],
                                        None, coord)
    out.update(bf16=bf16, int8=int8)
    if rank == 2:
        torch.save({"bf16": logits, "int8": int8_logits},
                   os.path.join(out_dir, "tp_disagg_logits.pt"))
    del model
    gc.collect()
    if TP_DEVICE == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
    dist.barrier(group=coord)
    out["seconds"] = time.perf_counter() - t_start
    return out


def fsdp_mesh_axes(world: int) -> dict:
    """Phase 9 (e)'s mesh: fsdp = 2 x tp = world / 2."""
    return {"fsdp": 2, "tp": world // 2}


def swapped_gathers(fs):
    """Phase 9 (e)'s planted fault, on one rank: every gather it makes
    lays the fsdp shards in the wrong order (rank 1's first)."""
    real = fs._all_gather

    def gather(buf, shard):
        real(buf, shard)
        buf.copy_(buf.view(fs.par.size, -1).flip(0).reshape(-1))
    fs._all_gather = gather


def tp_fsdp_serve(world: int, rank: int, refs):
    """Phase 9 (e), one rank: llama2_7b at 32 layers from SEED served at
    fsdp = 2 x tp = world / 2, each rank holding 1/world of every matmul
    weight and gathering each block as it runs (phase 5's 8 slots, page
    16, no prefix cache).  Prefill logits of every prompt against one
    card, the planted fault (rank 1's gathers swap the fsdp shards), the
    serving run from rank 0 (TP_FSDP_NEW_TOKENS a stream), K4' launches
    and decode steps on every rank, the rank's resident weight bytes, a
    decode step's host, wall and gather ms."""
    from mpi_operator_tpu_torch.models.llama import (LlamaModel, llama2_7b,
                                                     llama_param_specs)
    from mpi_operator_tpu_torch.models.params import init_params
    from mpi_operator_tpu_torch.ops import paged_attention as pa
    from mpi_operator_tpu_torch.parallel.fsdp_serve import is_cut
    from mpi_operator_tpu_torch.serving import InferenceServer
    from mpi_operator_tpu_torch.serving.mirror import (TickMirror,
                                                      serving_ranks)

    t_start = time.perf_counter()
    gc.collect()
    cuda = TP_DEVICE == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg = llama2_7b()
    axes = fsdp_mesh_axes(world)
    mesh = tp_mesh(**axes)
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=TP_DEVICE).manual_seed(
        SEED), device=TP_DEVICE, mesh=mesh)
    if cuda:
        torch.cuda.synchronize()
    fs = model.fsdp_serve
    # The one-card model's bytes: what fsdp x tp cuts, and the rest.
    specs = llama_param_specs(cfg)
    whole = {"cut": 0, "norms": 0, "block_cut": 0}
    for k, t in LlamaModel(cfg, device="meta").state_dict().items():
        n = t.numel() * t.element_size()
        whole["cut" if is_cut(specs[k]) else "norms"] += n
        if k.startswith("layers.0.") and is_cut(specs[k]):
            whole["block_cut"] += n
    out = {"init_s": time.perf_counter() - t0, "n_layers": cfg.n_layers,
           **axes, "whole_bytes": whole, "resident": fs.resident_bytes(),
           "allocated_after_init": (torch.cuda.memory_allocated() if cuda
                                    else None)}
    server = InferenceServer(model, mesh=mesh, max_batch_slots=8,
                             kv_page_size=16, kv_prefix_cache=False,
                             device=TP_DEVICE, tp_timeout_s=600)
    prompts, stream_prompt = refs["prompts"], refs["stream_prompt"]
    logits = torch.stack([server.prefill_logits(p)
                          for p in prompts]).float().cpu()
    out["logit_err"] = logit_err(logits, refs["logits"])
    real = fs._all_gather
    if rank == 1:
        swapped_gathers(fs)
    fault = server.prefill_logits(prompts[3]).float().cpu()
    fs._all_gather = real
    out["fault_logit_err"] = logit_err(fault[None], refs["logits"][3:4])
    steps0 = server.telemetry["dispatches_total"].value
    pa.LAUNCHES = 0
    server.start()
    try:
        if server.is_leader:
            out["run"] = tp_serve_run(server, prompts, stream_prompt,
                                      TP_FSDP_NEW_TOKENS)
    finally:
        if server.is_leader:
            server.stop()
        else:
            server.join(timeout=TP_DEADLINE_S)
            server.stop()
    if cuda:
        torch.cuda.synchronize()
    out.update(launches=pa.LAUNCHES,
               decode_steps=server.telemetry["dispatches_total"].value
               - steps0,
               exchange_ms_per_turn=(server.mirror.seconds * 1e3
                                     / server.mirror.turns))
    del server
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        out["decode_timing"] = decode_timing(
            model, TickMirror(serving_ranks(mesh)))
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del model, fs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    return out


def tp_rank(out_dir: str) -> int:
    """A child of phase 9: (a) always; (b), (c) and (e) with two cards
    or more; (d) with four."""
    import torch.distributed as dist

    rank, world = tp_group()
    refs = torch.load(os.path.join(out_dir, "tp_refs.pt"))
    result = {"rank": rank, "world": world, "card":
              torch.cuda.current_device(), "backend": dist.get_backend(),
              "seconds": {}}
    tensors = {}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        result["seconds"][name] = time.perf_counter() - t0
        return out

    serve = timed("(a) llama2_7b serving", tp_serve, world, rank, refs,
                  moe=False)
    tensors.update(logits=serve.pop("logits"),
                   fault_logits=serve.pop("fault_logits", None))
    result["serve"] = serve
    if world >= 2:
        result["moe"] = timed("(b) mixtral_8x7b serving", tp_serve, world,
                              rank, refs, moe=True)
        t0 = time.perf_counter()
        runs = {"tp": tp_parity_run(world, 1, fault=False),
                "tp_fault": tp_parity_run(world, 1, fault=True)}
        if world >= 4:
            runs["fsdp_tp"] = tp_parity_run(world, 2, fault=False)
        result["seconds"]["(c) parity"] = time.perf_counter() - t0
        result["parity_metrics"] = {k: v[0] for k, v in runs.items()}
        tensors["parity"] = {k: v[1] for k, v in runs.items()}
        result["full_width"] = [timed(f"(c) full width run {i}",
                                      tp_full_width_run, world)
                                for i in range(2)]
    if world >= 4:
        result["disagg"] = timed("(d) disagg", tp_disagg, world, rank, refs,
                                 out_dir)
    if world >= 2:
        result["fsdp"] = timed("(e) fsdp serving", tp_fsdp_serve, world,
                               rank, refs)
    if rank == 0:
        torch.save(tensors, os.path.join(out_dir, "tp_tensors.pt"))
    with open(os.path.join(out_dir, f"tp_rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()
    return 0


def tp_references(out_dir: str, serve):
    """One-card references on card 0, in this process: the 7B from SEED,
    each serving prompt's prefill logits (as the tp ranks take them), and
    over each prompt and its phase-5 stream the one-card top-2 logit gap
    at every stream position, relative to the largest |logit|."""
    from mpi_operator_tpu_torch.models.llama import init_cache
    from mpi_operator_tpu_torch.serving import ContinuousBatcher

    model = serving_model()
    prompts, stream_prompt = serving_prompts(model.config.vocab_size)
    if prompts != serve["prompts"]:
        raise SystemExit("tensor parallel: the serving prompts moved")
    batcher = ContinuousBatcher(model, max_slots=1, page_size=16,
                                prefix_cache=False, device="cuda")
    with torch.inference_mode():
        logits = torch.stack([batcher.prefill_logits(p)
                              for p in prompts]).float().cpu()
        gaps = []
        for p, stream in zip(prompts + [stream_prompt], serve["alone"]):
            seq = p + stream[:-1]
            cache = init_cache(model.config, 1, "cuda", max_len=len(seq))
            out = model(torch.tensor([seq], device="cuda"), cache=cache,
                        decode=True)[0, len(p) - 1:].float()
            top2 = out.topk(2, dim=-1).values
            gaps.append(((top2[:, 0] - top2[:, 1])
                         / out.abs().amax(-1)).cpu().tolist())
    del batcher
    gc.collect()
    torch.cuda.empty_cache()
    timing = decode_timing(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    torch.save({"prompts": prompts, "stream_prompt": stream_prompt,
                "logits": logits, "gaps": gaps, "alone": serve["alone"]},
               os.path.join(out_dir, "tp_refs.pt"))
    return logits, gaps, timing


def logit_err(got, want) -> float:
    """Largest difference over largest |logit|, per prompt, the worst."""
    return ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item()


def stream_verdict(got, want, gaps, limit):
    """None when the streams agree or first differ where the one-card
    top-2 gap is below ``limit`` (a bf16 near-tie); else the position."""
    for pos, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return None if gaps[pos] < limit else pos
    return None if len(got) == len(want) else len(got)


def tp_disagg_verdict(card: str, ranks, out_dir: str, ref_logits, gaps,
                      serve):
    """Phase 9 (d)'s checks over the four ranks' reports; prints them and
    returns the decode ranks' K4' launches."""
    d = [r["disagg"] for r in ranks]
    logits = torch.load(os.path.join(out_dir, "tp_disagg_logits.pt"))
    at = {n: SERVE_PROMPT_LENS.index(n) for n in SERVE_PROMPT_LENS}
    failures, report = [], {}
    for name, lens in (("bf16", DISAGG_PROMPT_LENS),
                       ("int8", (TP_DISAGG_INT8_LEN,))):
        lead = d[0][name]
        fault = name == "bf16"
        ship = list(lens) + ([TP_DISAGG_FAULT_LEN] if fault else [])
        handoffs = lead["prompts"] + ([lead["fault"]] if fault else [])
        for row in handoffs:
            if not (row["shipped"] == row["imported"] == row["digests"] > 0
                    and row["rejected"] == 0):
                failures.append(f"{name} {row['prompt_len']}: handoff "
                                f"{ {k: row[k] for k in ('digests', 'shipped', 'imported', 'deduped', 'rejected')} }")
        if fault and not (lead["reship"]["deduped"]
                          == lead["reship"]["shipped"]
                          == handoffs[0]["digests"]
                          and lead["reship"]["imported"] == 0):
            failures.append(f"bf16: a second ship was not all dedup: "
                            f"{lead['reship']}")
        hits = sum(row["digests"] for row in handoffs)
        for r in (2, 3):
            if d[r][name]["prefix_hit_blocks"] != hits:
                failures.append(f"{name} rank {r}: {d[r][name]['prefix_hit_blocks']}"
                                f" prefix hits, {hits} pages imported "
                                f"(a page prefilled again?)")
        rows_equal = {}
        for i, n in enumerate(ship):
            chunks = lead["wire"][i]["chunks"]
            held = [d[2][name]["rows"][i], d[3][name]["rows"][i]]
            rows_equal[n] = [h == c for h, c in zip(held, chunks)]
            planted = fault and n == TP_DISAGG_FAULT_LEN
            if planted == any(rows_equal[n]) or \
                    (not planted and not all(rows_equal[n])):
                failures.append(f"{name} {n}: pool rows equal to the "
                                f"rank's head chunk {rows_equal[n]}"
                                f"{' under the planted fault' if planted else ''}")
        errs = {n: logit_err(logits[name][i][None],
                             ref_logits[at[n]][None])
                for i, n in enumerate(ship)}
        err = max(errs[n] for n in lens)
        if not err <= TP_LOGIT_LIMIT:
            failures.append(f"{name}: logits over the imported pages differ"
                            f" from one card by {err} (limit "
                            f"{TP_LOGIT_LIMIT})")
        if fault and not errs[TP_DISAGG_FAULT_LEN] > TP_LOGIT_LIMIT:
            failures.append(f"bf16: the planted fault's logits differ by "
                            f"{errs[TP_DISAGG_FAULT_LEN]}, within "
                            f"{TP_LOGIT_LIMIT}")
        moved = {}
        for row in handoffs:
            n = row["prompt_len"]
            moved[n] = stream_verdict(row["stream"], serve["alone"][at[n]],
                                      gaps[at[n]], err)
            if n != TP_DISAGG_FAULT_LEN and (
                    moved[n] is not None
                    or len(row["stream"]) != SERVE_NEW_TOKENS):
                failures.append(f"{name} {n}: the decode stream leaves "
                                f"phase 5's at {moved[n]}, beyond a "
                                f"near-tie")
        for r in range(4):
            x = d[r][name]
            want = x["decode_steps"] * d[r]["n_layers"] if r >= 2 else 0
            if x["launches"] != want or (r >= 2 and not want) or \
                    (r < 2 and x["decode_steps"]):
                failures.append(f"{name} rank {r}: K4' launches "
                                f"{x['launches']}, decode steps "
                                f"{x['decode_steps']}")
        raw = sum(w["raw_kv_bytes"] for w in lead["wire"][:len(handoffs)])
        report[name] = {
            "logit_err": err, "logit_err_per_prompt": errs,
            "stream_first_departure": moved, "rows_equal": rows_equal,
            "prompts": [{**{k: v for k, v in row.items() if k != "stream"},
                         "raw_kv_bytes": w["raw_kv_bytes"],
                         "handoff_gb_per_s": w["raw_kv_bytes"]
                         / row["handoff_s"] / 1e9,
                         "scatter_bytes_sent_by_rank2": w["raw_kv_bytes"] / 2}
                        for row, w in zip(handoffs, lead["wire"])],
            "handoff_gb_per_s": raw / sum(r["handoff_s"] for r in handoffs)
            / 1e9,
            "reship": lead.get("reship"),
            "wire_digest_s": lead["wire_digest_s"],
            "per_rank": [{k: d[r][name][k] for k in (
                "launches", "decode_steps", "prefix_hit_blocks",
                "page_record_bytes", "exchange_ms_per_turn")}
                for r in range(4)]}
    for r in range(4):
        if not d[r].get("peak_bytes", 0) < 80e9:
            failures.append(f"rank {r}: peak {d[r].get('peak_bytes')}")
    seconds = [x["seconds"] for x in d]
    print("tensor parallel (d) disaggregated llama2_7b, prefill tp = 2 "
          "(ranks 0-1) -> decode tp = 2 (ranks 2-3): " + json.dumps({
              "card": card, "n_layers": d[0]["n_layers"], "slots": 8,
              "page_size": 16, "kv_cache_blocks": DISAGG_BLOCKS,
              "logit_limit": TP_LOGIT_LIMIT, **report,
              "peak_bytes": [x.get("peak_bytes") for x in d],
              "init_s": [x["init_s"] for x in d],
              "seconds": seconds, "budget_s": TP_DISAGG_BUDGET_S}),
          flush=True)
    if failures:
        raise SystemExit("tensor parallel (d): " + "; ".join(failures))
    print(f"tensor parallel (d): {max(seconds):.1f} s (budget "
          f"{TP_DISAGG_BUDGET_S} s); {card}", flush=True)
    return {f"{name}_rank{r}": d[r][name]["launches"]
            for name in ("bf16", "int8") for r in (2, 3)}


def tp_fsdp_verdict(card: str, ranks, serve, gaps):
    """Phase 9 (e)'s checks over every rank's report; prints them beside
    (a)'s (tp = world) and returns rank 0's K4' launches."""
    world = len(ranks)
    e = [r["fsdp"] for r in ranks]
    lead, a = e[0], ranks[0]["serve"]
    tp, fsdp = lead["tp"], lead["fsdp"]
    err = max(x["logit_err"] for x in e)
    if not err <= TP_LOGIT_LIMIT:
        raise SystemExit(f"tensor parallel (e): prefill logits differ from "
                         f"one card by {err} of the largest logit (limit "
                         f"{TP_LOGIT_LIMIT})")
    fault = e[1]["fault_logit_err"]
    if not fault > TP_LOGIT_LIMIT:
        raise SystemExit(f"tensor parallel (e): a planted fault (rank 1 "
                         f"swaps the fsdp shards of every gather) gives "
                         f"{fault}, within {TP_LOGIT_LIMIT}")
    run = lead["run"]
    if run["concurrent"] != run["alone"]:
        raise SystemExit("tensor parallel (e): concurrent != alone")
    want = [w[:TP_FSDP_NEW_TOKENS] for w in serve["alone"]]
    moved = {i: stream_verdict(got, w, gaps[i], err) for i, (got, w)
             in enumerate(zip(run["alone"], want))}
    if any(v is not None for v in moved.values()):
        raise SystemExit(f"tensor parallel (e): streams differ from the "
                         f"serving phase's beyond a near-tie: {moved}")
    bad = []
    for r, x in zip(ranks, e):
        w, res = x["whole_bytes"], x["resident"]
        # Each unit's run is padded to a multiple of fsdp: a few bytes.
        slack = 64 * (x["n_layers"] + 2)
        units = w["cut"] - x["n_layers"] * w["block_cut"]  # embed + head
        buffers = (2 * w["block_cut"] + units) / tp
        if not (w["cut"] / world <= res["shards"] <= w["cut"] / world
                + slack and res["whole"] == w["norms"]
                and buffers <= res["buffers"] <= buffers + slack):
            bad.append(f"rank {r['rank']} holds {res}, want shards "
                       f"{w['cut'] / world}, norms {w['norms']}, buffers "
                       f"{buffers}")
        if x["launches"] != x["decode_steps"] * x["n_layers"] or \
                x["launches"] == 0 or not x["peak_bytes"] < 80e9:
            bad.append(f"rank {r['rank']}: K4' launches {x['launches']}, "
                       f"decode steps {x['decode_steps']} x "
                       f"{x['n_layers']}, peak {x['peak_bytes']}")
    if bad:
        raise SystemExit(f"tensor parallel (e): {bad}")
    received = lead["whole_bytes"]["cut"] / tp * (fsdp - 1) / fsdp
    keys = ("ttft_mean_s", "inter_token_latency_mean_s",
            "output_tokens_per_s", "concurrent_wall_s")
    print(f"tensor parallel (e) llama2_7b, weights over fsdp={fsdp} x tp="
          f"{tp}, each block gathered per forward: " + json.dumps({
              "card": card, "world": world, "n_layers": lead["n_layers"],
              "slots": 8, "page_size": 16, "logit_err": err,
              "logit_limit": TP_LOGIT_LIMIT,
              "planted_fault_logit_err": fault,
              "new_tokens_each": TP_FSDP_NEW_TOKENS,
              "streams_differing_from_phase5_at_near_ties": sum(
                  g != w for g, w in zip(run["alone"], want)),
              **{k: run[k] for k in keys},
              "a_tp_world": {"new_tokens_each": SERVE_NEW_TOKENS,
                             **{k: a["run"][k] for k in keys}},
              "gather_bytes_received_per_forward": received,
              "gather_bound_ms_at_nvlink": received / NVLINK_BYTES_PER_S
              * 1e3,
              "seconds": max(x["seconds"] for x in e),
              "budget_s": TP_FSDP_BUDGET_S,
              "per_rank": [{
                  "rank": r["rank"], "resident": x["resident"],
                  "a_weight_bytes": r["serve"]["weight_bytes"],
                  "whole_weight_bytes": x["whole_bytes"]["cut"]
                  + x["whole_bytes"]["norms"],
                  **{k: x.get(k) for k in (
                      "launches", "decode_steps", "peak_bytes",
                      "allocated_after_init", "init_s",
                      "exchange_ms_per_turn", "decode_timing")},
                  "a_decode_timing": r["serve"].get("decode_timing")}
                  for r, x in zip(ranks, e)]}), flush=True)
    return lead["launches"]


def tp_phase(card: str, serve):
    """Phase 9: one process per card (tp_world), NCCL.  (a) llama2_7b
    served at tp = world, all 32 layers; (b) mixtral_8x7b served at
    TP_MOE_LAYERS of 32 layers, tp = world (two cards or more); (c)
    training parity at tp = world (and fsdp = 2 x tp = 2) against card 0
    alone with a planted fault, and the 7B at full width, twice; (d) at
    four cards, the 7B handed from a tp = 2 prefill replica to a tp = 2
    decode replica; (e) with two cards or more, the 7B served with its
    weights cut over fsdp = 2 x tp = world / 2."""
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="chip-smoke-tp-")
    gc.collect()
    torch.cuda.empty_cache()
    world = tp_world()
    print(f"tensor parallel: world {world} (tp = {world}, one process per "
          f"card); {card}", flush=True)
    ref_logits, gaps, one_card_timing = tp_references(out_dir, serve)
    run_ranks([sys.executable, os.path.abspath(__file__), "tp-rank",
               out_dir], world, "tensor parallel", TP_DEADLINE_S, out_dir)
    ranks = [json.load(open(os.path.join(out_dir, f"tp_rank{r}.json")))
             for r in range(world)]
    tensors = torch.load(os.path.join(out_dir, "tp_tensors.pt"))
    backend = "nccl" if TP_DEVICE == "cuda" else "gloo"
    if any(r["world"] != world or (world > 1 and r["backend"] != backend)
           or r["card"] != r["rank"] for r in ranks):
        raise SystemExit(f"tensor parallel: ranks formed {ranks}")

    # (a) llama2_7b.
    err = logit_err(tensors["logits"], ref_logits)
    if not err <= TP_LOGIT_LIMIT:
        raise SystemExit(f"tensor parallel (a): prefill logits differ from "
                         f"one card by {err} of the largest logit (limit "
                         f"{TP_LOGIT_LIMIT})")
    fault = None
    if world > 1:
        fault = logit_err(tensors["fault_logits"][None], ref_logits[3:4])
        if not fault > TP_LOGIT_LIMIT:
            raise SystemExit(f"tensor parallel (a): a planted fault (rank "
                             f"1 keeps its own wo partials) gives {fault}, "
                             f"within {TP_LOGIT_LIMIT}")
    run = ranks[0]["serve"]["run"]
    if run["concurrent"] != run["alone"]:
        raise SystemExit("tensor parallel (a): concurrent != alone")
    moved = {i: stream_verdict(got, want, gaps[i], err) for i, (got, want)
             in enumerate(zip(run["alone"], serve["alone"]))}
    if any(v is not None for v in moved.values()):
        raise SystemExit(f"tensor parallel (a): streams differ from the "
                         f"serving phase's beyond a near-tie: {moved}")
    differs = sum(a != b for a, b in zip(run["alone"], serve["alone"]))
    for label, key in (("(a)", "serve"), ("(b)", "moe")):
        if key not in ranks[0]:
            continue
        for r in ranks:
            s = r[key]
            layers = s["n_layers"]
            if s["launches"] != s["decode_steps"] * layers or \
                    s["launches"] == 0 or not s["peak_bytes"] < 80e9:
                raise SystemExit(f"tensor parallel {label} rank {r['rank']}:"
                                 f" K4' launches {s['launches']}, decode "
                                 f"steps {s['decode_steps']} x {layers}, "
                                 f"peak {s['peak_bytes']}")
    keys = ("ttft_mean_s", "inter_token_latency_mean_s",
            "output_tokens_per_s", "concurrent_wall_s")
    print("tensor parallel (a) llama2_7b: " + json.dumps({
        "card": card, "world": world, "tp": world, "n_layers": 32,
        "slots": 8, "page_size": 16, "logit_err": err,
        "logit_limit": TP_LOGIT_LIMIT, "planted_fault_logit_err": fault,
        "streams_differing_from_phase5_at_near_ties": differs,
        **{k: run[k] for k in keys},
        "one_card_inter_token_latency_mean_s": serve["itl_mean_s"],
        "one_card_decode_timing": one_card_timing,
        "per_rank": [{k: r["serve"].get(k) for k in (
            "launches", "decode_steps", "peak_bytes", "weight_bytes",
            "init_s", "exchange_ms_per_turn", "decode_timing")}
            for r in ranks]}), flush=True)
    result = {"world": world, "launches_rank0": ranks[0]["serve"]["launches"]}
    if world < 2:
        print("tensor parallel (b) mixtral_8x7b, (c) training, (e) "
              "weights over fsdp: need two cards (tp over one card is "
              "phase 5f's serving); (d) disaggregated prefill/decode "
              "across tp groups: needs four (phase 5e is the one-card "
              "handoff); this machine shows one", flush=True)
        return result

    # (b) mixtral_8x7b at TP_MOE_LAYERS layers.
    moe = ranks[0]["moe"]
    if moe["run"]["concurrent"] != moe["run"]["alone"]:
        raise SystemExit("tensor parallel (b): concurrent != alone")
    if min(moe["routed_share"]) <= 0:
        raise SystemExit(f"tensor parallel (b): an expert routed nothing: "
                         f"{moe['routed_share']}")
    print("tensor parallel (b) mixtral_8x7b: " + json.dumps({
        "card": card, "world": world, "tp": world,
        "n_layers": moe["n_layers"],
        **{k: moe["run"][k] for k in keys},
        "pr7_16_layer_one_card_inter_token_latency_s": 0.0692,
        "routed_share_per_expert": moe["routed_share"],
        "per_rank": [{k: r["moe"].get(k) for k in (
            "launches", "decode_steps", "peak_bytes", "weight_bytes",
            "init_s", "exchange_ms_per_turn")} for r in ranks]}),
        flush=True)
    result["moe_launches_rank0"] = moe["launches"]

    # (c) training.
    ref_metrics, ref_params, smallest = dist_parity_reference(world)
    verdict = {name: [f for r in ranks for f in dist_parity_failures(
        r["parity_metrics"][name], params, ref_metrics, ref_params,
        smallest)] for name, params in tensors["parity"].items()}
    if any(v for k, v in verdict.items() if k != "tp_fault") or \
            not verdict["tp_fault"]:
        raise SystemExit(f"tensor parallel (c) parity: {verdict}")
    print(f"tensor parallel (c) parity: llama2_tiny f32, "
          f"{DIST_PARITY_STEPS} AdamW steps, "
          f"{' and '.join(k for k in verdict if k != 'tp_fault')} == card 0 "
          f"alone at {DIST_STEP_TOL}; planted fault caught "
          f"({verdict['tp_fault'][:2]})", flush=True)
    stats = []
    for r in ranks:
        first, again = r["full_width"]
        want = TP_STEPS * first["n_layers"]
        if any(n != want for n in first["launches"].values()) or \
                not all(np.isfinite(first["losses"])) or \
                not first["peak_bytes"] < 80e9 or \
                again["losses"] != first["losses"]:
            raise SystemExit(f"tensor parallel (c) rank {r['rank']}: "
                             f"{first} / repeat {again['losses']}")
        stats.append({**first, "rank": r["rank"],
                      "losses_repeat": again["losses"],
                      "repeat_step_ms": again["step_ms"]})
    print(f"tensor parallel (c) llama2_7b full width, fsdp="
          f"{stats[0]['fsdp']} x tp={stats[0]['tp']}, {stats[0]['n_layers']}"
          f" layers: " + json.dumps({"card": card, "world": world,
                                     "pr9": PR9_FSDP4, "ranks": stats}),
          flush=True)
    result["train_launches_rank0"] = stats[0]["launches"]

    # (d) disaggregated prefill/decode across two tp groups.
    if world >= 4:
        result["disagg_launches"] = tp_disagg_verdict(
            card, ranks, out_dir, ref_logits, gaps, serve)
    else:
        print(f"tensor parallel (d) disaggregated prefill/decode across tp "
              f"groups: needs four cards (two tp = 2 replicas); this "
              f"machine shows {world}", flush=True)

    # (e) llama2_7b with its weights cut over fsdp too.
    result["fsdp_launches_rank0"] = tp_fsdp_verdict(card, ranks, serve,
                                                    gaps)
    print("tensor parallel parts (seconds, rank 0): "
          + json.dumps(ranks[0]["seconds"]), flush=True)
    return result


# -- phase 11: sequence and expert parallel ----------------------------------

SP_DEADLINE_S = 900
SP_STEPS = 4                      # one warm-up + 3 timed
SP_RESHARD_AT = 2                 # the move, at step 2 of SP_RESHARD_STEPS
SP_RESHARD_STEPS = 4
SP_RING_ITERS = 5


def sp_world() -> int:
    """Ranks of phase 11: 4 or 2 (one card runs none)."""
    cards = torch.cuda.device_count()
    return 4 if cards >= 4 else (2 if cards >= 2 else 1)


def sp_full_configs(world: int):
    """(b) the 7B round the ring and (c) Mixtral over ep: preset, layers
    of 32, mesh axes, tokens of the one row of a batch shard, activation
    checkpointing.  Both run under activation checkpointing (without it
    a rank ran out of its 80 GB in each: PERF.md, PR 11), so f32
    weights, gradients and AdamW moments (16 B a parameter) set the
    depth.  Four cards: the 7B whole, 108 GB (54 a rank at fsdp = 2;
    35.1 GB peak a rank measured at 16 layers, so about 62 at 32), and
    Mixtral at 8 layers, which holds 0.75 B parameters a layer on each
    ep rank (E/2 experts): 6.2 B with the embeddings, 50 GB a rank at
    fsdp = 2 (52.9 GB peak measured at 6 layers, so about 65 at 8).  Two
    cards, without fsdp: the 7B at 8 layers (34 GB of state) and Mixtral
    at 4 (52 GB).  The 7B runs 16 of its 32 layers at four cards: the
    seconds it saved pay for phase 12 (c) and (d) (PERF.md section 4)."""
    four = world >= 4
    return ({"preset": "llama2_7b", "layers": 16 if four else 8,
             "mesh": dict(fsdp=2, sp=2) if four else dict(sp=2),
             "seq": 16384, "remat": True},
            {"preset": "mixtral_8x7b", "layers": 8 if four else 4,
             "mesh": dict(fsdp=2, ep=2) if four else dict(ep=2),
             "seq": 4096, "remat": True})


def train_flops(cfg, batch: int, seq: int) -> float:
    """The flops of one training step (PERF.md section 2): 6 per token
    and matmul parameter that does useful work (for MoE attention, the
    top-k of the experts, the router and the head) and the causal
    attention products over the whole sequence."""
    moe = cfg.n_experts > 1
    ffn_params = ((cfg.top_k if moe else 1) * 3 * cfg.dim * cfg.ffn_dim
                  + (cfg.dim * cfg.n_experts if moe else 0))
    matmul_params = cfg.n_layers * (
        2 * cfg.dim * cfg.n_heads * cfg.head_dim
        + 2 * cfg.dim * cfg.kv_heads * cfg.head_dim
        + ffn_params) + cfg.dim * cfg.vocab_size
    return (6 * batch * seq * matmul_params
            + 12 * cfg.n_layers * batch * seq ** 2 * cfg.dim / 2)


def sp_group():
    """This process's group for phase 11 (NCCL on its card)."""
    import torch.distributed as dist

    from mpi_operator_tpu_torch.bootstrap import initialize_from_env

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_from_env(collective_timeout_seconds=600)
    return dist.get_rank(), dist.get_world_size()


_SP_MESHES = {}


def sp_mesh(**axes):
    """Phase 11's mesh over these axes (dp the rest), made once per
    process: each DeviceMesh forms communicators of its own, whose NCCL
    buffers stay on the card, so (a)'s runs and (b)/(c) share them."""
    from mpi_operator_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    key = tuple(sorted(axes.items()))
    if key not in _SP_MESHES:
        _SP_MESHES[key] = create_mesh(MeshConfig(**{"dp": -1, **axes}),
                                      "cuda")
    return _SP_MESHES[key]


def sp_loss(model, batch):
    from mpi_operator_tpu_torch.models.llama import next_token_loss
    return next_token_loss(model(batch), batch, sp=model.sp)


def sp_local_batch(mesh, tokens):
    from mpi_operator_tpu_torch.parallel.mesh import batch_rows, seq_cols
    shape, coord = tuple(mesh.shape), mesh.get_coordinate()
    rows = tokens[batch_rows(shape, coord, len(tokens))]
    return rows[:, seq_cols(shape, coord, rows.shape[1])].to("cuda")


def sp_parity_run(world: int, kind: str, fault: bool):
    """Phase 11 (a), one rank: DIST_PARITY_STEPS AdamW steps of a tiny
    f32 model from the one-card weights (cut by llama_param_specs) on
    ``kind``'s mesh; the full parameters after.  Kinds: "sp" (sp =
    world, the ring on the flash kernels), "fsdp_sp" (fsdp = 2 x sp =
    2), "ep" (mixtral_tiny, ep = 2, dp the rest), "fsdp_ep" (fsdp = 2 x
    ep = 2).  ``fault``: under sp, rank 1's RoPE positions are not
    offset (its columns rotated as if they began the sequence); under
    ep, rank 1 takes part in the all-reduce of the MoE combine but keeps
    its own partial."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.models.params import (gather_state_dict,
                                                      shard_state_dict)
    from mpi_operator_tpu_torch.parallel import tensor as tpm
    from mpi_operator_tpu_torch.parallel.train import adamw, build_train_step

    moe = kind.endswith("ep")
    cfg, weights, tokens = dist_parity_inputs(
        world, "mixtral_tiny" if moe else "llama2_tiny")
    if not moe:
        cfg = dataclasses.replace(cfg, ring_impl="flash")
    axes = {"sp": dict(sp=world), "fsdp_sp": dict(fsdp=2, sp=2),
            "ep": dict(ep=2), "fsdp_ep": dict(fsdp=2, ep=2)}[kind]
    mesh = sp_mesh(**axes)
    model = llama.LlamaModel(cfg, device="cuda",
                             store_dtype=torch.float32, mesh=mesh)
    model.load_state_dict(shard_state_dict(weights, cfg, model.tp,
                                           model.ep))
    init, step = build_train_step(sp_loss, adamw(DIST_LR), mesh=mesh,
                                  param_specs=llama.llama_param_specs(cfg))
    state = init(model)
    rows = sp_local_batch(mesh, tokens)
    real_rope, real_reduce = llama._rope, tpm._ReduceFromTP.forward
    if fault and dist.get_rank() == 1:
        if moe:
            def kept_own(ctx, x, tp):
                real_reduce(ctx, x, tp)
                return x.clone()
            tpm._ReduceFromTP.forward = staticmethod(kept_own)
        else:
            def local_positions(x, positions, *args):
                return real_rope(x, positions - positions[0], *args)
            llama._rope = local_positions
    try:
        metrics = []
        for _ in range(DIST_PARITY_STEPS):
            state, m = step(state, rows)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
    finally:
        llama._rope, tpm._ReduceFromTP.forward = real_rope, real_reduce
    local = {n: (p.full_tensor() if isinstance(p, DTensor) else p).detach()
             for n, p in state.model.named_parameters()}
    params = {n: t.cpu() for n, t in gather_state_dict(
        local, cfg, state.model.tp, state.model.ep).items()}
    return metrics, params


def sp_reshard_run(world: int):
    """Phase 11 (a), the live re-shard: llama2_tiny f32 with the ZeRO
    update, SP_RESHARD_STEPS steps straight on two ranks (dp = 2), grown
    from card 0 alone to two ranks before step SP_RESHARD_AT, and shrunk
    from two ranks to card 0; every rank of the group takes part in each
    move.  Returns, on rank 0: the three runs' final parameters and
    whether each moved state_dict equals the one before its move, bit
    for bit."""
    import torch.distributed as dist

    from mpi_operator_tpu_torch.models.llama import LlamaModel
    from mpi_operator_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from mpi_operator_tpu_torch.parallel.train import (adamw,
                                                       build_train_step,
                                                       reshard_train_state)

    cfg, weights, tokens = dist_parity_inputs(2)
    one = create_mesh(MeshConfig(dp=1), "cuda", ranks=[0])
    two = create_mesh(MeshConfig(dp=2), "cuda", ranks=[0, 1])

    def begin(mesh):
        if mesh.get_coordinate() is None:
            return None, None
        init, step = build_train_step(dist_loss, adamw(DIST_LR), mesh=mesh,
                                      shard_update=True)
        model = LlamaModel(cfg, device="cuda", store_dtype=torch.float32)
        model.load_state_dict(weights)
        return init(model), step

    def run(meshes):
        state, step = begin(meshes[0])
        mesh, equal = meshes[0], None
        for i in range(SP_RESHARD_STEPS):
            if i == SP_RESHARD_AT and len(meshes) > 1:
                before = state.state_dict() if state is not None else None
                mesh = meshes[1]
                state = reshard_train_state(state, mesh, shard_update=True)
                after = state.state_dict() if state is not None else None
                if dist.get_rank() == 0:
                    equal = state.step == SP_RESHARD_AT and \
                        state_dicts_equal(before, after)
                if state is not None:
                    _, step = build_train_step(dist_loss, adamw(DIST_LR),
                                               mesh=mesh, shard_update=True)
            if state is not None:
                state, _ = step(state, sp_local_batch(mesh, tokens))
        params = None
        if state is not None and dist.get_rank() == 0:
            params = {n: p.detach().cpu() for n, p in
                      state.model.named_parameters()}
        return params, equal

    out = {name: run(meshes) for name, meshes in (
        ("straight", [two]), ("grow", [one, two]), ("shrink", [two, one]))}
    return out if dist.get_rank() == 0 else None


def state_dicts_equal(a, b) -> bool:
    """Two state dicts (nested dicts and lists of tensors and values)
    hold the same keys, values and tensor bits."""
    if torch.is_tensor(a) or torch.is_tensor(b):
        return torch.is_tensor(a) and torch.is_tensor(b) and \
            a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            state_dicts_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(
            state_dicts_equal(x, y) for x, y in zip(a, b))
    return a == b


def ring_timing(mesh, cfg, seq_local: int):
    """Device ms of one ring attention forward and backward at the
    layer's shape (1 x S/sp x H x D, bf16, the flash route) on this
    rank's sp group, and of one rotation of its K/V chunk alone; CUDA
    events over SP_RING_ITERS runs after one warm-up."""
    from mpi_operator_tpu_torch.ops.ring_attention import ring_attention
    from mpi_operator_tpu_torch.parallel.tensor import (SequenceParallel,
                                                        ring_shift)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shape = (1, seq_local, cfg.n_heads, cfg.head_dim)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(4))
    leaves = [x.requires_grad_() for x in (q, k, v)]
    sp = SequenceParallel.of(mesh)
    kv = [k.detach().transpose(1, 2).contiguous(),
          v.detach().transpose(1, 2).contiguous()]

    def ring():
        out = ring_attention(*leaves, mesh, impl="flash")
        torch.autograd.backward(out, g)

    def rotate():
        ring_shift(kv, sp)

    times = {}
    for name, fn in (("ring_fwd_bwd_ms", ring), ("kv_rotation_ms", rotate)):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(SP_RING_ITERS):
            fn()
        end.record()
        end.synchronize()
        times[name] = start.elapsed_time(end) / SP_RING_ITERS
    return times


def sp_full_width_run(world: int, spec: dict, mesh):
    """Phase 11 (b) or (c), one rank: ``spec``'s model at full width, cut
    to its layers, on ``mesh`` (``spec``'s axes), f32 parameters and AdamW state, bf16
    compute, built on the meta device with each rank drawing its shard;
    one row of ``spec['seq']`` tokens a batch shard; SP_STEPS steps.  The
    flash kernels' launches are counted over the steps, and for MoE the
    routed share of each expert over every layer's last forward."""
    import torch.distributed as dist

    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.models.params import init_params_
    from mpi_operator_tpu_torch.ops import attention as fa
    from mpi_operator_tpu_torch.parallel.train import adamw, build_train_step

    cfg = dataclasses.replace(getattr(llama, spec["preset"])(),
                              n_layers=spec["layers"], ring_impl="flash",
                              max_seq_len=spec["seq"], remat=spec["remat"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init, step = build_train_step(sp_loss, adamw(3e-4), mesh=mesh,
                                  param_specs=llama.llama_param_specs(cfg))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    state = init(llama.LlamaModel(cfg, device="meta",
                                  store_dtype=cfg.param_dtype, mesh=mesh),
                 init_weights=lambda m: init_params_(m, gen))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    shards = sizes["dp"] * sizes["fsdp"]
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (shards, spec["seq"])))
    rows = sp_local_batch(mesh, tokens)
    for kernel in fa.LAUNCHES:
        fa.LAUNCHES[kernel] = 0
    losses, stamps = [], []
    dist.barrier()
    init_s = time.perf_counter() - t0
    for _ in range(SP_STEPS):
        state, metrics = step(state, rows)
        losses.append(metrics["loss"].item())     # waits for the step
        stamps.append(time.perf_counter())
    launches = dict(fa.LAUNCHES)
    step_s = (stamps[-1] - stamps[0]) / (len(stamps) - 1)
    out = {"preset": spec["preset"], "n_layers": cfg.n_layers,
           "mesh": sizes, "tokens_per_batch_shard": spec["seq"],
           "tokens_per_rank": rows.numel(), "init_s": init_s,
           "losses": losses, "step_ms": step_s * 1e3,
           "each_step_ms": [(b - a) * 1e3 for a, b in zip(stamps,
                                                          stamps[1:])],
           "tokens_per_s_per_card": shards * spec["seq"] / step_s / world,
           "train_mfu": shards * train_flops(cfg, 1, spec["seq"]) / step_s
           / (world * PEAK_OPS[torch.bfloat16]),
           "launches": launches, "sp_rank": state.model.sp.rank,
           "ep_rank": state.model.ep.rank, "remat": cfg.remat}
    if cfg.n_experts > 1:
        experts = torch.arange(cfg.n_experts, device=rows.device)
        hits = sum((layer.feed_forward.last_routing[0][..., None]
                    == experts).sum((0, 1)) for layer in state.model.layers)
        out["routed_share"] = (hits / hits.sum()).tolist()
    out["alloc_retries"] = torch.cuda.memory_stats().get(
        "num_alloc_retries", 0)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del state, metrics
    gc.collect()
    if cfg.n_experts <= 1:
        torch.cuda.empty_cache()
        out.update(ring_timing(mesh, cfg, rows.shape[1]))
        out["ring_share_of_step"] = \
            cfg.n_layers * out["ring_fwd_bwd_ms"] / out["step_ms"]
    return out


def sp_rank(out_dir: str) -> int:
    """A child of phase 11: (b) and (c), twice each, then (a), parity,
    planted faults and the re-shard, in the same process (the meshes are
    made once, ``sp_mesh``).  (c) runs near the card's memory, so it
    runs before (a)'s groups hold NCCL buffers on the card (after them,
    on four H100 80GB HBM3 at 700 W, its steps took 5.9 s against 0.63
    with allocator retries)."""
    import faulthandler

    import torch.distributed as dist

    # Every thread's stack lands in the rank's log before its deadline.
    faulthandler.dump_traceback_later(SP_DEADLINE_S - 30, exit=False)
    rank, world = sp_group()
    result = {"rank": rank, "world": world, "backend": dist.get_backend(),
              "card": torch.cuda.current_device(), "seconds": {}}
    t0 = time.perf_counter()

    def done(what):
        nonlocal t0
        result["seconds"][what] = time.perf_counter() - t0
        t0 = time.perf_counter()
        print(f"sp rank {rank}: {what} done", flush=True)

    path = os.path.join(out_dir, f"sp_rank{rank}.json")
    result["full_width"] = {}
    for spec in sp_full_configs(world):
        mesh = sp_mesh(**spec["mesh"])
        result["full_width"][spec["preset"]] = [
            sp_full_width_run(world, spec, mesh) for _ in range(2)]
        done(f"{'(c)' if spec['preset'].startswith('mixtral') else '(b)'}"
             f" {spec['preset']}")
        with open(path, "w") as f:             # what is done so far
            json.dump(result, f)
    gc.collect()
    torch.cuda.empty_cache()
    kinds = ["sp", "ep"] + (["fsdp_sp", "fsdp_ep"] if world >= 4 else [])
    runs = {}
    for kind in kinds:
        runs[kind] = sp_parity_run(world, kind, fault=False)
        runs[kind + "_fault"] = sp_parity_run(world, kind, fault=True)
        done(f"(a) {kind}")
    result["parity_metrics"] = {k: v[0] for k, v in runs.items()}
    reshard = sp_reshard_run(world)
    done("(a) reshard")
    if rank == 0:
        torch.save({"parity": {k: v[1] for k, v in runs.items()},
                    "reshard": reshard},
                   os.path.join(out_dir, "sp_tensors.pt"))
    with open(path, "w") as f:
        json.dump(result, f)
    dist.barrier()
    # No destroy_process_group: these ranks hold sub-meshes over part of
    # the group and point-to-point communicators, whose shutdown is not
    # needed to end the process.
    sys.stdout.flush()
    os._exit(0)


def sp_phase(card: str):
    """Phase 11: one process per card (4 or 2), NCCL.  (a) parity of
    llama2_tiny over sp (the ring on K1'-K3') and mixtral_tiny over ep
    against card 0 alone, each with a planted fault, and the live
    re-shard grown and shrunk; (b) llama2_7b at full width round the
    ring; (c) mixtral_8x7b at full width over ep."""
    import tempfile
    world = sp_world()
    if world < 2:
        print("sequence/expert parallel: phase 11 needs two cards; this "
              "machine shows one", flush=True)
        return {}
    out_dir = tempfile.mkdtemp(prefix="chip-smoke-sp-")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"sequence/expert parallel: world {world} (one process per "
          f"card); {card}", flush=True)
    refs = {preset: dist_parity_reference(world, preset)
            for preset in ("llama2_tiny", "mixtral_tiny")}
    gc.collect()
    torch.cuda.empty_cache()
    run_ranks([sys.executable, os.path.abspath(__file__), "sp-rank",
               out_dir], world, "sequence/expert parallel", SP_DEADLINE_S,
              out_dir)
    return sp_verdict(card, world, out_dir, refs)


def sp_verdict(card: str, world: int, out_dir: str, refs):
    """Phase 11's checks and printed results, from the ranks' files in
    ``out_dir`` and the one-card references."""
    ranks = [json.load(open(os.path.join(out_dir, f"sp_rank{r}.json")))
             for r in range(world)]
    tensors = torch.load(os.path.join(out_dir, "sp_tensors.pt"))
    if any(r["world"] != world or r["backend"] != "nccl"
           or r["card"] != r["rank"] for r in ranks):
        raise SystemExit(f"sequence/expert parallel: ranks formed {ranks}")

    # (a) parity, faults, the re-shard.
    verdict = {}
    for name, params in tensors["parity"].items():
        ref_metrics, ref_params, smallest = refs[
            "mixtral_tiny" if "ep" in name else "llama2_tiny"]
        verdict[name] = [f for r in ranks for f in dist_parity_failures(
            r["parity_metrics"][name], params, ref_metrics, ref_params,
            smallest)]
    if any(v for k, v in verdict.items() if not k.endswith("_fault")) or \
            not all(v for k, v in verdict.items() if k.endswith("_fault")):
        raise SystemExit(f"sequence/expert parallel (a) parity: {verdict}")
    reshard = tensors["reshard"]
    straight = reshard["straight"][0]
    moved = {}
    for name in ("grow", "shrink"):
        params, equal = reshard[name]
        err = max(((params[n] - p).abs() / (1 + p.abs())).max().item()
                  for n, p in straight.items())
        moved[name] = {"max_rel_err_vs_straight": err, "moved_bit_equal":
                       equal}
        if not (err <= DIST_STEP_TOL and equal):
            raise SystemExit(f"sequence/expert parallel (a) reshard {name}:"
                             f" {moved[name]}")
    print("sequence/expert parallel (a) parity: " + json.dumps({
        "card": card, "world": world,
        "held_at": DIST_STEP_TOL, "steps": DIST_PARITY_STEPS,
        "runs": [k for k in verdict if not k.endswith("_fault")],
        "planted_faults_caught": {k: v[:2] for k, v in verdict.items()
                                  if k.endswith("_fault")},
        "reshard_at_step": f"{SP_RESHARD_AT} of {SP_RESHARD_STEPS}",
        "reshard": moved}), flush=True)

    # (b) and (c).
    result = {"world": world}
    for spec in sp_full_configs(world):
        stats = []
        for r in ranks:
            first, again = r["full_width"][spec["preset"]]
            moe = spec["preset"].startswith("mixtral")
            per_layer = 1 if moe else first["sp_rank"] + 1
            want = {"flash_fwd": SP_STEPS * first["n_layers"] * per_layer
                    * (2 if first["remat"] else 1),
                    "flash_bwd_dq": SP_STEPS * first["n_layers"] * per_layer,
                    "flash_bwd_dkv": SP_STEPS * first["n_layers"]
                    * per_layer}
            if first["launches"] != want or \
                    not all(np.isfinite(first["losses"])) or \
                    not first["peak_bytes"] < 80e9 or \
                    again["losses"] != first["losses"] or \
                    (moe and min(first["routed_share"]) <= 0):
                raise SystemExit(
                    f"sequence/expert parallel {spec['preset']} rank "
                    f"{r['rank']}: launches {first['launches']} (want "
                    f"{want}), {first} / repeat {again['losses']}")
            stats.append({**first, "rank": r["rank"],
                          "launches_want": want,
                          "losses_repeat": again["losses"],
                          "repeat_step_ms": again["step_ms"]})
        label = "(c)" if spec["preset"].startswith("mixtral") else "(b)"
        print(f"sequence/expert parallel {label} {spec['preset']} full "
              f"width, {spec['layers']} of 32 layers, "
              f"{' x '.join(f'{a}={n}' for a, n in spec['mesh'].items())}, "
              f"1 x {spec['seq']} tokens a batch shard: "
              + json.dumps({"card": card, "world": world,
                            "remat": spec["remat"], "ranks": stats}),
              flush=True)
        result[spec["preset"]] = {f"rank{s['rank']}": s["launches"]
                                  for s in stats}
    print("sequence/expert parallel parts (seconds, rank 0): "
          + json.dumps(ranks[0]["seconds"]), flush=True)
    return result


# -- phase 12: pipeline parallel ----------------------------------------------

PP_DEADLINE_S = 900
PP_STEPS = 4                      # one warm-up + 3 timed
PP_CHECK_STEPS = 3                # the run held to phase 7 (c)'s losses
PP_MICRO = 8                      # (b), (c): M microbatches of 1 x 4096
PP_LAYERS_PER_CARD = 4            # (b): 16 of the 7B's 32 layers at pp = 4
PP_PARITY_LAYERS = 4              # (a), (d): tiny, deep enough for pp = 4
PP_PARITY_M = 4
PP_LOSS_RTOL = 2e-5               # tests/test_pipeline.py:367
PP_GRAD_RTOL, PP_GRAD_ATOL = 2e-4, 2e-5   # tests/test_pipeline.py:378
PP_CHECK_FIRST, PP_CHECK_NEXT = 1e-4, 1e-3   # against phase 7 (c)
PP_B_COST = 3.0                   # a B slot: the recompute and the backward
PP_MOE_PRESET = "mixtral_8x7b"    # (c)
PP_MOE_LAYERS = 8                 # (c): of 32; 2 a stage, ~48 GB of state
PP_RESHARD_AT = 2                 # (d): the move, before step 2 of
PP_RESHARD_STEPS = 4
PP_RESHARD_TOL = 1e-5             # (d): losses against the straight run


def pp_world() -> int:
    """Ranks of phase 12: 4 or 2 (one card runs none)."""
    cards = torch.cuda.device_count()
    return 4 if cards >= 4 else (2 if cards >= 2 else 1)


def pp_parity_kinds(world: int):
    """(a)'s runs on llama2_tiny and (d)'s on mixtral_tiny: name ->
    (preset, mesh axes, schedule, virtual stages, pp_fsdp).  Each
    preset's planted fault runs on ``pp_fault_kinds``' kind."""
    if world >= 4:
        return {"gpipe_pp4": ("llama2_tiny", dict(pp=4), "gpipe", 1, False),
                "1f1b_pp4": ("llama2_tiny", dict(pp=4), "1f1b", 1, False),
                "1f1b_dp2_pp2": ("llama2_tiny", dict(dp=2, pp=2), "1f1b", 1,
                                 False),
                "interleaved_fsdp2_pp2": ("llama2_tiny", dict(fsdp=2, pp=2),
                                          "1f1b", 2, True),
                "moe_1f1b_pp4": ("mixtral_tiny", dict(pp=4), "1f1b", 1,
                                 False),
                "moe_1f1b_dp2_pp2": ("mixtral_tiny", dict(dp=2, pp=2),
                                     "1f1b", 1, False),
                "moe_1f1b_fsdp2_pp2": ("mixtral_tiny", dict(fsdp=2, pp=2),
                                       "1f1b", 1, True)}
    return {"gpipe_pp2": ("llama2_tiny", dict(pp=2), "gpipe", 1, False),
            "1f1b_pp2": ("llama2_tiny", dict(pp=2), "1f1b", 1, False),
            "moe_1f1b_pp2": ("mixtral_tiny", dict(pp=2), "1f1b", 1, False)}


def pp_fault_kinds(world: int):
    """The planted faults: (a)'s wrong ring slot on the first 1F1B kind,
    (d)'s capacity fault on the MoE kind with two batch shards (at two
    cards: the MoE kind)."""
    kinds = pp_parity_kinds(world)
    return {next(k for k, v in kinds.items()
                 if v[0] == "llama2_tiny" and v[2] == "1f1b"): "wrong_slot",
            ("moe_1f1b_dp2_pp2" if world >= 4 else "moe_1f1b_pp2"):
            "capacity"}


_PP_MESHES = {}


def pp_mesh(**axes):
    """Phase 12's mesh over these axes (dp 1 unless named), made once per
    process: each DeviceMesh forms communicators of its own."""
    from mpi_operator_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    key = tuple(sorted(axes.items()))
    if key not in _PP_MESHES:
        _PP_MESHES[key] = create_mesh(MeshConfig(**{"dp": 1, **axes}),
                                      "cuda")
    return _PP_MESHES[key]


def table_bubble(fwd, bwd, n_stages: int, n_virtual: int, n_micro: int,
                 b_cost: float = PP_B_COST, lockstep: bool = False) -> float:
    """The idle share a schedule's tables imply: each rank runs its slots
    in the tables' order, an F slot of chunk work 1/V and a B slot of
    b_cost/V, each after its input (the F of the stage before; the B of
    the stage after, or the last stage's own F); 1 - busy / makespan.
    For the 1F1B tables this is (P-1)/(M+P-1) whatever b_cost is.
    ``lockstep``: every tick lasts as long as its busiest rank's slots,
    as when each tick ends in an exchange that waits for the neighbours
    (JAX's shard_map body, and the port's tick loop)."""
    P, V, M = n_stages, n_virtual, n_micro
    if lockstep:
        span = sum(max(float(fwd[p][t] >= 0) / V
                       + float(bwd[p][t] >= 0) * b_cost / V
                       for p in range(P)) for t in range(fwd.shape[1]))
        return 1 - M * (1 + b_cost) / span
    end, free = {}, [0.0] * P
    for t in range(fwd.shape[1]):
        for kind, table in (("f", fwd), ("b", bwd)):
            for p in range(P):
                e = int(table[p][t])
                if e < 0:
                    continue
                v, m = divmod(e, M)
                s = v * P + p
                if kind == "f":
                    dep, cost = end.get(("f", s - 1, m), 0.0), 1.0 / V
                else:
                    dep = end[("b", s + 1, m)] if s < P * V - 1 else \
                        end[("f", s, m)]
                    cost = b_cost / V
                start = max(free[p], dep)
                end[(kind, s, m)] = free[p] = start + cost
    return 1 - M * (1 + b_cost) / max(free)


def _wrong_slot(tick_ops):
    """Phase 12 (a)'s planted fault: this rank files every received
    activation under the next microbatch's ring slot."""
    def planted(*args, **kwargs):
        return [op._replace(micro=op.micro + 1)
                if not op.send and op.kind == "f" else op
                for op in tick_ops(*args, **kwargs)]
    return planted


def _capacity_fault(stage, mesh) -> None:
    """Phase 12 (d)'s planted fault: the MoE layers of this stage count
    their capacity over the rows of every batch shard's microbatch (with
    one batch shard: over every microbatch), not over the rows of one
    microbatch of their own shard, as the JAX stages do."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    shards = sizes["dp"] * sizes["fsdp"]
    for block in stage.layers.values():
        block.feed_forward.capacity_factor *= \
            shards if shards > 1 else PP_PARITY_M


def pp_parity_run(world: int, spec, fault=None):
    """Phase 12 (a) or (d), one rank: ``spec``'s tiny f32 model at
    PP_PARITY_LAYERS layers on its mesh and schedule: the (loss,
    gradients) of one pass, joined into the one-device layout, then
    DIST_PARITY_STEPS AdamW steps of build_train_step and the joined
    weights after.  ``fault``: "wrong_slot" (rank 1 files received
    activations under the wrong ring slot) or "capacity" (pp stage 1's
    MoE layers count their capacity over too many rows)."""
    import torch.distributed as dist

    from mpi_operator_tpu_torch.models.llama_pipeline import (
        LlamaStage, pipeline_loss, pipeline_loss_and_grads_1f1b)
    from mpi_operator_tpu_torch.models.params import gather_stage_state_dict
    from mpi_operator_tpu_torch.parallel import pipeline
    from mpi_operator_tpu_torch.parallel.train import adamw, build_train_step

    preset, axes, schedule, virtual, pp_fsdp = spec
    cfg, weights, tokens = dist_parity_inputs(world, preset,
                                              n_layers=PP_PARITY_LAYERS)
    mesh = pp_mesh(**axes)
    rows = _rows_on(mesh, tokens)

    def stage():
        s = LlamaStage(cfg, mesh=mesh, virtual_stages=virtual,
                       fsdp_shard=pp_fsdp, device="cuda",
                       store_dtype=torch.float32)
        s.load_full_state_dict(weights)
        if fault == "capacity" and mesh.get_local_rank("pp") == 1:
            _capacity_fault(s, mesh)
        return s

    real = pipeline.tick_ops
    if fault == "wrong_slot" and dist.get_rank() == 1:
        pipeline.tick_ops = _wrong_slot(real)
    try:
        one = stage()
        if schedule == "1f1b":
            loss, grads = pipeline_loss_and_grads_1f1b(
                one, rows, mesh, PP_PARITY_M, virtual_stages=virtual,
                fsdp_shard=pp_fsdp)
        else:                            # dp = fsdp = 1: nothing to reduce
            loss = pipeline_loss(one, rows, mesh, PP_PARITY_M)
            loss.backward()
            grads = {n: p.grad for n, p in one.named_parameters()}
        grads = gather_stage_state_dict(one, grads)
        init, step = build_train_step(
            None, adamw(DIST_LR), mesh=mesh, pipeline_schedule=schedule,
            microbatches=PP_PARITY_M, virtual_stages=virtual,
            pp_fsdp=pp_fsdp)
        state = init(stage())
        metrics = []
        for _ in range(DIST_PARITY_STEPS):
            state, m = step(state, rows)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        params = gather_stage_state_dict(state.model)
    finally:
        pipeline.tick_ops = real
    return ({"loss": loss.item(), "metrics": metrics},
            {"grads": grads, "params": params})


def pp_reshard_targets(world: int):
    """(d)'s moves of a pp = world 1F1B state: name -> (mesh axes,
    pp_fsdp)."""
    if world >= 4:
        return {"fsdp2_pp2": (dict(fsdp=2, pp=world // 2), True),
                f"dp{world}": (dict(dp=world), False)}
    return {f"dp{world}": (dict(dp=world), False)}


def pp_reshard_run(world: int):
    """Phase 12 (d), the re-shard of a pipeline: llama2_tiny f32 at
    PP_PARITY_LAYERS layers, a 1F1B state at pp = world, PP_RESHARD_STEPS
    steps straight, and moved before step PP_RESHARD_AT onto each of
    ``pp_reshard_targets`` (every rank takes part in each move).
    Returns, on rank 0: each run's losses and, for each move, whether
    the moved state_dict equals the one before the move, bit for bit,
    and the plan that took it."""
    import torch.distributed as dist

    from mpi_operator_tpu_torch.models.llama_pipeline import LlamaStage
    from mpi_operator_tpu_torch.parallel.train import (adamw,
                                                       build_train_step,
                                                       reshard_train_state)

    cfg, weights, tokens = dist_parity_inputs(world,
                                              n_layers=PP_PARITY_LAYERS)
    start = pp_mesh(pp=world)

    def build(axes, pp_fsdp):
        mesh = pp_mesh(**axes)
        if axes.get("pp", 1) > 1:
            return mesh, build_train_step(
                None, adamw(DIST_LR), mesh=mesh, pipeline_schedule="1f1b",
                microbatches=PP_PARITY_M, pp_fsdp=pp_fsdp)
        return mesh, build_train_step(dist_loss, adamw(DIST_LR), mesh=mesh)

    def run(target):
        init, step = build(dict(pp=world), False)[1]
        stage = LlamaStage(cfg, mesh=start, device="cuda",
                           store_dtype=torch.float32)
        stage.load_full_state_dict(weights)
        state, mesh, losses, moved = init(stage), start, [], None
        for i in range(PP_RESHARD_STEPS):
            if i == PP_RESHARD_AT and target is not None:
                axes, pp_fsdp = target
                before = state.state_dict()
                mesh, (_, step) = build(axes, pp_fsdp)
                state = reshard_train_state(
                    state, mesh, pipeline_schedule="1f1b",
                    microbatches=PP_PARITY_M, pp_fsdp=pp_fsdp)
                after = state.state_dict()
                if dist.get_rank() == 0:
                    moved = {"equal": state.step == PP_RESHARD_AT
                             and state_dicts_equal(before, after),
                             "plan": type(state.plan).__name__}
            state, m = step(state, _rows_on(mesh, tokens))
            losses.append(m["loss"].item())
        return {"losses": losses, "moved": moved}

    out = {"straight": run(None)}
    for name, target in pp_reshard_targets(world).items():
        out[name] = run(target)
    return out if dist.get_rank() == 0 else None


def _rows_on(mesh, tokens):
    """This rank's rows of the global batch, on its card."""
    from mpi_operator_tpu_torch.parallel.mesh import batch_rows
    return tokens[batch_rows(tuple(mesh.shape), mesh.get_coordinate(),
                             len(tokens))].cuda()


def pp_full_width_run(world: int, virtual: int, n_micro: int, tokens,
                      steps: int, preset: str = "llama2_7b",
                      n_layers: int = 0):
    """Phase 12 (b) or (c), one rank: ``preset`` at full width and
    ``n_layers`` layers (default: PP_LAYERS_PER_CARD a card), pp =
    world, the 1F1B schedule (interleaved at ``virtual`` > 1) over
    ``n_micro`` microbatches of the rows of ``tokens`` (every stage takes
    them all), f32 weights and AdamW state, bf16 compute; the stage is
    built on the meta device and filled with init_params' draws for SEED.
    Per step: host ms between synchronised steps, and the F and B slots'
    device ms (CUDA events) for the pipeline's idle share; for MoE the
    routed share of each expert over the stage's layers' last
    forward."""
    import torch.distributed as dist

    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.models.llama_pipeline import LlamaStage
    from mpi_operator_tpu_torch.models.params import init_params_
    from mpi_operator_tpu_torch.ops import attention as fa
    from mpi_operator_tpu_torch.parallel import pipeline
    from mpi_operator_tpu_torch.parallel.train import adamw, build_train_step

    cfg = dataclasses.replace(getattr(llama, preset)(),
                              n_layers=n_layers or PP_LAYERS_PER_CARD * world)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = pp_mesh(pp=world)
    init, step = build_train_step(None, adamw(3e-4), mesh=mesh,
                                  pipeline_schedule="1f1b",
                                  microbatches=n_micro,
                                  virtual_stages=virtual)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    state = init(LlamaStage(cfg, mesh=mesh, virtual_stages=virtual,
                            device="meta", store_dtype=cfg.param_dtype),
                 init_weights=lambda m: init_params_(m, gen))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    local_params = sum(p.numel() for p in state.model.parameters())
    rows = torch.as_tensor(tokens, device="cuda")
    for kernel in fa.LAUNCHES:
        fa.LAUNCHES[kernel] = 0
    losses, stamps, busy = [], [], []
    pipeline.SLOT_EVENTS = []
    dist.barrier()
    stamps.append(time.perf_counter())
    try:
        for _ in range(steps):
            del pipeline.SLOT_EVENTS[:]
            state, metrics = step(state, rows)
            losses.append(metrics["loss"].item())     # waits for the step
            stamps.append(time.perf_counter())
            busy.append(sum(a.elapsed_time(b)
                            for _, a, b in pipeline.SLOT_EVENTS))
    finally:
        pipeline.SLOT_EVENTS = None
    launches = dict(fa.LAUNCHES)
    each = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    step_ms = (stamps[-1] - stamps[1]) * 1e3 / (steps - 1)
    fwd, bwd, n_ticks, *_ = pipeline.schedule(world, n_micro, virtual)
    out = {"preset": preset, "n_layers": cfg.n_layers, "pp": world,
           "virtual_stages": virtual,
           "microbatches": n_micro, "tokens_per_step": rows.numel(),
           "stage": state.model.stage, "layers": state.model.layer_ids,
           "local_params": local_params, "init_s": init_s,
           "losses": losses, "step_ms": step_ms, "each_step_ms": each,
           "tokens_per_s_per_card": rows.numel() / (step_ms / 1e3) / world,
           "train_mfu": train_flops(cfg, rows.shape[0], rows.shape[1])
           / (step_ms / 1e3) / (world * PEAK_OPS[torch.bfloat16]),
           "train_flops_per_step": train_flops(cfg, rows.shape[0],
                                               rows.shape[1]),
           "busy_ms": busy,
           "idle_share": [1 - b / s for b, s in zip(busy[1:], each[1:])],
           "schedule_bubble": table_bubble(fwd, bwd, world, virtual,
                                           n_micro),
           "schedule_bubble_lockstep": table_bubble(
               fwd, bwd, world, virtual, n_micro, lockstep=True),
           "schedule_ticks": n_ticks, "launches": launches,
           "alloc_retries": torch.cuda.memory_stats().get(
               "num_alloc_retries", 0),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    if cfg.n_experts > 1:
        experts = torch.arange(cfg.n_experts, device=rows.device)
        hits = sum((block.feed_forward.last_routing[0][..., None]
                    == experts).sum((0, 1))
                   for block in state.model.layers.values())
        out["routed_share"] = (hits / hits.sum()).tolist()
    if virtual == 1:
        out["bubble_formula"] = (world - 1) / (n_micro + world - 1)
    del state, metrics
    gc.collect()
    return out


def pp_rank(out_dir: str) -> int:
    """A child of phase 12: (a) and (d) (parity, the planted faults, the
    re-shard of a pipeline state), then in the same process, on the
    communicators and the warm card these leave, (b), the 7B under 1F1B
    and interleaved 1F1B, each twice, and the run on phase 7 (c)'s
    weights and batch, then (c), mixtral_8x7b under 1F1B, twice.  Each
    part's seconds are kept."""
    import faulthandler

    import torch.distributed as dist

    faulthandler.dump_traceback_later(PP_DEADLINE_S - 30, exit=False)
    rank, world = sp_group()
    result = {"rank": rank, "world": world, "backend": dist.get_backend(),
              "card": torch.cuda.current_device(), "seconds": {}}
    path = os.path.join(out_dir, f"pp_rank{rank}.json")

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        result["seconds"][name] = time.perf_counter() - t0
        print(f"pp rank {rank}: {name} done", flush=True)
        return out

    kinds, faults = pp_parity_kinds(world), pp_fault_kinds(world)
    runs = {}
    for name, spec in kinds.items():
        label = "(d) moe parity" if spec[0] == "mixtral_tiny" else \
            "(a) parity"
        runs[name] = timed(f"{label} {name}", pp_parity_run, world, spec)
        if name in faults:
            runs[name + "_fault"] = timed(
                f"{label} {name} fault", pp_parity_run, world, spec,
                faults[name])
    result["parity"] = {k: v[0] for k, v in runs.items()}
    reshard = timed("(d) reshard", pp_reshard_run, world)
    if rank == 0:
        torch.save({"runs": {k: v[1] for k, v in runs.items()},
                    "reshard": reshard},
                   os.path.join(out_dir, "pp_tensors.pt"))
    del runs, reshard
    gc.collect()

    seq = 4096
    tokens = np.random.default_rng(SEED).integers(0, 32000, (PP_MICRO, seq))
    result["full_width"] = {}
    for name, virtual in (("1f1b", 1), ("interleaved", 2)):
        result["full_width"][name] = [
            timed(f"(b) {name} run {i}", pp_full_width_run, world,
                  virtual, PP_MICRO, tokens, PP_STEPS)
            for i in range(2)]
        with open(path, "w") as f:             # what is done so far
            json.dump(result, f)
    # Phase 7 (c)'s global batch: one row a card, as M = world.
    check = np.random.default_rng(SEED).integers(0, 32000, (world, seq))
    result["phase7_check"] = timed(
        "(b) phase 7 (c) check", pp_full_width_run, world, 1, world,
        check, PP_CHECK_STEPS, "llama2_7b", DIST_LAYERS_PER_CARD * world)
    result["full_width"]["moe_1f1b"] = [
        timed(f"(c) {PP_MOE_PRESET} run {i}", pp_full_width_run, world,
              1, PP_MICRO, tokens, PP_STEPS, PP_MOE_PRESET, PP_MOE_LAYERS)
        for i in range(2)]
    with open(path, "w") as f:
        json.dump(result, f)
    dist.barrier()
    # As phase 11: sub-meshes and point-to-point communicators need no
    # shutdown to end the process.
    sys.stdout.flush()
    os._exit(0)


def pp_phase(card: str, phase7_losses):
    """Phase 12: one process per card (4 or 2), NCCL.  (a) parity of
    llama2_tiny through GPipe, 1F1B and interleaved 1F1B against card 0
    alone, with a planted fault; (b) llama2_7b at full width under 1F1B
    and interleaved 1F1B, and held to phase 7 (c)'s losses on its
    weights and batch; (c) mixtral_8x7b at full width under 1F1B; (d) mixtral_tiny's
    parity against card 0 with a planted capacity fault, and the
    re-shard of a 1F1B state."""
    import tempfile
    world = pp_world()
    if world < 2:
        print("pipeline parallel: phase 12 needs two cards; this machine "
              "shows one", flush=True)
        return {}
    out_dir = tempfile.mkdtemp(prefix="chip-smoke-pp-")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"pipeline parallel: world {world} (one process per card); "
          f"{card}", flush=True)
    refs = pp_references(world)
    gc.collect()
    torch.cuda.empty_cache()
    run_ranks([sys.executable, os.path.abspath(__file__), "pp-rank",
               out_dir], world, "pipeline parallel", PP_DEADLINE_S, out_dir)
    return pp_verdict(card, world, out_dir, refs, phase7_losses)


def pp_chunk_loss(rows: int):
    """The loss of a pipeline whose microbatches of each batch shard hold
    ``rows`` rows, on one card: the mean over the global batch's chunks
    of ``rows`` rows of each chunk's loss.  The model's MoE layers then
    count their capacity over each chunk, as a pipeline stage's over one
    microbatch of its shard."""
    def loss(model, batch):
        chunks = batch.split(rows)
        return sum(dist_loss(model, c) for c in chunks) / len(chunks)
    return loss


def pp_references(world: int):
    """Card 0 alone on (a)'s and (d)'s weights and global batch, per
    preset and (for MoE) per microbatch size: the loss and gradients of
    one pass and DIST_PARITY_STEPS AdamW steps.  The dense loss is the
    sequential model's; the MoE loss the mean over the chunks each
    pipeline microbatch holds (``pp_chunk_loss``)."""
    from mpi_operator_tpu_torch.models.llama import LlamaModel
    refs, done = {}, {}
    for name, (preset, axes, *_) in pp_parity_kinds(world).items():
        moe = preset == "mixtral_tiny"
        cfg, weights, tokens = dist_parity_inputs(world, preset,
                                                  n_layers=PP_PARITY_LAYERS)
        shards = axes.get("dp", 1) * axes.get("fsdp", 1)
        rows = len(tokens) // shards // PP_PARITY_M if moe else 0
        if (preset, rows) not in done:
            loss_fn = pp_chunk_loss(rows) if moe else dist_loss
            model = LlamaModel(cfg, device="cuda",
                               store_dtype=torch.float32)
            model.load_state_dict(weights)
            loss = loss_fn(model, tokens.to("cuda"))
            loss.backward()
            grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
            del model
            done[(preset, rows)] = {
                "loss": loss.item(), "grads": grads,
                "steps": dist_parity_reference(world, preset,
                                               PP_PARITY_LAYERS, loss_fn)}
        refs[name] = done[(preset, rows)]
    return refs


def pp_grad_failures(loss, grads, ref_loss, ref_grads):
    """What in one pass differs from the one-card reference beyond the
    JAX tests' bounds."""
    bad = []
    if abs(loss - ref_loss) > PP_LOSS_RTOL * abs(ref_loss):
        bad.append(f"loss {loss} vs {ref_loss}")
    for name, want in ref_grads.items():
        err = (grads[name] - want).abs()
        if (err > PP_GRAD_ATOL + PP_GRAD_RTOL * want.abs()).any():
            bad.append(f"grad {name} max err {err.max().item():.3g}")
    return bad


def pp_full_width_verdict(card: str, world: int, ranks, name: str,
                          label: str):
    """(b) or (c)'s checks on every rank and its printed line: launches
    exact (K1' 2 x M x layers a stage a step, K2' and K3' M x layers a
    stage), finite and bit-identical losses over the two runs, peak
    below 80 GB, and for MoE every expert routed on every stage."""
    stats = []
    for r in ranks:
        first, again = r["full_width"][name]
        per = PP_MICRO * first["n_layers"] // world
        want = {"flash_fwd": 2 * per * PP_STEPS,
                "flash_bwd_dq": per * PP_STEPS,
                "flash_bwd_dkv": per * PP_STEPS}
        if first["launches"] != want or \
                not all(np.isfinite(first["losses"])) or \
                not first["peak_bytes"] < 80e9 or \
                again["losses"] != first["losses"] or \
                min(first.get("routed_share", [1])) <= 0:
            raise SystemExit(
                f"pipeline parallel {label} rank {r['rank']}: launches "
                f"{first['launches']} (want {want}), {first} / repeat "
                f"{again['losses']}")
        stats.append({**first, "rank": r["rank"], "launches_want": want,
                      "losses_repeat": again["losses"],
                      "repeat_step_ms": again["step_ms"]})
    s = stats[0]
    print(f"pipeline parallel {label} {s['preset']} full width, "
          f"{s['n_layers']} of 32 layers, pp={world}, {name} "
          f"(V={s['virtual_stages']}), M={PP_MICRO} x 1 x 4096 tokens: "
          + json.dumps({"card": card, "world": world, "ranks": stats}),
          flush=True)
    return {f"rank{s['rank']}": s["launches"] for s in stats}


def pp_verdict(card: str, world: int, out_dir: str, refs, phase7_losses):
    """Phase 12's checks and printed results."""
    ranks = [json.load(open(os.path.join(out_dir, f"pp_rank{r}.json")))
             for r in range(world)]
    if any(r["world"] != world or r["backend"] != "nccl"
           or r["card"] != r["rank"] for r in ranks):
        raise SystemExit(f"pipeline parallel: ranks formed {ranks}")
    pp_parity_verdict(card, world, ranks, out_dir, refs)

    # (b) and (c) full width.
    result = {"world": world}
    for name in ("1f1b", "interleaved"):
        result[name] = pp_full_width_verdict(card, world, ranks, name, "(b)")
    result["moe_1f1b"] = pp_full_width_verdict(card, world, ranks,
                                               "moe_1f1b", "(c)")

    # Held to phase 7 (c) on its weights and its global batch.
    check = [r["phase7_check"] for r in ranks]
    losses = check[0]["losses"]
    diffs = [abs(a - b) / abs(b) for a, b in zip(losses, phase7_losses)]
    if any(c["losses"] != losses for c in check) or \
            not diffs[0] <= PP_CHECK_FIRST or \
            not all(d <= PP_CHECK_NEXT for d in diffs[1:PP_CHECK_STEPS]):
        raise SystemExit(f"pipeline parallel (b) against phase 7 (c): "
                         f"{losses} vs {phase7_losses} ({diffs})")
    print("pipeline parallel (b) against phase 7 (c): " + json.dumps({
        "card": card, "world": world, "n_layers": check[0]["n_layers"],
        "microbatches": world, "losses": losses,
        "phase7_losses": phase7_losses[:PP_CHECK_STEPS],
        "rel_diff": diffs, "limits": [PP_CHECK_FIRST, PP_CHECK_NEXT],
        "step_ms": [c["step_ms"] for c in check],
        "peak_bytes": [c["peak_bytes"] for c in check]}), flush=True)
    print("pipeline parallel parts (seconds, rank 0): "
          + json.dumps(ranks[0]["seconds"]), flush=True)
    return result


def pp_parity_verdict(card: str, world: int, ranks, out_dir: str, refs):
    """(a) and (d)'s checks and printed results: parity of every run
    against card 0, each planted fault caught, and the re-shard."""
    tensors = torch.load(os.path.join(out_dir, "pp_tensors.pt"))
    verdict = {}
    for name, t in tensors["runs"].items():
        ref = refs[name.removesuffix("_fault")]
        ref_metrics, ref_params, smallest = ref["steps"]
        # The joined gradients and weights are rank 0's (every rank holds
        # the same); each rank's loss and metrics are its own.
        verdict[name] = pp_grad_failures(
            ranks[0]["parity"][name]["loss"], t["grads"], ref["loss"],
            ref["grads"]) + [f for r in ranks for f in dist_parity_failures(
                r["parity"][name]["metrics"], t["params"], ref_metrics,
                ref_params, smallest)] + [
            f"rank {r['rank']} loss {r['parity'][name]['loss']}"
            for r in ranks if r["parity"][name]["loss"]
            != ranks[0]["parity"][name]["loss"]]
    if any(v for k, v in verdict.items() if not k.endswith("_fault")) or \
            not all(v for k, v in verdict.items() if k.endswith("_fault")):
        raise SystemExit(f"pipeline parallel (a)/(d) parity: {verdict}")
    for label, moe in (("(a)", False), ("(d)", True)):
        names = [k for k in verdict if k.startswith("moe_") == moe]
        print(f"pipeline parallel {label} parity: " + json.dumps({
            "card": card, "world": world, "layers": PP_PARITY_LAYERS,
            "preset": "mixtral_tiny" if moe else "llama2_tiny",
            "microbatches": PP_PARITY_M,
            "held_at": {"loss_rtol": PP_LOSS_RTOL,
                        "grad_rtol": PP_GRAD_RTOL,
                        "grad_atol": PP_GRAD_ATOL, "steps": DIST_STEP_TOL},
            "runs": [k for k in names if not k.endswith("_fault")],
            "loss_rel_err": {
                k: abs(ranks[0]["parity"][k]["loss"]
                       - refs[k.removesuffix("_fault")]["loss"])
                / abs(refs[k.removesuffix("_fault")]["loss"])
                for k in names},
            "planted_faults_caught": {k: verdict[k][:2] for k in names
                                      if k.endswith("_fault")}}),
            flush=True)
    reshard = tensors["reshard"]
    straight = reshard["straight"]["losses"]
    moves = {}
    for name in pp_reshard_targets(world):
        run = reshard[name]
        err = max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                      straight))
        moves[name] = {"losses": run["losses"], "max_rel_err": err,
                       **run["moved"]}
        if not (err <= PP_RESHARD_TOL and run["moved"]["equal"]):
            raise SystemExit(f"pipeline parallel (d) reshard {name}: "
                             f"{moves[name]} vs straight {straight}")
    print("pipeline parallel (d) reshard: " + json.dumps({
        "card": card, "world": world, "from": f"pp={world}, 1f1b",
        "at_step": f"{PP_RESHARD_AT} of {PP_RESHARD_STEPS}",
        "straight_losses": straight, "held_at": PP_RESHARD_TOL,
        "moves": moves}), flush=True)


# -- phase 13: image workloads ------------------------------------------------

IMAGE_LR, IMAGE_MOMENTUM = 0.01, 0.9     # examples/resnet_benchmark.py
IMAGE_PARITY_STEPS = 3
IMAGE_PARITY_BATCH = 8                   # (a): rows; (c): rows a card
IMAGE_LOGIT_TOL = 1e-4                   # ROADMAP.md parity rules: logits
IMAGE_STEP_TOL = 1e-5                    # and training steps, f32
IMAGE_BATCH = 64                         # images a card (the reference)
IMAGE_SIZE = 224
IMAGE_WARMUP, IMAGE_STEPS = 5, 20
IMAGE_FIRST_RTOL, IMAGE_LATER_RTOL = 1e-6, 1e-2
IMAGE_DEADLINE_S = 600
ELASTIC_DEADLINE_S = 400


def image_world() -> int:
    """Ranks of phase 13 (c) and (d): every card, at most four."""
    return min(torch.cuda.device_count(), DIST_MAX_WORLD)


def load_example(name: str):
    """An examples/ script as a module (its main() is not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tiny_resnet_run(device, global_batch: int, mesh=None,
                    fault: bool = False):
    """ResNet with stage sizes (1, 1, 1, 1), width 16, 10 classes, f32,
    at 32 x 32, weights and a global batch from SEED: one train-mode
    forward (its logits and the running statistics it leaves), then, from
    the same weights, IMAGE_PARITY_STEPS SGD-momentum steps through
    build_train_step (losses, final weights and statistics).  Under
    ``mesh`` the rank takes its rows; ``fault`` gives one BatchNorm
    (``bn_init``) local statistics."""
    from mpi_operator_tpu_torch.models import resnet as tres
    from mpi_operator_tpu_torch.parallel.mesh import batch_rows
    from mpi_operator_tpu_torch.parallel.train import build_train_step, sgd

    cfg = tres.ResNetConfig(stage_sizes=(1, 1, 1, 1), num_classes=10,
                            width=16, dtype=torch.float32)
    weights = tres.init_weights_(tres.ResNet(cfg, device="cpu"),
                                 torch.Generator().manual_seed(SEED))
    weights = weights.state_dict()
    rng = np.random.default_rng(SEED)
    images = torch.as_tensor(rng.standard_normal((global_batch, 32, 32, 3),
                                                 dtype=np.float32))
    labels = torch.as_tensor(rng.integers(0, 10, (global_batch,)))
    if mesh is not None:
        rows = batch_rows(tuple(mesh.shape), mesh.get_coordinate(),
                          global_batch)
        images, labels = images[rows], labels[rows]
    images, labels = images.to(device), labels.to(device)

    def build():
        model = tres.ResNet(cfg, mesh=mesh, device=device)
        model.load_state_dict(weights)
        if fault:
            model.bn_init.group = None
        return model

    model = build()
    logits = model(images).detach().cpu()
    forward_stats = {k: v.cpu().clone() for k, v in
                     model.state_dict().items()
                     if k.endswith((".mean", ".var"))}
    init, step = build_train_step(
        lambda m, b: tres.cross_entropy_loss(m(b[0]), b[1]),
        sgd(IMAGE_LR, momentum=IMAGE_MOMENTUM), mesh=mesh)
    state = init(build())
    losses = [step(state, (images, labels))[1]["loss"].item()
              for _ in range(IMAGE_PARITY_STEPS)]
    return {"logits": logits, "forward_stats": forward_stats,
            "losses": losses,
            "state": {k: v.detach().cpu()
                      for k, v in state.model.state_dict().items()}}


def image_parity_failures(got, want, logits: bool = True):
    """What of a tiny run differs from the reference beyond the parity
    rules: logits 1e-4 (``logits``: a run over the whole batch), the
    statistics the forward leaves, the losses and every final weight and
    running statistic 1e-5."""
    bad = []

    def close(a, b, tol):
        return bool(torch.allclose(torch.as_tensor(a), torch.as_tensor(b),
                                   rtol=tol, atol=tol))

    if logits and not close(got["logits"], want["logits"], IMAGE_LOGIT_TOL):
        bad.append("logits")
    bad += [f"forward {k}" for k, v in want["forward_stats"].items()
            if not close(got["forward_stats"][k], v, IMAGE_STEP_TOL)]
    if not close(got["losses"], want["losses"], IMAGE_STEP_TOL):
        bad.append(f"losses {got['losses']} vs {want['losses']}")
    bad += [k for k, v in want["state"].items()
            if not close(got["state"][k], v, IMAGE_STEP_TOL)]
    return bad


def state_digest(model) -> str:
    """sha256 over every parameter and buffer's bytes, in name order."""
    import hashlib
    digest = hashlib.sha256()
    for name, value in sorted(model.state_dict().items()):
        digest.update(name.encode())
        digest.update(value.detach().contiguous().view(torch.uint8).cpu()
                      .numpy().tobytes())
    return digest.hexdigest()


def image_train_mfu(run) -> float:
    return (run["train_flops_per_image"] * run["batch_per_device"]
            / (run["step_ms"] / 1e3) / PEAK_OPS[torch.bfloat16])


def image_summary(run) -> dict:
    return {"images_per_s": run["images_per_s"], "step_ms": run["step_ms"],
            "peak_gb": run["peak_bytes"] / 1e9,
            "train_mfu": image_train_mfu(run),
            "train_gflop_per_image": run["train_flops_per_image"] / 1e9,
            "losses": run["losses"]}


def image_run_failures(run) -> list:
    bad = []
    if not all(np.isfinite(run["losses"])):
        bad.append(f"losses {run['losses']}")
    if not run["peak_bytes"] < 80e9:
        bad.append(f"peak {run['peak_bytes']}")
    return bad


def image_rank(out_dir: str) -> int:
    """A child of phase 13 (c): the tiny ResNet at dp = world, and again
    with the planted fault; then ResNet-101 at IMAGE_BATCH a card."""
    import torch.distributed as dist

    from mpi_operator_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    rank, world = sp_group()
    mesh = create_mesh(MeshConfig(dp=world), "cuda")
    runs = {"global": tiny_resnet_run("cuda", IMAGE_PARITY_BATCH * world,
                                      mesh),
            "local_bn_init": tiny_resnet_run(
                "cuda", IMAGE_PARITY_BATCH * world, mesh, fault=True)}
    torch.save(runs, os.path.join(out_dir, f"image_tiny_rank{rank}.pt"))
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = True
    run = load_example("resnet_benchmark_torch").benchmark(
        "resnet101", IMAGE_BATCH, IMAGE_STEPS, IMAGE_WARMUP, IMAGE_SIZE,
        "cuda", mesh, seed=SEED)
    result = {"rank": rank, "world": world, "backend": dist.get_backend(),
              "card": torch.cuda.current_device(),
              "digest": state_digest(run["state"].model),
              **image_summary(run), "peak_bytes": run["peak_bytes"]}
    with open(os.path.join(out_dir, f"image_rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()
    return 0


def elastic_run(card: str, world: int, out_dir: str):
    """Phase 13 (d): examples/elastic_train_torch.py --model resnet50 at
    224, IMAGE_BATCH images a card, one process per card; the membership
    artifact goes from ``world`` hosts to world / 2 and back (at one
    card it stays at one), then the stop file ends the run."""
    mpi_dir = os.path.join(out_dir, "mpi")
    os.makedirs(mpi_dir, exist_ok=True)
    hosts = os.path.join(mpi_dir, "discover_hosts.sh")
    stop = os.path.join(out_dir, "stop")

    def write_hosts(n):
        with open(hosts + ".tmp", "w") as f:
            f.write("#!/bin/sh\n" + "".join(f"echo h{i}\n" for i in range(n)))
        os.replace(hosts + ".tmp", hosts)

    write_hosts(world)
    port, submit = free_port(), time.time()
    argv = [sys.executable, os.path.join(HERE, "examples",
                                         "elastic_train_torch.py"),
            "--model", "resnet50", "--image-size", str(IMAGE_SIZE),
            "--batch", str(IMAGE_BATCH * world), "--steps", "100000",
            "--poll", "0.05", "--ckpt-dir", os.path.join(out_dir, "ckpt"),
            "--stop-file", stop]
    procs = []
    for rank in range(world):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_PROCESS_ID=str(rank), JAX_NUM_PROCESSES=str(world),
                   MPIJOB_SUBMIT_TIME=repr(submit), K_MOUNT_MPI=mpi_dir)
        log = open(os.path.join(out_dir, f"elastic_rank{rank}.log"), "w")
        procs.append((log, subprocess.Popen(argv, env=env, stdout=log,
                                            stderr=subprocess.STDOUT,
                                            cwd=HERE)))
    log0 = os.path.join(out_dir, "elastic_rank0.log")
    end = time.monotonic() + ELASTIC_DEADLINE_S

    def wait_for(pattern, count=1):
        while time.monotonic() < end:
            text = open(log0).read()
            if len(re.findall(pattern, text)) >= count:
                return text
            if any(p.poll() for _, p in procs):
                break
            time.sleep(0.2)
        raise SystemExit(f"image workloads (d) elastic: no {pattern!r}:\n"
                         + open(log0).read()[-4000:])

    t0 = time.perf_counter()
    try:
        wait_for(rf"ELASTIC-TRAIN-START world={world} ")
        start_s = time.perf_counter() - t0
        changes = []
        if world >= 2:
            for n, new in enumerate((world // 2, world)):
                time.sleep(3.0)                      # steps on this world
                write_hosts(new)
                wait_for(r"WORLD-CHANGE .* restored=True", n + 1)
                changes.append(time.perf_counter() - t0)
        time.sleep(3.0)
        with open(stop, "w"):
            pass
        for _, proc in procs:
            proc.wait(timeout=max(end - time.monotonic(), 1))
    finally:
        for log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    text = open(log0).read()
    codes = [p.returncode for _, p in procs]
    found = re.findall(r"WORLD-CHANGE step=(\d+) old=(\d+) new=(\d+) "
                       r"restored=True", text)
    ok = re.search(r"ELASTIC-TRAIN-OK steps=(\d+) worlds=(\S+) "
                   r"final_loss=(\S+)", text)
    want = ([(str(world), str(world // 2)), (str(world // 2), str(world))]
            if world >= 2 else [])
    steps = [int(s) for s, _, _ in found]
    if any(codes) or not ok or [(o, n) for _, o, n in found] != want or \
            steps != sorted(steps) or (steps and int(ok.group(1)) <=
                                       steps[-1]) or \
            not np.isfinite(float(ok.group(3))):
        raise SystemExit(f"image workloads (d) elastic: exit {codes}:\n"
                         + text[-4000:])
    print(f"image workloads (d) elastic: resnet50 at {IMAGE_SIZE}, "
          f"{IMAGE_BATCH} a card at {world} cards, "
          + (f"world {world} -> {world // 2} -> {world} at steps "
             f"{steps}" if world >= 2 else
             "world changes need two cards; ran at one")
          + f"; {ok.group(0)}; start {start_s:.1f} s, changes done at "
          f"{[round(c, 1) for c in changes]} s; {card}", flush=True)


def mnist_start(out_dir: str):
    """Phase 13 (e): examples/mnist_train_torch.py on card 0, started
    beside (d) (most of its seconds are its process starting); returns
    (process, log, deadline)."""
    log = open(os.path.join(out_dir, "mnist.log"), "w")
    proc = subprocess.Popen([sys.executable, os.path.join(
        HERE, "examples", "mnist_train_torch.py")], stdout=log,
        stderr=subprocess.STDOUT, cwd=HERE,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="0"))
    return proc, log, time.monotonic() + 300


def mnist_finish(started) -> None:
    """Wait for (e)'s process until its deadline, then kill it."""
    proc, log, deadline = started
    try:
        proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    finally:
        log.close()


def mnist_check(card: str, started, out_dir: str):
    """Phase 13 (e)'s checks on the finished example's output."""
    proc = started[0]
    text = open(os.path.join(out_dir, "mnist.log")).read()
    first = re.search(r"step=0 loss=(\S+)", text)
    done = re.search(r"done processes=1 devices=1 final_loss=(\S+)", text)
    if proc.returncode or not first or not done or \
            not float(done.group(1)) < float(first.group(1)):
        raise SystemExit(f"image workloads (e) mnist: exit "
                         f"{proc.returncode}\n{text[-4000:]}")
    goodput = re.search(r"goodput=.*", text).group(0)
    print(f"image workloads (e) mnist (beside (d)): step 0 loss "
          f"{first.group(1)} -> {done.group(0)}; {goodput}; {card}",
          flush=True)


def image_phase(card: str):
    """Phase 13: (a) the tiny ResNet on card 0 against the CPU; (b)
    ResNet-101 at 224, 64 a card, bf16, on one card, twice; (c) with
    two cards or more, dp over every card: the tiny model against one
    card and a planted BatchNorm fault, then ResNet-101 at 64 a card;
    (d) the elastic example; (e) the MNIST example, beside (d).  Prints
    each part's seconds."""
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="chip-smoke-image-")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    parts, t_part = {}, [t0]

    def part_done(name):
        parts[name] = time.perf_counter() - t_part[0]
        t_part[0] = time.perf_counter()

    cpu = tiny_resnet_run("cpu", IMAGE_PARITY_BATCH)
    card_run = tiny_resnet_run("cuda", IMAGE_PARITY_BATCH)
    bad = image_parity_failures(card_run, cpu)
    if bad:
        raise SystemExit(f"image workloads (a) parity: {bad}")
    print(f"image workloads (a) parity: tiny ResNet (1, 1, 1, 1) x 16, "
          f"f32, 32 x 32, batch {IMAGE_PARITY_BATCH}: card == CPU (logits "
          f"{IMAGE_LOGIT_TOL}, statistics and {IMAGE_PARITY_STEPS} "
          f"SGD-momentum steps {IMAGE_STEP_TOL}); largest logit error "
          f"{(card_run['logits'] - cpu['logits']).abs().max().item():.3g}, "
          f"losses {card_run['losses']}", flush=True)
    part_done("(a) parity")

    bench = load_example("resnet_benchmark_torch")
    benchmark_flag = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        runs = []
        for _ in range(2):
            gc.collect()
            torch.cuda.empty_cache()
            run = bench.benchmark("resnet101", IMAGE_BATCH, IMAGE_STEPS,
                                  IMAGE_WARMUP, IMAGE_SIZE, "cuda",
                                  seed=SEED)
            del run["state"]
            runs.append(run)
    finally:
        torch.backends.cudnn.benchmark = benchmark_flag
    first, again = (r["losses"] for r in runs)
    rel = [abs(a - b) / abs(b) for a, b in zip(again, first)]
    bad = image_run_failures(runs[0]) + image_run_failures(runs[1])
    if bad or rel[0] > IMAGE_FIRST_RTOL or max(rel[1:]) > IMAGE_LATER_RTOL:
        raise SystemExit(f"image workloads (b) resnet101: {bad}, repeat "
                         f"relative differences {rel}")
    print("image workloads (b) resnet101 at 224, batch 64, bf16, "
          "channels_last, one card: " + json.dumps({
              "card": card, "runs": [image_summary(r) for r in runs],
              "repeat_rel_diff_first": rel[0],
              "repeat_rel_diff_later_max": max(rel[1:])}), flush=True)
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    part_done("(b) resnet101 one card, twice")

    world = image_world()
    if world >= 2:
        run_ranks([sys.executable, os.path.abspath(__file__), "image-rank",
                   out_dir], world, "image workloads (c)",
                  IMAGE_DEADLINE_S, out_dir)
        ref = tiny_resnet_run("cuda", IMAGE_PARITY_BATCH * world)
        ranks = [json.load(open(os.path.join(out_dir,
                                             f"image_rank{r}.json")))
                 for r in range(world)]
        verdict = {}
        for r in range(world):
            tiny = torch.load(os.path.join(out_dir,
                                           f"image_tiny_rank{r}.pt"))
            verdict[r] = {name: image_parity_failures(run, ref,
                                                      logits=False)
                          for name, run in tiny.items()}
        if any(v["global"] or not v["local_bn_init"]
               for v in verdict.values()):
            raise SystemExit(f"image workloads (c) parity: {verdict}")
        digests = {r["digest"] for r in ranks}
        bad = [f"rank {r['rank']}: {f}" for r in ranks
               for f in image_run_failures(r)]
        if bad or len(digests) != 1 or \
                any(r["world"] != world or r["backend"] != "nccl"
                    for r in ranks):
            raise SystemExit(f"image workloads (c) resnet101: {bad}, "
                             f"{len(digests)} distinct states over "
                             f"{world} ranks: {ranks}")
        print(f"image workloads (c) parity: tiny ResNet at dp={world} "
              f"({IMAGE_PARITY_BATCH} rows a card) == card 0 alone on the "
              f"global batch at {IMAGE_STEP_TOL} ({IMAGE_PARITY_STEPS} "
              f"SGD-momentum steps, every weight and statistic); planted "
              f"fault (bn_init with local statistics) caught: "
              f"{verdict[0]['local_bn_init'][:3]}", flush=True)
        print(f"image workloads (c) resnet101 at dp={world}, {IMAGE_BATCH} "
              f"a card: weights and BatchNorm buffers bit-identical over "
              f"the ranks; " + json.dumps({
                  "card": card, "world": world,
                  "total_images_per_s": ranks[0]["images_per_s"],
                  "images_per_s_per_card": ranks[0]["images_per_s"] / world,
                  "ranks": [{"rank": r["rank"], "step_ms": r["step_ms"],
                             "images_per_s_per_card":
                                 r["images_per_s"] / world,
                             "peak_gb": r["peak_gb"],
                             "train_mfu": r["train_mfu"],
                             "losses": r["losses"]} for r in ranks]}),
              flush=True)
    else:
        print("image workloads (c) dp: needs two cards; this machine shows "
              "one", flush=True)
    part_done("(c) dp")

    mnist = mnist_start(out_dir)
    try:
        elastic_run(card, world, out_dir)
    finally:
        mnist_finish(mnist)
    mnist_check(card, mnist, out_dir)
    part_done("(d) elastic, (e) mnist beside it")
    print("image workloads parts (seconds): " + json.dumps(parts),
          flush=True)
    print(f"image workloads: phase 13 in {time.perf_counter() - t0:.1f} s",
          flush=True)


def build_phase() -> None:
    """Both kernel sources, each by its own nvcc, started together."""
    from mpi_operator_tpu_torch.ops import _build

    times, errors = {}, []

    def one(name):
        t0 = time.perf_counter()
        try:
            _build.build(name, force=True)
        except RuntimeError as exc:       # reported after both builds end
            errors.append(exc)
        times[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=one, args=(name,))
               for name in KERNEL_SOURCES]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(t.is_alive() for t in threads):
        raise SystemExit(f"kernel build failed: {errors}")
    for name in KERNEL_SOURCES:
        print(f"build: {name}.cu in {times[name]:.1f} s", flush=True)
        for line in _build.build_logs[name].splitlines():
            if any(w in line for w in ("Used", "spill", "entry function",
                                       "setmaxnreg", "wgmma")):
                print(f"build[{name}]: {line.strip()}")
    spills = wgmma_spills(_build.build_logs["flash_attention"])
    print("ptxas[flash_attention]: spill bytes (stores, loads) per wgmma "
          "kernel " + json.dumps(spills), flush=True)
    if len(spills) != len(WGMMA_KERNELS) or any(
            st or ld for st, ld in spills.values()):
        raise SystemExit(f"build: every wgmma kernel must report 0 spill "
                         f"bytes: {spills}")
    print("sass[flash_attention]: HGMMA per wgmma kernel "
          + json.dumps(hgmma_counts()), flush=True)


def wgmma_kernel(symbol: str):
    """The WGMMA_KERNELS name of a mangled symbol, or None."""
    return next((name for name, frag in WGMMA_KERNELS.items()
                 if frag in symbol), None)


def wgmma_spills(log: str):
    """{kernel: (spill store bytes, spill load bytes)} of the wgmma
    kernels, from nvcc's -Xptxas -v report."""
    spills, func = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            func = wgmma_kernel(line)
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if func and found:
            spills[func] = (int(found.group(1)), int(found.group(2)))
            func = None
    return spills


def hgmma_counts():
    """{kernel: HGMMA instructions} for the bf16 wgmma kernels (forward,
    dQ, dK/dV), from cuobjdump -sass of the built flash attention
    library; fails when one of them issues none."""
    from mpi_operator_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(_build.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            func = wgmma_kernel(line)
            if func:
                counts[func] = 0
        elif func and "HGMMA" in line:
            counts[func] += 1
    if len(counts) != len(WGMMA_KERNELS) or not all(counts.values()):
        raise SystemExit(f"sass: the bf16 flash kernels must issue wgmma "
                         f"(HGMMA): {counts}")
    return counts


def flash_entry(name, flash, launches, other_launches):
    main_case = flash["llama2_7b_train"]
    rel = {case: r["rel_err"][name] for case, r in flash.items()
           if isinstance(r, dict)}
    bound_ms, bound_by = main_case["bounds"][name]
    library = (main_case["sdpa_fwd_ms"] if name == "flash_fwd"
               else main_case["sdpa_bwd_ms"])
    return {
        "name": name,
        "route": "cuda",
        "source": "mpi_operator_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": FLASH_REPLACES[name],
        "launches": launches[name],
        # The training example's tiny defaults (head_dim 32, padded),
        # its mixtral-tiny --data run and the MoE training phase.
        "launches_other_paths": {path: counts[name] for path, counts in
                                 other_launches.items()},
        "max_abs_err": max(r["max_abs_err"][name] for r in flash.values()
                           if isinstance(r, dict)),
        "max_rel_err": rel,
        "with_lse_dlse_rel_err": flash["with_lse_dlse"],
        "with_lse_dlse_non_causal_rel_err":
            flash["with_lse_dlse_non_causal"],
        "planted_fault_rel_err": main_case["planted_fault_rel_err"][name],
        "ms": main_case["ms"][name],
        "host_us": main_case["host_us"][name],
        "plain_ms": main_case["plain_ms"][name],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "tflops": main_case["tflops"][name],
        "bound_share": main_case["bound_share"][name],
        "bitwise_repeat": {k: v for k, v in
                           main_case["bitwise_repeat"].items()
                           if (k in ("out", "lse")) == (name == "flash_fwd")},
        # SDPA's backward computes dq, dk and dv in one call: the
        # yardstick of K2' and K3' together.
        "library_ms": library,
    }


KERNEL_SOURCES = ("paged_attention", "flash_attention", "rmsnorm")
# The bf16 wgmma kernels of flash_attention.cu: {name: mangled fragment}.
WGMMA_KERNELS = {f"{k}<{d}>": f"{k}ILi{d}E"
                 for k in ("flash_fwd_wgmma_kernel",
                           "flash_bwd_dq_wgmma_kernel",
                           "flash_bwd_dkv_wgmma_kernel")
                 for d in (64, 128)}
FLASH_REPLACES = {
    "flash_fwd": "mpi_operator_tpu/ops/attention.py:53",
    "flash_bwd_dq": "mpi_operator_tpu/ops/attention.py:179",
    "flash_bwd_dkv": "mpi_operator_tpu/ops/attention.py:224",
}


# The phases that --phases names, and what each needs from another: a
# phase checks its results against these phases' (9 and 10: phase 5's
# streams and server; 12: phase 7 (c)'s losses).
PHASE_IDS = (3, 4, 5, 6, 7, 9, 11, 12, 13, 10)
PHASE_NEEDS = {9: (5,), 10: (5,), 12: (7,)}


def chosen_phases(argv):
    """The phases of ``--phases 5,9,12`` with what they need (every
    phase when the flag is absent); the build phase always runs."""
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default="",
                        help="a comma-separated subset of "
                             f"{','.join(map(str, PHASE_IDS))} (default: "
                             "all, as the smoke is run); each runs with the "
                             "phases it is checked against")
    args = parser.parse_args(argv)
    if not args.phases:
        return set(PHASE_IDS)
    picked = {int(p) for p in args.phases.split(",")}
    bad = picked - set(PHASE_IDS)
    if bad:
        parser.error(f"no phase {sorted(bad)}; phases: {PHASE_IDS}")
    for p in list(picked):
        picked.update(PHASE_NEEDS.get(p, ()))
    return picked


def main() -> int:
    if sys.argv[1:2] == ["distributed-rank"]:
        return distributed_rank(sys.argv[2])
    if sys.argv[1:2] == ["tp-rank"]:
        return tp_rank(sys.argv[2])
    if sys.argv[1:2] == ["sp-rank"]:
        return sp_rank(sys.argv[2])
    if sys.argv[1:2] == ["pp-rank"]:
        return pp_rank(sys.argv[2])
    if sys.argv[1:2] == ["image-rank"]:
        return image_rank(sys.argv[2])
    phases = chosen_phases(sys.argv[1:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke run needs the card",
              file=sys.stderr)
        return 1
    from mpi_operator_tpu_torch.ops import _build

    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    card = card_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    print(f"card: {card} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {nvcc}", flush=True)
    print(f"phases: {sorted(phases)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    timed("2 build", build_phase)
    if 3 in phases:
        kernels = timed("3 kernels K4'", kernel_phase)
        flash = timed("3 kernels K1'-K3'", flash_phase)
        rms = timed("3 kernels K5'", rmsnorm_phase)
    if 4 in phases:
        timed("4 parity", parity_phase)
        timed("4 train parity", train_parity_phase)
        timed("4 train parity moe", train_parity_phase, "mixtral_tiny")
        example_launches = timed("4 train example", train_example_phase)
        moe_example_launches = timed("4 train example moe",
                                     train_example_phase, True)
    if 5 in phases:
        from mpi_operator_tpu_torch.models.quant import quantize_model

        model = serving_model()
        serve = timed("5 serving", serving_phase, card, model)
        spec = timed("5b speculation", speculative_phase, card, model)
        chunked = timed("5c chunked", chunked_phase, card, model, serve)
        t0 = time.perf_counter()
        logit_prompt = serve["prompts"][3]
        bf16_logits = int8_logits(model, logit_prompt)
        qmodel = quantize_model(model)
        del model                   # the bf16 weights are freed here
        free()
        int8 = int8_phase(card, qmodel, bf16_logits, logit_prompt, serve)
        del qmodel
        free()
        seconds["5d int8"] = time.perf_counter() - t0
        model = serving_model()     # the bf16 7B again, from SEED
        disagg = timed("5e disagg", disagg_phase, card, model, serve)
        del model
        free()
        moe_serve = timed("5f moe serving", moe_serving_phase, card)
    if 6 in phases:
        flash_launches, losses = timed("6 training", training_phase, card)
        timed("6 training repeat", training_repeat_phase, card, losses)
        free()
        moe_flash_launches, moe_losses = timed(
            "6b moe training", training_phase, card, "mixtral_8x7b")
        timed("6b moe training repeat", training_repeat_phase, card,
              moe_losses, "mixtral_8x7b")
    if 7 in phases:
        distributed = timed("7 distributed", distributed_phase, card)
    if 9 in phases:
        tp = timed("9 tensor parallel", tp_phase, card, serve)
    if 11 in phases:
        sp = timed("11 sequence/expert parallel", sp_phase, card)
    if 12 in phases:
        pp = timed("12 pipeline parallel", pp_phase, card,
                   distributed["losses"])
    if 13 in phases:
        timed("13 image workloads", image_phase, card)
    if 10 in phases:
        k4_profile = timed("10 profile", serving_profile_phase,
                           serve["prompts"])
    for t in _REMOVALS:
        t.join()
    seconds["total"] = time.perf_counter() - t_start
    print("phase seconds: " + json.dumps(seconds), flush=True)
    if phases != set(PHASE_IDS):
        print(card)
        print(f"chip_smoke: phases {sorted(phases)} passed; the kernels "
              f"line needs every phase", flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    main_case = kernels["llama2_7b"]
    entry = {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "mpi_operator_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "mpi_operator_tpu/ops/paged_attention.py:75",
        "launches": serve["launches"],
        # K4' launches of the other serving paths, each counted from 0
        # over its own run.
        "launches_other_paths": {
            "speculative_self_draft":
                spec["self_draft"]["paged_attention_launches"],
            "speculative_prompt_lookup":
                spec["prompt_lookup"]["paged_attention_launches"],
            "chunked_prefill": chunked["paged_attention_launches"],
            "int8_weights": int8["paged_attention_launches"],
            "disagg_decode": disagg["launches"],
            "disagg_decode_int8_pool": disagg["int8_launches"],
            "moe_serving": moe_serve["launches"],
            # Phase 9, rank 0 (every rank's count is checked there);
            # the MoE run needs two cards.
            "tp_serving_rank0": tp["launches_rank0"],
            "tp_moe_serving_rank0": tp.get("moe_launches_rank0"),
            # Phase 9 (d), the decode replica's ranks (four cards).
            **{f"tp_disagg_decode_{k}": v
               for k, v in tp.get("disagg_launches", {}).items()},
            # Phase 9 (e), the weights over fsdp, rank 0 (two cards or
            # more; every rank's count is checked there).
            "tp_fsdp_serving_rank0": tp.get("fsdp_launches_rank0")},
        "max_abs_err": max(k["max_abs_err"] for k in kernels.values()),
        "max_rel_err": {n: k["max_rel_err"] for n, k in kernels.items()},
        "planted_fault_rel_err": main_case["planted_fault_rel_err"],
        "bitwise_repeat": all(k["bitwise_repeat"] for k in kernels.values()),
        "ms": main_case["ms"],
        "kernel_ms": main_case["ms"],
        "host_us": main_case["host_us"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "bound_share": main_case["bound_share"],
        "split_plan": main_case["split_plan"],
        # Every case: ms, share of its bound, host us.
        "cases": {n: {"ms": k["ms"], "bound_ms": k["bound_ms"],
                      "bound_share": k["bound_share"],
                      "host_us": k["host_us"]} for n, k in kernels.items()},
        # K4' device ms per decode step of the serving phase (profiled).
        "serving_ms_per_decode_step":
            k4_profile["paged_attention_ms_per_step"],
        "library_ms": None,
    }
    other = {"train_example_tiny": example_launches,
             "train_example_mixtral_tiny_data": moe_example_launches,
             "moe_training": moe_flash_launches,
             "fsdp_training_rank0": distributed["launches_rank0"],
             "fsdp_ckpt_restored_rank0": distributed["ckpt_launches_rank0"]}
    if "train_launches_rank0" in tp:       # two cards or more
        other["tp_training_rank0"] = tp["train_launches_rank0"]
    # Phase 11 (two cards or more): the ring's launches on every sp rank,
    # the MoE run's on rank 0.
    for rank, counts in sp.get("llama2_7b", {}).items():
        other[f"sp_training_{rank}"] = counts
    if "mixtral_8x7b" in sp:
        other["ep_training_rank0"] = sp["mixtral_8x7b"]["rank0"]
    # Phase 12 (two cards or more): the 7B's and (c) Mixtral's stages on
    # every pp rank.
    for name in ("1f1b", "interleaved", "moe_1f1b"):
        for rank, counts in pp.get(name, {}).items():
            other[f"pp_{name}_{rank}"] = counts
    entries = [entry] + [flash_entry(name, flash, flash_launches, other)
                         for name in FLASH_REPLACES] + [rmsnorm_entry(rms)]
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
