#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mpi_operator_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase is caught and
continued:

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
             (flash attention forward, dQ, dK/dV) at the training shape (2 x 32 heads x 4096 x 128,
             bf16, causal) and non-causal, S = 4095, D = 64, f32 and
             flash_attention_with_lse with an lse cotangent: per
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
             moe (5e)      mixtral_8x7b at full width (dim 4096, FFN
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
7. profile   after every measured phase, the serving phase's concurrent
             prompts on a fresh server of the same shape, once to warm
             up and once under torch.profiler: K4''s device ms per
             decode step (its split and merge kernels) and its share of
             the device's busy time.

Before the last line it prints the card line and one
{"kernels": [...]} JSON line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import gc
import json
import os
import re
import subprocess
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


# -- phase 5e: MoE serving ---------------------------------------------------

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


def flash_lse_case(fa, gen):
    """flash_attention_with_lse with an lse cotangent (dlse folded into
    delta) against autograd through the plain version."""
    dev = torch.device("cuda")
    q, k, v, g = (torch.randn(1, 8, 1024, 128, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    gl = torch.randn(1, 8, 1024, generator=gen, device=dev)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = fa.flash_attention_with_lse(*leaves, None, True)
    ((out * g.float()).sum() + (lse * gl).sum()).backward()
    plain = [x.clone().float().requires_grad_() for x in (q, k, v)]
    pout, plse = fa._plain_forward(*plain, 128 ** -0.5, True)
    ((pout * g.float()).sum() + (plse * gl).sum()).backward()
    errs = [bh_rel_err(out, pout)] + [bh_rel_err(a.grad, b.grad)
                                      for a, b in zip(leaves, plain)]
    limits = [FLASH_LIMITS[torch.bfloat16][0]] + \
        [FLASH_LIMITS[torch.bfloat16][1]] * 3
    if not all(e <= t for e, t in zip(errs, limits)):
        raise SystemExit(f"flash_attention_with_lse with dlse: errors "
                         f"{errs} exceed {limits}")
    print(f"kernel flash[with_lse_dlse]: out/dq/dk/dv rel err {errs}",
          flush=True)
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
    ]
    results = {c[0]: flash_case(fa, gen, *c) for c in cases}
    results["with_lse_dlse"] = flash_lse_case(fa, gen)
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
    moe = cfg.n_experts > 1
    ffn_params = ((cfg.top_k if moe else 1) * 3 * cfg.dim * cfg.ffn_dim
                  + (cfg.dim * cfg.n_experts if moe else 0))
    matmul_params = cfg.n_layers * (
        2 * cfg.dim * cfg.n_heads * cfg.head_dim
        + 2 * cfg.dim * cfg.kv_heads * cfg.head_dim
        + ffn_params) + cfg.dim * cfg.vocab_size
    flops = (6 * n_tokens * matmul_params
             + 12 * cfg.n_layers * batch * seq ** 2 * cfg.dim / 2)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke run needs the card",
              file=sys.stderr)
        return 1
    from mpi_operator_tpu_torch.ops import _build

    card = card_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    print(f"card: {card} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {nvcc}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_phase()
    kernels = kernel_phase()
    flash = flash_phase()
    rms = rmsnorm_phase()
    parity_phase()
    train_parity_phase()
    train_parity_phase("mixtral_tiny")
    example_launches = train_example_phase()
    moe_example_launches = train_example_phase(moe_data=True)

    from mpi_operator_tpu_torch.models.quant import quantize_model

    model = serving_model()
    serve = serving_phase(card, model)
    spec = speculative_phase(card, model)
    chunked = chunked_phase(card, model, serve)
    logit_prompt = serve["prompts"][3]
    bf16_logits = int8_logits(model, logit_prompt)
    qmodel = quantize_model(model)
    del model                       # the bf16 weights are freed here
    gc.collect()
    torch.cuda.empty_cache()
    int8 = int8_phase(card, qmodel, bf16_logits, logit_prompt, serve)
    del qmodel
    gc.collect()
    torch.cuda.empty_cache()
    moe_serve = moe_serving_phase(card)
    flash_launches, losses = training_phase(card)
    training_repeat_phase(card, losses)
    gc.collect()
    torch.cuda.empty_cache()
    moe_flash_launches, moe_losses = training_phase(card, "mixtral_8x7b")
    training_repeat_phase(card, moe_losses, "mixtral_8x7b")
    k4_profile = serving_profile_phase(serve["prompts"])

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
            "moe_serving": moe_serve["launches"]},
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
             "moe_training": moe_flash_launches}
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
