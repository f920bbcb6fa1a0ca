#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mpi_operator_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase is caught and
continued:

1. card      the card's name and power limit (nvidia-smi), the torch and
             CUDA versions and `nvcc --version`.
2. build     both kernel sources under mpi_operator_tpu_torch/ops/csrc/
             (paged_attention.cu, flash_attention.cu), each by its own
             nvcc, started together; each -Xptxas -v register /
             shared-memory / spill report is printed.
3. kernels   each kernel against its plain PyTorch version on the card.
             K4' (paged decode attention) at the serving path's shapes:
             per (row, query head), the largest error over the largest
             |plain output| is at most 2e-2 in bf16 and 2e-5 in f32; a
             planted fault (one table entry pointing at another block)
             must exceed it.  K1'-K3' (flash attention forward, dQ,
             dK/dV) at the training shape (2 x 32 heads x 4096 x 128,
             bf16, causal) and non-causal, S = 4095, D = 64, f32 and
             flash_attention_with_lse with an lse cotangent: per
             (batch, head), the largest error over the largest |plain
             value| is at most 2e-2 forward and 5e-2 for gradients in
             bf16, 2e-5 and 5e-4 in f32; a planted fault (key block 0 of
             one head replaced by block 10, given to the kernels only)
             must exceed each limit.  Kernels are timed by CUDA-graph
             replay between CUDA events (device time; the wrapper's host
             time is printed apart), beside their bound (bytes over 3.35
             TB/s or operations over the type's peak rate, whichever is
             larger), the plain version's time and, for K1'-K3',
             scaled_dot_product_attention's forward and backward.
4. parity    tiny f32 models on the card equal the plain path on the CPU:
             paged greedy generate, and two AdamW train steps through the
             flash kernels (loss and grad_norm at 1e-4).
5. serving   llama2_7b at full width and depth (32 layers, dim 4096),
             random bf16 weights from a seeded generator on the card,
             served through InferenceServer(max_batch_slots=8,
             kv_page_size=16) over HTTP: each prompt first alone on a
             server without prefix cache (the reference), then 8
             concurrent greedy /generate requests of mixed prompt lengths
             plus one SSE stream, then a prefix-sharing pair.  Checked:
             every response's token count, concurrent == alone, the SSE
             stream == alone, transfers == ticks, and the paged attention
             kernel's launches == decode steps x n_layers.
6. training  llama2_7b at full width, 8 of 32 layers, batch 2 x 4096
             tokens, f32 parameters and AdamW state, bf16 compute: one
             warm step and 5 more through run_train_loop(build_train_step)
             after the serving model is freed.  Printed: step ms,
             tokens/s, train_mfu, losses, peak memory, goodput.  Checked:
             finite losses, the last below the first, K1'/K2'/K3'
             launches == 6 steps x 8 layers each, peak memory < 80 GB.

Before the last line it prints the card line and one
{"kernels": [...]} JSON line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import gc
import json
import os
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


def host_us(fn, iters: int = 200) -> float:
    """Host time of one call (launch overhead of the Python wrapper)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


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


def kernel_phase():
    from mpi_operator_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    mixed7 = [4096, 3000, 2048, 1500, 1024, 517, 100, 5000]   # last idle
    mixed8 = [8192, 6000, 4096, 2500, 1024, 333, 17, 9000]    # last idle
    cases = [
        # name, b, h, kh, d, page, maxb, dtype, lens, int8, idle, window
        ("llama2_7b", 8, 32, 32, 128, 16, 256, bf16, mixed7, False, True,
         None),
        ("llama3_8b_gqa", 8, 32, 8, 128, 16, 512, bf16, mixed8, False,
         True, None),
        ("llama2_7b_int8", 8, 32, 32, 128, 16, 256, bf16, mixed7, True,
         True, None),
        ("llama2_7b_window", 8, 32, 32, 128, 16, 256, bf16, mixed7, False,
         True, 1024),
        ("llama2_7b_uniform", 8, 32, 32, 128, 16, 256, bf16, [2048] * 8,
         False, False, None),
        ("f32_gqa", 4, 8, 2, 64, 16, 64, f32, [1024, 700, 17, 1], False,
         False, None),
    ]
    results = {}
    for (name, b, h, kh, d, page, maxb, dtype, lens, int8, idle,
         window) in cases:
        q, pk, pv, table, lengths, ks, vs = paged_inputs(
            gen, b, h, kh, d, page, maxb, dtype, lens, int8, idle)
        scale = 1.0 / d ** 0.5

        def kern():
            return pa.paged_decode_attention(q, pk, pv, table, lengths,
                                             k_scale=ks, v_scale=vs,
                                             window=window)

        def plain():
            return pa._torch_paged(q, pk, pv, table, lengths, scale,
                                   k_scale=ks, v_scale=vs, window=window)

        out = kern()
        torch.cuda.synchronize()
        ref = plain()
        tol = 2e-5 if dtype == f32 else 2e-2
        err = (out.float() - ref.float()).abs().max().item()
        rel = head_rel_err(out, ref)
        if not torch.isfinite(out.float()).all():
            raise SystemExit(f"kernel case {name}: non-finite output")
        if not rel <= tol:
            raise SystemExit(f"kernel case {name}: error {rel} of the "
                             f"largest output exceeds tolerance {tol}")
        fault = None
        if name == "llama2_7b":
            # Negative control: one live page of the 4096-token row read
            # from another row's block must fail the limit.
            bad = table.clone()
            bad[0, 100] = table[1, 100]
            fault = head_rel_err(pa.paged_decode_attention(
                q, pk, pv, bad, lengths), ref)
            if not fault > tol:
                raise SystemExit(f"kernel case {name}: a planted one-page "
                                 f"fault ({fault}) passes tolerance {tol}")
        ms = time_ms(kern, iters=20)
        plain_ms = time_ms(plain, iters=3)
        bound_ms, bound_by = paged_bound(q, pk, table, lengths, ks, window)
        results[name] = dict(max_abs_err=err, max_rel_err=rel, tol=tol,
                             planted_fault_rel_err=fault, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, host_us=host_us(kern))
        print(f"kernel paged_decode_attention[{name}]: "
              + json.dumps(results[name]), flush=True)
        del q, pk, pv, table, lengths, ks, vs, out, ref
        torch.cuda.empty_cache()
    return results


# -- phase 4: tiny-model parity -----------------------------------------------

def parity_phase():
    from mpi_operator_tpu_torch.models.llama import generate, llama2_tiny
    from mpi_operator_tpu_torch.models.params import init_params

    cfg = llama2_tiny(page_size=16)
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
        raise SystemExit(f"tiny paged generate: card {got.tolist()} != "
                         f"cpu {want.tolist()}")
    print("parity: tiny f32 paged generate, card == cpu (4 rows x 12 "
          "tokens)", flush=True)


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


def serving_phase(card: str):
    from mpi_operator_tpu_torch.models.llama import llama2_7b
    from mpi_operator_tpu_torch.models.params import init_params
    from mpi_operator_tpu_torch.ops import paged_attention as pa
    from mpi_operator_tpu_torch.serving import InferenceServer
    from mpi_operator_tpu_torch.serving.batcher import prefix_page_digests

    cfg = llama2_7b()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    torch.cuda.synchronize()
    print(f"serving: llama2_7b random init ({cfg.n_layers} layers, dim "
          f"{cfg.dim}, {cfg.dtype}) in {time.perf_counter() - t0:.1f} s",
          flush=True)
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
    torch.cuda.empty_cache()

    server = InferenceServer(model, max_batch_slots=8, kv_page_size=16,
                             device="cuda").start()
    try:
        tm = server._batcher.telemetry
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
    hit = server._batcher.prefix_stats["hit_blocks"]
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
        "card": card, "model": "llama2_7b", "slots": 8, "page_size": 16,
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
    return launches


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


def flash_bounds(b, h, s, d, dtype, causal):
    """{kernel: (bound ms, bound_by)}: each input read once and each
    output written once over 3.35 TB/s; the products' flops (2 per
    multiply-add over the unmasked (q, k) pairs) over the type's peak."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    tile = b * h * s * d * torch.tensor([], dtype=dtype).element_size()
    rows = b * h * s * 4
    work = {"flash_fwd": (2, 3 * tile + tile + rows),
            "flash_bwd_dq": (3, 4 * tile + 2 * rows + tile),
            "flash_bwd_dkv": (4, 4 * tile + 2 * rows + 2 * tile)}
    out = {}
    for name, (products, nbytes) in work.items():
        t_ops = 2 * products * pairs * d / PEAK_OPS[dtype] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
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


# -- phase 4b: training parity -------------------------------------------------

def train_parity_phase():
    """A tiny f32 model's first two train steps through the kernels on the
    card equal the plain path on the CPU (loss and grad_norm at 1e-4)."""
    from mpi_operator_tpu_torch.models.llama import (llama2_tiny,
                                                     next_token_loss)
    from mpi_operator_tpu_torch.models.params import init_params
    from mpi_operator_tpu_torch.ops import attention as fa
    from mpi_operator_tpu_torch.parallel.train import adamw, build_train_step

    # head_dim 64 (the kernels take 64 or 128), GQA, a ragged sequence.
    cfg = llama2_tiny(dim=128, n_heads=2, n_kv_heads=1)
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
    print(f"parity: tiny f32 training, 2 AdamW steps, card {metrics[1]} == "
          f"cpu {metrics[0]} (loss, grad_norm) at 1e-4", flush=True)


# -- phase 6: training -----------------------------------------------------------

TRAIN_LAYERS = 8
TRAIN_BATCH = 2
TRAIN_SEQ = 4096
TRAIN_STEPS = 6              # one warm step + 5 timed


def training_phase(card: str):
    """llama2_7b at full width, 8 of 32 layers, 2 x 4096 tokens, f32
    parameters and AdamW state, bf16 compute, through
    run_train_loop(build_train_step(...)) with the flash kernels."""
    import dataclasses

    from mpi_operator_tpu_torch.models.llama import (llama2_7b,
                                                     next_token_loss)
    from mpi_operator_tpu_torch.models.params import init_params
    from mpi_operator_tpu_torch.ops import attention as fa
    from mpi_operator_tpu_torch.parallel.train import (adamw,
                                                       build_train_step,
                                                       run_train_loop)
    from mpi_operator_tpu_torch.telemetry.goodput import GoodputTracker
    from mpi_operator_tpu_torch.telemetry.metrics import Registry

    cfg = dataclasses.replace(llama2_7b(), n_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda", dtype=cfg.param_dtype)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)), device="cuda")

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

    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    state, steps = run_train_loop(state, step, (tokens for _ in range(
        TRAIN_STEPS)), max_steps=TRAIN_STEPS, on_metrics=on_metrics)
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    warm_s = stamps[0] - t0
    step_s = (stamps[-1] - stamps[0]) / (len(stamps) - 1)
    n_tokens = TRAIN_BATCH * TRAIN_SEQ
    matmul_params = cfg.n_layers * (
        2 * cfg.dim * cfg.n_heads * cfg.head_dim
        + 2 * cfg.dim * cfg.kv_heads * cfg.head_dim
        + 3 * cfg.dim * cfg.ffn_dim) + cfg.dim * cfg.vocab_size
    flops = (6 * n_tokens * matmul_params
             + 12 * cfg.n_layers * TRAIN_BATCH * TRAIN_SEQ ** 2 * cfg.dim / 2)
    stats = {
        "card": card, "model": "llama2_7b", "n_layers": cfg.n_layers,
        "reduced": "n_layers 8 of 32", "batch": TRAIN_BATCH,
        "seq_len": TRAIN_SEQ, "params": n_params, "steps": steps,
        "losses": losses, "warm_step_s": warm_s, "step_ms": step_s * 1e3,
        "tokens_per_s": n_tokens / step_s,
        "train_mfu": flops / step_s / PEAK_OPS[torch.bfloat16],
        "flops_per_step": flops, "max_memory_allocated_bytes": peak,
        "kernel_launches": launches, "goodput": goodput.summary(),
    }
    print("training: " + json.dumps(stats), flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"training: losses {losses} are not finite and "
                         f"falling")
    want = TRAIN_STEPS * cfg.n_layers
    if any(n != want for n in launches.values()):
        raise SystemExit(f"training: kernel launches {launches}, expected "
                         f"{want} each (steps x layers)")
    if not peak < 80e9:
        raise SystemExit(f"training: peak memory {peak} bytes")
    return launches


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
            if "Used" in line or "spill" in line:
                print(f"build[{name}]: {line.strip()}")


def flash_entry(name, flash, launches):
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
        # SDPA's backward computes dq, dk and dv in one call: the
        # yardstick of K2' and K3' together.
        "library_ms": library,
    }


KERNEL_SOURCES = ("paged_attention", "flash_attention")
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
    parity_phase()
    train_parity_phase()
    launches = serving_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    flash_launches = training_phase(card)

    main_case = kernels["llama2_7b"]
    entry = {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "mpi_operator_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "mpi_operator_tpu/ops/paged_attention.py:75",
        "launches": launches,
        "max_abs_err": max(k["max_abs_err"] for k in kernels.values()),
        "max_rel_err": {n: k["max_rel_err"] for n, k in kernels.items()},
        "planted_fault_rel_err": main_case["planted_fault_rel_err"],
        "ms": main_case["ms"],
        "kernel_ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
    }
    entries = [entry] + [flash_entry(name, flash, flash_launches)
                         for name in FLASH_REPLACES]
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
