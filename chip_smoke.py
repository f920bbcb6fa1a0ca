#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mpi_operator_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase is caught and
continued:

1. card      the card's name and power limit (nvidia-smi), the torch and
             CUDA versions and `nvcc --version`.
2. build     the kernel source mpi_operator_tpu_torch/ops/csrc/
             paged_attention.cu is compiled with nvcc; the -Xptxas -v
             register / shared-memory / spill report is printed.
3. kernels   each kernel against its plain PyTorch version on the card,
             at the serving path's shapes.  Tolerance, per (row, query
             head): the largest error over the largest |plain output| is
             at most 2e-2 in bf16 and 2e-5 in f32, so the limit shrinks
             with the outputs of long rows; a planted fault (one table
             entry of the longest row pointing at another block) must
             exceed it.  Timed by CUDA-graph replay between CUDA events
             (device time only; the wrapper's host time is printed
             apart), beside its bound (bytes over 3.35 TB/s or operations
             over the type's peak rate, whichever is larger) and the
             plain version's time.
4. parity    a tiny f32 model: paged greedy generate on the card equals
             the plain path on the CPU.
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

Before the last line it prints the card line and one
{"kernels": [...]} JSON line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

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

    t0 = time.perf_counter()
    _build.build("paged_attention", force=True)
    print(f"build: paged_attention.cu in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in _build.build_logs["paged_attention"].splitlines():
        if "Used" in line or "spill" in line:
            print(f"build[paged_attention]: {line.strip()}")

    kernels = kernel_phase()
    parity_phase()
    launches = serving_phase(card)

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
    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
