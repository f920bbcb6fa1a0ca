"""One rank of a gloo process group for tests/test_torch_distributed.py
and tests/test_torch_tensor_parallel.py.

    JAX_COORDINATOR_ADDRESS=127.0.0.1:PORT JAX_PROCESS_ID=r \\
    JAX_NUM_PROCESSES=n python tests/torch_dist_worker.py SCENARIO DIR [cuda]

The process forms its group from the operator's env
(``bootstrap.initialize_from_env``: gloo on the CPU, or NCCL on the card
of its rank with ``cuda``), runs SCENARIO with the
inputs the test wrote to DIR (``inputs.pt``: the llama2_tiny weights as
a state dict and the global token batch) and saves what it found to
DIR/SCENARIO.rank<r>.pt.  A scenario that raises leaves its error in
DIR/SCENARIO.rank<r>.err and exits 3.  Not a test module: pytest
collects only ``test_*.py``.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from mpi_operator_tpu_torch.bootstrap import initialize_from_env  # noqa: E402
from mpi_operator_tpu_torch.models import llama as tl  # noqa: E402
from mpi_operator_tpu_torch.models.params import (init_params,  # noqa: E402
                                                  init_params_)
from mpi_operator_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from mpi_operator_tpu_torch.parallel import train as ttrain  # noqa: E402
from mpi_operator_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

LR = 3e-4
DEVICE = "cpu"          # "cuda" from the command line


def _loss(model, batch):
    return tl.next_token_loss(model(batch), batch)


def _rows(mesh, tokens):
    coord = mesh.get_coordinate()
    return tokens[tmesh.batch_rows(tuple(mesh.shape), coord, len(tokens))]


def _model(inputs):
    model = tl.LlamaModel(tl.llama2_tiny(**inputs["config"]),
                          device=None if DEVICE == "cuda" else "cpu",
                          store_dtype=torch.float32)
    model.load_state_dict(inputs["weights"])
    return model


def _full(state):
    """The full parameters, on every rank (a collective)."""
    from torch.distributed.tensor import DTensor
    return {n: (p.full_tensor() if isinstance(p, DTensor) else p).detach()
            .cpu().clone() for n, p in state.model.named_parameters()}


def _opt_bytes(state):
    from torch.distributed.tensor import DTensor
    total = 0
    for entry in state.optimizer.state.values():
        for v in entry.values():
            if torch.is_tensor(v) and v.dim():
                v = v.to_local() if isinstance(v, DTensor) else v
                total += v.numel() * v.element_size()
    return total


def _train(inputs, mesh_cfg, steps=3, specs=False, tokens=None, **build):
    mesh = tmesh.create_mesh(tmesh.MeshConfig(**mesh_cfg), DEVICE)
    cfg = tl.llama2_tiny(**inputs["config"])
    init, step = ttrain.build_train_step(
        _loss, ttrain.adamw(LR), mesh=mesh,
        param_specs=tl.llama_param_specs(cfg) if specs else None, **build)
    state = init(_model(inputs))
    batch = _rows(mesh, inputs["tokens"] if tokens is None else tokens).to(
        ttrain._mesh_device(mesh))
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return {"metrics": metrics, "params": _full(state),
            "opt_bytes": _opt_bytes(state),
            "mesh": tmesh.mesh_ranks(tmesh.MeshConfig(**mesh_cfg),
                                     dist.get_world_size()).tolist(),
            "mesh_seen": mesh.mesh.tolist(), "state": state, "step": step,
            "batch": batch}


def _strip(result):
    return {k: v for k, v in result.items()
            if k not in ("state", "step", "batch")}


def _checkpoint(inputs, out_dir, mesh_cfg, **build):
    """4 steps straight, against 2 steps, a save, a fresh state that
    restores it and 2 more steps; then a notice on rank 1 alone stops
    every rank at one step with a checkpoint."""
    straight = _train(inputs, mesh_cfg, steps=4, **build)["params"]
    run = _train(inputs, mesh_cfg, steps=2, **build)
    ckpt_dir = os.path.join(out_dir, "ckpt-" + "-".join(
        f"{k}{v}" for k, v in sorted(mesh_cfg.items())))
    mgr = tckpt.CheckpointManager(ckpt_dir, every=100)
    mgr.save(run["state"], 2)
    mgr.drain()
    fresh = _train(inputs, mesh_cfg, steps=0, **build)
    with torch.no_grad():                 # unlike the saved weights
        for p in fresh["state"].model.parameters():
            p.mul_(0.5)
    state = mgr.restore(fresh["state"])
    for _ in range(2):
        state, _ = fresh["step"](state, fresh["batch"])
    resumed = _full(state)
    notice = os.path.join(out_dir, f"notice-{'-'.join(map(str, mesh_cfg))}")
    if dist.get_rank() == 1:
        open(notice, "w").close()
    dist.barrier()
    mgr2 = tckpt.CheckpointManager(ckpt_dir + "-preempt", every=100)
    code = None
    try:
        ttrain.run_train_loop(
            state, fresh["step"], (fresh["batch"] for _ in range(3)),
            checkpoint_manager=mgr2, start_step=4, prefetch=0,
            preemption_file=notice if dist.get_rank() == 1 else
            notice + ".absent")
    except SystemExit as exc:
        code = exc.code
    dist.barrier()                        # rank 0's write has landed
    return {"straight": straight, "resumed": resumed, "exit_code": code,
            "written": tckpt.latest_steps(ckpt_dir),
            "preempt_written": tckpt.latest_steps(ckpt_dir + "-preempt")}


def scenario_world2(inputs, out_dir):
    cfg = tl.llama2_tiny(**inputs["config"])
    out = {}
    out["dp"] = _strip(_train(inputs, {"dp": 2}))
    out["fsdp"] = _strip(_train(inputs, {"dp": 1, "fsdp": 2}, specs=True))
    out["dp_zero"] = _strip(_train(inputs, {"dp": 2}, shard_update=True))
    out["dp_accum"] = _strip(_train(inputs, {"dp": 2}, accum_steps=2))
    out["fsdp_accum"] = _strip(_train(inputs, {"dp": 1, "fsdp": 2},
                                      specs=True, accum_steps=2))
    try:
        _train(inputs, {"dp": 2}, steps=1, accum_steps=3)
    except ValueError as exc:
        out["accum_error"] = str(exc)
    # Each rank fills only its shard of a model built on meta.
    mesh = tmesh.create_mesh(tmesh.MeshConfig(dp=1, fsdp=2), "cpu")
    init, _ = ttrain.build_train_step(_loss, ttrain.adamw(LR), mesh=mesh,
                                      param_specs=tl.llama_param_specs(cfg))
    state = init(tl.LlamaModel(cfg, device="meta", store_dtype=torch.float32),
                 init_weights=lambda m: init_params_(
                     m, torch.Generator().manual_seed(7)))
    out["sharded_init"] = {
        "local_numel": sum(p.to_local().numel()
                           for p in state.model.parameters()),
        "full": _full(state),
        "want": dict(init_params(cfg, torch.Generator().manual_seed(7),
                                 device="cpu",
                                 dtype=torch.float32).named_parameters())}
    out["ckpt_fsdp"] = _checkpoint(inputs, out_dir, {"dp": 1, "fsdp": 2},
                                   specs=True)
    out["ckpt_zero"] = _checkpoint(inputs, out_dir, {"dp": 2},
                                   shard_update=True)
    return out


def scenario_world4(inputs, out_dir):
    mesh = {"dp": 2, "fsdp": 2}
    out = {}
    for name, build in (("flat", {}),
                        ("hier", {"hierarchical_allreduce": True}),
                        ("hier_zero", {"hierarchical_allreduce": True,
                                       "shard_update": True}),
                        ("zero", {"shard_update": True})):
        out[name] = _strip(_train(inputs, mesh, **build))
    return out


def scenario_cuda_dp(inputs, out_dir):
    """dp = world on the cards, NCCL."""
    return {"dp": _strip(_train(inputs, {"dp": dist.get_world_size()})),
            "backend": dist.get_backend()}


def scenario_init(inputs, out_dir):
    """The group formed (the test starts rank 0 late); one all-reduce,
    and the distributed_init span."""
    from mpi_operator_tpu_torch.telemetry.trace import default_tracer
    t = torch.tensor([dist.get_rank() + 1.0])
    dist.all_reduce(t)
    spans = [e for e in default_tracer().events()
             if e["name"] == "distributed_init"]
    return {"sum": t.item(), "spans": spans, "backend": dist.get_backend(),
            "world": dist.get_world_size()}


# -- tensor parallelism (tests/test_torch_tensor_parallel.py) -----------------

TP_PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7]]      # tests/test_serving.py:133


def _tp_mesh(**axes):
    return tmesh.create_mesh(tmesh.MeshConfig(**{"dp": 1, **axes}), DEVICE)


def _tp_model(inputs, name, mesh):
    from mpi_operator_tpu_torch.models.params import shard_state_dict
    preset, kw, weights = inputs["models"][name]
    cfg = getattr(tl, preset)(**kw)
    model = tl.LlamaModel(cfg, device=None if DEVICE == "cuda" else "cpu",
                          store_dtype=torch.float32, mesh=mesh)
    model.load_state_dict(shard_state_dict(weights, cfg, model.tp))
    return model


def _tp_full(state):
    """The full parameters (over fsdp, then tp), on every rank."""
    from torch.distributed.tensor import DTensor

    from mpi_operator_tpu_torch.models.params import gather_state_dict
    local = {n: (p.full_tensor() if isinstance(p, DTensor) else p).detach()
             for n, p in state.model.named_parameters()}
    return {n: t.cpu().clone() for n, t in gather_state_dict(
        local, state.model.config, state.model.tp).items()}


def _tp_train(inputs, mesh, steps=3, **build):
    cfg = tl.llama2_tiny()
    init, step = ttrain.build_train_step(
        _loss, ttrain.adamw(LR), mesh=mesh,
        param_specs=tl.llama_param_specs(cfg), **build)
    state = init(_tp_model(inputs, "dense", mesh))
    batch = _rows(mesh, inputs["tokens"]).to(ttrain._mesh_device(mesh))
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return {"metrics": metrics, "state": state, "step": step,
            "batch": batch}


def _tp_checkpoint(inputs, out_dir, mesh, tag):
    """2 steps, a save, 2 more steps of the saved state, and a fresh
    state that restores the save and takes 2 steps: both against 4
    straight steps; the checkpoint holds the one-device format."""
    straight = _tp_full(_tp_train(inputs, mesh, steps=4)["state"])
    run = _tp_train(inputs, mesh, steps=2)
    mgr = tckpt.CheckpointManager(os.path.join(out_dir, "ckpt-" + tag),
                                  every=100)
    mgr.save(run["state"], 2)
    mgr.drain()
    state = run["state"]
    for _ in range(2):                    # the saved state goes on
        state, _ = run["step"](state, run["batch"])
    continued = _tp_full(state)
    fresh = _tp_train(inputs, mesh, steps=0)
    with torch.no_grad():
        for p in fresh["state"].model.parameters():
            p.mul_(0.5)
    state = mgr.restore(fresh["state"])
    for _ in range(2):
        state, _ = fresh["step"](state, fresh["batch"])
    resumed = _tp_full(state)
    saved = None
    if dist.get_rank() == 0:
        payload = torch.load(os.path.join(tckpt._step_dir(os.path.join(
            out_dir, "ckpt-" + tag), 2), tckpt.STATE_FILE),
            weights_only=True)
        saved = {k: tuple(v.shape) for k, v in payload["model"].items()}
        saved.update({f"optimizer/{k}": tuple(v["exp_avg"].shape)
                      for k, v in payload["optimizer"]["state"].items()})
    return {"straight": straight, "continued": continued,
            "resumed": resumed, "saved_shapes": saved}


def _tp_serving(inputs, mesh, whole=False):
    """Greedy prompts one by one and as one multi-row request, sampled
    streams (twice alone, once beside neighbours), concurrent == alone;
    ``whole`` hands the server the one-card model to cut."""
    import threading

    from mpi_operator_tpu_torch.serving import InferenceServer
    if whole:
        model = _tp_model(inputs, "dense", None)
    else:
        model = _tp_model(inputs, "dense", mesh)
    server = InferenceServer(model, mesh=mesh, max_batch_slots=4,
                             kv_page_size=16, device=model.device,
                             tp_timeout_s=60).start()
    out = {"pool_heads": server._batcher._cache["layers_0"]["attention"][
        "pool_key"].shape[2]}
    if not server.is_leader:
        server.join(timeout=240)
        server.stop()
        return out
    try:
        out["single"] = [server.generate([p], 5)[0] for p in TP_PROMPTS]
        out["multi"] = server.generate(TP_PROMPTS, 5)
        long = [list(range(1 + i, 40 + 7 * i)) for i in range(4)]
        out["alone"] = [server.generate([p], 8)[0] for p in long]
        got = [None] * len(long)

        def run(i):
            got[i] = server.generate([long[i]], 8)[0]

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(long))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        out["concurrent"] = got
        kw = dict(temperature=0.9, top_p=0.9, seed=11)
        out["sampled"] = [server.generate([long[0]], 8, **kw)[0]
                          for _ in range(2)]
        side = [None]
        t = threading.Thread(target=lambda: side.__setitem__(
            0, server.generate([long[1]], 8, temperature=0.7, seed=3)))
        t.start()
        out["sampled_beside"] = server.generate([long[0]], 8, **kw)[0]
        t.join(120)
    finally:
        server.stop()
    return out


def _tp_extras(inputs, mesh):
    """What tp serving takes without code of its own: int8 weights (the
    rank's quantized shard against the one-card int8 state dict cut up)
    and a server with chunked prefill and prompt-lookup speculation."""
    from mpi_operator_tpu_torch.models.params import shard_state_dict
    from mpi_operator_tpu_torch.models.quant import (quantize_model,
                                                     quantize_params)
    from mpi_operator_tpu_torch.serving import InferenceServer
    model = _tp_model(inputs, "dense", mesh)
    qcfg = tl.llama2_tiny(weight_dtype="int8")
    want = shard_state_dict(quantize_params(inputs["models"]["dense"][2],
                                            qcfg), qcfg, model.tp)
    got = quantize_model(model).state_dict()
    out = {"int8_equal": set(got) == set(want) and all(
        torch.equal(got[k], want[k]) for k in want)}
    server = InferenceServer(model, mesh=mesh, max_batch_slots=4,
                             kv_page_size=16, kv_prefill_chunk=2,
                             draft_strategy="prompt_lookup", device="cpu",
                             tp_timeout_s=60).start()
    if not server.is_leader:
        server.join(timeout=240)
        server.stop()
        return out
    try:
        out["chunked_spec"] = [server.generate([p], 5)[0]
                               for p in TP_PROMPTS]
        out["spec_stats"] = server.batcher_stats()["spec"]
    finally:
        server.stop()
    return out


def scenario_tp_world2(inputs, out_dir):
    """tp = 2: the shards at init, logits, serving, fused xent, three
    steps, a checkpoint."""
    from mpi_operator_tpu_torch.models.params import init_params
    from mpi_operator_tpu_torch.ops.fused_xent import fused_softmax_xent
    from mpi_operator_tpu_torch.parallel.tensor import TensorParallel
    mesh = _tp_mesh(tp=2)
    out = {"init": {n: p.detach().clone() for n, p in init_params(
        tl.llama2_tiny(), torch.Generator().manual_seed(7), device="cpu",
        mesh=mesh).named_parameters()}}
    out["logits"] = {name: _tp_model(inputs, name, mesh)(
        inputs["tokens"]).detach() for name in inputs["models"]}
    out["serving"] = _tp_serving(inputs, mesh)
    out["serving_whole"] = _tp_serving(inputs, mesh, whole=True).get(
        "single")
    out["extras"] = _tp_extras(inputs, mesh)
    # The vocab-parallel fused loss against the unsharded one (value and
    # input gradient), on every rank.
    tp = TensorParallel.of(mesh)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(32, 16, generator=gen)
    w = torch.randn(16, 128, generator=gen) * 0.2
    t = torch.randint(0, 128, (32,), generator=gen)
    xs, xf = x.clone().requires_grad_(), x.clone().requires_grad_()
    sharded = fused_softmax_xent(xs, tp.chunk(w, 1), t, 32, tp=tp)
    whole = fused_softmax_xent(xf, w, t, 32)
    sharded.backward()
    whole.backward()
    out["xent"] = (sharded.item(), whole.item(),
                   (xs.grad - xf.grad).abs().max().item())
    run = _tp_train(inputs, mesh)
    out["train"] = {"metrics": run["metrics"],
                    "params": _tp_full(run["state"])}
    out["ckpt"] = _tp_checkpoint(inputs, out_dir, mesh, "tp2")
    return out


def scenario_tp_world4(inputs, out_dir):
    """fsdp = 2 x tp = 2: three steps and a checkpoint; tp = 4 serving."""
    mesh = _tp_mesh(fsdp=2, tp=2)
    run = _tp_train(inputs, mesh)
    out = {"train": {"metrics": run["metrics"],
                     "params": _tp_full(run["state"])},
           "ckpt": _tp_checkpoint(inputs, out_dir, mesh, "fsdp2tp2")}
    out["serving4"] = _tp_serving(inputs, _tp_mesh(tp=4))
    zero = _tp_train(inputs, _tp_mesh(dp=2, tp=2), shard_update=True)
    out["dp_zero"] = {"metrics": zero["metrics"],
                      "params": _tp_full(zero["state"])}
    return out


def _tp_fault(inputs, planted):
    """A tp = 2 server whose rank 1 carries ``planted``; rank 0 asks for
    a generation.  Every rank must end in an error."""
    from mpi_operator_tpu_torch.serving import InferenceServer
    mesh = _tp_mesh(tp=2)
    server = InferenceServer(_tp_model(inputs, "dense", mesh), mesh=mesh,
                             max_batch_slots=2, kv_page_size=16,
                             device="cpu", tp_timeout_s=4).start()
    if dist.get_rank() == 1:
        planted(server._batcher)
        server.join(timeout=120)
        return {"error": None}
    try:
        server.generate([list(range(1, 30))], 24)
    finally:
        server.stop()
    return {"error": None}


def scenario_tp_fault_skip(inputs, out_dir):
    """Rank 1 misses one exchange once it is decoding."""
    def planted(batcher):
        mirror, real = batcher._mirror, batcher._mirror.exchange

        def exchange(ticks, decisions=None, fatal=None):
            if ticks >= 2 and not getattr(mirror, "skipped", False):
                mirror.skipped = True
                mirror.turns += 1
                return {"stop": False, "new": [], "cancel": []}
            return real(ticks, decisions, fatal)
        mirror.exchange = exchange
    return _tp_fault(inputs, planted)


def scenario_tp_fault_raise(inputs, out_dir):
    """Rank 1 raises in its third token fetch."""
    def planted(batcher):
        real, calls = batcher._fetch, [0]

        def fetch(out, done):
            calls[0] += 1
            if calls[0] == 3:
                raise RuntimeError("planted fault in rank 1's fetch")
            return real(out, done)
        batcher._fetch = fetch
    return _tp_fault(inputs, planted)


def scenario_tp_cuda_serving(inputs, out_dir):
    """tp = 2 on the cards: llama2_tiny in bf16 from a seed, served with
    the paged pool; rank 0 also takes the one-card model's prefill logits
    and streams (before the group's server starts).  Each rank counts its
    K4' launches and decode steps."""
    from mpi_operator_tpu_torch.models.params import init_params
    from mpi_operator_tpu_torch.ops import paged_attention as pa
    from mpi_operator_tpu_torch.serving import (ContinuousBatcher,
                                                InferenceServer)
    cfg = tl.llama2_tiny(dtype=torch.bfloat16, **inputs["config"])
    prompts = inputs["prompts"]
    out = {}
    if dist.get_rank() == 0:
        one = init_params(cfg, torch.Generator("cuda").manual_seed(5),
                          device="cuda")
        ref = ContinuousBatcher(one, max_slots=4, page_size=16,
                                prefix_cache=False, device="cuda")
        out["one_logits"] = torch.stack(
            [ref.prefill_logits(p) for p in prompts]).float().cpu()
        ref.start()
        out["one_streams"] = [ref.submit(p, 12) for p in prompts]
        ref.stop()
        del ref, one
    mesh = _tp_mesh(tp=2)
    model = init_params(cfg, torch.Generator("cuda").manual_seed(5),
                        device="cuda", mesh=mesh)
    server = InferenceServer(model, mesh=mesh, max_batch_slots=4,
                             kv_page_size=16, kv_prefix_cache=False,
                             device="cuda")
    logits = torch.stack([server._batcher.prefill_logits(p)
                          for p in prompts]).float().cpu()
    pa.LAUNCHES = 0
    server.start()
    if server.is_leader:
        try:
            out["streams"] = [server.generate([p], 12)[0] for p in prompts]
        finally:
            server.stop()
    else:
        server.join(timeout=240)
        server.stop()
    torch.cuda.synchronize()
    out.update(logits=logits, launches=pa.LAUNCHES,
               steps=server.telemetry["dispatches_total"].value,
               n_layers=cfg.n_layers, backend=dist.get_backend())
    return out


def main() -> int:
    global DEVICE
    scenario, out_dir = sys.argv[1], sys.argv[2]
    DEVICE = sys.argv[3] if len(sys.argv) > 3 else "cpu"
    torch.set_num_threads(1)
    t0 = time.time()
    initialize_from_env(
        timeout_seconds=60, device=None if DEVICE == "cuda" else "cpu",
        collective_timeout_seconds=(10 if scenario.startswith("tp_fault")
                                    else None))
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"))
    try:
        result = globals()[f"scenario_{scenario}"](inputs, out_dir)
    except Exception as exc:
        with open(os.path.join(out_dir, f"{scenario}.rank"
                               f"{dist.get_rank()}.err"), "w") as f:
            f.write(f"{type(exc).__name__}: {exc}")
        raise SystemExit(3)
    result["seconds"] = time.time() - t0
    torch.save(result, os.path.join(
        out_dir, f"{scenario}.rank{dist.get_rank()}.pt"))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
