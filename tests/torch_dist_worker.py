"""One rank of a gloo process group for tests/test_torch_distributed.py,
tests/test_torch_tensor_parallel.py, tests/test_torch_ring_attention.py,
tests/test_torch_expert_parallel.py, tests/test_torch_pipeline.py,
tests/test_torch_moe_pipeline.py, tests/test_torch_resnet.py,
tests/test_torch_ckpt_resharded.py and tests/test_torch_kv_transfer_tp.py.

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
    """4 steps straight, against 2 steps, a save and 2 more steps of the
    saved state, and against a fresh state that restores the save and
    takes 2 more steps; then a notice on rank 1 alone stops every rank at
    one step with a checkpoint."""
    straight = _train(inputs, mesh_cfg, steps=4, **build)["params"]
    run = _train(inputs, mesh_cfg, steps=2, **build)
    ckpt_dir = os.path.join(out_dir, "ckpt-" + "-".join(
        f"{k}{v}" for k, v in sorted(mesh_cfg.items())))
    mgr = tckpt.CheckpointManager(ckpt_dir, every=100)
    mgr.save(run["state"], 2)
    mgr.drain()
    state = run["state"]
    for _ in range(2):                    # the saved state goes on
        state, _ = run["step"](state, run["batch"])
    continued = _full(state)
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
    return {"straight": straight, "resumed": resumed,
            "continued": continued, "exit_code": code,
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


def _tp_model(inputs, name, mesh, serving=False):
    """This rank's shard of ``inputs``' model ``name``; with ``serving``
    and fsdp > 1 in the mesh, the serving model's fsdp shard."""
    from mpi_operator_tpu_torch.models.params import shard_state_dict
    preset, kw, weights = inputs["models"][name]
    cfg = getattr(tl, preset)(**kw)
    model = tl.LlamaModel(cfg, device=None if DEVICE == "cuda" else "cpu",
                          store_dtype=torch.float32, mesh=mesh,
                          serving=serving)
    fs = model.fsdp_serve
    model.load_state_dict(shard_state_dict(weights, cfg, model.tp,
                                           model.ep,
                                           None if fs is None else fs.par))
    return model


def _holdings(model):
    """What this rank holds of a serving model: its state dict and the
    shape of every tensor it registers (parameters and buffers)."""
    import itertools
    return {"state": {k: v.detach().clone()
                      for k, v in model.state_dict().items()},
            "shapes": {n: tuple(t.shape) for n, t in itertools.chain(
                model.named_parameters(), model.named_buffers())}}


def _tp_full(state):
    """The full parameters (over fsdp, then tp and ep), on every rank."""
    from torch.distributed.tensor import DTensor

    from mpi_operator_tpu_torch.models.params import gather_state_dict
    local = {n: (p.full_tensor() if isinstance(p, DTensor) else p).detach()
             for n, p in state.model.named_parameters()}
    return {n: t.cpu().clone() for n, t in gather_state_dict(
        local, state.model.config, state.model.tp,
        state.model.ep).items()}


def _tp_train(inputs, mesh, steps=3, name="dense", **build):
    preset, kw, _ = inputs["models"][name]
    cfg = getattr(tl, preset)(**kw)
    init, step = ttrain.build_train_step(
        _loss, ttrain.adamw(LR), mesh=mesh,
        param_specs=tl.llama_param_specs(cfg), **build)
    state = init(_tp_model(inputs, name, mesh))
    batch = _rows(mesh, inputs["tokens"]).to(ttrain._mesh_device(mesh))
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return {"metrics": metrics, "state": state, "step": step,
            "batch": batch}


def _tp_checkpoint(inputs, out_dir, mesh, tag, name="dense"):
    """2 steps, a save, 2 more steps of the saved state, and a fresh
    state that restores the save and takes 2 steps: both against 4
    straight steps; the checkpoint holds the one-device format."""
    straight = _tp_full(_tp_train(inputs, mesh, steps=4, name=name)["state"])
    run = _tp_train(inputs, mesh, steps=2, name=name)
    mgr = tckpt.CheckpointManager(os.path.join(out_dir, "ckpt-" + tag),
                                  every=100)
    mgr.save(run["state"], 2)
    mgr.drain()
    state = run["state"]
    for _ in range(2):                    # the saved state goes on
        state, _ = run["step"](state, run["batch"])
    continued = _tp_full(state)
    fresh = _tp_train(inputs, mesh, steps=0, name=name)
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


def _tp_serving(inputs, mesh, whole=False, light=False, name="dense"):
    """Greedy prompts one by one and as one multi-row request, sampled
    streams (twice alone, once beside neighbours), concurrent == alone;
    ``whole`` hands the server the one-card model to cut, ``light``
    stops after the greedy prompts one by one."""
    import threading

    from mpi_operator_tpu_torch.serving import InferenceServer
    if whole:
        model = _tp_model(inputs, name, None)
    else:
        model = _tp_model(inputs, name, mesh, serving=True)
    server = InferenceServer(model, mesh=mesh, max_batch_slots=4,
                             kv_page_size=16, device=model.device,
                             tp_timeout_s=60).start()
    out = {"pool_heads": server._batcher._cache["layers_0"]["attention"][
        "pool_key"].shape[2]}
    if server.model.fsdp_serve is not None and not light:
        out["holdings"] = _holdings(server.model)
    if not server.is_leader:
        server.join(timeout=240)
        server.stop()
        return out
    try:
        out["single"] = [server.generate([p], 5)[0] for p in TP_PROMPTS]
        if light:
            return out
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


def _tp_extras(inputs, mesh, self_draft=False):
    """What serving over a mesh takes without code of its own: int8
    weights (the rank's quantized shard against the one-card int8 state
    dict cut up) and a server with chunked prefill and prompt-lookup
    speculation; ``self_draft`` adds a server whose draft is the model
    itself and one that quantizes it (``weight_dtype="int8"``)."""
    from mpi_operator_tpu_torch.models.params import shard_state_dict
    from mpi_operator_tpu_torch.models.quant import (quantize_model,
                                                     quantize_params)
    from mpi_operator_tpu_torch.serving import InferenceServer
    model = _tp_model(inputs, "dense", mesh, serving=True)
    fs = model.fsdp_serve
    qcfg = tl.llama2_tiny(weight_dtype="int8")
    want = shard_state_dict(quantize_params(inputs["models"]["dense"][2],
                                            qcfg), qcfg, model.tp,
                            fsdp=None if fs is None else fs.par)
    qmodel = quantize_model(model)
    got = qmodel.state_dict()
    out = {"int8_equal": set(got) == set(want) and all(
        torch.equal(got[k], want[k]) for k in want)}
    if fs is not None:
        out["int8_holdings"] = _holdings(qmodel)
    del qmodel
    servers = [("chunked_spec", dict(kv_prefill_chunk=2,
                                     draft_strategy="prompt_lookup"))]
    if self_draft:
        servers += [("self_draft", dict(draft_model=model)),
                    ("int8", dict(weight_dtype="int8"))]
    for key, kw in servers:
        server = InferenceServer(model, mesh=mesh, max_batch_slots=4,
                                 kv_page_size=16, device="cpu",
                                 tp_timeout_s=60, **kw).start()
        if not server.is_leader:
            server.join(timeout=240)
            server.stop()
            continue
        try:
            out[key] = [server.generate([p], 5)[0] for p in TP_PROMPTS]
            out[key + "_stats"] = server.batcher_stats()["spec"]
        finally:
            server.stop()
    out["spec_stats"] = out.get("chunked_spec_stats")
    return out


def _fsdp_moe(inputs, mesh):
    """mixtral_tiny served at fsdp: the no-cache forward's logits
    (capacity drops over one copy of the batch) and greedy tokens."""
    model = _tp_model(inputs, "moe", mesh, serving=True)
    with torch.inference_mode():
        logits = model(inputs["tokens"]).detach()
    out = _tp_serving(inputs, mesh, light=True, name="moe")
    out["logits"] = logits
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
    # fsdp = 2 serving (tp = 1): the dense model, and mixtral_tiny.
    fsdp = _tp_mesh(fsdp=2)
    out["fsdp_serving"] = _tp_serving(inputs, fsdp)
    out["fsdp_moe"] = _fsdp_moe(inputs, fsdp)
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
    """fsdp = 2 x tp = 2: three steps and a checkpoint, and serving (the
    weights cut over fsdp too: a whole model cut by the server, int8,
    chunked prefill, speculation); tp = 4 serving."""
    mesh = _tp_mesh(fsdp=2, tp=2)
    run = _tp_train(inputs, mesh)
    out = {"train": {"metrics": run["metrics"],
                     "params": _tp_full(run["state"])},
           "ckpt": _tp_checkpoint(inputs, out_dir, mesh, "fsdp2tp2")}
    out["fsdp_init"] = {k: v.clone() for k, v in init_params(
        tl.llama2_tiny(), torch.Generator().manual_seed(7), device="cpu",
        mesh=mesh).state_dict().items()}
    out["fsdp_tp_serving"] = _tp_serving(inputs, mesh)
    out["fsdp_tp_whole"] = _tp_serving(inputs, mesh, whole=True,
                                       light=True).get("single")
    out["fsdp_tp_extras"] = _tp_extras(inputs, mesh, self_draft=True)
    out["serving4"] = _tp_serving(inputs, _tp_mesh(tp=4))
    zero = _tp_train(inputs, _tp_mesh(dp=2, tp=2), shard_update=True)
    out["dp_zero"] = {"metrics": zero["metrics"],
                      "params": _tp_full(zero["state"])}
    return out


def _tp_fault(inputs, planted, axes=None):
    """A server over two ranks (tp = 2, or ``axes``) whose rank 1 carries
    ``planted``; rank 0 asks for a generation.  Every rank must end in
    an error."""
    from mpi_operator_tpu_torch.serving import InferenceServer
    mesh = _tp_mesh(**(axes or {"tp": 2}))
    server = InferenceServer(_tp_model(inputs, "dense", mesh, serving=True),
                             mesh=mesh,
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


def _skip_a_turn(batcher):
    """Planted in rank 1: it misses one exchange once it is decoding."""
    mirror, real = batcher._mirror, batcher._mirror.exchange

    def exchange(ticks, decisions=None, fatal=None):
        if ticks >= 2 and not getattr(mirror, "skipped", False):
            mirror.skipped = True
            mirror.turns += 1
            return {"stop": False, "new": [], "cancel": []}
        return real(ticks, decisions, fatal)
    mirror.exchange = exchange


def scenario_tp_fault_skip(inputs, out_dir):
    """Rank 1 misses one exchange once it is decoding."""
    return _tp_fault(inputs, _skip_a_turn)


def scenario_fsdp_fault_skip(inputs, out_dir):
    """At fsdp = 2 (tp = 1): rank 1 misses one exchange once it is
    decoding."""
    return _tp_fault(inputs, _skip_a_turn, {"fsdp": 2})


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


def scenario_fsdp_cuda_gather(inputs, out_dir):
    """fsdp = 2 on the cards: llama2_tiny in bf16 from a seed, each
    rank's weights cut flat over fsdp.  Each unit gathered over NCCL
    against the plain cut of the one-card weights (the same draws on each
    rank), the prefill logits against the one-card model's, and a served
    stream against one card's with K4' launches == decode steps x
    n_layers."""
    from mpi_operator_tpu_torch.models.params import (init_params,
                                                      shard_state_dict)
    from mpi_operator_tpu_torch.ops import paged_attention as pa
    from mpi_operator_tpu_torch.serving import (ContinuousBatcher,
                                                InferenceServer)
    cfg = tl.llama2_tiny(dtype=torch.bfloat16, **inputs["config"])
    prompts = inputs["prompts"]
    one = init_params(cfg, torch.Generator("cuda").manual_seed(5),
                      device="cuda")
    ref = ContinuousBatcher(one, max_slots=4, page_size=16,
                            prefix_cache=False, device="cuda")
    out = {"one_logits": torch.stack([ref.prefill_logits(p)
                                      for p in prompts]).float().cpu()}
    ref.start()
    out["one_streams"] = [ref.submit(p, 12) for p in prompts]
    ref.stop()
    mesh = _tp_mesh(fsdp=2)
    model = init_params(cfg, torch.Generator("cuda").manual_seed(5),
                        device="cuda", mesh=mesh)
    plain = shard_state_dict(one.state_dict(), cfg, model.tp)
    fs = model.fsdp_serve
    out["units_equal"] = all(
        torch.equal(t, plain[name]) for unit in fs.order
        for name, t in fs.gathered(unit).items())
    out["units"] = len(fs.order)
    # The gathers timed by CUDA events on the stream they run on.
    real, spans = fs._all_gather, []

    def timed(buf, shard):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        real(buf, shard)
        end.record()
        spans.append((start, end))
    fs._all_gather = timed
    server = InferenceServer(model, mesh=mesh, max_batch_slots=4,
                             kv_page_size=16, kv_prefix_cache=False,
                             device="cuda")
    out["logits"] = torch.stack([server._batcher.prefill_logits(p)
                                 for p in prompts]).float().cpu()
    fs._all_gather = real
    torch.cuda.synchronize()
    out["gather_ms"] = sum(a.elapsed_time(b) for a, b in spans)
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
    out.update(launches=pa.LAUNCHES,
               steps=server.telemetry["dispatches_total"].value,
               n_layers=cfg.n_layers, backend=dist.get_backend())
    return out


# -- sequence and expert parallelism (tests/test_torch_ring_attention.py,
# -- tests/test_torch_expert_parallel.py) ------------------------------------

def _cols(mesh, t):
    """This rank's token columns of [B, S, ...] (parallel.mesh.seq_cols)."""
    return t[:, tmesh.seq_cols(tuple(mesh.shape), mesh.get_coordinate(),
                               t.shape[1])]


def _sp_loss(model, batch):
    return tl.next_token_loss(model(batch), batch, sp=model.sp)


def _sp_fused_loss(model, batch):
    from mpi_operator_tpu_torch.ops.fused_xent import fused_next_token_loss
    hidden = model(batch, return_hidden=True)
    return fused_next_token_loss(hidden, model.output.weight.t(), batch,
                                 chunk=64, tp=model.tp, sp=model.sp)


def _ring(inputs, mesh, causal, impl):
    """ring_attention on this rank's columns of the test's q, k, v, and
    the gradients of sum(out * dout) over every rank."""
    from mpi_operator_tpu_torch.ops.ring_attention import ring_attention
    q, k, v, dout = (_cols(mesh, t) for t in inputs["ring"])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ring_attention(*leaves, mesh, causal=causal, impl=impl)
    (out * dout).sum().backward()
    return {"out": out.detach(), "grads": [t.grad for t in leaves]}


def _sp_train(inputs, mesh, loss=_sp_loss, steps=3, config=None, **build):
    """llama2_tiny from the test's weights, ``steps`` AdamW steps on this
    rank's rows and columns of the token batch."""
    cfg = tl.llama2_tiny(**(config or {}))
    init, step = ttrain.build_train_step(
        loss, ttrain.adamw(LR), mesh=mesh,
        param_specs=tl.llama_param_specs(cfg), **build)
    model = tl.LlamaModel(cfg, device=None if DEVICE == "cuda" else "cpu",
                          store_dtype=torch.float32, mesh=mesh)
    model.load_state_dict(inputs["weights"])
    state = init(model)
    batch = _cols(mesh, _rows(mesh, inputs["tokens"])).to(
        ttrain._mesh_device(mesh))
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return {"metrics": metrics, "params": _full(state)}


def scenario_sp_world2(inputs, out_dir):
    """sp = 2: the ring (causal or not, dense and flash, and through
    attention(mesh=)), three steps with the plain loss, the fused loss
    and under remat, the batch iterator's columns."""
    from mpi_operator_tpu_torch.utils.data import global_batch_iterator
    from mpi_operator_tpu_torch.ops.attention import attention
    mesh = _tp_mesh(sp=2)
    out = {"ring": {f"{causal}-{impl}": _ring(inputs, mesh, causal, impl)
                    for causal in (True, False)
                    for impl in ("dense", "flash")}}
    q, k, v, _ = (_cols(mesh, t) for t in inputs["ring"])
    out["attention"] = {impl: attention(q, k, v, mesh=mesh, impl=impl)
                        for impl in ("auto", "xla")}
    out["train"] = _sp_train(inputs, mesh)
    out["fused"] = _sp_train(inputs, mesh, loss=_sp_fused_loss)
    out["remat"] = _sp_train(inputs, mesh, remat=True)
    rows = _rows(mesh, inputs["tokens"])
    (got,) = next(global_batch_iterator(lambda step: (rows.numpy(),), mesh,
                                        "cpu"))
    out["iterator"] = {"got": got, "want": _cols(mesh, rows)}
    return out


def scenario_sp_world4(inputs, out_dir):
    """sp = 4: the ring and the model's logits; fsdp = 2 x sp = 2: three
    steps through FSDP2 with the ring on its flash route."""
    mesh = _tp_mesh(sp=4)
    out = {"ring": {f"True-{impl}": _ring(inputs, mesh, True, impl)
                    for impl in ("dense", "flash")}}
    model = tl.LlamaModel(tl.llama2_tiny(), device="cpu",
                          store_dtype=torch.float32, mesh=mesh)
    model.load_state_dict(inputs["weights"])
    with torch.no_grad():
        out["logits"] = model(_cols(mesh, inputs["llama_tokens"]))
    out["train"] = _sp_train(inputs, _tp_mesh(fsdp=2, sp=2),
                             config={"ring_impl": "flash"})
    return out


def scenario_ep_world2(inputs, out_dir):
    """mixtral_tiny at ep = 2: the shards at init, logits, three steps,
    a checkpoint."""
    from mpi_operator_tpu_torch.models.params import init_params
    mesh = _tp_mesh(ep=2)
    model = _tp_model(inputs, "moe", mesh)
    out = {"experts": model.layers[0].feed_forward.w1.shape[0],
           "init": {n: p.detach().clone() for n, p in init_params(
               tl.mixtral_tiny(), torch.Generator().manual_seed(7),
               device="cpu", mesh=mesh).named_parameters()}}
    with torch.no_grad():
        out["logits"] = model(inputs["tokens"])
    run = _tp_train(inputs, mesh, name="moe")
    out["train"] = {"metrics": run["metrics"],
                    "params": _tp_full(run["state"])}
    out["ckpt"] = _tp_checkpoint(inputs, out_dir, mesh, "ep2", name="moe")
    return out


class _MLP(torch.nn.Module):
    """tests/test_elastic.py's model: two matmuls."""

    def __init__(self, device=None):
        super().__init__()
        self.w1 = torch.nn.Parameter(torch.empty(8, 16, device=device))
        self.w2 = torch.nn.Parameter(torch.empty(16, 4, device=device))


def _mlp_loss(model, batch):
    x, y = batch
    return (((x @ model.w1) @ model.w2 - y) ** 2).mean()


def _adam(params):
    return torch.optim.Adam(params, lr=1e-2)


def _reshard_run(inputs, meshes, switch_at):
    """tests/test_elastic.py's run over ``meshes`` (built by every rank):
    ZeRO Adam steps over the test's batches, the state moved onto the
    second mesh before batch ``switch_at``; the final state_dict on the
    members of the last mesh."""
    def member(mesh):
        return mesh.get_coordinate() is not None

    mesh, state, step = meshes[0], None, None
    if member(mesh):
        init, step = ttrain.build_train_step(_mlp_loss, _adam, mesh=mesh,
                                             shard_update=True)
        model = _MLP()
        model.load_state_dict(inputs["mlp"])
        state = init(model)
    steps_at_switch = None
    for i, (x, y) in enumerate(inputs["mlp_batches"]):
        if i == switch_at and len(meshes) > 1:
            mesh = meshes[1]
            state = ttrain.reshard_train_state(
                state, mesh, shard_update=True,
                model=_MLP(device="meta") if member(mesh) else None)
            if state is not None:
                steps_at_switch = state.step
                _, step = ttrain.build_train_step(
                    _mlp_loss, _adam, mesh=mesh, shard_update=True)
        if state is not None:
            state, _ = step(state, (_rows(mesh, x), _rows(mesh, y)))
    if state is None:
        return None
    return {"state": state.state_dict(), "steps_at_switch": steps_at_switch}


def _moe_layer(inputs, mesh):
    """One MoEMLP on ``mesh`` at the test's capacity factor, fed this
    rank's rows and columns of the global input; its output, the
    gradient of its input and the router's gradient."""
    from mpi_operator_tpu_torch.ops.moe import MoEMLP
    case = inputs["moe_layer"]
    w = case["weights"]
    e, d, f = w["w1"].shape
    layer = MoEMLP(d, f, e, capacity_factor=case["capacity_factor"],
                   dtype=torch.float32, mesh=mesh, device="cpu")
    layer.load_state_dict({n: layer.ep.chunk(t, 0 if n != "router.weight"
                                             else None)
                           for n, t in w.items()})
    shape, coord = tuple(mesh.shape), mesh.get_coordinate()
    rows = tmesh.batch_rows(shape, coord, len(case["x"]))
    cols = tmesh.seq_cols(shape, coord, case["x"].shape[1])
    x, g = (t[rows, cols] for t in (case["x"], case["g"]))
    x = x.clone().requires_grad_()
    out = layer(x)
    (out * g).sum().backward()
    return {"rows": rows, "cols": cols, "ep": layer.ep.size,
            "out": out.detach(), "x_grad": x.grad,
            "router_grad": layer.router.weight.grad}


def scenario_ep_world4(inputs, out_dir):
    """mixtral_tiny at ep = 2 x tp = 2 and fsdp = 2 x ep = 2; the live
    re-shard grown from two ranks to four and shrunk back, and one
    re-shard alone (pure data movement)."""
    run = _tp_train(inputs, _tp_mesh(ep=2, tp=2), name="moe")
    out = {"ep_tp": {"metrics": run["metrics"],
                     "params": _tp_full(run["state"])},
           "moe_layer": {"dp_sp": _moe_layer(inputs, _tp_mesh(dp=2, sp=2)),
                         "sp_ep": _moe_layer(inputs, _tp_mesh(sp=2, ep=2))}}
    run = _tp_train(inputs, _tp_mesh(fsdp=2, ep=2), name="moe")
    out["fsdp_ep"] = {"metrics": run["metrics"],
                      "params": _tp_full(run["state"])}
    small = tmesh.create_mesh(tmesh.MeshConfig(dp=1, fsdp=2), "cpu",
                              ranks=[0, 1])
    big = tmesh.create_mesh(tmesh.MeshConfig(dp=2, fsdp=2), "cpu")
    out["reshard"] = {"golden": _reshard_run(inputs, [big], None),
                      "grow": _reshard_run(inputs, [small, big], 3),
                      "shrink": _reshard_run(inputs, [big, small], 3)}
    # One move alone: two ranks' ZeRO state (after a step) onto four.
    two = tmesh.create_mesh(tmesh.MeshConfig(dp=2), "cpu", ranks=[0, 1])
    four = tmesh.create_mesh(tmesh.MeshConfig(dp=4), "cpu")
    state = before = None
    if two.get_coordinate() is not None:
        init, step = ttrain.build_train_step(_mlp_loss, _adam, mesh=two,
                                             shard_update=True)
        model = _MLP()
        model.load_state_dict(inputs["mlp"])
        x, y = inputs["mlp_batches"][0]
        state, _ = step(init(model), (_rows(two, x), _rows(two, y)))
        before = state.state_dict()
    moved = ttrain.reshard_train_state(state, four, shard_update=True,
                                       model=_MLP(device="meta"))
    out["moved"] = {"before": before, "after": moved.state_dict(),
                    "masters": len(moved.plan.masters)}
    # Across plans: the same state onto FSDP2 over dp = 2 x fsdp = 2 (its
    # optimizer state keyed by name), and from there onto one rank.
    specs = {"w1": ("fsdp", None), "w2": ("fsdp", None)}
    hsdp = tmesh.create_mesh(tmesh.MeshConfig(dp=2, fsdp=2), "cpu")
    one = tmesh.create_mesh(tmesh.MeshConfig(dp=1), "cpu", ranks=[0])
    sharded = ttrain.reshard_train_state(moved, hsdp, param_specs=specs,
                                         model=_MLP(device="meta"))
    sharded_sd = sharded.state_dict()
    back = ttrain.reshard_train_state(
        sharded, one, model=_MLP(device="meta") if dist.get_rank() == 0
        else None)
    out["across"] = {"plan": type(sharded.plan).__name__,
                     "sharded": sharded_sd,
                     "back": back.state_dict() if back is not None else None}
    return out


def scenario_sp_cuda_ring(inputs, out_dir):
    """sp = world on the cards: ring_attention with impl='flash' against
    the plain version of the same ring ('dense'), in bf16, with each
    kernel's launches counted over the flash run."""
    from mpi_operator_tpu_torch.ops import attention as fa
    mesh = _tp_mesh(sp=dist.get_world_size())
    gen = torch.Generator().manual_seed(11)
    shape = inputs["shape"]
    q, k, v, dout = (torch.randn(shape, generator=gen).to(torch.bfloat16)
                     for _ in range(4))
    inputs = {"ring": [t.cuda() for t in (q, k, v, dout)]}
    plain = _ring(inputs, mesh, True, "dense")
    torch.cuda.synchronize()
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    flash = _ring(inputs, mesh, True, "flash")
    torch.cuda.synchronize()
    return {"launches": dict(fa.LAUNCHES), "sp_rank":
            mesh.get_local_rank("sp"),
            "out": (flash["out"].float().cpu(), plain["out"].float().cpu()),
            "grads": [(a.float().cpu(), b.float().cpu()) for a, b in
                      zip(flash["grads"], plain["grads"])]}


# -- pipelines (tests/test_torch_pipeline.py) ------------------------------------

def _pp_mesh(**axes):
    return tmesh.create_mesh(tmesh.MeshConfig(**{"dp": 1, **axes}), DEVICE)


def _pp_model(inputs, moe=False):
    """The preset and the keys of the test's inputs: the 4-layer
    llama2_tiny ("pp_"), or with ``moe`` mixtral_tiny ("moe_")."""
    return (tl.mixtral_tiny, "moe") if moe else (tl.llama2_tiny, "pp")


def _pp_stage(inputs, mesh, virtual_stages=1, fsdp_shard=False, config=None,
              moe=False):
    """This rank's LlamaStage of the test's 4-layer llama2_tiny (or
    mixtral_tiny) weights."""
    from mpi_operator_tpu_torch.models.llama_pipeline import LlamaStage
    preset, key = _pp_model(inputs, moe)
    cfg = preset(**{**inputs[f"{key}_config"], **(config or {})})
    stage = LlamaStage(cfg, mesh=mesh, virtual_stages=virtual_stages,
                       fsdp_shard=fsdp_shard,
                       device=None if DEVICE == "cuda" else "cpu",
                       store_dtype=torch.float32)
    stage.load_full_state_dict(inputs[f"{key}_weights"])
    return stage


def _pp_mlp(inputs, n_stages):
    """pipeline_apply on tests/test_pipeline.py's MLP stages: the outputs
    and the gradients of mean(out ** 2) (this stage's, and the
    microbatches' on stage 0)."""
    from mpi_operator_tpu_torch.parallel.pipeline import pipeline_apply
    case = inputs["mlp"][n_stages]
    mesh = _pp_mesh(pp=n_stages)
    p = mesh.get_local_rank("pp")
    params = {k: v.clone().requires_grad_()
              for k, v in case["stages"][p].items()}
    micro = case["micro"].clone().requires_grad_(p == 0)

    def stage_fn(prm, x):
        return torch.tanh(x @ prm["w1"] + prm["b1"]) @ prm["w2"] + x

    out = pipeline_apply(stage_fn, params, micro, mesh)
    (out ** 2).mean().backward()
    return {"out": out.detach(), "stage": p,
            "grads": {k: v.grad for k, v in params.items()},
            "x_grad": micro.grad}


def _pp_1f1b(inputs, mesh, m, virtual_stages=1, fsdp_shard=False,
             moe=False, stage=None):
    """pipeline_loss_and_grads_1f1b on this rank's rows; the loss and
    every stage's gradients joined into the one-device dict."""
    from mpi_operator_tpu_torch.models.llama_pipeline import (
        pipeline_loss_and_grads_1f1b)
    from mpi_operator_tpu_torch.models.params import gather_stage_state_dict
    if stage is None:
        stage = _pp_stage(inputs, mesh, virtual_stages, fsdp_shard, moe=moe)
    key = _pp_model(inputs, moe)[1]
    loss, grads = pipeline_loss_and_grads_1f1b(
        stage, _rows(mesh, inputs[f"{key}_tokens"]), mesh, m,
        virtual_stages=virtual_stages, fsdp_shard=fsdp_shard)
    return {"loss": loss.item(), "grads": gather_stage_state_dict(
        stage, grads)}


def _pp_train(inputs, mesh, steps=3, moe=False, **build):
    """``steps`` AdamW steps of build_train_step over ``mesh``: metrics
    and the one-device parameters after."""
    from mpi_operator_tpu_torch.models.params import gather_stage_state_dict
    stage = _pp_stage(inputs, mesh, build.get("virtual_stages", 1),
                      build.get("pp_fsdp", False), moe=moe)
    init, step = ttrain.build_train_step(None, ttrain.adamw(LR), mesh=mesh,
                                         **build)
    state = init(stage)
    batch = _rows(mesh, inputs[f"{_pp_model(inputs, moe)[1]}_tokens"])
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return {"metrics": metrics, "state": state, "step": step,
            "batch": batch, "params": gather_stage_state_dict(state.model)}


def _pp_checkpoint(inputs, out_dir, mesh, **build):
    """4 steps straight, against 2 steps, a save (the one-device format)
    and a fresh state that restores it and takes 2 more."""
    from mpi_operator_tpu_torch.models.params import gather_stage_state_dict
    straight = _pp_train(inputs, mesh, steps=4, **build)["params"]
    run = _pp_train(inputs, mesh, steps=2, **build)
    ckpt_dir = os.path.join(out_dir, "ckpt-pp")
    mgr = tckpt.CheckpointManager(ckpt_dir, every=100)
    mgr.save(run["state"], 2)
    mgr.drain()
    dist.barrier()                        # rank 0's write has landed
    held = sorted(run["state"].state_dict())  # the whole on rank 0 alone
    fresh = _pp_train(inputs, mesh, steps=0, **build)
    with torch.no_grad():                 # unlike the saved weights
        for p in fresh["state"].model.parameters():
            p.mul_(0.5)
    state = mgr.restore(fresh["state"])
    for _ in range(2):
        state, _ = fresh["step"](state, fresh["batch"])
    saved = torch.load(os.path.join(ckpt_dir, "step_00000002",
                                    tckpt.STATE_FILE), weights_only=False)
    return {"straight": straight, "resumed": gather_stage_state_dict(
        state.model), "step": state.step, "held_keys": held,
        "saved_keys": sorted(saved["model"]),
        "saved_optimizer_entries": len(saved["optimizer"]["state"])}


def scenario_pp_world2(inputs, out_dir):
    """pp = 2: the MLP stages through pipeline_apply, the logits, 1F1B and
    interleaved 1F1B, three AdamW steps of gpipe and 1f1b, a checkpoint,
    the refusal of M < P and the batch iterator's rows."""
    from mpi_operator_tpu_torch.models.llama_pipeline import pipeline_forward
    from mpi_operator_tpu_torch.parallel.pipeline import pipeline_1f1b
    from mpi_operator_tpu_torch.utils.data import global_batch_iterator
    mesh = _pp_mesh(pp=2)
    out = {"mlp": _pp_mlp(inputs, 2)}
    with torch.no_grad():
        out["logits"] = pipeline_forward(_pp_stage(inputs, mesh),
                                         inputs["pp_tokens"], mesh, 2)
    out["1f1b"] = _pp_1f1b(inputs, mesh, 4)
    out["interleaved"] = _pp_1f1b(inputs, mesh, 4, virtual_stages=2)
    for name, build in (("gpipe", {"microbatches": 4}),
                        ("1f1b", {"pipeline_schedule": "1f1b",
                                  "microbatches": 4})):
        out[f"steps_{name}"] = _strip(_pp_train(inputs, mesh, **build))
    out["ckpt"] = _pp_checkpoint(inputs, out_dir, mesh,
                                 pipeline_schedule="1f1b", microbatches=4)
    try:
        pipeline_1f1b(lambda prm, x: x, lambda *a: None, {}, {},
                      torch.zeros(1, 2, 3), mesh)
        out["m_lt_p"] = None
    except ValueError as exc:
        out["m_lt_p"] = str(exc)
    rows = inputs["pp_tokens"][:4]
    (got,) = next(global_batch_iterator(lambda step: (rows.numpy(),), mesh,
                                        "cpu"))
    out["iterator"] = {"got": got, "want": rows}
    return out


def scenario_pp_world4(inputs, out_dir):
    """pp = 4 (MLP stages, logits, 1F1B), dp = 2 x pp = 2 and fsdp = 2 x
    pp = 2 with the stages' matrices sharded (1F1B, interleaved), and
    three AdamW steps on each composed mesh."""
    from mpi_operator_tpu_torch.models.llama_pipeline import pipeline_forward
    pp4 = _pp_mesh(pp=4)
    out = {"mlp": _pp_mlp(inputs, 4)}
    with torch.no_grad():
        out["logits"] = pipeline_forward(_pp_stage(inputs, pp4),
                                         inputs["pp_tokens"], pp4, 4)
    out["1f1b_pp4"] = _pp_1f1b(inputs, pp4, 4)
    dp2 = _pp_mesh(dp=2, pp=2)
    fsdp2 = _pp_mesh(fsdp=2, pp=2)
    out["1f1b_dp2"] = _pp_1f1b(inputs, dp2, 2)
    out["1f1b_fsdp2"] = _pp_1f1b(inputs, fsdp2, 2, fsdp_shard=True)
    out["interleaved_fsdp2"] = _pp_1f1b(inputs, fsdp2, 2, virtual_stages=2,
                                        fsdp_shard=True)
    from mpi_operator_tpu_torch.models.llama_pipeline import LlamaStage
    from mpi_operator_tpu_torch.models.params import gather_stage_state_dict
    stage = LlamaStage(tl.llama2_tiny(**inputs["pp_config"]), mesh=fsdp2,
                       fsdp_shard=True, device="meta",
                       store_dtype=torch.float32)
    stage.to_empty(device="cpu")
    init_params_(stage, torch.Generator().manual_seed(7))
    out["init_fsdp"] = {"sharded": len(stage.fsdp_dims),
                        "joined": gather_stage_state_dict(stage)}
    out["steps_1f1b_dp2"] = _strip(_pp_train(
        inputs, dp2, pipeline_schedule="1f1b", microbatches=2))
    out["steps_gpipe_fsdp2"] = _strip(_pp_train(
        inputs, fsdp2, microbatches=2, pp_fsdp=True))
    out["steps_interleaved_fsdp2"] = _strip(_pp_train(
        inputs, fsdp2, pipeline_schedule="1f1b", microbatches=2,
        virtual_stages=2, pp_fsdp=True))
    return out


def scenario_pp_cuda(inputs, out_dir):
    """pp = world on the cards: 1F1B on llama2_tiny in bf16 through
    K1'-K3' ("auto") and through the plain attention ("xla") on the same
    weights and rows, with each kernel's launches over the kernel run."""
    from mpi_operator_tpu_torch.models.llama_pipeline import (
        pipeline_loss_and_grads_1f1b)
    from mpi_operator_tpu_torch.models.params import gather_stage_state_dict
    from mpi_operator_tpu_torch.ops import attention as fa
    mesh = _pp_mesh(pp=dist.get_world_size())
    tokens = inputs["pp_tokens"].cuda()
    runs = {}
    for impl in ("xla", "auto"):
        stage = _pp_stage(inputs, mesh, config={"dtype": torch.bfloat16,
                                                "attention_impl": impl})
        torch.cuda.synchronize()
        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        loss, grads = pipeline_loss_and_grads_1f1b(stage, tokens, mesh,
                                                   inputs["pp_m"])
        torch.cuda.synchronize()
        runs[impl] = {"loss": loss.item(), "launches": dict(fa.LAUNCHES),
                      "grads": {n: g.cpu() for n, g in
                                gather_stage_state_dict(stage,
                                                        grads).items()}}
    return {"runs": runs, "stage": mesh.get_local_rank("pp"),
            "layers_per_stage": inputs["pp_config"]["n_layers"]
            // dist.get_world_size()}


# -- MoE pipelines, re-sharding a pipeline (test_torch_moe_pipeline.py) --

def _moe_layers(stage):
    return [block.feed_forward for block in stage.layers.values()]


def _moe_gpipe(inputs, mesh, m, fsdp_shard=False):
    """pipeline_loss (GPipe, autograd) on this rank's rows of the MoE
    batch; the loss and the gradients averaged over the batch ranks by
    the GPipe plan's own reduction, and joined."""
    from mpi_operator_tpu_torch.models.llama_pipeline import pipeline_loss
    from mpi_operator_tpu_torch.models.params import gather_stage_state_dict
    stage = _pp_stage(inputs, mesh, fsdp_shard=fsdp_shard, moe=True)
    plan = ttrain._PipelinePlan(mesh, "gpipe", m, 1, fsdp_shard)
    plan.place(stage)
    loss = pipeline_loss(stage, _rows(mesh, inputs["moe_tokens"]), mesh, m,
                         fsdp_shard=fsdp_shard)
    loss.backward()
    plan.reduce(list(stage.parameters()))
    loss = plan.grads.all_reduce_(loss.detach()) / plan.world
    return {"loss": loss.item(), "grads": gather_stage_state_dict(
        stage, {n: p.grad for n, p in stage.named_parameters()})}


def _moe_capacity_fault(inputs, mesh, m):
    """1F1B on dp = 2 x pp = 2 where the MoE layers of pp stage 1 count
    their capacity over the microbatch of every batch shard (dp x its
    rows), not over their own rows."""
    stage = _pp_stage(inputs, mesh, moe=True)
    if mesh.get_local_rank("pp") == 1:
        shards = dict(zip(mesh.mesh_dim_names, mesh.shape))["dp"]
        for layer in _moe_layers(stage):
            layer.capacity_factor *= shards
    return _pp_1f1b(inputs, mesh, m, moe=True, stage=stage)


def _moe_recompute(inputs, mesh, m, planted):
    """1F1B at pp = world: each MoE layer's routing (expert indices) in
    the F slots (no autograd) and in the B slots' recompute, in order;
    ``planted`` moves every recomputed assignment to the next expert."""
    from mpi_operator_tpu_torch.ops.moe import MoEMLP
    real = MoEMLP.forward
    seen = {}

    def recorded(layer, x, no_drop=False):
        slot = "B" if torch.is_grad_enabled() else "F"
        topk = torch.topk
        if planted and slot == "B":
            def topk_(t, k, dim=-1):
                idx = (topk(t, k, dim=dim)[1] + 1) % t.shape[-1]
                return torch.gather(t, dim, idx), idx
            torch.topk = topk_
        try:
            out = real(layer, x, no_drop)
        finally:
            torch.topk = topk
        seen.setdefault((id(layer), slot), []).append(
            layer.last_routing[0].clone())
        return out

    MoEMLP.forward = recorded
    try:
        stage = _pp_stage(inputs, mesh, moe=True)
        out = _pp_1f1b(inputs, mesh, m, moe=True, stage=stage)
    finally:
        MoEMLP.forward = real
    layers = _moe_layers(stage)
    out["routing_equal"] = all(
        len(seen[(id(x), "F")]) == m and
        all(torch.equal(a, b) for a, b in zip(seen[(id(x), "F")],
                                             seen[(id(x), "B")]))
        for x in layers)
    return out


def _moe_pp_case(inputs, mesh, moe, **build):
    """This rank's model and step for one leg of a re-shard run: a
    LlamaStage and the pipeline step over a pp mesh, else a LlamaModel
    (its ep shard) and the plain step, both from the test's weights."""
    from mpi_operator_tpu_torch.models.params import shard_state_dict
    preset, key = _pp_model(inputs, moe)
    cfg = preset(**inputs[f"{key}_config"])
    if dict(zip(mesh.mesh_dim_names, mesh.shape))["pp"] > 1:
        init, step = ttrain.build_train_step(None, ttrain.adamw(LR),
                                             mesh=mesh, **build)
        model = _pp_stage(inputs, mesh, build.get("virtual_stages", 1),
                          build.get("pp_fsdp", False), moe=moe)
        return init, step, model
    init, step = ttrain.build_train_step(
        _loss, ttrain.adamw(LR), mesh=mesh,
        param_specs=tl.llama_param_specs(cfg), **build)
    model = tl.LlamaModel(cfg, device="cpu", store_dtype=torch.float32,
                          mesh=mesh)
    model.load_state_dict(shard_state_dict(inputs[f"{key}_weights"], cfg,
                                           model.tp, model.ep))
    return init, step, model


def _snapshot(state):
    """A copy of ``state.state_dict()`` (a collective) that later steps
    leave as it is: a plan may hand out its live tensors."""
    if state is None:
        return None
    return ttrain._map_tensors(state.state_dict(),
                               lambda t: t.detach().cpu().clone())


def _pp_reshard(inputs, legs, switch_at, steps=4, moe=False):
    """``steps`` AdamW steps of the test's batch, begun on the first of
    ``legs`` ((mesh, build kwargs), each mesh built by every rank) and
    moved by reshard_train_state onto the second before step
    ``switch_at`` (no move with one leg).  On the lowest rank of the last
    mesh: every step's (loss, grad_norm), the one-device state before
    and right after the move, and the one-device state at the end."""
    def member(mesh):
        return mesh.get_coordinate() is not None

    preset, key = _pp_model(inputs, moe)
    specs = tl.llama_param_specs(preset(**inputs[f"{key}_config"]))
    (mesh, build), state, step = legs[0], None, None
    if member(mesh):
        init, step, model = _moe_pp_case(inputs, mesh, moe, **build)
        state = init(model)
    metrics, before, after = [], None, None
    for i in range(steps):
        if i == switch_at and len(legs) > 1:
            before = _snapshot(state)
            mesh, build = legs[1]
            state = ttrain.reshard_train_state(state, mesh,
                                               param_specs=specs, **build)
            if state is not None:
                after = _snapshot(state)
                step = _moe_pp_case(inputs, mesh, moe, **build)[1]
        if state is not None:
            state, m = step(state, _rows(mesh, inputs[f"{key}_tokens"]))
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
    if state is None:
        return None
    final = state.state_dict()
    if dist.get_rank() != int(mesh.mesh.min()):
        return {"member": True}
    return {"member": True, "metrics": metrics, "before": before,
            "after": after, "final": final,
            "plan": type(state.plan).__name__,
            "model": type(state.model).__name__}


def scenario_moe_pp_world2(inputs, out_dir):
    """mixtral_tiny at pp = 2: GPipe, 1F1B and interleaved 1F1B, three
    AdamW steps of 1F1B, the routing of the 1F1B recompute (and a planted
    change of it); llama2_tiny moved from pp = 2 to fsdp = 2 at step 2
    of 4 (and its straight run)."""
    pp2 = _pp_mesh(pp=2)
    fsdp2 = _pp_mesh(fsdp=2)
    f1b = {"pipeline_schedule": "1f1b", "microbatches": 4}
    out = {"gpipe": _moe_gpipe(inputs, pp2, 4),
           "1f1b": _pp_1f1b(inputs, pp2, 4, moe=True),
           "interleaved": _pp_1f1b(inputs, pp2, 4, virtual_stages=2,
                                   moe=True),
           "steps_1f1b": _strip(_pp_train(inputs, pp2, moe=True, **f1b)),
           "recompute": _moe_recompute(inputs, pp2, 4, planted=False),
           "recompute_fault": _moe_recompute(inputs, pp2, 4, planted=True),
           "reshard_pp_fsdp": _pp_reshard(inputs, [(pp2, f1b), (fsdp2, {})],
                                          2),
           "straight_pp": _pp_reshard(inputs, [(pp2, f1b)], None)}
    return out


def scenario_moe_pp_world4(inputs, out_dir):
    """mixtral_tiny at pp = 4, dp = 2 x pp = 2 and fsdp = 2 x pp = 2 with
    pp_fsdp (1F1B, GPipe, three AdamW steps), the planted capacity fault;
    the stage init of the fsdp shards; llama2_tiny grown from dp = 2 (two
    ranks) to dp = 2 x pp = 2, mixtral_tiny moved from pp = 4 to fsdp = 2
    x pp = 2 with pp_fsdp (and its straight run), and mixtral_tiny shrunk
    from dp = 2 x pp = 2 to ep = 2 (two ranks), each at step 2 of 4."""
    from mpi_operator_tpu_torch.models.llama_pipeline import LlamaStage
    from mpi_operator_tpu_torch.models.params import gather_stage_state_dict
    pp4 = _pp_mesh(pp=4)
    dp2 = _pp_mesh(dp=2, pp=2)
    fsdp2 = _pp_mesh(fsdp=2, pp=2)
    out = {"1f1b_pp4": _pp_1f1b(inputs, pp4, 4, moe=True),
           "1f1b_dp2": _pp_1f1b(inputs, dp2, 2, moe=True),
           "1f1b_fsdp2": _pp_1f1b(inputs, fsdp2, 2, fsdp_shard=True,
                                  moe=True),
           "gpipe_fsdp2": _moe_gpipe(inputs, fsdp2, 2, fsdp_shard=True),
           "1f1b_dp2_fault": _moe_capacity_fault(inputs, dp2, 2),
           "steps_1f1b_dp2": _strip(_pp_train(
               inputs, dp2, moe=True, pipeline_schedule="1f1b",
               microbatches=2)),
           "steps_gpipe_fsdp2": _strip(_pp_train(
               inputs, fsdp2, moe=True, microbatches=2, pp_fsdp=True))}
    stage = LlamaStage(tl.mixtral_tiny(**inputs["moe_config"]), mesh=fsdp2,
                       fsdp_shard=True, device="meta",
                       store_dtype=torch.float32)
    stage.to_empty(device="cpu")
    init_params_(stage, torch.Generator().manual_seed(7))
    out["init_fsdp"] = {"dims": dict(stage.fsdp_dims),
                        "joined": gather_stage_state_dict(stage)}
    two = tmesh.create_mesh(tmesh.MeshConfig(dp=2), "cpu", ranks=[0, 1])
    ep2 = tmesh.create_mesh(tmesh.MeshConfig(dp=1, ep=2), "cpu",
                            ranks=[0, 1])
    gpipe2 = {"microbatches": 2}
    out["reshard_grow"] = _pp_reshard(inputs, [(two, {}), (dp2, gpipe2)], 2)
    out["straight_dp2"] = _pp_reshard(inputs, [(two, {})], None)
    out["reshard_shrink"] = _pp_reshard(inputs, [(dp2, gpipe2), (ep2, {})],
                                        2, moe=True)
    # Two rows a microbatch on both meshes: the same capacity, the same
    # function before and after the move.
    pp4_f1b = {"pipeline_schedule": "1f1b", "microbatches": 4}
    fsdp2_f1b = {"pipeline_schedule": "1f1b", "microbatches": 2,
                 "pp_fsdp": True}
    out["reshard_pp4_fsdp2"] = _pp_reshard(
        inputs, [(pp4, pp4_f1b), (fsdp2, fsdp2_f1b)], 2, moe=True)
    out["straight_pp4"] = _pp_reshard(inputs, [(pp4, pp4_f1b)], None,
                                      moe=True)
    return out


# -- the checkpoint data plane (test_torch_ckpt_resharded.py) -------------

CKPT_CHUNK_BYTES = 1 << 14


def _leaf_dict(state):
    """The one-device state leaf by leaf (``TrainState.leaves``, a
    collective over the state's mesh) on the mesh's lowest rank, None on
    the others."""
    leaves = {leaf.name: leaf.gather().detach().cpu().clone()
              for leaf in state.leaves()}
    lowest = int(state.plan.full_mesh.mesh.min())
    return leaves if dist.get_rank() == lowest else None


def _ckpt_case(inputs, out_dir, job, old, new, fault=False):
    """Two AdamW steps of the test's llama2_tiny on ``old`` ((mesh, build
    kwargs)), a per-rank save of step 2 into the job's directory store,
    restore_resharded onto ``new``, two more steps.  ``fault``: a second
    save (job ``JOB-fault``) in which rank 1 writes rank 0's range, also
    restored.  On every rank: its range, what its store uploaded and
    read; on the lowest rank also the leaves before the save, after the
    restore(s) and after the last step, and every step's metrics."""
    from mpi_operator_tpu_torch.ckpt import (BlobStore,
                                             ManifestCheckpointManager)
    from mpi_operator_tpu_torch.ckpt.manifest import shard_ranges
    tokens = inputs["pp_tokens"]
    (mesh, build), (new_mesh, new_build) = old, new
    init, step, model = _moe_pp_case(inputs, mesh, False, **build)
    state = init(model)
    metrics = []
    for _ in range(2):
        state, m = step(state, _rows(mesh, tokens))
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    store = BlobStore(root=os.path.join(out_dir, "store"))
    out = {"before": _leaf_dict(state)}
    jobs = [job] + [f"{job}-fault"] * fault
    for name in jobs:
        mgr = ManifestCheckpointManager(store, name, every=2,
                                        chunk_bytes=CKPT_CHUNK_BYTES)
        if name.endswith("-fault") and dist.get_rank() == 1:
            mgr.shard_range = lambda total: shard_ranges(total,
                                                         mgr.world)[0]
        written = dict(store.counters)
        assert mgr.maybe_save(state, 2)
        mgr.drain()
        out[f"save {name}"] = {
            "range": mgr.shard_range(store.read_manifest(name, 2)
                                     ["total_bytes"]),
            **{k: store.counters[k] - written[k] for k in
               ("puts", "bytes_written", "bytes_deduped")}}
    specs = tl.llama_param_specs(tl.llama2_tiny(**inputs["pp_config"]))
    for name in jobs:
        mgr = ManifestCheckpointManager(store, name,
                                        chunk_bytes=CKPT_CHUNK_BYTES)
        read = store.counters["bytes_read"]
        moved = mgr.restore_resharded(state, new_mesh, param_specs=specs,
                                      **new_build)
        out[f"restore {name}"] = {
            "bytes_read": store.counters["bytes_read"] - read,
            "plan": type(moved.plan).__name__,
            "leaves": _leaf_dict(moved)}
        if name == job:
            restored = moved
    step = _moe_pp_case(inputs, new_mesh, False, **new_build)[1]
    for _ in range(2):
        restored, m = step(restored, _rows(new_mesh, tokens))
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    out["final"] = _leaf_dict(restored)
    out["metrics"] = metrics
    return out


def scenario_ckpt_world2(inputs, out_dir):
    """fsdp = 2 -> dp = 2 with ZeRO (and the neighbour's-range fault),
    pp = 2 (1F1B) -> fsdp = 2."""
    fsdp2, dp2, pp2 = _pp_mesh(fsdp=2), _pp_mesh(dp=2), _pp_mesh(pp=2)
    return {"fsdp2_dp2": _ckpt_case(inputs, out_dir, "ckpt/fsdp2",
                                    (fsdp2, {}),
                                    (dp2, {"shard_update": True}),
                                    fault=True),
            "pp2_fsdp2": _ckpt_case(inputs, out_dir, "ckpt/pp2",
                                    (pp2, {"pipeline_schedule": "1f1b",
                                           "microbatches": 2}),
                                    (fsdp2, {}))}


def scenario_ckpt_world4(inputs, out_dir):
    """tp = 2 x fsdp = 2 -> fsdp = 4."""
    return {"tp2_fsdp2_fsdp4": _ckpt_case(
        inputs, out_dir, "ckpt/tp2fsdp2", (_pp_mesh(tp=2, fsdp=2), {}),
        (_pp_mesh(fsdp=4), {}))}


# -- the image workloads ---------------------------------------------------

def _resnet_run(inputs, fault: bool):
    """The test's tiny f32 ResNet at dp = world: ``steps`` SGD-momentum
    steps on this rank's rows; the losses and the final state (weights
    and running statistics).  ``fault`` gives ``bn_init`` local
    statistics (the reduction skipped on every rank)."""
    from mpi_operator_tpu_torch.models import resnet as tres

    spec = inputs["resnet"]
    mesh = tmesh.create_mesh(tmesh.MeshConfig(dp=dist.get_world_size()),
                             DEVICE)
    cfg = tres.ResNetConfig(stage_sizes=(1, 1, 1, 1), num_classes=10,
                            width=8, dtype=torch.float32)
    model = tres.ResNet(cfg, mesh=mesh,
                        device=None if DEVICE == "cuda" else "cpu")
    model.load_state_dict(spec["weights"])
    if fault:
        model.bn_init.group = None
    init, step = ttrain.build_train_step(
        lambda m, b: tres.cross_entropy_loss(m(b[0]), b[1]),
        ttrain.sgd(spec["lr"], momentum=spec["momentum"]), mesh=mesh)
    state = init(model)
    rows = tmesh.batch_rows(tuple(mesh.shape), mesh.get_coordinate(),
                            len(spec["images"]))
    batch = (spec["images"][rows].to(model.head.weight.device),
             spec["labels"][rows].to(model.head.weight.device))
    losses = [step(state, batch)[1]["loss"].item()
              for _ in range(spec["steps"])]
    return {"losses": losses,
            "state": {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()}}


def scenario_resnet_world2(inputs, out_dir):
    """dp = 2: global-batch BatchNorm, and the local-statistics fault."""
    return {"runs": {"global": _resnet_run(inputs, fault=False),
                     "local_bn_init": _resnet_run(inputs, fault=True)}}


# -- KV pages under tensor parallelism (tests/test_torch_kv_transfer_tp.py) --

KVTP_PAGE = 16


def _kvtp_post(url, path, payload):
    import json
    import urllib.request
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _kvtp_greedy(url, prompt, n=8):
    return _kvtp_post(url, "/generate", {"tokens": [prompt],
                                         "max_new_tokens": n,
                                         "temperature": 0.0})["tokens"][0]


def _kvtp_export(server, prompt, path):
    """Rank 0 of a replica: its pages of ``prompt`` as wire JSON at
    ``path`` (a lock-step export under tp)."""
    import json

    from mpi_operator_tpu_torch.serving import kv_transfer as kvt
    from mpi_operator_tpu_torch.serving.batcher import prefix_page_digests
    wire = kvt.encode_pages(server._batcher.export_kv_pages(
        prefix_page_digests(prompt, KVTP_PAGE)))
    with open(path, "w") as f:
        json.dump(wire, f)
    return wire


def _kvtp_rows_match(server, prompt, wire_path, chunk):
    """Whether this rank's pool rows of ``prompt``'s pages equal head
    chunk ``chunk`` of the wire pages' leaves, bit for bit, leaf by leaf
    (scales too)."""
    import json

    from mpi_operator_tpu_torch.serving import kv_transfer as kvt
    b = server._batcher
    with open(wire_path) as f:
        pages = kvt.decode_pages(json.load(f))
    by_digest = {d: blk for blk, d in b._block_digest.items()}
    out = {}
    for path, leaf in b._pool_leaves():
        held = leaf[[by_digest[p["digest"]] for p in pages]].cpu()
        want = torch.stack([p["leaves"][path] for p in pages]).chunk(
            2, dim=2)[chunk].to(leaf.dtype)
        out[path] = torch.equal(held.view(torch.uint8),
                                want.contiguous().view(torch.uint8))
    return out


def _kvtp_pair(inputs, mesh, role, name="dense", kv="auto"):
    """This rank's tp = 2 server of ``role`` over ``mesh``, started."""
    from mpi_operator_tpu_torch.serving import InferenceServer
    server = InferenceServer(
        _tp_model(inputs, name, mesh), mesh=mesh, role=role,
        max_batch_slots=2, kv_page_size=KVTP_PAGE, kv_cache_blocks=48,
        kv_cache_dtype=kv, device="cpu", tp_timeout_s=60).start()
    # Every page operation's verdicts as this rank holds them to rank 0's.
    server.agreed = []
    agree = server.mirror.agree

    def spy(what, verdicts):
        server.agreed.append((what, verdicts))
        agree(what, verdicts)
    server.mirror.agree = spy
    return server


def _kvtp_urls(mine: dict) -> list:
    """Every rank's {name: url} (gathered over the default group)."""
    urls = [None] * dist.get_world_size()
    dist.all_gather_object(urls, mine)
    return urls


def _kvtp_close(server, out):
    """Stop a tp server (rank 0) or wait for its group to stop; then
    what every rank reports of its pages."""
    if server.is_leader:
        server.stop()
    else:
        server.join(timeout=120)
        server.stop()
    b = server._batcher
    out.update(page_ops=server.agreed,
               record_bytes=server.mirror.page_record_bytes,
               dispatches=server.telemetry["dispatches_total"].value,
               prefix=dict(b.prefix_stats))


def scenario_kvtp_world4(inputs, out_dir):
    """Two tp = 2 replicas in one world: ranks 0-1 prefill (P), ranks 2-3
    decode (D), each its own mesh (``create_mesh(ranks=)``); rank 0 also
    hosts one-process replicas.  Rank 0 drives over HTTP: tp 2 -> tp 2,
    a re-ship, tp 2 -> tp 1, tp 1 -> tp 2, the JAX tp = 2 export into D,
    a bad chain and a dedup into D, exports to files, then a planted
    head-order fault (D's rank 0 scatters the chunks swapped); int8
    pools; mixtral_tiny; and a follower that stages other verdicts."""
    import json

    from mpi_operator_tpu_torch.serving import InferenceServer
    rank = dist.get_rank()
    mesh = [tmesh.create_mesh(tmesh.MeshConfig(dp=1, tp=2), DEVICE,
                              ranks=r) for r in ([0, 1], [2, 3])][rank // 2]
    role = "decode" if rank >= 2 else "prefill"
    p = inputs["prompts"]
    files = {k: os.path.join(out_dir, f"port_{k}.json")
             for k in ("A", "C", "F", "A_int8")}
    out = {"files": files}

    # Round 1: f32 pools, llama2_tiny.
    server = _kvtp_pair(inputs, mesh, role)
    out["role"] = server.fleet_state()["role"] if server.is_leader else None
    ones = {}
    if rank == 0:
        whole = _tp_model(inputs, "dense", None)
        ones = {r: InferenceServer(whole, role=r, max_batch_slots=2,
                                   kv_page_size=KVTP_PAGE,
                                   kv_cache_blocks=48,
                                   device="cpu").start()
                for r in ("prefill", "decode")}
    mine = {k: s.url for k, s in ones.items()}
    if server.is_leader:
        mine[role] = server.url
    urls = _kvtp_urls(mine)
    if rank == 0:
        P, D = urls[0]["prefill"], urls[2]["decode"]
        one_p, one_d = ones["prefill"].url, ones["decode"].url
        r = out["drive"] = {}
        r["tp2_tp2_reply"] = _kvtp_post(P, "/prefill", {
            "tokens": p["A"], "transfer": {"url": D, "have": []}})
        r["tp2_tp2"] = _kvtp_greedy(D, p["A"])
        r["reship"] = _kvtp_post(P, "/prefill", {
            "tokens": p["A"], "transfer": {"url": D}})
        r["tp2_tp1_reply"] = _kvtp_post(P, "/prefill", {
            "tokens": p["A"], "transfer": {"url": one_d, "have": []}})
        r["tp2_tp1"] = _kvtp_greedy(one_d, p["A"])
        r["tp1_tp2_reply"] = _kvtp_post(one_p, "/prefill", {
            "tokens": p["B"], "transfer": {"url": D, "have": []}})
        r["tp1_tp2"] = _kvtp_greedy(D, p["B"])
        with open(inputs["jax_wire"]) as f:
            r["jax_tp2_reply"] = _kvtp_post(D, "/kv/pages",
                                            {"pages": json.load(f)})
        r["jax_tp2"] = _kvtp_greedy(D, p["C"])
        _kvtp_post(P, "/prefill", {"tokens": p["C"]})
        _kvtp_export(server, p["C"], files["C"])
        wire_a = _kvtp_export(server, p["A"], files["A"])
        _kvtp_post(P, "/prefill", {"tokens": p["E"]})
        bad = json.loads(json.dumps(_kvtp_export(
            server, p["E"], os.path.join(out_dir, "port_E.json"))))
        bad[0]["tokens"][0] += 1          # the root no longer hashes
        r["bad_reply"] = _kvtp_post(D, "/kv/pages", {"pages": bad})
        r["dedup_reply"] = _kvtp_post(D, "/kv/pages", {"pages": wire_a})
        r["tp2_prefill_dispatches"] = \
            server.telemetry["dispatches_total"].value
    if rank == 3:
        try:
            server._batcher.import_kv_pages([])
        except RuntimeError as exc:
            out["follower_import"] = str(exc)
    dist.barrier()
    if rank == 2:                         # the planted head-order fault
        real = server._batcher._head_chunks
        server._batcher._head_chunks = lambda rows: real(rows)[::-1]
    dist.barrier()
    if rank == 0:
        r["fault_reply"] = _kvtp_post(P, "/prefill", {
            "tokens": p["F"], "transfer": {"url": D, "have": []}})
        r["fault"] = _kvtp_greedy(D, p["F"])
        _kvtp_export(server, p["F"], files["F"])
        for s in ones.values():
            s.stop()
    dist.barrier()
    _kvtp_close(server, out)
    if rank >= 2:
        out["rows"] = {k: _kvtp_rows_match(server, p[k], files[k], rank - 2)
                       for k in ("A", "F")}
        out["logits"] = {k: server.prefill_logits(p[k]).clone()
                         for k in ("A", "F")}
    del server

    # Round 2: int8 pools.
    server = _kvtp_pair(inputs, mesh, role, kv="int8")
    urls = _kvtp_urls({role: server.url} if server.is_leader else {})
    if rank == 0:
        _kvtp_post(urls[0]["prefill"], "/prefill", {
            "tokens": p["A"],
            "transfer": {"url": urls[2]["decode"], "have": []}})
        out["int8"] = _kvtp_greedy(urls[2]["decode"], p["A"])
        _kvtp_export(server, p["A"], files["A_int8"])
    dist.barrier()
    int8 = out["int8_report"] = {}
    _kvtp_close(server, int8)
    if rank >= 2:
        int8["rows"] = _kvtp_rows_match(server, p["A"], files["A_int8"],
                                        rank - 2)
    del server

    # Round 3: mixtral_tiny.
    server = _kvtp_pair(inputs, mesh, role, name="moe")
    urls = _kvtp_urls({role: server.url} if server.is_leader else {})
    if rank == 0:
        out["moe_reply"] = _kvtp_post(urls[0]["prefill"], "/prefill", {
            "tokens": p["A"],
            "transfer": {"url": urls[2]["decode"], "have": []}})
        out["moe"] = _kvtp_greedy(urls[2]["decode"], p["A"])
    dist.barrier()
    _kvtp_close(server, {})
    del server

    # Round 4: D's rank 1 stages another verdict for the first page.
    if rank >= 2:
        from mpi_operator_tpu_torch.serving import kv_transfer as kvt
        server = _kvtp_pair(inputs, mesh, role)
        b = server._batcher
        if rank == 3:
            real, calls = b._stage_import, []

            def stage(*a):
                calls.append(1)
                return ("deduped", None) if len(calls) == 1 else real(*a)
            b._stage_import = stage
        errors = []
        try:
            if rank == 2:
                with open(files["A"]) as f:
                    b.import_kv_pages(kvt.decode_pages(json.load(f)))
            server.join(timeout=120)
        except Exception as exc:          # the group's error, both ranks
            errors.append(f"{type(exc).__name__}: {exc}")
        server.stop()
        out["peer_error"] = errors
    dist.barrier()
    return out


def main() -> int:
    global DEVICE
    scenario, out_dir = sys.argv[1], sys.argv[2]
    DEVICE = sys.argv[3] if len(sys.argv) > 3 else "cpu"
    torch.set_num_threads(1)
    t0 = time.time()
    initialize_from_env(
        timeout_seconds=60, device=None if DEVICE == "cuda" else "cpu",
        collective_timeout_seconds=(10 if "_fault_" in scenario
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
