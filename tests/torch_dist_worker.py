"""One rank of a gloo process group for tests/test_torch_distributed.py.

    JAX_COORDINATOR_ADDRESS=127.0.0.1:PORT JAX_PROCESS_ID=r \\
    JAX_NUM_PROCESSES=n python tests/torch_dist_worker.py SCENARIO DIR [cuda]

The process forms its group from the operator's env
(``bootstrap.initialize_from_env``: gloo on the CPU, or NCCL on the card
of its rank with ``cuda``), runs SCENARIO with the
inputs the test wrote to DIR (``inputs.pt``: the llama2_tiny weights as
a state dict and the global token batch) and saves what it found to
DIR/SCENARIO.rank<r>.pt.  Not a test module: pytest collects only
``test_*.py``.
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


def main() -> int:
    global DEVICE
    scenario, out_dir = sys.argv[1], sys.argv[2]
    DEVICE = sys.argv[3] if len(sys.argv) > 3 else "cpu"
    torch.set_num_threads(1)
    t0 = time.time()
    initialize_from_env(timeout_seconds=60,
                        device=None if DEVICE == "cuda" else "cpu")
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"))
    result = globals()[f"scenario_{scenario}"](inputs, out_dir)
    result["seconds"] = time.time() - t0
    torch.save(result, os.path.join(
        out_dir, f"{scenario}.rank{dist.get_rank()}.pt"))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
