"""Expert parallelism and the live re-shard of the PyTorch port (gloo on
the CPU) against the JAX package.

Ranks are real processes (``tests/torch_dist_worker.py``) that form
their group from the operator's env; a world-2 job (ep = 2) and a
world-4 job (ep = 2 x tp = 2, fsdp = 2 x ep = 2, and the re-shard) run
while the JAX references are computed, each joined with a deadline.
Held:

- ``mixtral_tiny`` at ep = 2: each rank holds E/ep experts, its logits
  equal the JAX model's (1e-4), and a checkpoint holds the one-device
  format and restores and continues bit for bit;
- three AdamW steps at ep = 2, ep = 2 x tp = 2 and fsdp = 2 x ep = 2
  against the JAX step on ``test_mixtral_expert_parallel_train_step``'s
  mesh (dp = 2 x ep = 2 x tp = 2), at ``STEP_TOL``: the whole routing
  and its drops on every rank, the combine summed over ep, the
  gradients of the gates and of the MoE input through ``copy_to_ep``;
- ``reshard_train_state`` grown from two ranks to four and shrunk back
  at step 3 of 6 against the JAX run of tests/test_elastic.py on the
  same meshes (1e-5), and one move alone is pure data movement (the
  moved state bit-equal to the state before it).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpi_operator_tpu.models import llama as jl
from mpi_operator_tpu.parallel import mesh as jmesh
from mpi_operator_tpu.parallel import train as jtrain
from mpi_operator_tpu_torch.models import llama as tl
from mpi_operator_tpu_torch.models.params import from_flax_params
from mpi_operator_tpu_torch.parallel import train as ttrain
from test_torch_distributed import (LR, STEP_TOL, WORKER, _tokens,
                                    assert_metrics_close,
                                    assert_params_close, join, launch)

LOGIT_TOL = 1e-4                       # f32 model logits (parity rules)
EP_MESH = dict(dp=2, fsdp=1, ep=2, tp=2, sp=1)   # tests/test_models.py


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_ep_steps(model, variables):
    """Three AdamW steps of the JAX step on the JAX test's ep mesh."""
    cfg = jl.mixtral_tiny()
    mesh = jmesh.create_mesh(jmesh.MeshConfig(**EP_MESH))
    ep_model = jl.LlamaModel(cfg, mesh=mesh)

    def jloss(params, batch):
        return jl.next_token_loss(ep_model.apply(params, batch), batch)

    with mesh:
        init_fn, step_fn = jtrain.build_train_step(
            jloss, optax.adamw(LR), mesh, donate=False,
            param_specs=jl.llama_param_specs(cfg))
        state = init_fn(variables)
        batch = jax.device_put(jnp.asarray(_tokens()),
                               jmesh.batch_sharding(mesh))
        metrics = []
        for _ in range(3):
            state, m = step_fn(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, from_flax_params(_np(state.params["params"]),
                                     tl.mixtral_tiny(), torch.float32)


def _smallest_moe_grads(weights):
    """Per element, the smallest |gradient| over three one-process steps
    (the elements whose gradient rounding may flip: see
    ``assert_params_close``)."""
    model = tl.LlamaModel(tl.mixtral_tiny(), device="cpu",
                          store_dtype=torch.float32)
    model.load_state_dict(weights)
    init, step = ttrain.build_train_step(
        lambda m, b: tl.next_token_loss(m(b), b), ttrain.adamw(LR))
    state = init(model)
    smallest = {n: torch.full_like(p, float("inf"))
                for n, p in model.named_parameters()}
    for _ in range(3):
        state, _ = step(state, torch.from_numpy(_tokens()))
        for n, p in state.model.named_parameters():
            smallest[n] = torch.minimum(smallest[n], p.grad.abs())
    return smallest


def _mlp_inputs():
    """tests/test_elastic.py's parameters and six batches of 16 rows."""
    rng = np.random.default_rng(0)
    params = {"w1": rng.normal(size=(8, 16)).astype(np.float32),
              "w2": rng.normal(size=(16, 4)).astype(np.float32)}
    batches = [(rng.normal(size=(16, 8)).astype(np.float32),
                rng.normal(size=(16, 4)).astype(np.float32))
               for _ in range(6)]
    return params, batches


def _jax_reshard_runs(params, batches):
    """tests/test_elastic.py's run() on the meshes the world-4 job
    takes: (dp = 1, fsdp = 2) on two devices and (dp = 2, fsdp = 2) on
    four, straight on the larger, grown and shrunk at batch 3."""
    devs = jax.devices()
    small = jmesh.create_mesh(jmesh.MeshConfig(dp=1, fsdp=2), devs[:2])
    big = jmesh.create_mesh(jmesh.MeshConfig(dp=2, fsdp=2), devs[:4])

    def loss_fn(p, batch):
        x, y = batch
        return (((x @ p["w1"]) @ p["w2"] - y) ** 2).mean()

    def run(meshes, switch_at):
        init, step = jtrain.build_train_step(loss_fn, optax.adam(1e-2),
                                             meshes[0], shard_update=True)
        state = init({k: jnp.asarray(v) for k, v in params.items()})
        for i, (x, y) in enumerate(batches):
            if i == switch_at and len(meshes) > 1:
                state = jtrain.reshard_train_state(state, meshes[1],
                                                   shard_update=True)
                assert int(state.step) == switch_at
                _, step = jtrain.build_train_step(
                    loss_fn, optax.adam(1e-2), meshes[1], shard_update=True)
            state, _ = step(state, (jnp.asarray(x), jnp.asarray(y)))
        return {k: np.asarray(v) for k, v in
                jax.device_get(state.params).items()}

    return {"golden": run([big], None), "grow": run([small, big], 3),
            "shrink": run([big, small], 3)}


def _moe_layer_case():
    """A MoEMLP's weights and a [4, 8, D] input at a capacity factor
    that drops about half the assignments, and the one-process layer's
    output, input gradient and router gradient on the whole batch."""
    from mpi_operator_tpu_torch.ops.moe import MoEMLP
    rng = np.random.default_rng(5)
    e, d, f = 4, 16, 32

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    case = {"capacity_factor": 0.5, "x": draw(4, 8, d), "g": draw(4, 8, d),
            "weights": {"router.weight": draw(e, d), "w1": draw(e, d, f),
                        "w3": draw(e, d, f), "w2": draw(e, f, d)}}

    def layer(factor):
        moe = MoEMLP(d, f, e, capacity_factor=factor, dtype=torch.float32,
                     device="cpu")
        moe.load_state_dict(case["weights"])
        return moe

    x = case["x"].clone().requires_grad_()
    moe = layer(case["capacity_factor"])
    out = moe(x)
    (out * case["g"]).sum().backward()
    with torch.no_grad():
        undropped = layer(8.0)(case["x"])
    want = {"out": out.detach(), "x_grad": x.grad,
            "router_grad": moe.router.weight.grad,
            "drops": not torch.allclose(out, undropped)}
    return case, want


def _start(out, scenario, world):
    job_dir = out / scenario
    job_dir.mkdir()
    os.link(out / "inputs.pt", job_dir / "inputs.pt")
    return (world, job_dir, launch([sys.executable, WORKER, scenario,
                                    str(job_dir)], world, str(job_dir)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_ep")
    model = jl.LlamaModel(jl.mixtral_tiny())
    variables = {"params": model.init(jax.random.PRNGKey(0), jnp.zeros(
        (1, 4), jnp.int32))["params"]}
    weights = from_flax_params(_np(variables["params"]), tl.mixtral_tiny(),
                               torch.float32)
    params, batches = _mlp_inputs()
    layer_case, layer_want = _moe_layer_case()
    torch.save({"models": {"moe": ("mixtral_tiny", {}, weights)},
                "moe_layer": layer_case,
                "tokens": torch.from_numpy(_tokens()).long(),
                "mlp": {k: torch.from_numpy(v) for k, v in params.items()},
                "mlp_batches": [tuple(torch.from_numpy(a) for a in b)
                                for b in batches]},
               out / "inputs.pt")
    jobs = {name: _start(out, name, world)
            for name, world in (("ep_world2", 2), ("ep_world4", 4))}
    refs = {"logits": np.asarray(model.apply(variables,
                                             jnp.asarray(_tokens()))),
            "steps": _jax_ep_steps(model, variables),
            "reshard": _jax_reshard_runs(params, batches),
            "smallest": _smallest_moe_grads(weights),
            "weights": weights, "moe_layer": layer_want}
    for name, (world, job_dir, procs) in jobs.items():
        join(procs, str(job_dir))
        refs[name] = [torch.load(job_dir / f"{name}.rank{r}.pt",
                                 weights_only=False) for r in range(world)]
    return refs


# -- ep ------------------------------------------------------------------------------

def test_ep2_ranks_hold_half_the_experts_and_match_jax_logits(runs):
    for rank_result in runs["ep_world2"]:
        assert rank_result["experts"] == jl.mixtral_tiny().n_experts // 2
        np.testing.assert_allclose(rank_result["logits"].numpy(),
                                   runs["logits"], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


def test_init_params_under_ep_is_the_one_card_model_cut(runs):
    """Each rank draws every tensor whole at the seed and keeps its
    experts (dim 0 of the stacks, llama_param_specs' 'ep')."""
    from mpi_operator_tpu_torch.models.params import init_params
    cfg = tl.mixtral_tiny()
    want = dict(init_params(cfg, torch.Generator().manual_seed(7),
                            device="cpu").named_parameters())
    specs = tl.llama_param_specs(cfg)
    for r, rank_result in enumerate(runs["ep_world2"]):
        got = rank_result["init"]
        assert set(got) == set(want)
        for name, full in want.items():
            piece = full.chunk(2, 0)[r] if specs[name][0] == "ep" else full
            assert torch.equal(got[name], piece.detach()), name


@pytest.mark.parametrize("job,key", [("ep_world2", "train"),
                                     ("ep_world4", "ep_tp"),
                                     ("ep_world4", "fsdp_ep")])
def test_three_adamw_steps_match_the_jax_ep_step(runs, job, key):
    """ep = 2 (replicated plan), ep = 2 x tp = 2 (E over ep, F over tp)
    and fsdp = 2 x ep = 2 (FSDP2 over each ep index's expert shard)
    against the JAX step on dp = 2 x ep = 2 x tp = 2 (the same global
    batch: its dp mean is the full batch's)."""
    want_metrics, want = runs["steps"]
    for rank_result in runs[job]:
        run = rank_result[key]
        assert_metrics_close(run["metrics"], want_metrics)
        assert_params_close(run["params"], want, runs["smallest"],
                            f"{job} {key}")


@pytest.mark.parametrize("mesh", ["dp_sp", "sp_ep"])
def test_sharded_tokens_are_dropped_as_in_the_global_batch(runs, mesh):
    """MoEMLP over tokens cut by rows (dp = 2) and columns (sp = 2), and
    by columns beside ep = 2, at a capacity factor that drops
    assignments: each rank routes its own tokens at the global capacity
    and positions, so its output and input gradient are its rows and
    columns of the one-process layer's on the whole batch (whose drops
    are the JAX layer's: tests/test_torch_moe.py), and the token shards'
    router gradients sum to the whole batch's."""
    want = runs["moe_layer"]
    assert want["drops"]
    got = [r["moe_layer"][mesh] for r in runs["ep_world4"]]
    for res in got:
        for key in ("out", "x_grad"):
            torch.testing.assert_close(
                res[key], want[key][res["rows"], res["cols"]],
                atol=STEP_TOL, rtol=STEP_TOL)
    router = sum(res["router_grad"] for res in got) / got[0]["ep"]
    torch.testing.assert_close(router, want["router_grad"], atol=STEP_TOL,
                               rtol=STEP_TOL)


def test_ep_checkpoint_is_one_device_and_restores_bit_for_bit(runs):
    full = runs["weights"]
    for rank_result in runs["ep_world2"]:
        res = rank_result["ckpt"]
        for name, want in res["straight"].items():
            assert torch.equal(res["resumed"][name], want), name
            assert torch.equal(res["continued"][name], want), name
    saved = runs["ep_world2"][0]["ckpt"]["saved_shapes"]
    assert {k: v for k, v in saved.items() if "/" not in k} == \
        {k: tuple(v.shape) for k, v in full.items()}


# -- reshard_train_state ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["grow", "shrink"])
def test_reshard_lands_on_the_jax_run_and_the_straight_run(runs, name):
    """Two ranks (dp = 1 x fsdp = 2) to four (dp = 2 x fsdp = 2) and
    back, with the ZeRO update, moved before batch 3 of 6 at the same
    step; the members of the last mesh end where the JAX run on the same
    meshes and the straight run on four ranks end."""
    members = [r["reshard"][name] for r in runs["ep_world4"]
               if r["reshard"][name] is not None]
    assert len(members) == (4 if name == "grow" else 2)
    golden = runs["ep_world4"][0]["reshard"]["golden"]["state"]["model"]
    for got in members:
        assert got["steps_at_switch"] == 3 and got["state"]["step"] == 6
        for key, want in runs["reshard"][name].items():
            np.testing.assert_allclose(got["state"]["model"][key].numpy(),
                                       want, atol=STEP_TOL, rtol=STEP_TOL)
            np.testing.assert_allclose(got["state"]["model"][key].numpy(),
                                       golden[key].numpy(), atol=STEP_TOL,
                                       rtol=STEP_TOL)
            np.testing.assert_allclose(runs["reshard"]["golden"][key],
                                       want, atol=STEP_TOL, rtol=STEP_TOL)


def test_reshard_is_pure_data_movement(runs):
    """A ZeRO state of two ranks (its moments in halves) moved onto four
    (in quarters) gathers back to the same bits, at the same step."""
    moved = [r["moved"] for r in runs["ep_world4"]]
    before = moved[0]["before"]
    assert before["step"] == 1
    for m in moved:
        after = m["after"]
        assert m["masters"] == 2 and after["step"] == before["step"]
        for key, want in before["model"].items():
            assert torch.equal(after["model"][key], want), key
        for i, entry in before["optimizer"]["state"].items():
            for key, want in entry.items():
                assert torch.equal(after["optimizer"]["state"][i][key],
                                   want), (i, key)
        assert after["optimizer"]["param_groups"] == \
            before["optimizer"]["param_groups"]


def test_reshard_across_plans_keeps_the_state(runs):
    """The replicated ZeRO state moved onto FSDP2 (dp = 2 x fsdp = 2,
    its optimizer state keyed by parameter name) and from there onto one
    rank holds the same values, bit for bit."""
    before = runs["ep_world4"][0]["moved"]["before"]
    across = runs["ep_world4"][0]["across"]
    assert across["plan"] == "_ShardedPlan"
    names = ["w1", "w2"]
    sharded, back = across["sharded"], across["back"]
    assert sharded["step"] == back["step"] == before["step"]
    for key, want in before["model"].items():
        assert torch.equal(sharded["model"][key], want), key
        assert torch.equal(back["model"][key], want), key
    for i, entry in before["optimizer"]["state"].items():
        for key, want in entry.items():
            assert torch.equal(sharded["optimizer"]["state"][names[i]][key]
                               .cpu(), want), (i, key)
            assert torch.equal(back["optimizer"]["state"][i][key], want)
