"""MoE under pipeline parallelism, and re-sharding a pipeline state, in
the PyTorch port (gloo on the CPU) against the JAX package.

Ranks are real processes (``tests/torch_dist_worker.py``); a world-2 job
(pp = 2) and a world-4 job (pp = 4, dp = 2 x pp = 2, fsdp = 2 x pp = 2,
and the grow and shrink re-shards) run while the JAX references are
computed on JAX's 8 host devices, each joined with a deadline.  Held, on
a 4-layer ``mixtral_tiny`` in f32 (4 experts, top-2):

- the loss and every gradient leaf of ``pipeline_loss`` (GPipe) and
  ``pipeline_loss_and_grads_1f1b`` (1F1B, interleaved V = 2) at pp = 2
  and 4, dp = 2 x pp = 2 and fsdp = 2 x pp = 2 with ``fsdp_shard``,
  against JAX's functions on the same mesh at ``tests/test_pipeline.py``'s
  bounds.  The JAX stages run ``LlamaBlock`` inside ``shard_map``: each
  MoE layer counts its capacity over one microbatch of its batch shard,
  so with drops the pipeline's loss is not the sequential model's (held:
  it differs here), and a stage that counts it over every batch shard's
  rows (a planted fault) fails;
- three AdamW steps of ``build_train_step`` over pp against optax.adamw
  on JAX's pipeline gradients, at 1e-5;
- the routing of each MoE layer in the 1F1B B slot's recompute equals
  the F slot's, and a recompute planted to route elsewhere fails;
- ``reshard_train_state`` of a pipeline state: llama2_tiny from pp = 2 to
  fsdp = 2 and grown from dp = 2 (two ranks) to dp = 2 x pp = 2,
  mixtral_tiny from pp = 4 to fsdp = 2 x pp = 2 with ``pp_fsdp`` and
  shrunk from dp = 2 x pp = 2 to ep = 2 (two ranks), each at step 2 of 4,
  against the JAX run that moves its state by
  ``jtrain.reshard_train_state`` on the same meshes and (but the shrink)
  the straight run, at 1e-5; the moved state bit-equal to the state
  before;
- the stage's seeded draws and fsdp cuts of the expert stacks, the
  training example with ``--config mixtral-tiny --pp 2``.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpi_operator_tpu.models import llama as jl
from mpi_operator_tpu.models import llama_pipeline as jlp
from mpi_operator_tpu.parallel import mesh as jmesh
from mpi_operator_tpu.parallel import train as jtrain
from mpi_operator_tpu_torch.models import llama as tl
from mpi_operator_tpu_torch.models import llama_pipeline as tlp
from mpi_operator_tpu_torch.models.params import (from_flax_params,
                                                  init_params, init_params_)
from mpi_operator_tpu_torch.parallel import mesh as tmesh
from test_torch_distributed import (LR, STEP_TOL, TRAIN_EXAMPLE, WORKER,
                                    assert_metrics_close,
                                    assert_params_close, join, launch)

LOSS_TOL = 2e-5                          # tests/test_pipeline.py:367
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5        # tests/test_pipeline.py:378
JOB_DEADLINE_S = 600     # the jobs share the host with other test workers
N_LAYERS = 4

# The JAX references of one pass: (mesh, devices, M, V, fsdp_shard, gpipe).
PASSES = {"gpipe": (dict(pp=2), 2, 4, 1, False, True),
          "1f1b": (dict(pp=2), 2, 4, 1, False, False),
          "interleaved": (dict(pp=2), 2, 4, 2, False, False),
          "1f1b_pp4": (dict(pp=4), 4, 4, 1, False, False),
          "1f1b_dp2": (dict(dp=2, pp=2), 4, 2, 1, False, False),
          "1f1b_fsdp2": (dict(fsdp=2, pp=2), 4, 2, 1, True, False),
          "gpipe_fsdp2": (dict(fsdp=2, pp=2), 4, 2, 1, True, True)}
JOB = {"gpipe": "moe_pp_world2", "1f1b": "moe_pp_world2",
       "interleaved": "moe_pp_world2", "steps_1f1b": "moe_pp_world2"}
# Three AdamW steps: the pass whose JAX gradients optax takes.
STEPS = {"steps_1f1b": "1f1b", "steps_1f1b_dp2": "1f1b_dp2",
         "steps_gpipe_fsdp2": "gpipe_fsdp2"}
# The re-shard runs: (job, key, model, [(JAX mesh, devices, M or None)],
# the port's straight run).
RESHARD = {"pp2_to_fsdp2": ("moe_pp_world2", "reshard_pp_fsdp", "dense",
                            [(dict(pp=2), 2, 4), (dict(fsdp=2), 2, None)],
                            ("moe_pp_world2", "straight_pp")),
           "dp2_to_dp2_pp2": ("moe_pp_world4", "reshard_grow", "dense",
                              [(dict(dp=2), 2, None),
                               (dict(dp=2, pp=2), 4, 2)],
                              ("moe_pp_world4", "straight_dp2")),
           "dp2_pp2_to_ep2": ("moe_pp_world4", "reshard_shrink", "moe",
                              [(dict(dp=2, pp=2), 4, 2),
                               (dict(ep=2), 2, None)], None),
           "pp4_to_fsdp2_pp2": ("moe_pp_world4", "reshard_pp4_fsdp2", "moe",
                                [(dict(pp=4), 4, 4),
                                 (dict(fsdp=2, pp=2), 4, 2)],
                                ("moe_pp_world4", "straight_pp4"))}


def _configs():
    return {"moe": jl.mixtral_tiny(n_layers=N_LAYERS),
            "dense": jl.llama2_tiny(n_layers=N_LAYERS)}


def _torch_cfg(kind):
    return (tl.mixtral_tiny if kind == "moe" else tl.llama2_tiny)(
        n_layers=N_LAYERS)


def _tokens():
    return np.random.default_rng(12).integers(0, 256, (8, 16)).astype(
        np.int32)


def _port(tree, kind="moe"):
    return from_flax_params(jax.tree_util.tree_map(np.asarray, tree),
                            _torch_cfg(kind), torch.float32)


def _jax_mesh(axes, n_devices):
    return jmesh.create_mesh(jmesh.MeshConfig(**{"dp": 1, **axes}),
                             devices=jax.devices()[:n_devices])


def _jax_loss_fn(cfg, mesh, m, toks):
    """The JAX loss on ``mesh``: pipeline_loss (GPipe) over m
    microbatches, or with m None the model on the mesh."""
    if m is not None:
        return lambda v: jlp.pipeline_loss(cfg, v, toks, mesh, m)
    model = jl.LlamaModel(cfg, mesh=mesh)
    return lambda v: jl.next_token_loss(model.apply(v, toks), toks)


def _jax_adamw(fn, variables, legs, kind="moe"):
    """AdamW steps of optax on fn(leg)(variables) -> (loss, grads): for
    each of ``legs`` ((mesh, param specs, steps)), the state moved onto
    its mesh by jtrain.reshard_train_state first.  Returns every step's
    (loss, grad_norm), the final weights and, per element, the smallest
    |gradient| met (as the port's state dicts)."""
    tx = optax.adamw(LR)
    params = variables
    opt_state = tx.init(params)
    metrics, smallest = [], None
    for i, (mesh, specs, steps) in enumerate(legs):
        if i:
            moved = jtrain.reshard_train_state(jtrain.TrainState(
                step=jnp.asarray(len(metrics), jnp.int32), params=params,
                opt_state=opt_state), mesh, param_specs=specs)
            assert int(moved.step) == len(metrics)
            params, opt_state = moved.params, moved.opt_state
        step = fn(i)
        with mesh:
            for _ in range(steps):
                loss, grads = step(params)
                metrics.append((float(loss), float(optax.global_norm(
                    grads))))
                g = _port(jax.tree_util.tree_map(jnp.abs, grads), kind)
                smallest = g if smallest is None else {
                    n: torch.minimum(smallest[n], t) for n, t in g.items()}
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
    return metrics, _port(params, kind), smallest


def _references(variables, tokens):
    cfgs = _configs()
    cfg, toks = cfgs["moe"], jnp.asarray(tokens)
    model = jl.LlamaModel(cfg)
    refs = {"sequential_loss": float(jl.next_token_loss(
        model.apply(variables["moe"], toks), toks))}
    fns = {}
    for name, (axes, n_dev, m, v, fsdp, gpipe) in PASSES.items():
        mesh = _jax_mesh(axes, n_dev)
        if gpipe:
            step = jax.jit(jax.value_and_grad(
                lambda var, mesh=mesh, m=m, fsdp=fsdp: jlp.pipeline_loss(
                    cfg, var, toks, mesh, m, fsdp_shard=fsdp)))
        else:
            def f1b(var, mesh=mesh, m=m, v=v, fsdp=fsdp):
                loss, grads = jlp.pipeline_loss_and_grads_1f1b(
                    cfg, var, toks, mesh, m, virtual_stages=v,
                    fsdp_shard=fsdp)
                return loss, {"params": grads}
            step = jax.jit(f1b)
        fns[name] = (mesh, step)
        with mesh:
            loss, grads = step(variables["moe"])
        refs[name] = (float(loss), _port(grads))
    for name, of in STEPS.items():
        mesh, step = fns[of]
        refs[name] = _jax_adamw(lambda i, step=step: step,
                                variables["moe"], [(mesh, None, 3)])
    for name, (_, _, kind, legs, _) in RESHARD.items():
        meshes = [(_jax_mesh(axes, n), m) for axes, n, m in legs]
        specs = jl.llama_param_specs(cfgs[kind])

        def fn(i, kind=kind, meshes=meshes):
            mesh, m = meshes[i]
            return jax.jit(jax.value_and_grad(
                _jax_loss_fn(cfgs[kind], mesh, m, toks)))

        refs[name] = _jax_adamw(
            fn, variables[kind],
            [(mesh, None if m is not None else specs, 2)
             for mesh, m in meshes], kind)
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_moe_pp")
    variables = {kind: {"params": jl.LlamaModel(cfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))["params"]}
        for kind, cfg in _configs().items()}
    weights = {kind: _port(v["params"], kind)
               for kind, v in variables.items()}
    tokens = torch.from_numpy(_tokens()).long()
    torch.save({"config": {}, "moe_config": {"n_layers": N_LAYERS},
                "moe_weights": weights["moe"], "moe_tokens": tokens,
                "pp_config": {"n_layers": N_LAYERS},
                "pp_weights": weights["dense"], "pp_tokens": tokens},
               out / "inputs.pt")
    jobs = {}
    for name, world in (("moe_pp_world2", 2), ("moe_pp_world4", 4)):
        job_dir = out / name
        job_dir.mkdir()
        os.link(out / "inputs.pt", job_dir / "inputs.pt")
        jobs[name] = (world, job_dir, launch(
            [sys.executable, WORKER, name, str(job_dir)], world,
            str(job_dir)))
    refs = _references(variables, _tokens())
    refs["weights"] = weights
    for name, (world, job_dir, procs) in jobs.items():
        join(procs, str(job_dir), deadline_s=JOB_DEADLINE_S)
        refs[name] = [torch.load(job_dir / f"{name}.rank{r}.pt",
                                 weights_only=False) for r in range(world)]
    return refs


def _loss_and_grads_failures(got, want):
    """What of one pass lies outside the JAX tests' bounds."""
    bad = []
    want_loss, want_grads = want
    if abs(got["loss"] - want_loss) > LOSS_TOL * abs(want_loss):
        bad.append(f"loss {got['loss']} vs {want_loss}")
    assert set(got["grads"]) == set(want_grads)
    for name, g in want_grads.items():
        err = (got["grads"][name] - g).abs()
        if (err > GRAD_ATOL + GRAD_RTOL * g.abs()).any():
            bad.append(f"{name} max err {err.max().item():.3g}")
    return bad


# -- (1) one pass: loss and gradients --------------------------------------------

@pytest.mark.parametrize("name", list(PASSES))
def test_moe_pipeline_loss_and_grads_match_jax(runs, name):
    """Loss and every gradient leaf (embedding, attention, router, expert
    stacks, norms, head), joined from the stages, on every rank, against
    JAX's pipeline function on the same mesh."""
    for rank in runs[JOB.get(name, "moe_pp_world4")]:
        assert _loss_and_grads_failures(rank[name], runs[name]) == [], name


def test_capacity_counts_one_microbatch_of_a_batch_shard(runs):
    """The JAX pipeline drops per microbatch of a batch shard, which
    here is not what the sequential model drops; a stage of the port
    that counts its capacity over the microbatch of both dp shards
    fails the bounds."""
    want = runs["1f1b_dp2"]
    assert abs(want[0] - runs["sequential_loss"]) > 100 * LOSS_TOL
    for rank in runs["moe_pp_world4"]:
        assert _loss_and_grads_failures(rank["1f1b_dp2_fault"], want)


def test_recompute_routes_as_the_forward_slot(runs):
    """Each MoE layer's expert choice in the 1F1B B slot's recompute is
    the F slot's, microbatch by microbatch; a recompute that routes each
    assignment to the next expert changes the gradients past the
    bounds."""
    for rank in runs["moe_pp_world2"]:
        assert rank["recompute"]["routing_equal"] is True
        assert _loss_and_grads_failures(rank["recompute"],
                                        runs["1f1b"]) == []
        assert rank["recompute_fault"]["routing_equal"] is False
        assert _loss_and_grads_failures(rank["recompute_fault"],
                                        runs["1f1b"])


# -- (2) training -------------------------------------------------------------------

@pytest.mark.parametrize("name", list(STEPS))
def test_three_adamw_steps_match_optax_on_jax_moe_pipeline(runs, name):
    """build_train_step over pp (1F1B at pp = 2 and dp = 2 x pp = 2, GPipe
    at fsdp = 2 x pp = 2 with pp_fsdp): every rank's (loss, grad_norm)
    and the joined weights after three steps, against optax.adamw on
    JAX's gradients."""
    want_metrics, want, smallest = runs[name]
    for rank in runs[JOB.get(name, "moe_pp_world4")]:
        run = rank[name]
        assert_metrics_close(run["metrics"], want_metrics)
        assert_params_close(run["params"], want, smallest, name)


# -- (3) reshard_train_state of a pipeline --------------------------------------------

def _by_name(optim, names):
    """An optimizer state dict's entries keyed by parameter name."""
    return {names[k] if isinstance(k, int) else k: v
            for k, v in optim["state"].items()}


def _assert_same_state(a, b, names):
    assert a["step"] == b["step"]
    assert a["model"].keys() == b["model"].keys()
    for key, want in a["model"].items():
        assert torch.equal(b["model"][key].cpu(), want.cpu()), key
    sa, sb = _by_name(a["optimizer"], names), _by_name(b["optimizer"], names)
    assert sa.keys() == sb.keys() == set(names)
    for name, entry in sa.items():
        for key, want in entry.items():
            assert torch.equal(sb[name][key].cpu(), want.cpu()), (name, key)
    def hyper(optim):
        # FSDP2's state dict gives betas as a list.
        return [{k: tuple(v) if isinstance(v, list) else v
                 for k, v in g.items() if k != "params"}
                for g in optim["param_groups"]]

    assert hyper(a["optimizer"]) == hyper(b["optimizer"])


@pytest.mark.parametrize("case", list(RESHARD))
def test_pipeline_reshard_lands_on_the_jax_run_and_the_straight_run(runs,
                                                                    case):
    """Moved before step 2 of 4 at the same step: every step's loss and
    grad_norm and the final weights against the JAX run on the same
    meshes (which moves its state by jtrain.reshard_train_state) and,
    but for the shrink to ep, the port's straight run; the state right
    after the move is the state before it, bit for bit.  (The shrink has
    no straight run: the pipeline drops per microbatch and the ep model
    over the whole batch, so the steps before and after the move compute
    different functions; the JAX run makes the same switch.  From pp = 4
    to fsdp = 2 x pp = 2 a microbatch holds two rows on both meshes.)"""
    job, key, kind, _, straight = RESHARD[case]
    got = [r[key] for r in runs[job] if r[key] is not None]
    assert len(got) == (2 if job == "moe_pp_world2" or "shrink" in key
                        else 4)
    run = got[0]
    assert run["plan"] == {"reshard_pp_fsdp": "_ShardedPlan",
                           "reshard_grow": "_PipelinePlan",
                           "reshard_pp4_fsdp2": "_PipelinePlan",
                           "reshard_shrink": "_ReplicatedPlan"}[key]
    want_metrics, want, smallest = runs[case]
    assert_metrics_close(run["metrics"], want_metrics)
    params = {k: v.cpu() for k, v in run["final"]["model"].items()}
    assert_params_close(params, want, smallest, case)
    if straight is not None:
        plain = runs[straight[0]][0][straight[1]]
        assert_metrics_close(run["metrics"], plain["metrics"])
        for name, t in plain["final"]["model"].items():
            np.testing.assert_allclose(params[name].numpy(),
                                       t.cpu().numpy(), atol=STEP_TOL,
                                       rtol=STEP_TOL, err_msg=name)
    names = [n for n, _ in tl.LlamaModel(_torch_cfg(kind),
                                         device="meta").named_parameters()]
    assert run["before"]["step"] == 2 and run["final"]["step"] == 4
    _assert_same_state(run["before"], run["after"], names)


# -- (4) the stage's tensors, the example ---------------------------------------------

def _fake_mesh(index=0, **axes):
    shape = tuple(axes.get(a, 1) for a in tmesh.AXIS_NAMES)
    return types.SimpleNamespace(mesh_dim_names=tmesh.AXIS_NAMES,
                                 shape=shape,
                                 get_local_rank=lambda axis: index,
                                 get_group=lambda axis: None)


def test_moe_stage_draws_and_owners_cover_the_expert_stacks():
    """A MoE stage at a seed holds init_params' tensors of its layers
    (the expert stacks drawn as flax's lecun_normal draws them), every
    name's owner is its stage, and from_flax_params(stage=) gives the
    stage's names: no case of their own for the router or the stacks."""
    cfg = _torch_cfg("moe")
    whole = init_params(cfg, torch.Generator().manual_seed(3), device="cpu",
                        dtype=torch.float32).state_dict()
    tree = jl.LlamaModel(_configs()["moe"]).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))
    for n_stages, virtual in ((2, 1), (4, 1), (2, 2)):
        for p in range(n_stages):
            stage = tlp.LlamaStage(cfg, mesh=_fake_mesh(p, pp=n_stages),
                                   virtual_stages=virtual, device="cpu",
                                   store_dtype=torch.float32)
            init_params_(stage, torch.Generator().manual_seed(3))
            own = stage.state_dict()
            assert {n for n in own if "feed_forward" in n} == {
                f"layers.{i}.feed_forward.{w}" for i in stage.layer_ids
                for w in ("w1", "w2", "w3", "router.weight")}
            assert own.keys() == from_flax_params(
                tree, cfg, torch.float32, stage=stage).keys()
            for name, t in own.items():
                assert torch.equal(t, whole[name]), (n_stages, p, name)
                assert tlp.layer_owner(name, N_LAYERS, n_stages,
                                       virtual) == p


def test_fsdp_stage_cuts_the_expert_stacks_and_router_on_experts(runs):
    """fsdp = 2 x pp = 2 with pp_fsdp: the expert stacks [E, D, F] /
    [E, F, D] and the router [E, D] are cut along E by the rule every
    matrix takes (stage_param_fsdp_dims), and the chunks of each rank,
    joined, are init_params' weights at the seed."""
    whole = init_params(_torch_cfg("moe"), torch.Generator().manual_seed(7),
                        device="cpu", dtype=torch.float32).state_dict()
    for rank in runs["moe_pp_world4"]:
        dims = rank["init_fsdp"]["dims"]
        moe = {n: d for n, d in dims.items() if "feed_forward" in n}
        assert len(moe) == 4 * 2 and set(moe.values()) == {0}
        for name, t in rank["init_fsdp"]["joined"].items():
            assert torch.equal(t, whole[name]), name


def test_train_example_trains_mixtral_over_pp_1f1b(tmp_path):
    """The example's 1F1B schedule over pp (its GPipe default runs in
    tests/test_torch_ring_attention.py)."""
    logs = join(launch([sys.executable, TRAIN_EXAMPLE, "--config",
                        "mixtral-tiny", "--device", "cpu", "--steps", "2",
                        "--pp", "2", "--seq-len", "32", "--batch", "2",
                        "--pipeline-schedule", "1f1b", "--microbatches",
                        "2"], 2, str(tmp_path)), str(tmp_path))
    assert "mesh dp=1 fsdp=1 pp=2 ep=1 tp=1 sp=1" in logs[0], logs[0]
    assert np.isfinite(float(logs[0].split("loss=")[1].split()[0]))
    assert "mesh dp" not in logs[1]
