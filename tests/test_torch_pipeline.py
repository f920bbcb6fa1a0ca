"""Pipeline parallelism of the PyTorch port (gloo on the CPU) against the
JAX package.

Ranks are real processes (``tests/torch_dist_worker.py``); a world-2 job
(pp = 2) and a world-4 job (pp = 4, dp = 2 x pp = 2, fsdp = 2 x pp = 2)
run while the JAX references are computed on JAX's 8 host devices, each
joined with a deadline.  Held:

- the port's copies of ``_simulate_1f1b``, ``_phase_bounds`` and
  ``_simulate_interleaved`` equal to JAX's entry for entry, their
  errors, and each tick's messages (``tick_ops``): every send meets its
  receive in order, and no ring-buffer slot is overwritten before it is
  read;
- ``pipeline_apply`` on tests/test_pipeline.py's MLP stages, forward and
  gradients, against JAX's at that file's bounds;
- ``pipeline_forward`` logits of a 4-layer llama2_tiny at pp = 2 and 4
  against JAX's ``pipeline_forward`` and ``LlamaModel.apply`` (1e-4);
- ``pipeline_loss_and_grads_1f1b`` at pp = 2 and 4, dp = 2 x pp = 2,
  interleaved V = 2, and fsdp = 2 x pp = 2 with ``fsdp_shard`` (1F1B and
  interleaved), against JAX's function on the same mesh and
  ``jax.value_and_grad`` of the sequential model, at the JAX tests'
  bounds (loss 2e-5, every leaf rtol 2e-4 / atol 2e-5);
- three AdamW steps of ``build_train_step`` over pp (gpipe, 1f1b, and on
  dp x pp and fsdp x pp with ``pp_fsdp``) against optax.adamw on JAX's
  (loss, grads), at 1e-5;
- a pp checkpoint saved in the one-device format, restored and trained
  on bit for bit; a stage's seeded draws and its part of a JAX tree;
- the example over two and four processes, and the refusals.
"""

import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from mpi_operator_tpu.models import llama as jl
from mpi_operator_tpu.models import llama_pipeline as jlp
from mpi_operator_tpu.parallel import mesh as jmesh
from mpi_operator_tpu.parallel import pipeline as jpipe
from mpi_operator_tpu_torch.models import llama as tl
from mpi_operator_tpu_torch.models import llama_pipeline as tlp
from mpi_operator_tpu_torch.models.params import (from_flax_params,
                                                  init_params, init_params_)
from mpi_operator_tpu_torch.ops.moe import MoEMLP
from mpi_operator_tpu_torch.parallel import mesh as tmesh
from mpi_operator_tpu_torch.parallel import pipeline as tpipe
from mpi_operator_tpu_torch.parallel import train as ttrain
from mpi_operator_tpu_torch.parallel.tensor import refuse_pp_mix
from test_torch_distributed import (LR, TRAIN_EXAMPLE, WORKER,
                                    assert_metrics_close,
                                    assert_params_close, join, launch)

LOSS_TOL = 2e-5                          # tests/test_pipeline.py:367
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5        # tests/test_pipeline.py:378
MLP_FWD_TOL = 1e-5                       # tests/test_pipeline.py:62
MLP_GRAD_RTOL, MLP_GRAD_ATOL = 1e-4, 1e-5   # tests/test_pipeline.py:89
LOGIT_TOL = 1e-4                         # model logits in f32 (ROADMAP.md)
JOB_DEADLINE_S = 600     # the jobs share the host with other test workers
N_LAYERS = 4
MLP = {2: dict(d=8, hidden=16, batch=16), 4: dict(d=16, hidden=32, batch=8)}
MLP_MESH = {2: dict(dp=4, pp=2), 4: dict(dp=2, pp=4)}

# The JAX references of the 1F1B runs: (mesh, devices, M, V, fsdp_shard).
F1B = {"1f1b": (dict(dp=1, pp=2), 2, 4, 1, False),
       "interleaved": (dict(dp=1, pp=2), 2, 4, 2, False),
       "1f1b_pp4": (dict(dp=1, pp=4), 4, 4, 1, False),
       "1f1b_dp2": (dict(dp=2, pp=2), 4, 2, 1, False),
       "1f1b_fsdp2": (dict(dp=1, fsdp=2, pp=2), 4, 2, 1, True),
       "interleaved_fsdp2": (dict(dp=1, fsdp=2, pp=2), 4, 2, 2, True)}
# Three AdamW steps: (JAX reference, schedule) of each torch run.
STEPS = {"steps_gpipe": ("gpipe", dict(dp=1, pp=2), 2, 4, False),
         "steps_1f1b": ("1f1b", "1f1b"),
         "steps_1f1b_dp2": ("1f1b", "1f1b_dp2"),
         "steps_gpipe_fsdp2": ("gpipe", dict(dp=1, fsdp=2, pp=2), 4, 2, True),
         "steps_interleaved_fsdp2": ("1f1b", "interleaved_fsdp2")}
JOB = {"1f1b": "pp_world2", "interleaved": "pp_world2",
       "steps_gpipe": "pp_world2", "steps_1f1b": "pp_world2"}


def _cfg():
    return jl.llama2_tiny(n_layers=N_LAYERS)


def _tokens():
    return np.random.default_rng(12).integers(0, 256, (8, 16)).astype(
        np.int32)


def _port(tree):
    return from_flax_params(jax.tree_util.tree_map(np.asarray, tree),
                            tl.llama2_tiny(n_layers=N_LAYERS), torch.float32)


def _mlp_inputs():
    rng = np.random.default_rng(4)
    out = {}
    for n, c in MLP.items():
        stages = [{"w1": rng.standard_normal((c["d"], c["hidden"])) * 0.1,
                   "b1": rng.standard_normal(c["hidden"]) * 0.1,
                   "w2": rng.standard_normal((c["hidden"], c["d"])) * 0.1}
                  for _ in range(n)]
        x = rng.standard_normal((c["batch"], c["d"]))
        out[n] = {"stages": [{k: v.astype(np.float32) for k, v in s.items()}
                             for s in stages],
                  "micro": x.astype(np.float32).reshape(4, -1, c["d"])}
    return out


def _jax_mlp(case, n):
    """JAX's pipeline_apply on the stages: outputs and the gradients of
    mean(out ** 2) w.r.t. the stacked params and the microbatches."""
    mesh = jmesh.create_mesh(jmesh.MeshConfig(**MLP_MESH[n]))
    stacked = jpipe.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in s.items()} for s in case["stages"]])
    micro = jnp.asarray(case["micro"])

    def stage(params, x):
        return jnp.tanh(x @ params["w1"] + params["b1"]) @ params["w2"] + x

    def loss(st, mi):
        out = jpipe.pipeline_apply(stage, st, mi, mesh)
        return jnp.mean(out ** 2), out

    with mesh:
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(stacked, micro)
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, grads)


def _jax_mesh(mesh_cfg, n_devices):
    return jmesh.create_mesh(jmesh.MeshConfig(**mesh_cfg),
                             devices=jax.devices()[:n_devices])


def _jax_adamw(fn, variables):
    """Three optax.adamw steps on fn(variables) -> (loss, grads):
    [(loss, grad_norm)] and the final weights as the port's state
    dict."""
    tx = optax.adamw(LR)
    params = variables["params"]
    opt_state = tx.init(params)
    metrics = []
    for _ in range(3):
        loss, grads = fn({"params": params})
        metrics.append((float(loss), float(optax.global_norm(grads))))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    return metrics, _port(params)


def _references(variables, tokens):
    cfg = _cfg()
    model = jl.LlamaModel(cfg)
    toks = jnp.asarray(tokens)
    refs = {"apply": np.asarray(jax.jit(model.apply)(variables, toks))}
    for pp, (mesh_cfg, m) in {2: (dict(dp=4, pp=2), 2),
                              4: (dict(dp=2, pp=4), 4)}.items():
        mesh = jmesh.create_mesh(jmesh.MeshConfig(**mesh_cfg))
        with mesh:
            refs[f"logits_pp{pp}"] = np.asarray(jax.jit(
                lambda v, t, mesh=mesh, m=m: jlp.pipeline_forward(
                    cfg, v, t, mesh, num_microbatches=m))(variables, toks))
    loss, grads = jax.value_and_grad(
        lambda v: jl.next_token_loss(model.apply(v, toks), toks))(variables)
    refs["sequential"] = (float(loss), _port(grads["params"]))
    fns = {}
    for name, (mesh_cfg, n_dev, m, v, fsdp) in F1B.items():
        mesh = _jax_mesh(mesh_cfg, n_dev)
        fns[name] = jax.jit(
            lambda var, mesh=mesh, m=m, v=v, fsdp=fsdp:
            jlp.pipeline_loss_and_grads_1f1b(cfg, var, toks, mesh, m,
                                             virtual_stages=v,
                                             fsdp_shard=fsdp))
        loss, grads = fns[name](variables)
        refs[name] = (float(loss), _port(grads))
    for name, spec in STEPS.items():
        if spec[0] == "1f1b":
            refs[name] = _jax_adamw(fns[spec[1]], variables)
            continue
        _, mesh_cfg, n_dev, m, fsdp = spec
        mesh = _jax_mesh(mesh_cfg, n_dev)
        step = jax.jit(jax.value_and_grad(
            lambda var, mesh=mesh, m=m, fsdp=fsdp: jlp.pipeline_loss(
                cfg, var, toks, mesh, m, fsdp_shard=fsdp)))

        def fn(var, step=step):
            loss, grads = step(var)
            return loss, grads["params"]
        refs[name] = _jax_adamw(fn, variables)
    return refs


def _smallest(weights, tokens):
    """Per element, the smallest |gradient| over three steps of the
    one-process port on the global batch (assert_params_close's guard)."""
    model = tl.LlamaModel(tl.llama2_tiny(n_layers=N_LAYERS), device="cpu",
                          store_dtype=torch.float32)
    model.load_state_dict(weights)
    init, step = ttrain.build_train_step(
        lambda m, b: tl.next_token_loss(m(b), b), ttrain.adamw(LR))
    state = init(model)
    smallest = {n: torch.full_like(p, float("inf"))
                for n, p in model.named_parameters()}
    for _ in range(3):
        state, _ = step(state, torch.from_numpy(tokens).long())
        for n, p in state.model.named_parameters():
            smallest[n] = torch.minimum(smallest[n], p.grad.abs())
    return smallest


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_pp")
    cfg = _cfg()
    variables = jl.LlamaModel(cfg).init(jax.random.PRNGKey(1),
                                        jnp.zeros((1, 4), jnp.int32))
    weights = _port(variables["params"])
    tokens = _tokens()
    mlp = _mlp_inputs()
    torch.save({"config": {}, "pp_config": {"n_layers": N_LAYERS},
                "pp_weights": weights,
                "pp_tokens": torch.from_numpy(tokens).long(),
                "mlp": {n: {"stages": [{k: torch.from_numpy(v) for k, v in
                                        s.items()} for s in c["stages"]],
                            "micro": torch.from_numpy(c["micro"])}
                        for n, c in mlp.items()}}, out / "inputs.pt")
    jobs = {}
    for name, world in (("pp_world2", 2), ("pp_world4", 4)):
        job_dir = out / name
        job_dir.mkdir()
        os.link(out / "inputs.pt", job_dir / "inputs.pt")
        jobs[name] = (world, job_dir, launch(
            [sys.executable, WORKER, name, str(job_dir)], world,
            str(job_dir)))
    refs = _references(variables, tokens)
    refs["mlp"] = {n: _jax_mlp(c, n) for n, c in mlp.items()}
    refs["smallest"] = _smallest(weights, tokens)
    refs["weights"] = weights
    for name, (world, job_dir, procs) in jobs.items():
        join(procs, str(job_dir), deadline_s=JOB_DEADLINE_S)
        refs[name] = [torch.load(job_dir / f"{name}.rank{r}.pt",
                                 weights_only=False) for r in range(world)]
    return refs


# -- (1) the static schedules ------------------------------------------------------

@pytest.mark.parametrize("n_stages,n_micro", [
    (p, m) for p in (2, 3, 4) for m in sorted({p, p + 1, 2 * p, 8})])
def test_1f1b_tables_equal_jax(n_stages, n_micro):
    got = tpipe._simulate_1f1b(n_stages, n_micro)
    want = jpipe._simulate_1f1b(n_stages, n_micro)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    head = want[0][-1] >= 0
    assert tpipe._phase_bounds(got[0], got[1], got[2], head) == \
        jpipe._phase_bounds(want[0], want[1], want[2], head)


@pytest.mark.parametrize("n_stages,n_virtual,n_micro", [
    (p, v, k * p) for p in (2, 3, 4) for v in (1, 2, 3) for k in (1, 2, 3)])
def test_interleaved_tables_equal_jax(n_stages, n_virtual, n_micro):
    got = tpipe._simulate_interleaved(n_stages, n_virtual, n_micro)
    want = jpipe._simulate_interleaved(n_stages, n_virtual, n_micro)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:]
    head = want[0][-1] >= (n_virtual - 1) * n_micro
    assert tpipe._phase_bounds(got[0], got[1], got[2], head) == \
        jpipe._phase_bounds(want[0], want[1], want[2], head)


def test_schedule_errors_match_jax(runs):
    """M % P for the interleaved schedule (the simulator's ValueError),
    M < P for 1F1B (the schedule's, raised on every rank alike)."""
    for p, v, m in ((2, 2, 3), (4, 2, 6), (3, 3, 4)):
        with pytest.raises(ValueError) as want:
            jpipe._simulate_interleaved(p, v, m)
        with pytest.raises(ValueError) as got:
            tpipe._simulate_interleaved(p, v, m)
        assert str(got.value) == str(want.value)
    mesh = _jax_mesh(dict(dp=1, pp=2), 2)
    with pytest.raises(ValueError) as want:
        jpipe.pipeline_1f1b(lambda p, x: x, lambda *a: 0.0,
                            {"w": jnp.zeros((2, 1))}, {},
                            jnp.zeros((1, 2, 3)), mesh)
    for rank in runs["pp_world2"]:
        assert rank["m_lt_p"] == str(want.value)


def _simulate_ticks(fwd, bwd, n_ticks, P, V, M, kf, kb, kx):
    """Run the tables as the engine does (F slot, head, B slot, then the
    exchange) on slot bookkeeping alone; fail on a message without its
    partner, a chunk filed wrong, or a slot overwritten before read."""
    fbuf = [{} for _ in range(P)]
    bbuf = [{} for _ in range(P)]
    xbuf = [{} for _ in range(P)]
    for t in range(n_ticks):
        for p in range(P):
            e = int(fwd[p][t]) if t < fwd.shape[1] else -1
            if e >= 0:
                v, m = divmod(e, M)
                if not (p == 0 and v == 0):
                    assert fbuf[p].pop((v, m % kf)) == m, (p, t)
                assert (v, m % kx) not in xbuf[p], (p, t)
                xbuf[p][(v, m % kx)] = m
                if p == P - 1 and v == V - 1:
                    assert (v, m % kb) not in bbuf[p], (p, t)
                    bbuf[p][(v, m % kb)] = m
            e = int(bwd[p][t]) if t < bwd.shape[1] else -1
            if e >= 0:
                v, m = divmod(e, M)
                assert xbuf[p].pop((v, m % kx)) == m, (p, t)
                assert bbuf[p].pop((v, m % kb)) == m, (p, t)
        ops = [tpipe.tick_ops(fwd, bwd, p, t, P, V, M) for p in range(P)]
        for p in range(P):
            for q in range(P):
                sent = [(o.kind, o.micro) for o in ops[p]
                        if o.send and o.peer == q]
                got = [(o.kind, o.micro) for o in ops[q]
                       if not o.send and o.peer == p]
                assert sent == got, (t, p, q)
        for p in range(P):
            for o in ops[p]:
                if o.send:
                    continue
                src = [s for s in ops[o.peer]
                       if s.send and s.peer == p and s.kind == o.kind
                       and s.micro == o.micro][0]
                step = 1 if o.kind == "f" else -1
                assert o.chunk * P + p == src.chunk * P + o.peer + step
                buf, k = (fbuf, kf) if o.kind == "f" else (bbuf, kb)
                assert (o.chunk, o.micro % k) not in buf[p], (t, p, o)
                buf[p][(o.chunk, o.micro % k)] = o.micro
    assert not any(fbuf) and not any(bbuf) and not any(xbuf)


@pytest.mark.parametrize("n_stages,n_virtual,n_micro", [
    (2, 1, 2), (2, 1, 5), (3, 1, 4), (4, 1, 4), (4, 1, 8), (2, 2, 2),
    (2, 2, 4), (2, 3, 6), (3, 2, 3), (3, 3, 6), (4, 2, 4), (4, 2, 8),
    (4, 3, 8)])
def test_tick_ops_pair_up_and_never_overwrite_a_slot(n_stages, n_virtual,
                                                     n_micro):
    fwd, bwd, n_ticks, kf, kb, kx = tpipe.schedule(n_stages, n_micro,
                                                   n_virtual)
    _simulate_ticks(fwd, bwd, n_ticks, n_stages, n_virtual, n_micro,
                    kf, kb, kx)


@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 4), (3, 1)])
def test_gpipe_tick_ops_pair_up(n_stages, n_micro):
    """GPipe's forward sends only activations and its backward only
    gradients, tick by tick in the reverse drain."""
    fwd, bwd = tpipe._gpipe_tables(n_stages, n_micro)
    for table, kind in ((fwd, "f"), (bwd, "b")):
        f, b = (table, None) if kind == "f" else (None, table)
        for t in range(table.shape[1]):
            ops = [tpipe.tick_ops(f, b, p, t, n_stages, 1, n_micro)
                   for p in range(n_stages)]
            for p in range(n_stages):
                for o in ops[p]:
                    assert o.kind == kind
                    if o.send:
                        assert (False, kind, p, o.chunk, o.micro) in [
                            tuple(x) for x in ops[o.peer]]
    assert sorted(fwd[-1][fwd[-1] >= 0]) == list(range(n_micro))
    assert list(bwd[-1][bwd[-1] >= 0]) == list(range(n_micro))[::-1]


# -- (2) pipeline_apply, the logits ----------------------------------------------

@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_apply_matches_jax_on_mlp_stages(runs, n_stages):
    want_out, (want_stacked, want_micro) = runs["mlp"][n_stages]
    for rank in runs[f"pp_world{n_stages}"]:
        res = rank["mlp"]
        np.testing.assert_allclose(res["out"].numpy(), want_out,
                                   atol=MLP_FWD_TOL, rtol=MLP_FWD_TOL)
        for name, g in res["grads"].items():
            np.testing.assert_allclose(
                g.numpy(), want_stacked[name][res["stage"]],
                atol=MLP_GRAD_ATOL, rtol=MLP_GRAD_RTOL, err_msg=name)
        if res["stage"] == 0:
            np.testing.assert_allclose(res["x_grad"].numpy(), want_micro,
                                       atol=MLP_GRAD_ATOL,
                                       rtol=MLP_GRAD_RTOL)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_forward_logits_match_jax(runs, n_stages):
    """Every pp rank holds the logits of the whole batch shard, equal to
    JAX's pipeline_forward and to the plain model."""
    for rank in runs[f"pp_world{n_stages}"]:
        got = rank["logits"].numpy()
        for want in (runs[f"logits_pp{n_stages}"], runs["apply"]):
            np.testing.assert_allclose(got, want, atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL)


# -- (3) 1F1B loss and gradients ---------------------------------------------------

def _assert_loss_and_grads(got, want, what):
    loss, grads = got["loss"], got["grads"]
    want_loss, want_grads = want
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_TOL, err_msg=what)
    assert set(grads) == set(want_grads), what
    for name, g in want_grads.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("name", list(F1B))
def test_1f1b_loss_and_grads_match_jax_and_the_sequential_model(runs, name):
    """Loss and every gradient leaf (embedding, blocks, norm, head), joined
    from the stages on every rank, against JAX's
    pipeline_loss_and_grads_1f1b on the same mesh and against
    jax.value_and_grad of the sequential model."""
    for rank in runs[JOB.get(name, "pp_world4")]:
        for ref in (runs[name], runs["sequential"]):
            _assert_loss_and_grads(rank[name], ref, name)


# -- (4) training ---------------------------------------------------------------------

@pytest.mark.parametrize("name", list(STEPS))
def test_three_adamw_steps_match_optax_on_jax_pipeline_grads(runs, name):
    """build_train_step over pp: the loss is the last stage's global mean
    on every rank, grad_norm the global norm (every leaf once), and the
    joined weights after three steps JAX's."""
    want_metrics, want = runs[name]
    for rank in runs[JOB.get(name, "pp_world4")]:
        run = rank[name]
        assert_metrics_close(run["metrics"], want_metrics)
        assert_params_close(run["params"], want, runs["smallest"], name)


def test_pp_checkpoint_is_one_device_and_resumes_bit_for_bit(runs):
    names = [n for n, _ in tl.LlamaModel(tl.llama2_tiny(n_layers=N_LAYERS),
                                         device="meta").named_parameters()]
    for r, rank in enumerate(runs["pp_world2"]):
        ck = rank["ckpt"]
        assert ck["step"] == 4
        # Only rank 0, which writes, holds the joined state.
        assert ck["held_keys"] == (["model", "optimizer", "step"] if r == 0
                                   else ["step"])
        assert ck["saved_keys"] == sorted(names)
        assert ck["saved_optimizer_entries"] == len(names)
        for name, want in ck["straight"].items():
            assert torch.equal(ck["resumed"][name], want), name


def test_stage_init_equals_init_params_and_takes_its_part_of_a_jax_tree():
    """A stage at a seed holds init_params' tensors of its layers (every
    draw of the one-card model is made; each stage keeps its own), and
    from_flax_params(stage=) gives exactly the stage's names."""
    cfg = tl.llama2_tiny(n_layers=N_LAYERS)
    whole = init_params(cfg, torch.Generator().manual_seed(3), device="cpu",
                        dtype=torch.float32).state_dict()
    jcfg = _cfg()
    tree = jl.LlamaModel(jcfg).init(jax.random.PRNGKey(1),
                                    jnp.zeros((1, 4), jnp.int32))
    full = _port(tree["params"])
    for n_stages, virtual in ((2, 1), (4, 1), (2, 2)):
        for p in range(n_stages):
            mesh = _fake_mesh(pp=n_stages)
            mesh.get_local_rank = lambda axis, p=p: p
            stage = tlp.LlamaStage(cfg, mesh=mesh, virtual_stages=virtual,
                                   device="cpu", store_dtype=torch.float32)
            init_params_(stage, torch.Generator().manual_seed(3))
            own = stage.state_dict()
            assert own.keys() == from_flax_params(
                tree, cfg, torch.float32, stage=stage).keys()
            for name, t in own.items():
                assert torch.equal(t, whole[name]), (n_stages, p, name)
                assert tlp.layer_owner(name, N_LAYERS, n_stages,
                                       virtual) == p
            stage.load_full_state_dict(full)
            assert all(torch.equal(t, full[n])
                       for n, t in stage.state_dict().items())
    assert tlp.stage_layers(8, 2, 2, 1) == [[2, 3], [6, 7]]


def test_fsdp_stage_init_equals_init_params(runs):
    """fsdp = 2 x pp = 2 with the stages' matrices sharded: each rank's
    chunks, joined, are init_params' weights at the seed."""
    whole = init_params(tl.llama2_tiny(n_layers=N_LAYERS),
                        torch.Generator().manual_seed(7), device="cpu",
                        dtype=torch.float32).state_dict()
    for rank in runs["pp_world4"]:
        assert rank["init_fsdp"]["sharded"] > 0
        for name, t in rank["init_fsdp"]["joined"].items():
            assert torch.equal(t, whole[name]), name


# -- (5) the batch -----------------------------------------------------------------------

@pytest.mark.parametrize("config", [{"dp": 2, "pp": 4},
                                    {"dp": 2, "fsdp": 2, "pp": 2},
                                    {"dp": 1, "fsdp": 4, "pp": 2},
                                    {"dp": 1, "pp": 8}])
def test_batch_rows_over_pp_match_jax(config):
    """The pp ranks of a batch shard hold its rows, as device r of the
    JAX mesh does under PartitionSpec(("dp", "fsdp"))."""
    jm = jmesh.create_mesh(jmesh.MeshConfig(**config))
    index = NamedSharding(jm, PartitionSpec(jmesh.BATCH_AXES)) \
        .devices_indices_map((16, 5))
    ranks = tmesh.mesh_ranks(tmesh.MeshConfig(**config), 8)
    for device, idx in index.items():
        coord = tuple(int(c) for c in np.argwhere(ranks == device.id)[0])
        rows = tmesh.batch_rows(ranks.shape, coord, 16)
        assert range(16)[rows] == range(16)[idx[0]], (config, device.id)


def test_global_batch_iterator_gives_every_stage_the_rows(runs):
    for rank in runs["pp_world2"]:
        it = rank["iterator"]
        assert torch.equal(it["got"], it["want"])


# -- (6) the example and the refusals ---------------------------------------------------

@pytest.mark.parametrize("world,flags,line", [
    (2, ["--pp", "2", "--pipeline-schedule", "1f1b", "--virtual-stages", "2",
         "--n-layers", "4", "--microbatches", "4", "--batch", "4"],
     "mesh dp=1 fsdp=1 pp=2 ep=1 tp=1 sp=1 schedule=1f1b virtual_stages=2 "
     "processes=2"),
    (4, ["--pp", "2", "--fsdp", "2", "--pp-fsdp", "--microbatches", "2"],
     "mesh dp=1 fsdp=2 pp=2 ep=1 tp=1 sp=1 schedule=gpipe pp_fsdp "
     "processes=4")])
def test_train_example_over_pp(tmp_path, world, flags, line):
    logs = join(launch([sys.executable, TRAIN_EXAMPLE, "--config", "tiny",
                        "--device", "cpu", "--steps", "2", "--seq-len", "32",
                        *flags], world, str(tmp_path)), str(tmp_path))
    assert line in logs[0], logs[0]
    assert np.isfinite(float(logs[0].split("loss=")[1].split()[0]))
    assert "mesh dp" not in logs[1]


def _fake_mesh(**axes):
    shape = tuple(axes.get(a, 1) for a in tmesh.AXIS_NAMES)
    return types.SimpleNamespace(mesh_dim_names=tmesh.AXIS_NAMES,
                                 shape=shape,
                                 get_local_rank=lambda axis: 0,
                                 get_group=lambda axis: None)


@pytest.mark.parametrize("axis", ["tp", "sp", "ep"])
def test_pp_with_tp_sp_or_ep_raises(axis):
    mesh = _fake_mesh(pp=2, **{axis: 2})
    cfg = tl.llama2_tiny(n_layers=N_LAYERS)
    for call in (lambda: refuse_pp_mix(mesh, "x"),
                 lambda: tl.LlamaModel(cfg, device="cpu", mesh=mesh),
                 lambda: tlp.LlamaStage(cfg, mesh=mesh, device="cpu"),
                 lambda: ttrain.build_train_step(None, ttrain.adamw(LR),
                                                 mesh=mesh)):
        with pytest.raises(ValueError, match="combine pp with dp and fsdp"):
            call()


def test_moe_under_pp_raises_naming_its_roadmap_item():
    """MoE under pp is ported (tests/test_torch_moe_pipeline.py): a stage,
    the whole model and the layer build on a pp mesh, the stage with its
    blocks' expert stacks whole, and the layer computes what it computes
    without a mesh."""
    mesh = _fake_mesh(pp=2)
    cfg = tl.mixtral_tiny()
    stage = tlp.LlamaStage(cfg, mesh=mesh, device="cpu")
    assert stage.layers["0"].feed_forward.w1.shape == (
        cfg.n_experts, cfg.dim, cfg.ffn_dim)
    whole = tl.LlamaModel(cfg, device="cpu", mesh=mesh)
    assert whole.layers[1].feed_forward.w2.shape == (
        cfg.n_experts, cfg.ffn_dim, cfg.dim)
    alone = MoEMLP(128, 256, 4, dtype=torch.float32, device="cpu")
    on_pp = MoEMLP(128, 256, 4, dtype=torch.float32, device="cpu",
                   mesh=mesh)
    gen = torch.Generator().manual_seed(1)
    weights = {n: torch.randn(t.shape, generator=gen)
               for n, t in alone.state_dict().items()}
    alone.load_state_dict(weights)
    on_pp.load_state_dict(weights)
    x = torch.randn(2, 8, 128, generator=gen)
    assert torch.equal(on_pp(x), alone(x))


def test_build_train_step_refusals_under_pp():
    mesh = _fake_mesh(pp=2)
    with pytest.raises(ValueError, match="accum_steps applies"):
        ttrain.build_train_step(None, ttrain.adamw(LR), mesh=mesh,
                                accum_steps=2)
    with pytest.raises(ValueError, match="no stages"):
        ttrain.build_train_step(lambda m, b: 0, ttrain.adamw(LR),
                                pp_fsdp=True)
    with pytest.raises(ValueError, match="loss_fn=None"):
        ttrain.build_train_step(lambda m, b: 0, ttrain.adamw(LR), mesh=mesh,
                                pipeline_schedule="1f1b")
    for flag in ("shard_update", "hierarchical_allreduce", "remat"):
        with pytest.raises(ValueError, match="does not apply under pp"):
            ttrain.build_train_step(None, ttrain.adamw(LR), mesh=mesh,
                                    **{flag: True})


@pytest.mark.parametrize("flags,message", [
    (["--pp-fsdp"], "without --pp > 1"),
    (["--pp", "2", "--accum-steps", "2"], "--accum-steps applies"),
    (["--pp", "2", "--sp", "2"], "combine --pp with --dp and --fsdp"),
    (["--pp", "2", "--fused-xent"], "drop --fused-xent")])
def test_train_example_refuses_before_forming_a_group(flags, message):
    done = subprocess.run([sys.executable, TRAIN_EXAMPLE, "--config", "tiny",
                           "--device", "cpu", *flags],
                          capture_output=True, text=True, timeout=120)
    assert done.returncode != 0
    assert message in done.stderr
