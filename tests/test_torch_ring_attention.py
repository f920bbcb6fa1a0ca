"""Sequence parallelism of the PyTorch port (gloo on the CPU) against the
JAX package: ring attention over 'sp' and the training step on it.

Ranks are real processes (``tests/torch_dist_worker.py``) that form
their group from the operator's env; a world-2 job (sp = 2) and a world-4
job (sp = 4, and fsdp = 2 x sp = 2) run while the JAX references are
computed on JAX's 8 host devices, each joined with a deadline.  Held:

- ``ops/ring_attention.ring_attention`` at sp = 2 and 4, 'dense' and
  'flash' (the plain versions of the kernels here), causal and not,
  against the JAX ``ring_attention`` on the meshes of tests/test_ops.py:
  forward at 2e-5, gradients at 5e-4; ``attention(mesh=)`` at sp = 2;
- the model's logits at sp = 4 against the JAX ring model of
  ``test_llama_ring_attention_path_matches_dense`` (2e-5): its global
  RoPE positions;
- three AdamW steps at sp = 2 (the plain loss, the fused loss, under
  remat) and at fsdp = 2 x sp = 2 against the JAX ``build_train_step``
  on the same mesh, at ``STEP_TOL``: the loss shift across shards, the
  global mean, gradients summed over sp;
- ``seq_cols`` against JAX's ``seq_batch_sharding``, and the columns
  ``global_batch_iterator`` yields;
- ``examples/llama_train_torch.py --sp 2`` from the operator's env.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from mpi_operator_tpu.models import llama as jl
from mpi_operator_tpu.ops.ring_attention import ring_attention as jring
from mpi_operator_tpu.parallel import mesh as jmesh
from mpi_operator_tpu.parallel import train as jtrain
from mpi_operator_tpu_torch.models import llama as tl
from mpi_operator_tpu_torch.models.params import from_flax_params
from mpi_operator_tpu_torch.parallel import mesh as tmesh
from test_torch_distributed import (LR, TRAIN_EXAMPLE, WORKER,
                                    _smallest_grads, _tokens,
                                    assert_metrics_close,
                                    assert_params_close, join, launch)

FWD_TOL = 2e-5                 # tests/test_ops.py: ring forward
GRAD_TOL = 5e-4                # tests/test_ops.py: flash gradients
RING_SHAPE = (2, 64, 4, 32)    # [B, S, H, D]: S/sp >= the JAX block 16
RING_MESHES = {2: dict(dp=2, tp=2, sp=2), 4: dict(dp=2, tp=1, sp=4)}


def _ring_inputs():
    rng = np.random.default_rng(5)
    return [rng.standard_normal(RING_SHAPE).astype(np.float32)
            for _ in range(4)]


def _jax_ring(inputs, sp, impl, causal):
    """The JAX ring's output and the gradients of sum(out * dout)."""
    mesh = jmesh.create_mesh(jmesh.MeshConfig(**RING_MESHES[sp]))
    q, k, v, dout = (jnp.asarray(x) for x in inputs)

    def loss(q, k, v):
        out = jring(q, k, v, mesh, causal=causal, impl=impl,
                    interpret=True)
        return jnp.sum(out * dout), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _jax_sp_steps(variables, mesh_config, n_devices):
    """Three AdamW steps of the JAX step with the ring model on the
    mesh."""
    mesh = jmesh.create_mesh(jmesh.MeshConfig(**mesh_config),
                             devices=jax.devices()[:n_devices])
    cfg = jl.llama2_tiny()
    model = jl.LlamaModel(cfg, mesh=mesh)

    def jloss(params, batch):
        return jl.next_token_loss(model.apply(params, batch), batch)

    with mesh:
        init_fn, step_fn = jtrain.build_train_step(
            jloss, optax.adamw(LR), mesh, donate=False,
            param_specs=jl.llama_param_specs(cfg))
        state = init_fn(variables)
        batch = jax.device_put(jnp.asarray(_tokens()),
                               jmesh.seq_batch_sharding(mesh))
        metrics = []
        for _ in range(3):
            state, m = step_fn(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, from_flax_params(jax.tree_util.tree_map(
        np.asarray, state.params["params"]), tl.llama2_tiny(),
        torch.float32)


def _jax_ring_logits(variables, tokens):
    mesh = jmesh.create_mesh(jmesh.MeshConfig(dp=2, tp=1, sp=4))
    model = jl.LlamaModel(jl.llama2_tiny(), mesh=mesh)
    with mesh:
        return np.asarray(jax.jit(model.apply)(variables,
                                               jnp.asarray(tokens)))


def _start(out, scenario, world):
    job_dir = out / scenario
    job_dir.mkdir()
    os.link(out / "inputs.pt", job_dir / "inputs.pt")
    return (world, job_dir, launch([sys.executable, WORKER, scenario,
                                    str(job_dir)], world, str(job_dir)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_sp")
    model = jl.LlamaModel(jl.llama2_tiny())
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 4), jnp.int32))
    weights = from_flax_params(jax.tree_util.tree_map(
        np.asarray, variables["params"]), tl.llama2_tiny(), torch.float32)
    ring = _ring_inputs()
    llama_tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(2), (2, 64), 0, 256)).astype(np.int64)
    torch.save({"config": {}, "weights": weights,
                "tokens": torch.from_numpy(_tokens()).long(),
                "ring": [torch.from_numpy(x) for x in ring],
                "llama_tokens": torch.from_numpy(llama_tokens)},
               out / "inputs.pt")
    jobs = {name: _start(out, name, world)
            for name, world in (("sp_world2", 2), ("sp_world4", 4))}
    refs = {"ring": {(sp, causal, impl): _jax_ring(ring, sp, impl, causal)
                     for sp, causal, impl in RING_CASES},
            "logits": _jax_ring_logits(variables, llama_tokens),
            "sp2": _jax_sp_steps(variables, {"dp": 1, "sp": 2}, 2),
            "fsdp2sp2": _jax_sp_steps(variables,
                                      {"dp": 1, "fsdp": 2, "sp": 2}, 4),
            "smallest": _smallest_grads(weights)}
    for name, (world, job_dir, procs) in jobs.items():
        join(procs, str(job_dir))
        refs[name] = [torch.load(job_dir / f"{name}.rank{r}.pt",
                                 weights_only=False) for r in range(world)]
    return refs


RING_CASES = [(2, True, "dense"), (2, True, "flash"), (2, False, "dense"),
              (2, False, "flash"), (4, True, "dense"), (4, True, "flash")]


def _joined(ranks, sp, pick):
    """The ranks' column shards joined along the sequence."""
    return np.concatenate([pick(r).numpy() for r in ranks[:sp]], axis=1)


# -- ring attention -----------------------------------------------------------------

@pytest.mark.parametrize("sp,causal,impl", RING_CASES)
def test_ring_attention_forward_matches_jax(runs, sp, causal, impl):
    ranks = runs[f"sp_world{sp}"]
    key = f"{causal}-{impl}"
    got = _joined(ranks, sp, lambda r: r["ring"][key]["out"])
    want, _ = runs["ring"][(sp, causal, impl)]
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("sp,causal,impl", RING_CASES)
def test_ring_attention_gradients_match_jax(runs, sp, causal, impl):
    """dq of each rank's queries, and dk/dv of each rank's own chunk,
    which the accumulators carry home round the ring."""
    ranks = runs[f"sp_world{sp}"]
    key = f"{causal}-{impl}"
    _, want = runs["ring"][(sp, causal, impl)]
    for i, name in enumerate("qkv"):
        got = _joined(ranks, sp, lambda r: r["ring"][key]["grads"][i])
        np.testing.assert_allclose(got, want[i], atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_attention_with_an_sp_mesh_takes_the_ring(runs, impl):
    """attention(mesh=) at sp = 2: this rank's columns in, its shard of
    the JAX ring's result out ('auto' on the flash route, 'xla' dense)."""
    got = _joined(runs["sp_world2"], 2, lambda r: r["attention"][impl])
    want, _ = runs["ring"][(2, True, "dense")]
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)


def test_llama_logits_at_sp4_match_the_jax_ring_model(runs):
    """The JAX test's setup (tokens [2, 64] from PRNGKey(2), the ring
    model on dp = 2 x sp = 4): each rank's logits are its columns, at
    global RoPE positions."""
    got = _joined(runs["sp_world4"], 4, lambda r: r["logits"])
    np.testing.assert_allclose(got, runs["logits"], atol=FWD_TOL,
                               rtol=FWD_TOL)


# -- training -----------------------------------------------------------------------

@pytest.mark.parametrize("job,key,ref", [
    ("sp_world2", "train", "sp2"), ("sp_world2", "fused", "sp2"),
    ("sp_world2", "remat", "sp2"), ("sp_world4", "train", "fsdp2sp2")])
def test_three_adamw_steps_match_the_jax_step_on_the_same_mesh(runs, job,
                                                               key, ref):
    """sp = 2 (replicated plan; the plain loss, the fused loss, remat's
    second ring in the backward) and fsdp = 2 x sp = 2 (FSDP2, its
    gradient shards summed over sp; the ring on its flash route): the
    reported loss is the global mean, every rank ends with the JAX
    parameters."""
    want_metrics, want = runs[ref]
    for rank_result in runs[job]:
        run = rank_result[key]
        assert_metrics_close(run["metrics"], want_metrics)
        assert_params_close(run["params"], want, runs["smallest"],
                            f"{job} {key}")


# -- the batch ------------------------------------------------------------------------

@pytest.mark.parametrize("config", [{"dp": 1, "sp": 8},
                                    {"dp": 2, "fsdp": 2, "sp": 2},
                                    {"dp": 2, "tp": 2, "sp": 2},
                                    {"dp": 1, "fsdp": 2, "sp": 4}])
def test_seq_cols_match_jax(config):
    """Device r of the JAX mesh and rank r hold the same block of a
    [batch, seq] array under seq_batch_sharding."""
    jm = jmesh.create_mesh(jmesh.MeshConfig(**config))
    index = NamedSharding(jm, PartitionSpec(jmesh.BATCH_AXES, "sp")) \
        .devices_indices_map((16, 64))
    ranks = tmesh.mesh_ranks(tmesh.MeshConfig(**config), 8)
    for device, idx in index.items():
        coord = tuple(int(c) for c in np.argwhere(ranks == device.id)[0])
        rows = tmesh.batch_rows(ranks.shape, coord, 16)
        cols = tmesh.seq_cols(ranks.shape, coord, 64)
        assert range(16)[rows] == range(16)[idx[0]], (config, device.id)
        assert range(64)[cols] == range(64)[idx[1]], (config, device.id)
    with pytest.raises(ValueError, match="not divisible by sp"):
        tmesh.seq_cols(ranks.shape, (0,) * 6, 63)


def test_global_batch_iterator_yields_the_sp_columns(runs):
    for rank_result in runs["sp_world2"]:
        it = rank_result["iterator"]
        assert it["got"].shape == (4, 8)
        assert torch.equal(it["got"], it["want"])


# -- the example ------------------------------------------------------------------------

def test_train_example_over_two_sp_processes_with_data(tmp_path):
    """``--sp 2 --data``: the two sp ranks of the one batch shard read the
    same rows of the corpus, each trains on its columns, and rank 0
    prints the mesh and a finite loss."""
    from mpi_operator_tpu_torch.native import write_token_file
    corpus = tmp_path / "corpus.bin"
    write_token_file(str(corpus), np.random.default_rng(0).integers(
        0, 256, 64 * 32))
    logs = join(launch([sys.executable, TRAIN_EXAMPLE, "--config", "tiny",
                        "--device", "cpu", "--steps", "2", "--sp", "2",
                        "--seq-len", "32", "--data", str(corpus)], 2,
                       str(tmp_path)), str(tmp_path))
    assert "mesh dp=1 fsdp=1 pp=1 ep=1 tp=1 sp=2 processes=2" in logs[0]
    assert "batch=2 seq=32" in logs[0]
    assert np.isfinite(float(logs[0].split("loss=")[1].split()[0]))
    assert "mesh dp" not in logs[1]


def test_train_example_refuses_pp_naming_its_roadmap_item(tmp_path):
    """pp is ported (tests/test_torch_pipeline.py), with MoE too
    (tests/test_torch_moe_pipeline.py): the example trains mixtral_tiny
    over two stages; --pp beside --sp still exits before forming a
    group."""
    import subprocess
    logs = join(launch([sys.executable, TRAIN_EXAMPLE, "--config",
                        "mixtral-tiny", "--device", "cpu", "--steps", "2",
                        "--pp", "2", "--seq-len", "32", "--batch", "2",
                        "--microbatches", "2"], 2, str(tmp_path)),
                str(tmp_path))
    assert "mesh dp=1 fsdp=1 pp=2 ep=1 tp=1 sp=1 schedule=gpipe " \
        "processes=2" in logs[0], logs[0]
    assert np.isfinite(float(logs[0].split("loss=")[1].split()[0]))
    done = subprocess.run([sys.executable, TRAIN_EXAMPLE, "--device", "cpu",
                           "--config", "tiny", "--pp", "2", "--sp", "2"],
                          capture_output=True, text=True, timeout=120)
    assert done.returncode != 0
    assert "combine --pp with --dp and --fsdp" in done.stderr
