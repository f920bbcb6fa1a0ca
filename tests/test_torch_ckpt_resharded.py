"""The port's checkpoint data plane across processes (gloo on the CPU)
against the JAX package's.

Ranks are real processes (``tests/torch_dist_worker.py``): a world-2 job
(``ckpt_world2``) and a world-4 job (``ckpt_world4``) run while the JAX
references are computed on JAX's host devices, each joined with a
deadline.  On ``llama2_tiny`` in f32, each case trains two AdamW steps,
saves step 2 through ``ManifestCheckpointManager`` (each rank its own
byte range of the one-device stream, into a directory store), restores
it onto another mesh and takes two more steps:

- fsdp = 2 -> dp = 2 with ZeRO (``shard_update``);
- fsdp = 2 -> one process (``restore`` here, with no group);
- tp = 2 x fsdp = 2 -> fsdp = 4;
- pp = 2 (1F1B) -> fsdp = 2.

Held: the restored state equals the saved one bit for bit; the four
steps' metrics and the continued parameters are within 1e-5 of the JAX
run that saves through the JAX manager and restores through its
``restore_resharded`` on the same meshes; each rank uploads exactly its
range's bytes, and an FSDP2 restore reads less than the stream; the
per-rank manifest names the blobs a one-process save of the same state
with the same ``num_shards`` names; and a save in which rank 1 writes
rank 0's range restores to another state.
"""

import contextlib
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpi_operator_tpu.ckpt import BlobStore as JaxBlobStore
from mpi_operator_tpu.ckpt import \
    ManifestCheckpointManager as JaxManifestCheckpointManager
from mpi_operator_tpu.models import llama as jl
from mpi_operator_tpu.models import llama_pipeline as jlp
from mpi_operator_tpu.parallel import mesh as jmesh
from mpi_operator_tpu.parallel import train as jtrain
from mpi_operator_tpu_torch.ckpt import BlobStore, ManifestCheckpointManager
from mpi_operator_tpu_torch.ckpt.manifest import chunk_spans
from mpi_operator_tpu_torch.models import llama as tl
from mpi_operator_tpu_torch.models.params import from_flax_params
from mpi_operator_tpu_torch.parallel import train as ttrain
from test_torch_distributed import (LR, WORKER, assert_metrics_close,
                                    assert_params_close, join, launch)

N_LAYERS = 2
JOB_DEADLINE_S = 240     # the jobs share the host with other test workers
CHUNK_BYTES = 1 << 14    # torch_dist_worker.CKPT_CHUNK_BYTES

# name: (job, the job's case, its store job, the world it saved at, the
# JAX legs [(mesh axes or None for one process, devices, 1F1B
# microbatches or None)], shard_update of the new mesh).
CASES = {
    "fsdp2_to_dp2_zero": ("ckpt_world2", "fsdp2_dp2", "ckpt/fsdp2", 2,
                          [(dict(fsdp=2), 2, None), (dict(dp=2), 2, None)],
                          True),
    "fsdp2_to_one_process": ("ckpt_world2", "fsdp2_dp2", "ckpt/fsdp2", 2,
                             [(dict(fsdp=2), 2, None), (None, 1, None)],
                             False),
    "tp2_fsdp2_to_fsdp4": ("ckpt_world4", "tp2_fsdp2_fsdp4",
                           "ckpt/tp2fsdp2", 4,
                           [(dict(tp=2, fsdp=2), 4, None),
                            (dict(fsdp=4), 4, None)], False),
    "pp2_to_fsdp2": ("ckpt_world2", "pp2_fsdp2", "ckpt/pp2", 2,
                     [(dict(pp=2), 2, 2), (dict(fsdp=2), 2, None)], False),
}


def _cfg():
    return jl.llama2_tiny(n_layers=N_LAYERS)


def _tokens():
    return np.random.default_rng(12).integers(0, 256, (8, 16)).astype(
        np.int32)


def _port(tree):
    return from_flax_params(jax.tree_util.tree_map(np.asarray, tree),
                            tl.llama2_tiny(n_layers=N_LAYERS), torch.float32)


def _jax_mesh(axes, n_devices):
    return jmesh.create_mesh(jmesh.MeshConfig(**{"dp": 1, **axes}),
                             devices=jax.devices()[:n_devices])


@functools.lru_cache(maxsize=None)
def _jax_step(axes, n_devices, m):
    """(mesh, step): one optax AdamW step of the JAX run on the mesh of
    ``axes`` (a sorted tuple of pairs; None: one device), jitted whole:
    1F1B over m microbatches, or the model on the mesh.  step(params,
    opt_state) -> (params, opt_state, loss, grad_norm, |grads|)."""
    cfg, tx = _cfg(), optax.adamw(LR)
    toks = jnp.asarray(_tokens())
    mesh = None if axes is None else _jax_mesh(dict(axes), n_devices)
    if m is not None:
        def loss_and_grads(v):
            loss, grads = jlp.pipeline_loss_and_grads_1f1b(cfg, v, toks, mesh,
                                                            m)
            return loss, {"params": grads}
    else:
        model = jl.LlamaModel(cfg, mesh=mesh)
        loss_and_grads = jax.value_and_grad(
            lambda v: jl.next_token_loss(model.apply(v, toks), toks))

    def step(params, opt_state):
        loss, grads = loss_and_grads(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state, loss,
                optax.global_norm(grads),
                jax.tree_util.tree_map(jnp.abs, grads))

    return mesh, jax.jit(step)


def _jax_run(variables, legs, shard_update, world):
    """Two optax AdamW steps on the first leg's mesh, a save of step 2
    through the JAX manager (``world`` shards), its restore_resharded
    onto the second leg's mesh (restore alone for one process), two more
    steps: every step's (loss, grad_norm), the final weights and, per
    element, the smallest |gradient| met (as the port's state dicts)."""
    specs = jl.llama_param_specs(_cfg())
    params, opt_state = variables, optax.adamw(LR).init(variables)
    metrics, smallest = [], None
    for i, (axes, n, m) in enumerate(legs):
        mesh, step = _jax_step(
            None if axes is None else tuple(sorted(axes.items())), n, m)
        if i:
            mgr = JaxManifestCheckpointManager(
                JaxBlobStore(), "ckpt/jax", num_shards=world,
                chunk_bytes=CHUNK_BYTES, async_save=False)
            state = jtrain.TrainState(step=np.int64(2), params=params,
                                      opt_state=opt_state)
            mgr.save(state, 2)
            state = mgr.restore(state) if mesh is None else \
                mgr.restore_resharded(state, mesh, param_specs=specs,
                                      shard_update=shard_update)
            assert int(state.step) == 2
            params, opt_state = state.params, state.opt_state
        with mesh if mesh is not None else contextlib.nullcontext():
            for _ in range(2):
                params, opt_state, loss, norm, grads = step(params,
                                                            opt_state)
                metrics.append((float(loss), float(norm)))
                g = _port(grads["params"])
                smallest = g if smallest is None else {
                    k: torch.minimum(smallest[k], t) for k, t in g.items()}
    return metrics, _port(params["params"]), smallest


def _one_device_state():
    """A one-device TrainState of the test's model and optimizer, and its
    step function."""
    model = tl.LlamaModel(tl.llama2_tiny(n_layers=N_LAYERS), device="cpu",
                          store_dtype=torch.float32)
    init, step = ttrain.build_train_step(
        lambda mdl, b: tl.next_token_loss(mdl(b), b), ttrain.adamw(LR))
    return init(model), step


def _leaves(state):
    return {leaf.name: leaf.gather().clone() for leaf in state.leaves()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_ckpt")
    variables = {"params": jl.LlamaModel(_cfg()).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))["params"]}
    torch.save({"config": {}, "pp_config": {"n_layers": N_LAYERS},
                "pp_weights": _port(variables["params"]),
                "pp_tokens": torch.from_numpy(_tokens()).long()},
               out / "inputs.pt")
    jobs = {}
    for name, world in (("ckpt_world2", 2), ("ckpt_world4", 4)):
        job_dir = out / name
        job_dir.mkdir()
        os.link(out / "inputs.pt", job_dir / "inputs.pt")
        jobs[name] = (world, job_dir, launch(
            [sys.executable, WORKER, name, str(job_dir)], world,
            str(job_dir)))
    refs = {case: _jax_run(variables, legs, zero, world)
            for case, (_, _, _, world, legs, zero) in CASES.items()}
    for name, (world, job_dir, procs) in jobs.items():
        join(procs, str(job_dir), deadline_s=JOB_DEADLINE_S)
        refs[name] = [torch.load(job_dir / f"{name}.rank{r}.pt",
                                 weights_only=False) for r in range(world)]
        refs[f"{name} store"] = str(job_dir / "store")
    # fsdp = 2 -> one process: the world-2 job's store, restored here.
    state, step = _one_device_state()
    store = BlobStore(root=refs["ckpt_world2 store"])
    state = ManifestCheckpointManager(store, "ckpt/fsdp2").restore(state)
    refs["one_process_restored"] = _leaves(state)
    metrics = []
    for _ in range(2):
        state, m = step(state, torch.from_numpy(_tokens()).long())
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    refs["one_process_final"] = _leaves(state)
    refs["one_process_metrics"] = metrics
    return refs


def _case(runs, name):
    job, key, store_job, world, _, _ = CASES[name]
    return runs[job], key, store_job, world


def _continued(runs, name):
    """The port's (metrics, final one-device leaves) of a case."""
    ranks, key, _, _ = _case(runs, name)
    if name == "fsdp2_to_one_process":
        return (ranks[0][key]["metrics"][:2] + runs["one_process_metrics"],
                runs["one_process_final"])
    return ranks[0][key]["metrics"], ranks[0][key]["final"]


@pytest.mark.parametrize("name", list(CASES))
def test_restored_state_is_the_saved_state_bit_for_bit(runs, name):
    """Every leaf of the one-device state (step, weights, AdamW moments
    and steps) after the restore equals the saved one bit for bit, on
    a plan of the new mesh."""
    ranks, key, store_job, _ = _case(runs, name)
    before = ranks[0][key]["before"]
    if name == "fsdp2_to_one_process":
        after = runs["one_process_restored"]
    else:
        after = ranks[0][key][f"restore {store_job}"]["leaves"]
        assert ranks[0][key][f"restore {store_job}"]["plan"] == (
            "_ReplicatedPlan" if name == "fsdp2_to_dp2_zero"
            else "_ShardedPlan")
    assert list(after) == list(before)
    assert int(after["step"]) == 2
    for leaf, want in before.items():
        assert torch.equal(after[leaf], want), leaf


@pytest.mark.parametrize("name", list(CASES))
def test_continued_training_matches_jax_manager_restore_resharded(runs,
                                                                  name):
    """Two steps before the save and two after the restore, against the
    JAX run through its manager's save and restore_resharded on the same
    meshes, at 1e-5."""
    want_metrics, want, smallest = runs[name]
    metrics, final = _continued(runs, name)
    assert_metrics_close(metrics, want_metrics)
    got = {k[len("model."):]: v for k, v in final.items()
           if k.startswith("model.")}
    assert set(got) == set(want)
    assert_params_close(got, want, smallest, name)


@pytest.mark.parametrize("name", ["fsdp2_to_dp2_zero", "tp2_fsdp2_to_fsdp4",
                                  "pp2_to_fsdp2"])
def test_each_rank_uploads_its_range_and_reads_what_it_holds(runs, name):
    """A rank's store puts exactly the chunks of its byte range (uploaded
    or deduplicated), the ranges tile the stream, and a restore onto
    FSDP2 reads only the chunks that cover its rows: less than the whole
    stream."""
    ranks, key, store_job, world = _case(runs, name)
    ranges = [r[key][f"save {store_job}"]["range"] for r in ranks]
    total = ranges[-1][1]
    assert ranges[0][0] == 0 and all(
        ranges[i][1] == ranges[i + 1][0] for i in range(world - 1))
    for r, (lo, hi) in zip(ranks, ranges):
        save = r[key][f"save {store_job}"]
        assert save["bytes_written"] + save["bytes_deduped"] == hi - lo
        assert save["puts"] == len(chunk_spans(hi - lo, CHUNK_BYTES))
        read = r[key][f"restore {store_job}"]["bytes_read"]
        if name == "fsdp2_to_dp2_zero":
            assert read == total            # replicated: every leaf whole
        else:
            assert 0 < read < total


@pytest.mark.parametrize("job,store_job,world", [
    ("ckpt_world2", "ckpt/fsdp2", 2), ("ckpt_world2", "ckpt/pp2", 2),
    ("ckpt_world4", "ckpt/tp2fsdp2", 4)])
def test_per_rank_manifest_names_the_one_process_blobs(runs, job, store_job,
                                                       world):
    """The manifest the ranks wrote, and one written by one process from
    the same state restored here with the same num_shards, name the same
    blobs (and the same layout and size)."""
    store = BlobStore(root=runs[f"{job} store"])
    state, _ = _one_device_state()
    state = ManifestCheckpointManager(store, store_job).restore(state)
    mine = BlobStore()
    ManifestCheckpointManager(mine, store_job, num_shards=world,
                              chunk_bytes=CHUNK_BYTES,
                              async_save=False).save(state, 2)
    per_rank, one = store.read_manifest(store_job, 2), \
        mine.read_manifest(store_job, 2)
    for field in ("num_shards", "total_bytes", "layout", "kind", "shards"):
        assert per_rank[field] == one[field], field
    assert per_rank["num_shards"] == world


def test_neighbours_range_fails_the_bit_equality(runs):
    """A save in which rank 1 writes rank 0's range commits (the shard
    manifests are whole), and its restore is not the saved state."""
    ranks = runs["ckpt_world2"]
    out = ranks[0]["fsdp2_dp2"]
    assert ranks[1]["fsdp2_dp2"]["save ckpt/fsdp2-fault"]["range"] == \
        ranks[0]["fsdp2_dp2"]["save ckpt/fsdp2-fault"]["range"]
    after = out["restore ckpt/fsdp2-fault"]["leaves"]
    assert any(not torch.equal(after[k], v)
               for k, v in out["before"].items())
