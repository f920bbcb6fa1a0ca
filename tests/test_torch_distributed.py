"""Multi-process training of the PyTorch port (gloo on the CPU) against the
JAX package.

Ranks are real processes (``tests/torch_dist_worker.py``) that form
their group from the operator's env through
``bootstrap.initialize_from_env``; one world-2 job and one world-4 job
run every scenario, each joined with a deadline.  Held:

- the mesh layout (``mesh_ranks``/``create_mesh``/
  ``create_multislice_mesh``) and the batch rows of each rank against the
  JAX ``Mesh`` and ``NamedSharding`` over the 8 CPU devices;
- the env bootstrap: ``process_env`` against the JAX one, a late
  coordinator, the ``distributed_init`` span, the ``TimeoutError``;
- three AdamW steps of ``build_train_step`` at dp = 2 (replicated
  parameters) and at fsdp = 2 (``llama_param_specs``, FSDP2) against the
  JAX step on a dp = 2 / fsdp = 2 mesh (loss, grad_norm and parameters
  at ``STEP_TOL``, as tests/test_torch_train.py holds one device);
- ``shard_update`` (ZeRO) and ``hierarchical_allreduce`` (world 4, dp = 2
  x fsdp = 2) against the flat replicated step, accumulation against the
  full batch, the FSDP2 shards at init against ``init_params``, and a
  two-rank checkpoint save/restore/continue bit for bit (and the saved
  state itself training on to the straight run's weights);
- ``examples/torch_pi.py`` as a 3-process MPIJob through the JAX
  package's ``LocalCluster``, and ``examples/llama_train_torch.py
  --dp 2 --data`` over two processes.
"""

import os
import socket
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from mpi_operator_tpu.bootstrap import distributed as jboot
from mpi_operator_tpu.models import llama as jl
from mpi_operator_tpu.parallel import mesh as jmesh
from mpi_operator_tpu.parallel import train as jtrain
from mpi_operator_tpu.sched import topology as jtopo
from mpi_operator_tpu.utils.waiters import wait_until
from mpi_operator_tpu_torch.bootstrap import distributed as tboot
from mpi_operator_tpu_torch.models import llama as tl
from mpi_operator_tpu_torch.models.params import from_flax_params
from mpi_operator_tpu_torch.parallel import mesh as tmesh
from mpi_operator_tpu_torch.parallel import train as ttrain
from mpi_operator_tpu_torch.utils.data import global_batch_iterator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
TORCH_PI = os.path.join(REPO, "examples", "torch_pi.py")
TRAIN_EXAMPLE = os.path.join(REPO, "examples", "llama_train_torch.py")
STEP_TOL = 1e-5          # tests/test_torch_train.py
LR = 3e-4
DEADLINE_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(port, rank, world, **extra):
    env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
               JAX_PROCESS_ID=str(rank), JAX_NUM_PROCESSES=str(world),
               OMP_NUM_THREADS="1", **extra)
    return env


def launch(argv, world, out_dir, late_rank=None, late_s=0.0, **extra):
    """One process per rank, with the operator's env; ``late_rank``
    starts ``late_s`` seconds after the others."""
    port = free_port()
    procs = []

    def start(rank):
        log = open(os.path.join(out_dir, f"rank{rank}.log"), "w")
        procs.append((rank, log, subprocess.Popen(
            argv, env=rank_env(port, rank, world, **extra), stdout=log,
            stderr=subprocess.STDOUT, cwd=REPO)))

    for rank in range(world):
        if rank != late_rank:
            start(rank)
    if late_rank is not None:
        time.sleep(late_s)
        start(late_rank)
    return sorted(procs, key=lambda p: p[0])


def join(procs, out_dir, deadline_s=DEADLINE_S):
    """Wait for every rank within the deadline; kill them all and fail
    the test on expiry or on a non-zero exit."""
    def settled():
        # A rank that fails leaves the others waiting in a collective:
        # stop at the first failure, not at the deadline.
        codes = [proc.poll() for _, _, proc in procs]
        return all(c == 0 for c in codes) or any(c for c in codes)

    try:
        wait_until(settled, timeout=deadline_s, interval=0.1,
                   desc="every rank to exit")
    except TimeoutError:
        pass                      # the ranks still running are killed
    finally:
        for _, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    logs = {rank: open(os.path.join(out_dir, f"rank{rank}.log")).read()
            for rank, _, _ in procs}
    codes = {rank: proc.returncode for rank, _, proc in procs}
    if any(codes.values()):
        pytest.fail(f"ranks exited {codes}:\n" + "\n".join(
            f"--- rank {r}\n{text[-3000:]}" for r, text in logs.items()))
    return logs


def run_scenario(scenario, world, out_dir, **kw):
    return launch([sys.executable, WORKER, scenario, str(out_dir)], world,
                  str(out_dir), **kw)


def results(scenario, world, out_dir):
    return [torch.load(os.path.join(out_dir, f"{scenario}.rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# -- inputs and references ------------------------------------------------------

def _tokens():
    return np.random.default_rng(3).integers(0, 256, (4, 16)).astype(
        np.int32)


def _jax_model():
    model = jl.LlamaModel(jl.llama2_tiny())
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 4), jnp.int32))
    return model, variables


def _jax_steps(model, variables, mesh_config, specs):
    """Three AdamW steps of the JAX build_train_step on two CPU devices:
    [(loss, grad_norm)] and the final weights as the port's state
    dict."""
    mesh = jmesh.create_mesh(jmesh.MeshConfig(**mesh_config),
                             devices=jax.devices()[:2])
    cfg = jl.llama2_tiny()

    def jloss(params, batch):
        return jl.next_token_loss(model.apply(params, batch), batch)

    with mesh:
        init_fn, step_fn = jtrain.build_train_step(
            jloss, optax.adamw(LR), mesh, donate=False,
            param_specs=jl.llama_param_specs(cfg) if specs else None)
        state = init_fn(variables)
        batch = jax.device_put(jnp.asarray(_tokens()),
                               jmesh.batch_sharding(mesh))
        metrics = []
        for _ in range(3):
            state, m = step_fn(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    final = from_flax_params(jax.tree_util.tree_map(
        np.asarray, state.params["params"]), tl.llama2_tiny(),
        torch.float32)
    return metrics, final


def _smallest_grads(weights):
    """Per element, the smallest |gradient| over three steps of the
    one-process port on the global batch."""
    model = tl.LlamaModel(tl.llama2_tiny(), device="cpu",
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


def assert_params_close(got, want, smallest, what):
    """As tests/test_torch_train.py: an element whose gradient came
    within rounding of zero (another order of summation) moves by an
    amount that rounding sets, up to lr a step; those are held to 3 lr,
    every other element to STEP_TOL."""
    for name, ref in want.items():
        sound = (smallest[name] == 0) | (smallest[name] >= 1e-7)
        assert sound.float().mean().item() > 0.99, name
        np.testing.assert_allclose(got[name][sound].numpy(),
                                   ref[sound].numpy(), atol=STEP_TOL,
                                   rtol=STEP_TOL, err_msg=f"{what} {name}")
        assert (got[name] - ref).abs().max().item() <= 3 * LR, name


def assert_metrics_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=STEP_TOL, rtol=STEP_TOL)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world-2 and world-4 jobs (started first, so the JAX
    references are computed while they run) and the references."""
    out = tmp_path_factory.mktemp("torch_dist")
    model, variables = _jax_model()
    weights = from_flax_params(jax.tree_util.tree_map(
        np.asarray, variables["params"]), tl.llama2_tiny(), torch.float32)
    torch.save({"config": {}, "weights": weights,
                "tokens": torch.from_numpy(_tokens()).long()},
               out / "inputs.pt")
    jobs = {}
    for scenario, world in (("world2", 2), ("world4", 4)):
        job_dir = out / scenario
        job_dir.mkdir()
        os.link(out / "inputs.pt", job_dir / "inputs.pt")
        jobs[scenario] = (world, job_dir, run_scenario(scenario, world,
                                                       job_dir))
    refs = {"dp": _jax_steps(model, variables, {"dp": 2}, specs=False),
            "fsdp": _jax_steps(model, variables, {"dp": 1, "fsdp": 2},
                               specs=True),
            "smallest": _smallest_grads(weights)}
    for scenario, (world, job_dir, procs) in jobs.items():
        join(procs, str(job_dir))
        refs[scenario] = results(scenario, world, job_dir)
    return refs


# -- (1) the mesh ------------------------------------------------------------------

MESHES = [({"dp": -1}, 1), ({"dp": 2, "fsdp": 4}, 1),
          ({"dp": -1, "fsdp": 2, "tp": 2}, 1), ({"fsdp": 8, "dp": 1}, 1),
          ({"dp": 2, "sp": 2, "ep": 2}, 1), ({"dp": 4, "fsdp": 2}, 2),
          ({"dp": -1, "fsdp": 2}, 4), ({"dp": 8}, 8)]


@pytest.mark.parametrize("config,num_slices", MESHES)
def test_mesh_layout_matches_jax(config, num_slices):
    jm = jmesh.create_multislice_mesh(jmesh.MeshConfig(**config),
                                      num_slices=num_slices)
    ranks = tmesh.mesh_ranks(tmesh.MeshConfig(**config), 8, num_slices)
    assert tmesh.AXIS_NAMES == jmesh.AXIS_NAMES == tuple(jm.axis_names)
    assert tmesh.BATCH_AXES == jmesh.BATCH_AXES
    assert ranks.shape == tuple(jm.shape[a] for a in jmesh.AXIS_NAMES)
    np.testing.assert_array_equal(
        ranks, np.vectorize(lambda d: d.id)(jm.devices))
    assert tmesh.MeshConfig(**config).resolve(8) == \
        jmesh.MeshConfig(**config).resolve(8)


@pytest.mark.parametrize("config,num_slices", [
    ({"dp": 3}, 1), ({"fsdp": 3}, 1), ({"dp": 2, "fsdp": 4}, 4),
    ({"dp": -1}, 3)])
def test_mesh_refusals_match_jax(config, num_slices):
    with pytest.raises(ValueError) as want:
        jmesh.create_multislice_mesh(jmesh.MeshConfig(**config),
                                     num_slices=num_slices)
    with pytest.raises(ValueError) as got:
        tmesh.mesh_ranks(tmesh.MeshConfig(**config), 8, num_slices)
    assert str(got.value) == str(want.value)


def test_create_mesh_on_the_ranks(runs):
    """The DeviceMesh each rank built holds mesh_ranks' layout."""
    for world, job in ((2, "world2"), (4, "world4")):
        for rank_result in runs[job]:
            for run in rank_result.values():
                if isinstance(run, dict) and "mesh" in run:
                    assert run["mesh_seen"] == run["mesh"]
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.create_mesh(tmesh.MeshConfig(), "cpu")


@pytest.mark.parametrize("config", [{"dp": 8}, {"dp": 2, "fsdp": 4},
                                    {"dp": 2, "fsdp": 2, "tp": 2},
                                    {"dp": 1, "fsdp": 2, "sp": 4}])
def test_batch_rows_match_jax(config):
    """Device r of the JAX mesh and rank r hold the same rows of a
    (dp, fsdp)-sharded global batch."""
    jm = jmesh.create_mesh(jmesh.MeshConfig(**config))
    index = NamedSharding(jm, PartitionSpec(jmesh.BATCH_AXES)) \
        .devices_indices_map((16, 5))
    ranks = tmesh.mesh_ranks(tmesh.MeshConfig(**config), 8)
    for device, idx in index.items():
        coord = tuple(int(c) for c in np.argwhere(ranks == device.id)[0])
        rows = tmesh.batch_rows(ranks.shape, coord, 16)
        assert range(16)[rows] == range(16)[idx[0]], (config, device.id)


def test_global_batch_iterator_yields_the_local_rows():
    local = np.arange(12).reshape(3, 4)
    batches = list(global_batch_iterator(lambda step: (local + step,),
                                         None, "cpu", steps=2))
    assert len(batches) == 2
    assert torch.equal(batches[1][0], torch.from_numpy(local + 1))
    # sp and pp are ported (tests/test_torch_ring_attention.py,
    # tests/test_torch_pipeline.py): every stage of a batch shard gets its
    # rows whole; pp beside sp still raises.
    wider = types.SimpleNamespace(mesh_dim_names=tmesh.AXIS_NAMES,
                                  shape=(1, 1, 2, 1, 1, 1))
    (got,) = next(global_batch_iterator(lambda step: (local,), wider, "cpu"))
    assert torch.equal(got, torch.from_numpy(local))
    mixed = types.SimpleNamespace(mesh_dim_names=tmesh.AXIS_NAMES,
                                  shape=(1, 1, 2, 1, 1, 2))
    with pytest.raises(ValueError, match="pp=2 with sp=2"):
        next(global_batch_iterator(lambda step: (local,), mixed, "cpu"))


def test_placement_from_env_matches_jax(monkeypatch):
    for text in ("slice-a=0.0/4x4;slice-b=0.0/2x2+2.0/2x2", "", "a=0/x",
                 "a=0.0/2x2;a=1.1/1x1", "a=0.0/2x0"):
        want = jtopo.decode_placement(text)
        got = tmesh.decode_placement(text)
        if want is None:
            assert got is None, text
            continue
        assert {k: [(b.origin, b.shape, b.chips, b.coords()) for b in v]
                for k, v in got.items()} == \
            {k: [(b.origin, b.shape, b.chips, b.coords()) for b in v]
             for k, v in want.items()}
    assert tmesh.placement_from_env() is None
    monkeypatch.setenv("MPI_OPERATOR_PLACEMENT", "s0=0.0/2x2;s1=0.0/2x2")
    monkeypatch.setenv("MPI_OPERATOR_CHIP_COORDS", "1.0")
    monkeypatch.setenv("MPI_OPERATOR_SLICE", "s1")
    got = tmesh.placement_from_env()
    want = jmesh.placement_from_env()
    assert (got["num_slices"], got["slice"], got["coords"]) == \
        (want["num_slices"], want["slice"], want["coords"]) == \
        (2, "s1", (1, 0))


# -- (2) the bootstrap ---------------------------------------------------------------

def test_process_env_matches_jax(monkeypatch):
    assert tboot.process_env() is None is jboot.process_env()
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "w-0.svc:8476")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("MEGASCALE_NUM_SLICES", "2")
    monkeypatch.setenv("MEGASCALE_SLICE_ID", "1")
    monkeypatch.setenv("MPIJOB_SUBMIT_TIME", str(time.time() - 5))
    assert vars(tboot.process_env()) == vars(jboot.process_env())
    assert tboot.process_env().is_multislice
    assert tboot.submit_time() == jboot.submit_time()
    assert 5 <= tboot.launch_latency_seconds() < 60


def test_initialize_without_a_group(monkeypatch):
    """Outside an MPIJob and for one process: the env, no group; several
    cards per process are the GPU control plane's (queue 1 item 7)."""
    import torch.distributed as dist
    assert tboot.initialize_from_env(device="cpu") is None
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    assert tboot.initialize_from_env(device="cpu").num_processes == 1
    assert not dist.is_initialized()
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_LOCAL_DEVICE_COUNT", "2")
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        tboot.initialize_from_env(device="cpu")


def test_initialize_times_out_without_a_coordinator(monkeypatch):
    import torch.distributed as dist
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS",
                       f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not connect to 127.0.0.1"):
        tboot.initialize_from_env(timeout_seconds=1.0, device="cpu")
    assert time.monotonic() - t0 < 30
    assert not dist.is_initialized()


def test_initialize_waits_for_a_late_coordinator(tmp_path):
    """Rank 1 starts 3 s before the coordinator; both form the group,
    and the wait is a distributed_init span under the job's context."""
    torch.save({}, tmp_path / "inputs.pt")
    procs = run_scenario("init", 2, tmp_path, late_rank=0, late_s=3.0,
                         MPI_OPERATOR_TRACE_CONTEXT="job-trace:42")
    join(procs, str(tmp_path))
    got = results("init", 2, tmp_path)
    for rank, res in enumerate(got):
        assert res["sum"] == 3.0 and res["world"] == 2
        assert res["backend"] == "gloo"
        (init_span,) = res["spans"]
        assert init_span["trace_id"] == "job-trace"
        assert init_span["parent_id"] == 42
        assert init_span["attrs"]["process_id"] == rank
        assert init_span["attrs"]["num_processes"] == 2
    assert got[1]["spans"][0]["dur"] > 1.0    # it waited for rank 0


# -- (3)-(7) training ---------------------------------------------------------------

def test_dp2_matches_jax(runs):
    want_metrics, want = runs["dp"]
    for rank_result in runs["world2"]:
        run = rank_result["dp"]
        assert_metrics_close(run["metrics"], want_metrics)
        assert_params_close(run["params"], want, runs["smallest"], "dp=2")


def test_fsdp2_matches_jax(runs):
    want_metrics, want = runs["fsdp"]
    for rank_result in runs["world2"]:
        run = rank_result["fsdp"]
        assert_metrics_close(run["metrics"], want_metrics)
        assert_params_close(run["params"], want, runs["smallest"],
                            "fsdp=2")
        # FSDP2 holds half of every parameter and of its moments.
        assert run["opt_bytes"] * 2 == rank_result["dp"]["opt_bytes"]


def test_fsdp_shards_at_init_equal_init_params(runs):
    total = sum(p.numel() for p in
                runs["world2"][0]["sharded_init"]["want"].values())
    for rank_result in runs["world2"]:
        init = rank_result["sharded_init"]
        assert init["local_numel"] * 2 == total
        for name, want in init["want"].items():
            assert torch.equal(init["full"][name], want.detach()), name


@pytest.mark.parametrize("job,run,ref", [("world2", "dp_zero", "dp"),
                                         ("world4", "zero", "flat")])
def test_shard_update_equals_the_replicated_update(runs, job, run, ref):
    for rank_result in runs[job]:
        got, want = rank_result[run], rank_result[ref]
        assert_metrics_close(got["metrics"], want["metrics"])
        assert_params_close(got["params"], want["params"],
                            runs["smallest"], run)
        # The moments of every parameter with a dim divisible by dp=2
        # (all of llama2_tiny's) live in halves.
        assert got["opt_bytes"] * 2 == want["opt_bytes"]


@pytest.mark.parametrize("run", ["hier", "hier_zero"])
def test_hierarchical_allreduce_equals_flat(runs, run):
    """World 4, dp = 2 x fsdp = 2 (tests/test_train_hotpath.py's check of
    the JAX schedule): reduce-scatter over fsdp, all-reduce over dp,
    all-gather over fsdp, with or without the ZeRO update."""
    for rank_result in runs["world4"]:
        got, want = rank_result[run], rank_result["flat"]
        assert_metrics_close(got["metrics"], want["metrics"])
        assert_params_close(got["params"], want["params"],
                            runs["smallest"], run)
    assert runs["world4"][0]["hier_zero"]["opt_bytes"] * 2 == \
        runs["world4"][0]["flat"]["opt_bytes"]


@pytest.mark.parametrize("run,ref", [("dp_accum", "dp"),
                                     ("fsdp_accum", "fsdp")])
def test_accum_steps_equals_the_full_batch(runs, run, ref):
    for rank_result in runs["world2"]:
        got, want = rank_result[run], rank_result[ref]
        assert_metrics_close(got["metrics"], want["metrics"])
        assert_params_close(got["params"], want["params"],
                            runs["smallest"], run)


def test_accum_steps_divisibility_error_matches_jax(runs):
    """The global batch of 4 rows over 2 batch shards does not divide
    into 3 microbatches: the JAX step's words."""
    got = runs["world2"][0]["accum_error"]
    assert got == ("batch dim 4 not divisible by accum_steps 3 x batch "
                   "shards 2 (dp*fsdp)")
    mesh = jmesh.create_mesh(jmesh.MeshConfig(dp=2),
                             devices=jax.devices()[:2])
    with mesh:
        _, step_fn = jtrain.build_train_step(
            lambda p, b: jnp.sum(p["w"]) * jnp.mean(b), optax.sgd(0.1),
            mesh, donate=False, accum_steps=3)
        init_fn, _ = jtrain.build_train_step(
            lambda p, b: jnp.sum(p["w"]) * jnp.mean(b), optax.sgd(0.1),
            mesh, donate=False, accum_steps=3)
        state = init_fn({"w": jnp.ones((2,))})
        with pytest.raises(ValueError) as want:
            step_fn(state, jax.device_put(jnp.ones((4, 2)),
                                          jmesh.batch_sharding(mesh)))
    assert got == str(want.value)


# -- (9) checkpoints ---------------------------------------------------------------

@pytest.mark.parametrize("run", ["ckpt_fsdp", "ckpt_zero"])
def test_checkpoint_restore_continues_bit_for_bit(runs, run):
    """Two ranks: 2 steps, a save (rank 0 writes), a fresh state that
    restores it and 2 more steps equal 4 straight steps exactly; a
    notice on rank 1 alone makes both exit 143 at the same step, with
    one checkpoint written."""
    for rank_result in runs["world2"]:
        res = rank_result[run]
        for name, want in res["straight"].items():
            assert torch.equal(res["resumed"][name], want), name
        assert res["exit_code"] == 143
        assert res["written"] == [2] and res["preempt_written"] == [4]


@pytest.mark.parametrize("run", ["ckpt_fsdp", "ckpt_zero"])
def test_a_save_leaves_the_saved_state_training_on(runs, run):
    """The state that was saved at step 2 takes 2 more steps and ends
    where 4 straight steps end: the save (under ZeRO, the gather of the
    moment chunks into the one-device format) leaves the live optimizer
    state as it was."""
    for rank_result in runs["world2"]:
        res = rank_result[run]
        for name, want in res["straight"].items():
            np.testing.assert_allclose(res["continued"][name].numpy(),
                                       want.numpy(), atol=STEP_TOL,
                                       rtol=STEP_TOL, err_msg=name)


def test_llama_param_specs_transpose_the_jax_specs():
    """Each parameter's axes are the JAX spec's, moved to the port's
    layouts: a matmul [in, ...out] kernel becomes an [out, in] weight
    (wo's [H, D, dim] merges H and D into its in dim)."""
    def merged(axes):
        named = [a for a in axes if a is not None]
        return named[0] if named else None

    for cfg_name in ("llama2_tiny", "mixtral_tiny"):
        cfg_kw = {"n_layers": 2}
        jspecs = jl.llama_param_specs(getattr(jl, cfg_name)(**cfg_kw))
        tspecs = tl.llama_param_specs(getattr(tl, cfg_name)(**cfg_kw))
        want = {"tok_embeddings.weight": tuple(
            jspecs["params"]["tok_embeddings"]["embedding"]),
            "norm.scale": tuple(jspecs["params"]["norm"]["scale"])}
        out = tuple(jspecs["params"]["output"]["kernel"])
        want["output.weight"] = (out[1], out[0])
        for i in range(2):
            layer = jspecs["params"][f"layers_{i}"]
            pre = f"layers.{i}"
            for norm in ("attention_norm", "ffn_norm"):
                want[f"{pre}.{norm}.scale"] = tuple(layer[norm]["scale"])
            for name in ("wq", "wk", "wv"):
                k = tuple(layer["attention"][name]["kernel"])
                want[f"{pre}.attention.{name}.weight"] = (merged(k[1:]),
                                                          k[0])
            k = tuple(layer["attention"]["wo"]["kernel"])
            want[f"{pre}.attention.wo.weight"] = (k[2], merged(k[:2]))
            ffn = layer["feed_forward"]
            if "router" in ffn:
                r = tuple(ffn["router"]["kernel"])
                want[f"{pre}.feed_forward.router.weight"] = (r[1], r[0])
                for name in ("w1", "w2", "w3"):
                    want[f"{pre}.feed_forward.{name}"] = tuple(ffn[name])
            else:
                for name in ("w1", "w2", "w3"):
                    k = tuple(ffn[name]["kernel"])
                    want[f"{pre}.feed_forward.{name}.weight"] = (k[1], k[0])
        assert tspecs == want, cfg_name
        model = tl.LlamaModel(getattr(tl, cfg_name)(**cfg_kw),
                              device="meta")
        assert {n: p.dim() for n, p in model.named_parameters()} == \
            {n: len(s) for n, s in tspecs.items()}


# -- the examples ------------------------------------------------------------------

def test_torch_pi_process_group_through_local_cluster():
    """test_e2e_jax_pi_process_group's job with the port's example: the
    launcher as process 0 and 2 workers form a gloo group from the
    operator's injected env and compute pi with one all-reduce."""
    from mpi_operator_tpu.api import constants
    from mpi_operator_tpu.api.types import (MPIJob, MPIJobSpec, ReplicaSpec,
                                            RunPolicy)
    from mpi_operator_tpu.k8s.core import (Container, PodSpec,
                                           PodTemplateSpec)
    from mpi_operator_tpu.k8s.meta import ObjectMeta
    from mpi_operator_tpu.server import LocalCluster

    cmd = [sys.executable, TORCH_PI, "200000", "--device", "cpu"]

    def replica(name, replicas=None):
        return ReplicaSpec(replicas=replicas, template=PodTemplateSpec(
            spec=PodSpec(containers=[Container(name=name, image="local",
                                               command=cmd)])))

    job = MPIJob(
        metadata=ObjectMeta(name="torch-pi", namespace="default"),
        spec=MPIJobSpec(
            mpi_implementation=constants.IMPL_JAX,
            run_policy=RunPolicy(), run_launcher_as_worker=True,
            mpi_replica_specs={
                constants.REPLICA_TYPE_LAUNCHER: replica("launcher"),
                constants.REPLICA_TYPE_WORKER: replica("worker", 2)}))
    with LocalCluster() as cluster:
        cluster.submit(job)
        done = cluster.wait_for_condition("default", "torch-pi",
                                          constants.JOB_SUCCEEDED,
                                          timeout=180)
        logs = cluster.launcher_logs("default", "torch-pi")
    assert "workers=3" in logs, logs
    pi_line = [line for line in logs.splitlines() if "pi=" in line][0]
    assert abs(float(pi_line.split("pi=")[1]) - 3.14159) < 0.05, logs
    assert "samples=600000" in pi_line
    assert done.status.completion_time is not None
    lat_line = [line for line in logs.splitlines()
                if line.startswith("launch_to_first_allreduce_seconds=")]
    assert lat_line, logs
    assert 0 < float(lat_line[0].split("=")[1]) < 240


def test_llama_train_example_over_two_processes_with_data(tmp_path):
    """--dp 2 --data: each process reads its part of the corpus through
    the native loader and global_batch_iterator; rank 0 alone prints the
    mesh and the result."""
    from mpi_operator_tpu_torch.native import write_token_file
    corpus = tmp_path / "corpus.bin"
    write_token_file(str(corpus), np.random.default_rng(0).integers(
        0, 256, 64 * 32))
    logs = join(launch([sys.executable, TRAIN_EXAMPLE, "--config", "tiny",
                        "--device", "cpu", "--steps", "2", "--dp", "2",
                        "--seq-len", "32", "--data", str(corpus)], 2,
                       str(tmp_path)), str(tmp_path))
    assert "mesh dp=2 fsdp=1 pp=1 ep=1 tp=1 sp=1 processes=2" in logs[0]
    assert "batch=4 seq=32" in logs[0]
    loss = float(logs[0].split("loss=")[1].split()[0])
    assert np.isfinite(loss)
    assert "tokens/sec" not in logs[1] and "mesh dp" not in logs[1]
