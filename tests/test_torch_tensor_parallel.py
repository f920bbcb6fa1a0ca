"""Tensor parallelism of the PyTorch port (gloo on the CPU) against the JAX
package.

Ranks are real processes (``tests/torch_dist_worker.py``) that form
their group from the operator's env; a world-2 job (tp = 2) and a
world-4 job (fsdp = 2 x tp = 2, and tp = 4 serving) run while the JAX
references are computed, and two world-2 jobs plant faults.  Each job is
joined with a deadline.  Held:

- (i) the shards: ``shard_state_dict`` cuts ``from_flax_params``' tensors
  where ``llama_param_specs`` puts 'tp', chunk r of ``wq`` holding query
  heads [r*H/tp, ...) and chunk r of ``wk``/``wv`` the KV heads they read
  (GQA), and ``init_params(mesh=)`` at a seed equals the one-card weights
  cut up;
- (ii) logits of ``llama2_tiny`` f32, a GQA variant (2 KV heads) and
  ``mixtral_tiny`` at tp = 2 against the JAX ``LlamaModel.apply``;
- (iii) ``InferenceServer(mesh=)`` (paged pool, 4 slots) at tp = 2 and 4:
  greedy tokens equal the JAX ``InferenceServer(mesh=MeshConfig(tp=2,
  fsdp=2))`` on tests/test_serving.py's prompts, concurrent == alone,
  sampled streams seed-determined and independent of their neighbours;
- (iv) three AdamW steps at tp = 2 and at fsdp = 2 x tp = 2 against the
  JAX step on the same mesh (loss, grad_norm, parameters at
  ``STEP_TOL``), the vocab-parallel fused loss against the unsharded
  one, and checkpoints: the one-device format, restored and continued
  bit for bit;
- (v) what still raises: pp (sp and ep are ported: their parity is in
  tests/test_torch_ring_attention.py and
  tests/test_torch_expert_parallel.py), a KV-head count tp does not
  divide, fsdp in a serving mesh (the disaggregated roles under tp are
  served in tests/test_torch_kv_transfer_tp.py);
- (vi) a follower that misses a turn, and a rank that raises, end every
  rank with an error within the deadline.
"""

import os
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpi_operator_tpu.models import llama as jl
from mpi_operator_tpu.parallel import mesh as jmesh
from mpi_operator_tpu.parallel import train as jtrain
from mpi_operator_tpu.serving import InferenceServer as JaxServer
from mpi_operator_tpu.utils.waiters import wait_until
from mpi_operator_tpu_torch.models import llama as tl
from mpi_operator_tpu_torch.models.params import (from_flax_params,
                                                  init_params,
                                                  shard_state_dict)
from mpi_operator_tpu_torch.parallel import mesh as tmesh
from mpi_operator_tpu_torch.parallel import train as ttrain
from mpi_operator_tpu_torch.parallel.tensor import TensorParallel
from test_torch_distributed import (LR, REPO, TRAIN_EXAMPLE, WORKER,
                                    _smallest_grads, _tokens,
                                    assert_metrics_close,
                                    assert_params_close, join, launch)

LOGIT_TOL = 1e-4                       # f32 model logits (parity rules)
FAULT_DEADLINE_S = 90
MODELS = {"dense": ("llama2_tiny", {}),
          "gqa": ("llama2_tiny", {"n_kv_heads": 2}),
          "moe": ("mixtral_tiny", {})}


def _jax_variables(preset, kw):
    cfg = getattr(jl, preset)(**kw)
    model = jl.LlamaModel(cfg)
    return model, model.init(jax.random.PRNGKey(0),
                             jnp.zeros((1, 4), jnp.int32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_steps(model, variables, mesh_config, n_devices):
    """Three AdamW steps of the JAX build_train_step with
    llama_param_specs on ``mesh_config``."""
    mesh = jmesh.create_mesh(jmesh.MeshConfig(**mesh_config),
                             devices=jax.devices()[:n_devices])
    cfg = jl.llama2_tiny()

    def jloss(params, batch):
        return jl.next_token_loss(model.apply(params, batch), batch)

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
                                     tl.llama2_tiny(), torch.float32)


def _results(scenario, world, out_dir):
    return [torch.load(os.path.join(out_dir, f"{scenario}.rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _start(out, scenario, world):
    job_dir = out / scenario
    job_dir.mkdir()
    os.link(out / "inputs.pt", job_dir / "inputs.pt")
    return (world, job_dir, time.monotonic(),
            launch([sys.executable, WORKER, scenario, str(job_dir)], world,
                   str(job_dir)))


def _join_failing(procs, out_dir, t0):
    """Wait for every rank of a planted-fault job; each must exit
    non-zero (no rank hangs, none carries on alone)."""
    try:
        wait_until(lambda: all(proc.poll() is not None
                               for _, _, proc in procs),
                   timeout=max(0.0, t0 + FAULT_DEADLINE_S - time.monotonic()),
                   interval=0.1, desc="every rank of a faulty job to exit")
    except TimeoutError:
        pass                      # the ranks still running are killed
    hung = [rank for rank, _, proc in procs if proc.poll() is None]
    for _, log, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    errors = {}
    for rank, _, proc in procs:
        err = [f for f in os.listdir(out_dir)
               if f.endswith(f".rank{rank}.err")]
        text = open(os.path.join(out_dir, err[0] if err else
                                 f"rank{rank}.log")).read()
        errors[rank] = (proc.returncode, text[-2000:])
    return hung, time.monotonic() - t0, errors


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_tp")
    jax_models = {name: _jax_variables(*spec)
                  for name, spec in MODELS.items()}
    weights = {name: (MODELS[name][0], MODELS[name][1], from_flax_params(
        _np(v["params"]), getattr(tl, MODELS[name][0])(**MODELS[name][1]),
        torch.float32)) for name, (_, v) in jax_models.items()}
    torch.save({"models": weights, "config": {},
                "weights": weights["dense"][2],
                "tokens": torch.from_numpy(_tokens()).long()},
               out / "inputs.pt")
    jobs = {name: _start(out, name, world) for name, world in (
        ("tp_world2", 2), ("tp_world4", 4), ("tp_fault_skip", 2),
        ("tp_fault_raise", 2))}
    model, variables = jax_models["dense"]
    refs = {
        "logits": {name: np.asarray(m.apply(v, jnp.asarray(_tokens())))
                   for name, (m, v) in jax_models.items()},
        "serving": JaxServer(model, variables, mesh=jmesh.create_mesh(
            jmesh.MeshConfig(dp=1, tp=2, fsdp=2),
            devices=jax.devices()[:4])).generate(
                [[1, 2, 3, 4, 5], [9, 8, 7]], max_new_tokens=5),
        "tp2": _jax_steps(model, variables, {"dp": 1, "tp": 2}, 2),
        "fsdp2tp2": _jax_steps(model, variables,
                               {"dp": 1, "fsdp": 2, "tp": 2}, 4),
        "dp2tp2": _jax_steps(model, variables, {"dp": 2, "tp": 2}, 4),
        "smallest": _smallest_grads(weights["dense"][2]),
        "weights": weights,
    }
    for name, (world, job_dir, t0, procs) in jobs.items():
        if name.startswith("tp_fault"):
            refs[name] = _join_failing(procs, str(job_dir), t0)
        else:
            join(procs, str(job_dir))
            refs[name] = _results(name, world, job_dir)
    return refs


# -- (i) the shards ---------------------------------------------------------------

def test_shards_follow_llama_param_specs_and_gqa_heads(runs):
    """Rank r's shard of each tensor is its chunk on the 'tp' dim of
    llama_param_specs; in the JAX tree that is query heads
    [r*H/tp, (r+1)*H/tp) of wq and wo and KV heads [r*KH/tp, ...) of
    wk/wv, which are the KV heads those query heads read."""
    _, _, full = runs["weights"]["gqa"]
    _, variables = _jax_variables("llama2_tiny", {"n_kv_heads": 2})
    cfg = tl.llama2_tiny(n_kv_heads=2)
    h, kh, tp = cfg.n_heads, cfg.kv_heads, 2
    attn = _np(variables["params"])["layers_0"]["attention"]
    for r in range(tp):
        shard = shard_state_dict(full, cfg, TensorParallel(tp, r))
        q_heads = range(r * h // tp, (r + 1) * h // tp)
        kv_heads = range(r * kh // tp, (r + 1) * kh // tp)
        # GQA: query head j reads KV head j // (H / KH).
        assert sorted({j // (h // kh) for j in q_heads}) == list(kv_heads)
        for name, heads in (("wq", q_heads), ("wk", kv_heads),
                            ("wv", kv_heads)):
            kernel = attn[name]["kernel"][:, heads.start:heads.stop]
            want = kernel.reshape(kernel.shape[0], -1).T
            np.testing.assert_array_equal(
                shard[f"layers.0.attention.{name}.weight"].numpy(), want)
        wo = attn["wo"]["kernel"][q_heads.start:q_heads.stop]
        np.testing.assert_array_equal(
            shard["layers.0.attention.wo.weight"].numpy(),
            wo.reshape(-1, wo.shape[-1]).T)
        assert shard["tok_embeddings.weight"].shape == (cfg.vocab_size // tp,
                                                        cfg.dim)
        assert torch.equal(shard["norm.scale"], full["norm.scale"])


def test_init_params_under_tp_is_the_one_card_model_cut(runs):
    cfg = tl.llama2_tiny()
    want = dict(init_params(cfg, torch.Generator().manual_seed(7),
                            device="cpu").named_parameters())
    specs = tl.llama_param_specs(cfg)
    for r, rank_result in enumerate(runs["tp_world2"]):
        got = rank_result["init"]
        assert set(got) == set(want)
        for name, full in want.items():
            d = next((i for i, a in enumerate(specs[name]) if a == "tp"),
                     None)
            piece = full if d is None else full.chunk(2, d)[r]
            assert torch.equal(got[name], piece.detach()), name


# -- (ii) logits ------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_tp2_logits_match_jax(runs, name):
    for rank_result in runs["tp_world2"]:
        np.testing.assert_allclose(rank_result["logits"][name].numpy(),
                                   runs["logits"][name], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL, err_msg=name)


# -- (iii) serving ----------------------------------------------------------------

@pytest.mark.parametrize("job,key", [("tp_world2", "serving"),
                                     ("tp_world4", "serving4")])
def test_tp_server_greedy_tokens_match_the_jax_tp_server(runs, job, key):
    serving = runs[job][0][key]
    assert serving["single"] == runs["serving"]
    assert serving["multi"] == runs["serving"]
    assert serving["concurrent"] == serving["alone"]
    world = len(runs[job])
    for rank_result in runs[job]:
        # Each rank's pool holds its KV heads only.
        assert rank_result[key]["pool_heads"] == 4 // world


def test_tp_server_cuts_a_whole_model_itself(runs):
    assert runs["tp_world2"][0]["serving_whole"] == runs["serving"]


def test_tp_server_takes_int8_chunked_prefill_and_speculation(runs):
    extras = runs["tp_world2"][0]["extras"]
    assert all(r["extras"]["int8_equal"] for r in runs["tp_world2"])
    assert extras["chunked_spec"] == runs["serving"]
    assert extras["spec_stats"]["spec_ticks"] > 0


def test_tp_server_sampled_streams_follow_the_parity_rules(runs):
    serving = runs["tp_world2"][0]["serving"]
    first, again = serving["sampled"]
    assert len(first) == 8 and first == again            # seed-determined
    assert serving["sampled_beside"] == first            # neighbour-free


# -- (iv) training ----------------------------------------------------------------

@pytest.mark.parametrize("job,key,ref", [("tp_world2", "train", "tp2"),
                                         ("tp_world4", "train", "fsdp2tp2"),
                                         ("tp_world4", "dp_zero", "dp2tp2")])
def test_three_adamw_steps_match_the_jax_step_on_the_same_mesh(runs, job,
                                                               key, ref):
    """tp = 2, fsdp = 2 x tp = 2 (FSDP2), dp = 2 x tp = 2 with the ZeRO
    update (the replicated plan)."""
    want_metrics, want = runs[ref]
    for rank_result in runs[job]:
        run = rank_result[key]
        assert_metrics_close(run["metrics"], want_metrics)
        assert_params_close(run["params"], want, runs["smallest"], ref)


def test_fused_xent_under_tp_equals_the_unsharded_value(runs):
    for rank_result in runs["tp_world2"]:
        sharded, whole, dx_err = rank_result["xent"]
        np.testing.assert_allclose(sharded, whole, rtol=1e-6)
        assert dx_err < 1e-6


@pytest.mark.parametrize("job", ["tp_world2", "tp_world4"])
def test_tp_checkpoint_is_one_device_and_restores_bit_for_bit(runs, job):
    full = runs["weights"]["dense"][2]
    for rank_result in runs[job]:
        res = rank_result["ckpt"]
        for name, want in res["straight"].items():
            assert torch.equal(res["resumed"][name], want), name
            assert torch.equal(res["continued"][name], want), name
    saved = runs[job][0]["ckpt"]["saved_shapes"]
    assert {k: v for k, v in saved.items() if "/" not in k} == \
        {k: tuple(v.shape) for k, v in full.items()}
    assert sorted(v for k, v in saved.items() if "/" in k) == \
        sorted(tuple(v.shape) for v in full.values())


# -- (v) what still raises -------------------------------------------------------

def _fake_mesh(**axes):
    shape = tuple(axes.get(a, 1) for a in tmesh.AXIS_NAMES)
    return types.SimpleNamespace(mesh_dim_names=tmesh.AXIS_NAMES,
                                 shape=shape,
                                 get_local_rank=lambda axis: 0,
                                 get_group=lambda axis: None)


@pytest.mark.parametrize("axis", ["pp"])
def test_axes_past_tp_still_raise_with_their_pointer(axis):
    """pp is ported for training (tests/test_torch_pipeline.py), beside dp
    and fsdp only: beside tp the model, the step and the batch iterator
    refuse it (ValueError); serving over pp still waits for item 3
    (NotImplementedError).  An MoE layer takes a pp mesh
    (tests/test_torch_moe_pipeline.py): it holds every expert whole."""
    from mpi_operator_tpu_torch.ops.moe import MoEMLP
    from mpi_operator_tpu_torch.serving import InferenceServer
    from mpi_operator_tpu_torch.utils.data import global_batch_iterator
    mixed = _fake_mesh(**{axis: 2, "tp": 2})
    mesh = _fake_mesh(**{axis: 2})
    model = tl.LlamaModel(tl.llama2_tiny(), device="cpu")
    q = torch.zeros(1, 4, 2, 32)
    for call in (lambda: tl.LlamaModel(tl.llama2_tiny(), device="cpu",
                                       mesh=mixed),
                 lambda: ttrain.build_train_step(
                     lambda m, b: 0, ttrain.adamw(LR), mesh=mixed,
                     param_specs=tl.llama_param_specs(tl.llama2_tiny())),
                 lambda: next(global_batch_iterator(lambda s: (q,), mixed,
                                                    "cpu"))):
        with pytest.raises(ValueError, match=f"{axis}=2 with tp=2"):
            call()
    with pytest.raises(NotImplementedError, match="queue 1 item 3 "):
        InferenceServer(model, mesh=mesh, max_batch_slots=2, device="cpu")
    layer = MoEMLP(128, 256, 4, mesh=mesh, device="cpu")
    assert layer.w1.shape == (4, 128, 256) and layer.tp.size == 1


def test_global_batch_iterator_takes_tp():
    from mpi_operator_tpu_torch.utils.data import global_batch_iterator
    local = np.arange(6).reshape(2, 3)
    (got,) = next(global_batch_iterator(lambda step: (local,),
                                        _fake_mesh(tp=2), "cpu"))
    assert torch.equal(got, torch.from_numpy(local))


def test_kv_heads_tp_and_roles_refusals():
    with pytest.raises(ValueError, match="kv_heads 2 not divisible by "
                                         "tp=4: KV heads are not "
                                         "replicated"):
        tl.LlamaModel(tl.llama2_tiny(n_kv_heads=2), device="meta",
                      mesh=_fake_mesh(tp=4))
    from mpi_operator_tpu_torch.serving import InferenceServer
    model = tl.LlamaModel(tl.llama2_tiny(), device="cpu")
    # The disaggregated roles construct and serve under tp
    # (tests/test_torch_kv_transfer_tp.py); fsdp in a serving mesh still
    # waits for item 3.
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        InferenceServer(model, mesh=_fake_mesh(tp=2, fsdp=2),
                        max_batch_slots=2, device="cpu")
    with pytest.raises(ValueError, match="param_specs"):
        ttrain.build_train_step(lambda m, b: 0, ttrain.adamw(LR),
                                mesh=_fake_mesh(tp=2))


# -- (vi) faults ------------------------------------------------------------------

@pytest.mark.parametrize("job,words", [
    ("tp_fault_skip", "tp-exchange"),
    ("tp_fault_raise", "planted fault in rank 1's fetch")])
def test_a_faulty_rank_ends_every_rank_within_the_deadline(runs, job,
                                                            words):
    hung, seconds, errors = runs[job]
    assert not hung and seconds < FAULT_DEADLINE_S, (hung, seconds, errors)
    assert all(code not in (0, None) for code, _ in errors.values()), errors
    assert words in errors[0][1], errors


# -- the examples ------------------------------------------------------------------

def test_serve_and_train_examples_over_two_tp_processes(tmp_path):
    """``--tp 2`` on the CPU: the serving example's demo from rank 0 (its
    follower prints nothing) equals the one-process demo at the same
    seed, and the training example trains over the tp mesh."""
    serve = os.path.join(REPO, "examples", "llama_serve_torch.py")
    base = ["--config", "tiny", "--device", "cpu"]
    jobs = {}
    for name, argv, world in (
            ("one", [serve, *base, "--demo", "--port", "0"], 1),
            ("serve", [serve, *base, "--demo", "--port", "0", "--tp", "2"],
             2),
            ("train", [TRAIN_EXAMPLE, *base, "--steps", "2", "--tp", "2",
                       "--seq-len", "32"], 2)):
        (tmp_path / name).mkdir()
        jobs[name] = (launch([sys.executable, *argv], world,
                             str(tmp_path / name)), str(tmp_path / name))
    logs = {name: join(procs, out) for name, (procs, out) in jobs.items()}

    def demo(text):
        return [line for line in text.splitlines()
                if line.startswith("demo:")]

    assert demo(logs["serve"][0]) == demo(logs["one"][0]) != []
    assert "serving on" not in logs["serve"][1]
    assert "mesh dp=1 fsdp=1 pp=1 ep=1 tp=2 sp=1 processes=2" in \
        logs["train"][0]
    assert np.isfinite(float(logs["train"][0].split("loss=")[1].split()[0]))
