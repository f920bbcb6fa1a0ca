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
- (iii) ``InferenceServer(mesh=)`` (paged pool, 4 slots) at tp = 2 and 4,
  and with the weights cut over fsdp too (``parallel/fsdp_serve.py``) at
  fsdp = 2 x tp = 2 and fsdp = 2: greedy tokens equal the JAX
  ``InferenceServer(mesh=MeshConfig(tp=2, fsdp=2))`` on
  tests/test_serving.py's prompts, concurrent == alone, sampled streams
  seed-determined and independent of their neighbours; ``mixtral_tiny``
  at fsdp = 2 equals the JAX server at fsdp = 2 (and its no-cache logits,
  capacity drops included, the JAX forward's); int8 weights (the JAX
  int8 server's tokens on the same mesh), chunked prefill and
  speculation at fsdp x tp; each rank holds only its part of
  every matmul weight, int8 weights and scales included;
- (iv) three AdamW steps at tp = 2 and at fsdp = 2 x tp = 2 against the
  JAX step on the same mesh (loss, grad_norm, parameters at
  ``STEP_TOL``), the vocab-parallel fused loss against the unsharded
  one, and checkpoints: the one-device format, restored and continued
  bit for bit;
- (v) what still raises: pp (sp and ep are ported: their parity is in
  tests/test_torch_ring_attention.py and
  tests/test_torch_expert_parallel.py), a KV-head count tp does not
  divide, a model dim fsdp does not divide, dp, sp and ep in a serving
  mesh and the disaggregated roles at fsdp > 1 (under tp they are served
  in tests/test_torch_kv_transfer_tp.py);
- (vi) a follower that misses a turn (at tp = 2 and at fsdp = 2), and a
  rank that raises, end every rank with an error within the deadline.
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
from mpi_operator_tpu_torch.parallel.fsdp_serve import flat_shards, layout_of
from mpi_operator_tpu_torch.parallel.tensor import TensorParallel
from test_torch_distributed import (LR, REPO, TRAIN_EXAMPLE, WORKER,
                                    _smallest_grads, _tokens,
                                    assert_metrics_close,
                                    assert_params_close, free_port, join,
                                    launch)

LOGIT_TOL = 1e-4                       # f32 model logits (parity rules)
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7]]     # tests/test_serving.py:133
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
        ("tp_fault_raise", 2), ("fsdp_fault_skip", 2))}
    model, variables = jax_models["dense"]
    refs = {
        "logits": {name: np.asarray(m.apply(v, jnp.asarray(_tokens())))
                   for name, (m, v) in jax_models.items()},
        "serving": JaxServer(model, variables, mesh=jmesh.create_mesh(
            jmesh.MeshConfig(dp=1, tp=2, fsdp=2),
            devices=jax.devices()[:4])).generate(
                PROMPTS, max_new_tokens=5),
        "serving_int8": JaxServer(
            model, variables, weight_dtype="int8",
            mesh=jmesh.create_mesh(jmesh.MeshConfig(dp=1, tp=2, fsdp=2),
                                   devices=jax.devices()[:4])).generate(
                PROMPTS, max_new_tokens=5),
        "serving_moe_fsdp2": JaxServer(*jax_models["moe"],
                                       mesh=jmesh.create_mesh(
            jmesh.MeshConfig(dp=1, fsdp=2),
            devices=jax.devices()[:2])).generate(PROMPTS, max_new_tokens=5),
        "tp2": _jax_steps(model, variables, {"dp": 1, "tp": 2}, 2),
        "fsdp2tp2": _jax_steps(model, variables,
                               {"dp": 1, "fsdp": 2, "tp": 2}, 4),
        "dp2tp2": _jax_steps(model, variables, {"dp": 2, "tp": 2}, 4),
        "smallest": _smallest_grads(weights["dense"][2]),
        "weights": weights,
    }
    for name, (world, job_dir, t0, procs) in jobs.items():
        if name.endswith(("fault_skip", "fault_raise")):
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


def test_init_params_under_fsdp_serving_is_the_one_card_model_cut(runs):
    """At fsdp = 2 x tp = 2 each rank's state dict is the one-card
    weights at the seed cut over tp, then flat over fsdp (rank = fsdp
    index * 2 + tp index)."""
    cfg = tl.llama2_tiny()
    full = init_params(cfg, torch.Generator().manual_seed(7),
                       device="cpu").state_dict()
    for r, rank_result in enumerate(runs["tp_world4"]):
        want = shard_state_dict(full, cfg, TensorParallel(2, r % 2),
                                fsdp=TensorParallel(2, r // 2))
        got = rank_result["fsdp_init"]
        assert set(got) == set(want)
        for name, value in want.items():
            assert torch.equal(got[name], value), name


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


# -- (iii) serving with the weights cut over fsdp -------------------------

FSDP_SERVING = [("tp_world4", "fsdp_tp_serving", 2), ("tp_world2",
                                                      "fsdp_serving", 1)]


@pytest.mark.parametrize("job,key,tp", FSDP_SERVING)
def test_fsdp_server_greedy_tokens_match_the_jax_server(runs, job, key, tp):
    """fsdp = 2 x tp = 2 and fsdp = 2 (tp = 1): every rank runs every
    forward, the pool cut over tp only."""
    serving = runs[job][0][key]
    assert serving["single"] == runs["serving"]
    assert serving["multi"] == runs["serving"]
    assert serving["concurrent"] == serving["alone"]
    for rank_result in runs[job]:
        assert rank_result[key]["pool_heads"] == 4 // tp


@pytest.mark.parametrize("job,key,tp", FSDP_SERVING)
def test_fsdp_server_sampled_streams_follow_the_parity_rules(runs, job, key,
                                                             tp):
    serving = runs[job][0][key]
    first, again = serving["sampled"]
    assert len(first) == 8 and first == again
    assert serving["sampled_beside"] == first
    if tp == 2:
        # The gather is exact: fsdp x tp computes tp = 2's logits bit for
        # bit, so one seed gives tp = 2's stream.
        assert first == runs["tp_world2"][0]["serving"]["sampled"][0]


def _whole_from_ranks(ranks, cfg, fsdp, tp, key="state"):
    """The one-card state dict joined from every rank's own tensors:
    the fsdp ranks' flat shards of a unit laid end to end, cut back into
    tensors by the layout, then the tp chunks joined (rank = fsdp index
    * tp + tp index, the mesh's layout)."""
    first = ranks[0][key]
    whole = {}
    for t in range(tp):
        states = [ranks[f * tp + t][key] for f in range(fsdp)]
        flat = {k: torch.cat([st[k] for st in states])
                for k in first if ".flat_" in k}
        layout = layout_of(shard_state_dict(_meta_state(cfg), cfg,
                                            TensorParallel(tp, t)),
                           cfg, fsdp)
        part = {k: v for k, v in states[0].items() if ".flat_" not in k}
        for (unit, dtype), (_, items) in layout.runs.items():
            run = flat[f"{unit}.flat_{str(dtype).rsplit('.', 1)[-1]}"]
            for name, shape, off in items:
                n = int(np.prod(shape))
                part[name] = run[off:off + n].reshape(shape)
        for name, value in part.items():
            whole.setdefault(name, []).append(value)
    specs = tl.llama_param_specs(cfg)
    return {name: parts[0] if len(parts) == 1 or "tp" not in specs[name]
            else torch.cat(parts, dim=specs[name].index("tp"))
            for name, parts in whole.items()}


def _meta_state(cfg):
    """The one-card state dict of ``cfg`` on the meta device: the names,
    shapes and dtypes a layout is made of."""
    return tl.LlamaModel(cfg, device="meta").state_dict()


@pytest.mark.parametrize("job,key,tp", FSDP_SERVING)
def test_fsdp_ranks_hold_only_their_part_of_every_matmul_weight(runs, job,
                                                                key, tp):
    """From each rank's own tensors: the flat shards of all ranks join
    into the one-card state dict, no rank registers a tensor of a matmul
    weight's shape (its tp shard or the whole), and a rank's shards are
    1/(fsdp x tp) of the matmul bytes (padding aside); at fsdp x tp the
    int8 weights and their scales too."""
    from mpi_operator_tpu_torch.models.quant import quantize_params
    cfg = tl.llama2_tiny()
    full = runs["weights"]["dense"][2]
    ranks = [r[key]["holdings"] for r in runs[job]]
    cases = [(cfg, full, ranks)]
    if job == "tp_world4":
        qcfg = tl.llama2_tiny(weight_dtype="int8")
        cases.append((qcfg, quantize_params(full, qcfg), [
            r["fsdp_tp_extras"]["int8_holdings"] for r in runs[job]]))
    specs = tl.llama_param_specs(cfg)
    matmul = {k for k, spec in specs.items() if any(spec)}
    for c, want, held in cases:
        got = _whole_from_ranks(held, c, 2, tp)
        assert set(got) == set(want)
        for name, value in want.items():
            assert torch.equal(got[name], value), name
        cut = {k for k in want if k in matmul or k.endswith(".scale")
               and k.rsplit(".", 2)[-2] not in ("attention_norm",
                                                "ffn_norm", "norm")}
        shapes = {tuple(want[k].shape) for k in cut
                  if want[k].dim() > 1} | {
            tuple(v.shape) for v in shard_state_dict(
                want, c, TensorParallel(tp, 0)).values() if v.dim() > 1}
        world = 2 * tp
        per_rank = sum(want[k].numel() * want[k].element_size()
                       for k in cut) / world
        for rank in held:
            assert not cut & set(rank["shapes"])
            assert not {s for n, s in rank["shapes"].items()
                        if ".flat_" not in n} & shapes
            mine = sum(v.numel() * v.element_size()
                       for k, v in rank["state"].items() if ".flat_" in k)
            assert per_rank <= mine < per_rank + 4096, (mine, per_rank)


def test_fsdp_server_cuts_a_whole_model_itself(runs):
    assert runs["tp_world4"][0]["fsdp_tp_whole"] == runs["serving"]


def test_fsdp_tp_server_takes_int8_chunked_prefill_and_speculation(runs):
    extras = runs["tp_world4"][0]["fsdp_tp_extras"]
    assert all(r["fsdp_tp_extras"]["int8_equal"] for r in runs["tp_world4"])
    assert extras["chunked_spec"] == runs["serving"]
    assert extras["self_draft"] == runs["serving"]
    assert extras["chunked_spec_stats"]["spec_ticks"] > 0
    assert extras["self_draft_stats"]["spec_ticks"] > 0
    # int8 weights read through the gather buffers: the JAX int8 server's
    # tokens on the same mesh.
    assert extras["int8"] == runs["serving_int8"]


def test_mixtral_at_fsdp2_matches_the_jax_server(runs):
    """mixtral_tiny served at fsdp = 2: greedy tokens equal the JAX
    server's on a mesh of two CPU devices, and the no-cache forward (the
    capacity path) equals the JAX forward's logits: capacity counts one
    copy of the batch, as on one card."""
    for rank_result in runs["tp_world2"]:
        moe = rank_result["fsdp_moe"]
        np.testing.assert_allclose(moe["logits"].numpy(),
                                   runs["logits"]["moe"], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    assert runs["tp_world2"][0]["fsdp_moe"]["single"] == \
        runs["serving_moe_fsdp2"]


def test_flat_shards_partition_each_unit():
    """The fsdp cut is flat: the ranks' shards of a unit, laid end to
    end, are its cut tensors laid end to end (padded), for dense and
    MoE models, f32, bf16 and int8 (weights and scales)."""
    from mpi_operator_tpu_torch.models.quant import quantize_params
    for cfg in (tl.llama2_tiny(), tl.mixtral_tiny(dtype=torch.bfloat16),
                tl.llama2_tiny(n_kv_heads=2, n_layers=1)):
        model = init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
        states = [(cfg, model.state_dict())]
        if cfg.n_experts == 0:
            qcfg = tl.llama2_tiny(weight_dtype="int8",
                                  n_kv_heads=cfg.n_kv_heads,
                                  n_layers=cfg.n_layers)
            states.append((qcfg, quantize_params(model.state_dict(), qcfg)))
        for c, state in states:
            for n in (2, 3):
                parts = [flat_shards(state, c, TensorParallel(n, r))
                         for r in range(n)]
                layout = layout_of(state, c, n)
                assert {k for k in state if k not in layout.where} | {
                    k for k in parts[0] if ".flat_" in k} == set(parts[0])
                for (unit, dtype), (total, items) in layout.runs.items():
                    key = f"{unit}.flat_{str(dtype).rsplit('.', 1)[-1]}"
                    joined = torch.cat([p[key] for p in parts])
                    assert joined.numel() == total and joined.dtype == dtype
                    want = torch.cat([state[name].reshape(-1)
                                      for name, _, _ in items])
                    assert torch.equal(joined[:want.numel()], want)
                    assert not joined[want.numel():].any()


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
    # The disaggregated roles construct and serve under tp and at fsdp >
    # 1 (tests/test_torch_kv_transfer_tp.py); what a role still refuses
    # on a mesh is an unpaged cache: there is nothing to hand over.
    for role in ("prefill", "decode"):
        with pytest.raises(ValueError, match="requires a paged KV cache"):
            InferenceServer(model, mesh=_fake_mesh(tp=2, fsdp=2),
                            role=role, kv_page_size=0,
                            max_batch_slots=2, device="cpu")
    # A model dim fsdp does not divide, as jax.device_put refuses it.
    with pytest.raises(ValueError, match="dim 128 not divisible by "
                                         "fsdp=3"):
        tl.LlamaModel(tl.llama2_tiny(), device="meta", serving=True,
                      mesh=_fake_mesh(fsdp=3))
    with pytest.raises(ValueError, match="param_specs"):
        ttrain.build_train_step(lambda m, b: 0, ttrain.adamw(LR),
                                mesh=_fake_mesh(tp=2))


@pytest.mark.parametrize("axis", ["dp", "sp", "ep"])
def test_serving_mesh_refusals_that_remain(axis):
    """dp, sp and ep in a serving mesh (beside fsdp and tp, which serve)
    name their ROADMAP.md entry."""
    from mpi_operator_tpu_torch.serving import InferenceServer
    model = tl.LlamaModel(tl.llama2_tiny(), device="cpu")
    with pytest.raises(NotImplementedError,
                       match=f"{axis}=2 is not ported yet: ROADMAP.md "
                             f"queue 1 item 3 .*entry 3.5: '{axis}'"):
        InferenceServer(model, mesh=_fake_mesh(**{axis: 2, "fsdp": 2,
                                                  "tp": 2}),
                        max_batch_slots=2, device="cpu")


# -- (vi) faults ------------------------------------------------------------------

@pytest.mark.parametrize("job,words", [
    ("tp_fault_skip", "tp-exchange"),
    ("tp_fault_raise", "planted fault in rank 1's fetch"),
    ("fsdp_fault_skip", "tp-exchange")])
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
    seed, as does ``--fsdp 2``'s, and the training example trains over
    the tp mesh."""
    serve = os.path.join(REPO, "examples", "llama_serve_torch.py")
    base = ["--config", "tiny", "--device", "cpu"]
    jobs = {}
    for name, argv, world in (
            ("one", [serve, *base, "--demo", "--port", "0"], 1),
            ("serve", [serve, *base, "--demo", "--port", "0", "--tp", "2"],
             2),
            ("serve_fsdp", [serve, *base, "--demo", "--port", "0",
                            "--fsdp", "2"], 2),
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
    assert demo(logs["serve_fsdp"][0]) == demo(logs["one"][0])
    assert "serving on" not in logs["serve"][1]
    assert "serving on" not in logs["serve_fsdp"][1]
    assert "mesh dp=1 fsdp=1 pp=1 ep=1 tp=2 sp=1 processes=2" in \
        logs["train"][0]
    assert np.isfinite(float(logs["train"][0].split("loss=")[1].split()[0]))


def test_serve_example_hands_off_between_fsdp_roles(tmp_path):
    """``--fsdp 2 --role decode`` and ``--fsdp 2 --role prefill --demo
    --decode-url`` on the CPU, two jobs of two processes: the prefill
    job's demo ships the prompt's two pages to the decode job, whose
    greedy tokens equal the prefill job's own; SIGTERM stops the decode
    job's rank 0 and, through it, its follower."""
    import json
    import signal
    serve = os.path.join(REPO, "examples", "llama_serve_torch.py")
    base = [sys.executable, serve, "--config", "tiny", "--device", "cpu",
            "--fsdp", "2"]
    port = free_port()
    (tmp_path / "decode").mkdir()
    (tmp_path / "prefill").mkdir()
    decode = launch(base + ["--role", "decode", "--port", str(port)], 2,
                    str(tmp_path / "decode"))
    try:
        wait_until(lambda: "serving on" in (
            tmp_path / "decode" / "rank0.log").read_text(), timeout=120,
            interval=0.2, desc="the decode job to serve")
        prefill = launch(base + ["--role", "prefill", "--port", "0",
                                 "--demo", "--decode-url",
                                 f"http://127.0.0.1:{port}"], 2,
                         str(tmp_path / "prefill"))
        logs = join(prefill, str(tmp_path / "prefill"))
    finally:
        decode[0][2].send_signal(signal.SIGTERM)
        join(decode, str(tmp_path / "decode"))
    (line,) = [line for line in logs[0].splitlines()
               if line.startswith("demo:")]
    demo = json.loads(line[len("demo:"):])
    assert demo["handoff"] == {"shipped": 2, "imported": 2, "deduped": 0,
                               "rejected": 0}, demo
    assert demo["decode"] == demo["prefill"] and len(demo["decode"]) == 8
    assert "serving on" not in logs[1]
