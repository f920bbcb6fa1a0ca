"""Training slice of the PyTorch port vs the JAX package on llama2_tiny.

Weights come from the JAX model's init and cross through
``from_flax_params(dtype=f32)`` (the f32-stored training model); token
batches are made with numpy.  Held: training logits at 1e-4 and
``next_token_loss`` at 1e-5; every parameter gradient against
``jax.grad`` at 1e-4; the fused cross-entropy and its gradients against
``fused_softmax_xent``; three steps of ``build_train_step`` + AdamW
against the JAX step + ``optax.adamw(3e-4)`` on a one-device CPU mesh
(loss, grad_norm and parameters at 1e-5).  Also: gradient accumulation,
the preemption protocol of ``run_train_loop`` with resume, atomic
checkpoints, the step instrumentation counters and the prefetcher.
"""

import importlib
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpi_operator_tpu.models import llama as jl
from mpi_operator_tpu.ops import fused_xent as jfx
from mpi_operator_tpu.parallel import train as jtrain
from mpi_operator_tpu.parallel.mesh import MeshConfig, create_mesh
from mpi_operator_tpu_torch.models import llama as tl
from mpi_operator_tpu_torch.models.params import (from_flax_params,
                                                  init_params,
                                                  load_flax_params)
from mpi_operator_tpu_torch.ops import fused_xent as tfx
from mpi_operator_tpu_torch.parallel.mesh import AXIS_NAMES
from mpi_operator_tpu_torch.parallel import train as ttrain
from mpi_operator_tpu_torch.telemetry.goodput import (GoodputTracker,
                                                      instrument_step)
from mpi_operator_tpu_torch.telemetry.metrics import Registry
from mpi_operator_tpu_torch.utils import checkpoint as tckpt
from mpi_operator_tpu_torch.utils.data import (DevicePrefetcher,
                                               synthetic_token_batches)

ta = importlib.import_module("mpi_operator_tpu_torch.ops.attention")

LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-5
VARIANTS = {"mha": {}, "gqa": dict(n_kv_heads=2)}
_JAX = {}


def _jax(variant):
    """(config kwargs, JAX model, variables, numpy param tree)."""
    if variant not in _JAX:
        kw = VARIANTS[variant]
        model = jl.LlamaModel(jl.llama2_tiny(**kw))
        variables = model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 4), jnp.int32))
        tree = jax.tree_util.tree_map(np.asarray, variables["params"])
        _JAX[variant] = (kw, model, variables, tree)
    return _JAX[variant]


def _tokens(seed=0, b=4, s=16):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _port(tree, kw):
    return load_flax_params(tree, tl.llama2_tiny(**kw), device="cpu",
                            dtype=torch.float32)


def _loss(model, batch):
    return tl.next_token_loss(model(batch), batch)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_loss_and_param_grads_match_jax(variant):
    kw, jm, variables, tree = _jax(variant)
    tokens = _tokens()
    tm = _port(tree, kw)
    assert tm.output.weight.dtype == torch.float32

    def jloss(params):
        return jl.next_token_loss(jm.apply({"params": params},
                                           jnp.asarray(tokens)),
                                  jnp.asarray(tokens))

    want_logits = jm.apply(variables, jnp.asarray(tokens))
    want_loss, want_grads = jax.value_and_grad(jloss)(variables["params"])
    batch = torch.from_numpy(tokens)
    logits = tm(batch)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    loss = tl.next_token_loss(logits, batch)
    np.testing.assert_allclose(loss.item(), float(want_loss),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    loss.backward()
    want = from_flax_params(jax.tree_util.tree_map(np.asarray, want_grads),
                            tm.config, torch.float32)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)


def test_fused_xent_matches_jax_and_the_plain_loss():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((30, 16), dtype=np.float32)
    w = rng.standard_normal((16, 64), dtype=np.float32)
    tgt = rng.integers(0, 64, 30).astype(np.int32)
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    loss = tfx.fused_softmax_xent(tx, tw, torch.from_numpy(tgt), 16)
    loss.backward()
    want, (gx, gw) = jax.value_and_grad(
        lambda x, w: jfx.fused_softmax_xent(x, w, jnp.asarray(tgt), 16),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(loss.item(), float(want), atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx),
                               atol=GRAD_TOL, rtol=GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw),
                               atol=GRAD_TOL, rtol=GRAD_TOL)
    # On the model: the fused loss over return_hidden equals the plain
    # loss over the logits, and so do the gradients.
    kw, _, _, tree = _jax("mha")
    tokens = torch.from_numpy(_tokens(seed=2))
    a, b = _port(tree, kw), _port(tree, kw)
    _loss(a, tokens).backward()
    hidden = b(tokens, return_hidden=True)
    fused = tfx.fused_next_token_loss(hidden, b.output.weight.t(), tokens,
                                      chunk=64)
    fused.backward()
    np.testing.assert_allclose(fused.item(), _loss(a, tokens).item(),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        np.testing.assert_allclose(pa.grad.numpy(), pb.grad.numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_three_adamw_steps_match_jax(variant):
    kw, jm, variables, tree = _jax(variant)
    tokens = _tokens(seed=3)
    mesh = create_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])

    def jloss(params, batch):
        return jl.next_token_loss(jm.apply(params, batch), batch)

    with mesh:
        init_fn, step_fn = jtrain.build_train_step(
            jloss, optax.adamw(3e-4), mesh, donate=False)
        state = init_fn(variables)
        want = []
        for _ in range(3):
            state, metrics = step_fn(state, jnp.asarray(tokens))
            want.append((float(metrics["loss"]),
                         float(metrics["grad_norm"])))
    init, step = ttrain.build_train_step(_loss, ttrain.adamw(3e-4))
    tstate = init(_port(tree, kw))
    smallest = {n: torch.full_like(p, float("inf"))
                for n, p in tstate.model.named_parameters()}
    for want_loss, want_norm in want:
        tstate, metrics = step(tstate, torch.from_numpy(tokens))
        np.testing.assert_allclose(metrics["loss"].item(), want_loss,
                                   atol=STEP_TOL, rtol=STEP_TOL)
        np.testing.assert_allclose(metrics["grad_norm"].item(), want_norm,
                                   atol=STEP_TOL, rtol=STEP_TOL)
        for n, p in tstate.model.named_parameters():
            smallest[n] = torch.minimum(smallest[n], p.grad.abs())
    assert tstate.step == 3
    final = from_flax_params(jax.tree_util.tree_map(
        np.asarray, state.params["params"]), tstate.model.config,
        torch.float32)
    # Adam divides each gradient by its own magnitude, so an element
    # whose gradient is within rounding of zero (the two frameworks sum
    # in another order) moves by an amount set by that rounding, up to
    # lr per step.  Such elements (0 < |g| < 1e-7 at some step, a few in
    # 10^4 here) are held to 3 * lr; every other element to 1e-5
    # (embedding rows of absent tokens have exact zero gradients).
    for name, p in tstate.model.named_parameters():
        got, ref = p.detach(), final[name]
        sound = (smallest[name] == 0) | (smallest[name] >= 1e-7)
        assert sound.float().mean().item() > 0.99, name
        np.testing.assert_allclose(got[sound].numpy(), ref[sound].numpy(),
                                   atol=STEP_TOL, rtol=STEP_TOL,
                                   err_msg=name)
        assert (got - ref).abs().max().item() <= 3 * 3e-4, name


def _tiny_state(accum_steps=1, **build):
    model = init_params(tl.llama2_tiny(), torch.Generator().manual_seed(5),
                        device="cpu", dtype=torch.float32)
    init, step = ttrain.build_train_step(_loss, ttrain.adamw(3e-4),
                                         accum_steps=accum_steps, **build)
    return init(model), step


def test_accum_steps_equals_the_full_batch_and_out_of_slice_raise():
    tokens = torch.from_numpy(_tokens(seed=4))
    (s1, step1), (s2, step2) = _tiny_state(1), _tiny_state(2)
    _, m1 = step1(s1, tokens)
    _, m2 = step2(s2, tokens)
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(),
                               rtol=1e-6)
    np.testing.assert_allclose(m2["grad_norm"].item(),
                               m1["grad_norm"].item(), rtol=1e-5)
    for a, b in zip(s1.model.parameters(), s2.model.parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=STEP_TOL, rtol=STEP_TOL)
    with pytest.raises(ValueError, match="divisible"):
        _tiny_state(3)[1](_tiny_state(3)[0], tokens)
    # One device is a 1-sized dp and ici axis: the plain step.
    for kw in (dict(shard_update=True), dict(hierarchical_allreduce=True)):
        assert _tiny_state(**kw)[0].plan is None
    # Every mesh axis trains now (tp, sp, ep and pp:
    # tests/test_torch_tensor_parallel.py, tests/test_torch_ring_attention.py,
    # tests/test_torch_expert_parallel.py, tests/test_torch_pipeline.py);
    # what still raises is pp beside tp, sp or ep.
    mesh = types.SimpleNamespace(mesh_dim_names=AXIS_NAMES,
                                 shape=(1, 1, 2, 1, 1, 2))
    with pytest.raises(ValueError, match="pp=2 with sp=2"):
        _tiny_state(mesh=mesh)


def test_training_forward_shapes_and_remat_launch_count(monkeypatch):
    """remat runs each block's forward again in the backward, so the
    attention forward is called twice per layer and step (on the card:
    K1' launches double), the backward once; the loss and gradients do
    not change."""
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = ta._flash_forward, ta._flash_backward

    def fwd(*a, **k):
        calls["fwd"] += 1
        return real_fwd(*a, **k)

    def bwd(*a, **k):
        calls["bwd"] += 1
        return real_bwd(*a, **k)

    def through_function(q, k, v, **kw):
        out = ta.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2))
        return out.transpose(1, 2)

    monkeypatch.setattr(ta, "_flash_forward", fwd)
    monkeypatch.setattr(ta, "_flash_backward", bwd)
    monkeypatch.setattr(tl, "attention", through_function)
    tokens = torch.from_numpy(_tokens(seed=6))
    grads = []
    for remat in (False, True):
        cfg = tl.llama2_tiny(remat=remat, n_kv_heads=2)
        model = init_params(cfg, torch.Generator().manual_seed(7),
                            device="cpu", dtype=torch.float32)
        calls.update(fwd=0, bwd=0)
        logits = model(tokens)
        assert logits.shape == (4, 16, 256)
        assert model(tokens, return_hidden=True).shape == (4, 16, 128)
        calls.update(fwd=0, bwd=0)
        tl.next_token_loss(model(tokens), tokens).backward()
        n = cfg.n_layers
        assert calls == {"fwd": n * (2 if remat else 1), "bwd": n}
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b)


def test_preemption_checkpoints_exits_143_and_resumes_identically(
        tmp_path):
    tokens = torch.from_numpy(_tokens(seed=8))
    batches = [tokens] * 6
    whole, step = _tiny_state()
    whole, n = ttrain.run_train_loop(whole, step, batches, max_steps=4)
    assert n == 4

    notice = tmp_path / "preempt.notice"
    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpt"), every=100)
    first, step = _tiny_state()

    def on_metrics(i, metrics):
        if i == 2:
            notice.write_text("now")

    with pytest.raises(SystemExit) as exc:
        ttrain.run_train_loop(first, step, batches, checkpoint_manager=mgr,
                              max_steps=4, preemption_file=str(notice),
                              on_metrics=on_metrics)
    assert exc.value.code == ttrain.PREEMPTION_EXIT_CODE == 143
    assert tckpt.latest_steps(mgr.directory) == [2]
    os.remove(notice)
    resumed, step = _tiny_state()
    resumed = mgr.restore(resumed)
    assert resumed.step == mgr.resume_step() == 2
    resumed, n = ttrain.run_train_loop(resumed, step, batches,
                                       checkpoint_manager=mgr,
                                       start_step=2, max_steps=4,
                                       preemption_file=str(notice))
    assert n == 4 and resumed.step == 4
    for a, b in zip(whole.model.parameters(), resumed.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_checkpoint_manager_never_restores_uncommitted(tmp_path):
    directory = str(tmp_path)
    state, step = _tiny_state()
    state, _ = step(state, torch.from_numpy(_tokens()))
    mgr = tckpt.CheckpointManager(directory, every=1, keep=2)
    assert mgr.maybe_save(state, 1)
    mgr.drain()
    # A torn write of a later step: a tmp directory with data, and an
    # empty final-named directory.
    os.makedirs(os.path.join(directory, "step_00000005.tmp-w"))
    with open(os.path.join(directory, "step_00000005.tmp-w", "state.pt"),
              "wb") as f:
        f.write(b"torn")
    os.makedirs(os.path.join(directory, "step_00000007"))
    assert tckpt.latest_steps(directory) == [1]
    fresh, _ = _tiny_state()
    restored = mgr.restore(fresh)
    assert restored.step == 1
    for a, b in zip(state.model.parameters(), restored.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for bad in (5, 7):
        with pytest.raises(ValueError, match="uncommitted"):
            tckpt.restore_checkpoint(directory, fresh, step=bad)
    # keep=2: a third save drops the oldest; a failing writer is re-raised
    # at the next save point.
    mgr.save(state, 2)
    mgr.save(state, 3)
    mgr.drain()
    assert tckpt.latest_steps(directory) == [2, 3]
    mgr.directory = str(tmp_path / "file")
    (tmp_path / "file").write_text("not a directory")
    mgr.save(state, 4)
    with pytest.raises(OSError):
        mgr.drain()


def test_instrument_step_counters_and_prefetcher_error_relay():
    registry = Registry()
    ticks = iter(range(100))
    gp = GoodputTracker(clock=lambda: float(next(ticks)))
    wrapped = instrument_step(lambda x: {"loss": torch.tensor(x)},
                              goodput=gp, registry=registry, sync_every=2)
    for i in range(5):
        wrapped(float(i))
    dispatched = registry.get("train_steps_dispatched_total")
    blocks = registry.get("train_host_blocks_total")
    assert dispatched.value == 5
    assert blocks.value == 2            # steps 2-3 and 4-5 of 4 after warm-up
    wrapped.sync()
    assert blocks.value == 2            # the window was empty
    wrapped(5.0)
    assert wrapped.sync()["loss"].item() == 5.0
    assert blocks.value == 3
    summary = gp.summary()
    assert summary["steps"] == 5 and summary["seconds"]["compile"] > 0

    def source():
        yield (np.zeros(2),)
        raise RuntimeError("source broke")

    fetched = DevicePrefetcher(source(), depth=2, device="cpu")
    first = next(fetched)
    assert isinstance(first[0], torch.Tensor)
    with pytest.raises(RuntimeError, match="source broke"):
        next(fetched)
    fetched.close()
    batch = synthetic_token_batches(2, 8, 100)(0)[0]
    assert batch.shape == (2, 8) and batch.max() < 100
