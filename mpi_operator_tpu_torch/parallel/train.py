"""Training step and preemption-aware loop on one device.  Counterpart of
``mpi_operator_tpu/parallel/train.py``.

JAX's ``TrainState`` holds params and optax state as immutable trees and
its jitted step returns new ones.  Here the state holds the model and a
``torch.optim`` optimizer, and the step updates both in place (one copy
of the weights and moments, not two).  Sharded training (``mesh``,
``param_specs``, ``shard_update``, ``hierarchical_allreduce``) waits for
ROADMAP.md queue 1 item 3.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint


def _multi_gpu(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue 1 item 3 (multi-GPU "
        f"parallelism)")


@dataclass
class TrainState:
    """Step count, model and optimizer; ``state_dict()`` is what a
    checkpoint holds."""
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, payload: dict) -> None:
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.step = int(payload["step"])


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> Callable[[Any], torch.optim.Optimizer]:
    """Counterpart of ``optax.adamw``, with optax's defaults (torch's own
    weight decay default is 1e-2): a factory build_train_step calls on
    the model's parameters.

    optax:  p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)
    torch:  p <- p * (1 - lr * wd);  p <- p - lr * m_hat / (sqrt(v_hat)
            + eps)
    which is the same update: the Adam term does not depend on p."""
    def make(params):
        return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2),
                                 eps=eps, weight_decay=weight_decay)
    return make


def optax_global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


def build_train_step(loss_fn: Callable, optimizer, mesh=None,
                     param_specs=None, remat: bool = False,
                     accum_steps: int = 1, shard_update: bool = False,
                     hierarchical_allreduce: bool = False, goodput=None,
                     telemetry_registry=None,
                     sync_every: Optional[int] = None):
    """Build (init_fn, step_fn) on one device.

    - loss_fn(model, batch) -> scalar loss; batch is a tensor (or a tuple
      of tensors) whose dim 0 is the batch.
    - optimizer: a factory over the parameters (:func:`adamw`).
    - remat: run the loss under activation checkpointing.
    - accum_steps: >1 runs the batch as that many microbatches under one
      update, with the strided split of the JAX step (row r goes to
      microbatch r % accum_steps); loss and gradients are the mean over
      microbatches, accumulated in f32.
    - goodput / telemetry_registry: wrap step_fn in
      ``telemetry.goodput.instrument_step`` (sync every ``sync_every``).

    init_fn(model) -> TrainState; step_fn(state, batch) -> (state,
    metrics) with ``loss`` and ``grad_norm`` (of the gradients before the
    update) as f32 device scalars, read by nobody unless asked."""
    if mesh is not None or param_specs is not None:
        raise _multi_gpu("sharded training (mesh=, param_specs=)")
    if shard_update or hierarchical_allreduce:
        raise _multi_gpu("shard_update / hierarchical_allreduce")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    run_loss = loss_fn
    if remat:
        def run_loss(model, batch):
            return checkpoint(loss_fn, model, batch, use_reentrant=False)

    def init_fn(model):
        return TrainState(step=0, model=model,
                          optimizer=optimizer(model.parameters()))

    def split(batch, i):
        if isinstance(batch, (tuple, list)):
            return type(batch)(split(x, i) for x in batch)
        if batch.shape[0] % accum_steps:
            raise ValueError(f"batch dim {batch.shape[0]} not divisible by "
                             f"accum_steps {accum_steps}")
        return batch[i::accum_steps]

    def grads_of(state, batch):
        params = [p for p in state.model.parameters() if p.requires_grad]
        if accum_steps == 1:
            loss = run_loss(state.model, batch)
            loss.backward()
            return loss.detach().float(), params
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=params[0].device)
        for i in range(accum_steps):
            loss = run_loss(state.model, split(batch, i))
            loss.backward()
            loss_sum += loss.detach().float()
            for a, p in zip(acc, params):
                a += p.grad.float()
                p.grad = None
        for a, p in zip(acc, params):
            p.grad = (a / accum_steps).to(p.dtype)
        return loss_sum / accum_steps, params

    def step_fn(state: TrainState, batch):
        state.optimizer.zero_grad(set_to_none=True)
        loss, params = grads_of(state, batch)
        grad_norm = optax_global_norm([p.grad for p in params])
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm}

    if goodput is not None or telemetry_registry is not None:
        from ..telemetry.goodput import instrument_step
        step_fn = instrument_step(step_fn, goodput=goodput,
                                  registry=telemetry_registry,
                                  sync_every=sync_every)
    return init_fn, step_fn


# ---------------------------------------------------------------------------
# Preemption-aware training loop
# ---------------------------------------------------------------------------

# The kubelet exports the pod's notice-file path here; the file's
# existence IS the notice.
PREEMPTION_NOTICE_ENV = "K_PREEMPTION_NOTICE_FILE"

# Retryable under RestartPolicy=ExitCode (128-255): 128 + SIGTERM.
PREEMPTION_EXIT_CODE = 143

RESIZE_NOTICE_ENV = "K_RESIZE_NOTICE_FILE"


def preemption_notice_path() -> Optional[str]:
    """Where this process's preemption notice appears (None when no
    channel is configured)."""
    path = os.environ.get(PREEMPTION_NOTICE_ENV)
    if path:
        return path
    sandbox = os.environ.get("K_SANDBOX_DIR")
    if sandbox:
        return os.path.join(sandbox, "preemption.notice")
    return None


def preemption_requested(path: Optional[str] = None) -> bool:
    path = path or preemption_notice_path()
    return bool(path) and os.path.exists(path)


def resize_notice_path() -> Optional[str]:
    """Where this process's elastic-resize notice appears (None when no
    channel is configured)."""
    path = os.environ.get(RESIZE_NOTICE_ENV)
    if path:
        return path
    sandbox = os.environ.get("K_SANDBOX_DIR")
    if sandbox:
        return os.path.join(sandbox, "resize.notice")
    return None


def resize_requested(path: Optional[str] = None) -> Optional[int]:
    """The target worker count of a delivered resize notice, or None
    when there is no (parsable) notice."""
    path = path or resize_notice_path()
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None


def _first_step_span(t0: float, metrics, step: int) -> None:
    """Causal-trace terminal milestone: the first step of this
    incarnation, parented to the job context in the worker's env.  The
    step is asynchronous on the card (``step_fn`` returns once it is
    queued), so the span closes when the step's metrics have reached the
    host, not at the enqueue."""
    from ..telemetry.goodput import _block
    from ..telemetry.trace import default_tracer, env_context
    ctx = env_context()
    if ctx is None:
        return
    _block(metrics)
    default_tracer().emit("first_step", ts=t0, dur=time.time() - t0,
                          ctx=ctx, step=step)


class _NoticePoller:
    """At most one stat of the notice file per step, none once seen."""

    def __init__(self, path: Optional[str]):
        self._path = path
        self._seen = False
        self.stats = 0

    def poll(self) -> bool:
        if self._seen:
            return True
        if not self._path:
            return False
        self.stats += 1
        self._seen = os.path.exists(self._path)
        return self._seen


def run_train_loop(state, step_fn, batches, checkpoint_manager=None,
                   max_steps: Optional[int] = None, start_step: int = 0,
                   preemption_file: Optional[str] = None,
                   exit_on_preemption: bool = True,
                   on_metrics: Optional[Callable] = None,
                   prefetch: int = 2):
    """Drive ``step_fn`` over ``batches`` with checkpointing and a
    checkpoint-then-exit on preemption.

    Each step: run it, let the checkpoint manager save on its schedule,
    then poll the preemption notice once (re-polling right after an
    async write completes); one poll before the first step too.  On a
    notice the loop checkpoints at once, drains the writer and raises
    SystemExit(143), so the restarted job resumes from this step
    (``exit_on_preemption=False`` returns instead).  ``prefetch`` batches
    are pulled ahead on a thread (utils.data.DevicePrefetcher; 0
    disables).  On every exit path the step function's open goodput
    window is flushed (``step_fn.sync()``) and the writer drained.
    Returns ``(state, step)``."""
    step = start_step
    poller = _NoticePoller(preemption_file or preemption_notice_path())

    def drain_checkpoints():
        if checkpoint_manager is not None:
            checkpoint_manager.drain()

    def handle_preemption(saved_this_step: bool):
        # A checkpoint failure must not abort the exit protocol: any exit
        # other than 143 turns a retryable preemption into a failure.
        ckpt_error = None
        if checkpoint_manager is not None and not saved_this_step:
            try:
                checkpoint_manager.save(state, step)
            except Exception:
                # Likely a stored writer error re-raised at the save
                # point; raising cleared it, so retry once.
                try:
                    checkpoint_manager.save(state, step)
                except Exception as exc:
                    ckpt_error = exc
        if ckpt_error is None:
            try:
                drain_checkpoints()
            except Exception as exc:
                ckpt_error = exc
        # Black-box the exit: record the preemption on the flight ring,
        # export it as a sidecar (so the control plane's bundle gets a
        # train lane), and dump this process's own bundle; SystemExit
        # never reaches sys.excepthook, so this is the only chance.
        from ..telemetry import flight
        flight.record("train", "preemption", step=step,
                      checkpointed=(checkpoint_manager is not None
                                    and ckpt_error is None),
                      checkpoint_error=(repr(ckpt_error)
                                        if ckpt_error is not None else None),
                      exit_code=PREEMPTION_EXIT_CODE)
        flight.export_sidecar()
        flight.dump_bundle("train-preemption")
        if exit_on_preemption:
            raise SystemExit(PREEMPTION_EXIT_CODE)

    source = batches
    prefetcher = None
    if prefetch and prefetch > 0:
        from ..utils.data import DevicePrefetcher
        source = prefetcher = DevicePrefetcher(batches, depth=prefetch)

    save_completed = None
    if checkpoint_manager is not None:
        save_completed = checkpoint_manager.completed_since_last_poll
    try:
        if poller.poll():
            handle_preemption(saved_this_step=False)
            return state, step
        for batch in source:
            if max_steps is not None and step >= max_steps:
                break
            first = step == start_step
            if first:
                first_t0 = time.time()
            state, metrics = step_fn(state, batch)
            step += 1
            if first:
                _first_step_span(first_t0, metrics, step)
            if on_metrics is not None:
                on_metrics(step, metrics)
            saved = False
            if checkpoint_manager is not None:
                saved = checkpoint_manager.maybe_save(state, step)
                if save_completed():
                    poller.poll()
            if poller.poll():
                handle_preemption(saved_this_step=saved)
                return state, step
    finally:
        if prefetcher is not None:
            prefetcher.close()
        # Normal exit is as durable as the preemption path; an exception
        # already unwinding takes precedence over one raised here.
        unwinding = sys.exc_info()[0] is not None
        sync_error = None
        sync = getattr(step_fn, "sync", None)
        if sync is not None:
            try:
                sync()
            except BaseException as exc:
                if not unwinding:
                    sync_error = exc
        try:
            drain_checkpoints()
        except BaseException:
            if not unwinding and sync_error is None:
                raise
        if sync_error is not None:
            raise sync_error
    return state, step
