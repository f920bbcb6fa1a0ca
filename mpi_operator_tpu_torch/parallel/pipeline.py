"""Pipeline parallelism over the 'pp' axis of the port's ``DeviceMesh``:
counterpart of ``mpi_operator_tpu/parallel/pipeline.py``.

JAX stacks every stage's parameters on a leading axis sharded over 'pp'
and runs the schedules lock-step under ``shard_map``: every device traces
the same tick body, an idle slot is masked compute, and activations move
by ``jax.lax.ppermute``.  Here one process drives one card and holds
only its own stage (``models/llama_pipeline.LlamaStage``), so a rank runs
only its own slots: an idle slot (-1 in the static tables) computes
nothing.  JAX's masked compute adds only zeros there, so the sums, and
the order in which microbatches accumulate (the tables' tick order), are
JAX's.  Each tick's traffic is one batched ``isend``/``irecv`` exchange
over the pp group, and both ends of every message derive it from the
same tables (:func:`tick_ops`), so no rank waits on a send that never
comes.

- :func:`pipeline_apply`: GPipe's fill-drain over M + P - 1 ticks, one
  ``torch.autograd.Function`` (autograd does not see point-to-point
  sends): its backward runs the drain in reverse, sending each
  microbatch's input gradient to the rank before.  The outputs reach
  every pp rank, as JAX's masked psum gives them.
- :func:`pipeline_1f1b`: one F slot and one B slot per tick from
  ``_simulate_1f1b``'s table; the B slot recomputes the stage forward
  from the saved input (rematerialisation) and runs its backward with
  the queued dy.  Ring buffers of P entries indexed ``m % P``, dy in f32
  scaled by 1/M, the input gradient kept on stage 0.
- :func:`pipeline_interleaved_1f1b`: V chunks a rank (global stage v*P +
  p) from ``_simulate_interleaved``, the P-1 -> 0 wrap filed under chunk
  v + 1, ring buffers sized by the simulator.

Both 1F1B schedules end in :func:`_collect_1f1b`'s sums: the loss and the
head gradients come from the last stage, the mean is over the batch axes
(dp x fsdp), the input gradient carries 1/n_dp.  With ``fsdp_dims``
(pp x fsdp) the stage weights a rank holds are its fsdp chunks: they are
all-gathered once per call and the full-size f32 gradients are
reduce-scattered at the end (``_gather_fsdp_params``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import BATCH_AXES, pp_neighbours
from .tensor import axis_sizes

# When a list: each F and B slot of the 1F1B schedules appends
# (kind, start, end) CUDA events around its compute (chip_smoke.py reads
# the pipeline's busy time from them).  None: nothing is recorded.
SLOT_EVENTS: Optional[list] = None


# ---------------------------------------------------------------------------
# Static schedules (numpy; the JAX module's simulators, copied)
# ---------------------------------------------------------------------------

def _simulate_1f1b(n_stages: int, n_micro: int):
    """Event-driven static schedule: per (stage, tick) which microbatch to
    Forward and which to Backward (-1 = idle slot).  Each tick has one F
    slot and one B slot per stage (the standard SPMD 1F1B step); at most
    P - p microbatches are in flight at stage p, which is the 1F1B
    activation-memory bound this schedule exists for."""
    P, M = n_stages, n_micro
    t_max = 2 * (M + P) + 4
    fwd = -np.ones((P, t_max), np.int32)
    bwd = -np.ones((P, t_max), np.int32)
    fwd_done = np.full((P, M), t_max + 1)
    bwd_done = np.full((P, M), t_max + 1)
    nf = [0] * P
    nb = [0] * P

    end = 0
    for t in range(t_max):
        if all(nb[p] == M for p in range(P)):
            end = t
            break
        for p in range(P):
            # F slot: activation from the left arrived on an EARLIER tick
            # (stage 0 always has its input), bounded in-flight window.
            if nf[p] < M:
                m = nf[p]
                avail = (p == 0) or (fwd_done[p - 1][m] < t)
                if avail and (nf[p] - nb[p]) < (P - p):
                    fwd[p][t] = m
                    fwd_done[p][m] = t
                    nf[p] += 1
            # B slot: dy from the right arrived earlier; the last stage
            # builds dy from its own F of the same tick (F runs first in
            # the step body).
            if nb[p] < M:
                m = nb[p]
                ready = (fwd_done[P - 1][m] <= t) if p == P - 1 \
                    else (bwd_done[p + 1][m] < t)
                if ready:
                    bwd[p][t] = m
                    bwd_done[p][m] = t
                    nb[p] += 1
    else:
        raise RuntimeError("1F1B schedule did not converge")
    return fwd[:, :end], bwd[:, :end], end


def _phase_bounds(fwd_np, bwd_np, n_ticks: int, head_slots=None):
    """(first tick with any B scheduled, one past the last tick with any
    F scheduled): the static warmup/steady/drain split of the JAX
    schedules, whose lock-step tick bodies are specialised by segment.
    Here a rank runs only its own slots, so the split costs nothing; the
    head-slot invariant is still checked: every head-bearing F slot
    (the last global stage's) must lie in [t_warm, t_fend), which holds
    by construction of the simulators (the last stage's first B shares
    its F's tick)."""
    b_ticks = np.nonzero((bwd_np >= 0).any(axis=0))[0]
    f_ticks = np.nonzero((fwd_np >= 0).any(axis=0))[0]
    t_warm = int(b_ticks[0]) if b_ticks.size else n_ticks
    t_fend = int(f_ticks[-1]) + 1 if f_ticks.size else 0
    if head_slots is not None:
        h_ticks = np.nonzero(head_slots)[0]
        if h_ticks.size and (h_ticks[0] < t_warm or h_ticks[-1] >= t_fend):
            raise RuntimeError(
                f"head-bearing F slots at ticks [{h_ticks[0]}, "
                f"{h_ticks[-1]}] escape the combined segment "
                f"[{t_warm}, {t_fend})")
    return t_warm, t_fend


def _simulate_interleaved(n_stages: int, n_virtual: int, n_micro: int):
    """Static schedule for Megatron-style interleaved 1F1B: each
    pipeline rank owns ``n_virtual`` chunks (rank p holds global stages
    v*P + p), microbatches cycle through chunks in groups of P, and the
    warmup depth grows by (V-1)*P forwards: the bubble shrinks ~1/V at
    the cost of V x the chunk-boundary traffic (incl. the P-1 -> 0 wrap
    between chunks).

    Returns (fwd_table, bwd_table, n_ticks, kf, kb, kx): tables are
    [P, T] int32 with entries v*M + m (or -1 idle); kf, kb, kx are the
    maximum simulated occupancies of the forward-input, backward-input
    and saved-activation buffers, the ring sizes a rank allocates."""
    P, V, M = n_stages, n_virtual, n_micro
    if M % P != 0:
        raise ValueError(
            f"interleaved 1F1B needs microbatches divisible by stages "
            f"({M} % {P})")
    S = P * V

    def f_op(p, k):
        g, j = divmod(k, P * V)
        return (j // P, g * P + j % P)        # (chunk, microbatch)

    def b_op(p, k):
        g, j = divmod(k, P * V)
        return (V - 1 - j // P, g * P + j % P)

    t_max = 4 * (M * V + P) + 8
    fwd = -np.ones((P, t_max), np.int64)
    bwd = -np.ones((P, t_max), np.int64)
    fwd_done = np.full((S, M), t_max + 1)
    bwd_done = np.full((S, M), t_max + 1)
    nf = [0] * P
    nb = [0] * P
    caps = [min(M * V, (V - 1) * P + 2 * (P - p - 1) + 1)
            for p in range(P)]

    end = 0
    for t in range(t_max):
        if all(nb[p] == M * V for p in range(P)):
            end = t
            break
        for p in range(P):
            if nf[p] < M * V and (nf[p] - nb[p]) < caps[p]:
                v, m = f_op(p, nf[p])
                s = v * P + p
                if s == 0 or fwd_done[s - 1][m] < t:
                    fwd[p][t] = v * M + m
                    fwd_done[s][m] = t
                    nf[p] += 1
            if nb[p] < M * V:
                v, m = b_op(p, nb[p])
                s = v * P + p
                ready = (fwd_done[s][m] <= t) if s == S - 1 \
                    else (bwd_done[s + 1][m] < t)
                if ready:
                    bwd[p][t] = v * M + m
                    bwd_done[s][m] = t
                    nb[p] += 1
    else:
        raise RuntimeError("interleaved 1F1B schedule did not converge")

    def max_occupancy(arrivals, consumes):
        """arrivals/consumes: lists of (tick, key); occupancy counts
        arrived-not-yet-consumed at each tick."""
        events = [(t, 1) for t, _ in arrivals] + \
                 [(t + 1, -1) for t, _ in consumes]
        occ = best = 0
        for _, d in sorted(events):
            occ += d
            best = max(best, occ)
        return max(best, 1)

    kf = kb = kx = 1
    for p in range(P):
        for v in range(V):
            s = v * P + p
            f_arr = [(fwd_done[s - 1][m], m) for m in range(M) if s > 0]
            f_con = [(fwd_done[s][m], m) for m in range(M) if s > 0]
            kf = max(kf, max_occupancy(f_arr, f_con))
            b_arr = [(bwd_done[s + 1][m] if s < S - 1
                      else fwd_done[s][m], m) for m in range(M)]
            b_con = [(bwd_done[s][m], m) for m in range(M)]
            kb = max(kb, max_occupancy(b_arr, b_con))
            x_arr = [(fwd_done[s][m], m) for m in range(M)]
            x_con = [(bwd_done[s][m], m) for m in range(M)]
            kx = max(kx, max_occupancy(x_arr, x_con))
    return (fwd[:, :end].astype(np.int32), bwd[:, :end].astype(np.int32),
            end, kf, kb, kx)


def _gpipe_tables(n_stages: int, n_micro: int):
    """GPipe's fill-drain as tables: stage p forwards microbatch t - p at
    tick t, and in the backward pass (its own M + P - 1 ticks) takes
    microbatch M - 1 - (t - (P - 1 - p)): the drain in reverse."""
    P, M = n_stages, n_micro
    t = np.arange(M + P - 1)[None, :]
    p = np.arange(P)[:, None]
    f = t - p
    b = (M - 1) - (t - (P - 1 - p))
    return (np.where((f >= 0) & (f < M), f, -1).astype(np.int32),
            np.where((b >= 0) & (b < M), b, -1).astype(np.int32))


def schedule(n_stages: int, n_micro: int, n_virtual: int = 1):
    """(fwd, bwd, n_ticks, kf, kb, kx) of the 1F1B schedule (V = 1, ring
    buffers of P entries) or the interleaved one (V > 1)."""
    if n_virtual > 1:
        return _simulate_interleaved(n_stages, n_virtual, n_micro)
    fwd, bwd, n_ticks = _simulate_1f1b(n_stages, n_micro)
    return fwd, bwd, n_ticks, n_stages, n_stages, n_stages


# ---------------------------------------------------------------------------
# Each tick's messages, from the tables
# ---------------------------------------------------------------------------

class TickOp(NamedTuple):
    """One message of a tick on one rank: ``send`` or receive, ``kind``
    "f" (an activation, to the right) or "b" (an input gradient, to the
    left), the ``peer``'s pp index, and the (``chunk``, ``micro``) it
    carries: the sender's own chunk, or the chunk the receiver files it
    under."""
    send: bool
    kind: str
    peer: int
    chunk: int
    micro: int


def _entry(table, row: int, t: int) -> int:
    """``take_row(table, row)[t]``: -1 off the table's rows or ticks."""
    if table is None or not 0 <= row < table.shape[0] \
            or not 0 <= t < table.shape[1]:
        return -1
    return int(table[row][t])


def tick_ops(fwd, bwd, p: int, t: int, n_stages: int, n_virtual: int,
             n_micro: int):
    """The messages of rank ``p`` at tick ``t``, in the order the
    exchange posts them: sends (F then B), then receives (F then B).
    ``fwd``/``bwd`` are the schedule's tables (either may be None: that
    pass sends nothing).  A rank receives what its left neighbour's F
    slot and its right neighbour's B slot sent at the same tick, read
    from their rows of the same tables, so the two ends of a message
    always agree; with V > 1 the ring wraps, the P-1 -> 0 activation is
    filed under chunk v + 1 and the 0 -> P-1 gradient under v - 1 (JAX
    :842, :863).  The last global stage sends no activation and global
    stage 0 no gradient."""
    P, V, M = n_stages, n_virtual, n_micro
    last = P - 1
    wrap = V > 1
    right = (p + 1) % P if wrap else p + 1
    left = (p - 1) % P if wrap else p - 1
    sends, recvs = [], []
    e = _entry(fwd, p, t)
    if e >= 0:
        v, m = divmod(e, M)
        if not (p == last and v == V - 1):
            sends.append(TickOp(True, "f", right, v, m))
    e = _entry(bwd, p, t)
    if e >= 0:
        v, m = divmod(e, M)
        if not (p == 0 and v == 0):
            sends.append(TickOp(True, "b", left, v, m))
    e = _entry(fwd, left, t)
    if e >= 0:
        v, m = divmod(e, M)
        if not (left == last and v == V - 1):
            recvs.append(TickOp(False, "f", left, v + 1 if p == 0 else v,
                                m))
    e = _entry(bwd, right, t)
    if e >= 0:
        v, m = divmod(e, M)
        if not (right == 0 and v == 0):
            recvs.append(TickOp(False, "b", right, v - 1 if p == last else v,
                                m))
    return sends + recvs


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def split_microbatches(x, num_microbatches: int):
    """[B, ...] -> [M, B/M, ...]."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by {num_microbatches} "
                         f"microbatches")
    return x.reshape((num_microbatches, b // num_microbatches)
                     + tuple(x.shape[1:]))


def merge_microbatches(x):
    """[M, mb, ...] -> [B, ...]."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def stage_param_fsdp_dims(params: dict, n_fsdp: int) -> dict:
    """{name: dim to shard over 'fsdp', or -1} for a stage's parameters
    (their full shapes).  The first dim divisible by the axis, on genuine
    matrices only: a tensor with fewer than 2 non-trivial dims (the norm
    scales) is a few KB, and an all-gather and reduce-scatter of its own
    would cost more than it saves.  JAX's stacked leaves carry a leading
    stage dim that is never sharded; a stage here holds each layer's
    tensors as they are, so a dim indexes the tensor itself.  The rule
    needs no case of its own for MoE blocks: an expert stack ([E, D, F]
    or [E, F, D]) and a router ([E, D]) are cut along E when the axis
    divides it (the JAX rule may pick another dim of its stacked leaf;
    the gathered tensors are the same)."""
    def dim(shape):
        if n_fsdp <= 1 or sum(s > 1 for s in shape) < 2:
            return -1
        return next((d for d, s in enumerate(shape)
                     if s >= n_fsdp and s % n_fsdp == 0), -1)

    return {name: dim(tuple(t.shape)) for name, t in params.items()}


class _Place:
    """This rank's place in a pipeline mesh: pp size and index, the pp
    group, the global ranks of its ring neighbours (``peers``, by pp
    index: a tick's messages go to them alone), and the batch axes'
    groups (dp x fsdp: the ranks that hold the same stage)."""

    _warm = set()

    def __init__(self, mesh):
        from .train import _AxesGroup, _mesh_device
        sizes = axis_sizes(mesh)
        self.n = sizes["pp"]
        self.index = mesh.get_local_rank("pp") if self.n > 1 else 0
        self.group = mesh.get_group("pp") if self.n > 1 else None
        prev, nxt = pp_neighbours(mesh)
        self.peers = {(self.index - 1) % self.n: prev,
                      (self.index + 1) % self.n: nxt}
        self.last = self.index == self.n - 1
        self.batch = _AxesGroup(mesh, BATCH_AXES)
        self.n_dp = sizes["dp"] * sizes["fsdp"]
        self.n_fsdp = sizes["fsdp"]
        self.fsdp_group = mesh.get_group("fsdp") if self.n_fsdp > 1 else None
        self.dp_group = _AxesGroup(mesh, ("dp",))
        self.device = _mesh_device(mesh)
        if self.n > 1 and id(self.group) not in _Place._warm:
            # NCCL forms a group's communicator at its first collective;
            # a batched point-to-point call must not be that first call
            # unless every rank of the group joins it.
            dist.all_reduce(torch.zeros(1, device=self.device),
                            group=self.group)
            _Place._warm.add(id(self.group))

    def global_rank(self, index: int) -> int:
        if self.group is None:
            return dist.get_rank()
        return dist.get_global_rank(self.group, index % self.n)

    def exchange(self, sends, recvs) -> None:
        """One batched isend/irecv exchange: ``sends`` and ``recvs`` are
        [(tensor, pp index)] in the order :func:`tick_ops` gives."""
        ops = [dist.P2POp(dist.isend, t.contiguous(), self.peers[q],
                          self.group) for t, q in sends]
        ops += [dist.P2POp(dist.irecv, buf, self.peers[q], self.group)
                for buf, q in recvs]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()

    def from_last(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the last stage holds it, on every pp rank (in place)."""
        if self.n > 1:
            dist.broadcast(t, src=self.global_rank(self.n - 1),
                           group=self.group)
        return t


def _gather_fsdp(t: torch.Tensor, d: int, place: _Place) -> torch.Tensor:
    """The full tensor of every fsdp rank's chunk of dim ``d``."""
    moved = t.movedim(d, 0).contiguous()
    full = moved.new_empty((moved.shape[0] * place.n_fsdp,)
                           + tuple(moved.shape[1:]))
    dist.all_gather_into_tensor(full, moved, group=place.fsdp_group)
    return full.movedim(0, d)


def _scatter_fsdp(t: torch.Tensor, d: int, place: _Place) -> torch.Tensor:
    """This rank's chunk of dim ``d`` of the sum of every fsdp rank's
    ``t`` (a reduce-scatter)."""
    moved = t.movedim(d, 0).contiguous()
    part = moved.new_empty((moved.shape[0] // place.n_fsdp,)
                           + tuple(moved.shape[1:]))
    dist.reduce_scatter_tensor(part, moved, group=place.fsdp_group)
    return part.movedim(0, d)


def _gather_fsdp_params(params: dict, fsdp_dims: Optional[dict],
                        place: _Place) -> dict:
    """The full stage weights from their fsdp chunks (a dict of leaves
    that require grad): gathered once per call, so the full copy lives
    for the whole pipelined pass; what pp x fsdp buys is sharded state at
    rest (weights and optimizer moments)."""
    if not fsdp_dims:
        return params
    with torch.no_grad():
        out = {name: (_gather_fsdp(t, fsdp_dims[name], place)
                      if fsdp_dims.get(name, -1) >= 0 else t)
               for name, t in params.items()}
    return {name: (t.requires_grad_() if fsdp_dims.get(name, -1) >= 0
                   else t) for name, t in out.items()}


def _event_pair(kind: str, device):
    if SLOT_EVENTS is None or device.type != "cuda":
        return None
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    return kind, start


def _event_end(pair) -> None:
    if pair is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        SLOT_EVENTS.append((pair[0], pair[1], end))


def _check_stages(place: _Place, n_chunks: int, have: int) -> None:
    if have != n_chunks:
        raise ValueError(f"stage chunks {have} != virtual stages {n_chunks}"
                         f" (one chunk per global stage v*P + p on each of "
                         f"pp={place.n} ranks)")


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------

class _GPipe(torch.autograd.Function):
    """GPipe over the pp group as one autograd node per rank.  Forward:
    the fill-drain, keeping each microbatch's stage graph (GPipe's O(M)
    activations) and, with ``run["broadcast"]``, broadcasting the last
    stage's outputs.  Backward: the drain in reverse; every rank ignores
    the cotangent of its outputs except the last, whose own carry the
    loss's gradient."""

    @staticmethod
    def forward(ctx, run, xs, *flat):
        place, names = run["place"], run["names"]
        P, M, p = place.n, xs.shape[0], place.index
        fwd, _ = _gpipe_tables(P, M)
        keep = run["keep"]
        full = _gather_fsdp_params(
            dict(zip(names, (t.detach() for t in flat))), run["fsdp_dims"],
            place)
        leaves = {n: (t if t.requires_grad or not keep
                      else t.detach().requires_grad_())
                  for n, t in full.items()}
        mb_shape, dtype = tuple(xs.shape[1:]), run["dtype"]
        outputs = torch.zeros((M,) + mb_shape, dtype=dtype,
                              device=place.device)
        graphs = {}
        inbox = None
        for t in range(fwd.shape[1]):
            m = int(fwd[p][t])
            y = None
            if m >= 0:
                x_in = xs[m] if p == 0 else inbox
                x_leaf = x_in.detach().requires_grad_(keep)
                with torch.set_grad_enabled(keep):
                    y = run["stage_fn"](leaves, x_leaf)
                graphs[m] = (x_leaf, y)
                if place.last:
                    outputs[m] = y.detach()
            sends, recvs = [], []
            for op in tick_ops(fwd, None, p, t, P, 1, M):
                if op.send:
                    sends.append((y.detach(), op.peer))
                else:
                    inbox = torch.empty(mb_shape, dtype=dtype,
                                        device=place.device)
                    recvs.append((inbox, op.peer))
            place.exchange(sends, recvs)
        if run["broadcast"]:
            place.from_last(outputs)
        ctx.run, ctx.graphs, ctx.leaves = run, graphs, leaves
        ctx.x_meta = (xs.shape, xs.dtype, xs.device, xs.requires_grad)
        return outputs

    @staticmethod
    def backward(ctx, g_out):
        run, graphs, leaves = ctx.run, ctx.graphs, ctx.leaves
        place, names = run["place"], run["names"]
        shape, x_dtype, x_device, x_grad = ctx.x_meta
        P, M, p = place.n, shape[0], place.index
        _, bwd = _gpipe_tables(P, M)
        mb_shape, dtype = tuple(shape[1:]), run["dtype"]
        acc = [torch.zeros(leaves[n].shape, dtype=torch.float32,
                           device=leaves[n].device) for n in names]
        dxs = torch.zeros(shape, dtype=x_dtype, device=x_device) \
            if p == 0 and x_grad else None
        inbox = None
        for t in range(bwd.shape[1]):
            m = int(bwd[p][t])
            dx = None
            if m >= 0:
                x_leaf, y = graphs.pop(m)
                dy = g_out[m].to(dtype) if place.last else inbox
                grads = torch.autograd.grad(
                    y, [x_leaf] + [leaves[n] for n in names], dy,
                    allow_unused=True)
                dx = grads[0]
                for a, g in zip(acc, grads[1:]):
                    if g is not None:
                        a += g.float()
                if dxs is not None:
                    dxs[m] = dx
            sends, recvs = [], []
            for op in tick_ops(None, bwd, p, t, P, 1, M):
                if op.send:
                    sends.append((dx, op.peer))
                else:
                    inbox = torch.empty(mb_shape, dtype=dtype,
                                        device=place.device)
                    recvs.append((inbox, op.peer))
            place.exchange(sends, recvs)
        dims = run["fsdp_dims"] or {}
        out = []
        for n, a, t in zip(names, acc, run["params"]):
            if dims.get(n, -1) >= 0:
                # The all-gather's transpose: the chunk of the fsdp sum.
                a = _scatter_fsdp(a, dims[n], place)
            out.append(a.to(t.dtype))
        return (None, dxs, *out)


def pipeline_apply(stage_fn: Callable, stage_params: dict, microbatches,
                   mesh, fsdp_dims: Optional[dict] = None,
                   broadcast: bool = True):
    """Run ``microbatches`` [M, mb, ...] through the P stages of the pp
    axis, GPipe's fill-drain over M + P - 1 ticks (bubble (P-1)/(M+P-1)).

    - stage_fn(params, x) -> y, y.shape == x.shape: this rank's stage,
      on ``stage_params`` (name -> tensor; this rank's own, not stacked).
    - microbatches: read on pp rank 0 (the stage input); elsewhere only
      its shape and dtype are used (a ``meta`` tensor will do).
    - fsdp_dims: pp x fsdp: the stage weights are this rank's fsdp chunks
      of the dims named (``stage_param_fsdp_dims``), gathered once per
      call; their gradients are the chunks of the fsdp sum.

    Returns the outputs [M, mb, ...] on every pp rank (the last stage's,
    broadcast); with ``broadcast=False`` only the last rank's are the
    outputs (the others' are zeros), for a caller that reduces them there
    (``from_last_stage``).  Differentiable w.r.t. ``stage_params`` and, on
    rank 0, ``microbatches``; the gradient is that of the last stage's
    copy."""
    place = _Place(mesh)
    names = list(stage_params)
    params = [stage_params[n] for n in names]
    keep = torch.is_grad_enabled() and (
        microbatches.requires_grad or any(t.requires_grad for t in params))
    run = {"place": place, "names": names, "params": params,
           "stage_fn": stage_fn, "fsdp_dims": fsdp_dims, "keep": keep,
           "dtype": microbatches.dtype, "broadcast": broadcast}
    return _GPipe.apply(run, microbatches, *params)


class _FromLast(torch.autograd.Function):
    """The last pp rank's ``value`` on every pp rank.  Backward: the last
    rank's own gradient; the others return zeros for ``local`` (what
    their backward must still pass through: their stage; a broadcast
    zero, which allocates nothing)."""

    @staticmethod
    def forward(ctx, place, local, value):
        ctx.place, ctx.local_meta = place, (local.shape, local.dtype)
        out = value.clone() if place.last else value.new_empty(value.shape)
        return place.from_last(out)

    @staticmethod
    def backward(ctx, grad):
        shape, dtype = ctx.local_meta
        if ctx.place.last:
            return None, None, grad
        zero = torch.zeros((), dtype=dtype, device=grad.device)
        return None, zero.expand(shape), None


def from_last_stage(mesh, local, value):
    """``value`` (computed on the last pp rank; any tensor of the right
    shape and dtype elsewhere) broadcast to every pp rank, with autograd:
    the gradient reaches the last rank's ``value`` and, through zeros,
    every other rank's ``local`` (the outputs of its pipeline)."""
    return _FromLast.apply(_Place(mesh), local, value)


# ---------------------------------------------------------------------------
# 1F1B and interleaved 1F1B
# ---------------------------------------------------------------------------

def _run_1f1b(stage_fn, head_fn, chunks, head_params, xs, aux, mesh,
              n_virtual, fsdp_dims):
    """The fused forward + backward of both 1F1B schedules on this rank:
    ``chunks`` is a list of V param dicts (chunk v = global stage v*P +
    p); returns _collect_1f1b's (loss, chunk grads, head grads, dx)."""
    place = _Place(mesh)
    P, V, p, M = place.n, n_virtual, place.index, xs.shape[0]
    if M < P:
        raise ValueError(
            f"1F1B needs microbatches >= stages ({M} < {P})")
    _check_stages(place, V, len(chunks))
    fwd, bwd, n_ticks, kf, kb, kx = schedule(P, M, V)
    head_row = fwd[-1] >= (V - 1) * M if V > 1 else fwd[-1] >= 0
    _phase_bounds(fwd, bwd, n_ticks, head_slots=head_row)
    last, dev = P - 1, place.device
    mb_shape, dtype = tuple(xs.shape[1:]), xs.dtype

    full = [_gather_fsdp_params(c, fsdp_dims, place) for c in chunks]
    leaves = [[t for t in c.values() if t.requires_grad] for c in full]
    heads = [t for t in head_params.values() if t.requires_grad]
    for t in [t for group in leaves for t in group] + heads:
        t.grad = None
    fwd_buf = torch.zeros((V, kf) + mb_shape, dtype=dtype, device=dev)
    bwd_buf = torch.zeros((V, kb) + mb_shape, dtype=torch.float32,
                          device=dev)
    x_buf = torch.zeros((V, kx) + mb_shape, dtype=dtype, device=dev)
    dx = torch.zeros((M,) + mb_shape, dtype=torch.float32, device=dev) \
        if p == 0 else None
    loss = torch.zeros((), dtype=torch.float32, device=dev)

    for t in range(n_ticks):
        y = dx_m = None
        e = int(fwd[p][t])
        if e >= 0:                                    # ---- F slot
            v, m = divmod(e, M)
            x_in = xs[m] if (p == 0 and v == 0) else fwd_buf[v, m % kf]
            ev = _event_pair("F", dev)
            with torch.no_grad():
                y = stage_fn(v, full[v], x_in)
                x_buf[v, m % kx].copy_(x_in)
            if p == last and v == V - 1:
                # The head: loss and dy of this microbatch, queued for
                # the B slot (possibly this same tick).
                y_leaf = y.detach().requires_grad_()
                with torch.enable_grad():
                    loss_m = head_fn(head_params, y_leaf,
                                     None if aux is None else aux[m], m)
                torch.autograd.backward(loss_m, inputs=[y_leaf] + heads)
                loss += loss_m.detach().float() / M
                bwd_buf[v, m % kb] = y_leaf.grad.float() / M
            _event_end(ev)
        e = int(bwd[p][t])
        if e >= 0:                                    # ---- B slot
            v, m = divmod(e, M)
            ev = _event_pair("B", dev)
            x_leaf = x_buf[v, m % kx].detach().requires_grad_()
            with torch.enable_grad():
                y_b = stage_fn(v, full[v], x_leaf)
            # Parameter gradients accumulate in f32 (f32 weights) across
            # the B slots, in the table's order.
            torch.autograd.backward(y_b, bwd_buf[v, m % kb].to(dtype),
                                    inputs=[x_leaf] + leaves[v])
            dx_m = x_leaf.grad.float()
            if p == 0 and v == 0:
                dx[m] = dx_m
            _event_end(ev)
        sends, recvs = [], []
        for op in tick_ops(fwd, bwd, p, t, P, V, M):
            if op.send:
                sends.append((y if op.kind == "f" else dx_m, op.peer))
            elif op.kind == "f":
                recvs.append((fwd_buf[op.chunk, op.micro % kf], op.peer))
            else:
                recvs.append((bwd_buf[op.chunk, op.micro % kb], op.peer))
        place.exchange(sends, recvs)

    grads = [{n: (t.grad if t.grad is not None else torch.zeros_like(
        t, dtype=torch.float32)) for n, t in c.items() if t.requires_grad}
        for c in full]
    head_grads = {n: t.grad / M for n, t in head_params.items()
                  if t.requires_grad}
    return _collect_1f1b(place, loss, grads, head_grads, dx, fsdp_dims)


def _collect_1f1b(place: _Place, loss, grads, head_grads, dx, fsdp_dims):
    """The shared epilogue of both 1F1B schedules: loss and head
    gradients live on the last stage, dx on stage 0, stage gradients on
    their rank.  Each batch rank saw only its rows, so loss and parameter
    gradients get the mean over dp x fsdp that autodiff would have
    inserted; dx is d(this shard's mean)/dx and the global loss is the
    mean over shards, so it carries 1/n_dp.  With ``fsdp_dims`` a
    sharded leaf's full-size f32 gradient leaves as its chunk of the
    fsdp sum over n_fsdp (scatter first: it shrinks the tensor before
    the dp mean moves it), then the mean over dp."""
    from .train import _all_reduce_mean
    if place.n > 1:
        dist.all_reduce(loss, group=place.group)      # the last stage's
    place.batch.all_reduce_(loss)
    loss /= place.n_dp
    if head_grads:
        _all_reduce_mean(list(head_grads.values()), place.n_dp, place.batch)
    if dx is not None:
        dx /= place.n_dp
    dims = fsdp_dims or {}
    out = []
    for chunk in grads:
        plain = [g for n, g in chunk.items() if dims.get(n, -1) < 0]
        _all_reduce_mean(plain, place.n_dp, place.batch)
        coll = {}
        for n, g in chunk.items():
            if dims.get(n, -1) >= 0:
                part = _scatter_fsdp(g, dims[n], place)
                part /= place.n_fsdp
                place.dp_group.all_reduce_(part)
                part /= place.n_dp // place.n_fsdp
                coll[n] = part
            else:
                coll[n] = g
        out.append(coll)
    return loss, out, head_grads, dx


def pipeline_1f1b(stage_fn: Callable, head_fn: Callable, stage_params: dict,
                  head_params: dict, microbatches, mesh, aux=None,
                  fsdp_dims: Optional[dict] = None):
    """Fused forward + backward with the 1F1B schedule: at most P - p
    microbatch inputs are held on stage p (ring buffers of P entries),
    and each B slot recomputes the stage forward from its saved input.

    - stage_fn(params, x) -> y, homogeneous stages (y.shape == x.shape),
      on this rank's ``stage_params`` (name -> tensor).
    - head_fn(head_params, y, aux_m, m) -> scalar loss of microbatch m,
      on the last stage (the total is the mean over M); ``head_params``
      is empty elsewhere.  ``aux`` [M, mb, ...] (e.g. target tokens) is
      not differentiated.
    - microbatches [M, mb, ...]: read on pp rank 0; shape and dtype
      elsewhere (a ``meta`` tensor will do).
    - fsdp_dims: as :func:`pipeline_apply`.

    Returns (loss, stage_grads, head_grads, dx): the loss on every rank
    of the mesh, this rank's stage gradients (f32, by name, the fsdp
    chunks under ``fsdp_dims``) and head gradients (last stage; empty
    elsewhere), all averaged over the batch axes, and on pp rank 0 dx
    [M, mb, ...] f32, the gradient w.r.t. this shard's microbatches
    (feed it to the embedding backward; None elsewhere)."""
    loss, grads, head_grads, dx = _run_1f1b(
        lambda v, params, x: stage_fn(params, x), head_fn, [stage_params],
        head_params, microbatches, aux, mesh, 1, fsdp_dims)
    return loss, grads[0], head_grads, dx


def pipeline_interleaved_1f1b(stage_fn: Callable, head_fn: Callable,
                              chunk_params: list, head_params: dict,
                              microbatches, mesh, virtual_stages: int,
                              aux=None, fsdp_dims: Optional[dict] = None):
    """Interleaved (virtual-stage) 1F1B: this rank holds
    ``virtual_stages`` chunks, chunk v being global stage v*P + p, which
    shrinks the bubble ~1/V against :func:`pipeline_1f1b` at V x the
    chunk-boundary traffic (incl. the P-1 -> 0 wrap).

    - stage_fn(v, params, x) -> y runs chunk v on ``params``, its entry
      of ``chunk_params`` (a list of V name -> tensor dicts).
    - head_fn / aux / fsdp_dims / return as :func:`pipeline_1f1b`, with
      the stage gradients a list of V dicts.

    Microbatch count must divide by P (the canonical interleaved
    grouping); V = 1 is :func:`pipeline_1f1b`."""
    if virtual_stages == 1:
        loss, grads, head_grads, dx = pipeline_1f1b(
            lambda params, x: stage_fn(0, params, x), head_fn,
            chunk_params[0], head_params, microbatches, mesh, aux=aux,
            fsdp_dims=fsdp_dims)
        return loss, [grads], head_grads, dx
    return _run_1f1b(stage_fn, head_fn, chunk_params, head_params,
                     microbatches, aux, mesh, virtual_stages, fsdp_dims)


def sum_over_batch_(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed in place over the batch axes (dp x fsdp): the ranks
    that hold the same stage."""
    from .train import _AxesGroup
    return _AxesGroup(mesh, BATCH_AXES).all_reduce_(t)
