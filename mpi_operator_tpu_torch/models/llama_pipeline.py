"""Pipeline-parallel Llama: counterpart of
``mpi_operator_tpu/models/llama_pipeline.py``.

JAX stacks the blocks [n_layers, ...], reshapes them into
[pp_stages, layers_per_stage, ...] and keeps the embedding, final norm
and head replicated outside the ring.  Here a pipeline rank builds only
its :class:`LlamaStage`: its own blocks (layers [p*L/P, (p+1)*L/P), or
under the interleaved schedule the V chunks v*P + p), the embedding on
the rank of global stage 0 and the norm and head on the rank of the last
one.  No rank builds the whole model (the 7B's 32 layers with f32 AdamW
state do not fit one card).  Parameter names are ``LlamaModel``'s, so a
stage's state dict is a part of the one-device state dict
(``models/params.py`` draws, converts and joins them).

- :func:`pipeline_forward` / :func:`pipeline_loss`: the GPipe schedule
  (``parallel/pipeline.pipeline_apply``) under autograd, the logits on
  every pp rank;
- :func:`pipeline_loss_and_grads_1f1b`: the fused (loss, gradients) of
  the 1F1B schedule, or with ``virtual_stages > 1`` the interleaved one,
  the embedding's backward on stage 0 taking the pipeline's f32 dx.

RoPE positions are global (``arange(S)``, as JAX's ``_staged_blocks``);
the head is ``next_token_loss`` of each microbatch, averaged over M.  The
stages run their blocks without activation checkpointing, as JAX's do
(the 1F1B B slot recomputes the stage forward itself).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..device import resolve_device
from ..parallel.pipeline import (from_last_stage, merge_microbatches,
                                 pipeline_apply, pipeline_interleaved_1f1b,
                                 split_microbatches, stage_param_fsdp_dims,
                                 sum_over_batch_)
from ..parallel.tensor import refuse_pp_mix
from .llama import (LlamaBlock, LlamaConfig, RMSNorm, _linear,
                    next_token_loss)


def stage_layers(n_layers: int, n_stages: int, virtual_stages: int,
                 stage: int):
    """The global layer ids of each chunk of pipeline rank ``stage``:
    chunk v is global stage c = v*P + p and holds layers
    [c*L/(P*V), (c+1)*L/(P*V))."""
    n_chunks = n_stages * virtual_stages
    if n_layers % n_chunks:
        raise ValueError(f"n_layers {n_layers} not divisible by pp * "
                         f"virtual_stages = {n_chunks}")
    per = n_layers // n_chunks
    return [list(range((v * n_stages + stage) * per,
                       (v * n_stages + stage + 1) * per))
            for v in range(virtual_stages)]


def layer_owner(name: str, n_layers: int, n_stages: int,
                virtual_stages: int) -> int:
    """The pp index of the stage that holds parameter ``name`` (a
    ``LlamaModel`` name)."""
    if name.startswith("tok_embeddings."):
        return 0
    if not name.startswith("layers."):
        return n_stages - 1                       # norm, output
    layer = int(name.split(".")[1])
    per = n_layers // (n_stages * virtual_stages)
    return (layer // per) % n_stages


class LlamaStage(nn.Module):
    """One pipeline rank's part of :class:`models.llama.LlamaModel`.

    ``mesh``: a ``parallel.mesh`` mesh whose pp axis gives this rank's
    stage p of P (none: the one stage of a 1-stage pipeline).  The stage
    holds the blocks of its ``virtual_stages`` chunks (``chunks``: their
    global layer ids; chunk v is global stage v*P + p), the embedding
    when p == 0 and the final norm and head when p == P - 1, under
    ``LlamaModel``'s parameter names.  pp with tp, sp or ep raises
    ValueError.

    An MoE config's blocks hold their router and expert stacks whole
    (``feed_forward.router.weight`` [E, D], ``w1``/``w3`` [E, D, F],
    ``w2`` [E, F, D]) and are built without a mesh, as the JAX stages
    run ``LlamaBlock(config)`` inside ``shard_map``: each MoE layer
    counts its capacity over the rows it is given, one microbatch of its
    batch shard, with no exchange between ranks.  The load-balancing
    value is not added to the loss (the JAX stages apply the block
    without the ``losses`` collection).

    ``fsdp_shard`` (pp x fsdp): each genuine matrix of the blocks is
    held as this rank's chunk over the mesh's fsdp axis, along the dim
    ``stage_param_fsdp_dims`` picks (``fsdp_dims``: name -> dim); the
    schedules gather them once per call.  The embedding, the head and
    the norms stay whole, as the JAX pipeline keeps them outside its
    stacks.  Built on ``device`` (default: the card; ``"meta"``
    allocates nothing, for a plan to place and fill)."""

    def __init__(self, config: LlamaConfig, mesh=None, virtual_stages: int = 1,
                 fsdp_shard: bool = False, device=None, store_dtype=None):
        super().__init__()
        dev = torch.device("meta") if str(device) == "meta" else \
            resolve_device(device)
        n_stages, stage, n_fsdp, fsdp_rank = 1, 0, 1, 0
        if mesh is not None:
            sizes = refuse_pp_mix(mesh, "LlamaStage")
            n_stages, n_fsdp = sizes["pp"], sizes["fsdp"]
            stage = mesh.get_local_rank("pp") if n_stages > 1 else 0
            fsdp_rank = mesh.get_local_rank("fsdp") if n_fsdp > 1 else 0
        self.config, self.mesh = config, mesh
        self.n_stages, self.stage = n_stages, stage
        self.virtual_stages = virtual_stages
        self.chunks = stage_layers(config.n_layers, n_stages, virtual_stages,
                                   stage)
        self.holds_embedding = stage == 0
        self.holds_head = stage == n_stages - 1
        self.fsdp_shard, self.n_fsdp, self.fsdp_rank = \
            fsdp_shard, n_fsdp, fsdp_rank
        store = store_dtype or config.dtype
        with torch.device("meta"):
            if self.holds_embedding:
                self.tok_embeddings = nn.Embedding(config.vocab_size,
                                                   config.dim, dtype=store)
            self.layers = nn.ModuleDict(
                {str(i): LlamaBlock(config, store)
                 for chunk in self.chunks for i in chunk})
            if self.holds_head:
                self.norm = RMSNorm(config.dim, config.norm_eps,
                                    config.param_dtype, None)
                self.output = _linear(config, config.dim, config.vocab_size,
                                      store)
        self.fsdp_dims = {}
        if fsdp_shard:
            blocks = {n: p for n, p in self.named_parameters()
                      if n.startswith("layers.")}
            for name, d in stage_param_fsdp_dims(blocks, n_fsdp).items():
                if d < 0:
                    continue
                self.fsdp_dims[name] = d
                module, leaf = name.rsplit(".", 1)
                shape = list(blocks[name].shape)
                shape[d] //= n_fsdp
                setattr(self.get_submodule(module), leaf, nn.Parameter(
                    torch.empty(shape, dtype=blocks[name].dtype,
                                device="meta")))
        self.to_empty(device=dev)
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, RMSNorm):
                    module.scale.fill_(1.0)

    @property
    def layer_ids(self):
        return [i for chunk in self.chunks for i in chunk]

    def embed(self, tokens):
        """Token rows of the embedding in ``dtype`` (stage 0 only)."""
        return F.embedding(tokens, self.tok_embeddings.weight.to(
            self.config.dtype))

    def forward(self, x, chunk: int = 0, positions=None):
        """Chunk ``chunk``'s blocks on x [B, S, dim] at ``positions``
        (default ``arange(S)``)."""
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        for i in self.chunks[chunk]:
            x = self.layers[str(i)](x, None, positions)
        return x

    def head(self, x):
        """Final norm and head (the last stage only): logits [B, S, V]."""
        return self.output(self.norm(x))

    def chunk_params(self, chunk: int) -> dict:
        """{name: parameter} of chunk ``chunk``'s blocks."""
        prefixes = tuple(f"layers.{i}." for i in self.chunks[chunk])
        return {n: p for n, p in self.named_parameters()
                if n.startswith(prefixes)}

    def head_params(self) -> dict:
        return {n: p for n, p in self.named_parameters()
                if n.startswith(("norm.", "output."))}

    def fsdp_part(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of a one-device tensor of parameter ``name``:
        its fsdp chunk under ``fsdp_shard``, else the tensor."""
        d = self.fsdp_dims.get(name, -1)
        if d < 0:
            return full
        return full.chunk(self.n_fsdp, dim=d)[self.fsdp_rank]

    @torch.no_grad()
    def load_full_state_dict(self, state: dict) -> None:
        """Load this stage's entries of a one-device state dict (names the
        stage does not hold are ignored), cutting the fsdp chunks."""
        own = dict(self.named_parameters())
        missing = [n for n in own if n not in state]
        if missing:
            raise KeyError(f"state dict lacks {missing[:3]}...")
        for name, p in own.items():
            p.copy_(self.fsdp_part(name, state[name]))


def _check(stage: LlamaStage, mesh, virtual_stages: int,
           fsdp_shard: bool) -> None:
    pp = dict(zip(mesh.mesh_dim_names, mesh.shape))["pp"]
    if stage.n_stages != pp or stage.virtual_stages != virtual_stages:
        raise ValueError(
            f"the stage holds {stage.virtual_stages} chunk(s) of a "
            f"{stage.n_stages}-stage pipeline; the call runs pp={pp} with "
            f"virtual_stages={virtual_stages}: build "
            f"LlamaStage(mesh=, virtual_stages=) to match")
    if stage.fsdp_shard != fsdp_shard:
        raise ValueError(
            f"fsdp_shard={fsdp_shard} but the stage was built with "
            f"fsdp_shard={stage.fsdp_shard} (LlamaStage(fsdp_shard=))")


def _stage_fn(stage: LlamaStage, positions):
    """stage_fn(v, params, x): chunk v on ``params`` (the stage's own
    tensors, or the full weights gathered from its fsdp chunks)."""
    def run(v, params, x):
        return functional_call(stage, params, (x,),
                               {"chunk": v, "positions": positions})
    return run


def _stage_input(stage: LlamaStage, shape):
    """A ``meta`` stand-in for the microbatches off stage 0: the
    schedules read only its shape and dtype there."""
    return torch.empty(shape, dtype=stage.config.dtype, device="meta")


def _gpipe_hidden(stage: LlamaStage, tokens, mesh, num_microbatches: int,
                  fsdp_shard: bool):
    """The GPipe fill-drain over the blocks: the last stage's hidden
    states [B, S, D] on the last pp rank (zeros on the others),
    differentiable."""
    _check(stage, mesh, 1, fsdp_shard)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)
    x = stage.embed(tokens) if stage.holds_embedding else \
        _stage_input(stage, (b, s, stage.config.dim))
    run = _stage_fn(stage, positions)
    return merge_microbatches(pipeline_apply(
        lambda params, xx: run(0, params, xx), stage.chunk_params(0),
        split_microbatches(x, num_microbatches), mesh,
        fsdp_dims=stage.fsdp_dims or None, broadcast=False))


def pipeline_forward(stage: LlamaStage, tokens, mesh,
                     num_microbatches: int = 4, fsdp_shard: bool = False):
    """Pipelined causal-LM forward (GPipe): tokens [B, S] (this batch
    shard's rows, the same on every pp rank) -> logits [B, S, V] on every
    pp rank, differentiable (each rank's backward runs its stage).
    B must divide by ``num_microbatches``."""
    cfg = stage.config
    out = _gpipe_hidden(stage, tokens, mesh, num_microbatches, fsdp_shard)
    logits = stage.head(out) if stage.holds_head else torch.empty(
        tokens.shape + (cfg.vocab_size,), dtype=cfg.dtype, device=out.device)
    return from_last_stage(mesh, out, logits)


def pipeline_loss(stage: LlamaStage, tokens, mesh, num_microbatches: int = 4,
                  fsdp_shard: bool = False):
    """next_token_loss of :func:`pipeline_forward`'s logits (this batch
    shard's mean; the same value on every pp rank).  The last stage
    computes it; only the scalar leaves that rank."""
    out = _gpipe_hidden(stage, tokens, mesh, num_microbatches, fsdp_shard)
    loss = next_token_loss(stage.head(out), tokens) if stage.holds_head \
        else torch.empty((), dtype=torch.float32, device=out.device)
    return from_last_stage(mesh, out, loss)


def pipeline_loss_and_grads_1f1b(stage: LlamaStage, tokens, mesh,
                                 num_microbatches: int = 4,
                                 virtual_stages: int = 1,
                                 fsdp_shard: bool = False):
    """Fused 1F1B training step core: (loss, grads) in one pipelined
    pass, activation memory bounded by pipeline depth, each stage
    forward recomputed in its B slot.  With ``virtual_stages > 1`` the
    interleaved schedule runs (the stage holds V chunks of
    n_layers/(pp*V) blocks).  tokens [B, S]: this batch shard's rows, the
    same on every pp rank; B must divide by ``num_microbatches``.

    Returns (loss, grads): the global loss (mean over the batch shards)
    on every rank, and the gradients of this rank's stage under
    ``LlamaModel``'s names, in the one-device layout of each tensor it
    holds (its fsdp chunk under ``fsdp_shard``), f32, averaged over the
    batch shards like the JAX function's; ``models.params.
    gather_stage_state_dict`` joins every stage's into the one-device
    dict."""
    _check(stage, mesh, virtual_stages, fsdp_shard)
    cfg = stage.config
    token_micro = split_microbatches(tokens, num_microbatches)
    m, mb, s = token_micro.shape
    positions = torch.arange(s, device=tokens.device)
    x_micro = None
    if stage.holds_embedding:
        emb = stage.tok_embeddings.weight
        emb.grad = None
        with torch.enable_grad():
            x_micro = stage.embed(token_micro)
        xs = x_micro.detach()
    else:
        xs = _stage_input(stage, (m, mb, s, cfg.dim))

    def head_fn(head_params, y, toks, micro):
        # The head's parameters are the stage's own (never sharded).
        return next_token_loss(stage.head(y), toks)

    loss, chunk_grads, head_grads, dx = pipeline_interleaved_1f1b(
        _stage_fn(stage, positions), head_fn,
        [stage.chunk_params(v) for v in range(virtual_stages)],
        stage.head_params(), xs, mesh, virtual_stages, aux=token_micro,
        fsdp_dims=stage.fsdp_dims or None)
    grads = {}
    for chunk in chunk_grads:
        grads.update(chunk)
    grads.update(head_grads)
    if x_micro is not None:
        # dx is f32 and carries 1/n_dp: the embedding's gradient is the
        # sum over the batch shards of its backward.
        torch.autograd.backward(x_micro, dx.to(x_micro.dtype), inputs=[emb])
        grads["tok_embeddings.weight"] = sum_over_batch_(emb.grad.float(),
                                                         mesh)
    return loss, grads
