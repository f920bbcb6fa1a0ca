"""Llama-2 model family in PyTorch: the training forward and the decode
path.

Counterpart of ``mpi_operator_tpu/models/llama.py`` (RMSNorm, RoPE with
llama3 scaling, SwiGLU, optional GQA).  The training forward
(``decode=False``) runs causal flash attention through the hand-written
kernels of ``ops/attention.py`` on the card; serving uses the dense
per-row KV cache or the paged block-pool cache with optional int8 K/V,
paged decode attention through ``ops/paged_attention.py``, row-wise
sampling and the generate loops.

The KV cache is an explicit state object, not a flax ``cache``
collection: a nested dict ``{"layers_<i>": {"attention": {...}}}`` whose
per-layer leaves carry the JAX leaf names (``cache_index`` [B],
``cached_key``/``cached_value`` or ``pool_key``/``pool_value``
[+ ``pool_key_scale``/``pool_value_scale``] and ``block_table``
[B, MAXB]).  A forward call updates the cache in place: K/V are written
into the existing buffers (JAX returned a new, donated tree) and each
layer's ``cache_index`` entry is rebound to the advanced index.

Matmul weights and the embedding are stored in ``store_dtype``
(default ``config.dtype``) and cast to ``config.dtype`` at every use, as
flax casts its f32 params: serving stores them in ``dtype`` (the same
arithmetic at half the memory), training stores them in
``config.param_dtype`` (f32) so the optimizer updates f32 weights, as
the JAX ``TrainState`` does.  Norm scales stay in ``param_dtype``.
With ``weight_dtype="int8"`` the matmul layers are ``QuantLinear``s
(int8 weight, f32 scale per output row; ``models/quant.py``), as the
JAX model builds ``QuantDenseGeneral``.

With ``n_experts > 1`` (the Mixtral presets) each block's
``feed_forward`` is ``ops/moe.py``'s ``MoEMLP``, as in the JAX block:
drop-free routing exactly when a KV cache is passed (the JAX
``decode=True``: dense and paged prefill, the decode step, the
speculative verify, chunked prefill), capacity factor 1.25 in the
training forward.  Each MoE layer's Switch load-balancing value (the
JAX ``losses`` collection) is its attribute ``load_balancing`` after a
forward (``model.layers[i].feed_forward.load_balancing``); the training
loss does not include it, as the JAX example drops that collection.
Weight-only int8 with MoE raises, as in the JAX package.

Tensor parallelism (``LlamaModel(mesh=)``, a ``parallel.mesh`` mesh with
``tp`` > 1): each rank holds the ``torch.chunk`` of every dimension that
``llama_param_specs`` puts on 'tp' (Megatron: ``wq``/``wk``/``wv``/
``w1``/``w3`` and the MoE ``w1``/``w3`` by output, ``wo``/``w2`` by
input, the embedding and the head by vocabulary; norms and the router
replicated).  Chunk r of ``wq`` holds query heads [r*H/tp, (r+1)*H/tp),
which under GQA read KV heads [r*KH/tp, ...): chunk r of ``wk``/``wv``.
So attention, its KV cache (KH/tp heads a rank) and K4' run on the
rank's heads alone; a row-parallel product ends in one all-reduce (in
f32, ``parallel/tensor.py``), the embedding sums the rank that owns each
token's row, and the logits are gathered whole on every rank.

Sequence parallelism (``sp`` > 1 in the mesh; the training forward): each
rank holds token columns [i*S/sp, (i+1)*S/sp) (``parallel.mesh.seq_cols``)
at the global RoPE positions ``i*S/sp + arange(S/sp)``, attention runs
through ``ops/ring_attention.py`` with ``config.ring_impl``, and
:func:`next_token_loss` takes the next rank's first token as the target
of the rank's last column.  Expert parallelism (``ep`` > 1): each MoE
layer holds its experts' share (``ops/moe.py``); the rest of the model
is replicated over ep.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.attention import attention
from ..ops.moe import MoEMLP
from ..ops.paged_attention import paged_decode_attention
from ..ops.ring_attention import ring_attention
from ..parallel.tensor import (ExpertParallel, SequenceParallel,
                               TensorParallel, copy_to_tp, gather_from_tp,
                               reduce_from_tp, refuse_pp_mix, ring_shift)


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: Optional[int] = None          # None -> MHA (llama2-7b)
    hidden_dim: Optional[int] = None          # None -> llama2 rule
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_seq_len: int = 4096
    dtype: Any = torch.bfloat16               # weight/activation dtype
    param_dtype: Any = torch.float32          # norm scales
    remat: bool = False
    attention_impl: str = "auto"
    n_experts: int = 0                        # >1 -> MoE (ops/moe.py)
    top_k: int = 2
    ring_impl: str = "dense"
    weight_dtype: str = "auto"                # 'int8': weight-only
    sliding_window: Optional[int] = None      # Mistral SWA
    rope_scaling: Optional[dict] = None       # llama3-style scaling
    page_size: int = 0                        # >0 -> paged KV cache
    cache_blocks: int = 0                     # paged pool size; 0 -> auto
    kv_cache_dtype: str = "auto"              # 'auto' | 'int8' (paged)

    def __post_init__(self):
        # Hashable like the JAX config: the scaling mapping is kept as a
        # sorted item tuple (converted back wherever it is read).
        if isinstance(self.rope_scaling, dict):
            object.__setattr__(self, "rope_scaling",
                               tuple(sorted(self.rope_scaling.items())))
        if self.weight_dtype not in ("auto", "int8"):
            raise ValueError(
                f"weight_dtype must be 'auto' or 'int8', "
                f"got {self.weight_dtype!r}")
        if self.weight_dtype == "int8" and self.n_experts > 1:
            raise NotImplementedError(
                "weight-only int8 does not cover MoE expert stacks yet")
        if self.sliding_window is not None and self.sliding_window < 1:
            raise ValueError(
                f"sliding_window must be >= 1, got {self.sliding_window}")
        if self.kv_cache_dtype not in ("auto", "int8"):
            raise ValueError(
                f"kv_cache_dtype must be 'auto' or 'int8', "
                f"got {self.kv_cache_dtype!r}")
        if self.kv_cache_dtype == "int8" and self.page_size <= 0:
            raise ValueError(
                "kv_cache_dtype='int8' requires the paged cache "
                "(page_size > 0); the dense layout is not quantized")

    @property
    def blocks_per_row(self) -> int:
        """Logical blocks per sequence under the paged layout."""
        return -(-self.max_seq_len // max(1, self.page_size))

    def pool_blocks(self, batch: int) -> int:
        """Physical pool size: configured, or worst case (every row at
        max_seq_len) + 1 for the reserved scratch block 0."""
        if self.cache_blocks:
            return self.cache_blocks
        return 1 + batch * self.blocks_per_row

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def ffn_dim(self) -> int:
        if self.hidden_dim is not None:
            return self.hidden_dim
        # llama2: 4*dim -> 2/3 -> round up to multiple of 256.
        hidden = int(2 * (4 * self.dim) / 3)
        return 256 * ((hidden + 255) // 256)


def llama2_7b(**overrides) -> LlamaConfig:
    return LlamaConfig(**{**dict(vocab_size=32000, dim=4096, n_layers=32,
                                 n_heads=32, max_seq_len=4096), **overrides})


def llama2_tiny(**overrides) -> LlamaConfig:
    """Test config: same architecture, toy widths."""
    return LlamaConfig(**{**dict(vocab_size=256, dim=128, n_layers=2,
                                 n_heads=4, max_seq_len=256,
                                 dtype=torch.float32), **overrides})


def llama3_8b(**overrides) -> LlamaConfig:
    """Llama-3-8B-shaped config: GQA (8 kv heads), 128k vocab,
    rope_theta 500k, 14336 FFN."""
    return LlamaConfig(**{**dict(vocab_size=128256, dim=4096, n_layers=32,
                                 n_heads=32, n_kv_heads=8,
                                 hidden_dim=14336, rope_theta=500000.0,
                                 max_seq_len=8192), **overrides})


def mixtral_tiny(**overrides) -> LlamaConfig:
    """Tiny Mixtral-style MoE config (tests)."""
    return llama2_tiny(**{**dict(n_experts=4, top_k=2), **overrides})


def mixtral_8x7b(**overrides) -> LlamaConfig:
    """Mixtral-8x7B-shaped config (vocab 32k, dim 4096, 8 experts)."""
    return LlamaConfig(**{**dict(vocab_size=32000, dim=4096, n_layers=32,
                                 n_heads=32, n_kv_heads=8, hidden_dim=14336,
                                 max_seq_len=4096, n_experts=8, top_k=2),
                          **overrides})


def quantize_kv(x):
    """Per-token-per-head symmetric int8: x [..., KH, D] ->
    (int8 values, f32 scales [..., KH]) with dequant = q * scale.
    A zero vector stores scale 0 so it dequantizes to exactly zero."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    safe = torch.where(amax > 0, amax, torch.ones_like(amax))
    q = torch.round(xf / safe[..., None] * 127.0).to(torch.int8)
    return q, torch.where(amax > 0, safe / 127.0, torch.zeros_like(amax))


def dequantize_kv(q, scales):
    """Inverse of quantize_kv: int8 [..., KH, D] + scales [..., KH] ->
    f32."""
    return q.float() * scales[..., None]


def _scale_rope_freqs(freqs, scaling):
    """Llama-3.1 rope scaling: long wavelengths divided by `factor`, short
    kept, smooth interpolation in between.  ``scaling`` is a mapping or
    the config's normalized item tuple."""
    if not isinstance(scaling, dict):
        scaling = dict(scaling)
    factor = scaling["factor"]
    low = scaling.get("low_freq_factor", 1.0)
    high = scaling.get("high_freq_factor", 4.0)
    old_len = scaling.get("original_max_position_embeddings", 8192)
    wavelen = 2 * math.pi / freqs
    low_wavelen = old_len / low
    high_wavelen = old_len / high
    smooth = (old_len / wavelen - low) / (high - low)
    return torch.where(
        wavelen > low_wavelen, freqs / factor,
        torch.where(wavelen < high_wavelen, freqs,
                    (1 - smooth) * freqs / factor + smooth * freqs))


def _rope(x, positions, theta: float, scaling=None):
    """Rotary embedding on [B, S, H, D] in f32; positions [S] or [B, S]."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    if scaling is not None:
        freqs = _scale_rope_freqs(freqs, scaling)
    angles = positions[..., None].float() * freqs
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    """Inline RMSNorm in f32, as the JAX model computes it (the fused
    Pallas RMSNorm kernel is not on the model's path)."""

    def __init__(self, dim: int, eps: float, param_dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=param_dtype,
                                             device=device))

    def forward(self, x):
        xf = x.float()
        norm = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(x.dtype)


class Linear(nn.Linear):
    """Bias-free ``nn.Linear`` whose weight is stored in ``store_dtype``
    and cast to ``compute_dtype`` at use, with its input (flax
    ``DenseGeneral(dtype=..., param_dtype=...)``).  The casts are no-ops
    when the two types agree."""

    def __init__(self, n_in: int, n_out: int, compute_dtype, store_dtype,
                 device=None):
        super().__init__(n_in, n_out, bias=False, device=device,
                         dtype=store_dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return F.linear(x.to(self.compute_dtype),
                        self.weight.to(self.compute_dtype))


def _linear(cfg: LlamaConfig, n_in: int, n_out: int, store_dtype,
            device=None) -> nn.Module:
    """Matmul layer factory (the JAX ``_dense_layer``): ``Linear``, or
    the weight-only-int8 ``QuantLinear`` when cfg.weight_dtype is
    'int8'."""
    if cfg.weight_dtype == "int8":
        from .quant import QuantLinear
        return QuantLinear(n_in, n_out, cfg.dtype, device=device)
    return Linear(n_in, n_out, cfg.dtype, store_dtype, device=device)


def _decode_attention(q, k_cache, v_cache, positions, gqa_repeat: int,
                      window: Optional[int] = None):
    """Cached attention: q [B,S,H,D] against the full cache [B,L,KH,D];
    keys beyond each query's position are masked (the unused cache tail,
    stale slots and intra-step causality).  positions is per-row [B,S]."""
    if gqa_repeat > 1:
        k_cache = k_cache.repeat_interleave(gqa_repeat, dim=2)
        v_cache = v_cache.repeat_interleave(gqa_repeat, dim=2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale,
                          k_cache.float())
    kv_pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = kv_pos[None, None, :] <= positions[:, :, None]   # [B, S, L]
    if window is not None:
        mask &= kv_pos[None, None, :] > positions[:, :, None] - window
    scores = scores.masked_fill(~mask[:, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v_cache.float())
    return out.to(q.dtype)


class LlamaAttention(nn.Module):
    """Attention over this rank's heads: ``n_heads`` query and
    ``kv_heads`` KV heads of the config, divided by tp."""

    def __init__(self, cfg: LlamaConfig, store_dtype,
                 tp: TensorParallel = TensorParallel(),
                 sp: SequenceParallel = SequenceParallel()):
        super().__init__()
        self.config = cfg
        self.tp, self.sp = tp, sp
        self.n_heads = cfg.n_heads // tp.size
        self.kv_heads = cfg.kv_heads // tp.size
        hd = cfg.head_dim
        self.wq = _linear(cfg, cfg.dim, self.n_heads * hd, store_dtype)
        self.wk = _linear(cfg, cfg.dim, self.kv_heads * hd, store_dtype)
        self.wv = _linear(cfg, cfg.dim, self.kv_heads * hd, store_dtype)
        self.wo = _linear(cfg, self.n_heads * hd, cfg.dim, store_dtype)

    def forward(self, x, cache: Optional[dict], positions=None):
        """x [B, S, dim].  With ``cache`` (this layer's cache dict,
        updated in place; dense or paged by its layout): the decode
        path.  Without: the training forward at ``positions`` [S]."""
        x = copy_to_tp(x, self.tp)
        if cache is None:
            return self._out(self._train(x, positions))
        cfg = self.config
        b, s, _ = x.shape
        hd, kvh = cfg.head_dim, self.kv_heads
        idx = cache["cache_index"]
        # Per-row positions: each row decodes at its own cache index.
        positions = idx[:, None].long() + torch.arange(s, device=x.device)

        q = self.wq(x).view(b, s, self.n_heads, hd)
        k = self.wk(x).view(b, s, kvh, hd)
        v = self.wv(x).view(b, s, kvh, hd)
        q = _rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = _rope(k, positions, cfg.rope_theta, cfg.rope_scaling)

        if "pool_key" in cache:
            out = self._paged(cache, q, k, v, positions)
        else:
            ck, cv = cache["cached_key"], cache["cached_value"]
            # Per-row insertion at each row's own index; the start is
            # clamped into the cache like lax.dynamic_update_slice, so an
            # idle slot ticking past the end rewrites its last position.
            start = idx.long().clamp(0, ck.shape[1] - s)
            rows = torch.arange(b, device=x.device)[:, None]
            cols = start[:, None] + torch.arange(s, device=x.device)
            ck.index_put_((rows, cols), k.to(ck.dtype))
            cv.index_put_((rows, cols), v.to(cv.dtype))
            cache["cache_index"] = idx + s
            out = _decode_attention(q, ck, cv, positions,
                                    self.n_heads // kvh,
                                    window=cfg.sliding_window)
        return self._out(out)

    def _out(self, out):
        """``wo`` over this rank's heads [B, S, H/tp, D]; under tp the
        partial products of the ranks are summed (row-parallel)."""
        b, s = out.shape[:2]
        return reduce_from_tp(self.wo(out.reshape(b, s, -1)), self.tp)

    def _train(self, x, positions):
        cfg = self.config
        b, s, _ = x.shape
        hd, kvh, nh = cfg.head_dim, self.kv_heads, self.n_heads
        q = _rope(self.wq(x).view(b, s, nh, hd), positions,
                  cfg.rope_theta, cfg.rope_scaling)
        k = _rope(self.wk(x).view(b, s, kvh, hd), positions, cfg.rope_theta,
                  cfg.rope_scaling)
        v = self.wv(x).view(b, s, kvh, hd)
        if kvh != nh:                        # GQA: repeat KV groups
            k = k.repeat_interleave(nh // kvh, dim=2)
            v = v.repeat_interleave(nh // kvh, dim=2)
        if self.sp.size > 1:
            if cfg.sliding_window is not None:
                raise NotImplementedError(
                    "sliding_window + sequence-parallel ring attention is "
                    "not supported; run SWA models with sp=1")
            return ring_attention(q, k, v, self.sp.mesh, causal=True,
                                  impl=cfg.ring_impl)
        return attention(q, k, v, causal=True, impl=cfg.attention_impl,
                         mesh=self.tp.mesh, window=cfg.sliding_window)

    def _paged(self, cache, q, k, v, positions):
        cfg = self.config
        b, s = q.shape[:2]
        hd, kvh = cfg.head_dim, self.kv_heads
        pool_k, pool_v = cache["pool_key"], cache["pool_value"]
        table = cache["block_table"]
        page, maxb = pool_k.shape[1], table.shape[1]
        int8_kv = "pool_key_scale" in cache
        idx = cache["cache_index"]
        # Scatter the s new tokens through the block table: position p
        # lands in block table[row, p // page] at offset p % page.  Live
        # rows write only private blocks; inactive rows all write the
        # scratch block 0, where duplicate writes (any winner) are fine.
        logical = (positions // page).clamp(0, maxb - 1)
        dest_block = torch.take_along_dim(table, logical, dim=1)
        flat_b = dest_block.reshape(-1).long()
        flat_o = (positions % page).reshape(-1)
        k_rows = k.reshape(b * s, kvh, hd)
        v_rows = v.reshape(b * s, kvh, hd)
        if int8_kv:
            k_q, k_sc = quantize_kv(k_rows)
            v_q, v_sc = quantize_kv(v_rows)
            pool_k.index_put_((flat_b, flat_o), k_q)
            pool_v.index_put_((flat_b, flat_o), v_q)
            cache["pool_key_scale"].index_put_((flat_b, flat_o), k_sc)
            cache["pool_value_scale"].index_put_((flat_b, flat_o), v_sc)
        else:
            pool_k.index_put_((flat_b, flat_o), k_rows.to(pool_k.dtype))
            pool_v.index_put_((flat_b, flat_o), v_rows.to(pool_v.dtype))
        cache["cache_index"] = idx + s
        if s == 1:
            # Single-token decode (the serving hot path): the kernel
            # attends straight against the pool.
            return paged_decode_attention(
                q[:, 0], pool_k, pool_v, table, idx + 1,
                k_scale=cache.get("pool_key_scale"),
                v_scale=cache.get("pool_value_scale"),
                window=cfg.sliding_window)[:, None]
        # Multi-token (suffix prefill into a paged cache): gather each
        # row's blocks in logical order, so the view index equals the
        # sequence position and the causal mask applies unchanged.
        span = maxb * page
        tbl = table.long()
        k_all = pool_k[tbl].reshape(b, span, kvh, hd)
        v_all = pool_v[tbl].reshape(b, span, kvh, hd)
        if int8_kv:
            k_all = dequantize_kv(k_all, cache["pool_key_scale"][tbl].reshape(
                b, span, kvh)).to(cfg.dtype)
            v_all = dequantize_kv(v_all, cache["pool_value_scale"][
                tbl].reshape(b, span, kvh)).to(cfg.dtype)
        return _decode_attention(q, k_all, v_all, positions,
                                 self.n_heads // kvh,
                                 window=cfg.sliding_window)


class LlamaMLP(nn.Module):
    """SwiGLU over this rank's ffn_dim/tp hidden units: ``w1``/``w3``
    column-parallel, ``w2`` row-parallel."""

    def __init__(self, cfg: LlamaConfig, store_dtype,
                 tp: TensorParallel = TensorParallel()):
        super().__init__()
        self.tp = tp
        hidden = cfg.ffn_dim // tp.size
        self.w1 = _linear(cfg, cfg.dim, hidden, store_dtype)
        self.w3 = _linear(cfg, cfg.dim, hidden, store_dtype)
        self.w2 = _linear(cfg, hidden, cfg.dim, store_dtype)

    def forward(self, x):
        x = copy_to_tp(x, self.tp)
        return reduce_from_tp(self.w2(F.silu(self.w1(x)) * self.w3(x)),
                              self.tp)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, store_dtype,
                 tp: TensorParallel = TensorParallel(),
                 sp: SequenceParallel = SequenceParallel()):
        super().__init__()
        self.attention = LlamaAttention(cfg, store_dtype, tp, sp)
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps,
                                      cfg.param_dtype, None)
        self.moe = cfg.n_experts > 1
        if self.moe:
            self.feed_forward = MoEMLP(
                cfg.dim, cfg.ffn_dim, cfg.n_experts, top_k=cfg.top_k,
                dtype=cfg.dtype, store_dtype=store_dtype,
                param_dtype=cfg.param_dtype, mesh=tp.mesh)
        else:
            self.feed_forward = LlamaMLP(cfg, store_dtype, tp)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.param_dtype, None)

    def forward(self, x, cache: Optional[dict], positions=None):
        h = x + self.attention(self.attention_norm(x), cache, positions)
        normed = self.ffn_norm(h)
        if self.moe:
            # With a cache (JAX decode=True) routing is drop-free: a
            # decode step's capacity differs from the prefill's, so
            # dropping would make generation diverge from the model's
            # own forward pass (ops/moe.py).
            return h + self.feed_forward(normed, no_drop=cache is not None)
        return h + self.feed_forward(normed)


class LlamaModel(nn.Module):
    """Causal LM: tokens [B, S] -> logits [B, S, V]; the training forward
    without a cache, the decode path with one.

    Parameters are allocated on ``device`` (default: the CUDA card)
    without initialisation; fill them with ``load_state_dict`` or build
    the model through ``models.params`` (``init_params``,
    ``load_flax_params``).  ``store_dtype`` is the storage type of the
    matmul weights and the embedding (default ``config.dtype``; training
    passes ``config.param_dtype``).

    ``mesh`` (a ``parallel.mesh.create_mesh`` mesh): the model holds this
    rank's tensor-parallel shards over its 'tp' axis (see the module
    docstring; every rank of the tp group runs every forward together).
    Its 'dp' and 'fsdp' axes are the training step's; under 'sp' the
    training forward takes this rank's token columns and runs ring
    attention, under 'ep' each MoE layer holds its experts' share (see
    the module docstring).  Over 'pp' the model is whole, dense or MoE,
    as the JAX model is under a pp mesh: a pipeline rank builds only its
    stage (``models/llama_pipeline.LlamaStage``, from this module's
    ``LlamaBlock``, ``RMSNorm`` and ``_linear``); pp with tp, sp or ep
    raises ValueError.  A KV-head count that tp does not divide raises
    ValueError: KV heads are not replicated over tp, in either
    package."""

    def __init__(self, config: LlamaConfig, device=None, store_dtype=None,
                 mesh=None):
        super().__init__()
        # "meta" allocates nothing: sharded training places the model
        # first and fills each rank's shard (models/params.py).
        dev = torch.device("meta") if str(device) == "meta" else \
            resolve_device(device)
        store = store_dtype or config.dtype
        self.config = config
        if mesh is not None:
            refuse_pp_mix(mesh, "LlamaModel")
        self.tp = tp = TensorParallel.of(mesh)
        self.sp = sp = SequenceParallel.of(mesh)
        self.ep = ExpertParallel.of(mesh)
        _check_tp(config, tp.size)
        if config.n_experts > 1 and config.n_experts % self.ep.size:
            raise ValueError(f"n_experts {config.n_experts} not divisible "
                             f"by ep={self.ep.size}")
        with torch.device("meta"):
            self.tok_embeddings = nn.Embedding(config.vocab_size // tp.size,
                                               config.dim, dtype=store)
            self.layers = nn.ModuleList(
                LlamaBlock(config, store, tp, sp)
                for _ in range(config.n_layers))
            self.norm = RMSNorm(config.dim, config.norm_eps,
                                config.param_dtype, None)
            self.output = _linear(config, config.dim,
                                  config.vocab_size // tp.size, store)
        self.to_empty(device=dev)
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, RMSNorm):
                    module.scale.fill_(1.0)

    @property
    def device(self) -> torch.device:
        return self.output.weight.device

    @property
    def mesh(self):
        return self.tp.mesh

    def _embed(self, tokens):
        """Token rows of the embedding.  Under tp each rank looks up the
        tokens of its own vocabulary range and zeroes the rest; exactly
        one rank holds each row, so the all-reduce adds only zeros to it
        (exact)."""
        w = self.tok_embeddings.weight.to(self.config.dtype)
        tp = self.tp
        if tp.size == 1:
            return F.embedding(tokens, w)
        local = tokens.long() - tp.rank * w.shape[0]
        mine = (local >= 0) & (local < w.shape[0])
        rows = F.embedding(local.clamp(0, w.shape[0] - 1), w)
        return reduce_from_tp(torch.where(mine[..., None], rows,
                                          torch.zeros_like(rows)), tp)

    def forward(self, tokens, cache: Optional[dict] = None,
                decode: bool = False, return_hidden: bool = False):
        """``return_hidden`` returns the normed pre-head hidden states
        [B, S, dim] (the fused-xent loss applies the head itself).  With
        ``config.remat`` each block of the training forward runs under
        activation checkpointing (flax ``nn.remat``)."""
        cfg = self.config
        # The table is cast to dtype before the lookup, as flax's
        # promote_dtype does.
        x = self._embed(tokens)
        if decode:
            if cache is None:
                raise ValueError("decode=True needs a KV cache (init_cache)")
            if self.sp.size > 1:
                raise NotImplementedError(
                    "the decode path over a sequence-parallel mesh is not "
                    "ported: ROADMAP.md queue 1 item 3 (serve with sp=1)")
            for i, layer in enumerate(self.layers):
                x = layer(x, cache[f"layers_{i}"]["attention"])
        else:
            if cache is not None:
                raise ValueError("the training forward (decode=False) takes "
                                 "no KV cache")
            # Global positions: sp rank i holds columns i*S/sp onward.
            s_local = tokens.shape[1]
            positions = self.sp.rank * s_local + torch.arange(
                s_local, device=x.device)
            for layer in self.layers:
                if cfg.remat:
                    x = checkpoint(layer, x, None, positions,
                                   use_reentrant=False)
                else:
                    x = layer(x, None, positions)
        x = self.norm(x)
        if return_hidden:
            return x
        # Under tp: this rank's vocabulary columns, gathered whole.
        return gather_from_tp(self.output(copy_to_tp(x, self.tp)), self.tp)


def _check_tp(cfg: LlamaConfig, tp: int) -> None:
    """Every dimension llama_param_specs puts on 'tp' divides by it."""
    if tp == 1:
        return
    if cfg.kv_heads % tp:
        raise ValueError(
            f"kv_heads {cfg.kv_heads} not divisible by tp={tp}: KV heads "
            f"are not replicated over tp (nor in the JAX package's "
            f"server)")
    for what, n in (("n_heads", cfg.n_heads), ("ffn_dim", cfg.ffn_dim),
                    ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(f"{what} {n} not divisible by tp={tp}")


def llama_param_specs(config: LlamaConfig) -> dict:
    """The mesh axis of each dim of each parameter of :class:`LlamaModel`
    (``None``: not sharded): the JAX ``llama_param_specs`` (Megatron
    sharding: head/hidden/vocab dims over 'tp', the opposite matmul dim
    over 'fsdp', norms replicated) transposed to the port's layouts.  A
    Flax kernel is [in, ...out] and an ``nn.Linear`` weight [out, in]
    (``models/params.py``), so ``wq`` P("fsdp", "tp", None) becomes
    ("tp", "fsdp"); the embedding keeps its [V, dim] layout and the MoE
    expert stacks theirs.  An int8 weight's ``.scale`` [out] follows the
    weight's output dim.

    ``LlamaModel(mesh=)`` cuts the 'tp' and 'ep' dims (``models/params.py``
    cuts and joins full tensors by them), ``parallel/train.build_train_step``
    shards the 'fsdp' entries (and grafts 'dp' for its ZeRO update)."""
    def linear(name, out_axis, in_axis):
        specs = {f"{name}.weight": (out_axis, in_axis)}
        if config.weight_dtype == "int8":
            specs[f"{name}.scale"] = (out_axis,)
        return specs

    def block(i):
        pre = f"layers.{i}"
        specs = {f"{pre}.attention_norm.scale": (None,),
                 f"{pre}.ffn_norm.scale": (None,)}
        for name in ("wq", "wk", "wv"):
            specs.update(linear(f"{pre}.attention.{name}", "tp", "fsdp"))
        specs.update(linear(f"{pre}.attention.wo", "fsdp", "tp"))
        ffn = f"{pre}.feed_forward"
        if config.n_experts > 1:
            specs.update({f"{ffn}.router.weight": (None, None),
                          f"{ffn}.w1": ("ep", "fsdp", "tp"),
                          f"{ffn}.w3": ("ep", "fsdp", "tp"),
                          f"{ffn}.w2": ("ep", "tp", "fsdp")})
        else:
            specs.update(linear(f"{ffn}.w1", "tp", "fsdp"))
            specs.update(linear(f"{ffn}.w3", "tp", "fsdp"))
            specs.update(linear(f"{ffn}.w2", "fsdp", "tp"))
        return specs

    specs = {"tok_embeddings.weight": ("tp", "fsdp"),
             "norm.scale": (None,)}
    for i in range(config.n_layers):
        specs.update(block(i))
    specs.update(linear("output", "tp", "fsdp"))
    return specs


def next_targets(tokens, sp: Optional[SequenceParallel] = None):
    """(targets [B, n], n): the next token of each of the first n columns
    of ``tokens`` [B, S].  Under sequence parallelism (``sp`` of size > 1,
    ``tokens`` this rank's columns) the target of the last column is the
    next rank's first token, fetched by one exchange over the sp group,
    and the last rank has no target for its last column."""
    if sp is None or sp.size == 1:
        return tokens[:, 1:], tokens.shape[1] - 1
    (first_of_next,) = ring_shift([tokens[:, :1]], sp, shift=-1)
    targets = torch.cat([tokens[:, 1:], first_of_next], dim=1)
    n = tokens.shape[1] - (sp.rank == sp.size - 1)
    return targets[:, :n], n


def next_token_loss(logits, tokens, sp: Optional[SequenceParallel] = None):
    """Shifted cross-entropy: predict tokens[:, 1:] from logits[:, :-1]
    (logits come in ``dtype`` and are cast to f32 here, as in JAX).

    Under sequence parallelism (``sp``: the model's ``SequenceParallel``,
    size > 1; logits and tokens this rank's columns [B, S/sp]) the value
    is this rank's share of the global mean over B x (S - 1): its
    positions' sum over that count (:func:`next_targets` gives their
    targets), so the shares of the sp ranks sum to the JAX loss of the
    global logits (a collective over the sp group)."""
    targets, n = next_targets(tokens, sp)
    logits = logits[:, :n].float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    if sp is None or sp.size == 1:
        return (logz - gold).mean()
    return (logz - gold).sum() / (tokens.shape[0] *
                                  (tokens.shape[1] * sp.size - 1))


# -- cache helpers ---------------------------------------------------------

def init_cache(config: LlamaConfig, batch: int, device,
               max_len: Optional[int] = None, tp: int = 1) -> dict:
    """A zeroed KV cache for ``batch`` rows: paged when
    ``config.page_size > 0`` (block tables all scratch), else dense with
    ``max_len`` positions per row (default ``config.max_seq_len``).
    Under tensor parallelism (``tp`` ranks) it holds this rank's
    kv_heads / tp heads."""
    device = torch.device(device)
    hd, kvh = config.head_dim, config.kv_heads // tp
    layers = {}
    for i in range(config.n_layers):
        if config.page_size > 0:
            nb = config.pool_blocks(batch)
            shape = (nb, config.page_size, kvh, hd)
            int8 = config.kv_cache_dtype == "int8"
            pool_dtype = torch.int8 if int8 else config.dtype
            c = {"pool_key": torch.zeros(shape, dtype=pool_dtype,
                                         device=device),
                 "pool_value": torch.zeros(shape, dtype=pool_dtype,
                                           device=device),
                 "block_table": torch.zeros(
                     (batch, config.blocks_per_row), dtype=torch.int32,
                     device=device)}
            if int8:
                c["pool_key_scale"] = torch.zeros(shape[:3],
                                                  dtype=torch.float32,
                                                  device=device)
                c["pool_value_scale"] = torch.zeros(shape[:3],
                                                    dtype=torch.float32,
                                                    device=device)
        else:
            shape = (batch, max_len or config.max_seq_len, kvh, hd)
            c = {"cached_key": torch.zeros(shape, dtype=config.dtype,
                                           device=device),
                 "cached_value": torch.zeros(shape, dtype=config.dtype,
                                             device=device)}
        c["cache_index"] = torch.zeros((batch,), dtype=torch.int32,
                                       device=device)
        layers[f"layers_{i}"] = {"attention": c}
    return layers


def replace_cache_leaf(cache, name: str, value):
    """Rewrite every per-layer cache leaf called ``name`` to ``value``
    (or value(old) when value is callable); returns a new tree whose
    other leaves are the same tensors."""
    def rec(node):
        if isinstance(node, dict):
            return {k: ((value(v) if callable(value) else value)
                        if k == name else rec(v))
                    for k, v in node.items()}
        return node
    return rec(cache)


def _set_cache_index(cache, lengths):
    """Rewrite every per-layer cache_index leaf to the given [B] vector."""
    return replace_cache_leaf(cache, "cache_index", lengths)


def _set_block_tables(cache, table):
    """Rewrite every per-layer block_table leaf to the given [B, MAXB]
    table (paged layout)."""
    return replace_cache_leaf(cache, "block_table", table)


def canonical_block_table(batch: int, config: LlamaConfig, device=None):
    """Contiguous allocation: row r owns pool blocks
    [1 + r*blocks_per_row, ...) — block 0 stays reserved scratch.  On
    ``device`` (default: the card)."""
    bpr = config.blocks_per_row
    need = 1 + batch * bpr
    if config.pool_blocks(batch) < need:
        raise ValueError(
            f"cache_blocks={config.cache_blocks} < {need} needed for "
            f"batch {batch} at max_seq_len {config.max_seq_len} "
            f"(page_size {config.page_size})")
    return 1 + torch.arange(batch * bpr, dtype=torch.int32,
                            device=resolve_device(device)).reshape(batch, bpr)


# -- sampling --------------------------------------------------------------

def _gumbel(shape, generator, device):
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u))


def _noise(generators, shape, device):
    """Gumbel noise [B, V]: one draw from a single generator, or one row
    per slot generator (None rows get zeros and are never sampled)."""
    if isinstance(generators, torch.Generator):
        return _gumbel(shape, generators, device)
    zeros = torch.zeros(shape[1], device=device)
    return torch.stack([zeros if g is None else _gumbel(shape[1], g, device)
                        for g in generators])


def select_rows(logits, temps, top_ps, generators, top_ks=None):
    """Row-wise token selection shared by every sampling path: logits
    [B, V], temps/top_ps [B] f32, top_ks [B] int (0 = disabled), and
    ``generators`` either one torch.Generator or a list of B per-row
    generators (None for greedy rows; each sampled row draws once from
    its own generator, so a row's stream does not depend on its
    neighbours).  HF order: scale -> top-k -> top-p; rows with
    temperature <= 0 are greedy (argmax in the logits' own dtype, first
    maximum on ties).  Returns tokens [B] (int64)."""
    greedy = logits.argmax(dim=-1)
    if not isinstance(generators, torch.Generator) and all(
            g is None for g in generators):
        return greedy
    scaled = logits.float() / temps.clamp_min(1e-6)[:, None]
    sorted_logits = scaled.sort(dim=-1, descending=True).values
    v = scaled.shape[-1]
    if top_ks is not None:
        # k-th largest as a per-row threshold; k=0 disables.
        k_idx = top_ks.long().clamp(1, v) - 1
        k_thresh = sorted_logits.gather(-1, k_idx[:, None])
        scaled = torch.where((scaled < k_thresh) & (top_ks[:, None] > 0),
                             float("-inf"), scaled)
        keep = torch.where(top_ks > 0, top_ks.long(), v)
        sorted_logits = torch.where(
            torch.arange(v, device=logits.device)[None, :] >= keep[:, None],
            float("-inf"), sorted_logits)
    probs = torch.softmax(sorted_logits, dim=-1)
    cumulative = probs.cumsum(dim=-1)
    cutoff = (cumulative < top_ps[:, None]).sum(-1).clamp(max=v - 1)
    threshold = sorted_logits.gather(-1, cutoff[:, None])
    nucleus = torch.where((scaled < threshold) & (top_ps[:, None] < 1.0),
                          float("-inf"), scaled)
    sampled = (nucleus + _noise(generators, nucleus.shape,
                                logits.device)).argmax(dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled)


def _select_token(logits, temperature: float, top_p: float, generator,
                  top_k: int = 0):
    """Batch-wide selection for generate(): greedy at temperature 0,
    else top-k / nucleus sampling from one generator."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    b = logits.shape[0]
    full = lambda v, dt: torch.full((b,), v, dtype=dt,  # noqa: E731
                                    device=logits.device)
    return select_rows(logits, full(temperature, torch.float32),
                       full(top_p, torch.float32), generator,
                       full(top_k, torch.int32))


def _prefill(model: LlamaModel, prompt, max_new_tokens: int):
    """Fresh cache + prompt forward -> (logits, cache)."""
    cfg = model.config
    b, s = prompt.shape
    if cfg.page_size > 0:
        # Paged: install the canonical contiguous allocation so every
        # row owns its blocks.
        cache = _set_block_tables(
            init_cache(cfg, b, model.device, tp=model.tp.size),
            canonical_block_table(b, cfg, model.device))
    else:
        # Dense: positions past prompt + budget are never written, so
        # the rows are sized to it rather than to max_seq_len.
        cache = init_cache(cfg, b, model.device, max_len=s + max_new_tokens,
                           tp=model.tp.size)
    return model(prompt, cache=cache, decode=True), cache


def _check_budget(model, prompt_len: int, max_new_tokens: int) -> None:
    total = prompt_len + max_new_tokens
    if total > model.config.max_seq_len:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"= {total} exceeds max_seq_len {model.config.max_seq_len}")


def _default_generator(generator, device):
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return generator


@torch.inference_mode()
def generate(model: LlamaModel, prompt_tokens, max_new_tokens: int,
             temperature: float = 0.0, top_p: float = 1.0, generator=None,
             prompt_lengths=None, stop_tokens=(), top_k: int = 0):
    """KV-cache decoding: prefill the prompt, then one token per step.
    temperature=0 is greedy; otherwise top-k / nucleus sampling from
    ``generator`` (a torch.Generator on the model's device; default
    seeded 0).

    prompt_tokens [B, S] may be right-padded; pass prompt_lengths [B]
    and every row decodes from its own position.  stop_tokens end
    decoding once every row has emitted one (a per-step host read, only
    with a non-empty set); positions after a row's first stop token
    repeat it.  Returns [B, steps] int64 on the model's device."""
    device = model.device
    prompt = torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.int32,
                             device=device)
    if max_new_tokens <= 0:
        return torch.zeros((prompt.shape[0], 0), dtype=torch.int64,
                           device=device)
    _check_budget(model, prompt.shape[1], max_new_tokens)
    logits, cache = _prefill(model, prompt, max_new_tokens)
    if prompt_lengths is not None:
        lengths = torch.as_tensor(np.asarray(prompt_lengths),
                                  dtype=torch.int32, device=device)
        cache = _set_cache_index(cache, lengths)
        last = logits[torch.arange(prompt.shape[0], device=device),
                      lengths.long() - 1]
    else:
        last = logits[:, -1]
    if temperature > 0.0:
        generator = _default_generator(generator, device)
    nxt = _select_token(last, temperature, top_p, generator, top_k)

    stop_list = sorted(set(map(int, stop_tokens)))
    out = [nxt]
    done = None
    if stop_list:
        done = np.isin(nxt.cpu().numpy(), stop_list)
    for _ in range(max_new_tokens - 1):
        if done is not None and done.all():
            break
        logits = model(out[-1][:, None].int(), cache=cache, decode=True)
        nxt = _select_token(logits[:, -1], temperature, top_p, generator,
                            top_k)
        out.append(nxt)
        if done is not None:
            done |= np.isin(nxt.cpu().numpy(), stop_list)
    result = torch.stack(out, dim=1)
    if stop_list:
        result = torch.as_tensor(
            fill_after_stop(result.cpu().numpy().copy(), stop_list),
            device=device)
    return result


def fill_after_stop(arr, stop_tokens):
    """Stop-token output convention: for each row of a [B, T] int array,
    positions after the FIRST stop token repeat it (the stop token
    itself stays).  Mutates and returns ``arr``."""
    stop_list = list(stop_tokens)
    for row in range(arr.shape[0]):
        hits = np.nonzero(np.isin(arr[row], stop_list))[0]
        if hits.size:
            arr[row, hits[0] + 1:] = arr[row, hits[0]]
    return arr


def greedy_generate(model: LlamaModel, prompt_tokens, max_new_tokens: int):
    """KV-cache greedy decoding (generate with temperature=0)."""
    return generate(model, prompt_tokens, max_new_tokens, temperature=0.0)


def stream_generate(model: LlamaModel, prompt_tokens, max_new_tokens: int,
                    temperature: float = 0.0, top_p: float = 1.0,
                    generator=None, stop_tokens=(), top_k: int = 0):
    """Token-by-token generator for ONE sequence ([1, S] or [S] prompt):
    yields each id as soon as its step completes (the SSE source of the
    non-batched server path).  A stop token is yielded, then the stream
    ends."""
    device = model.device
    prompt = torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.int32,
                             device=device)
    if prompt.dim() == 1:
        prompt = prompt[None]
    if max_new_tokens <= 0:
        return
    _check_budget(model, prompt.shape[1], max_new_tokens)
    if temperature > 0.0:
        generator = _default_generator(generator, device)
    stop = frozenset(map(int, stop_tokens))
    with torch.inference_mode():
        logits, cache = _prefill(model, prompt, max_new_tokens)
        nxt = _select_token(logits[:, -1], temperature, top_p, generator,
                            top_k)
    for step in range(max_new_tokens):
        if step:
            with torch.inference_mode():
                logits = model(nxt[:, None].int(), cache=cache, decode=True)
                nxt = _select_token(logits[:, -1], temperature, top_p,
                                    generator, top_k)
        tok = int(nxt[0])
        yield tok
        if tok in stop:
            return
