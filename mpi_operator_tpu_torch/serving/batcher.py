"""Continuous batching for the KV-cache decode path.

Counterpart of ``mpi_operator_tpu/serving/batcher.py``.  The batcher
keeps B persistent cache slots and runs ONE decode step per tick across
every slot; new requests are prefilled into free slots between ticks and
finished slots are freed at once (iteration-level scheduling, per-slot
greedy or top-k/nucleus sampling).  Each slot decodes at its own cache
index, so mixed-length, mixed-arrival sequences share one batch.

With ``page_size > 0`` the KV cache is paged: K/V live in a shared pool
of fixed-size blocks and each slot holds a block-table row.  A slot's
block budget (prompt + max_new_tokens) is reserved at admission and
returned at retirement, so a pool below the worst case oversubscribes
and admission waits for blocks when it runs dry.  Each decode step
attends through the hand-written paged attention kernel once per layer.
Prefill runs on the dense batch-1 layout at the prompt's exact length
and is scattered into the slot's blocks.

Paged mode also prefix-caches (``prefix_cache=True``): full prompt
blocks are content-addressed by their token prefix, so a prompt that
starts with a cached prefix maps the existing blocks (refcounted,
evicted LRU at refcount 0 under pool pressure) and prefills only its
suffix, through the paged multi-token branch of a batch-1 view of the
cache.

The steady-state tick is **pipelined** (``pipelined=True``, the
default): step k+1 is launched from step k's still-on-device token
tensor before step k's tokens are read, so the card computes step k+1
while the host runs emission, stop checks, retirement and admission for
step k.  Step k's tokens come to the host in ONE copy, on a side stream
that waits only for step k, so the read never waits for step k+1.  A
slot that retired or was replaced between launch and read has its
overrun token discarded, so emitted streams equal the serialized loop's.
Ticks, dispatches and transfers are counted in the ``serving_*``
metrics, and ``transfers_total == ticks_total`` holds.

Speculative decoding (``draft_model`` or ``draft_strategy=
"prompt_lookup"``): when every active slot is greedy, a tick is a
speculation round: ``draft_len`` proposals per slot (from the draft
model's own per-slot dense cache, or by n-gram lookup over the slot's
own stream), ONE width-(draft_len+1) target verify across all slots,
longest-prefix acceptance plus the bonus token, and a per-row
``cache_index`` rollback over rejected positions.  A sampling slot
forces plain ticks (acceptance is argmax-only).  A speculative batcher
keeps the serialized loop: acceptance needs every committed token on
the host before the next round.  The verify and the draft both run the
dense or multi-token paths, never the paged decode kernel.

Chunked prefill (``prefill_chunk > 0``, paged only): a prompt (or its
uncached suffix) runs through batch-1 paged forwards of at most
``prefill_chunk`` tokens that write the slot's blocks in place, so the
peak activation memory of an admission is that of one chunk.

Disaggregated serving (serving/kv_transfer.py): ``export_kv_pages``
copies registered prompt pages out of the pool to the host, and
``import_kv_pages`` installs pages another replica exported, verified
against their chain digests, as cached blocks.  A request that carries
a causal-trace context emits its ``serve_queue_wait`` and ``prefill``
spans at its first token, and a fatal scheduler error leaves a
``batcher-fatal`` flight bundle behind.

Serving across cards (``mirror``: a ``serving/mirror.TickMirror`` over
every rank of the serving mesh, fsdp x tp; the model this rank's shard):
every rank runs this batcher over its shard of the model and of the KV
pool (KV heads are cut over tp only: the fsdp ranks of a tp rank hold the
same pool), and each scheduler turn starts with one exchange of host
records: the leader's (mesh rank 0's) queue drained into the turn's
admissions, its cancellations and stop, every rank's health.  Every
branch of the loop then reads only agreed state (``_cancelled``, the
admission queue of the turn), so every rank runs the same prefills,
installs, retirements and decode steps, and so the same tp all-reduces
and fsdp gathers.  A group of two or more ranks always has a mirror.
The followers take no requests of their own; a slot-local admission
error is fatal in a group (it may have happened on one rank only).

KV pages under tp carry every head, in the JAX wire's layout (the JAX
batcher exports its pool's global arrays): rank r's pool holds the
contiguous KV-head chunk [r*kvh/tp, (r+1)*kvh/tp) (``TensorParallel.
chunk``), the heads axis is dim 1 of a page leaf, and an export or an
import is one lock-step operation.  Rank 0 queues it for the scheduler
thread (an HTTP thread never runs a collective), the turn's record
carries its headers (digests, parents, tokens, leaf shapes; never leaf
bytes), and every rank runs it before the turn's admissions: the same
lookups and verdicts from the same state, held to rank 0's
(``TickMirror.agree``), then the bytes move over the tp group's device
communicator.  An export gathers each rank's rows of a wave to rank 0,
which joins them on the heads axis; an import scatters each rank's head
chunk of a wave from rank 0, which alone holds the decoded pages
((tp-1)/tp of a wave's bytes leave it).  A failure there is fatal to the
batcher and, through the mirror, to the group.  Page operations at
fsdp > 1 raise NotImplementedError (ROADMAP.md queue 1 item 3.5: the
disaggregated roles at fsdp > 1).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.llama import (_set_block_tables, _set_cache_index, init_cache,
                            quantize_kv, select_rows)
from ..telemetry import flight
from ..telemetry.metrics import Registry, new_serving_metrics
from ..telemetry.trace import default_tracer
from .drafts import DRAFT_STRATEGIES, propose_prompt_lookup

log = logging.getLogger(__name__)

# KV export and import move pages in waves.  An export wave (on a
# prefill replica, where nothing competes for the card) gathers up to
# one push batch of pages (MAX_PAGES_PER_PUSH in serving/kv_transfer.py)
# in one index_select per pool leaf and one device-to-host copy.  Import
# waves land on DECODE replicas with live streams, so they are narrow:
# the device lock is released between waves and decode steps interleave,
# bounding a decode stall to one narrow scatter.  Unlike the JAX
# package, waves are not padded to these widths: that padding only
# bounds XLA recompiles.
_EXPORT_WAVE_WIDTH = 64
_IMPORT_WAVE_WIDTH = 8
# Under tp an export waits for the next scheduler turn, which may hold a
# long admission prefill.
_TP_EXPORT_TIMEOUT_S = 120.0


def _page_digest(parent_hex: str, page) -> str:
    """Content digest of one prompt page CHAINED through its parent's
    digest, so a digest identifies the whole token prefix up to and
    including this page (byte-identical to the JAX package's)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(parent_hex.encode())
    h.update(",".join(str(int(t)) for t in page).encode())
    return h.hexdigest()


def prefix_page_digests(tokens, page_size: int) -> List[str]:
    """Chain digests of a prompt's full pages eligible for prefix-cache
    reuse (at least one token is always left to prefill, the same cap as
    ContinuousBatcher._match_prefix).  Digest j covers tokens
    [0, (j+1)*page_size)."""
    if page_size <= 0:
        raise ValueError(
            f"prefix_page_digests requires a paged KV cache "
            f"(page_size > 0), got page_size={page_size}")
    out: List[str] = []
    parent = ""
    for j in range((len(tokens) - 1) // page_size):
        parent = _page_digest(parent,
                              tokens[j * page_size:(j + 1) * page_size])
        out.append(parent)
    return out


def _page_header(page: dict) -> dict:
    """What every rank of a tp group needs of a transferred page to stage
    it: its digest, parent, tokens and leaf shapes (no leaf bytes)."""
    return {"digest": str(page.get("digest", "")),
            "parent": str(page.get("parent", "")),
            "tokens": [int(t) for t in page.get("tokens", ())],
            "shapes": {str(path): tuple(int(n) for n in np.shape(leaf))
                       for path, leaf in page.get("leaves", {}).items()}}


def _flat_bytes(tensors) -> torch.Tensor:
    """The tensors' bytes one after another, as one flat uint8 tensor."""
    return torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])


def _unflat_bytes(flat: torch.Tensor, like) -> List[torch.Tensor]:
    """Views of ``flat`` (``_flat_bytes`` of tensors shaped and typed as
    ``like``) with each one's shape and dtype."""
    out, pos = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(flat[pos:pos + n].view(t.dtype).view(t.shape))
        pos += n
    return out


class _WaitQueue:
    """FIFO of requests with a *non-dequeuing* idle wait: the scheduler
    blocks on the condition without taking the head, so submission
    order is admission order."""

    def __init__(self):
        self._items: deque = deque()
        self._cond = threading.Condition()

    def put(self, item) -> None:
        with self._cond:
            self._items.append(item)
            self._cond.notify_all()

    def get_nowait(self):
        with self._cond:
            if not self._items:
                raise queue.Empty
            return self._items.popleft()

    def qsize(self) -> int:
        with self._cond:
            return len(self._items)

    def wait_nonempty(self, timeout: float) -> bool:
        """Block until an item is present (without removing it) or the
        timeout elapses; returns whether the queue is non-empty."""
        with self._cond:
            if not self._items:
                self._cond.wait(timeout)
            return bool(self._items)

    def poke(self) -> None:
        """Wake an idle ``wait_nonempty`` without enqueuing anything, so
        out-of-band scheduler work (KV-page imports) runs at once."""
        with self._cond:
            self._cond.notify_all()


@dataclass
class _Request:
    tokens: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int = 0
    stop_tokens: frozenset = frozenset()
    done: threading.Event = field(default_factory=threading.Event)
    output: List[int] = field(default_factory=list)
    error: Optional[Exception] = None
    on_token: Optional[object] = None  # callable(int), streaming hook
    cancelled: threading.Event = field(default_factory=threading.Event)
    # Telemetry: set at enqueue; emit() attributes TTFT and inter-token
    # latency to the serving histograms.
    metrics: Optional[dict] = None
    submitted_at: float = 0.0
    _last_emit: float = 0.0
    was_deferred: bool = False
    # Causal tracing: the carried context, the wall-clock submit time and
    # the perf_counter admission mark, so the first token emits the
    # replica-side queue-wait and prefill spans retroactively.
    trace_ctx: Optional[object] = None
    submitted_wall: float = 0.0
    admitted_at: float = 0.0
    # Tensor-parallel serving: rank 0's id of the request and the agreed
    # cancellation, the one every rank's loop reads.
    rid: int = -1
    cancel_agreed: bool = False

    def emit(self, token: int) -> None:
        if self.metrics is not None:
            now = time.perf_counter()
            if not self.output and self.submitted_at:
                self.metrics["ttft_seconds"].observe(
                    now - self.submitted_at)
                if self.trace_ctx is not None:
                    self._trace_first_token(now)
            elif self.output and self._last_emit:
                self.metrics["token_latency_seconds"].observe(
                    now - self._last_emit)
            self._last_emit = now
        self.output.append(token)
        if self.on_token is not None:
            self.on_token(token)

    def _trace_first_token(self, now: float) -> None:
        """Replica-side spans of the request's causal trace, emitted once
        at the first token: submit -> admission (``serve_queue_wait``)
        and admission -> first token (``prefill``), both parented to the
        carried context."""
        admitted = self.admitted_at or self.submitted_at
        queue_wait = max(0.0, admitted - self.submitted_at)
        tracer = default_tracer()
        tracer.emit("serve_queue_wait", ts=self.submitted_wall,
                    dur=queue_wait, ctx=self.trace_ctx,
                    deferred=self.was_deferred)
        tracer.emit("prefill", ts=self.submitted_wall + queue_wait,
                    dur=max(0.0, now - admitted), ctx=self.trace_ctx,
                    prompt_tokens=len(self.tokens))

    @property
    def finished(self) -> bool:
        """Budget exhausted or a stop token emitted (the stop token
        itself is included in the output)."""
        return (len(self.output) >= self.max_new_tokens
                or (bool(self.stop_tokens)
                    and self.output
                    and self.output[-1] in self.stop_tokens))


def _slot_seed(seed: int, prompt_len: int) -> int:
    """Per-request generator seed from (seed, prompt length), the role
    of the JAX batcher's fold_in(PRNGKey(seed), len(tokens))."""
    return (int(seed) * 0x9E3779B97F4A7C15 + prompt_len) % (1 << 63)


def _fsdp_size(model) -> int:
    """The fsdp ranks a serving model's weights are cut over (1 unless
    ``model.fsdp_serve``)."""
    fs = getattr(model, "fsdp_serve", None)
    return 1 if fs is None else fs.par.size


class ContinuousBatcher:
    """Continuous-batching scheduler over ``model``'s decode path; each
    slot carries its own (temperature, top_p, top_k, generator) so
    greedy and sampling requests share decode ticks."""

    def __init__(self, model, max_slots: int = 4,
                 device_lock: Optional[threading.Lock] = None,
                 page_size: int = 0, cache_blocks: int = 0,
                 prefix_cache: bool = True, kv_cache_dtype: str = "auto",
                 draft_model=None, draft_strategy: Optional[str] = None,
                 draft_len: int = 4, prompt_lookup_ngram: int = 3,
                 prefill_chunk: int = 0, pipelined: bool = True,
                 telemetry_registry: Optional[Registry] = None,
                 device=None, mirror=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, batcher on "
                             f"{self.device}")
        cfg = model.config
        self._mirror = mirror
        self._tp = model.tp.size
        self._fsdp = _fsdp_size(model)
        if self._tp * self._fsdp > 1 and mirror is None:
            raise ValueError("a model served over several cards needs the "
                             "tick mirror of its group "
                             "(InferenceServer(mesh=))")
        if draft_model is not None and (
                draft_model.tp.size, _fsdp_size(draft_model)) != (
                    self._tp, self._fsdp):
            raise ValueError(f"draft model holds tp={draft_model.tp.size}, "
                             f"fsdp={_fsdp_size(draft_model)} shards, the "
                             f"target tp={self._tp}, fsdp={self._fsdp}")
        # Tensor-parallel serving: requests agreed for admission, and
        # every agreed request not finished yet, by id.
        self._admit: deque = deque()
        self._live: dict = {}
        self._next_rid = 0
        if cfg.page_size > 0:
            # Prefill runs on the dense layout and the batcher derives the
            # paged layout itself: pass page_size= to this constructor.
            raise ValueError(
                "ContinuousBatcher requires a dense-layout model "
                "(config.page_size == 0); use the page_size argument "
                "to enable the paged cache")
        self._prefill_chunk = int(prefill_chunk)
        if self._prefill_chunk > 0 and page_size <= 0:
            raise ValueError(
                "prefill_chunk requires the paged cache (page_size > 0); "
                "the dense layout prefills whole prompts")
        if kv_cache_dtype != "auto" and page_size <= 0:
            raise ValueError(
                f"kv_cache_dtype={kv_cache_dtype!r} requires the paged "
                f"cache (page_size > 0)")
        self.model = model
        self.max_slots = max_slots
        self.telemetry = new_serving_metrics(telemetry_registry
                                             or Registry())
        self.pipelined = bool(pipelined)
        # Tick accounting, written only by the scheduler thread (the
        # source of the serving_pipeline_depth gauge).
        self.ticks_dispatched = 0
        self.ticks_fetched = 0
        self._queue = _WaitQueue()
        self._stop = threading.Event()
        # Set when the scheduler loop dies unrecoverably; every later
        # submit fails loudly, naming the tick phase that died.
        self.fatal_error: Optional[BaseException] = None
        self._fatal_phase: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        # Shared with the server's non-batched path so at most one model
        # computation is launched at a time; taken per tick / prefill.
        self._device_lock = device_lock or threading.Lock()
        self._max_seq_len = cfg.max_seq_len
        self.page_size = page_size
        if page_size > 0:
            decode_cfg = dataclasses.replace(
                cfg, page_size=page_size, cache_blocks=cache_blocks,
                kv_cache_dtype=kv_cache_dtype)
            nb = decode_cfg.pool_blocks(max_slots)
            self._free_blocks = list(range(1, nb))  # 0 = reserved scratch
            self._total_blocks = nb - 1
            self._slot_blocks: dict = {}
            self._slot_shared: dict = {}   # slot -> shared-prefix blocks
            self._blocks_per_row = decode_cfg.blocks_per_row
            # Prefix cache: (parent block, page tokens) -> pool block;
            # _block_meta refcounts registered blocks (refs = live slots
            # mapping the block; refs-0 blocks stay cached until evicted).
            self._prefix_cache = bool(prefix_cache)
            self._registry: dict = {}
            self._block_meta: dict = {}
            # block id -> chain digest (prefix_page_digests form), the
            # hit index advertised at /fleet-state.
            self._block_digest: dict = {}
            self._prefix_clock = 0
            self._retire_count = 0
            self.prefix_stats = {"lookups": 0, "hit_blocks": 0,
                                 "hit_tokens": 0, "evicted": 0}
            # Transferred KV pages wait here until the scheduler thread
            # installs them: all pool and registry mutation stays on that
            # thread, as admission's does.  Under tp exports wait here
            # too, and rank 0 moves both into the turn's record:
            # (kind, payload, result, done) each.
            self._kv_imports: deque = deque()
            self._kv_imports_lock = threading.Lock()
            # Tensor parallel: the agreed page operations (headers) of the
            # turn, and rank 0's own (payload, result, done) of each, in
            # the same order.
            self._page_ops: deque = deque()
            self._page_payload: deque = deque()
        else:
            decode_cfg = cfg
        with torch.inference_mode():
            cache = init_cache(decode_cfg, max_slots, self.device,
                               tp=self._tp)
            if page_size > 0:
                # One block table shared by every layer, edited in place
                # (the model only reads it).
                self._table = torch.zeros(
                    (max_slots, self._blocks_per_row), dtype=torch.int32,
                    device=self.device)
                cache = _set_block_tables(cache, self._table)
        self._cache = cache

        # Speculative decoding (greedy slots only), from a draft model or
        # a training-free strategy; the same verify and acceptance serve
        # both.
        self.draft_len = int(draft_len)
        self._draft_model = draft_model
        self._draft_strategy = draft_strategy
        self._pl_ngram = int(prompt_lookup_ngram)
        if draft_strategy is not None:
            if draft_strategy not in DRAFT_STRATEGIES:
                raise ValueError(f"unknown draft_strategy "
                                 f"{draft_strategy!r}; one of "
                                 f"{DRAFT_STRATEGIES}")
            if draft_model is not None:
                raise ValueError(
                    "draft_strategy and draft_model are exclusive")
        if draft_model is not None:
            dcfg = draft_model.config
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft/target vocab_size mismatch")
            if dcfg.page_size > 0:
                raise ValueError("draft model must be dense-layout")
            if dcfg.max_seq_len < cfg.max_seq_len:
                raise ValueError(
                    f"draft max_seq_len {dcfg.max_seq_len} < target "
                    f"{cfg.max_seq_len}: verify rounds write past it")
            if draft_model.device != self.device:
                raise ValueError(f"draft model is on {draft_model.device}, "
                                 f"batcher on {self.device}")
            # The draft's own per-slot dense cache (the target itself may
            # be the draft: same tensors, this second cache).
            with torch.inference_mode():
                self._draft_cache = init_cache(dcfg, max_slots, self.device,
                                               tp=self._tp)
            # slot -> highest committed position whose K/V the draft cache
            # holds; a slot that advanced through plain ticks past it is
            # re-prefilled when speculation resumes.
            self._draft_pos: dict = {}
        self._speculative = draft_model is not None or \
            draft_strategy is not None
        if self._speculative and self.draft_len < 1:
            raise ValueError("draft_len must be >= 1")
        self.spec_stats = {"spec_ticks": 0, "plain_ticks": 0,
                           "accepted_drafts": 0, "drafted": 0}
        if self._speculative:
            # Acceptance needs every committed token on the host before
            # the next round, so a speculative batcher never launches
            # ahead (plain-tick interludes stay serialized too).
            self.pipelined = False
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
            self._host_tokens = torch.empty((max_slots,), dtype=torch.int32,
                                            pin_memory=True)

    # -- device plumbing ---------------------------------------------------
    def _tensor(self, values, dtype):
        return torch.as_tensor(np.asarray(values), dtype=dtype,
                               device=self.device)

    def decode_step(self, tokens, temps, top_ps, gens, top_ks):
        """One decode step across every slot (the step each tick
        launches): tokens [max_slots] in, next tokens [max_slots] out,
        left on the device."""
        logits = self.model(tokens[:, None], cache=self._cache, decode=True)
        return select_rows(logits[:, -1], temps, top_ps, gens,
                           top_ks).to(torch.int32)

    def _fetch(self, out, done) -> np.ndarray:
        """One device->host copy of a step's [max_slots] tokens.  On the
        card it runs on a side stream that waits for that step only (the
        next step, already launched, keeps the card busy)."""
        if done is None:
            return out.numpy()
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(done)
            self._host_tokens.copy_(out, non_blocking=True)
        self._copy_stream.synchronize()
        return self._host_tokens.numpy().copy()

    def _cache_index(self):
        return self._cache["layers_0"]["attention"]["cache_index"]

    def _set_slot_index(self, slot: int, length: int) -> None:
        """Every layer's cache_index holds the same values, so one
        updated vector is shared by all layers (the model rebinds, never
        mutates, that leaf)."""
        idx = self._cache_index().clone()
        idx[slot] = length
        self._cache = _set_cache_index(self._cache, idx)

    def _prefill(self, tokens: List[int], sample_args):
        """Dense batch-1 prefill at the prompt's exact length ->
        (row cache, first token [1])."""
        prompt = self._tensor([tokens], torch.int32)
        row_cache = init_cache(self.model.config, 1, self.device,
                               max_len=len(tokens), tp=self._tp)
        logits = self.model(prompt, cache=row_cache, decode=True)
        temp, top_p, gen, top_k = sample_args
        return row_cache, select_rows(logits[:, -1], temp, top_p, [gen],
                                      top_k)

    @staticmethod
    def _copy_dense_row(cache, slot: int, row_cache) -> None:
        """Copy a batch-1 dense prefill cache into row ``slot`` of a dense
        per-slot cache (the target's dense layout and the draft's)."""
        for name, node in cache.items():
            dst = node["attention"]
            src = row_cache[name]["attention"]
            n = src["cached_key"].shape[1]
            dst["cached_key"][slot, :n] = src["cached_key"][0]
            dst["cached_value"][slot, :n] = src["cached_value"][0]

    def _install(self, slot: int, row_cache, length: int) -> None:
        """Copy a batch-1 prefill cache into persistent slot ``slot``."""
        if self.page_size > 0:
            self._install_paged(slot, row_cache)
        else:
            self._copy_dense_row(self._cache, slot, row_cache)
        self._set_slot_index(slot, length)

    # -- paged-pool plumbing -----------------------------------------------
    def _blocks_needed(self, total_tokens: int) -> int:
        return -(-total_tokens // self.page_size)

    def _chain_key(self, parent: Optional[int], tokens: List[int], j: int):
        """Content key of prompt block j: (parent pool block id, that
        page's tokens); leaf-first eviction keeps stale parent ids from
        ever matching."""
        page = self.page_size
        return (parent, tuple(tokens[j * page:(j + 1) * page]))

    def _match_prefix(self, tokens: List[int]) -> List[int]:
        """Longest chain of cached full prompt blocks, capped so at
        least one prompt token is left to prefill."""
        if not self._prefix_cache:
            return []
        hits: List[int] = []
        parent: Optional[int] = None
        max_full = (len(tokens) - 1) // self.page_size
        self.prefix_stats["lookups"] += 1
        self.telemetry["prefix_lookups"].inc()
        for j in range(max_full):
            blk = self._registry.get(self._chain_key(parent, tokens, j))
            if blk is None:
                break
            hits.append(blk)
            parent = blk
        return hits

    def _alloc_blocks(self, slot: int, total_tokens: int,
                      tokens: Optional[List[int]] = None) -> bool:
        """Reserve the slot's block budget or decline.  Cached prefix
        blocks satisfy the head of the budget; refcount-0 cached blocks
        are evicted LRU to make room before declining."""
        shared = self._match_prefix(tokens) if tokens else []
        need = self._blocks_needed(total_tokens) - len(shared)
        shared_set = set(shared)
        if need > len(self._free_blocks) + sum(
                1 for b, m in self._block_meta.items()
                if m["refs"] == 0 and b not in shared_set):
            # Infeasible even after full eviction: decline without
            # evicting, so the reusable prefix cache survives.
            return False
        while len(self._free_blocks) < need:
            if not self._evict_one(shared_set):
                return False
        self._prefix_clock += 1
        for blk in shared:
            meta = self._block_meta[blk]
            meta["refs"] += 1
            meta["last"] = self._prefix_clock
        self.prefix_stats["hit_blocks"] += len(shared)
        self.prefix_stats["hit_tokens"] += len(shared) * self.page_size
        if shared:
            self.telemetry["prefix_hit_blocks"].inc(len(shared))
            self.telemetry["prefix_hit_tokens"].inc(
                len(shared) * self.page_size)
        priv = [self._free_blocks.pop() for _ in range(need)]
        self._slot_blocks[slot] = shared + priv
        self._slot_shared[slot] = len(shared)
        return True

    def _evict_one(self, protect: set) -> bool:
        """Evict ONE cached block back to the free list (leaf-first LRU:
        no slot references it and no registered child chains through
        it).  Scheduler thread only."""
        victim = min(
            (b for b, m in self._block_meta.items()
             if m["refs"] == 0 and not m["children"]
             and b not in protect),
            key=lambda b: self._block_meta[b]["last"], default=None)
        if victim is None:
            return False
        meta = self._block_meta.pop(victim)
        del self._registry[meta["key"]]
        self._block_digest.pop(victim, None)
        if meta["parent"] is not None:
            parent_meta = self._block_meta.get(meta["parent"])
            if parent_meta is not None:
                parent_meta["children"].discard(victim)
        self._free_blocks.append(victim)
        self.prefix_stats["evicted"] += 1
        self.telemetry["prefix_evicted"].inc()
        return True

    def _register_blocks(self, slot: int, tokens: List[int]) -> None:
        """Content-address this slot's full prompt blocks for future
        prefix hits (the slot itself holds one reference on each)."""
        if not self._prefix_cache:
            return
        blocks = self._slot_blocks[slot]
        parent = (blocks[self._slot_shared[slot] - 1]
                  if self._slot_shared[slot] else None)
        for j in range(self._slot_shared[slot],
                       len(tokens) // self.page_size):
            key = self._chain_key(parent, tokens, j)
            existing = self._registry.get(key)
            if existing is not None:
                # Concurrent duplicate: keep the first, chain onward
                # through it.
                parent = existing
                continue
            blk = blocks[j]
            self._registry[key] = blk
            self._block_meta[blk] = {"key": key, "refs": 1,
                                     "last": self._prefix_clock,
                                     "parent": parent, "children": set()}
            self._block_digest[blk] = _page_digest(
                "" if parent is None
                else self._block_digest.get(parent, ""),
                tokens[j * self.page_size:(j + 1) * self.page_size])
            if parent is not None and parent in self._block_meta:
                self._block_meta[parent]["children"].add(blk)
            parent = blk

    def prefix_digest(self) -> List[str]:
        """The replica's advertised prefix-cache hit index: the chain
        digests of every registered prompt block.  Read from HTTP
        threads while the scheduler mutates the dict — retry the
        snapshot on a concurrent resize."""
        if self.page_size <= 0 or not self._prefix_cache:
            return []
        for _ in range(8):
            try:
                return sorted(self._block_digest.values())
            except RuntimeError:
                continue
        return []

    def free_blocks(self) -> int:
        """Pool blocks not reserved by any live slot (cached refcount-0
        blocks count as free).  Read from HTTP threads without a lock; a
        momentarily stale value only skews routing."""
        if self.page_size <= 0:
            return 0
        for _ in range(8):
            try:
                cached = sum(1 for m in self._block_meta.values()
                             if m["refs"] == 0)
                return len(self._free_blocks) + cached
            except RuntimeError:
                continue
        return len(self._free_blocks)

    # -- KV-page transfer (disaggregated serving) ---------------------------
    def _pool_leaves(self) -> List[tuple]:
        """(wire path, tensor) of every pool_* leaf, in cache order; the
        paths are the JAX cache tree's (``layers_<i>/attention/pool_key``
        and ``pool_value``, plus ``*_scale`` for int8 pools)."""
        return [(f"{name}/attention/{leaf}", tensor)
                for name, node in self._cache.items()
                for leaf, tensor in node["attention"].items()
                if leaf.startswith("pool_")]

    def _wave_leaves(self) -> List[tuple]:
        """``_pool_leaves`` with wider elements first, so every leaf's
        bytes start aligned to its element size inside the one flat
        buffer a wave moves in."""
        return sorted(self._pool_leaves(),
                      key=lambda pl: -pl[1].element_size())

    def _wire_shapes(self) -> dict:
        """Wire path -> the shape of that leaf in a page: the pool
        leaf's per-block shape with every KV head (this rank's head
        count times tp on dim 1, the heads axis)."""
        out = {}
        for path, leaf in self._pool_leaves():
            shape = list(leaf.shape[1:])
            shape[1] *= self._tp
            out[path] = tuple(shape)
        return out

    def _export_entries(self, digests: List[str]) -> List[tuple]:
        """(digest, block, parent digest, tokens) of each requested chain
        digest this replica has registered, in the order asked."""
        by_digest: dict = {}
        for _ in range(8):
            try:
                by_digest = {d: b
                             for b, d in list(self._block_digest.items())}
                break
            except RuntimeError:
                continue
        entries: List[tuple] = []
        for digest in digests:
            blk = by_digest.get(digest)
            meta = self._block_meta.get(blk) if blk is not None else None
            if meta is None:
                continue
            parent_blk = meta["parent"]
            parent = ("" if parent_blk is None
                      else self._block_digest.get(parent_blk, ""))
            entries.append((digest, blk, parent,
                            [int(t) for t in meta["key"][1]]))
        return entries

    def export_kv_pages(self, digests: List[str]) -> List[dict]:
        """Snapshot the requested prefix-cache pages for transfer to a
        decode replica: for each chain digest this replica has
        registered, the page's tokens, its parent digest and its raw pool
        K/V leaves as host tensors, every KV head in each.

        Safe from HTTP threads while the scheduler ticks.  Each wave of
        blocks is gathered with one ``index_select`` per leaf under the
        device lock, on the stream the scheduler writes the pool on, and
        copied to the host in ONE copy.  A block that was evicted and
        reused before the gather changes or loses its digest before the
        copy returns, so each block's digest is checked again after the
        copy and a changed one is dropped (best-effort protocol: a
        missing page just means the importer prefills that span).  Under
        tp (rank 0 only) the export is a lock-step operation of the
        scheduler threads: this call queues it and waits."""
        if self.page_size <= 0:
            raise ValueError(
                "export_kv_pages requires the paged KV cache "
                "(page_size > 0)")
        self._refuse_pages_over_fsdp("export")
        if self._mirror is None:
            return self._export_waves(self._export_entries(digests))
        result: dict = {"pages": None}
        self._request_page_op("export", [str(d) for d in digests], result,
                              _TP_EXPORT_TIMEOUT_S)
        if result["pages"] is None:
            raise self._shutdown_error()
        return result["pages"]

    def _export_waves(self, entries: List[tuple]) -> Optional[List[dict]]:
        """The entries' pages, wave by wave: each rank gathers its rows
        of a wave (one ``index_select`` a leaf, one flat buffer); under
        tp the buffers are gathered to rank 0, which joins them on the
        heads axis.  None on the other ranks of a tp group."""
        tp = self.model.tp
        leaves = self._wave_leaves()
        pages: List[dict] = []
        for off in range(0, len(entries), _EXPORT_WAVE_WIDTH):
            wave = entries[off:off + _EXPORT_WAVE_WIDTH]
            with torch.inference_mode():
                idx = self._tensor([e[1] for e in wave], torch.long)
                with self._device_lock:
                    rows = [leaf.index_select(0, idx) for _, leaf in leaves]
                    parts = tp.gather_to_first(_flat_bytes(rows))
                    if parts is None:
                        continue
                    if len(parts) > 1:
                        rows = [torch.cat(chunks, dim=2) for chunks in
                                zip(*(_unflat_bytes(p, rows)
                                      for p in parts))]
                    flat = _flat_bytes(rows) if len(parts) > 1 else parts[0]
                host = flat.cpu()
            split = dict(zip((path for path, _ in leaves),
                             _unflat_bytes(host, rows)))
            for i, (digest, blk, parent, tokens) in enumerate(wave):
                if self._block_digest.get(blk) != digest:
                    continue  # evicted and reused mid-gather: drop
                pages.append({"digest": digest, "parent": parent,
                              "tokens": tokens,
                              "leaves": {path: split[path][i]
                                         for path, _ in leaves}})
                self.telemetry["kv_pages_exported"].inc()
        return pages if tp.rank == 0 else None

    def import_kv_pages(self, pages: List[dict],
                        timeout: float = 30.0) -> dict:
        """Install transferred KV pages into this replica's pool and
        prefix registry (decode-replica side).  Called from HTTP threads:
        the pages are queued for the scheduler thread, the only thread
        that mutates the pool, which is woken at once; this call blocks
        until that import completes.  Under tp (rank 0 only) every rank
        installs its heads of them in lock-step.  Returns per-page
        accounting ``{"imported", "deduped", "rejected"}``."""
        if self.page_size <= 0:
            raise ValueError(
                "import_kv_pages requires the paged KV cache "
                "(page_size > 0)")
        self._refuse_pages_over_fsdp("import")
        staged = [(_page_header(page), page.get("leaves", {}))
                  for page in pages]
        result = {"imported": 0, "deduped": 0, "rejected": 0}
        self._request_page_op("import", staged, result, timeout)
        return result

    def _refuse_pages_over_fsdp(self, kind: str) -> None:
        if self._fsdp > 1:
            raise NotImplementedError(
                f"KV-page {kind} at fsdp={self._fsdp} is not ported yet: "
                f"ROADMAP.md queue 1 item 3.5 (the disaggregated roles at "
                f"fsdp > 1)")

    def _request_page_op(self, kind: str, payload, result: dict,
                         timeout: float) -> None:
        """Queue a page operation for the scheduler thread, wake it and
        wait until it ran (under tp: until rank 0 put it in a turn's
        record and every rank ran it)."""
        if self._mirror is not None and not self._mirror.leader:
            raise RuntimeError(
                f"serving rank {self._mirror.rank} runs no "
                f"KV-page {kind} of its own: rank 0 of the group queues "
                f"them")
        if self._stop.is_set():
            raise self._shutdown_error()
        done = threading.Event()
        with self._kv_imports_lock:
            self._kv_imports.append((kind, payload, result, done))
        self._queue.poke()
        if not done.wait(timeout):
            raise TimeoutError(f"KV-page {kind} timed out")
        if self._stop.is_set() and self.fatal_error is not None:
            raise self._shutdown_error()

    def _drain_kv_imports(self) -> None:
        """Scheduler thread: run every queued page operation (under tp:
        the turn's agreed ones, ``_run_page_ops``).  Imports arrive
        parent-first; each page is digest-verified and registered like a
        locally prefilled block at refcount 0 (a retired prompt's
        blocks), then the staged blocks' data lands in place, one
        ``index_copy_`` per pool leaf per wave.  Staged blocks are
        unreadable until then: prefix matching runs on this thread,
        after this method returns.  A page whose parent is missing or
        whose digest or shape does not verify is rejected (its
        descendants are too), and pool exhaustion rejects rather than
        taking blocks from live slots.  A failure inside the scatter
        leaves the pool half-written, so it is fatal to the batcher."""
        if self._mirror is not None:
            self._run_page_ops()
            return
        while True:
            with self._kv_imports_lock:
                if not self._kv_imports:
                    return
                _, staged, result, done = self._kv_imports.popleft()
            try:
                self._import_pages([h for h, _ in staged],
                                   [lv for _, lv in staged], result)
            except Exception as exc:
                self._tick_fatal(exc, "kv-import")
                return
            finally:
                done.set()

    def _page_ops_to_record(self) -> List[dict]:
        """Rank 0: move the queued page operations into the turn's record
        as headers, each with its op id (the turn and its place there;
        the leaves stay here, in record order).  An import's leaf shapes
        travel as a table of the distinct shape sets, each page naming
        its entry."""
        with self._kv_imports_lock:
            queued = list(self._kv_imports)
            self._kv_imports.clear()
        heads = []
        for i, (kind, payload, result, done) in enumerate(queued):
            self._page_payload.append((payload, result, done))
            op = [self._mirror.turns, i]
            if kind == "export":
                heads.append({"op": op, "kind": kind, "digests": payload})
                continue
            table: List[dict] = []
            rows = []
            for header, _ in payload:
                shapes = header["shapes"]
                if shapes not in table:
                    table.append(shapes)
                rows.append((header["digest"], header["parent"],
                             header["tokens"], table.index(shapes)))
            heads.append({"op": op, "kind": kind, "shapes": table,
                          "pages": rows})
        return heads

    def _run_page_ops(self) -> None:
        """Every rank of a tp group: run the turn's agreed page
        operations in order.  Rank 0 holds each one's leaves (an import)
        and its waiter; a failure is fatal ("kv-import", "kv-export")."""
        while self._page_ops:
            head = self._page_ops.popleft()
            payload, result, done = (self._page_payload.popleft()
                                     if self._mirror.leader
                                     else (None, None, None))
            try:
                if head["kind"] == "export":
                    pages = self._export_agreed(head["digests"])
                    if result is not None:
                        result["pages"] = pages
                    continue
                headers = [{"digest": d, "parent": p, "tokens": t,
                            "shapes": head["shapes"][k]}
                           for d, p, t, k in head["pages"]]
                self._import_pages(
                    headers,
                    None if payload is None else [lv for _, lv in payload],
                    result if result is not None else
                    {"imported": 0, "deduped": 0, "rejected": 0})
            except Exception as exc:
                self._tick_fatal(exc, f"kv-{head['kind']}")
                return
            finally:
                if done is not None:
                    done.set()

    def _export_agreed(self, digests: List[str]) -> Optional[List[dict]]:
        """Every rank of a tp group: the same lookup, held to rank 0's,
        then the gather (``_export_waves``); the pages on rank 0."""
        entries = self._export_entries(digests)
        self._mirror.agree("export", [(e[0], e[1]) for e in entries])
        return self._export_waves(entries)

    def _import_pages(self, headers: List[dict], leaves: Optional[list],
                      result: dict) -> None:
        """Stage every page (``_stage_import``), hold the verdicts to rank
        0's under tp, then land the staged blocks' data (``leaves``: each
        page's wire leaves; None on the other ranks of a tp group)."""
        shapes = self._wire_shapes()
        protected: set = set()
        staged: List[tuple] = []  # (blk, wire leaves or None)
        verdicts = []
        for i, header in enumerate(headers):
            verdict, blk = self._stage_import(header, protected, shapes)
            result[verdict] += 1
            verdicts.append((verdict, blk))
            if verdict == "imported":
                staged.append((blk, None if leaves is None else leaves[i]))
                self.telemetry["kv_pages_imported"].inc()
        if self._mirror is not None:
            self._mirror.agree("import", verdicts)
        self._scatter_staged(staged)

    def _reject(self, reason: str) -> tuple:
        self.telemetry["kv_import_rejected"].labels(reason).inc()
        return "rejected", reason

    def _stage_import(self, page: dict, protected: set,
                      shapes: dict) -> tuple:
        """Verify one transferred page (its header: ``_page_header``)
        against this replica's chain and the wire leaf ``shapes``, and
        claim a pool block for it.  Returns ``(verdict, blk)`` (the
        reason in place of the block when rejected); on "imported" the
        block is REGISTERED (later pages of the import chain through it)
        but its data is not in the pool yet: the caller scatters every
        staged block before the scheduler does anything else."""
        tokens = page["tokens"]
        digest = page["digest"]
        parent_digest = page["parent"]
        if (len(tokens) != self.page_size
                or _page_digest(parent_digest, tokens) != digest):
            return self._reject("digest_mismatch")
        # Root pages have parent ""; others chain through a block already
        # registered here (shipped parent-first, or cached locally).
        parent_blk: Optional[int] = None
        if parent_digest:
            parent_blk = next((b for b, d in self._block_digest.items()
                               if d == parent_digest), None)
            if parent_blk is None:
                return self._reject("missing_parent")
        key = (parent_blk, tuple(tokens))
        if key in self._registry or digest in self._block_digest.values():
            return "deduped", None
        for path, shape in shapes.items():
            if page["shapes"].get(path) != shape:
                return self._reject("shape")
        if not self._free_blocks and not self._evict_one(protected):
            return self._reject("pool_exhausted")
        blk = self._free_blocks.pop()
        self._prefix_clock += 1
        self._registry[key] = blk
        self._block_meta[blk] = {"key": key, "refs": 0,
                                 "last": self._prefix_clock,
                                 "parent": parent_blk, "children": set()}
        self._block_digest[blk] = digest
        if parent_blk is not None and parent_blk in self._block_meta:
            self._block_meta[parent_blk]["children"].add(blk)
        protected.add(blk)
        return "imported", blk

    def _scatter_staged(self, staged: List[tuple]) -> None:
        """Land an import's K/V data in place: per wave of
        ``_IMPORT_WAVE_WIDTH`` blocks, one ``index_copy_`` per pool leaf,
        each leaf cast to the pool's dtype, under the device lock
        (released between waves).  One rank moves each leaf's rows to
        the card; under tp rank 0 does, cuts them on the heads axis
        (``_head_chunks``) and scatters each rank its chunk, one flat
        buffer a rank."""
        tp = self.model.tp
        leaves = self._wave_leaves()
        for off in range(0, len(staged), _IMPORT_WAVE_WIDTH):
            wave = staged[off:off + _IMPORT_WAVE_WIDTH]
            idx = self._tensor([blk for blk, _ in wave], torch.long)
            with self._device_lock:
                rows = None
                if tp.rank == 0:
                    rows = [torch.stack([torch.as_tensor(lv[path])
                                         for _, lv in wave]).to(
                                             self.device, leaf.dtype)
                            for path, leaf in leaves]
                if tp.size > 1:
                    like = [torch.empty((len(wave),) + leaf.shape[1:],
                                        dtype=leaf.dtype, device="meta")
                            for _, leaf in leaves]
                    mine = tp.scatter_from_first(
                        None if rows is None else self._head_chunks(rows),
                        torch.empty(sum(t.numel() * t.element_size()
                                        for t in like),
                                    dtype=torch.uint8, device=self.device))
                    rows = _unflat_bytes(mine, like)
                for (_, leaf), r in zip(leaves, rows):
                    leaf.index_copy_(0, idx, r)

    def _head_chunks(self, rows: List[torch.Tensor]) -> List[torch.Tensor]:
        """Rank 0 of a tp group: for each rank r, one flat buffer of its
        KV-head chunk r of every leaf's wave rows ([wave, page, heads,
        ...], heads on dim 2), the ``TensorParallel.chunk`` layout."""
        n = self.model.tp.size
        return [_flat_bytes([r.chunk(n, dim=2)[k] for r in rows])
                for k in range(n)]

    def _retire_slot(self, slot: int) -> None:
        """Drop the slot's block references and point its table row back
        at scratch block 0, so the still-ticking inactive row cannot
        write into blocks about to be reallocated.  Registered blocks
        stay cached at refcount-1; unregistered ones return to the free
        list."""
        if self.page_size <= 0:
            return
        blocks = self._slot_blocks.pop(slot, None)
        self._slot_shared.pop(slot, None)
        if not blocks:
            return
        for blk in blocks:
            meta = self._block_meta.get(blk)
            if meta is not None:
                meta["refs"] -= 1
            else:
                self._free_blocks.append(blk)
        self._retire_count += 1
        # In place, after every launched step in stream order.
        self._table[slot] = 0

    def _table_row(self, blocks: List[int]):
        """Slot block-table row: allocated blocks in logical order,
        unmapped tail entries at scratch block 0."""
        row = np.zeros((self._blocks_per_row,), np.int32)
        row[:len(blocks)] = blocks
        return self._tensor(row, torch.int32)

    def _install_paged(self, slot: int, row_cache) -> None:
        """Scatter a batch-1 dense prefill row into the slot's allocated
        pool blocks (in place) and publish its table row."""
        blocks = self._slot_blocks[slot]
        barr = self._tensor(blocks, torch.long)
        span = len(blocks) * self.page_size
        for name, node in self._cache.items():
            dst = node["attention"]
            src = row_cache[name]["attention"]
            for pool, dense in (("pool_key", "cached_key"),
                                ("pool_value", "cached_value")):
                seq = src[dense][0]                  # [L, KH, D]
                take = min(seq.shape[0], span)
                chunk = seq.new_zeros((span,) + tuple(seq.shape[1:]))
                chunk[:take] = seq[:take]
                if pool + "_scale" in dst:
                    # Prefill ran on the dense layout; the int8 pool
                    # stores quantized values + per-token scales.
                    q8, sc = quantize_kv(chunk)
                    dst[pool][barr] = q8.view(len(blocks), self.page_size,
                                              *seq.shape[1:])
                    dst[pool + "_scale"][barr] = sc.view(
                        len(blocks), self.page_size, seq.shape[1])
                else:
                    dst[pool][barr] = chunk.view(
                        len(blocks), self.page_size,
                        *seq.shape[1:]).to(dst[pool].dtype)
        self._table[slot] = self._table_row(blocks)

    def _prefill_paged(self, slot: int, tokens: List[int], start_len: int,
                       chunk: int):
        """Prefill ``tokens[start_len:]`` into ``slot``'s blocks through
        batch-1 views of the cache, ``chunk`` tokens per forward: each
        view maps the slot's table (shared prefix + private blocks) at
        cache_index = the chunk's start, so the paged multi-token branch
        attends across everything before it and writes the chunk's K/V
        into the private blocks.  The views share the pools, so the
        writes land in place (the JAX batcher donated the whole cache to
        each apply and rebuilt it from the output).  The JAX batcher pads
        each chunk to a fixed width (one compiled program); eager PyTorch
        runs the last chunk at its own width.  Publishes the slot's table
        row and cache index; returns the last position's logits [1, V]
        (the callers sample once from them, so the first token equals
        the unchunked paths')."""
        table_row = self._table_row(self._slot_blocks[slot])
        logits = None
        for pos in range(start_len, len(tokens), chunk):
            piece = tokens[pos:pos + chunk]
            start = self._tensor([pos], torch.int32)
            view = {name: {"attention": {**node["attention"],
                                         "block_table": table_row[None],
                                         "cache_index": start}}
                    for name, node in self._cache.items()}
            logits = self.model(self._tensor([piece], torch.int32),
                                cache=view, decode=True)
        self._table[slot] = table_row
        self._set_slot_index(slot, len(tokens))
        return logits[:, -1]

    def _prefill_pool_logits(self, slot: int, tokens: List[int]):
        """Prefill the prompt past its cached prefix (if any) straight
        into ``slot``'s blocks: in one forward, or in chunks when that
        part is longer than ``prefill_chunk``.  Returns the last
        position's logits [1, V]."""
        start = self._slot_shared[slot] * self.page_size
        chunk = self._prefill_chunk
        if not 0 < chunk < len(tokens) - start:
            chunk = len(tokens)
        return self._prefill_paged(slot, tokens, start, chunk)

    def _prefill_in_pool(self, slot: int, tokens: List[int], sample_args):
        """``_prefill_pool_logits``, then the first token [1]."""
        temp, top_p, gen, top_k = sample_args
        return select_rows(self._prefill_pool_logits(slot, tokens),
                           temp, top_p, [gen], top_k)

    # -- speculative decoding ----------------------------------------------
    def _draft_prefill_install(self, slot: int, tokens: List[int]) -> None:
        """Prefill the committed stream through the draft model (batch-1
        dense) into the draft's slot row."""
        row_cache = init_cache(self._draft_model.config, 1, self.device,
                               max_len=len(tokens), tp=self._tp)
        self._draft_model(self._tensor([tokens], torch.int32),
                          cache=row_cache, decode=True)
        self._copy_dense_row(self._draft_cache, slot, row_cache)
        self._draft_pos[slot] = len(tokens) - 1

    def _speculative_tick(self, slots, next_tokens):
        """One speculation round across every active (all-greedy) slot:
        k proposals per slot, then ``_verify_and_accept``.  Inactive
        slots ride along: their dense rows are garbage that admission
        resets, and their paged table rows point at scratch block 0."""
        k = self.draft_len
        active = [i for i, r in enumerate(slots) if r is not None]
        hists = {i: slots[i].tokens + slots[i].output for i in active}
        # Committed-and-cached length: everything but the newest emitted
        # token is in the caches (the plain-tick invariant).
        m = np.zeros((self.max_slots,), np.int64)
        t_last = np.zeros((self.max_slots,), np.int32)
        for i in active:
            m[i] = len(hists[i]) - 1
            t_last[i] = hists[i][m[i]]

        if self._draft_strategy is not None:
            # Training-free: n-gram lookup over each slot's committed
            # stream; host work only.
            drafted = np.zeros((self.max_slots, k), np.int32)
            for i in active:
                drafted[i] = propose_prompt_lookup(
                    hists[i][:m[i] + 1], k, self._pl_ngram)
        else:
            # Model draft: re-feed the last two committed tokens at index
            # m-1 so the draft cache is current through m, then extend
            # one token at a time.
            feed = np.zeros((self.max_slots, 2), np.int32)
            for i in active:
                feed[i] = (hists[i][m[i] - 1], hists[i][m[i]])
            with self._device_lock:
                # A plain-tick interlude advanced the stream without the
                # draft: a slot whose coverage lags past what the 2-token
                # re-feed covers is re-prefilled.
                for i in active:
                    if self._draft_pos.get(i, -1) < m[i] - 2:
                        self._draft_prefill_install(i, hists[i][:m[i] + 1])
                d_cache = _set_cache_index(
                    self._draft_cache,
                    self._tensor(np.maximum(m - 1, 0), torch.int32))
                tokens = self._tensor(feed, torch.int32)
                drafts = []
                for _ in range(k):
                    logits = self._draft_model(tokens, cache=d_cache,
                                               decode=True)
                    tokens = logits[:, -1].argmax(dim=-1).to(
                        torch.int32)[:, None]
                    drafts.append(tokens)
                self.telemetry["dispatches_total"].inc(k)
                # ONE [B, k] transfer for the whole proposal matrix.
                drafted = torch.cat(drafts, dim=1).cpu().numpy()
                self.telemetry["transfers_total"].inc()
        return self._verify_and_accept(slots, next_tokens, m, t_last,
                                       drafted)

    def _verify_and_accept(self, slots, next_tokens, m, t_last, drafted):
        """ONE width-(k+1) target verify of ``drafted`` across all slots,
        then longest-prefix acceptance + bonus, emission, and per-row
        cache_index rollback over rejected positions."""
        k = self.draft_len
        active = [i for i, r in enumerate(slots) if r is not None]
        with self._device_lock:
            verify_tokens = np.concatenate([t_last[:, None], drafted],
                                           axis=1)
            self._cache = _set_cache_index(
                self._cache, self._tensor(np.maximum(m, 0), torch.int32))
            logits = self.model(self._tensor(verify_tokens, torch.int32),
                                cache=self._cache, decode=True)
            self.telemetry["dispatches_total"].inc()
            g_np = logits.argmax(dim=-1).cpu().numpy()     # [B, k+1]
            self.telemetry["transfers_total"].inc()
            self.telemetry["ticks_total"].inc()

        # Acceptance and emission per slot (lock released: emit() runs
        # streaming callbacks).
        accepted = np.cumprod(drafted == g_np[:, :-1], axis=1).sum(axis=1)
        self.spec_stats["spec_ticks"] += 1
        carry_idx: List[int] = []
        carry_tok: List[int] = []
        for i in active:
            req = slots[i]
            if self._cancelled(req):
                req.done.set()
                slots[i] = None
                self._retire_slot(i)
                continue
            remaining = req.max_new_tokens - len(req.output)
            self.spec_stats["drafted"] += min(k, remaining)
            j = int(accepted[i])
            emit = g_np[i, :j + 1]
            take = int(min(len(emit), remaining))
            if req.stop_tokens:
                # Truncate at the first stop token (emitted inclusive).
                for pos in range(take):
                    if int(emit[pos]) in req.stop_tokens:
                        take = pos + 1
                        break
            self.spec_stats["accepted_drafts"] += min(j, take)
            self._tally(emit[:take])
            for tok in emit[:take]:
                req.emit(int(tok))
            if self._draft_model is not None:
                # Draft coverage: positions m+1..m+min(j, take) hold
                # committed drafts; on a full-acceptance round the last
                # proposal was never fed back, so at most m+k-1.
                self._draft_pos[i] = int(m[i] + min(j, take, k - 1))
            m[i] += take
            if req.finished:
                req.done.set()
                slots[i] = None
                self._retire_slot(i)
            else:
                # Plain-tick invariant for a possible fallback tick:
                # next_tokens carries the newest emitted token.
                carry_idx.append(i)
                carry_tok.append(int(req.output[-1]))
        if carry_idx:
            next_tokens = next_tokens.index_copy(
                0, self._tensor(carry_idx, torch.long),
                self._tensor(carry_tok, torch.int32))
        # Roll every row's write position back over rejected slots.
        self._cache = _set_cache_index(
            self._cache, self._tensor(np.maximum(m, 0), torch.int32))
        return next_tokens

    # -- public API --------------------------------------------------------
    def _headroom(self, temperature: float) -> int:
        """Cache positions past prompt + max_new a verify round may touch
        (the last round can draft past the needed tokens).  Only greedy
        requests speculate, so sampling requests are not charged."""
        if not self._speculative or temperature > 0.0:
            return 0
        return self.draft_len + 1

    def _enqueue(self, tokens, max_new_tokens, temperature, top_p, seed,
                 on_token=None, stop_tokens=(), top_k=0,
                 trace_ctx=None) -> _Request:
        if self._mirror is not None and not self._mirror.leader:
            raise RuntimeError(
                f"serving rank {self._mirror.rank} takes no "
                f"requests: rank 0 of the group admits them")
        headroom = self._headroom(float(temperature))
        if len(tokens) + max_new_tokens + headroom > self._max_seq_len:
            raise ValueError(
                f"prompt ({len(tokens)}) + max_new_tokens "
                f"({max_new_tokens}) + speculation headroom "
                f"({headroom}) exceeds max_seq_len {self._max_seq_len}")
        if self.page_size > 0:
            need = self._blocks_needed(len(tokens) + max_new_tokens
                                       + headroom)
            if need > self._total_blocks:
                raise ValueError(
                    f"request needs {need} cache blocks but the pool "
                    f"only has {self._total_blocks} (cache_blocks too "
                    f"small)")
        if self._stop.is_set():
            raise self._shutdown_error()
        if seed is None:
            import random
            seed = random.getrandbits(31)
        req = _Request(list(map(int, tokens)), max_new_tokens,
                       temperature=float(temperature), top_p=float(top_p),
                       top_k=int(top_k), seed=int(seed),
                       on_token=on_token,
                       stop_tokens=frozenset(map(int, stop_tokens)),
                       metrics=self.telemetry,
                       submitted_at=time.perf_counter(),
                       trace_ctx=trace_ctx, submitted_wall=time.time())
        self._queue.put(req)
        # The scheduler may have stopped and drained between the check
        # above and this put: re-check and fail the request here.
        if self._stop.is_set():
            req.error = self._shutdown_error()
            req.done.set()
            raise req.error
        self.telemetry["queue_depth"].set(self._queue.qsize())
        return req

    def submit(self, tokens: List[int], max_new_tokens: int,
               timeout: float = 300.0, temperature: float = 0.0,
               top_p: float = 1.0, seed: Optional[int] = None,
               stop_tokens=(), top_k: int = 0,
               trace_ctx=None) -> List[int]:
        if max_new_tokens <= 0:
            return []
        req = self._enqueue(tokens, max_new_tokens, temperature, top_p,
                            seed, stop_tokens=stop_tokens, top_k=top_k,
                            trace_ctx=trace_ctx)
        if not req.done.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        return req.output

    def submit_many(self, rows: List[List[int]], max_new_tokens: int,
                    timeout: float = 300.0, temperature: float = 0.0,
                    top_p: float = 1.0, seed: Optional[int] = None,
                    stop_tokens=(), top_k: int = 0,
                    trace_ctx=None) -> List[List[int]]:
        """Several prompts at once, each in a slot of its own (queued
        together, admitted in order); their outputs in order."""
        if max_new_tokens <= 0:
            return [[] for _ in rows]
        reqs = [self._enqueue(r, max_new_tokens, temperature, top_p, seed,
                              stop_tokens=stop_tokens, top_k=top_k,
                              trace_ctx=trace_ctx) for r in rows]
        deadline = time.monotonic() + timeout
        for req in reqs:
            if not req.done.wait(max(0.0, deadline - time.monotonic())):
                raise TimeoutError("generation timed out")
            if req.error is not None:
                raise req.error
        return [req.output for req in reqs]

    def submit_iter(self, tokens: List[int], max_new_tokens: int,
                    timeout: float = 300.0, temperature: float = 0.0,
                    top_p: float = 1.0, seed: Optional[int] = None,
                    stop_tokens=(), top_k: int = 0, trace_ctx=None):
        """Streaming submit: yields each generated id as the batcher
        produces it."""
        if max_new_tokens <= 0:
            return
        sentinel = object()
        out: "queue.Queue" = queue.Queue()
        req = self._enqueue(tokens, max_new_tokens, temperature, top_p,
                            seed, on_token=out.put,
                            stop_tokens=stop_tokens, top_k=top_k,
                            trace_ctx=trace_ctx)
        threading.Thread(
            target=lambda: (req.done.wait(timeout), out.put(sentinel)),
            daemon=True).start()
        try:
            while True:
                item = out.get(timeout=timeout)
                if item is sentinel:
                    break
                yield item
        finally:
            # Closed early (client disconnect): cancel so the batcher
            # frees the slot instead of decoding for nobody.
            req.cancelled.set()
        if req.error is not None:
            raise req.error
        if not req.done.is_set():
            raise TimeoutError("generation timed out")

    def fill_slots(self, context: int, headroom: int = 0) -> None:
        """Occupy every slot with ``context`` cached tokens, whatever the
        cache holds (no prefill runs), with room for ``headroom`` more:
        blocks come from the allocator admission uses, and the table row
        and cache index are set as an install sets them.  For timing
        decode steps at a fixed context; call it before start()."""
        if self._thread is not None:
            raise RuntimeError("fill_slots: the scheduler loop is running")
        with torch.inference_mode():
            for i in range(self.max_slots):
                if self.page_size > 0:
                    if not self._alloc_blocks(i, context + headroom):
                        raise ValueError(
                            f"the pool cannot hold {self.max_slots} slots "
                            f"of {context + headroom} tokens")
                    self._table[i] = self._table_row(self._slot_blocks[i])
                self._set_slot_index(i, context)

    def prefill_logits(self, tokens: List[int]):
        """Last-position logits [V] of ``tokens`` prefilled into slot 0's
        blocks as admission prefills a prompt (past any cached prefix,
        in ``prefill_chunk``-token forwards when that is set); the
        blocks are returned afterwards.  Call it before start() or after
        the scheduler loop ended (under tp: on every rank, a collective
        forward)."""
        if self.page_size <= 0:
            raise ValueError("prefill_logits needs the paged cache "
                             "(page_size > 0)")
        running = self._thread is not None and self._thread.is_alive()
        if running or 0 in self._slot_blocks:
            raise RuntimeError("prefill_logits: slot 0 is in use")
        tokens = [int(t) for t in tokens]
        with torch.inference_mode():
            if not self._alloc_blocks(0, len(tokens) + 1, tokens):
                raise ValueError(f"the pool cannot hold {len(tokens)} "
                                 f"tokens")
            try:
                return self._prefill_pool_logits(0, tokens)[0]
            finally:
                self._retire_slot(0)

    def _shutdown_error(self) -> RuntimeError:
        if self.fatal_error is not None:
            return RuntimeError(
                f"batcher failed fatally during "
                f"{self._fatal_phase or 'admission'} (see the "
                f"batcher-fatal debug bundle): {self.fatal_error!r}")
        return RuntimeError("batcher stopped")

    def start(self) -> "ContinuousBatcher":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="continuous-batcher")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the scheduler.  A tensor-parallel follower's loop ends at
        the turn rank 0 stops (or a fault stops) the group: this only
        waits for it."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for the scheduler loop to end; raise its fatal error."""
        if self._thread is not None:
            self._thread.join(timeout)
        if self.fatal_error is not None:
            raise self._shutdown_error()

    # -- tensor-parallel lock-step -----------------------------------------
    def _cancelled(self, req: _Request) -> bool:
        """Whether the loop drops ``req`` now: its own flag, or under tp
        the cancellation rank 0 broadcast (the same on every rank)."""
        if self._mirror is not None:
            return req.cancel_agreed
        return req.cancelled.is_set()

    def _tally(self, tokens) -> None:
        if self._mirror is not None:
            self._mirror.tally(tokens)

    def _next_request(self) -> _Request:
        if self._mirror is not None:
            if not self._admit:
                raise queue.Empty
            return self._admit.popleft()
        return self._queue.get_nowait()

    def _queue_depth(self) -> int:
        return self._queue.qsize() + len(self._admit)

    def _mirror_turn(self) -> bool:
        """Start a tp scheduler turn: the exchange of records
        (``TickMirror.exchange``), then rank 0's decisions applied on
        every rank.  Returns False when the group stops."""
        m = self._mirror
        decisions = None
        if m.leader:
            new = []
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                req.rid, self._next_rid = self._next_rid, self._next_rid + 1
                new.append((req.rid, req.tokens, req.max_new_tokens,
                            req.temperature, req.top_p, req.top_k,
                            req.seed, sorted(req.stop_tokens)))
                self._live[req.rid] = req
                self._admit.append(req)
            decisions = {
                "stop": self._stop.is_set(), "new": new,
                "cancel": [rid for rid, r in self._live.items()
                           if r.cancelled.is_set() and not r.cancel_agreed],
                "pages": (self._page_ops_to_record()
                          if self.page_size > 0 else [])}
        lead = m.exchange(self.ticks_dispatched, decisions)
        if not m.leader:
            for rid, tokens, n, temp, top_p, top_k, seed, stop in \
                    lead["new"]:
                req = _Request(list(tokens), n, temperature=temp,
                               top_p=top_p, top_k=top_k, seed=seed,
                               stop_tokens=frozenset(stop), rid=rid)
                self._live[rid] = req
                self._admit.append(req)
        for rid in lead["cancel"]:
            if rid in self._live:
                self._live[rid].cancel_agreed = True
        self._page_ops.extend(lead.get("pages", ()))
        self._live = {rid: r for rid, r in self._live.items()
                      if not r.done.is_set()}
        return not lead["stop"]

    # -- scheduler loop ----------------------------------------------------
    def _tick_fatal(self, exc: BaseException, phase: str) -> None:
        """The scheduler cannot continue (a device error mid-launch or
        mid-fetch, a failed KV import, a streaming callback blowing
        up): fail the whole batcher loudly, black-box bundle FIRST, so
        the evidence is on disk when submit() raises."""
        self.fatal_error = exc
        self._fatal_phase = phase
        self._stop.set()
        log.error("batcher failed fatally during %s (dispatched %d, "
                  "fetched %d ticks)", phase, self.ticks_dispatched,
                  self.ticks_fetched, exc_info=exc)
        flight.record(
            "serving", "fatal_error", phase=phase,
            error=f"{type(exc).__name__}: {exc}",
            queue_depth=self._queue.qsize(),
            pipeline_depth=self.ticks_dispatched - self.ticks_fetched,
            last_dispatched_tick=self.ticks_dispatched,
            last_fetched_tick=self.ticks_fetched)
        flight.dump_bundle("batcher-fatal",
                           registry=self.telemetry["registry"],
                           once_key=f"batcher-fatal-{id(self)}")

    def _loop(self) -> None:
        with torch.inference_mode():
            self._run()

    def _run(self) -> None:
        tm = self.telemetry
        on_card = self.device.type == "cuda"
        slots: List[Optional[_Request]] = [None] * self.max_slots
        # Per-slot sampling state: host mirrors, uploaded once per
        # admission wave; one generator per sampling slot (None greedy).
        h_temps = np.zeros((self.max_slots,), np.float32)
        h_top_ps = np.ones((self.max_slots,), np.float32)
        h_top_ks = np.zeros((self.max_slots,), np.int32)
        gens: List[Optional[torch.Generator]] = [None] * self.max_slots
        temps = self._tensor(h_temps, torch.float32)
        top_ps = self._tensor(h_top_ps, torch.float32)
        top_ks = self._tensor(h_top_ks, torch.int32)
        # Tokens feeding the NEXT launched step (on the device: the
        # previous step's output with admission firsts scattered in).
        next_tokens = torch.zeros((self.max_slots,), dtype=torch.int32,
                                  device=self.device)
        # The in-flight step: (token tensor, slots snapshot, done event).
        pending: Optional[tuple] = None
        # A request that could not get cache blocks waits here (FIFO
        # order preserved) until retirements free enough of the pool.
        deferred: Optional[_Request] = None
        deferred_mark = -1

        def dispatch_step():
            """Launch one decode step across every slot (returns once
            the work is queued on the card).  Inactive slots decode
            garbage into their own rows; admission resets them."""
            nonlocal next_tokens
            with self._device_lock:
                out = self.decode_step(next_tokens, temps, top_ps,
                                       list(gens), top_ks)
                done = None
                if on_card:
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
            next_tokens = out
            self.ticks_dispatched += 1
            tm["dispatches_total"].inc()
            tm["pipeline_depth"].set(
                self.ticks_dispatched - self.ticks_fetched)
            return out, list(slots), done

        def process_step(step) -> None:
            """Fetch the step's tokens in ONE device->host transfer, then
            emit / stop-check / retire.  Lanes whose request retired or
            was replaced after the launch hold overrun tokens, dropped
            here."""
            out, snap, done = step
            live = [i for i, req in enumerate(snap)
                    if req is not None and req is slots[i]]
            self.ticks_fetched += 1
            tm["pipeline_depth"].set(
                self.ticks_dispatched - self.ticks_fetched)
            if not live:
                return  # pure-overrun step: dropped without a transfer
            out_np = self._fetch(out, done)
            tm["transfers_total"].inc()
            tm["ticks_total"].inc()
            # Counted here, not at launch: a dropped overrun step emits
            # nothing.
            self.spec_stats["plain_ticks"] += 1
            self._tally(out_np[live])
            for i in live:
                req = snap[i]
                if self._cancelled(req):
                    req.done.set()
                    slots[i] = None
                    self._retire_slot(i)
                    continue
                req.emit(int(out_np[i]))
                if req.finished:
                    req.done.set()
                    slots[i] = None
                    self._retire_slot(i)

        mirror = self._mirror
        while mirror is not None or not self._stop.is_set():
            if mirror is not None:
                # Tensor parallel: the turn starts from rank 0's
                # decisions, the same on every rank.
                try:
                    if not self._mirror_turn():
                        break
                except Exception as exc:
                    self._tick_fatal(exc, "tp-exchange")
                    mirror = None      # the exchange itself failed
                    break
            # Transferred KV pages install before this turn's admissions,
            # so a /generate that raced its own page push still hits the
            # prefix cache.
            if self.page_size > 0 and (
                    self._page_ops
                    or (self._mirror is None and self._kv_imports)):
                self._drain_kv_imports()
                if self._stop.is_set():
                    break
            # Pipelined launch-ahead: queue step k+1 from step k's
            # on-device tokens BEFORE reading step k.
            try:
                ahead = None
                if (pending is not None and self.pipelined
                        and any(s is not None for s in slots)):
                    ahead = dispatch_step()
            except Exception as exc:
                self._tick_fatal(exc, "dispatch")
                break
            try:
                if pending is not None:
                    process_step(pending)
                pending = ahead
            except Exception as exc:
                self._tick_fatal(exc, "fetch")
                break

            # Admit new requests into free slots; per-slot state is
            # staged host-side and uploaded once after the wave.
            admitted = False
            wave_idx: List[int] = []
            wave_first: list = []
            for i in range(self.max_slots):
                if slots[i] is not None:
                    continue
                if deferred is not None:
                    if self._cancelled(deferred):
                        deferred.done.set()
                        deferred = None
                        continue
                    if (self.page_size > 0
                            and deferred_mark == self._retire_count):
                        # Nothing retired since the failed allocation.
                        break
                    req, deferred = deferred, None
                else:
                    try:
                        req = self._next_request()
                    except queue.Empty:
                        break
                if self._cancelled(req):
                    req.done.set()
                    continue
                if self.page_size > 0 and not self._alloc_blocks(
                        i, len(req.tokens) + req.max_new_tokens
                        + self._headroom(req.temperature),
                        tokens=req.tokens):
                    deferred = req  # pool exhausted; retry after retires
                    deferred_mark = self._retire_count
                    req.was_deferred = True
                    break
                req.admitted_at = time.perf_counter()
                tm["queue_wait_seconds"].labels(
                    "deferred" if req.was_deferred else "direct").observe(
                        req.admitted_at - req.submitted_at)
                try:
                    gen = None
                    if req.temperature > 0.0:
                        gen = torch.Generator(device=self.device)
                        gen.manual_seed(_slot_seed(req.seed,
                                                   len(req.tokens)))
                    sample_args = (
                        self._tensor([req.temperature], torch.float32),
                        self._tensor([req.top_p], torch.float32), gen,
                        self._tensor([req.top_k], torch.int32))
                    shared = (self._slot_shared.get(i, 0)
                              if self.page_size > 0 else 0)
                    with self._device_lock:
                        if (shared > 0 or
                                0 < self._prefill_chunk < len(req.tokens)):
                            first = self._prefill_in_pool(i, req.tokens,
                                                          sample_args)
                        else:
                            row_cache, first = self._prefill(req.tokens,
                                                             sample_args)
                            self._install(i, row_cache, len(req.tokens))
                        if (self._draft_model is not None
                                and req.temperature <= 0.0):
                            # Sampling slots never speculate, so their
                            # draft rows can stay garbage.
                            self._draft_prefill_install(i, req.tokens)
                    if self.page_size > 0:
                        self._register_blocks(i, req.tokens)
                    first_i = int(first[0])
                    self._tally((first_i,))
                    req.emit(first_i)
                    if req.finished:
                        req.done.set()
                        self._retire_slot(i)
                        continue
                    slots[i] = req
                    gens[i] = gen
                    h_temps[i] = req.temperature
                    h_top_ps[i] = req.top_p
                    h_top_ks[i] = req.top_k
                    wave_idx.append(i)
                    wave_first.append(first_i)
                    admitted = True
                except Exception as exc:
                    # Slot-local: prefill and install write only this
                    # slot's dense row or private blocks (nothing is
                    # donated, unlike the JAX batcher), and a sticky
                    # device error resurfaces at the next launch, which
                    # is fatal there.  Under tp it may have struck one
                    # rank only: fatal to the group.
                    req.error = exc
                    req.done.set()
                    self._retire_slot(i)
                    if mirror is not None:
                        self._tick_fatal(exc, "admission")
                        break

            if self._stop.is_set() and (mirror is None
                                        or self.fatal_error is not None):
                break  # external stop (under tp: a fault): drain

            if wave_idx:
                # One scatter for the wave's first tokens (landing on the
                # in-flight step's outputs, the next step's inputs) and
                # one upload per sampling-parameter array.
                try:
                    next_tokens = next_tokens.index_copy(
                        0, self._tensor(wave_idx, torch.long),
                        self._tensor(wave_first, torch.int32))
                    temps = self._tensor(h_temps, torch.float32)
                    top_ps = self._tensor(h_top_ps, torch.float32)
                    top_ks = self._tensor(h_top_ks, torch.int32)
                except Exception as exc:
                    self._tick_fatal(exc, "admission-scatter")
                    break

            active_count = sum(1 for s in slots if s is not None)
            tm["queue_depth"].set(self._queue_depth())
            tm["active_slots"].set(active_count)
            if active_count:
                tm["batch_size"].observe(active_count)

            if not active_count:
                if not admitted and pending is None and (
                        mirror is None or mirror.leader):
                    # Idle: wait for work without dequeuing (a tp
                    # follower waits in the next exchange instead).
                    self._queue.wait_nonempty(0.05)
                continue

            # Speculation: every active slot greedy -> one round commits
            # 1..k+1 tokens per slot.  ``pending`` is None here: a
            # speculative batcher never launches ahead.
            if self._speculative and all(
                    r.temperature <= 0.0 for r in slots if r is not None):
                try:
                    next_tokens = self._speculative_tick(slots,
                                                         next_tokens)
                except Exception as exc:
                    self._tick_fatal(exc, "speculative-tick")
                    break
                continue

            # Plain tick: launch (pipeline bootstrap, or every tick in
            # serialized mode); read at the next loop top.
            if pending is None:
                try:
                    pending = dispatch_step()
                except Exception as exc:
                    self._tick_fatal(exc, "dispatch")
                    break

        if mirror is not None and self.fatal_error is not None:
            # This rank's own fault: the others stop at their next
            # exchange.
            mirror.tell_fatal(self.ticks_dispatched, self.fatal_error)
        # Drain on shutdown: submit() rejects once _stop is set, so this
        # converges; pending and in-flight requests fail loudly.
        self._stop.set()
        while self._admit:
            req = self._admit.popleft()
            req.error = self._shutdown_error()
            req.done.set()
        if deferred is not None:
            deferred.error = self._shutdown_error()
            deferred.done.set()
        if self.page_size > 0:
            # Unblock importers waiting on a dead scheduler
            # (import_kv_pages re-checks the fatal state after the event).
            with self._kv_imports_lock:
                while self._kv_imports:
                    self._kv_imports.popleft()[3].set()
            while self._page_payload:
                self._page_payload.popleft()[2].set()
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.error = self._shutdown_error()
            req.done.set()
        for req in slots:
            if req is not None:
                req.error = self._shutdown_error()
                req.done.set()
