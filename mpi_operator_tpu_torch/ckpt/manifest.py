"""Checkpoint manifest format, delta chains, and chain resolution: the
port's copy of ``mpi_operator_tpu/ckpt/manifest.py`` (stdlib only).

The manifest is the unit of visibility (docs/RESILIENCE.md "Checkpoint
data plane"): a job-level manifest names, for one training step, the
complete (shard -> chunk -> blob) mapping needed to restore it.  Two
kinds:

- ``full``: every shard lists every chunk.
- ``delta``: every shard lists only the chunks whose CONTENT HASH
  changed since its base, plus ``base_step`` — the manifest chains onto
  the previous manifest, and restore overlays the delta's chunks onto
  the resolved base view.

``depth`` counts deltas since the last full.  The compaction rule is
bounded depth: a writer about to exceed :data:`MAX_DELTA_DEPTH` writes
a full manifest instead.  Because blobs are content-addressed, that
"synthetic full" re-uploads nothing (every unchanged chunk is a dedup
hit) — it costs one manifest write, and it caps a restore at
O(shards) manifest reads instead of O(history).

Manifests carry no wallclock and are canonically encoded
(blobstore.canonical_bytes), so a seeded run commits byte-identical
manifests on every re-run.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .blobstore import BlobStore, canonical_bytes

FORMAT_VERSION = 1

# Compaction bound: a delta chain never grows past this many manifests
# (the full at the root included in the read count, so restore touches
# at most MAX_DELTA_DEPTH + 1 manifests per job, independent of run
# length).
MAX_DELTA_DEPTH = 4

KIND_FULL = "full"
KIND_DELTA = "delta"


def canonical_manifest_bytes(body: dict) -> bytes:
    """The byte-identity surface asserted by ckpt_smoke's run-twice
    check (alias of the store's canonical encoding)."""
    return canonical_bytes(body)


def build_manifest(job: str, step: int, kind: str, num_shards: int,
                   layout: List[dict], total_bytes: int,
                   chunk_bytes: int, shards: Dict[int, dict],
                   base_step: Optional[int] = None,
                   depth: int = 0) -> dict:
    if kind not in (KIND_FULL, KIND_DELTA):
        raise ValueError(f"manifest kind {kind!r}")
    if kind == KIND_DELTA and base_step is None:
        raise ValueError("delta manifest requires base_step")
    return {
        "format": FORMAT_VERSION,
        "job": job,
        "step": int(step),
        "kind": kind,
        "base_step": base_step,
        "depth": int(depth),
        "num_shards": int(num_shards),
        "chunk_bytes": int(chunk_bytes),
        "total_bytes": int(total_bytes),
        "layout": layout,
        "shards": {str(s): shards[s] for s in sorted(shards)},
    }


def shard_ranges(total_bytes: int, num_shards: int) -> List[Tuple[int, int]]:
    """Contiguous byte-range partition of the serialized state stream:
    shard ``i`` owns ``[bounds[i], bounds[i+1])`` — the ZeRO-flavored
    disjoint ownership (arXiv:2004.13336) that lets every worker stream
    only its own slice."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    bounds = [round(i * total_bytes / num_shards)
              for i in range(num_shards + 1)]
    return [(bounds[i], bounds[i + 1]) for i in range(num_shards)]


def chunk_spans(length: int, chunk_bytes: int) -> List[Tuple[int, int]]:
    """Fixed-size chunk boundaries within one shard's byte range.
    Stable across steps (state layouts don't change shape mid-run), so
    an unchanged region hashes to the same blob every step — the
    property delta checkpoints ride on."""
    if chunk_bytes < 1:
        raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
    spans = []
    off = 0
    while off < length:
        end = min(off + chunk_bytes, length)
        spans.append((off, end))
        off = end
    if not spans:
        spans.append((0, 0))
    return spans


def resolve_chain(store: BlobStore, job: str,
                  step: int) -> Optional[List[dict]]:
    """The manifest chain for ``step``: ``[full, delta, ..., delta]``
    oldest-first, or None when any link is missing/torn.  Walks at most
    MAX_DELTA_DEPTH + 1 links — a longer chain is a protocol violation
    (the compaction rule was broken) and reads as unreadable rather
    than as an unbounded walk."""
    chain: List[dict] = []
    seen = set()
    cursor: Optional[int] = step
    for _ in range(MAX_DELTA_DEPTH + 1):
        if cursor is None or cursor in seen:
            return None
        seen.add(cursor)
        manifest = store.read_manifest(job, cursor)
        if manifest is None:
            return None
        chain.append(manifest)
        if manifest["kind"] == KIND_FULL:
            chain.reverse()
            return chain
        cursor = manifest.get("base_step")
    return None  # chain deeper than the compaction bound


def effective_chunks(chain: List[dict]) -> Dict[int, Dict[int, dict]]:
    """Overlay the chain into the effective restore view:
    ``{shard: {chunk_index: {"blob", "nbytes"}}}`` — exactly what a
    reader fetches, O(shards * chunks) regardless of chain length."""
    view: Dict[int, Dict[int, dict]] = {}
    for manifest in chain:  # oldest (full) first, deltas overlay
        for shard_key, shard in manifest["shards"].items():
            shard_view = view.setdefault(int(shard_key), {})
            for idx_key, ref in shard.get("chunks", {}).items():
                shard_view[int(idx_key)] = ref
    return view


def chain_complete(store: BlobStore, chain: List[dict]) -> List[str]:
    """Failures that make the chain unrestorable: a missing blob, or a
    shard whose effective view has chunk gaps.  Empty list = readable."""
    problems: List[str] = []
    head = chain[-1]
    view = effective_chunks(chain)
    for shard in range(head["num_shards"]):
        chunks = view.get(shard)
        if chunks is None:
            problems.append(f"shard {shard} absent from manifest chain")
            continue
        declared = head["shards"].get(str(shard), {}).get("num_chunks")
        expected = set(range(declared)) if declared is not None \
            else set(range(len(chunks)))
        if set(chunks) != expected:
            problems.append(
                f"shard {shard} has chunk gaps: "
                f"{sorted(set(chunks) ^ expected)[:4]}")
            continue
        for idx, ref in chunks.items():
            if not store.has(ref["blob"]):
                problems.append(
                    f"shard {shard} chunk {idx} blob {ref['blob'][:16]}"
                    f"... missing from store")
    return problems


def latest_restorable(store: BlobStore, job: str
                      ) -> Optional[Tuple[int, List[dict]]]:
    """The newest step whose manifest chain is fully readable —
    skipping torn manifests (invisible already) and committed manifests
    whose chain lost a link/blob.  This is what a restart restores
    from, and what the ``ckpt_manifest_consistent`` invariant audits."""
    for step in reversed(store.manifest_steps(job)):
        chain = resolve_chain(store, job, step)
        if chain is not None and not chain_complete(store, chain):
            return step, chain
    return None
