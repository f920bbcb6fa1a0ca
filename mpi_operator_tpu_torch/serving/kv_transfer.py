"""Paged KV-transfer protocol for disaggregated prefill/decode serving:
the port's counterpart of ``mpi_operator_tpu/serving/kv_transfer.py``.

Disaggregation splits a model's replicas into a *prefill* pool
(compute-bound: prefill only, requests retire at admission) and a
*decode* pool (memory-bandwidth bound: steady-state ticks only).  The
handoff between them is the prompt's KV cache, and because the paged
cache is content-addressed by ``prefix_page_digests`` chain digests
(serving/batcher.py), the handoff is a *content-addressed page
transfer*: the prefill replica is told which chain digests the decode
replica already advertises, and only the missing pages cross the wire.

Wire format (POST /kv/pages on the receiving replica, JSON), the same
bytes as the JAX package's, so pages cross between the two packages in
either direction:

    {"pages": [{"digest":  "<blake2b-8 chain digest>",
                "parent":  "<parent chain digest or ''>",
                "tokens":  [<page_size ints>],
                "leaves":  {"layers_<i>/attention/pool_key":
                              {"b64": ..., "dtype": ..., "shape": ...},
                            ...}},
               ...]}

A leaf's ``dtype`` is a numpy dtype name.  numpy alone has no
``"bfloat16"`` (the JAX side writes it through ``ml_dtypes``), so the
codec maps the names itself: a bf16 leaf travels as its raw bytes under
the name ``"bfloat16"`` and is read back through an int16 view.

Pages are ordered parent-first so the receiver can rebuild the chain in
one pass.  The receiver verifies every digest against its own chain
before installing: a transfer is *proposed*, not trusted, and the
protocol is best-effort (a rejected page just means the decode replica
prefills that span itself).
"""

from __future__ import annotations

import base64
import json
import time
from typing import Dict, List, Optional
from urllib import request as _urlreq

import numpy as np
import torch

#: Ceiling on pages per POST /kv/pages body; longer chains are shipped
#: in consecutive parent-first batches so one long prompt cannot hold a
#: replica's HTTP handler on a single giant body.
MAX_PAGES_PER_PUSH = 64

# Wire dtype name -> (numpy dtype the bytes are read as, torch dtype).
_WIRE_DTYPES = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float16": (np.float16, torch.float16),
    "float32": (np.float32, torch.float32),
    "int8": (np.int8, torch.int8),
}


class KVTransferError(RuntimeError):
    """A page push failed in transport (the receiving replica is
    unreachable or errored).  Callers fall back to decode-side
    self-prefill: this error is flow control, not data loss."""


def encode_leaf(arr) -> dict:
    """One pool leaf (a host tensor or numpy array) -> JSON-safe dict."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:
            raw = arr.contiguous().view(torch.int16).numpy()
            return {"b64": base64.b64encode(raw.tobytes()).decode("ascii"),
                    "dtype": "bfloat16", "shape": list(arr.shape)}
        arr = arr.numpy()
    arr = np.asarray(arr)
    return {"b64": base64.b64encode(arr.tobytes()).decode("ascii"),
            "dtype": str(arr.dtype), "shape": list(arr.shape)}


def decode_leaf(spec: dict) -> torch.Tensor:
    """Inverse of :func:`encode_leaf`, as a host tensor.  Raises on a
    malformed spec (an unknown dtype included); the importer maps that
    to a dropped page, never a crash."""
    if spec["dtype"] not in _WIRE_DTYPES:
        raise ValueError(f"unknown wire dtype {spec['dtype']!r}")
    np_dtype, dtype = _WIRE_DTYPES[spec["dtype"]]
    raw = base64.b64decode(spec["b64"])
    arr = np.frombuffer(raw, dtype=np_dtype).reshape(spec["shape"]).copy()
    return torch.from_numpy(arr).view(dtype)


def encode_pages(pages: List[dict]) -> List[dict]:
    """Batcher ``export_kv_pages`` output -> wire form."""
    out = []
    for page in pages:
        out.append({"digest": page["digest"], "parent": page["parent"],
                    "tokens": [int(t) for t in page["tokens"]],
                    "leaves": {path: encode_leaf(leaf)
                               for path, leaf in page["leaves"].items()}})
    return out


def decode_pages(wire: List[dict]) -> List[dict]:
    """Wire form -> batcher ``import_kv_pages`` input.  A page whose
    leaves fail to decode is dropped here (best-effort), so one corrupt
    page cannot poison the rest of its batch."""
    out = []
    for page in wire:
        try:
            out.append({"digest": str(page["digest"]),
                        "parent": str(page.get("parent", "")),
                        "tokens": [int(t) for t in page["tokens"]],
                        "leaves": {path: decode_leaf(spec)
                                   for path, spec
                                   in page["leaves"].items()}})
        except (KeyError, TypeError, ValueError):
            continue
    return out


def payload_bytes(wire_pages: List[dict]) -> int:
    """Serialized size of a wire-form page list."""
    return len(json.dumps({"pages": wire_pages}).encode())


def push_pages(url: str, wire_pages: List[dict],
               timeout: float = 30.0) -> dict:
    """POST wire-form pages to ``url``/kv/pages in parent-first
    batches.  Returns aggregate receiver accounting
    ``{"imported", "deduped", "rejected", "bytes"}``, plus the
    receiver's own seconds (``wire_decode_s``, ``import_s``) where it
    reports them (a JAX replica does not)."""
    total = {"imported": 0, "deduped": 0, "rejected": 0, "bytes": 0,
             "wire_decode_s": 0.0, "import_s": 0.0}
    for off in range(0, len(wire_pages), MAX_PAGES_PER_PUSH):
        batch = wire_pages[off:off + MAX_PAGES_PER_PUSH]
        body = json.dumps({"pages": batch}).encode()
        req = _urlreq.Request(
            url.rstrip("/") + "/kv/pages", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with _urlreq.urlopen(req, timeout=timeout) as resp:
                reply = json.loads(resp.read().decode())
        except Exception as exc:  # urllib raises a small zoo here
            raise KVTransferError(
                f"KV-page push to {url} failed: {exc}") from exc
        for key in ("imported", "deduped", "rejected"):
            total[key] += int(reply.get(key, 0))
        for key in ("wire_decode_s", "import_s"):
            total[key] += float(reply.get(key, 0.0))
        total["bytes"] += len(body)
    return total


def transfer_pages(batcher, digests: List[str], dest_url: str,
                   have: Optional[List[str]] = None,
                   timeout: float = 30.0) -> Dict[str, object]:
    """The prefill-replica side of a disaggregated handoff: export the
    chain pages for ``digests`` that the destination does NOT already
    advertise (``have``), and push them parent-first to ``dest_url``.

    Returns ``{"shipped", "deduped", "imported", "rejected", "bytes",
    "seconds"}``: ``deduped`` counts pages never exported because the
    destination already had them, ``seconds`` splits the handoff's wall
    time into ``export`` (gather + device-to-host copy), ``encode``,
    ``push`` (the HTTP round trips, the receiver's work included) and
    the receiver's ``wire_decode`` and ``import`` where it reports
    them."""
    have_set = set(have or ())
    missing = [d for d in digests if d not in have_set]
    seconds = {"export": 0.0, "encode": 0.0, "push": 0.0,
               "wire_decode": 0.0, "import": 0.0}
    stats = {"shipped": 0, "deduped": len(digests) - len(missing),
             "imported": 0, "rejected": 0, "bytes": 0, "seconds": seconds}
    if not missing:
        return stats
    t0 = time.perf_counter()
    pages = batcher.export_kv_pages(missing)
    t1 = time.perf_counter()
    seconds["export"] = t1 - t0
    if not pages:
        return stats
    wire = encode_pages(pages)
    t2 = time.perf_counter()
    seconds["encode"] = t2 - t1
    reply = push_pages(dest_url, wire, timeout=timeout)
    seconds["push"] = time.perf_counter() - t2
    seconds["wire_decode"] = reply["wire_decode_s"]
    seconds["import"] = reply["import_s"]
    stats["shipped"] = len(wire)
    stats["imported"] = reply["imported"]
    # Receiver-side dedup (it learned the page since ``have`` was
    # snapshotted) folds into the dedup figure too.
    stats["deduped"] += reply["deduped"]
    stats["rejected"] = reply["rejected"]
    stats["bytes"] = reply["bytes"]
    return stats
