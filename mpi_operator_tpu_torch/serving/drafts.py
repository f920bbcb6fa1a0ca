"""Training-free draft strategies for speculative decoding.

The port's own copy of ``mpi_operator_tpu/serving/drafts.py`` (pure
Python and numpy; the port imports nothing of the JAX package).

Prompt-lookup decoding: propose the continuation of the request's OWN
context.  Match the longest n-gram suffix of the committed stream
(prompt + generated) against an earlier occurrence and copy the k tokens
that followed it.  No draft model, no draft cache: drafting is host
work, and the acceptance rule of the model-draft path (argmax
longest-prefix + bonus) keeps the emitted stream a greedy decode of the
target.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

DRAFT_STRATEGIES = ("prompt_lookup",)


def propose_prompt_lookup(history: Sequence[int], k: int,
                          max_ngram: int = 3,
                          window: int = 4096) -> List[int]:
    """Propose k tokens by n-gram continuation lookup over ``history``.

    Scans n-gram sizes ``max_ngram..1``; for each, finds the MOST RECENT
    earlier occurrence of the history's length-n suffix and copies the k
    tokens after it.  A continuation shorter than k is extended by
    cycling it.  No occurrence at any n: k repeats of the last token.
    Only the last ``window`` tokens are searched.
    """
    if k < 1:
        return []
    if len(history) == 0:
        return [0] * k
    h = np.asarray(history[-window:] if len(history) > window
                   else history, dtype=np.int64)
    size = int(h.size)
    for n in range(min(max_ngram, size - 1), 0, -1):
        tail = h[size - n:]
        # Candidate starts 0..size-n-1 (the suffix itself sits at size-n).
        match = np.ones(size - n, dtype=bool)
        for j in range(n):
            match &= h[j:size - n + j] == tail[j]
        idx = np.nonzero(match)[0]
        if idx.size:
            s = int(idx[-1])  # most recent occurrence
            base = h[s + n:]  # never empty: s <= size-n-1
            return [int(base[j % base.size]) for j in range(k)]
    return [int(h[-1])] * k
