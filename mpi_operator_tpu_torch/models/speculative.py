"""Speculative decoding (greedy, lossless): counterpart of
``mpi_operator_tpu/models/speculative.py``.

A draft model proposes ``draft_len`` tokens one at a time; the target
scores all of them in ONE forward (the multi-token decode branch) and
keeps the longest prefix that matches its own greedy choices, plus one
corrected or bonus token.  Every committed token is the target's argmax
from a verify forward, while the number of target forwards drops toward
max_new_tokens / (draft_len + 1) as the draft agrees.

Numerics: the verify forward (width draft_len + 1) and ``generate``'s
width-1 step are different computations whose logits can differ in the
last bits.  In f32 on the CPU the streams are identical to
``greedy_generate``'s; in bf16 on the card a near-tied top-2 can flip,
and both streams are then greedy decodes of the same model.

Cache bookkeeping: both caches advance in place through the model's
decode path, and each round rolls every row's ``cache_index`` back over
rejected positions (stale K/V past the index is masked and overwritten
before it is read).  The draft is re-fed the last TWO committed tokens
each round (rewriting one identical K/V entry), which covers the
all-accepted case where its cache is one token behind.
"""

from __future__ import annotations

import numpy as np
import torch

from .llama import LlamaModel, _prefill, _set_cache_index


def _greedy(model: LlamaModel, cache, tokens):
    """One decode forward of ``tokens`` [B, w] -> argmax ids [B, w]."""
    return model(tokens.int(), cache=cache, decode=True).argmax(dim=-1)


@torch.inference_mode()
def speculative_generate(model: LlamaModel, draft_model: LlamaModel,
                         prompt_tokens, max_new_tokens: int,
                         draft_len: int = 4, return_stats: bool = False):
    """Greedy speculative decoding, token-identical to
    ``greedy_generate(model, prompt_tokens, max_new_tokens)`` up to the
    float ties above.

    - model and draft_model share a vocabulary and a device; the draft
      may be the target itself (same tensors, its own cache).
    - draft_len: proposals per round; each round costs draft_len draft
      forwards and ONE target forward and commits 1..draft_len+1 tokens.
    - Reserves draft_len + 1 positions of cache headroom past
      prompt + max_new_tokens (the last round may verify past them).

    Returns [B, max_new_tokens] int64 on the model's device, with a stats
    dict (``target_forwards``, ``draft_forwards``, ``rounds``,
    ``accepted_drafts``, ``live_drafted``) when ``return_stats``."""
    device = model.device
    if draft_model.device != device:
        raise ValueError(f"draft on {draft_model.device}, target on "
                         f"{device}")
    prompt = torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.int32,
                             device=device)
    b, s = prompt.shape
    if max_new_tokens <= 0:
        out = torch.zeros((b, 0), dtype=torch.int64, device=device)
        return (out, {"target_forwards": 0, "draft_forwards": 0,
                      "rounds": 0, "accepted_drafts": 0,
                      "live_drafted": 0}) if return_stats else out
    if draft_len < 1:
        raise ValueError(f"draft_len must be >= 1, got {draft_len}")
    total = s + max_new_tokens + draft_len + 1
    for which, m in (("model", model), ("draft_model", draft_model)):
        if total > m.config.max_seq_len:
            raise ValueError(
                f"prompt ({s}) + max_new_tokens ({max_new_tokens}) + "
                f"speculation headroom ({draft_len + 1}) = {total} "
                f"exceeds {which}.max_seq_len {m.config.max_seq_len}")

    stats = {"target_forwards": 1, "draft_forwards": 1, "rounds": 0,
             "accepted_drafts": 0, "live_drafted": 0}
    budget = max_new_tokens + draft_len + 1
    logits, cache = _prefill(model, prompt, budget)
    _, d_cache = _prefill(draft_model, prompt, budget)

    def ids(arr):
        return torch.as_tensor(arr, dtype=torch.int32, device=device)

    out = np.zeros((b, max_new_tokens), np.int64)
    done = np.zeros((b,), np.int64)            # per-row emitted count
    out[:, 0] = logits[:, -1].argmax(dim=-1).cpu().numpy()
    done += 1
    # history: [B, S + max_new] committed tokens (prompt + emitted);
    # m_row: committed-and-cached length per row (the newest excluded).
    history = np.concatenate([prompt.cpu().numpy().astype(np.int64), out],
                             axis=1)
    m_row = np.full((b,), s, np.int64)
    rows = np.arange(b)

    while done.min() < max_new_tokens:
        stats["rounds"] += 1
        # Drafts that could be committed this round: the accept-rate
        # denominator (finished rows ride along but cannot accept).
        stats["live_drafted"] = int(stats["live_drafted"] + np.minimum(
            draft_len, np.maximum(max_new_tokens - done, 0)).sum())
        # Draft: re-feed the last two committed tokens at index m-1,
        # then extend one token at a time.
        d_cache = _set_cache_index(d_cache, ids(m_row - 1))
        g = _greedy(draft_model, d_cache, ids(np.stack(
            [history[rows, m_row - 1], history[rows, m_row]], axis=1)))
        stats["draft_forwards"] += 1
        drafts = [g[:, -1]]
        for _ in range(draft_len - 1):
            drafts.append(_greedy(draft_model, d_cache,
                                  drafts[-1][:, None])[:, -1])
            stats["draft_forwards"] += 1
        drafted = torch.stack(drafts, dim=1)                # [B, k]

        # Target verifies in one forward.
        t_last = ids(history[rows, m_row])
        cache = _set_cache_index(cache, ids(m_row))
        greedy = _greedy(model, cache, torch.cat(
            [t_last[:, None], drafted.int()], dim=1))
        stats["target_forwards"] += 1

        # Acceptance.
        d_np = drafted.cpu().numpy()
        g_np = greedy.cpu().numpy()                         # [B, k+1]
        accepted = np.cumprod(d_np == g_np[:, :-1], axis=1).sum(axis=1)
        for row in range(b):
            if done[row] >= max_new_tokens:
                continue                # finished row: index stays parked
            j = int(accepted[row])
            emit = g_np[row, :j + 1]                        # d1..dj, bonus
            take = int(min(len(emit), max_new_tokens - done[row]))
            # Only drafts actually committed count as accepted.
            stats["accepted_drafts"] += min(j, take)
            out[row, done[row]:done[row] + take] = emit[:take]
            history[row, s + done[row]:s + done[row] + take] = emit[:take]
            done[row] += take
            m_row[row] += take          # m_row = s + done - 1

    result = torch.as_tensor(out, device=device)
    return (result, stats) if return_stats else result
