"""Lock-step ticks for tensor-parallel serving.

The JAX server has one controller; the port has one process per card,
and every rank of the tp group must run the same forwards in the same
order, or their collectives pair up wrongly.  So every rank runs the
same ``ContinuousBatcher`` over its shard, rank 0 alone takes requests
(its HTTP front end and queue), and at the top of each scheduler turn
the ranks exchange one record over a gloo group of host objects
(:meth:`TickMirror.exchange`): rank 0's decisions that depend on time or
on the front end (the requests it admits to the turn, with their prompt
tokens, sampling parameters and seeds; the cancellations it saw; stop),
and every rank's health: the turn number, its count of launched decode
steps, a running checksum of every token it emitted, and the error that
stopped it, if one did.  Everything else the batcher decides (admission
order, blocks, prefix hits, retirement, speculation) follows from those
inputs, so the cache surgery is the same on every rank without a
protocol of its own.

Sampled tokens: the gathered logits are the same bits on every rank and
each slot's generator is seeded alike, so the tokens agree; the checksum
holds it every turn, and a rank whose turn, step count or checksum
differs from rank 0's stops every rank with an error.  A rank that
fails sends its error in one last exchange; the others stop at that
exchange.  A rank that never arrives (dead, or stuck in a collective)
makes the exchange time out on the others (the group's ``timeout``), as
the model's own collectives time out by the process group's.
"""

from __future__ import annotations

import datetime
import time
from typing import Optional

import torch.distributed as dist

_MOD = (1 << 61) - 1


class TPPeerError(RuntimeError):
    """Another rank of the tensor-parallel group failed or diverged."""


class TickMirror:
    """The host side of one tensor-parallel serving group: a gloo group
    over the tp ranks, this rank's role and its health record."""

    def __init__(self, tp, timeout_s: float = 120.0):
        self.tp = tp
        self.leader = tp.rank == 0
        self.group = dist.new_group(
            ranks=dist.get_process_group_ranks(tp.group), backend="gloo",
            timeout=datetime.timedelta(seconds=timeout_s))
        self.turns = 0
        self.checksum = 0
        self.seconds = 0.0          # wall time spent in exchanges

    def tally(self, tokens) -> None:
        """Fold emitted tokens into this rank's running checksum."""
        for t in tokens:
            self.checksum = (self.checksum * 1000003 + int(t) + 1) % _MOD

    def exchange(self, ticks: int, decisions: Optional[dict] = None,
                 fatal: Optional[str] = None) -> dict:
        """One all-gather of every rank's record; returns rank 0's
        decisions.  Raises TPPeerError when another rank failed or any
        rank's turn, step count or checksum differs from rank 0's."""
        mine = {"turn": self.turns, "ticks": ticks, "sum": self.checksum,
                "fatal": fatal, "decisions": decisions}
        records = [None] * self.tp.size
        t0 = time.perf_counter()
        dist.all_gather_object(records, mine, group=self.group)
        self.seconds += time.perf_counter() - t0
        self.turns += 1
        for rank, rec in enumerate(records):
            if rec["fatal"] is not None and rank != self.tp.rank:
                raise TPPeerError(f"tensor-parallel rank {rank} failed: "
                                  f"{rec['fatal']}")
        health = [(r["turn"], r["ticks"], r["sum"]) for r in records]
        if len(set(health)) > 1:
            raise TPPeerError(
                f"tensor-parallel ranks diverged (turn, decode steps, "
                f"token checksum per rank): {health}")
        return records[0]["decisions"]

    def tell_fatal(self, ticks: int, error: BaseException) -> None:
        """This rank stopped on its own error: one last exchange carrying
        it, so the ranks waiting at their next exchange stop too.  Bounded
        by the group's timeout when they are not there."""
        try:
            self.exchange(ticks, fatal=f"{type(error).__name__}: {error}")
        except Exception:  # noqa: BLE001 — the peers may be gone already
            pass
