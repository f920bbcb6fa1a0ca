"""Lock-step ticks for serving across cards.

The JAX server has one controller; the port has one process per card,
and every rank of the serving group (every rank of the serving mesh:
fsdp x tp) must run the same forwards in the same order, or their
collectives (the tp all-reduces, the fsdp gathers) pair up wrongly.  So
every rank runs the same ``ContinuousBatcher`` over its shard, mesh rank
0 alone takes requests
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

KV-page operations (disaggregated serving) ride the same record as
headers only: rank 0's queued exports (the chain digests asked for) and
imports (each page's digest, parent, tokens and leaf shapes), never the
leaf bytes, which move afterwards over the tp group's device
communicator (``serving/batcher.py``; at tp only: page operations refuse
fsdp > 1).  Every rank stages the same
verdicts from the same state; :meth:`TickMirror.agree` holds that
before a byte moves, and a rank whose verdicts differ from rank 0's
stops every rank with :class:`TPPeerError`.

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
import pickle
import time
from typing import Optional

import torch.distributed as dist

_MOD = (1 << 61) - 1


class TPPeerError(RuntimeError):
    """Another rank of the serving group failed or diverged."""


def serving_ranks(mesh) -> list:
    """The global ranks of a serving mesh, in mesh order (its rank 0
    leads)."""
    return [int(r) for r in mesh.mesh.flatten().tolist()]


class TickMirror:
    """The host side of one serving group: a gloo group over its ranks
    (global ranks, the leader first: ``serving_ranks(mesh)``), this
    rank's role and its health record."""

    def __init__(self, ranks, timeout_s: float = 120.0):
        self.ranks = list(ranks)
        self.rank = self.ranks.index(dist.get_rank())
        self.size = len(self.ranks)
        self.leader = self.rank == 0
        # Only the group's own ranks take part: a world may hold several
        # serving groups (a prefill replica and a decode replica) whose
        # ranks build their servers independently.
        self.group = dist.new_group(
            ranks=sorted(self.ranks), backend="gloo",
            timeout=datetime.timedelta(seconds=timeout_s),
            use_local_synchronization=True)
        self.turns = 0
        self.checksum = 0
        self.seconds = 0.0          # wall time spent in exchanges
        # Pickled size of the largest record that carried page headers.
        self.page_record_bytes = 0

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
        if decisions and decisions.get("pages"):
            self.page_record_bytes = max(self.page_record_bytes,
                                         len(pickle.dumps(mine)))
        records = self._gather(mine)
        self.turns += 1
        health = [(r["turn"], r.get("ticks"), r.get("sum")) for r in records]
        if len(set(health)) > 1:
            raise TPPeerError(
                f"serving ranks diverged (turn, decode steps, "
                f"token checksum per rank): {health}")
        return records[0]["decisions"]

    def agree(self, what: str, verdicts) -> None:
        """Hold this rank's verdicts of a page operation (what it staged
        or found, block by block) to rank 0's: one all-gather; raises
        TPPeerError when another rank failed or staged differently."""
        records = self._gather({"turn": self.turns, "fatal": None,
                                "verdicts": verdicts})
        theirs = [r.get("verdicts") for r in records]
        if any(v != theirs[0] for v in theirs):
            raise TPPeerError(
                f"serving ranks staged different verdicts for a "
                f"KV-page {what} (per rank): {theirs}")

    def _gather(self, mine: dict) -> list:
        """Every rank's record; TPPeerError when another rank sent the
        error that stopped it."""
        gathered = [None] * self.size
        t0 = time.perf_counter()
        dist.all_gather_object(gathered, mine, group=self.group)
        self.seconds += time.perf_counter() - t0
        # In the group's rank order; the leader's record first.
        order = sorted(self.ranks)
        records = [gathered[order.index(r)] for r in self.ranks]
        for rank, rec in enumerate(records):
            if rec["fatal"] is not None and rank != self.rank:
                raise TPPeerError(f"serving rank {rank} failed: "
                                  f"{rec['fatal']}")
        return records

    def tell_fatal(self, ticks: int, error: BaseException) -> None:
        """This rank stopped on its own error: one last exchange carrying
        it, so the ranks waiting at their next exchange stop too.  Bounded
        by the group's timeout when they are not there."""
        try:
            self.exchange(ticks, fatal=f"{type(error).__name__}: {error}")
        except Exception:  # noqa: BLE001 — the peers may be gone already
            pass
