"""The reference graph split over the ranks of a cell across cards, in plain
torch and ``torch.distributed``, and the exact comparison of the port's
stored graph with it.

Each rank keeps the reference's ordered pairs (u, v) whose ``owner`` (a
hash of u * V + v, mod the world's size) is its rank: it regenerates every
tuple from the configuration's ``edge_chunks``, adds each reciprocal where
the configuration symmetrizes, and coalesces its share with
``torch.unique``. So no card holds the whole graph, and a rank's share is
even on a skewed graph.

The port's stored edges are read by the partition contract of its 2D
layout (stated again here, not imported; ``dist/partition.py``): P ranks
on an (R, C) mesh, R >= C and as near square as P allows, rank = i * C +
j; V padded to P * vp; rank (i, j) compresses its edges by destination in
``in_block``: major b * vp + t is destination (b * R + i) * vp + t, for
b < C, and minor s is source j * R * vp + s. Each rank turns its edges
into global pairs and sends each to the pair's owner with
``all_to_all_single``; each owner then counts the pairs it should hold
and did not get, those it got and should not hold, and those it got more
than once.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

HASH_MUL = 0x9E3779B1  # Fibonacci hashing's 32-bit multiplier
EXCHANGE_EDGES = 1 << 27  # stored edges a rank sends in one round of the exchange


def mesh_shape(p: int):
    """(R, C) of P ranks: R * C = P, R >= C, C the largest divisor of P
    not above its square root."""
    c = math.isqrt(p)
    while p % c:
        c -= 1
    return p // c, c


def owner(keys: torch.Tensor, p: int) -> torch.Tensor:
    """The rank that holds each pair key (int64, non-negative): the top
    bits of a 63-bit product of the key's folded low 31 bits, mod P (no
    product overflows)."""
    x = keys ^ (keys >> 31)
    return (((x & 0x7FFFFFFF) * HASH_MUL) >> 32) % p


def all_sum(x: int, device) -> int:
    t = torch.tensor([x], dtype=torch.int64, device=device)
    dist.all_reduce(t)
    return int(t)


def all_max(x: float, device) -> float:
    t = torch.tensor([x], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


@dataclasses.dataclass
class Shard:
    """One rank's share of the reference graph."""

    rank: int
    world: int
    num_vertices: int
    tuples: int  # generated tuples, over every chunk
    keys: torch.Tensor  # (E_r,) int64 u * V + v, sorted, distinct, owner(key) == rank
    src: torch.Tensor  # (E_r,) int32 u
    dst: torch.Tensor  # (E_r,) int32 v

    @property
    def num_edges(self) -> int:
        return self.keys.numel()

    @property
    def vertex_range(self):
        """[lo, hi) of the global vertices whose values the port's rank
        ``rank`` returns (range q = j * R + i of vp, cut at V)."""
        rows, cols = mesh_shape(self.world)
        vp = -(-self.num_vertices // self.world)
        i, j = divmod(self.rank, cols)
        lo = (j * rows + i) * vp
        return min(lo, self.num_vertices), min(lo + vp, self.num_vertices)


def build_shard(chunks, num_vertices: int, symmetrize: bool, rank: int, world: int) -> Shard:
    """This rank's ``Shard`` from the (src, dst) ``chunks`` that every rank
    draws alike."""
    v = num_vertices
    kept, tuples = [], 0
    for s, d in chunks:
        s, d = s.long(), d.long()
        tuples += s.numel()
        k = torch.cat([s * v + d, d * v + s]) if symmetrize else s * v + d
        del s, d
        kept.append(torch.unique(k[owner(k, world) == rank]))
        del k
    every = torch.cat(kept)
    kept.clear()
    keys = torch.unique(every)
    del every
    src = torch.div(keys, v, rounding_mode="floor").to(torch.int32)
    dst = (keys % v).to(torch.int32)
    return Shard(rank, world, v, tuples, keys, src, dst)


@dataclasses.dataclass
class Received:
    """The port's stored pairs that reached their owner: distinct keys
    (sorted), how many arrived more than once, and the count of the
    graph's own facts that break the contract."""

    keys: torch.Tensor
    repeated: int
    bad_facts: int


def exchange_stored(graph, num_vertices: int, symmetric: bool, rank: int, world: int,
                    device):
    """Every stored edge of this rank's part of the port's MGGraph
    ``graph`` (its ``in_block``, majors read from the offsets), as a
    global pair key at the key's owner: (the keys this rank received, the
    count of the graph's facts that break the contract). ``received``
    tallies them once the port's graph is freed."""
    v, (rows, cols) = num_vertices, mesh_shape(world)
    vp = -(-v // world)
    i, j = divmod(rank, cols)
    blk = graph.in_block
    offsets, minors = blk.offsets.long(), blk.minors
    bad = int(graph.num_vertices != v) + int(bool(graph.is_symmetric) != symmetric)
    bad += int(offsets.numel() != cols * vp + 1)
    bad += int(offsets.numel() == 0 or int(offsets[-1]) != minors.numel())
    if bad:
        offsets = torch.zeros(1, dtype=torch.int64, device=device)
        minors = minors[:0]
    local_rounds = -(-minors.numel() // EXCHANGE_EDGES)
    rounds = int(all_max(local_rounds, device))  # every rank takes the same count of rounds
    got = []
    for r in range(rounds):
        lo = min(r * EXCHANGE_EDGES, minors.numel())
        hi = min(lo + EXCHANGE_EDGES, minors.numel())
        pos = torch.arange(lo, hi, dtype=torch.int64, device=device)
        major = torch.searchsorted(offsets, pos, right=True) - 1
        del pos
        dst = (major // vp * rows + i) * vp + major % vp
        del major
        keys = (minors[lo:hi].long() + j * rows * vp) * v + dst
        del dst
        own = owner(keys, world)
        order = torch.argsort(own)
        send = keys[order]
        del keys, order
        send_counts = torch.bincount(own, minlength=world)
        del own
        recv_counts = torch.empty_like(send_counts)
        dist.all_to_all_single(recv_counts, send_counts)
        recv = torch.empty(int(recv_counts.sum()), dtype=torch.int64, device=device)
        dist.all_to_all_single(recv, send, recv_counts.tolist(), send_counts.tolist())
        del send
        got.append(recv)
    every = torch.cat(got) if got else torch.empty(0, dtype=torch.int64, device=device)
    got.clear()
    return every, bad


def received(keys: torch.Tensor, bad_facts: int) -> Received:
    """The ``Received`` of ``exchange_stored``'s keys."""
    distinct, counts = torch.unique(keys, return_counts=True)
    return Received(distinct, int((counts - 1).sum()), bad_facts)


def graph_mismatch(received: Received, shard: Shard, device) -> int:
    """Over every rank: the pairs missing, extra or repeated, plus the
    facts that break the contract (exact: the limit is 0)."""
    found = 0
    if received.keys.numel() and shard.num_edges:
        pos = torch.searchsorted(received.keys, shard.keys).clamp(max=received.keys.numel() - 1)
        found = int((received.keys[pos] == shard.keys).sum())
    missing = shard.num_edges - found
    extra = received.keys.numel() - found
    return all_sum(missing + extra + received.repeated + received.bad_facts, device)


class Facts:
    """What the nominal counts of a query read, over every rank: the
    vertices, the stored (coalesced) edges and the generated tuples."""

    def __init__(self, shard: Shard):
        self.num_vertices = shard.num_vertices
        self.stored_edges = all_sum(shard.num_edges, shard.keys.device)
        self.tuples = shard.tuples
