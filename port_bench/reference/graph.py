"""The reference graph: the generated tuples symmetrized and coalesced, in
plain torch, the judge of the port's ingest; and the facts that the
nominal counts of a query read (connected components, their tuples, stored
edges and vertices).

Stored edges: every tuple (u, v) and its reciprocal (v, u), each distinct
ordered pair once, a self-loop (u, u) once; sorted by (u, v). That is the
graph ``from_edgelist(..., symmetrize=True)`` promises.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

CHUNK = 1 << 27  # edges a step of a sweep over the stored edges, to bound its scratch


@dataclasses.dataclass
class RefGraph:
    num_vertices: int
    keys: torch.Tensor  # (E,) int64 u * V + v, sorted, distinct
    src: torch.Tensor  # (E,) int32 u
    dst: torch.Tensor  # (E,) int32 v
    offsets: torch.Tensor  # (V + 1,) int64

    @property
    def num_edges(self) -> int:
        return self.keys.numel()

    def degrees(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]

    def has_edges(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """(u, v) is a stored edge, elementwise; u and v int64 in range."""
        q = u * self.num_vertices + v
        pos = torch.searchsorted(self.keys, q).clamp(max=self.num_edges - 1)
        return self.keys[pos] == q


def build(src_in: torch.Tensor, dst_in: torch.Tensor, num_vertices: int) -> RefGraph:
    v = num_vertices
    s, d = src_in.long(), dst_in.long()
    keys = torch.unique(torch.cat([s * v + d, d * v + s]))
    del s, d
    src = torch.div(keys, v, rounding_mode="floor").to(torch.int32)
    dst = (keys % v).to(torch.int32)
    offsets = torch.zeros(v + 1, dtype=torch.int64, device=keys.device)
    offsets[1:] = torch.cumsum(torch.bincount(src, minlength=v), 0)
    return RefGraph(v, keys, src, dst, offsets)


def graph_mismatch(graph, ref: RefGraph) -> int:
    """How far the port's graph is from the reference: 1 for each of its
    vertex count, edge count and symmetry that differ, else the count of
    its adjacency's offsets, minors and majors that differ (exact: the
    limit is 0)."""
    adj = graph.csr()
    bad = int(graph.num_vertices != ref.num_vertices) + int(not graph.is_symmetric)
    bad += int(graph.num_edges != ref.num_edges) + int(adj.num_edges != ref.num_edges)
    if bad:
        return bad
    bad += int((adj.offsets.long() != ref.offsets).sum())
    bad += int((adj.minors != ref.dst).sum())
    bad += int((adj.majors != ref.src).sum())
    return bad


def components(ref: RefGraph) -> torch.Tensor:
    """Connected-component labels (the smallest vertex id of each), by
    min-label hooking over every stored edge and pointer jumping."""
    v = ref.num_vertices
    lab = torch.arange(v, dtype=torch.int32, device=ref.keys.device)
    while True:
        new = lab.clone()
        for i in range(0, ref.num_edges, CHUNK):
            d = ref.dst[i:i + CHUNK].long()
            new.scatter_reduce_(0, d, lab.index_select(0, ref.src[i:i + CHUNK]), "amin")
        while True:
            jumped = new.index_select(0, new)
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, lab):
            return lab
        lab = new


class Facts:
    """What the nominal counts of a query read: the graph's sizes, and for
    each connected component (indexed by its label) its generated tuples
    (loops and repeats counted), its stored edges and its vertices. The
    components are labelled at first use: PageRank's counts read none."""

    def __init__(self, ref: RefGraph, src_in: torch.Tensor):
        self.ref, self.src_in = ref, src_in
        self.num_vertices = ref.num_vertices
        self.stored_edges = ref.num_edges
        self.tuples = src_in.numel()

    @functools.cached_property
    def labels(self) -> torch.Tensor:
        return components(self.ref)

    @functools.cached_property
    def comp_tuples(self) -> torch.Tensor:
        ids = self.labels.index_select(0, self.src_in).long()
        return torch.bincount(ids, minlength=self.num_vertices)

    @functools.cached_property
    def comp_edges(self) -> torch.Tensor:
        lab = self.labels.long()
        return torch.zeros_like(lab).index_add_(0, lab, self.ref.degrees())

    @functools.cached_property
    def comp_vertices(self) -> torch.Tensor:
        return torch.bincount(self.labels.long(), minlength=self.num_vertices)

    def per_root(self, table: torch.Tensor, roots) -> list:
        """table[label of root] for each root, on the host."""
        idx = torch.as_tensor(list(roots), dtype=torch.int64, device=self.labels.device)
        return table.index_select(0, self.labels.index_select(0, idx).long()).tolist()
