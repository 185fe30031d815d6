"""Minibatch neighbor loaders for GNN training.

Counterpart of ``cugraph_tpu/gnn/loader.py`` (ref:
python/cugraph/cugraph/gnn/pyg_extensions/loader/neighbor_loader.py and
link_neighbor_loader.py): iterate seed batches, sample multi-hop
neighbourhoods, emit each as a block with a compact id space.

The JAX package renumbers each block on the host in numpy; the port does
it on the graph's device (``_build_block``), in the same order. Draws
come from a ``torch.Generator`` where the JAX package splits a PRNG key;
the shuffle order still comes from numpy's ``default_rng(seed)``, so both
packages visit the seeds in the same batches.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..core.csr import Graph, from_edgelist
from ..sampling.uniform_neighbor_sample import uniform_neighbor_sample
from ..utils.device import as_tensor, resolve_device
from ..utils.dtypes import VERTEX_DTYPE


@dataclasses.dataclass
class SampledBlock:
    """One minibatch: the compact subgraph and its id maps, on the
    graph's device."""

    graph: Graph  # compact-id subgraph (directed src->dst as sampled)
    n_ids: torch.Tensor  # (n_local,) int32: global id of each compact id
    seed_ids: torch.Tensor  # (batch,) int32 global seed ids (compact ids 0..batch-1)
    num_seeds: int


class NeighborLoader:
    """Iterates seed batches -> multi-hop sampled blocks.

    generator: a ``torch.Generator`` on the graph's device for the
    sampler's draws (None: one seeded with ``seed``). ``seed`` also seeds
    numpy's generator for the shuffle, as in the JAX package.
    """

    def __init__(
        self,
        graph: Graph,
        seeds,
        num_neighbors: Sequence[int],
        batch_size: int = 512,
        *,
        shuffle: bool = False,
        with_replacement: bool = False,
        generator: Optional[torch.Generator] = None,
        seed: int = 0,
    ):
        dev = resolve_device(graph.device)
        self.graph = graph
        self.seeds = as_tensor(seeds, VERTEX_DTYPE, dev).reshape(-1)
        self.num_neighbors = list(num_neighbors)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.with_replacement = with_replacement
        self.generator = (
            generator if generator is not None
            else torch.Generator(device=dev).manual_seed(seed)
        )
        self._np_rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return -(-self.seeds.numel() // self.batch_size)

    def __iter__(self) -> Iterator[SampledBlock]:
        for batch in self._seed_batches():
            yield self._build_block(batch, self._sample(batch))

    def _seed_batches(self) -> Iterator[torch.Tensor]:
        """One epoch's seed batches, shuffled by numpy's generator."""
        n = self.seeds.numel()
        order = self._np_rng.permutation(n) if self.shuffle else np.arange(n)
        order = torch.from_numpy(order).to(self.seeds.device)
        for lo in range(0, n, self.batch_size):
            yield self.seeds[order[lo: lo + self.batch_size]]

    def _sample(self, batch: torch.Tensor) -> dict:
        """The batch's multi-hop sample, drawn from the loader's generator."""
        return uniform_neighbor_sample(
            self.graph,
            batch,
            self.num_neighbors,
            with_replacement=self.with_replacement,
            generator=self.generator,
        )

    def _build_block(self, batch: torch.Tensor, res) -> SampledBlock:
        """Renumber the sampled edges to compact ids, seeds first (PyG's
        n_id convention), in the JAX package's order: the batch's seeds
        take [0, batch) in batch order, the other ids of the sorted unique
        set follow in ascending order. A batch holding a seed twice raises
        ValueError: no compact map puts it at two ids (the JAX package's
        numpy assignment raises a shape mismatch there)."""
        dev = self.graph.device
        batch = as_tensor(batch, VERTEX_DTYPE, dev).reshape(-1)
        srcs, dsts = res["sources"], res["destinations"]
        b, ns = batch.numel(), srcs.numel()
        n_ids, inv = torch.unique(
            torch.cat([batch, srcs.to(VERTEX_DTYPE), dsts.to(VERTEX_DTYPE)]),
            sorted=True, return_inverse=True,
        )
        n = n_ids.numel()
        seed_pos = inv[:b]
        is_seed = torch.zeros(n, dtype=torch.bool, device=dev)
        is_seed[seed_pos] = True
        if int(is_seed.sum()) != b:
            raise ValueError("a batch holds a seed vertex more than once")
        perm = torch.empty(n, dtype=torch.int64, device=dev)
        perm[seed_pos] = torch.arange(b, device=dev)
        perm[~is_seed] = torch.arange(b, n, device=dev)
        n_ids_ordered = torch.empty_like(n_ids)
        n_ids_ordered[perm] = n_ids
        g = from_edgelist(
            perm[inv[b: b + ns]],
            perm[inv[b + ns:]],
            res["weights"],
            num_vertices=n,
            device=dev,
        )
        return SampledBlock(graph=g, n_ids=n_ids_ordered, seed_ids=batch, num_seeds=b)


class LinkNeighborLoader(NeighborLoader):
    """Edge-pair variant (ref link_neighbor_loader.py): the seeds are the
    sorted unique endpoints of the (n, 2) pairs; blocks sample around
    both endpoints."""

    def __init__(self, graph: Graph, edge_pairs, num_neighbors, **kw):
        dev = resolve_device(graph.device)
        pairs = as_tensor(edge_pairs, VERTEX_DTYPE, dev)
        super().__init__(graph, torch.unique(pairs.reshape(-1)), num_neighbors, **kw)
        self.edge_pairs = pairs
