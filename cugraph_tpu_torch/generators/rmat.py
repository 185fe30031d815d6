"""R-MAT recursive-bisection generator and Graph500 vertex scrambling.

Counterpart of ``cugraph_tpu/generators/rmat.py`` (ref:
cpp/src/generators/generate_rmat_edgelist.cu, scramble.cuh). Every edge
draws its quadrant bits in parallel, one Bernoulli pair per bit position,
from a ``torch.Generator`` on the output device. The draws follow the JAX
package's rule but not its bits (torch's Philox is not JAX's threefry).

``mg_rmat_edgelist`` is the multi-card generator: the JAX package draws
one shard per device, with the device index folded into the key, into
one sharded array. The port runs one process per card, and every rank
streams the same chunks into ``distribute_edgelist_chunks``; so shard d is
drawn from a generator seeded by (seed, d), on the rank's device, when a
rank asks for it (``rmat_chunk_source``): no host holds the global edge
list, and no rank waits on another.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Tuple

import torch

from ..utils.device import DeviceLike, resolve_device


def rmat_edgelist(
    scale: int,
    num_edges: int,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    *,
    generator: Optional[torch.Generator] = None,
    clip_and_flip: bool = False,
    scramble: bool = False,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate an R-MAT edge list with 2^scale vertices.

    generator: a ``torch.Generator`` on ``device``; default one seeded 0.
    clip_and_flip: keep only the lower triangle by swapping (src, dst)
    where src < dst (ref graph_generators.hpp), before any scramble.
    scramble: apply ``scramble_vertex_ids`` to both ends.
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    a, b, c = f32(a), f32(b), f32(c)
    d = 1.0 - a - b - c
    # P(src_bit = 1) = c + d; P(dst_bit = 1) is b / (a + b) after src_bit 0
    # and d / (c + d) after src_bit 1
    p_src1 = c + d
    p_dst1_given0 = b / (a + b)
    p_dst1_given1 = d / torch.clamp(c + d, min=1e-12)
    dtype = torch.int64 if scale > 31 else torch.int32
    src = torch.zeros(num_edges, dtype=dtype, device=dev)
    dst = torch.zeros_like(src)
    for _ in range(scale):
        u1 = torch.rand(num_edges, generator=generator, device=dev)
        u2 = torch.rand(num_edges, generator=generator, device=dev)
        sbit = u1 < p_src1
        dbit = u2 < torch.where(sbit, p_dst1_given1, p_dst1_given0)
        src = (src << 1) | sbit.to(dtype)
        dst = (dst << 1) | dbit.to(dtype)
    if clip_and_flip:
        src, dst = torch.maximum(src, dst), torch.minimum(src, dst)
    if scramble:
        src = scramble_vertex_ids(src, scale)
        dst = scramble_vertex_ids(dst, scale)
    return src, dst


def scramble_vertex_ids(ids: torch.Tensor, scale: int) -> torch.Tensor:
    """Bijective bit mix of [0, 2^scale) ids, the same rounds as the JAX
    package's (odd multiply mod 2^scale, then an xorshift).

    The JAX package multiplies in uint32; the low ``scale`` bits of that
    product equal those of the int64 product here, so both give the same
    permutation for scale <= 31."""
    mask = (1 << scale) - 1
    x = ids.to(torch.int64)
    for mult, shift in ((0x9E3779B1, 7), (0x85EBCA77, 11)):
        x = (x * mult) & mask
        x = x ^ (x >> shift)
        x = x & mask
    return x.to(ids.dtype)


def shard_seed(seed: int, shard: int) -> int:
    """The seed of shard ``shard``: (seed, shard) through the splitmix64
    finalizer, cut to 63 bits (``torch.Generator.manual_seed`` takes a
    signed 64-bit seed). Distinct shards of a seed get distinct seeds."""
    mask = (1 << 64) - 1
    x = ((seed & mask) * 0x9E3779B97F4A7C15 + shard + 1) & mask
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
    return (x ^ (x >> 31)) >> 1


@dataclasses.dataclass(frozen=True)
class RmatShards:
    """The edge shards of ``mg_rmat_edgelist``: ``len(shards)`` shards of
    ``shard_edges`` edges each, one per mesh position in rank order
    (i * cols + j). ``shard(d)`` draws shard d on ``device`` with
    ``rmat_edgelist`` from a generator seeded ``shard_seed(seed, d)``; the
    same arguments give the same edges on every rank."""

    scale: int
    shard_edges: int
    a: float
    b: float
    c: float
    seed: int
    scramble: bool
    mesh_shape: Tuple[int, int]
    device: torch.device

    def __len__(self) -> int:
        return self.mesh_shape[0] * self.mesh_shape[1]

    @property
    def shape(self) -> Tuple[int, int, int]:
        """(rows, cols, shard_edges), the JAX function's array shape."""
        return self.mesh_shape + (self.shard_edges,)

    def shard(self, d: int) -> Tuple[torch.Tensor, torch.Tensor]:
        if not 0 <= d < len(self):
            raise IndexError(f"shard {d} of {len(self)}")
        gen = torch.Generator(device=self.device).manual_seed(shard_seed(self.seed, d))
        return rmat_edgelist(self.scale, self.shard_edges, self.a, self.b, self.c,
                             generator=gen, scramble=self.scramble, device=self.device)


def mg_rmat_edgelist(
    mesh,
    scale: int,
    num_edges: int,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    *,
    seed: int = 0,
    scramble: bool = False,
) -> RmatShards:
    """R-MAT edges in one shard per mesh position, ceil(num_edges / ranks)
    edges each, drawn on ``mesh.device`` when asked for (ref:
    generate_rmat_edgelist.cu is likewise per rank). Feed the result to
    ``rmat_chunk_source`` for ``distribute_edgelist_chunks``.

    Where the JAX function takes ``rng_key`` and folds the device index
    into it, this one takes ``seed`` and seeds shard d with
    ``shard_seed(seed, d)``."""
    dev = resolve_device(mesh.device)
    rows, cols = mesh.shape
    return RmatShards(scale=int(scale), shard_edges=-(-int(num_edges) // (rows * cols)),
                      a=float(a), b=float(b), c=float(c), seed=int(seed),
                      scramble=bool(scramble), mesh_shape=(rows, cols), device=dev)


def rmat_chunk_source(
    shards: RmatShards,
) -> Callable[[], Iterator[Tuple[torch.Tensor, torch.Tensor]]]:
    """Zero-argument callable yielding one (src, dst) chunk per shard, in
    shard order, each drawn when it is asked for: the ChunkSource of
    ``distribute_edgelist_chunks``. One shard is resident at a time."""

    def chunks():
        for d in range(len(shards)):
            yield shards.shard(d)

    return chunks
