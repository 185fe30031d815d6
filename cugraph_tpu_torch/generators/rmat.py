"""R-MAT recursive-bisection generator and Graph500 vertex scrambling.

Counterpart of ``cugraph_tpu/generators/rmat.py`` (ref:
cpp/src/generators/generate_rmat_edgelist.cu, scramble.cuh). Every edge
draws its quadrant bits in parallel, one Bernoulli pair per bit position,
from a ``torch.Generator`` on the output device. The draws follow the JAX
package's rule but not its bits (torch's Philox is not JAX's threefry).
"""

from __future__ import annotations

from typing import Optional, Tuple

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
    scramble: bool = False,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate an R-MAT edge list with 2^scale vertices.

    generator: a ``torch.Generator`` on ``device``; default one seeded 0.
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
