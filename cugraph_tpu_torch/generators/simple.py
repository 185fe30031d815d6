"""Simple deterministic generators and Erdős–Rényi G(n, p).

Counterpart of ``cugraph_tpu/generators/simple.py`` (ref:
cpp/src/generators/simple_generators.cu, graph_generators.hpp:150-301,
erdos_renyi_generator.cu). Each returns (src, dst) int32 tensors on
``device`` (default the CUDA card, as ``rmat_edgelist``); the edges come
in the JAX package's order. Erdős–Rényi draws on the host with numpy's
``default_rng(seed)``, as the JAX module does, so both packages give the
same edges for a seed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from ..utils.dtypes import VERTEX_DTYPE


def _ids(n: int, dev: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=VERTEX_DTYPE, device=dev)


def path_graph_edgelist(num_vertices: int, *, device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """i -> i + 1 for i < num_vertices - 1."""
    src = _ids(max(num_vertices - 1, 0), resolve_device(device))
    return src, src + 1


def complete_graph_edgelist(num_vertices: int, *, device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every ordered pair (i, j), i != j, in row-major order."""
    ids = _ids(num_vertices, resolve_device(device))
    src, dst = torch.meshgrid(ids, ids, indexing="ij")
    keep = src != dst
    return src[keep], dst[keep]


def mesh_2d_edgelist(x: int, y: int, *, device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D grid of x by y: each vertex to its +x and +y neighbours (all
    +x edges first, then all +y edges)."""
    ids = _ids(x * y, resolve_device(device)).reshape(y, x)
    src = torch.cat([ids[:, :-1].reshape(-1), ids[:-1, :].reshape(-1)])
    dst = torch.cat([ids[:, 1:].reshape(-1), ids[1:, :].reshape(-1)])
    return src, dst


def mesh_3d_edgelist(x: int, y: int, z: int, *, device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """3-D grid: each vertex to its +x, +y and +z neighbours, axis by axis."""
    ids = _ids(x * y * z, resolve_device(device)).reshape(z, y, x)
    pairs = [
        (ids[:, :, :-1], ids[:, :, 1:]),
        (ids[:, :-1, :], ids[:, 1:, :]),
        (ids[:-1, :, :], ids[1:, :, :]),
    ]
    src = torch.cat([p[0].reshape(-1) for p in pairs])
    dst = torch.cat([p[1].reshape(-1) for p in pairs])
    return src, dst


def erdos_renyi_gnp_edgelist(
    num_vertices: int, p: float, seed: int = 0, directed: bool = False,
    *, device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """G(n, p) by a Bernoulli draw per ordered pair from numpy's
    ``default_rng(seed)`` on the host (a small-graph generator, as the
    reference's erdos_renyi_generator.cu); no self-loops; undirected keeps
    the pairs i < j."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    m = rng.random((num_vertices, num_vertices)) < p
    np.fill_diagonal(m, False)
    if not directed:
        m = np.triu(m)
    src, dst = np.nonzero(m)
    return (torch.from_numpy(src.astype(np.int32)).to(dev),
            torch.from_numpy(dst.astype(np.int32)).to(dev))
