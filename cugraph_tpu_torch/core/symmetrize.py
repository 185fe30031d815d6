"""Edge-list symmetrization and de-duplication on the device.

Counterpart of ``cugraph_tpu/core/symmetrize.py`` (ref:
cpp/src/structure/symmetrize_edgelist_impl.cuh). The JAX package does this
on the host in numpy; the port sorts packed (src, dst) keys on the edge
list's device, as ``core/csr.py`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.device import DeviceLike, as_tensor, resolve_device
from ..utils.dtypes import VERTEX_DTYPE, WEIGHT_DTYPE
from ..utils.error import expects

_SCATTER = {"min": "amin", "max": "amax"}


def coalesce_edgelist(
    src,
    dst,
    weight=None,
    reduce: str = "sum",
    *,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Merge parallel (src, dst) duplicates, reducing their weights by
    ``reduce`` ("sum", "min" or "max"). Returns the edges sorted by
    (src, dst), int32 ids and float32 weights, on ``device``."""
    expects(reduce in ("sum", "min", "max"), f"unknown reduce {reduce!r}")
    dev = resolve_device(device)
    src = as_tensor(src, VERTEX_DTYPE, dev)
    dst = as_tensor(dst, VERTEX_DTYPE, dev)
    if weight is not None:
        weight = as_tensor(weight, WEIGHT_DTYPE, dev)
    if src.numel() == 0:
        return src, dst, weight
    n = int(torch.maximum(src.max(), dst.max())) + 1
    key, order = torch.sort(src.to(torch.int64) * n + dst.to(torch.int64), stable=True)
    keep = torch.ones_like(key, dtype=torch.bool)
    keep[1:] = key[1:] != key[:-1]
    usrc, udst = src[order][keep], dst[order][keep]
    if weight is None:
        return usrc, udst, None
    group = torch.cumsum(keep, 0) - 1
    w = weight[order]
    if reduce == "sum":
        out = torch.zeros(usrc.numel(), dtype=WEIGHT_DTYPE, device=dev)
        return usrc, udst, out.index_add_(0, group, w)
    fill = float("inf") if reduce == "min" else float("-inf")
    out = torch.full((usrc.numel(),), fill, dtype=WEIGHT_DTYPE, device=dev)
    return usrc, udst, out.scatter_reduce_(0, group, w, _SCATTER[reduce])


def symmetrize_edgelist(
    src,
    dst,
    weight=None,
    multi: bool = False,
    *,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Union each edge with its reciprocal; self-loops are not doubled.
    Unless ``multi``, duplicates are then coalesced and a reciprocal pair
    keeps the smaller weight (the reference's symmetrize-by-union)."""
    dev = resolve_device(device)
    src = as_tensor(src, VERTEX_DTYPE, dev)
    dst = as_tensor(dst, VERTEX_DTYPE, dev)
    loops = src == dst
    s2 = torch.cat([src, dst[~loops]])
    d2 = torch.cat([dst, src[~loops]])
    w2 = None
    if weight is not None:
        weight = as_tensor(weight, WEIGHT_DTYPE, dev)
        w2 = torch.cat([weight, weight[~loops]])
    if multi:
        return s2, d2, w2
    return coalesce_edgelist(s2, d2, w2, reduce="min", device=dev)
