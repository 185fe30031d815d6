"""Degree-descending renumbering of integer vertex ids in [0, V).

Counterpart of ``cugraph_tpu/core/renumber.py`` (``compute_renumber_map``,
``apply_renumber_map``), which follows the reference's
``renumber_edgelist_impl.cuh:96``: new id 0 has the highest total degree,
so heavy rows come first. Here the degree histogram and the stable sort run
on the tensors' device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.device import DeviceLike, as_tensor, resolve_device
from ..utils.dtypes import VERTEX_DTYPE


def compute_renumber_map(
    src, dst, num_vertices: Optional[int] = None, *, device: DeviceLike = None
) -> torch.Tensor:
    """Returns ``new_to_old`` (int32): position i holds the old id of new
    vertex i. Total degree is in-degree plus out-degree; the sort is
    descending and stable, so ties keep the old id order."""
    dev = resolve_device(device)
    src = as_tensor(src, torch.int64, dev)
    dst = as_tensor(dst, torch.int64, dev)
    if num_vertices is None:
        num_vertices = int(max(src.max(), dst.max()).item()) + 1 if src.numel() else 0
    deg = torch.bincount(src, minlength=num_vertices) + torch.bincount(
        dst, minlength=num_vertices
    )
    _, new_to_old = torch.sort(deg, descending=True, stable=True)
    return new_to_old.to(VERTEX_DTYPE)


def apply_renumber_map(
    new_to_old, *vertex_arrays, device: DeviceLike = None
) -> Tuple[torch.Tensor, ...]:
    """Map old ids -> new ids in each array (inverse permutation lookup)."""
    dev = resolve_device(device)
    new_to_old = as_tensor(new_to_old, torch.int64, dev)
    old_to_new = torch.empty_like(new_to_old, dtype=VERTEX_DTYPE)
    old_to_new[new_to_old] = torch.arange(
        new_to_old.numel(), dtype=VERTEX_DTYPE, device=dev
    )
    return tuple(old_to_new[as_tensor(a, torch.int64, dev)] for a in vertex_arrays)
