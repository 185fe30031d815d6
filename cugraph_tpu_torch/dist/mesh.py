"""Process mesh over torch.distributed: one process per card.

Counterpart of ``cugraph_tpu/dist/mesh.py``. The JAX package lays its
devices on a 2-D ``jax.sharding.Mesh`` with axes ("row", "col") and names
an axis in each collective. Here every rank is one process on one device,
and ``Mesh2D`` carries the two process groups that stand for the axes
(the reference's row/col subcomms, partition_manager.hpp:68-105):

- ``row_group``: the ranks of this rank's mesh column (same j, group rank
  i), JAX's "row" axis: the src-side all-gather runs over it;
- ``col_group``: the ranks of this rank's mesh row (same i, group rank
  j), JAX's "col" axis: the merge of dst partials runs over it.

Rank = i * cols + j, the order of ``np.asarray(devices).reshape(r, c)``.
NCCL joins the cards; gloo runs the same code on the CPU for the tests.
Each collective here is a span named for its operation
(``cgt/collective.all_gather``, ``.reduce_scatter``, ``.all_reduce``;
``utils/timer.py``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device
from ..utils.error import expects
from ..utils.timer import spanned


# torch 2.13 renamed the tensor-in, tensor-out collectives; older releases
# have only the first names
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


@spanned("cgt/collective.all_gather")
def all_gather_rows(t: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Every group member's ``t``, concatenated along dim 0 in group-rank
    order (the world when ``group`` is None)."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    _all_gather(out, t, group=group)
    return out


@spanned("cgt/collective.reduce_scatter")
def reduce_scatter_rows(
    t: torch.Tensor, op: dist.ReduceOp, group: dist.ProcessGroup
) -> torch.Tensor:
    """Reduce ``t`` over the group by ``op`` and keep this member's slice
    of dim 0: slice k goes to group rank k."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    out = torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    _reduce_scatter(out, t, op=op, group=group)
    return out


@spanned("cgt/collective.all_reduce")
def all_reduce(
    t: torch.Tensor, op: dist.ReduceOp = dist.ReduceOp.SUM,
    group: Optional[dist.ProcessGroup] = None,
) -> torch.Tensor:
    """Reduce ``t`` in place over the group (the world when ``group`` is
    None) by ``op``; returns ``t``."""
    dist.all_reduce(t, op=op, group=group)
    return t


def mesh_shape_for(n_devices: int) -> Tuple[int, int]:
    """Near-square (rows, cols) factorization, rows >= cols: the
    reference's default prows = sqrt(P) policy (dask/comms/comms.py
    subcomm_init)."""
    c = int(math.isqrt(n_devices))
    while n_devices % c:
        c -= 1
    return n_devices // c, c


def _rank_device(device: DeviceLike) -> torch.device:
    """``device=None`` (or a bare "cuda") is this process's card,
    ``cuda:{LOCAL_RANK}``; without CUDA it raises."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """This rank's place on an (rows, cols) process mesh."""

    rows: int
    cols: int
    i: int  # mesh row of this rank
    j: int  # mesh column of this rank
    device: torch.device
    row_group: dist.ProcessGroup  # same j, group rank i (JAX axis "row")
    col_group: dist.ProcessGroup  # same i, group rank j (JAX axis "col")

    @property
    def shape(self) -> Tuple[int, int]:
        return self.rows, self.cols


def initialize_distributed(
    backend: Optional[str] = None,
    device: DeviceLike = None,
    *,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> torch.device:
    """Join the process group and return this rank's device.

    backend defaults to NCCL on a card and gloo on the CPU; init_method,
    world_size and rank default to torch's ``env://`` variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). A no-op, apart from
    binding the card, if the group is already up. Unlike the JAX
    package's version, errors of the bootstrap are raised, not swallowed.
    """
    dev = _rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method,
        **kwargs,
    )
    return dev


def make_mesh(
    shape: Optional[Tuple[int, int]] = None, device: DeviceLike = None
) -> Mesh2D:
    """A (rows, cols) mesh over every rank of the process group (default:
    ``mesh_shape_for(world_size)``). Every rank must call it, with the
    same shape: it creates every row and column group, in one order."""
    dev = _rank_device(device)
    expects(dist.is_initialized(), "call initialize_distributed first")
    world = dist.get_world_size()
    r, c = mesh_shape_for(world) if shape is None else shape
    expects(r >= 1 and c >= 1 and r * c == world,
            f"mesh shape {(r, c)} does not cover the {world} ranks")
    i, j = divmod(dist.get_rank(), c)
    row_groups = [dist.new_group([ii * c + jj for ii in range(r)]) for jj in range(c)]
    col_groups = [dist.new_group([i_ * c + jj for jj in range(c)]) for i_ in range(r)]
    return Mesh2D(rows=r, cols=c, i=i, j=j, device=dev,
                  row_group=row_groups[j], col_group=col_groups[i])


def make_global_mesh(
    shape: Optional[Tuple[int, int]] = None, device: DeviceLike = None
) -> Mesh2D:
    """A mesh over every rank, shaped as the JAX package shapes its global
    mesh: (LOCAL_WORLD_SIZE, nodes) when the ranks span several nodes of
    more than one card each, else ``mesh_shape_for(world_size)``."""
    device = _rank_device(device)
    if shape is None:
        expects(dist.is_initialized(), "call initialize_distributed first")
        n = dist.get_world_size()
        n_local = max(int(os.environ.get("LOCAL_WORLD_SIZE", 1)), 1)
        if n > n_local > 1 and n % n_local == 0:
            shape = (n_local, n // n_local)
        else:
            shape = mesh_shape_for(n)
    return make_mesh(shape, device=device)
