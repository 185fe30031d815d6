"""Distributed GraphSAGE forward and training step: the multi-GPU GNN path.

Counterpart of ``cugraph_tpu/dist/mg_gnn.py`` (``init_sage_params``,
``mg_sage_forward``, ``make_sage_train_step``). The sparse aggregation is
``mg_spmm_aggregate`` (an all-gather over the mesh column, ``spmm_rows``
per rank, a reduce-scatter over the mesh row; its backward trades the
two collectives' places and runs over ``out_block``); the dense layers
are plain matrix products on each rank's (vp, F) rows, with the
parameters replicated. ``sage_params_from_jax`` carries the JAX
package's parameters over.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device
from ..utils.dtypes import WEIGHT_DTYPE
from .mesh import Mesh2D
from .mg_algos import _local_ids, mg_spmm_aggregate
from .mg_graph import MGGraph

SAGE_PARAMS = ("w_self1", "w_nbr1", "w_self2", "w_nbr2")


def init_sage_params(
    generator: torch.Generator,
    in_features: int,
    hidden: int,
    out_features: int,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """Normal weights scaled by 1/sqrt(2 * fan_in), as the JAX package
    draws them, from ``generator`` (the numbers differ from jax.random's)."""
    dev = resolve_device(device)
    s1 = 1.0 / np.sqrt(2 * in_features)
    s2 = 1.0 / np.sqrt(2 * hidden)
    shapes = {
        "w_self1": ((in_features, hidden), s1),
        "w_nbr1": ((in_features, hidden), s1),
        "w_self2": ((hidden, out_features), s2),
        "w_nbr2": ((hidden, out_features), s2),
    }
    return {
        name: (torch.randn(shape, generator=generator, dtype=WEIGHT_DTYPE,
                           device=generator.device) * scale).to(dev)
        for name, (shape, scale) in shapes.items()
    }


def sage_params_from_jax(params_np: Mapping, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter dict (arrays, e.g. numpy) as the port's
    dict of f32 tensors on ``device``."""
    dev = resolve_device(device)
    return {
        name: torch.as_tensor(np.asarray(params_np[name], dtype=np.float32)).to(dev)
        for name in SAGE_PARAMS
    }


def mg_sage_forward(
    mesh: Mesh2D, mgg: MGGraph, params: Mapping[str, torch.Tensor], feats: torch.Tensor
) -> torch.Tensor:
    """2-layer mean-aggregate GraphSAGE on this rank's (vp, F) features."""
    agg = mg_spmm_aggregate(mesh, mgg, feats, op="mean")
    h = torch.relu(feats @ params["w_self1"] + agg @ params["w_nbr1"])
    agg2 = mg_spmm_aggregate(mesh, mgg, h, op="mean")
    return h @ params["w_self2"] + agg2 @ params["w_nbr2"]


def make_sage_train_step(
    mesh: Mesh2D, mgg: MGGraph, lr: float = 1e-2
) -> Callable[[Mapping[str, torch.Tensor], torch.Tensor, torch.Tensor],
              Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    """Returns train_step(params, feats, targets) -> (params, loss).

    feats and targets are this rank's (vp, F) and (vp, out) rows; params
    the replicated dict. One step: ``mg_sage_forward``, the masked MSE
    over the global vertices (the padded tail past V left out, divided by
    the global count V), its backward, and plain SGD, p - lr * g, as the
    JAX package applies it. Where XLA inserts the psum of the replicated
    parameters' gradients, the port all-reduces them (SUM) over the
    world, with the rank's share of the loss in the same call. Only the
    parameters take a gradient, so a step launches ``spmm_rows`` three
    times on a card: twice forward over ``in_block``, once backward over
    ``out_block`` (the second layer's aggregation). Every rank must call
    it, with the same params."""
    _, vmask = _local_ids(mesh, mgg)
    mask = vmask.to(WEIGHT_DTYPE)[:, None]
    count = float(max(mgg.num_vertices, 1))  # the global mask's sum

    def train_step(params, feats, targets):
        leaves = {k: params[k].detach().requires_grad_() for k in SAGE_PARAMS}
        with torch.enable_grad():
            out = mg_sage_forward(mesh, mgg, leaves, feats)
            loss = (((out - targets) ** 2) * mask).sum() / count
            grads = torch.autograd.grad(loss, [leaves[k] for k in SAGE_PARAMS])
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
        dist.all_reduce(flat)
        new, lo = {}, 0
        for k in SAGE_PARAMS:
            p = leaves[k].detach()
            new[k] = p - lr * flat[lo:lo + p.numel()].view_as(p)
            lo += p.numel()
        return new, flat[lo]

    return train_step
