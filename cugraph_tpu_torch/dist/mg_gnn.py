"""Distributed GraphSAGE forward: the multi-GPU GNN path.

Counterpart of ``cugraph_tpu/dist/mg_gnn.py`` (``init_sage_params``,
``mg_sage_forward``). The sparse aggregation is ``mg_spmm_aggregate``
(an all-gather over the mesh column, ``spmm_rows`` per rank, a
reduce-scatter over the mesh row); the dense layers are plain matrix
products on each rank's (vp, F) rows, with the parameters replicated.
``sage_params_from_jax`` carries the JAX package's parameters over.
The training step (``make_sage_train_step``) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from ..utils.dtypes import WEIGHT_DTYPE
from .mesh import Mesh2D
from .mg_algos import mg_spmm_aggregate
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
