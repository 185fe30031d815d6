"""GraphSAGE and GCN as ``nn.Module``s over the SpMM aggregation.

Counterpart of ``cugraph_tpu/gnn/models.py`` (flax). Each flax ``nn.Dense``
is an ``nn.Linear``; ``graphsage_from_flax`` and ``gcn_from_flax`` load a
flax parameter tree (nested dicts of numpy arrays) into a module, turning
each flax kernel (in, out) into a torch weight (out, in).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..core.csr import Graph
from ..utils.device import DeviceLike, resolve_device
from .aggregators import gcn_aggregate, spmm_aggregate


class SAGEConv(nn.Module):
    """h = W_self x + W_nbr mean(x over incoming neighbours)."""

    def __init__(self, in_features: int, out_features: int, *, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.lin_self = nn.Linear(in_features, out_features, device=dev)
        self.lin_nbr = nn.Linear(in_features, out_features, device=dev)

    def forward(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        nbr = spmm_aggregate(g, x, op="mean")
        return self.lin_self(x) + self.lin_nbr(nbr)


class GraphSAGE(nn.Module):
    """N-layer GraphSAGE (mean aggregator) node embedder; the output rows
    are L2-normalized."""

    def __init__(self, in_features: int, hidden_features: int = 128,
                 out_features: int = 64, num_layers: int = 2,
                 *, device: DeviceLike = None):
        super().__init__()
        widths = [in_features] + [hidden_features] * (num_layers - 1) + [out_features]
        self.convs = nn.ModuleList(
            SAGEConv(widths[i], widths[i + 1], device=device)
            for i in range(num_layers)
        )

    def forward(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs[:-1]:
            x = torch.relu(conv(g, x))
        x = self.convs[-1](g, x)
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


class GCN(nn.Module):
    """Kipf-Welling GCN with symmetric normalization."""

    def __init__(self, in_features: int, hidden_features: int = 128,
                 out_features: int = 64, num_layers: int = 2,
                 *, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        widths = [in_features] + [hidden_features] * (num_layers - 1) + [out_features]
        self.dense = nn.ModuleList(
            nn.Linear(widths[i], widths[i + 1], device=dev) for i in range(num_layers)
        )

    def forward(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        for lin in self.dense[:-1]:
            x = torch.relu(lin(gcn_aggregate(g, x)))
        return self.dense[-1](gcn_aggregate(g, x))


def _load_dense(lin: nn.Linear, p: Mapping) -> None:
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.array(p["kernel"], dtype=np.float32).T))
        lin.bias.copy_(torch.from_numpy(np.array(p["bias"], dtype=np.float32)))


def _layers(params: Mapping) -> Mapping:
    return params["params"] if "params" in params else params


def graphsage_from_flax(params: Mapping, in_features: int, hidden_features: int = 128,
                        out_features: int = 64, num_layers: int = 2,
                        *, device: DeviceLike = None) -> GraphSAGE:
    """A GraphSAGE loaded from the flax tree of ``cugraph_tpu.gnn.GraphSAGE``
    (``params["params"]["conv0"]["self"]["kernel"]`` and so on)."""
    model = GraphSAGE(in_features, hidden_features, out_features, num_layers, device=device)
    tree = _layers(params)
    for i, conv in enumerate(model.convs):
        _load_dense(conv.lin_self, tree[f"conv{i}"]["self"])
        _load_dense(conv.lin_nbr, tree[f"conv{i}"]["nbr"])
    return model


def gcn_from_flax(params: Mapping, in_features: int, hidden_features: int = 128,
                  out_features: int = 64, num_layers: int = 2,
                  *, device: DeviceLike = None) -> GCN:
    """A GCN loaded from the flax tree of ``cugraph_tpu.gnn.GCN``
    (``params["params"]["dense0"]["kernel"]`` and so on)."""
    model = GCN(in_features, hidden_features, out_features, num_layers, device=device)
    tree = _layers(params)
    for i, lin in enumerate(model.dense):
        _load_dense(lin, tree[f"dense{i}"])
    return model
