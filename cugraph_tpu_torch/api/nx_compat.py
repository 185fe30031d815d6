"""NetworkX interop.

Counterpart of ``cugraph_tpu/api/nx_compat.py`` (ref:
python/cugraph/cugraph/utilities/nx_factory.py: convert_from_nx :76,
cugraph_to_nx :179, df_score_to_dictionary :109; utilities/utils.py
ensure_cugraph_obj_for_nx): every public algorithm accepts nx graphs and
returns nx-typed results. An nx graph is converted onto ``device``, which
follows the device rule: ``None`` is the card.
"""

from __future__ import annotations

from typing import Tuple

import pandas as pd

from ..utils.device import DeviceLike
from .graph import Graph


def from_networkx(nx_graph, weight: str = "weight", device: DeviceLike = None) -> Graph:
    directed = nx_graph.is_directed()
    g = Graph(directed=directed, device=device)
    edges = list(nx_graph.edges(data=True))
    if not edges:
        raise ValueError("empty networkx graph")
    src = [e[0] for e in edges]
    dst = [e[1] for e in edges]
    has_w = any(weight in e[2] for e in edges)
    df = pd.DataFrame({"source": src, "destination": dst})
    attr = None
    if has_w:
        df["weight"] = [float(e[2].get(weight, 1.0)) for e in edges]
        attr = "weight"
    g.from_pandas_edgelist(df, edge_attr=attr)
    return g


def to_networkx(g: Graph):
    import networkx as nx

    G = nx.DiGraph() if g.directed else nx.Graph()
    df = g.edges()
    if "weight" in df:
        G.add_weighted_edges_from(zip(df["src"], df["dst"], df["weight"]))
    else:
        G.add_edges_from(zip(df["src"], df["dst"]))
    return G


def ensure_graph(G, device: DeviceLike = None) -> Tuple[Graph, bool]:
    """Accept api.Graph or networkx graphs (ref ensure_cugraph_obj_for_nx).
    Returns (graph, whether G came from networkx); an api.Graph keeps its
    own device, an nx graph is converted onto ``device``."""
    if isinstance(G, Graph):
        return G, False
    try:
        import networkx as nx

        if isinstance(G, (nx.Graph, nx.DiGraph)):
            return from_networkx(G, device=device), True
    except ImportError:
        pass
    raise TypeError(f"unsupported graph type {type(G)!r}")


def maybe_dict(df: pd.DataFrame, value_col: str, is_nx: bool):
    """ref: df_score_to_dictionary — nx inputs get dict outputs."""
    if not is_nx:
        return df
    return dict(zip(df["vertex"], df[value_col]))
