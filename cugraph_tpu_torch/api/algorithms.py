"""Dataframe-typed algorithm wrappers over api.Graph: the cugraph-Python UX.

Counterpart of ``cugraph_tpu/api/algorithms.py`` (ref:
python/cugraph/cugraph/{link_analysis/pagerank.py:61, traversal/bfs.py,
community/louvain.py, ...}). Every function accepts an api.Graph or a
networkx graph (converted onto ``device``, which follows the device rule;
results then come back as dicts, as the reference's
utilities/nx_factory.py does). Each wrapper calls the port's algorithm on
``G.core`` and adds only the id translation and the frame, so its values
are the core function's. Draws (``uniform_neighbor_sample``,
``random_walks``, ``node2vec``) come from a ``torch.Generator`` on the
graph's device, seeded 0 unless one is passed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd

from ..algos import centrality as _centrality
from ..algos import community as _community
from ..algos import components as _components
from ..algos import cores as _cores
from ..algos import layout as _layout
from ..algos import link_analysis as _link_analysis
from ..algos import link_prediction as _lp
from ..algos import traversal as _traversal
from ..algos import tree as _tree
from ..core.convert import decompress_to_edgelist
from ..utils.device import DeviceLike
from .graph import Graph, _host
from .nx_compat import ensure_graph, maybe_dict


def _vertex_frame(g: Graph, **columns) -> pd.DataFrame:
    """DataFrame['vertex', *columns], one row per vertex in internal order."""
    return pd.DataFrame(
        {"vertex": g.vertex_ids_external(), **{k: _host(v) for k, v in columns.items()}}
    )


def pagerank(
    G,
    alpha: float = 0.85,
    personalization: Optional[pd.DataFrame] = None,
    max_iter: int = 100,
    tol: float = 1.0e-5,
    nstart: Optional[pd.DataFrame] = None,
    device: DeviceLike = None,
):
    """Returns DataFrame['vertex', 'pagerank'] (or dict for nx input).

    Examples
    --------
    >>> import pandas as pd
    >>> from cugraph_tpu_torch.api import Graph, algorithms
    >>> G = Graph(device="cpu")
    >>> _ = G.from_pandas_edgelist(pd.DataFrame(
    ...     {"source": [0, 1, 2], "destination": [1, 2, 0]}))
    >>> df = algorithms.pagerank(G, tol=1e-10)
    >>> [round(x, 4) for x in df["pagerank"]]
    [0.3333, 0.3333, 0.3333]
    """
    g, is_nx = ensure_graph(G, device)
    pers = None
    if personalization is not None:
        ids = g.to_internal(personalization["vertex"].to_numpy())
        pers = (ids, personalization["values"].to_numpy())
    ns = None
    if nstart is not None:
        order = np.argsort(g.to_internal(nstart["vertex"].to_numpy()))
        ns = nstart["values"].to_numpy()[order]
    scores, _ = _link_analysis.pagerank(
        g.core,
        alpha=alpha,
        personalization=pers,
        max_iterations=max_iter,
        tol=tol,
        nstart=ns,
    )
    return maybe_dict(_vertex_frame(g, pagerank=scores), "pagerank", is_nx)


def hits(G, max_iter: int = 100, tol: float = 1.0e-5, device: DeviceLike = None):
    g, is_nx = ensure_graph(G, device)
    h, a, _ = _link_analysis.hits(g.core, max_iterations=max_iter, tol=tol)
    df = _vertex_frame(g, hubs=h, authorities=a)
    if is_nx:
        return (
            dict(zip(df["vertex"], df["hubs"])),
            dict(zip(df["vertex"], df["authorities"])),
        )
    return df


def katz_centrality(G, alpha=None, beta=1.0, max_iter=1000, tol=1.0e-6,
                    device: DeviceLike = None):
    g, is_nx = ensure_graph(G, device)
    x, _ = _centrality.katz_centrality(
        g.core, alpha=alpha, beta=beta, max_iterations=max_iter, tol=tol
    )
    return maybe_dict(_vertex_frame(g, katz_centrality=x), "katz_centrality", is_nx)


def eigenvector_centrality(G, max_iter=1000, tol=1.0e-6, device: DeviceLike = None):
    g, is_nx = ensure_graph(G, device)
    x, _ = _centrality.eigenvector_centrality(g.core, max_iterations=max_iter, tol=tol)
    return maybe_dict(
        _vertex_frame(g, eigenvector_centrality=x), "eigenvector_centrality", is_nx
    )


def betweenness_centrality(G, k=None, normalized=True, seed=0, device: DeviceLike = None):
    g, is_nx = ensure_graph(G, device)
    x = _centrality.betweenness_centrality(g.core, k=k, normalized=normalized, seed=seed)
    return maybe_dict(
        _vertex_frame(g, betweenness_centrality=x), "betweenness_centrality", is_nx
    )


def degree_centrality(G, normalized=True, device: DeviceLike = None):
    g, is_nx = ensure_graph(G, device)
    x = _centrality.degree_centrality(g.core, normalized=normalized)
    return maybe_dict(_vertex_frame(g, degree_centrality=x), "degree_centrality", is_nx)


def _external_predecessors(g: Graph, pred) -> np.ndarray:
    pred = _host(pred)
    return np.where(pred >= 0, g.to_external(np.maximum(pred, 0)), -1)


def bfs(G, start, depth_limit=None, device: DeviceLike = None):
    """Returns DataFrame['vertex', 'distance', 'predecessor'].

    Examples
    --------
    >>> import pandas as pd
    >>> from cugraph_tpu_torch.api import Graph, algorithms
    >>> G = Graph(directed=True, device="cpu")
    >>> _ = G.from_pandas_edgelist(pd.DataFrame(
    ...     {"source": [0, 1], "destination": [1, 2]}))
    >>> df = algorithms.bfs(G, 0).sort_values("vertex")
    >>> df["distance"].tolist()
    [0, 1, 2]
    """
    g, _ = ensure_graph(G, device)
    start_int = g.to_internal(np.atleast_1d(start))
    dist, pred = _traversal.bfs(g.core, start_int, depth_limit=depth_limit)
    return _vertex_frame(g, distance=dist, predecessor=_external_predecessors(g, pred))


def sssp(G, source, cutoff=None, device: DeviceLike = None):
    g, _ = ensure_graph(G, device)
    src_int = g.to_internal(np.atleast_1d(source))
    dist, pred = _traversal.sssp(g.core, src_int, cutoff=cutoff)
    return _vertex_frame(g, distance=dist, predecessor=_external_predecessors(g, pred))


shortest_path = sssp  # reference alias (traversal/sssp.py shortest_path)


def connected_components(G, device: DeviceLike = None):
    g, is_nx = ensure_graph(G, device)
    labels = _components.weakly_connected_components(g.core)
    return maybe_dict(_vertex_frame(g, labels=labels), "labels", is_nx)


weakly_connected_components = connected_components


def strongly_connected_components(G, device: DeviceLike = None):
    g, is_nx = ensure_graph(G, device)
    labels = _components.strongly_connected_components(g.core)
    return maybe_dict(_vertex_frame(g, labels=labels), "labels", is_nx)


def core_number(G, degree_type: str = "incoming_outgoing", device: DeviceLike = None):
    g, is_nx = ensure_graph(G, device)
    core = _cores.core_number(g.core, degree_type=degree_type)
    return maybe_dict(_vertex_frame(g, core_number=core), "core_number", is_nx)


def _subgraph(g: Graph, sub, vmap) -> Graph:
    """An api.Graph of a core subgraph whose vertex i is g's vmap[i]."""
    out = Graph(directed=g.directed, device=g.device)
    s, d, w = decompress_to_edgelist(sub)
    ext = np.asarray(g.to_external(vmap))
    out.from_numpy_edgelist(ext[_host(s)], ext[_host(d)], None if w is None else _host(w))
    return out


def k_core(G, k: int, degree_type: str = "outgoing", device: DeviceLike = None):
    g, _ = ensure_graph(G, device)
    sub, vmap = _cores.k_core(g.core, k, degree_type=degree_type)
    return _subgraph(g, sub, vmap)


def louvain(G, max_level: int = 100, resolution: float = 1.0, device: DeviceLike = None):
    """Returns (DataFrame['vertex','partition'], modularity)."""
    g, is_nx = ensure_graph(G, device)
    labels, q = _community.louvain(g.core, max_level=max_level, resolution=resolution)
    df = _vertex_frame(g, partition=labels)
    if is_nx:
        return dict(zip(df["vertex"], df["partition"])), q
    return df, q


def leiden(G, max_level: int = 100, resolution: float = 1.0, device: DeviceLike = None):
    g, is_nx = ensure_graph(G, device)
    labels, q = _community.leiden(g.core, max_level=max_level, resolution=resolution)
    df = _vertex_frame(g, partition=labels)
    if is_nx:
        return dict(zip(df["vertex"], df["partition"])), q
    return df, q


def triangle_count(G, device: DeviceLike = None):
    g, is_nx = ensure_graph(G, device)
    counts = _community.triangle_count(g.core)
    return maybe_dict(_vertex_frame(g, counts=counts), "counts", is_nx)


triangles = triangle_count


def _similarity_df(g, kind, pairs=None, use_weight=False):
    fn = getattr(_lp, kind)
    if pairs is not None:
        pairs = (g.to_internal(pairs[0]), g.to_internal(pairs[1]))
    v1, v2, coeff = fn(g.core, pairs=pairs, use_weight=use_weight)
    return pd.DataFrame(
        {
            "first": g.to_external(v1),
            "second": g.to_external(v2),
            f"{kind}_coeff": _host(coeff),
        }
    )


def jaccard(G, pairs=None, use_weight=False, device: DeviceLike = None):
    g, _ = ensure_graph(G, device)
    return _similarity_df(g, "jaccard", pairs, use_weight)


def sorensen(G, pairs=None, use_weight=False, device: DeviceLike = None):
    g, _ = ensure_graph(G, device)
    return _similarity_df(g, "sorensen", pairs, use_weight)


def overlap(G, pairs=None, use_weight=False, device: DeviceLike = None):
    g, _ = ensure_graph(G, device)
    return _similarity_df(g, "overlap", pairs, use_weight)


def uniform_neighbor_sample(G, start_list, fanout_vals, with_replacement=False,
                            generator=None, device: DeviceLike = None):
    from ..sampling.uniform_neighbor_sample import uniform_neighbor_sample as _uns

    g, _ = ensure_graph(G, device)
    res = _uns(
        g.core,
        g.to_internal(np.atleast_1d(start_list)),
        fanout_vals,
        with_replacement=with_replacement,
        generator=generator,
    )
    df = pd.DataFrame(
        {
            "sources": g.to_external(res["sources"]),
            "destinations": g.to_external(res["destinations"]),
            "hop_id": _host(res["hop"]),
        }
    )
    if res["weights"] is not None:
        df["indices"] = _host(res["weights"])
    return df


def random_walks(G, start_vertices, max_depth, generator=None, device: DeviceLike = None):
    """Returns (walks, weights) as numpy arrays of internal ids, as the JAX
    package's wrapper does."""
    from ..sampling.random_walks import random_walks as _rw

    g, _ = ensure_graph(G, device)
    walks, ws = _rw(
        g.core, g.to_internal(np.atleast_1d(start_vertices)), max_depth, generator=generator
    )
    return _host(walks), _host(ws)


def node2vec(G, start_vertices, max_depth, p=1.0, q=1.0, generator=None,
             device: DeviceLike = None):
    from ..sampling.random_walks import node2vec as _n2v

    g, _ = ensure_graph(G, device)
    walks, ws = _n2v(
        g.core, g.to_internal(np.atleast_1d(start_vertices)), max_depth, p=p, q=q,
        generator=generator,
    )
    return _host(walks), _host(ws)


def ego_graph(G, n, radius: int = 1, device: DeviceLike = None):
    g, _ = ensure_graph(G, device)
    sub, vmap = _community.ego_graph(
        g.core, int(g.to_internal(np.atleast_1d(n))[0]), radius=radius
    )
    return _subgraph(g, sub, vmap)


def force_atlas2(G, max_iter: int = 500, device: DeviceLike = None, **kwargs):
    g, _ = ensure_graph(G, device)
    pos = _host(_layout.force_atlas2(g.core, max_iter=max_iter, **kwargs))
    return pd.DataFrame(
        {"vertex": g.vertex_ids_external(), "x": pos[:, 0], "y": pos[:, 1]}
    )


def minimum_spanning_tree(G, device: DeviceLike = None):
    g, _ = ensure_graph(G, device)
    s, d, w = _tree.minimum_spanning_tree(g.core)
    return pd.DataFrame(
        {"src": g.to_external(s), "dst": g.to_external(d), "weight": _host(w)}
    )
