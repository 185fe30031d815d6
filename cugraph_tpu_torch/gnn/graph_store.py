"""GNN graph/feature store over PropertyGraph and the sampler.

Counterpart of ``cugraph_tpu/gnn/graph_store.py`` (ref:
python/cugraph/cugraph/gnn/graph_store.py: CuGraphStore :30 — node and
edge feature storage over PropertyGraph, sample_neighbors :155 via
uniform_neighbor_sample, CuFeatureStorage :402). The tables stay in
pandas on the host, as in the JAX package; the algorithm graph and the
sampling run on the store's device (default: the card).

Differences by design: features come back as torch tensors on the
store's device by default (``backend_lib="torch"``) or as numpy arrays;
``backend_lib="jax"`` raises. ``sample_neighbors`` takes a
``torch.Generator`` where the JAX package takes a PRNG key. A store over
a ``dist.MGPropertyGraph`` samples on its mesh
(``dist.mg_sampling.mg_uniform_neighbor_sample``); every rank of the mesh
then makes the same calls.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import pandas as pd
import torch

from ..api.property_graph import DST_COL, EDGE_ID_COL, SRC_COL, VERTEX_COL, PropertyGraph
from ..sampling.uniform_neighbor_sample import uniform_neighbor_sample
from ..utils.device import DeviceLike, resolve_device

BACKENDS = ("torch", "numpy")


def check_backend(backend_lib: str) -> None:
    """The port delivers torch tensors or numpy arrays; "jax" and any other
    name raise ValueError."""
    if backend_lib not in BACKENDS:
        raise ValueError(f"backend_lib must be one of {BACKENDS}, got {backend_lib!r}")


def deliver(mat: np.ndarray, backend_lib: str, device: torch.device):
    """A host float matrix as ``backend_lib`` asks: a tensor on ``device``,
    or the numpy array itself."""
    return torch.tensor(mat, device=device) if backend_lib == "torch" else mat


class FeatureStorage:
    """Feature fetch wrapper (ref CuFeatureStorage, gnn/graph_store.py:402).

    storage_type "node": indices are vertex ids; "edge": edge ids.
    backend_lib: "torch" (a tensor on ``device``, default the card) or
    "numpy"."""

    def __init__(
        self,
        pg: PropertyGraph,
        columns: Sequence[str],
        type_name: str,
        storage_type: str = "node",
        backend_lib: str = "torch",
        device: DeviceLike = None,
    ):
        check_backend(backend_lib)
        self.pg = pg
        self.columns = list(columns)
        self.type_name = type_name
        self.storage_type = storage_type
        self.backend_lib = backend_lib
        self.device = resolve_device(device)

    def fetch(self, indices):
        types = [self.type_name] if self.type_name else None
        idx = _host(indices)
        if self.storage_type == "edge":
            df = self.pg.get_edge_data(edge_ids=idx, types=types)
            df = df.set_index(EDGE_ID_COL).loc[idx]
        else:
            df = self.pg.get_vertex_data(vertex_ids=idx, types=types)
            df = df.set_index(VERTEX_COL).loc[idx]
        if len(self.columns) == 1 and df[self.columns[0]].dtype == object:
            # vector property: stack the packed rows
            mat = PropertyGraph._vector_to_array(df, self.columns[0]).astype(np.float32)
        else:
            mat = df[self.columns].to_numpy(dtype=np.float32)
        return deliver(mat, self.backend_lib, self.device)


class GraphStore:
    """Node/edge feature store + neighbor sampler (ref CuGraphStore)."""

    def __init__(self, property_graph: Optional[PropertyGraph] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.pg = property_graph if property_graph is not None else PropertyGraph()
        self._graph_cache = None
        self._rev_core = None
        self._mgg = {}  # edge_dir -> the MGGraph an MG-backed store samples

    # ---- data ingestion (ref CuGraphStore.add_node_data/add_edge_data) ---
    def add_node_data(self, df: pd.DataFrame, node_col_name: str, node_type: str = ""):
        self.pg.add_vertex_data(df, node_col_name, type_name=node_type)
        self._graph_cache = self._rev_core = None
        self._mgg = {}

    def add_edge_data(self, df: pd.DataFrame, vertex_col_names, edge_type: str = ""):
        self.pg.add_edge_data(df, vertex_col_names, type_name=edge_type)
        self._graph_cache = self._rev_core = None
        self._mgg = {}

    # ---- graph views (ref CuGraphStore :125-148, :320-326) -----------------
    @property
    def num_vertices(self) -> int:
        return self.pg.get_num_vertices()

    @property
    def num_edges(self) -> int:
        return self.pg.get_num_edges()

    def num_nodes(self, ntype: Optional[str] = None) -> int:
        return self.pg.get_num_vertices(ntype)

    def num_edges_of(self, etype: Optional[str] = None) -> int:
        return self.pg.get_num_edges(etype)

    @property
    def ntypes(self):
        return self.pg.vertex_types

    @property
    def etypes(self):
        return self.pg.edge_types

    @property
    def has_multiple_etypes(self) -> bool:
        return len(self.pg.edge_types) > 1

    @property
    def num_nodes_dict(self) -> Dict[str, int]:
        return {t: self.pg.get_num_vertices(t) for t in self.pg.vertex_types}

    @property
    def num_edges_dict(self) -> Dict[str, int]:
        return {t: self.pg.get_num_edges(t) for t in self.pg.edge_types}

    def get_vertex_ids(self) -> np.ndarray:
        return np.asarray(self.pg.get_vertices())

    def find_edges(self, edge_ids, etype: Optional[str] = None):
        """(src, dst) endpoint arrays (numpy, from the host table) for the
        given edge ids (ref CuGraphStore.find_edges :346)."""
        ids = _host(edge_ids)
        df = self.pg.get_edge_data(edge_ids=ids, types=[etype] if etype else None)
        df = df.set_index(EDGE_ID_COL).loc[ids]
        return df[SRC_COL].to_numpy(), df[DST_COL].to_numpy()

    def _algo_graph(self):
        if self._graph_cache is None:
            from ..api.graph import Graph

            self._graph_cache = self.pg.extract_subgraph(
                create_using=Graph(directed=True, device=self.device)
            )
        return self._graph_cache

    @property
    def is_mg(self) -> bool:
        """True when the backing tables are an MGPropertyGraph: sampling
        then runs on its mesh (ref CuGraphStore.is_mg)."""
        return bool(getattr(self.pg, "is_mg", lambda: False)())

    @property
    def gdata(self):
        """The backing PropertyGraph (ref CuGraphStore.gdata :148)."""
        return self.pg

    # ---- sampling (ref CuGraphStore.sample_neighbors :155) ---------------
    def sample_neighbors(
        self,
        nodes,
        fanout: int = -1,
        with_replacement: bool = False,
        num_hops: int = 1,
        edge_dir: str = "in",
        generator: Optional[torch.Generator] = None,
    ) -> pd.DataFrame:
        """edge_dir "in": sample edges INTO the seed nodes (DGL default,
        via the reverse adjacency — ref extracted_reverse_subgraph :287);
        "out": sample outgoing edges. Returns a frame of external ids and
        hops. An MG-backed store samples on its mesh (``_sample_neighbors_mg``)."""
        if self.is_mg:
            return self._sample_neighbors_mg(nodes, fanout, with_replacement, num_hops,
                                             edge_dir, generator)
        g = self._algo_graph()
        sample_g = g.core
        if edge_dir == "in":
            from ..core.convert import transpose

            if self._rev_core is None:
                self._rev_core = transpose(g.core)
            sample_g = self._rev_core
        res = uniform_neighbor_sample(
            sample_g,
            g.to_internal(np.atleast_1d(_host(nodes))),
            [fanout] * num_hops,
            with_replacement=with_replacement,
            generator=generator,
        )
        srcs, dsts = res["sources"], res["destinations"]
        if edge_dir == "in":  # un-reverse the reported edges
            srcs, dsts = dsts, srcs
        return pd.DataFrame({
            "sources": g.to_external(srcs),
            "destinations": g.to_external(dsts),
            "hop": _host(res["hop"]),
        })

    def _sample_neighbors_mg(self, nodes, fanout, with_replacement, num_hops, edge_dir,
                             generator) -> pd.DataFrame:
        """The mesh sampler over the MGPropertyGraph's edges, stored reversed
        for edge_dir "in" (JAX graph_store.py:221, ref CuGraphStore's dask
        path). The graph is extracted once a direction and kept; vertex ids
        are the tables' integer ids. Every rank must make the same call."""
        from ..dist import mg_sampling
        from ..utils.error import expects

        expects(fanout > 0, "MG sampling needs fanout > 0")
        rev = edge_dir == "in"
        mgg = self._mgg.get(edge_dir)
        if mgg is None:
            mgg = self._mgg[edge_dir] = self.pg.extract_subgraph(check_multi_edges=False,
                                                                 reverse=rev)
        res = mg_sampling.mg_uniform_neighbor_sample(
            self.pg.mesh, mgg, np.atleast_1d(_host(nodes)), [fanout] * num_hops,
            with_replacement=with_replacement, generator=generator)
        srcs, dsts = _host(res["sources"]), _host(res["destinations"])
        if rev:
            srcs, dsts = dsts, srcs
        return pd.DataFrame({"sources": srcs, "destinations": dsts, "hop": _host(res["hop"])})

    def get_node_storage(
        self, columns, node_type: str = "", backend_lib: str = "torch"
    ) -> FeatureStorage:
        return FeatureStorage(self.pg, columns, node_type, storage_type="node",
                              backend_lib=backend_lib, device=self.device)

    def get_edge_storage(
        self, columns, edge_type: str = "", backend_lib: str = "torch"
    ) -> FeatureStorage:
        """Edge-feature fetch by edge id (ref CuGraphStore.get_edge_storage)."""
        return FeatureStorage(self.pg, columns, edge_type, storage_type="edge",
                              backend_lib=backend_lib, device=self.device)

    def node_subgraph(self, nodes):
        """Induced subgraph over a node subset (ref CuGraphStore helpers):
        (core graph, external ids of its vertices)."""
        from ..core.convert import induced_subgraph

        g = self._algo_graph()
        sub, vmap = induced_subgraph(g.core, g.to_internal(_host(nodes)))
        return sub, g.to_external(vmap)

    def egonet(self, node, k: int = 1):
        from ..algos.community import ego_graph

        g = self._algo_graph()
        sub, vmap = ego_graph(g.core, int(g.to_internal(np.atleast_1d(_host(node)))[0]), k)
        return sub, g.to_external(vmap)


def _host(a):
    """A tensor (on any device), array or sequence as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
