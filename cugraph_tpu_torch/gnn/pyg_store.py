"""PyG remote-backend protocol over PropertyGraph (framework-neutral).

Counterpart of ``cugraph_tpu/gnn/pyg_store.py`` (ref:
python/cugraph/cugraph/gnn/pyg_extensions/data/cugraph_store.py —
CuGraphEdgeAttr :36, CuGraphTensorAttr :96, EXPERIMENTAL__CuGraphStore
:165: get/put_edge_index, get_all_edge_attrs, neighbor_sample :432,
put_tensor/create_named_tensor :590-605, get_tensor :678,
get_all_tensor_attrs :650, multi_get_tensor, to_pyg :73).

The same protocol surface as the JAX package's, with no torch_geometric
dependency. The tables stay in pandas on the host; the algorithm graph
and the sampler run on the store's device (default: the card).
``get_tensor`` delivers what ``backend_lib`` asks: a torch tensor on the
store's device (default) or a numpy array; "jax" raises.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from ..api.property_graph import DST_COL, SRC_COL, VERTEX_COL, PropertyGraph
from ..sampling.uniform_neighbor_sample import uniform_neighbor_sample
from ..utils.device import DeviceLike, as_tensor, resolve_device
from ..utils.dtypes import VERTEX_DTYPE
from .graph_store import _host, check_backend, deliver

_UNSET = object()


class EdgeLayout(Enum):
    COO = "coo"
    CSC = "csc"
    CSR = "csr"


def _cast(cls, args, kwargs):
    if len(args) == 1 and not kwargs:
        elem = args[0]
        if elem is None or isinstance(elem, cls):
            return elem
        if isinstance(elem, (tuple, list)):
            return cls(*elem)
        if isinstance(elem, dict):
            return cls(**elem)
    return cls(*args, **kwargs)


@dataclasses.dataclass
class EdgeAttr:
    """GraphStore edge-group descriptor (ref CuGraphEdgeAttr :36)."""

    edge_type: Optional[Any]
    layout: EdgeLayout = EdgeLayout.COO
    is_sorted: bool = False
    size: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        self.layout = EdgeLayout(self.layout)

    @classmethod
    def cast(cls, *args, **kwargs):
        return _cast(cls, args, kwargs)


@dataclasses.dataclass
class TensorAttr:
    """FeatureStore tensor descriptor (ref CuGraphTensorAttr :96)."""

    group_name: Any = _UNSET
    attr_name: Any = _UNSET
    index: Any = _UNSET
    properties: Any = _UNSET
    dtype: Any = _UNSET

    def is_set(self, key) -> bool:
        if key not in self.__dataclass_fields__:
            raise KeyError(key)
        return getattr(self, key) is not _UNSET

    def is_fully_specified(self) -> bool:
        return all(self.is_set(k) for k in self.__dataclass_fields__)

    def fully_specify(self):
        for k in self.__dataclass_fields__:
            if not self.is_set(k):
                setattr(self, k, None)
        return self

    def update(self, attr: "TensorAttr"):
        for k in self.__dataclass_fields__:
            if attr.is_set(k):
                setattr(self, k, getattr(attr, k))

    @classmethod
    def cast(cls, *args, **kwargs):
        return _cast(cls, args, kwargs)

    def _given(self, key):
        """The field's value, None where it is unset."""
        return getattr(self, key) if self.is_set(key) else None


class PyGStore:
    """FeatureStore + GraphStore protocol over one PropertyGraph
    (ref EXPERIMENTAL__CuGraphStore :165)."""

    def __init__(self, pg: Optional[PropertyGraph] = None, backend_lib: str = "torch",
                 device: DeviceLike = None):
        check_backend(backend_lib)
        self.device = resolve_device(device)
        self.pg = pg if pg is not None else PropertyGraph()
        self.backend_lib = backend_lib
        self._tensor_attrs: Dict[Tuple[str, str], TensorAttr] = {}
        self._graph_cache = None

    # ---- GraphStore side --------------------------------------------------
    def put_edge_index(self, edge_index, edge_attr) -> bool:
        """Register a COO edge group (ref :266 raises; COO is accepted)."""
        attr = EdgeAttr.cast(edge_attr)
        if attr.layout != EdgeLayout.COO:
            raise ValueError("only COO layout is supported for ingestion")
        df = pd.DataFrame({"src": _host(edge_index[0]), "dst": _host(edge_index[1])})
        self.pg.add_edge_data(df, ("src", "dst"), type_name=attr.edge_type or "")
        self._graph_cache = None
        return True

    def get_edge_index(self, *args, **kwargs) -> Tuple[np.ndarray, np.ndarray]:
        """COO (row, col) numpy arrays of an edge group, from the host table
        (ref :275/:366)."""
        attr = EdgeAttr.cast(*args, **kwargs)
        types = [attr.edge_type] if attr.edge_type else None
        df = self.pg.get_edge_data(types=types)
        if df is None or not len(df):
            raise KeyError(f"no edges of type {attr.edge_type!r}")
        return df[SRC_COL].to_numpy(), df[DST_COL].to_numpy()

    def get_all_edge_attrs(self) -> List[EdgeAttr]:
        out = []
        for t in self.pg.edge_types or [""]:
            n = self.pg.get_num_edges(t) if t else self.pg.get_num_edges()
            if n:
                v = self.pg.get_num_vertices()
                out.append(EdgeAttr(edge_type=t or None, layout=EdgeLayout.COO, size=(v, v)))
        return out

    # ---- FeatureStore side ------------------------------------------------
    def put_tensor(self, tensor, attr) -> bool:
        """Store vertex features as PropertyGraph columns (ref :590)."""
        attr = TensorAttr.cast(attr)
        arr = _host(tensor)
        index = attr._given("index")
        idx = _host(index) if index is not None else np.arange(arr.shape[0])
        cols = (list(attr.properties) if attr._given("properties")
                else [f"{attr.attr_name}_{i}" for i in range(arr.shape[1])])
        df = pd.DataFrame({c: arr[:, i] for i, c in enumerate(cols)})
        df["__vid"] = idx
        self.pg.add_vertex_data(df, "__vid", type_name=attr.group_name or "")
        self.create_named_tensor(attr.attr_name, cols, attr.group_name or "", arr.dtype)
        return True

    def create_named_tensor(
        self, attr_name: str, properties: Sequence[str], vertex_type: str, dtype
    ) -> None:
        """Name a group of property columns as one tensor (ref :593)."""
        self._tensor_attrs[(vertex_type, attr_name)] = TensorAttr(
            group_name=vertex_type, attr_name=attr_name, properties=list(properties),
            dtype=dtype,
        )

    def get_all_tensor_attrs(self) -> List[TensorAttr]:
        return [dataclasses.replace(a) for a in self._tensor_attrs.values()]

    def get_tensor(self, *args, **kwargs):
        attr = TensorAttr.cast(*args, **kwargs)
        named = self._tensor_attrs.get((attr.group_name or "", attr.attr_name))
        props = attr._given("properties") or (named.properties if named else None)
        if props is None:
            raise KeyError(f"unknown tensor {attr.attr_name!r}")
        index = attr._given("index")
        idx = None if index is None else _host(index)
        df = self.pg.get_vertex_data(
            vertex_ids=idx, types=[attr.group_name] if attr.group_name else None)
        if idx is not None:
            df = df.set_index(VERTEX_COL).loc[idx]
        dtype = attr._given("dtype")
        if dtype is None:
            dtype = named.dtype if named and named.dtype is not None else np.float32
        return deliver(df[list(props)].to_numpy(dtype=dtype), self.backend_lib, self.device)

    def multi_get_tensor(self, attrs):
        return [self.get_tensor(a) for a in attrs]

    def remove_tensor(self, attr) -> bool:
        attr = TensorAttr.cast(attr)
        return self._tensor_attrs.pop((attr.group_name or "", attr.attr_name), None) is not None

    # ---- sampling (ref neighbor_sample :432) --------------------------------
    def neighbor_sample(
        self,
        index,
        num_neighbors: Sequence[int],
        replace: bool = False,
        directed: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        """Returns (row, col, node_ids, hop) in LOCAL ids over the sampled
        node set, PyG remote-backend style (ref :432-490's renumbering):
        row and col int64 tensors on the store's device, node_ids the
        external ids of the sorted node set (numpy), hop an int32 tensor.
        Seeds with no sampled edge are in the node set too."""
        from ..api.graph import Graph

        if self._graph_cache is None:
            self._graph_cache = self.pg.extract_subgraph(
                create_using=Graph(directed=True, device=self.device))
        g = self._graph_cache
        seeds = as_tensor(g.to_internal(np.atleast_1d(_host(index))), VERTEX_DTYPE, self.device)
        res = uniform_neighbor_sample(g.core, seeds, list(num_neighbors),
                                      with_replacement=replace, generator=generator)
        srcs, dsts = res["sources"], res["destinations"]
        nodes = torch.unique(torch.cat([seeds, srcs, dsts]))
        row = torch.searchsorted(nodes, srcs)
        col = torch.searchsorted(nodes, dsts)
        return row, col, g.to_external(nodes), res["hop"]


def to_pyg(G, backend_lib: str = "torch", device: DeviceLike = None) -> Tuple[PyGStore, PyGStore]:
    """(feature_store, graph_store) pair for PyG remote-backend loaders —
    the same object serves both protocols (ref EXPERIMENTAL__to_pyg :73)."""
    store = PyGStore(G if isinstance(G, PropertyGraph) else None, backend_lib=backend_lib,
                     device=device)
    return store, store
