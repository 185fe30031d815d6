"""User-facing Graph classes: dataframe in and out, auto-renumbering.

Counterpart of ``cugraph_tpu/api/graph.py`` (ref:
python/cugraph/cugraph/structure/graph_classes.py: Graph :95
from_cudf_edgelist, :295 from_pandas_edgelist, :412 unrenumber, :585-644
to_directed/undirected). The frames and id maps live on the host
(pandas, numpy), as in the JAX package; the core graph lives on
``device`` (default: the card).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd

from ..core import csr as core_csr
from ..core.convert import decompress_to_edgelist
from ..core.renumber import NumberMap
from ..utils.device import DeviceLike, resolve_device
from ..utils.error import expects


class Graph:
    """NetworkX-flavored graph handle wrapping the device-side core Graph.

    Undirected by default (as cugraph.Graph); ``directed=True`` for the
    DiGraph behavior. ``device=None`` means the CUDA card and raises
    without one; ``device="cpu"`` runs on the CPU.

    Examples
    --------
    >>> import pandas as pd
    >>> from cugraph_tpu_torch.api import Graph
    >>> G = Graph(device="cpu")
    >>> _ = G.from_pandas_edgelist(pd.DataFrame(
    ...     {"source": ["a", "b"], "destination": ["b", "c"]}))
    >>> G.number_of_vertices()
    3
    >>> G.number_of_edges()
    2
    """

    def __init__(self, directed: bool = False, device: DeviceLike = None):
        self.directed = directed
        self.device = resolve_device(device)
        self._g: Optional[core_csr.Graph] = None
        self._nm: Optional[NumberMap] = None
        self._renumbered = False
        self._edge_df: Optional[pd.DataFrame] = None

    # ---- construction ----------------------------------------------------
    def from_pandas_edgelist(
        self,
        df: pd.DataFrame,
        source: str = "source",
        destination: str = "destination",
        edge_attr: Optional[str] = None,
        renumber: bool = True,
    ) -> "Graph":
        """ref: from_cudf_edgelist / from_pandas_edgelist semantics."""
        expects(self._g is None, "graph already populated")
        w = (
            df[edge_attr].to_numpy().astype(np.float32)
            if edge_attr is not None
            else None
        )
        if renumber:
            src, dst, nm = NumberMap.renumber(df, source, destination, device=self.device)
            self._nm = nm
            self._renumbered = True
            nv = nm.num_vertices
        else:
            src = df[source].to_numpy().astype(np.int32)
            dst = df[destination].to_numpy().astype(np.int32)
            nv = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
        self._g = core_csr.from_edgelist(
            src,
            dst,
            w,
            num_vertices=nv,
            symmetrize=not self.directed,
            multi=self.is_multigraph(),
            device=self.device,
        )
        self._edge_df = df[[source, destination] + ([edge_attr] if edge_attr else [])]
        return self

    def from_numpy_edgelist(self, src, dst, weight=None, renumber: bool = True):
        df = pd.DataFrame({"source": src, "destination": dst})
        attr = None
        if weight is not None:
            df["weight"] = weight
            attr = "weight"
        return self.from_pandas_edgelist(df, edge_attr=attr, renumber=renumber)

    def from_numpy_array(self, a: np.ndarray) -> "Graph":
        """Dense adjacency matrix (ref: convert_matrix.py from_numpy_array)."""
        src, dst = np.nonzero(a)
        w = a[src, dst].astype(np.float32)
        return self.from_numpy_edgelist(src, dst, w, renumber=False)

    def from_scipy_sparse(self, m) -> "Graph":
        coo = m.tocoo()
        return self.from_numpy_edgelist(
            coo.row, coo.col, coo.data.astype(np.float32), renumber=False
        )

    def from_pandas_adjacency(self, df: pd.DataFrame) -> "Graph":
        return self.from_numpy_array(df.to_numpy())

    # ---- vertex id translation ------------------------------------------
    def to_internal(self, ext_ids) -> np.ndarray:
        if self._renumbered:
            return self._nm.to_internal(ext_ids)
        return np.asarray(ext_ids, dtype=np.int32)

    def to_external(self, int_ids):
        """Internal ids (numpy or a tensor) -> external ids (numpy, or a
        DataFrame for multi-column ids)."""
        if self._renumbered:
            return self._nm.to_external(int_ids)
        return _host(int_ids)

    def unrenumber(self, df: pd.DataFrame, column: str) -> pd.DataFrame:
        """ref: Graph.unrenumber (graph_classes.py:412)."""
        out = df.copy()
        out[column] = self.to_external(df[column].to_numpy())
        return out

    def vertex_ids_external(self) -> np.ndarray:
        return self.to_external(np.arange(self.number_of_vertices()))

    # ---- introspection ---------------------------------------------------
    @property
    def core(self) -> core_csr.Graph:
        expects(self._g is not None, "graph not populated")
        return self._g

    def number_of_vertices(self) -> int:
        return self.core.num_vertices

    def number_of_nodes(self) -> int:
        return self.number_of_vertices()

    def number_of_edges(self) -> int:
        e = self.core.num_edges
        return e // 2 if not self.directed else e

    def is_directed(self) -> bool:
        return self.directed

    def is_renumbered(self) -> bool:
        return self._renumbered

    def is_weighted(self) -> bool:
        return self.core.weighted

    def is_multigraph(self) -> bool:
        return False

    def has_isolated_vertices(self) -> bool:
        deg = self.core.out_degrees() + self.core.in_degrees()
        return bool((deg == 0).any())

    def nodes(self) -> np.ndarray:
        return self.vertex_ids_external()

    def edges(self) -> pd.DataFrame:
        """DataFrame['src', 'dst'(, 'weight')] in CSR order; undirected
        graphs keep each edge once, as s <= d."""
        s, d, w = decompress_to_edgelist(self.core)
        if not self.directed:
            keep = s <= d
            s, d = s[keep], d[keep]
            if w is not None:
                w = w[keep]
        df = pd.DataFrame(
            {"src": self.to_external(s), "dst": self.to_external(d)}
        )
        if w is not None:
            df["weight"] = _host(w)
        return df

    def view_edge_list(self) -> pd.DataFrame:
        return self.edges()

    def degree(self) -> pd.DataFrame:
        """Out-degree (of the symmetrized graph when undirected)."""
        return self._degree_frame(self.core.out_degrees())

    def in_degree(self) -> pd.DataFrame:
        return self._degree_frame(self.core.in_degrees())

    def out_degree(self) -> pd.DataFrame:
        return self._degree_frame(self.core.out_degrees())

    def _degree_frame(self, deg) -> pd.DataFrame:
        return pd.DataFrame({"vertex": self.vertex_ids_external(), "degree": _host(deg)})

    # ---- conversions -----------------------------------------------------
    def to_directed(self) -> "Graph":
        g = Graph(directed=True, device=self.device)
        df = self.edges()
        if not self.directed:
            # expand each undirected edge to both directions
            rev = df.rename(columns={"src": "dst", "dst": "src"})
            df = pd.concat([df, rev[df.columns]], ignore_index=True).drop_duplicates(
                subset=["src", "dst"]
            )
        g.from_pandas_edgelist(
            df,
            source="src",
            destination="dst",
            edge_attr="weight" if "weight" in df else None,
        )
        return g

    def to_undirected(self) -> "Graph":
        g = Graph(directed=False, device=self.device)
        df = self.edges()
        g.from_pandas_edgelist(
            df,
            source="src",
            destination="dst",
            edge_attr="weight" if "weight" in df else None,
        )
        return g


class DiGraph(Graph):
    """Deprecated alias (the reference deprecates DiGraph in favor of
    Graph(directed=True), graph_classes.py)."""

    def __init__(self, device: DeviceLike = None):
        super().__init__(directed=True, device=device)


class MultiGraph(Graph):
    """Parallel-edge-preserving graph (no coalescing on symmetrize)."""

    def is_multigraph(self) -> bool:
        return True


def _host(a) -> np.ndarray:
    """A tensor or array-like as a numpy array on the host."""
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
