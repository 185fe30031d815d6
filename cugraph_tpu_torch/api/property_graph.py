"""PropertyGraph: typed vertex/edge property tables over pandas, feeding
algorithm graphs and GNN feature stores.

ref: python/cugraph/cugraph/structure/property_graph.py (PropertySelection
:28-52; add_vertex_data :328, add_edge_data :525 with edge_id_col_name;
get_num_vertices(type, include_edge_data) :238; extract_subgraph :871 with
selection/default_edge_weight/check_multi_edges/add_edge_data;
renumber_vertices_by_type :1168, renumber_edges_by_type :1233;
is_multigraph :1278, has_duplicate_edges :1285). Independent redesign on
pandas: one long-format table per element kind with _TYPE_ discriminator
columns, selections as boolean Series.

Counterpart of ``cugraph_tpu/api/property_graph.py``: the pandas code is
the same; the Graph that ``extract_subgraph`` builds lives on the device
of ``create_using`` (default: a directed Graph on the card).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import pandas as pd

from ..utils.error import expects
from .graph import Graph

TYPE_COL = "_TYPE_"
VERTEX_COL = "_VERTEX_"
SRC_COL = "_SRC_"
DST_COL = "_DST_"
EDGE_ID_COL = "_EDGE_ID_"
_INTERNAL_V = (TYPE_COL, VERTEX_COL)
_INTERNAL_E = (TYPE_COL, SRC_COL, DST_COL, EDGE_ID_COL)


class PropertySelection:
    """Vertex and/or edge boolean selections over a PropertyGraph, returned
    by select_vertices()/select_edges(); combine with `+`."""

    def __init__(self, vertex_selection=None, edge_selection=None):
        self.vertex_selections = vertex_selection
        self.edge_selections = edge_selection

    def __add__(self, other: "PropertySelection") -> "PropertySelection":
        vs = self.vertex_selections
        if vs is None:
            vs = other.vertex_selections
        es = self.edge_selections
        if es is None:
            es = other.edge_selections
        return PropertySelection(vs, es)


class PropertyGraph:
    def __init__(self):
        self._vertex_df: Optional[pd.DataFrame] = None
        self._edge_df: Optional[pd.DataFrame] = None
        self._next_edge_id = 0
        # typed schema: dtype recorded per property at add time; concat
        # NaN-promotion is undone where lossless (the reference keeps
        # __vertex_prop_dtypes/__edge_prop_dtypes for exactly this,
        # property_graph.py:128-132)
        self._vertex_prop_dtypes: dict = {}
        self._edge_prop_dtypes: dict = {}

    # ---- typed schema ------------------------------------------------------
    @property
    def vertex_property_dtypes(self) -> dict:
        """Property name -> declared dtype (ref __vertex_prop_dtypes)."""
        return dict(self._vertex_prop_dtypes)

    @property
    def edge_property_dtypes(self) -> dict:
        return dict(self._edge_prop_dtypes)

    @staticmethod
    def _restore_dtypes(df: pd.DataFrame, dtypes: dict) -> pd.DataFrame:
        for col, dt in dtypes.items():
            if col not in df.columns or df[col].dtype == dt:
                continue
            if not df[col].isna().any():
                try:
                    df[col] = df[col].astype(dt)
                except (TypeError, ValueError):
                    pass
        return df

    @staticmethod
    def _pack_vectors(df, chunk, vector_properties, vector_property=None):
        """Pack listed columns into one vector-valued property per entry
        (object column of np arrays; the reference's vector_properties).
        vector_property: treat an existing array-valued column as one."""
        for name, cols in (vector_properties or {}).items():
            mat = df[list(cols)].to_numpy()
            chunk[name] = list(mat)
        if vector_property is not None:
            chunk[vector_property] = [
                np.asarray(v) for v in df[vector_property]
            ]
        return chunk

    @staticmethod
    def _vector_to_array(df: pd.DataFrame, col_name: str) -> np.ndarray:
        """Stack a vector property column into an (n, dim) array (the
        reference's vertex/edge_vector_property_to_array)."""
        vals = [np.asarray(v) for v in df[col_name]]
        expects(len(vals) > 0, f"no rows for vector property {col_name!r}")
        return np.stack(vals)

    vertex_vector_property_to_array = _vector_to_array
    edge_vector_property_to_array = _vector_to_array

    # ---- ingestion -------------------------------------------------------
    def add_vertex_data(
        self,
        df: pd.DataFrame,
        vertex_col_name: str,
        type_name: str = "",
        property_columns: Optional[List[str]] = None,
        vector_properties: Optional[dict] = None,
    ) -> None:
        vec_cols = set()
        for cols in (vector_properties or {}).values():
            vec_cols.update(cols)
        cols = property_columns or [
            c for c in df.columns if c != vertex_col_name and c not in vec_cols
        ]
        chunk = df[[vertex_col_name] + cols].rename(
            columns={vertex_col_name: VERTEX_COL}
        )
        chunk[TYPE_COL] = type_name
        chunk = self._pack_vectors(df, chunk, vector_properties)
        for c in cols:
            self._vertex_prop_dtypes.setdefault(c, df[c].dtype)
        for name in (vector_properties or {}):
            self._vertex_prop_dtypes.setdefault(name, np.dtype(object))
        self._vertex_df = (
            chunk
            if self._vertex_df is None
            else pd.concat([self._vertex_df, chunk], ignore_index=True)
        )
        self._vertex_df = self._restore_dtypes(
            self._vertex_df, self._vertex_prop_dtypes
        )

    def add_edge_data(
        self,
        df: pd.DataFrame,
        vertex_col_names,
        edge_id_col_name: Optional[str] = None,
        type_name: str = "",
        property_columns: Optional[List[str]] = None,
        vector_properties: Optional[dict] = None,
    ) -> None:
        s, d = vertex_col_names
        vec_cols = set()
        for cols in (vector_properties or {}).values():
            vec_cols.update(cols)
        skip = {s, d, edge_id_col_name} | vec_cols
        cols = property_columns or [c for c in df.columns if c not in skip]
        chunk = df[[s, d] + cols].rename(columns={s: SRC_COL, d: DST_COL})
        chunk[TYPE_COL] = type_name
        chunk = self._pack_vectors(df, chunk, vector_properties)
        for c in cols:
            self._edge_prop_dtypes.setdefault(c, df[c].dtype)
        for name in (vector_properties or {}):
            self._edge_prop_dtypes.setdefault(name, np.dtype(object))
        if edge_id_col_name is not None:
            chunk[EDGE_ID_COL] = df[edge_id_col_name].to_numpy()
            self._next_edge_id = max(
                self._next_edge_id, int(chunk[EDGE_ID_COL].max()) + 1
            )
        else:
            chunk[EDGE_ID_COL] = np.arange(
                self._next_edge_id, self._next_edge_id + len(chunk)
            )
            self._next_edge_id += len(chunk)
        self._edge_df = (
            chunk
            if self._edge_df is None
            else pd.concat([self._edge_df, chunk], ignore_index=True)
        )
        self._edge_df = self._restore_dtypes(
            self._edge_df, self._edge_prop_dtypes
        )

    # ---- introspection ---------------------------------------------------
    @property
    def vertex_property_names(self) -> List[str]:
        if self._vertex_df is None:
            return []
        return [c for c in self._vertex_df.columns if c not in _INTERNAL_V]

    @property
    def edge_property_names(self) -> List[str]:
        if self._edge_df is None:
            return []
        return [c for c in self._edge_df.columns if c not in _INTERNAL_E]

    @property
    def vertex_types(self) -> List[str]:
        if self._vertex_df is None:
            return []
        return sorted(self._vertex_df[TYPE_COL].unique().tolist())

    @property
    def edge_types(self) -> List[str]:
        if self._edge_df is None:
            return []
        return sorted(self._edge_df[TYPE_COL].unique().tolist())

    @property
    def edges(self) -> Optional[pd.DataFrame]:
        if self._edge_df is None:
            return None
        return self._edge_df[[SRC_COL, DST_COL, EDGE_ID_COL]].copy()

    def get_vertices(self, selection=None) -> pd.Series:
        """Unique vertex ids across vertex AND edge data."""
        sers = []
        if self._vertex_df is not None:
            sers.append(self._vertex_df[VERTEX_COL])
        if self._edge_df is not None:
            sers.append(self._edge_df[SRC_COL])
            sers.append(self._edge_df[DST_COL])
        if not sers:
            return pd.Series(dtype="int64")
        return pd.Series(pd.concat(sers).unique())

    def vertices_ids(self) -> pd.Series:
        return self.get_vertices()

    def get_num_vertices(
        self, type: Optional[str] = None, *, include_edge_data: bool = True
    ) -> int:
        if type is None:
            if not include_edge_data:
                return 0 if self._vertex_df is None else len(self._vertex_df)
            return len(self.get_vertices())
        if self._vertex_df is None:
            return 0
        counts = self._vertex_df[TYPE_COL].value_counts()
        n = int(counts.get(type, 0))
        if type == "" and include_edge_data:
            # vertices appearing only in edge data carry the default type
            n += len(self.get_vertices()) - len(self._vertex_df)
        return n

    def get_num_edges(self, type: Optional[str] = None) -> int:
        if self._edge_df is None:
            return 0
        if type is None:
            return len(self._edge_df)
        return int(self._edge_df[TYPE_COL].value_counts().get(type, 0))

    def get_vertex_data(
        self, vertex_ids=None, types=None, columns=None
    ) -> pd.DataFrame:
        expects(self._vertex_df is not None, "no vertex data")
        df = self._vertex_df
        if vertex_ids is not None:
            df = df[df[VERTEX_COL].isin(list(np.asarray(vertex_ids)))]
        if types is not None:
            df = df[df[TYPE_COL].isin(types)]
        if columns is not None:
            df = df[[VERTEX_COL, TYPE_COL] + list(columns)]
        return df.reset_index(drop=True)

    def get_edge_data(self, edge_ids=None, types=None, columns=None) -> pd.DataFrame:
        expects(self._edge_df is not None, "no edge data")
        df = self._edge_df
        if edge_ids is not None:
            df = df[df[EDGE_ID_COL].isin(list(np.asarray(edge_ids)))]
        if types is not None:
            df = df[df[TYPE_COL].isin(types)]
        if columns is not None:
            df = df[[SRC_COL, DST_COL, EDGE_ID_COL, TYPE_COL] + list(columns)]
        return df.reset_index(drop=True)

    # ---- multigraph checks (ref :1278-1301) ------------------------------
    @classmethod
    def is_multigraph(cls, df: pd.DataFrame) -> bool:
        return cls.has_duplicate_edges(df)

    @classmethod
    def has_duplicate_edges(cls, df: pd.DataFrame, columns=None) -> bool:
        if df is None or len(df) == 0:
            return False
        cols = [SRC_COL, DST_COL] + (list(columns) if columns else [])
        return bool(df.duplicated(subset=cols).any())

    # ---- selections (ref :780-869) ----------------------------------------
    def select_vertices(
        self, expr: str, from_previous_selection: Optional[PropertySelection] = None
    ) -> PropertySelection:
        """Evaluate expr over the vertex table -> PropertySelection. A
        previous vertex selection restricts the rows considered."""
        expects(self._vertex_df is not None, "no vertex data")
        mask = self._vertex_df.eval(expr)
        if (
            from_previous_selection is not None
            and from_previous_selection.vertex_selections is not None
        ):
            mask = mask & from_previous_selection.vertex_selections
        return PropertySelection(vertex_selection=mask)

    def select_edges(self, expr: str) -> PropertySelection:
        expects(self._edge_df is not None, "no edge data")
        return PropertySelection(edge_selection=self._edge_df.eval(expr))

    # ---- graph extraction (ref :871-993) -----------------------------------
    def extract_subgraph(
        self,
        create_using: Optional[Graph] = None,
        selection=None,
        edge_weight_property: Optional[str] = None,
        default_edge_weight: Optional[float] = None,
        check_multi_edges: bool = True,
        renumber_graph: bool = True,
        add_edge_data: bool = True,
        edge_types=None,
    ) -> Graph:
        """Build an algorithm Graph from the selected edges. A vertex
        selection restricts edges to those whose BOTH endpoints are
        selected (ref extract_subgraph semantics). The graph is built on
        ``create_using``'s device; without it, a directed Graph on the
        card."""
        expects(self._edge_df is not None, "no edge data")
        df = self._edge_df
        if edge_types is not None:
            df = df[df[TYPE_COL].isin(edge_types)]
        if isinstance(selection, pd.Series):  # back-compat: bare edge mask
            selection = PropertySelection(edge_selection=selection)
        if selection is not None:
            if selection.edge_selections is not None:
                df = df[selection.edge_selections.reindex(df.index, fill_value=False)]
            if selection.vertex_selections is not None:
                chosen = set(
                    self._vertex_df.loc[
                        selection.vertex_selections, VERTEX_COL
                    ]
                )
                df = df[df[SRC_COL].isin(chosen) & df[DST_COL].isin(chosen)]
        g = create_using if create_using is not None else Graph(directed=True)
        if check_multi_edges and not getattr(g, "is_multigraph", lambda: False)():
            expects(
                not self.has_duplicate_edges(df),
                "selection yields a multigraph; pass check_multi_edges=False "
                "or create_using=MultiGraph",
            )
        edgelist = pd.DataFrame(
            {"source": df[SRC_COL], "destination": df[DST_COL]}
        )
        attr = None
        if edge_weight_property is not None:
            expects(
                edge_weight_property in df.columns,
                f"graph has no edge property {edge_weight_property!r}",
            )
            wcol = df[edge_weight_property]
            if default_edge_weight is not None:
                wcol = wcol.fillna(default_edge_weight)
            edgelist["weight"] = wcol.to_numpy()
            attr = "weight"
        elif default_edge_weight is not None:
            edgelist["weight"] = default_edge_weight
            attr = "weight"
        g.from_pandas_edgelist(edgelist, edge_attr=attr, renumber=renumber_graph)
        if add_edge_data:
            g.edge_data = df[[SRC_COL, DST_COL, EDGE_ID_COL, TYPE_COL]].reset_index(
                drop=True
            )
        return g

    # ---- renumber by type (ref :1168-1276) ----------------------------------
    def renumber_vertices_by_type(self) -> pd.DataFrame:
        """Reassign vertex ids so each vertex type occupies a contiguous
        range; edge endpoints are remapped. Returns a dataframe of
        (start, stop) inclusive id ranges indexed by type."""
        expects(self._vertex_df is not None, "no vertex data")
        df = self._vertex_df.sort_values(TYPE_COL, kind="stable")
        old = df[VERTEX_COL].to_numpy()
        new = np.arange(len(df))
        mapping = dict(zip(old.tolist(), new.tolist()))
        self._vertex_df = df.assign(**{VERTEX_COL: new}).reset_index(drop=True)
        if self._edge_df is not None:
            self._edge_df[SRC_COL] = self._edge_df[SRC_COL].map(mapping)
            self._edge_df[DST_COL] = self._edge_df[DST_COL].map(mapping)
            expects(
                not self._edge_df[SRC_COL].isna().any()
                and not self._edge_df[DST_COL].isna().any(),
                "edge data references vertices missing from vertex data",
            )
        grp = self._vertex_df.groupby(TYPE_COL)[VERTEX_COL]
        return pd.DataFrame({"start": grp.min(), "stop": grp.max()})

    def renumber_edges_by_type(self) -> pd.DataFrame:
        """Reassign edge ids so each edge type occupies a contiguous range.
        Returns (start, stop) inclusive ranges indexed by type."""
        expects(self._edge_df is not None, "no edge data")
        df = self._edge_df.sort_values(TYPE_COL, kind="stable")
        df = df.assign(**{EDGE_ID_COL: np.arange(len(df))})
        self._edge_df = df.reset_index(drop=True)
        self._next_edge_id = len(df)
        grp = self._edge_df.groupby(TYPE_COL)[EDGE_ID_COL]
        return pd.DataFrame({"start": grp.min(), "stop": grp.max()})

    def annotate_dataframe(self, df, G, edge_vertex_col_names=(SRC_COL, DST_COL)):
        """Join edge properties back onto an edge dataframe."""
        s, d = edge_vertex_col_names
        return df.merge(
            self._edge_df,
            left_on=[s, d],
            right_on=[SRC_COL, DST_COL],
            how="left",
        )
