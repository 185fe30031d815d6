"""MGPropertyGraph: property tables whose extracted subgraphs are
2D-partitioned over a mesh.

Counterpart of ``cugraph_tpu/dist/mg_property_graph.py`` (ref:
python/cugraph/cugraph/dask/structure/mg_property_graph.py,
EXPERIMENTAL__MGPropertyGraph :52). The pandas tables are those of the
single-device ``PropertyGraph``; only an extracted subgraph is
distributed: ``extract_subgraph`` streams the selected edges in chunks
through ``distribute_edgelist_chunks``, and returns this rank's
``MGGraph``. Every rank of the mesh holds the same tables and makes the
same calls.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..api.property_graph import (
    DST_COL,
    EDGE_ID_COL,
    SRC_COL,
    TYPE_COL,
    VERTEX_COL,
    PropertyGraph,
    PropertySelection,
)
from ..utils.device import resolve_device
from ..utils.error import expects
from .mesh import Mesh2D
from .mg_graph import MGGraph, distribute_edgelist_chunks


class MGPropertyGraph(PropertyGraph):
    """PropertyGraph whose extract_subgraph returns an MGGraph on
    ``mesh``. The property-table verbs are inherited unchanged, as the
    reference's MGPropertyGraph mirrors the single-GPU surface."""

    def __init__(self, mesh: Mesh2D, chunk_edges: int = 1 << 20):
        super().__init__()
        self.mesh = mesh
        self.chunk_edges = int(chunk_edges)

    def is_mg(self) -> bool:  # the GNN stores route their sampler by it
        return True

    def extract_subgraph(
        self,
        create_using=None,
        selection=None,
        edge_weight_property: Optional[str] = None,
        default_edge_weight: Optional[float] = None,
        check_multi_edges: bool = True,
        renumber_graph: bool = True,
        add_edge_data: bool = True,
        edge_types=None,
        reverse: bool = False,
    ) -> MGGraph:
        """The selected edges as this rank's MGGraph on the mesh, streamed
        ``chunk_edges`` at a time. Vertex ids must already be integers
        (``renumber_vertices_by_type`` or a NumberMap make them so); they
        are the graph's ids as they are (``create_using`` and
        ``renumber_graph`` are accepted and not read). reverse=True stores
        every edge reversed (the "in" direction of the GNN store's
        sampler). With add_edge_data the selected edges' src, dst, id and
        type columns are attached as ``mgg.edge_data``."""
        resolve_device(self.mesh.device)
        expects(self._edge_df is not None, "no edge data")
        df = self._edge_df
        if edge_types is not None:
            df = df[df[TYPE_COL].isin(edge_types)]
        if selection is not None and not isinstance(selection, PropertySelection):
            selection = PropertySelection(edge_selection=selection)
        if selection is not None:
            if selection.edge_selections is not None:
                df = df[selection.edge_selections.reindex(df.index, fill_value=False)]
            if selection.vertex_selections is not None:
                chosen = set(self._vertex_df.loc[selection.vertex_selections, VERTEX_COL])
                df = df[df[SRC_COL].isin(chosen) & df[DST_COL].isin(chosen)]
        if check_multi_edges:
            expects(not self.has_duplicate_edges(df),
                    "selection yields a multigraph; pass check_multi_edges=False")
        src = df[SRC_COL].to_numpy()
        dst = df[DST_COL].to_numpy()
        expects(np.issubdtype(src.dtype, np.integer) and np.issubdtype(dst.dtype, np.integer),
                "MGPropertyGraph.extract_subgraph needs integer vertex ids")
        w = None
        if edge_weight_property is not None:
            expects(edge_weight_property in df.columns,
                    f"graph has no edge property {edge_weight_property!r}")
            wcol = df[edge_weight_property]
            if default_edge_weight is not None:
                wcol = wcol.fillna(default_edge_weight)
            w = wcol.to_numpy().astype(np.float32)
        elif default_edge_weight is not None:
            w = np.full(len(src), default_edge_weight, np.float32)
        num_vertices = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
        if reverse:
            src, dst = dst, src
        step = self.chunk_edges

        def chunks():
            for o in range(0, len(src), step):
                yield (src[o:o + step], dst[o:o + step], None if w is None else w[o:o + step])

        mgg = distribute_edgelist_chunks(self.mesh, chunks, num_vertices=num_vertices)
        if add_edge_data:
            mgg = dataclasses.replace(
                mgg, edge_data=df[[SRC_COL, DST_COL, EDGE_ID_COL, TYPE_COL]].reset_index(drop=True))
        return mgg
