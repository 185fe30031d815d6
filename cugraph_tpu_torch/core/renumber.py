"""Renumbering: external vertex ids -> contiguous internal ids in [0, V).

Counterpart of ``cugraph_tpu/core/renumber.py``, after the reference's two
layers:

- ``compute_renumber_map`` / ``apply_renumber_map`` order integer ids by
  degree (``renumber_edgelist_impl.cuh:96``): new id 0 has the highest
  total degree, so heavy rows come first. Here the degree histogram and
  the stable sort run on the tensors' device.
- ``NumberMap`` takes ids of any dtype, in one column or several (ref:
  python/cugraph/cugraph/structure/number_map.py:49,500,693). Its first
  pass, pandas ``factorize``, runs on the host; its second pass is
  ``compute_renumber_map`` on the device. Both sorts are stable, so the
  internal ids equal the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import pandas as pd
import torch

from ..utils.device import DeviceLike, as_tensor, resolve_device
from ..utils.dtypes import VERTEX_DTYPE
from ..utils.error import expects


def compute_renumber_map(
    src, dst, num_vertices: Optional[int] = None, *, device: DeviceLike = None
) -> torch.Tensor:
    """Returns ``new_to_old`` (int32): position i holds the old id of new
    vertex i. Total degree is in-degree plus out-degree; the sort is
    descending and stable, so ties keep the old id order."""
    dev = resolve_device(device)
    src = as_tensor(src, torch.int64, dev)
    dst = as_tensor(dst, torch.int64, dev)
    if num_vertices is None:
        num_vertices = int(max(src.max(), dst.max()).item()) + 1 if src.numel() else 0
    deg = torch.bincount(src, minlength=num_vertices) + torch.bincount(
        dst, minlength=num_vertices
    )
    _, new_to_old = torch.sort(deg, descending=True, stable=True)
    return new_to_old.to(VERTEX_DTYPE)


def apply_renumber_map(
    new_to_old, *vertex_arrays, device: DeviceLike = None
) -> Tuple[torch.Tensor, ...]:
    """Map old ids -> new ids in each array (inverse permutation lookup)."""
    dev = resolve_device(device)
    new_to_old = as_tensor(new_to_old, torch.int64, dev)
    old_to_new = torch.empty_like(new_to_old, dtype=VERTEX_DTYPE)
    old_to_new[new_to_old] = torch.arange(
        new_to_old.numel(), dtype=VERTEX_DTYPE, device=dev
    )
    return tuple(old_to_new[as_tensor(a, torch.int64, dev)] for a in vertex_arrays)


class NumberMap:
    """External (any dtype, possibly multi-column) ids <-> internal [0, V).

    ref: python/cugraph/cugraph/structure/number_map.py (SG inner class :49;
    renumber_and_segment :500; unrenumber :693). Internal ids are
    degree-descending. The map lives on the host (pandas); ids cross it as
    numpy arrays.
    """

    def __init__(self):
        self._ext_values: Optional[pd.DataFrame] = None  # index = internal id
        self._lookup: Optional[pd.Series] = None  # external id -> internal id
        self._column: Optional[np.ndarray] = None  # single column: internal -> external
        self.num_vertices = 0
        self.col_names = None

    @classmethod
    def renumber(
        cls, df: pd.DataFrame, src_cols, dst_cols, *, device: DeviceLike = None
    ) -> Tuple[torch.Tensor, torch.Tensor, "NumberMap"]:
        """Renumber a (possibly multi-column-keyed) edge dataframe.

        Returns (src_int, dst_int, number_map): int32 tensors on ``device``
        and the map; internal ids are degree-descending."""
        dev = resolve_device(device)
        if isinstance(src_cols, str):
            src_cols = [src_cols]
        if isinstance(dst_cols, str):
            dst_cols = [dst_cols]
        expects(len(src_cols) == len(dst_cols), "src/dst column count mismatch")
        nm = cls()
        nm.col_names = [f"v_{i}" for i in range(len(src_cols))]

        src_df = df[src_cols].set_axis(nm.col_names, axis=1)
        dst_df = df[dst_cols].set_axis(nm.col_names, axis=1)
        allv = pd.concat([src_df, dst_df], ignore_index=True)
        if len(nm.col_names) == 1:
            codes, uniques = pd.factorize(allv[nm.col_names[0]], sort=True)
            uniq_df = pd.DataFrame({nm.col_names[0]: uniques})
        else:
            mi = pd.MultiIndex.from_frame(allv)
            codes, uniques = pd.factorize(mi, sort=True)
            uniq_df = pd.DataFrame(
                {c: [u[i] for u in uniques] for i, c in enumerate(nm.col_names)}
            )
        n = len(codes) // 2
        codes = torch.from_numpy(codes).to(dev)
        nv = len(uniq_df)
        # second pass, on the device: degree-descending internal order
        new_to_old = compute_renumber_map(codes[:n], codes[n:], nv, device=dev)
        src_int, dst_int = apply_renumber_map(new_to_old, codes[:n], codes[n:], device=dev)
        nm._ext_values = uniq_df.iloc[new_to_old.cpu().numpy()].reset_index(drop=True)
        nm.num_vertices = nv
        return src_int, dst_int, nm

    def _index(self) -> pd.Series:
        """external id -> internal id, built at first use."""
        if self._lookup is None:
            if len(self.col_names) == 1:
                index = pd.Index(self._ext_values[self.col_names[0]])
            else:
                index = pd.MultiIndex.from_frame(self._ext_values)
            self._lookup = pd.Series(
                np.arange(self.num_vertices, dtype=np.int32), index=index
            )
        return self._lookup

    def to_internal(self, ext_vals) -> np.ndarray:
        """Map external ids -> internal ids (int32 numpy); raises GraphError
        on an id the map does not hold.

        ref analog: NumberMap.to_internal_vertex_id."""
        if len(self.col_names) == 1:
            out = self._index().reindex(pd.Index(np.asarray(ext_vals))).to_numpy()
        else:
            out = self._index().reindex(pd.MultiIndex.from_tuples(list(ext_vals))).to_numpy()
        expects(not np.any(pd.isna(out)), "unknown external vertex id")
        return out.astype(np.int32)

    def to_external(self, int_ids):
        """Map internal ids (numpy or a tensor) -> external ids: an ndarray
        for a single column, else a DataFrame.

        ref analog: NumberMap.unrenumber / from_internal_vertex_id."""
        if isinstance(int_ids, torch.Tensor):
            int_ids = int_ids.cpu().numpy()
        if len(self.col_names) == 1:
            # numpy indexing of the column, built at first use: the same
            # values as the JAX package's iloc, without its DataFrame
            if self._column is None:
                self._column = self._ext_values[self.col_names[0]].to_numpy()
            return self._column[np.asarray(int_ids)]
        return self._ext_values.iloc[np.asarray(int_ids)].reset_index(drop=True)
