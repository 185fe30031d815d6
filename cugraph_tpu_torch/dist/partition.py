"""2D edge partition math.

Counterpart of ``cugraph_tpu/dist/partition.py`` (ref:
cpp/include/cugraph/graph_view.hpp:47-242, partition_manager.hpp:68-105),
kept as the port's own copy.

Layout (ranks on an (R = rows, C = cols) mesh, P = R * C):

- The vertex array is padded to P * vp and split into P equal ranges.
  Range q is owned by mesh position (i, j) with q = j * R + i. Column j's
  ranks jointly own the contiguous span [j * R * vp, (j + 1) * R * vp),
  the "column span".
- The (dst x src) edge matrix is blocked: rank (i, j) holds C blocks;
  block b holds the edges with dst in range b * R + i and src in column
  span j. The src-side values of a rank's blocks are then one all-gather
  over its mesh column (``Mesh2D.row_group``), and the per-block dst
  partials merge with one reduce-scatter over its mesh row
  (``Mesh2D.col_group``), which leaves each rank its own range.
"""

from __future__ import annotations

import dataclasses

from ..utils.error import expects


@dataclasses.dataclass(frozen=True)
class Partition2D:
    rows: int  # R, the JAX mesh axis "row"
    cols: int  # C, the JAX mesh axis "col"
    num_vertices: int  # unpadded global V
    vp: int  # vertices per range (padded)

    @classmethod
    def create(cls, rows: int, cols: int, num_vertices: int) -> "Partition2D":
        p = rows * cols
        vp = (num_vertices + p - 1) // p
        return cls(rows=rows, cols=cols, num_vertices=num_vertices, vp=vp)

    @property
    def num_partitions(self) -> int:
        return self.rows * self.cols

    @property
    def v_padded(self) -> int:
        return self.num_partitions * self.vp

    # ---- vertex ranges ---------------------------------------------------
    def range_of(self, i: int, j: int) -> tuple[int, int]:
        """Vertex range owned by mesh position (i, j): q = j*R + i."""
        q = j * self.rows + i
        return q * self.vp, (q + 1) * self.vp

    def owner_of_vertex(self, v) -> tuple:
        """(i, j) owning vertex v (array-friendly integer math)."""
        q = v // self.vp
        return q % self.rows, q // self.rows

    def col_span(self, j: int) -> tuple[int, int]:
        """Contiguous vertex span jointly owned by column j."""
        return j * self.rows * self.vp, (j + 1) * self.rows * self.vp

    def dst_range_of_block(self, i: int, b: int) -> tuple[int, int]:
        """Dst vertex range of block b on mesh row i (range q = b*R + i)."""
        q = b * self.rows + i
        return q * self.vp, (q + 1) * self.vp

    # ---- edge -> (rank, block) assignment --------------------------------
    def edge_block(self, src, dst):
        """Map global (src, dst) -> (i, j, b) mesh coordinates + block.

        dst range q_d = dst // vp gives i = q_d % R and b = q_d // R;
        src's column span gives j = src // (R * vp). Vectorizes over numpy
        arrays and tensors.
        """
        q_d = dst // self.vp
        i = q_d % self.rows
        b = q_d // self.rows
        j = src // (self.rows * self.vp)
        return i, j, b

    def validate(self) -> None:
        expects(self.rows >= 1 and self.cols >= 1, "bad mesh shape")
        expects(self.vp >= 1, "empty vertex ranges")
