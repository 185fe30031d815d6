"""Reduction monoids for the prims layer.

Counterpart of ``cugraph_tpu/prims/reduce_ops.py`` (ref:
cpp/src/prims/reduce_op.cuh). Each op carries its identity and its
reduction by segment id: ``index_add_`` for the sum, ``scatter_reduce_``
for min and max.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ReduceOp:
    name: str
    scatter: str  # "sum" | "amin" | "amax"

    def identity(self, dtype: torch.dtype):
        if self.scatter == "sum":
            return 0
        info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
        if self.scatter == "amin":
            return float("inf") if dtype.is_floating_point else info.max
        return float("-inf") if dtype.is_floating_point else info.min

    def combine(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.scatter == "sum":
            return a + b
        return torch.minimum(a, b) if self.scatter == "amin" else torch.maximum(a, b)

    def reduce(self, values: torch.Tensor, init=None) -> torch.Tensor:
        """Reduce along dim 0 in the values' dtype (bools count as int32),
        combined with ``init`` if given; the identity when there are no
        values."""
        if values.dtype == torch.bool:
            values = values.to(torch.int32)
        if values.shape[0] == 0:
            out = torch.full(
                tuple(values.shape[1:]), self.identity(values.dtype),
                dtype=values.dtype, device=values.device,
            )
        elif self.scatter == "sum":
            out = values.sum(0, dtype=values.dtype)
        else:
            out = values.amin(0) if self.scatter == "amin" else values.amax(0)
        if init is not None:
            out = self.combine(out, torch.as_tensor(init, dtype=out.dtype, device=out.device))
        return out

    def segment(
        self, values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
    ) -> torch.Tensor:
        """out[s] = reduce over values[i] with segment_ids[i] == s; the
        identity where a segment is empty. Reduces along dim 0."""
        out = torch.full(
            (num_segments,) + tuple(values.shape[1:]),
            self.identity(values.dtype),
            dtype=values.dtype,
            device=values.device,
        )
        if self.scatter == "sum":
            return out.index_add_(0, segment_ids, values)
        idx = segment_ids.to(torch.int64).view((-1,) + (1,) * (values.dim() - 1))
        return out.scatter_reduce_(0, idx.expand_as(values), values, self.scatter)


PLUS = ReduceOp("plus", "sum")
MINIMUM = ReduceOp("minimum", "amin")
MAXIMUM = ReduceOp("maximum", "amax")
# "any": an arbitrary contributing value (ref reduce_op::any, BFS and SSSP
# predecessors); the minimum, for determinism, as in the JAX package
ANY = ReduceOp("any", "amin")
