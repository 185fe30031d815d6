"""Expensive input validation behind a debug flag.

Counterpart of ``cugraph_tpu/utils/validation.py`` (ref: the
``do_expensive_check`` argument of every public reference function, e.g.
per_v_transform_reduce_incoming_outgoing_e.cuh:1087). Enable it with
``set_expensive_checks(True)`` or the ``CUGRAPH_TPU_EXPENSIVE_CHECKS=1``
environment variable, the JAX package's switch.

The checks run on the tensors' device; each check reads the host once.
"""

from __future__ import annotations

import os

import torch

from .error import expects

_ENABLED = os.environ.get("CUGRAPH_TPU_EXPENSIVE_CHECKS", "0") == "1"


def expensive_checks_enabled() -> bool:
    return _ENABLED


def set_expensive_checks(enabled: bool) -> None:
    global _ENABLED
    _ENABLED = bool(enabled)


def _first_failure(flags, messages) -> None:
    """Raise GraphError with the message of the first true flag: the flags
    are 0-d bool tensors on one device, read in one copy to the host."""
    if not flags:
        return
    for bad, msg in zip(torch.stack(flags).tolist(), messages):
        expects(not bad, msg)


def check_edgelist(src, dst, weight, num_vertices: int) -> None:
    """O(E) range and NaN validation (ref: create_graph_from_edgelist
    checks). src, dst, weight: tensors (or anything ``torch.as_tensor``
    takes) on one device."""
    if not _ENABLED:
        return
    src, dst = torch.as_tensor(src), torch.as_tensor(dst)
    flags, messages = [], []
    if src.numel():
        flags += [src.min() < 0, src.max() >= num_vertices]
        messages += ["negative src vertex id", "src vertex id out of range"]
    if dst.numel():
        flags += [dst.min() < 0, dst.max() >= num_vertices]
        messages += ["negative dst vertex id", "dst vertex id out of range"]
    if weight is not None:
        flags.append(~torch.isfinite(torch.as_tensor(weight)).all())
        messages.append("non-finite edge weight")
    _first_failure(flags, messages)


def check_vertex_values(values, num_vertices: int, name: str = "values") -> None:
    if not _ENABLED:
        return
    v = torch.as_tensor(values)
    expects(
        v.shape[0] == num_vertices,
        f"{name}: expected leading dim {num_vertices}, got {v.shape[0]}",
    )
    if v.is_floating_point():
        _first_failure([~torch.isfinite(v).all()], [f"{name}: non-finite entries"])
