"""Argument checks and ctypes plumbing shared by the kernel wrappers."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ...core.csr import CompressedAdj


def check_operands(
    kernel: str, adj: CompressedAdj, x: torch.Tensor, weights: Optional[torch.Tensor]
) -> None:
    """Raise on anything the kernel does not take: every operand on the
    same CUDA device, int32 CSC arrays, f32 contiguous values, ids that
    fit a C int."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{kernel}: x must be a CUDA or CPU tensor, got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{kernel}: x must be contiguous float32, got {x.dtype}")
    if x.shape[0] != adj.num_minors:
        raise ValueError(f"{kernel}: x has {x.shape[0]} rows, graph has {adj.num_minors}")
    tensors = [adj.offsets, adj.minors] + ([] if weights is None else [weights])
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{kernel}: graph on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: graph arrays must be contiguous")
    if adj.offsets.dtype != torch.int32 or adj.minors.dtype != torch.int32:
        raise ValueError(f"{kernel}: offsets and minors must be int32")
    if weights is not None and weights.dtype != torch.float32:
        raise ValueError(f"{kernel}: weights must be float32")
    if adj.num_edges >= 2**31 or adj.num_majors >= 2**31:
        raise ValueError(f"{kernel}: graph too large for int32 offsets")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_of(device: torch.device) -> int:
    """The raw handle of the current stream on ``device``. The raw query
    skips building a ``torch.cuda.Stream``: every launch pays this call."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(device).cuda_stream
    return raw(device.index)


def on_device(device: torch.device):
    """The device guard a launch needs: none when ``device`` is already
    the current one, the common case, whose guard would cost more host
    time than a short kernel's launch."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def raise_on_error(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed, cudaError {rc}")

