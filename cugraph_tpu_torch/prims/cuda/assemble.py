"""assemble_chunks: the chunk-copy kernel (csrc/assemble.cu) and its plain
version.

Counterpart of ``cugraph_tpu/prims/pallas/spmv2.py:_assemble_call`` (def
1605, ``pallas_call`` 1627), the sorted engine's standalone K-C1 assembly.
No path of the JAX package calls it (its round 3 fused the copy into
``_sort_reduce_call``), and no path of the port does: it is an entry point
of its own.

    out rows [cd[i]*CH, (cd[i]+1)*CH) <- binned rows [cs[i]*CH, (cs[i]+1)*CH)

``chunk_src`` may repeat a chunk; ``chunk_dst`` is unique. Output rows that
no chunk writes are zero (the Pallas kernel leaves them undefined). A CUDA
tensor launches the kernel (and counts the launch in
``assemble_chunks.launches``); a CPU tensor takes the plain version. A
chunk id outside its array raises ValueError on either device: the plain
version checks the ids first; on the card the index kernel raises a flag
in pinned host memory, which the C call reads once that kernel is done,
while the copy runs.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import build
from ._launch import on_device, raise_on_error, stream_of


def _check(binned, chunk_src, chunk_dst, chunk_rows: int, out_rows: int) -> int:
    """Raise on what the function does not take; returns the floats per
    chunk."""
    if binned.dim() != 2 or binned.dtype != torch.float32 or not binned.is_contiguous():
        raise ValueError("assemble_chunks: binned must be a contiguous 2-D float32 tensor")
    if chunk_rows <= 0 or binned.shape[0] % chunk_rows or out_rows % chunk_rows:
        raise ValueError(
            f"assemble_chunks: {binned.shape[0]} binned rows and {out_rows} output rows "
            f"must be multiples of chunk_rows={chunk_rows}"
        )
    if chunk_src.shape != chunk_dst.shape or chunk_src.dim() != 1:
        raise ValueError("assemble_chunks: chunk_src and chunk_dst must be 1-D, equal length")
    for t in (chunk_src, chunk_dst):
        if t.device != binned.device:
            raise ValueError(f"assemble_chunks: chunk ids on {t.device}, binned on {binned.device}")
    return chunk_rows * binned.shape[1]


def _bad_ids() -> ValueError:
    return ValueError("assemble_chunks: a chunk id lies outside its array")


def assemble_chunks_reference(
    binned: torch.Tensor,
    chunk_src: torch.Tensor,
    chunk_dst: torch.Tensor,
    chunk_rows: int,
    out_rows: int,
) -> torch.Tensor:
    """Plain version of assemble_chunks, on any device: ``index_select`` on
    the (chunks, CH*lanes) view, then ``index_copy_`` into zeros."""
    width = _check(binned, chunk_src, chunk_dst, chunk_rows, out_rows)
    for ids, n in ((chunk_src, binned.shape[0] // chunk_rows), (chunk_dst, out_rows // chunk_rows)):
        if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= n):
            raise _bad_ids()
    src = binned.view(-1, width).index_select(0, chunk_src.to(torch.int64))
    out = torch.zeros(out_rows // chunk_rows, width, dtype=binned.dtype, device=binned.device)
    out.index_copy_(0, chunk_dst.to(torch.int64), src)
    return out.view(out_rows, binned.shape[1])


# device index -> (one pinned int32, the C call's bad-id flag; the event
# the call waits on), both used only inside the call; the lock keeps calls
# from threads one at a time
_per_device: dict = {}
_lock = threading.Lock()


def _flag_and_event(device: torch.device):
    """The pinned flag and the event of ``device``, made on its first call
    (under ``_lock``, on the device)."""
    got = _per_device.get(device.index)
    if got is None:
        event = ctypes.c_void_p()
        raise_on_error("assemble_chunks", build.load("assemble").cgt_assemble_event(
            ctypes.byref(event)))
        got = _per_device[device.index] = (
            torch.empty(1, dtype=torch.int32, pin_memory=True), event.value)
    return got


def _ids(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as contiguous ``dtype``, without a copy where it already is."""
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def assemble_chunks(
    binned: torch.Tensor,
    chunk_src: torch.Tensor,
    chunk_dst: torch.Tensor,
    chunk_rows: int,
    out_rows: int,
) -> torch.Tensor:
    """(out_rows, lanes) float32: chunk i of ``binned`` (``chunk_rows``
    rows) copied to chunk ``chunk_dst[i]`` of the output, zeros elsewhere.
    On the card the call waits for the index pass (it reads the kernel's
    bad-id flag), not for the copy; the output is a view at the front of
    one allocation that also holds the copy's index (4 B an output
    chunk)."""
    dev = binned.device
    if dev.type == "cpu":
        return assemble_chunks_reference(binned, chunk_src, chunk_dst, chunk_rows, out_rows)
    if dev.type != "cuda":
        raise RuntimeError(f"assemble_chunks: binned must be a CUDA or CPU tensor, got {dev}")
    width = _check(binned, chunk_src, chunk_dst, chunk_rows, out_rows)
    if width % 4:
        raise ValueError(f"assemble_chunks: a chunk of {width} floats is not whole float4s")
    if binned.data_ptr() % 16:
        raise ValueError("assemble_chunks: binned must be 16 B aligned")
    in_chunks, out_chunks = binned.shape[0] // chunk_rows, out_rows // chunk_rows
    if max(in_chunks, out_chunks, chunk_src.numel()) >= 2**31:
        raise ValueError("assemble_chunks: too many chunks for int32 chunk ids")
    # int64 ids go to the kernel as they are: cutting them to int32 could
    # wrap an id outside the arrays into them
    wide = torch.int64 in (chunk_src.dtype, chunk_dst.dtype)
    id_dtype = torch.int64 if wide else torch.int32
    cs, cd = _ids(chunk_src, id_dtype), _ids(chunk_dst, id_dtype)
    # one allocation: the output, then the inverse (4 B an output chunk),
    # which the copy reads after the call returns; on a bad id the copy
    # still runs and the allocation goes back to the stream's pool
    n = out_rows * binned.shape[1]
    buf = torch.empty(n + out_chunks, dtype=torch.float32, device=dev)
    with _lock, on_device(dev):
        flag, event = _flag_and_event(dev)
        rc = build.load("assemble").cgt_assemble_chunks(
            binned.data_ptr(), cs.data_ptr(), cd.data_ptr(), buf.data_ptr() + 4 * n,
            buf.data_ptr(), flag.data_ptr(), event, cs.numel(), in_chunks, out_chunks,
            width // 4, int(wide), stream_of(dev),
        )
    if rc == -1:
        raise _bad_ids()
    raise_on_error("assemble_chunks", rc)
    assemble_chunks.launches += 1
    return buf[:n].view(out_rows, binned.shape[1])


assemble_chunks.launches = 0
