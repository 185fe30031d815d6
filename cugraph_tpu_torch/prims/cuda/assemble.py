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
version checks the ids first, the kernel skips such a step and raises a
flag that the wrapper reads after the launch.
"""

from __future__ import annotations

import torch

from . import build
from ._launch import raise_on_error, stream_of


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


def assemble_chunks(
    binned: torch.Tensor,
    chunk_src: torch.Tensor,
    chunk_dst: torch.Tensor,
    chunk_rows: int,
    out_rows: int,
) -> torch.Tensor:
    """(out_rows, lanes) float32: chunk i of ``binned`` (``chunk_rows``
    rows) copied to chunk ``chunk_dst[i]`` of the output, zeros elsewhere."""
    if binned.device.type == "cpu":
        return assemble_chunks_reference(binned, chunk_src, chunk_dst, chunk_rows, out_rows)
    if binned.device.type != "cuda":
        raise RuntimeError(f"assemble_chunks: binned must be a CUDA or CPU tensor, got {binned.device}")
    width = _check(binned, chunk_src, chunk_dst, chunk_rows, out_rows)
    if width % 4:
        raise ValueError(f"assemble_chunks: a chunk of {width} floats is not whole float4s")
    if binned.data_ptr() % 16:
        raise ValueError("assemble_chunks: binned must be 16 B aligned")
    in_chunks, out_chunks = binned.shape[0] // chunk_rows, out_rows // chunk_rows
    if max(in_chunks, out_chunks, chunk_src.numel()) >= 2**31:
        raise ValueError("assemble_chunks: too many chunks for int32 chunk ids")
    cs = chunk_src.to(torch.int32).contiguous()
    cd = chunk_dst.to(torch.int32).contiguous()
    out = torch.empty(out_rows, binned.shape[1], dtype=torch.float32, device=binned.device)
    inv = torch.empty(out_chunks + 1, dtype=torch.int32, device=binned.device)  # + error flag
    with torch.cuda.device(binned.device):
        rc = build.load("assemble").cgt_assemble_chunks(
            binned.data_ptr(), cs.data_ptr(), cd.data_ptr(), inv.data_ptr(), out.data_ptr(),
            cs.numel(), in_chunks, out_chunks, width // 4, stream_of(binned.device),
        )
    raise_on_error("assemble_chunks", rc)
    if int(inv[out_chunks]):
        raise _bad_ids()
    assemble_chunks.launches += 1
    return out


assemble_chunks.launches = 0
