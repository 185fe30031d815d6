"""The probe kernels (csrc/probes.cu) and their plain versions:
stream_scale, gather_rows, gather_window_sum, multiwin_reduce and
seg_scan_rows.

Counterparts of the TPU probes in the JAX package's ``benchmarks/``
(``microbench_tpu.py``, ``microbench3_tpu.py``, ``microbench4_rowgather.py``,
``microbench5_rowgather.py``, ``microbench6_bf16row.py``; csrc/probes.cu
names each site). No algorithm calls them: their entry point is
``cugraph_tpu_torch.microbench``, which measures the card's copy and
gather rates with them. A CUDA tensor launches the kernel (and counts the
launch in ``<name>.launches``); a CPU tensor takes the plain version
(``<name>_reference``). There is no fallback from one to the other.

Every index a caller gives is checked with one host read before a launch
and raises ``GraphError`` when it lies outside its array, on either
device: on the card such an index would fault the process's CUDA context.
"""

from __future__ import annotations

import torch

from ...utils.error import GraphError
from . import build
from ._launch import on_device, raise_on_error, stream_of

LANES = 128  # multiwin_reduce's lanes a row of edges (a window is kWindowEdges = 8 x 128)
WINDOW_ROWS = 512  # gather_window_sum's rows a window, W (csrc/probes.cu kWindowRows)
TILES_PER_WINDOW = 4  # tiles of edges a window (microbench4_rowgather.py: t // 4)
WINDOW_LANES = 32  # lanes a block of gather_window_sum sums (kWinLanes)
WINDOW_EDGE_ROWS = 8  # multiwin_reduce's rows of edges a window, LW
CAP_V = 256  # multiwin_reduce's slots a window (kCapV)
SEG_TILE_ROWS = 512  # seg_scan_rows' tile (kSegTile)


def _on(name: str, *tensors: torch.Tensor) -> str:
    """The device type every tensor shares: "cpu" or "cuda"; raises on
    mixed devices or any other device."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: tensors must be CUDA or CPU tensors, got {dev}")
    return dev.type


def _f32(name: str, arg: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous float32, got {t.dtype}")


def _ints(name: str, arg: str, t: torch.Tensor) -> None:
    if t.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: {arg} must be int32 or int64, got {t.dtype}")


def _expect_in_range(name: str, *checks) -> None:
    """Raise GraphError unless every (arg, ids, lo, hi) has lo <= ids < hi:
    one reduction an argument (its min and max), one host read for all."""
    given = [c for c in checks if c[1].numel()]
    if not given:
        return
    ends = torch.stack([torch.stack(torch.aminmax(ids)).to(torch.int64) for _, ids, _, _ in given])
    for (arg, _, lo, hi), (least, most) in zip(given, ends.tolist()):
        if least < lo or most >= hi:
            raise GraphError(f"{name}: {arg} out of range [{lo}, {hi})")


def _i32(t: torch.Tensor) -> torch.Tensor:
    """Ids as contiguous int32 (checked in range, so nothing is cut)."""
    return t if t.dtype == torch.int32 and t.is_contiguous() else t.to(torch.int32).contiguous()


# ------------------------------------------------------------- stream_scale


def stream_scale_reference(x: torch.Tensor, a: float) -> torch.Tensor:
    """Plain version of stream_scale: one f32 product an element."""
    _f32("stream_scale", "x", x)
    return x * torch.tensor(a, dtype=torch.float32, device=x.device)


def stream_scale(x: torch.Tensor, a: float) -> torch.Tensor:
    """o = a * x for contiguous float32 x of any shape, a rounded to f32:
    the streaming copy (``microbench_tpu.py:k1_copy``,
    ``microbench3_tpu.py``'s ``copy_kern``)."""
    if _on("stream_scale", x) == "cpu":
        return stream_scale_reference(x, a)
    _f32("stream_scale", "x", x)
    o = torch.empty_like(x)
    n = x.numel()
    vec = int(n % 4 == 0 and x.data_ptr() % 16 == 0)
    with on_device(x.device):
        rc = build.load("probes").cgt_stream_scale(
            x.data_ptr(), o.data_ptr(), n, float(a), vec, stream_of(x.device))
    raise_on_error("stream_scale", rc)
    stream_scale.launches += 1
    return o


stream_scale.launches = 0


# -------------------------------------------------------------- gather_rows


def _check_gather(table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("gather_rows: table must be a contiguous 2-D tensor")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gather_rows: table must be float32 or bfloat16, got {table.dtype}")
    _ints("gather_rows", "ids", ids)
    if table.shape[0] >= 2**31:
        raise ValueError("gather_rows: too many table rows for int32 ids")
    _expect_in_range("gather_rows", ("ids", ids, 0, table.shape[0]))


def gather_rows_reference(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version of gather_rows: ``index_select`` on the flat ids."""
    _on("gather_rows", table, ids)
    _check_gather(table, ids)
    return table.index_select(0, ids.reshape(-1).to(torch.int64))


def _vec_bytes(row_bytes: int, *ptrs: int) -> int:
    """The unit of gather_rows' copy: of 16, 8, 4 and 2 bytes, those that
    divide a row and every pointer; the widest that still gives each of a
    warp's 32 lanes a unit of the row (an f32 row of 128: 16 B; bf16: 8 B),
    else the widest."""
    fits = [v for v in (16, 8, 4, 2) if row_bytes % v == 0 and all(p % v == 0 for p in ptrs)]
    if not fits:
        raise ValueError("gather_rows: rows are not whole 2-byte units")
    return next((v for v in fits if row_bytes // v >= 32), fits[0])


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(ids.numel(), width) rows of ``table`` (float32 or bfloat16), row i
    ``table[ids.flat[i]]``: the per-edge row gather
    (``microbench4_rowgather.py``, ``microbench5_rowgather.py``,
    ``microbench6_bf16row.py``). Raises GraphError on an id outside
    [0, rows)."""
    if _on("gather_rows", table, ids) == "cpu":
        return gather_rows_reference(table, ids)
    _check_gather(table, ids)
    flat = _i32(ids.reshape(-1))
    out = torch.empty(flat.numel(), table.shape[1], dtype=table.dtype, device=table.device)
    return _launch_gather_rows(table, flat, out)


def _launch_gather_rows(table: torch.Tensor, flat: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """gather_rows' launch into ``out`` on contiguous int32 ``flat`` ids
    that the caller has checked against ``table`` (the entry point times
    the kernel alone this way, its ids checked once)."""
    row_bytes = table.shape[1] * table.element_size()
    if flat.numel() == 0 or row_bytes == 0:
        return out
    vec = _vec_bytes(row_bytes, table.data_ptr(), out.data_ptr())
    with on_device(table.device):
        rc = build.load("probes").cgt_gather_rows(
            table.data_ptr(), flat.data_ptr(), out.data_ptr(), flat.numel(), row_bytes, vec,
            stream_of(table.device))
    raise_on_error("gather_rows", rc)
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


# -------------------------------------------------------- gather_window_sum


def _check_window(table: torch.Tensor, srcs: torch.Tensor, dstl: torch.Tensor) -> int:
    """Raise on what gather_window_sum does not take; returns the number
    of windows."""
    _f32("gather_window_sum", "table", table)
    if table.dim() != 2 or table.shape[1] % WINDOW_LANES:
        raise ValueError(f"gather_window_sum: table must be (rows, a multiple of "
                         f"{WINDOW_LANES}) float32, got {tuple(table.shape)}")
    for arg, t in (("srcs", srcs), ("dstl", dstl)):
        _ints("gather_window_sum", arg, t)
    if srcs.dim() != 2 or srcs.shape != dstl.shape or srcs.shape[0] % TILES_PER_WINDOW:
        raise ValueError(f"gather_window_sum: srcs and dstl must be equal (tiles, edges) with "
                         f"tiles a multiple of {TILES_PER_WINDOW}")
    if table.shape[0] >= 2**31 or srcs.numel() >= 2**31:
        raise ValueError("gather_window_sum: too large for int32 ids")
    _expect_in_range("gather_window_sum", ("srcs", srcs, 0, table.shape[0]),
                     ("dstl", dstl, 0, WINDOW_ROWS))
    return srcs.shape[0] // TILES_PER_WINDOW


def gather_window_sum_reference(table: torch.Tensor, srcs: torch.Tensor,
                                dstl: torch.Tensor) -> torch.Tensor:
    """Plain version of gather_window_sum: the gathered rows rounded to
    bf16, then an f32 ``index_add_`` at window * W + dstl into zeros."""
    _on("gather_window_sum", table, srcs, dstl)
    n_win = _check_window(table, srcs, dstl)
    rows = table.index_select(0, srcs.reshape(-1).to(torch.int64))
    rows = rows.to(torch.bfloat16).to(torch.float32)
    win = torch.arange(srcs.shape[0], device=table.device) // TILES_PER_WINDOW
    keys = (win * WINDOW_ROWS).repeat_interleave(srcs.shape[1]) + dstl.reshape(-1).to(torch.int64)
    out = torch.zeros(n_win * WINDOW_ROWS, table.shape[1], dtype=torch.float32, device=table.device)
    return out.index_add_(0, keys, rows)


def gather_window_sum(table: torch.Tensor, srcs: torch.Tensor, dstl: torch.Tensor) -> torch.Tensor:
    """(windows * W, width) float32, W = 512: window w holds tiles
    [4w, 4w + 4) of (srcs, dstl) (each (tiles, edges)); its row r is the
    f32 sum of ``bf16(table[s])`` over the window's edges (s, r). Every row
    is written, zeros where no edge lands. The gather and one-hot product
    of ``microbench4_rowgather.py:gather_matmul_call``. The kernel adds in
    no fixed order: sums agree with the plain version to f32 rounding, not
    to the bit. Raises GraphError on srcs outside [0, table rows) or dstl
    outside [0, W)."""
    if _on("gather_window_sum", table, srcs, dstl) == "cpu":
        return gather_window_sum_reference(table, srcs, dstl)
    n_win = _check_window(table, srcs, dstl)
    out = torch.empty(n_win * WINDOW_ROWS, table.shape[1], dtype=torch.float32,
                      device=table.device)
    return _launch_gather_window_sum(table, _i32(srcs), _i32(dstl), out)


def _launch_gather_window_sum(table: torch.Tensor, srcs: torch.Tensor, dstl: torch.Tensor,
                              out: torch.Tensor) -> torch.Tensor:
    """gather_window_sum's launch into ``out`` on contiguous int32 ids
    that the caller has checked."""
    n_win = srcs.shape[0] // TILES_PER_WINDOW
    if n_win == 0:
        return out
    with on_device(table.device):
        rc = build.load("probes").cgt_gather_window_sum(
            table.data_ptr(), srcs.data_ptr(), dstl.data_ptr(), out.data_ptr(), n_win,
            table.shape[1], srcs.numel() // n_win, stream_of(table.device))
    raise_on_error("gather_window_sum", rc)
    gather_window_sum.launches += 1
    return out


gather_window_sum.launches = 0


# ---------------------------------------------------------- multiwin_reduce


def _check_multiwin(wstart: torch.Tensor, vals: torch.Tensor, gdl: torch.Tensor,
                    out_rows: int) -> None:
    """Raise on what multiwin_reduce does not take."""
    _f32("multiwin_reduce", "vals", vals)
    _ints("multiwin_reduce", "gdl", gdl)
    _ints("multiwin_reduce", "wstart", wstart)
    if vals.dim() != 2 or gdl.shape != vals.shape or vals.shape[0] % WINDOW_EDGE_ROWS:
        raise ValueError(f"multiwin_reduce: vals and gdl must be equal (rows, lanes) with rows "
                         f"a multiple of {WINDOW_EDGE_ROWS}")
    if vals.shape[1] != LANES:
        raise ValueError(f"multiwin_reduce: a window is {WINDOW_EDGE_ROWS} rows of {LANES} "
                         f"lanes, got {vals.shape[1]} lanes")
    n_win = vals.shape[0] // WINDOW_EDGE_ROWS
    if wstart.shape != (n_win,):
        raise ValueError(f"multiwin_reduce: wstart must hold one start a window ({n_win})")
    size = out_rows * vals.shape[1]
    if size >= 2**31 or vals.numel() >= 2**31:
        raise ValueError("multiwin_reduce: too large for int32 offsets")
    _expect_in_range("multiwin_reduce", ("gdl", gdl, 0, CAP_V),
                     ("wstart", wstart, 0, size - CAP_V + 1))


def multiwin_reduce_reference(wstart: torch.Tensor, vals: torch.Tensor, gdl: torch.Tensor,
                              out_rows: int) -> torch.Tensor:
    """Plain version of multiwin_reduce: ``index_add_`` of the flat vals at
    wstart[window] + gdl into zeros."""
    _on("multiwin_reduce", wstart, vals, gdl)
    _check_multiwin(wstart, vals, gdl, out_rows)
    keys = (wstart.to(torch.int64).repeat_interleave(WINDOW_EDGE_ROWS * vals.shape[1])
            + gdl.reshape(-1).to(torch.int64))
    out = torch.zeros(out_rows * vals.shape[1], dtype=torch.float32, device=vals.device)
    return out.index_add_(0, keys, vals.reshape(-1)).view(out_rows, vals.shape[1])


def multiwin_reduce(wstart: torch.Tensor, vals: torch.Tensor, gdl: torch.Tensor,
                    out_rows: int) -> torch.Tensor:
    """(out_rows, 128) float32, zero but for ``out.flat[wstart[w] + gdl[e]]
    += vals[e]`` over each window w of 8 rows of (vals, gdl): the windowed
    scatter-reduce of ``microbench_tpu.py:k6_multiwin_reduce`` (windows may
    overlap). Adds in no fixed order: sums agree with the plain version to
    f32 rounding, not to the bit. Raises GraphError on gdl outside [0, 256)
    or a window reaching past the output."""
    if _on("multiwin_reduce", wstart, vals, gdl) == "cpu":
        return multiwin_reduce_reference(wstart, vals, gdl, out_rows)
    _check_multiwin(wstart, vals, gdl, out_rows)
    out = torch.zeros(out_rows, vals.shape[1], dtype=torch.float32, device=vals.device)
    return _launch_multiwin_reduce(_i32(wstart), vals, _i32(gdl), out)


def _launch_multiwin_reduce(wstart: torch.Tensor, vals: torch.Tensor, gdl: torch.Tensor,
                            out: torch.Tensor) -> torch.Tensor:
    """multiwin_reduce's launch, adding into ``out``, on contiguous int32
    ids that the caller has checked."""
    if wstart.numel() == 0:
        return out
    with on_device(vals.device):
        rc = build.load("probes").cgt_multiwin_reduce(
            wstart.data_ptr(), vals.data_ptr(), gdl.data_ptr(), out.data_ptr(), wstart.numel(),
            stream_of(vals.device))
    raise_on_error("multiwin_reduce", rc)
    multiwin_reduce.launches += 1
    return out


multiwin_reduce.launches = 0


# ------------------------------------------------------------ seg_scan_rows


def _check_seg(v: torch.Tensor, flags: torch.Tensor) -> None:
    _f32("seg_scan_rows", "v", v)
    _f32("seg_scan_rows", "flags", flags)
    if v.dim() != 2 or flags.shape != v.shape:
        raise ValueError("seg_scan_rows: v and flags must be equal 2-D shapes")
    if v.shape[1] >= 2**31:
        raise ValueError("seg_scan_rows: too many lanes")


def seg_scan_rows_reference(v: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Plain version of seg_scan_rows: the tiles' rows in order, each row
    ``v`` where it starts a segment, else the previous row's sum + ``v``
    (the kernel's additions, in its order)."""
    _on("seg_scan_rows", v, flags)
    _check_seg(v, flags)
    rows, width = v.shape
    n_tiles = -(-rows // SEG_TILE_ROWS)
    pad = n_tiles * SEG_TILE_ROWS - rows
    x = torch.cat([v, v.new_zeros(pad, width)]).view(n_tiles, SEG_TILE_ROWS, width)
    start = torch.cat([flags != 0, flags.new_ones(pad, width, dtype=torch.bool)])
    start = start.view(n_tiles, SEG_TILE_ROWS, width)
    out = torch.empty_like(x)
    out[:, 0] = x[:, 0]
    for r in range(1, SEG_TILE_ROWS):
        out[:, r] = torch.where(start[:, r], x[:, r], out[:, r - 1] + x[:, r])
    return out.view(-1, width)[:rows]


def seg_scan_rows(v: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Per lane, within each tile of 512 rows of ``v`` (rows, lanes)
    float32: the inclusive sum down the rows, restarting where ``flags``
    is not 0 and at each tile's first row (a last tile may be short). The
    segmented scan of ``microbench_tpu.py:k8_seg_scan_reduce``, added in
    row order, so the same bits as the plain version."""
    if _on("seg_scan_rows", v, flags) == "cpu":
        return seg_scan_rows_reference(v, flags)
    _check_seg(v, flags)
    out = torch.empty_like(v)
    if v.numel() == 0:
        return out
    with on_device(v.device):
        rc = build.load("probes").cgt_seg_scan_rows(
            v.data_ptr(), flags.data_ptr(), out.data_ptr(), v.shape[0], v.shape[1],
            stream_of(v.device))
    raise_on_error("seg_scan_rows", rc)
    seg_scan_rows.launches += 1
    return out


seg_scan_rows.launches = 0
