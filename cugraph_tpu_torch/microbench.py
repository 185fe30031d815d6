"""The TPU probes of the JAX package's benchmarks/, on the card.

    python -m cugraph_tpu_torch.microbench [--rows N] [--table-rows N]
        [--probes NAME,...] [--seed S] [--device D]

The counterpart of the main()s of ``benchmarks/microbench_tpu.py`` (k1,
k6, k8), ``microbench3_tpu.py`` (b0, b6, b7), ``microbench4_rowgather.py``,
``microbench5_rowgather.py`` and ``microbench6_bf16row.py``, on the port's
probe kernels (``prims/cuda/probes.py``). Inputs are made with numpy
from ``--seed``, at the probes' shapes by default: ``--rows`` rows of 128
lanes for the copy, the window reduce and the segmented scan; the
probes' 2,048 tiles of 128 edges into a ``--table-rows`` table for the
gathers. Two more shapes measure the card's ceilings: ``--rows 2097152``
(1 GiB each way, far past the 50 MB L2) gives the HBM copy rate, and
``--table-rows 2097152`` (s21's vertex count) the gather rate from HBM,
where the probe's own 16 MB table sits in the L2.

One line a probe, in the probes' form: name, ms, Gelem/s, chk. ``ms`` is
the card's time for one launch, from back-to-back launches between two
CUDA events (for the chains, the slope (t(33) - t(1)) / 32 of
``microbench5_rowgather.py``); ``call`` is the median of single calls of
the wrapper, each alone between two events, host time included, and
``b2b`` the wrapper's calls back to back. For the gathers, the window sum
and the window reduce the launch is timed alone, its ids checked once
before, and the wrapper's time includes its id check (one host read); for
the copy and the scan the launch is the wrapper. An element is a row for
the gathers, an edge for the window sum and the window reduce, a float
for the rest.

``device=None`` means the card and raises without CUDA. With ``--device
cpu`` the plain versions run and the host clock times them: those are not
the card's numbers.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .prims.cuda import probes
from .utils.device import DeviceLike, resolve_device

# the probes' constants (benchmarks/microbench*.py), kept here
LANES = 128
ROWS = 131072  # --rows of microbench_tpu.py and microbench3_tpu.py
TR = 1 << 15  # table rows of microbench4/5/6 (32K x 128 f32 = 16 MB)
T = 128  # edges a tile
N_TILES = 2048  # tiles a pass: 262,144 edges
W = 512  # rows a destination window (microbench4_rowgather.py)
LW, CAP_V = 8, 256  # k6: rows of edges a window, slots a window
MWR_OUT_ROWS = 8192 + CAP_V // LANES  # k6's output rows
COPY_SCALE = {"k1_copy": 2.0, "b0_copy": 1.000001}
CHAIN_SCALE = {torch.float32: 1e-3, torch.bfloat16: 1e-2}  # microbench5 / microbench6
CHAIN_K = (1, 33)
REPS = 20  # calls a median, and calls a back-to-back round
PROBES = ("k1_copy", "b0_copy", "gather_f32", "gather_bf16", "gather_f32_chain",
          "gather_bf16_chain", "gather_window_sum", "k6_multiwin_reduce", "k8_seg_scan_reduce")


# ------------------------------------------------------------------ inputs


def _rng(seed: int, stream: int) -> np.random.Generator:
    """One generator an input, so that any subset of the probes sees the
    same values."""
    return np.random.default_rng([seed, stream])


def probe_inputs(names: Sequence[str], rows: int = ROWS, table_rows: int = TR,
                 seed: int = 0, device: DeviceLike = None) -> Dict:
    """The named inputs of the probes: x (rows, 128) U[0, 1) f32; table
    (table_rows, 128) N(0, 1) f32; srcs (N_TILES, 128) in [0, table_rows),
    dstl (N_TILES, 128) in [0, W); vals (rows, 128) U[0, 1) f32, gdl in
    [0, CAP_V), wstart a multiple of CAP_V a window of LW rows, each as
    microbench_tpu.py's k6 draws them; v U[0, 1) and flags (1.0 with
    probability 0.1) as k8 draws them."""
    dev = resolve_device(device)
    make = {
        "x": lambda: _rng(seed, 0).random((rows, LANES), dtype=np.float32),
        "table": lambda: _rng(seed, 1).standard_normal((table_rows, LANES), dtype=np.float32),
        "srcs": lambda: _rng(seed, 2).integers(0, table_rows, (N_TILES, T), dtype=np.int32),
        "dstl": lambda: _rng(seed, 3).integers(0, W, (N_TILES, T), dtype=np.int32),
        "vals": lambda: _rng(seed, 4).random((rows, LANES), dtype=np.float32),
        "gdl": lambda: _rng(seed, 5).integers(0, CAP_V, (rows, LANES), dtype=np.int32),
        "wstart": lambda: (_rng(seed, 6).integers(
            0, (MWR_OUT_ROWS - CAP_V // LANES) // (CAP_V // LANES), rows // LW) * CAP_V
        ).astype(np.int32),
        "v": lambda: _rng(seed, 7).random((rows, LANES), dtype=np.float32),
        "flags": lambda: (_rng(seed, 8).random((rows, LANES)) < 0.1).astype(np.float32),
    }
    return {n: torch.from_numpy(make[n]()).to(dev) for n in names}


NEEDS = {
    "k1_copy": ("x",), "b0_copy": ("x",),
    "gather_f32": ("table", "srcs"), "gather_bf16": ("table", "srcs"),
    "gather_f32_chain": ("table", "srcs"), "gather_bf16_chain": ("table", "srcs"),
    "gather_window_sum": ("table", "srcs", "dstl"),
    "k6_multiwin_reduce": ("wstart", "vals", "gdl"),
    "k8_seg_scan_reduce": ("v", "flags"),
}


# ------------------------------------------------------------------ probes


def gather_chain(table: torch.Tensor, srcs: torch.Tensor, k: int, gather=None) -> torch.Tensor:
    """microbench5/6's chain: k gathers, each folding its first table-rows
    output rows back into the table (``tb + out[:TR] * c``; in f32 as one
    fused multiply-add, as XLA compiles it). ``gather(tb)`` defaults to
    ``gather_rows(tb, srcs)``."""
    c = CHAIN_SCALE[table.dtype]
    gather = gather or (lambda tb: probes.gather_rows(tb, srcs))
    n = table.shape[0]
    tb = table
    for _ in range(k):
        out = gather(tb)[:n]
        if tb.dtype == torch.float32:
            tb = torch.addcmul(tb, out, torch.tensor(c, dtype=torch.float32, device=tb.device))
        else:
            tb = tb + out * torch.tensor(c, dtype=tb.dtype, device=tb.device)
    return tb


def _probe_calls(name: str, inp: Dict) -> tuple:
    """(call, launch, elements): the wrapper's call; on the card the
    launch alone, on operands checked once here (on the CPU the wrapper
    again); the elements one call handles. A chain's two take k."""
    on_card = next(iter(inp.values())).device.type == "cuda"
    if name in COPY_SCALE:
        x, a = inp["x"], COPY_SCALE[name]

        def call():
            return probes.stream_scale(x, a)

        return call, call, x.numel()
    if name == "k8_seg_scan_reduce":
        v, flags = inp["v"], inp["flags"]

        def call():
            return probes.seg_scan_rows(v, flags)

        return call, call, v.numel()
    if name == "gather_window_sum":
        table, srcs, dstl = inp["table"], inp["srcs"], inp["dstl"]

        def call():
            return probes.gather_window_sum(table, srcs, dstl)

        if not on_card:
            return call, call, srcs.numel()
        out, s32, d32 = call(), probes._i32(srcs), probes._i32(dstl)
        return call, lambda: probes._launch_gather_window_sum(table, s32, d32, out), srcs.numel()
    if name == "k6_multiwin_reduce":
        wstart, vals, gdl = inp["wstart"], inp["vals"], inp["gdl"]

        def call():
            return probes.multiwin_reduce(wstart, vals, gdl, MWR_OUT_ROWS)

        if not on_card:
            return call, call, vals.numel()
        out, w32, g32 = call(), probes._i32(wstart), probes._i32(gdl)
        return call, lambda: probes._launch_multiwin_reduce(w32, vals, g32, out), vals.numel()
    # the gathers
    table = inp["table"] if "f32" in name else inp["table"].to(torch.bfloat16)
    srcs = inp["srcs"]

    def gather(tb):
        return probes.gather_rows(tb, srcs)

    launch = gather
    if on_card:
        gather(table)  # checks the ids against the table once
        flat = probes._i32(srcs.reshape(-1))
        out = torch.empty(flat.numel(), LANES, dtype=table.dtype, device=table.device)

        def launch(tb):
            return probes._launch_gather_rows(tb, flat, out)

    if name.endswith("chain"):
        return (lambda k: gather_chain(table, srcs, k),
                lambda k: gather_chain(table, srcs, k, launch), srcs.numel())
    return lambda: gather(table), lambda: launch(table), srcs.numel()


# ------------------------------------------------------------------ timing


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _span_ms(fn: Callable, device: torch.device, times: int = 1) -> float:
    """ms of ``times`` calls of ``fn``: between two CUDA events on the
    card, on the host clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(times):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t = time.perf_counter()
    for _ in range(times):
        fn()
    return (time.perf_counter() - t) * 1e3


def median_ms(fn: Callable, reps: int, device: torch.device) -> float:
    """Median of ``reps`` single calls, each alone, after one warm-up."""
    fn()
    _sync(device)
    return statistics.median(_span_ms(fn, device) for _ in range(reps))


def back_to_back_ms(fn: Callable, reps: int, device: torch.device) -> float:
    """A call's time from ``reps`` calls back to back (the median of 3
    rounds), after one warm-up."""
    fn()
    _sync(device)
    return statistics.median(_span_ms(fn, device, reps) / reps for _ in range(3))


def run(rows: int = ROWS, table_rows: int = TR, names: Sequence[str] = PROBES,
        seed: int = 0, device: DeviceLike = None) -> List[Dict]:
    """Each named probe once for its check value, then timed; one dict a
    probe: name, chk, elements, the shape and its times: ``kernel_b2b_ms``
    (the launch alone, back to back; for a chain the slope a step),
    ``ms`` (the median of single wrapper calls) and ``back_to_back_ms``
    (the wrapper back to back); a chain has only the first."""
    dev = resolve_device(device)
    unknown = [n for n in names if n not in PROBES]
    if unknown:
        raise ValueError(f"unknown probes {unknown}; probes: {', '.join(PROBES)}")
    inp = probe_inputs(sorted({i for n in names for i in NEEDS[n]}), rows, table_rows, seed, dev)
    results = []
    for name in names:
        call, launch, elements = _probe_calls(name, {i: inp[i] for i in NEEDS[name]})
        if name.endswith("chain"):
            if N_TILES * T < table_rows:
                continue  # the fold takes table-rows output rows
            chk = float(call(3).double().sum())
            t1, t33 = (median_ms(lambda k=k: launch(k), 3, dev) for k in CHAIN_K)
            kernel_ms = (t33 - t1) / (CHAIN_K[1] - CHAIN_K[0])
            ms = b2b_ms = None
        else:
            chk = float(call().double().sum())
            kernel_ms = back_to_back_ms(launch, REPS, dev)
            ms = median_ms(call, REPS, dev)
            b2b_ms = kernel_ms if launch is call else back_to_back_ms(call, REPS, dev)
        results.append(dict(name=name, kernel_b2b_ms=kernel_ms, ms=ms, back_to_back_ms=b2b_ms,
                            gelem_s=elements / kernel_ms / 1e6, chk=chk, elements=elements,
                            rows=rows, table_rows=table_rows, tiles=N_TILES, device=str(dev)))
    return results


def line(r: Dict) -> str:
    """One probe's line, in the probes' form."""
    call = ("" if r["ms"] is None
            else f"   call={r['ms']:.4f} ms   b2b={r['back_to_back_ms']:.4f} ms")
    return (f"{r['name']:24s} {r['kernel_b2b_ms']:9.4f} ms   {r['gelem_s']:8.3f} Gelem/s"
            f"   chk={r['chk']:.6g}{call}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=ROWS, help="rows of 128 lanes (copy, k6, k8)")
    ap.add_argument("--table-rows", type=int, default=TR, help="rows of the gathers' table")
    ap.add_argument("--probes", default=",".join(PROBES), help="comma-separated probe names")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain versions, host clock)")
    print(f"device={kind} rows={args.rows} table_rows={args.table_rows} "
          f"edges={N_TILES * T}", flush=True)
    for r in run(args.rows, args.table_rows, args.probes.split(","), args.seed, dev):
        print(line(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
