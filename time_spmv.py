"""spmv_sum and spmv_minplus of the PyTorch port on an NVIDIA card, on the
benchmark's scale-24 GAP graphs (port_bench/configs/), at forced counts K of
column segments, for choosing the segment rule's constants and for
comparing two trees of the repo on one card:

    python3 time_spmv.py --save build/spmv_k1.pt
    python3 time_spmv.py --tree build/parent --ks 1 --against build/spmv_k1.pt

``--tree DIR`` imports cugraph_tpu_torch from DIR, a checkout of another
commit, in place of this one (a tree without column segments runs K = 1
only); the graphs, timers and checks are this checkout's. Phases:

- the sweep: each graph of ``--graphs`` from ``SEED``, made and stored as
  the benchmark does (generator, symmetrize); then for each K of ``--ks``
  (ranges of ceil(V / K) minors) the plan's one-time build, spmv_sum on a
  PageRank-like x held within chip_smoke.TOL_SUM_REL of float64 and
  spmv_minplus on a BFS-shaped x (10% of the ids, +inf elsewhere) bit-equal
  to its plain version, each relaunched bit-equal, then the median of
  single calls and the back-to-back time, and edges a second;
  ``--save`` keeps the K = 1 results, ``--against`` reports whether they
  are bit-equal to saved ones.
- ``--weighted``: the graphs carry weights in (0, 1], which both SpMVs
  read (spmv_minplus then takes the random x).
- ``--degrees``: Urand graphs of 2^24 vertices and d x 2^24 tuples (one
  direction, no symmetrizing), spmv_sum back to back at each K, for the
  degree below which segments do not pay.

Prints the card's name and power limit, then one JSON line, also written
to ``--out``. Needs CUDA.
"""

import argparse
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

# imported before --tree joins sys.path, so from this checkout
import chip_smoke as cs

REPS = 10  # timed calls of each measurement
SEED = 7


def forced(spmv, width):
    """A block in which every sweep takes ranges of ``width`` minors; a
    tree without segments takes its one sweep."""
    if not hasattr(spmv, "segment_width"):
        return contextlib.nullcontext()
    return cs.forced_segments(width)


def card_graph(config: str, seed: int, weighted: bool = False):
    import torch

    import cugraph_tpu_torch as ct

    with open(f"port_bench/configs/{config}.json") as f:
        cfg = json.load(f)
    gen = importlib.import_module(f"port_bench.gen.{cfg['generator']}")
    src, dst = gen.edges(cfg, seed, cs.DEV)
    v = 1 << int(cfg["scale"])
    w = None
    if weighted:
        w = 1.0 - torch.rand(src.numel(), device=cs.DEV,
                             generator=torch.Generator(device=cs.DEV).manual_seed(seed + 3))
    g = ct.from_edgelist(src, dst, w, num_vertices=v, symmetrize=bool(cfg["symmetrize"]),
                         device=cs.DEV)
    del src, dst
    torch.cuda.empty_cache()
    return g


def timings(fn) -> dict:
    return dict(ms=cs.median_ms(fn, REPS), back_to_back_ms=cs.back_to_back_ms(fn, REPS))


def sweep(g, ks, saved, name) -> dict:
    import torch

    from cugraph_tpu_torch.prims.cuda import spmv, spmv_minplus, spmv_minplus_reference
    from cugraph_tpu_torch.prims.cuda import spmv_sum, spmv_sum_reference

    adj = g.csc()
    v, e = adj.num_minors, adj.num_edges
    gen = torch.Generator(device=cs.DEV).manual_seed(SEED)
    x = torch.rand(v, generator=gen, device=cs.DEV) / v
    ids = torch.arange(v, dtype=torch.float32, device=cs.DEV)
    xb = torch.where(torch.rand(v, generator=gen, device=cs.DEV) < 0.1, ids, float("inf"))
    weighted = adj.weights is not None
    if weighted:
        xb = x
    ref_size = cs.sum_reference(adj, x, spmv_sum_reference)
    min_ref = spmv_minplus_reference(adj, xb, use_weights=weighted)
    out = {"vertices": v, "edges": e}
    if hasattr(spmv, "segment_width"):
        out["rule_width"] = spmv.segment_width(adj, cs.DEV)
    for k in ks:
        width = -(-v // k)
        if k > 1 and not hasattr(spmv, "segment_width"):
            continue
        if hasattr(adj, "segments"):
            adj.segments.clear()
        with forced(spmv, width):
            cs.sync()
            t = time.perf_counter()
            y = spmv_sum(adj, x)
            cs.sync()
            first_s = time.perf_counter() - t
            cs.check_relaunch("spmv_sum", y, lambda: spmv_sum(adj, x))
            _, rel = cs.sum_error(adj, y, x, spmv_sum_reference, ref_size=ref_size)
            cs.require(rel <= cs.TOL_SUM_REL, f"{name} K={k}: spmv_sum error {rel}")
            yb = spmv_minplus(adj, xb, use_weights=weighted)
            cs.sync()
            cs.require(torch.equal(yb, min_ref), f"{name} K={k}: spmv_minplus not bit-exact")
            cs.check_relaunch("spmv_minplus", yb,
                              lambda: spmv_minplus(adj, xb, use_weights=weighted))
            row = dict(width=width, first_call_s=first_s, sum_rel_err=rel,
                       sum=timings(lambda: spmv_sum(adj, x)),
                       minplus=timings(lambda: spmv_minplus(adj, xb, use_weights=weighted)))
        for op in ("sum", "minplus"):
            row[op]["gedges_per_s"] = e / row[op]["back_to_back_ms"] / 1e6
        if k == 1:
            key = (name, "sum"), (name, "minplus")
            if saved is not None and key[0] in saved:
                row["bits_equal_against"] = bool(torch.equal(y.cpu(), saved[key[0]])
                                                 and torch.equal(yb.cpu(), saved[key[1]]))
            out["k1"] = {key[0]: y.cpu(), key[1]: yb.cpu()}
        out[f"K={k}"] = row
        cs.log(f"{name} K={k}: {json.dumps(row)}")
        del y, yb
    if hasattr(adj, "segments"):
        adj.segments.clear()
    return out


def degrees(ds, ks) -> dict:
    import torch

    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.prims.cuda import spmv, spmv_sum

    v = 1 << 24
    out = {}
    for d in ds:
        gen = torch.Generator(device=cs.DEV).manual_seed(SEED + d)
        src = torch.randint(0, v, (d * v,), generator=gen, device=cs.DEV, dtype=torch.int32)
        dst = torch.randint(0, v, (d * v,), generator=gen, device=cs.DEV, dtype=torch.int32)
        adj = ct.from_edgelist(src, dst, num_vertices=v, store="in", device=cs.DEV).csc()
        del src, dst
        x = torch.rand(v, generator=gen, device=cs.DEV) / v
        row = {}
        for k in ks:
            adj.segments.clear()
            with forced(spmv, -(-v // k)):
                row[f"K={k}"] = cs.back_to_back_ms(lambda: spmv_sum(adj, x), REPS)
        row["rule_width"] = spmv.segment_width(adj, cs.DEV)
        out[f"d={d}"] = row
        cs.log(f"urand 2^24 degree {d}: back-to-back ms {json.dumps(row)}")
        del adj, x
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=None, help="import cugraph_tpu_torch from this checkout")
    ap.add_argument("--graphs", default="gap-urand-s24,gap-kron-s24")
    ap.add_argument("--ks", default="1,2,4,8,16")
    ap.add_argument("--degrees", default="", help="average degrees of the Urand phase")
    ap.add_argument("--weighted", action="store_true")
    ap.add_argument("--save", default=None, help="torch.save the K = 1 results here")
    ap.add_argument("--against", default=None, help="compare with results saved by --save")
    ap.add_argument("--out", default="build/time_spmv.json")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    cs.log(smi)
    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.prims.cuda import build

    cs.log(f"cugraph_tpu_torch from {os.path.dirname(ct.__file__)}; "
           f"L2 {torch.cuda.get_device_properties(0).L2_cache_size} bytes")
    build.build(["spmv"])
    for line in build.compiler_report("spmv").splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"  spmv: {line.strip()}")
    result = {"tree": args.tree or ".", "card": smi,
              "l2_bytes": torch.cuda.get_device_properties(0).L2_cache_size}
    saved = torch.load(args.against) if args.against else None
    ks = [int(k) for k in args.ks.split(",")]
    keep = {}
    for name in filter(None, args.graphs.split(",")):
        g = card_graph(name, SEED, args.weighted)
        res = sweep(g, ks, saved, name)
        keep.update(res.pop("k1", {}))
        result[name] = res
        del g
        torch.cuda.empty_cache()
    if args.save:
        torch.save(keep, args.save)
    if args.degrees:
        result["degrees"] = degrees([int(d) for d in args.degrees.split(",")], ks)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
