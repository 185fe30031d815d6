"""Exact betweenness and edge betweenness (k=None, every vertex a source)
of the PyTorch port on an NVIDIA card, on the R-MAT graph of
chip_smoke.py (edgefactor 16, scrambled, renumbered by descending
degree), for comparing two trees of the repo on one card:

    python3 time_brandes.py --scale 14 --save build/bc_a.pt
    python3 time_brandes.py --tree build/other --scale 14 --against build/bc_a.pt

``--tree DIR`` imports cugraph_tpu_torch from DIR, a checkout of another
commit, in place of this one. Each call runs ``--repeats`` times after a
first call; the launches of spmv_sum and spmm_rows are counted over the
first call. Prints the card's name and power limit, then one JSON line:
V, E, each call's first and best warm seconds and launches, and with
``--against`` each result's largest difference from the saved one over
its largest magnitude. Needs CUDA.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None, help="import cugraph_tpu_torch from this checkout")
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--save", default=None, help="torch.save the results here")
    ap.add_argument("--against", default=None, help="compare with results saved by --save")
    args = ap.parse_args(argv)
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    if not torch.cuda.is_available():
        print("time_brandes.py: CUDA is not available", file=sys.stderr)
        return 1
    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.prims.cuda import spmm_rows, spmv_sum

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    v = 1 << args.scale
    gen = torch.Generator(device=dev).manual_seed(0)
    src, dst = ct.rmat_edgelist(args.scale, 16 * v, scramble=True, generator=gen, device=dev)
    new_to_old = ct.compute_renumber_map(src, dst, v, device=dev)
    src, dst = ct.apply_renumber_map(new_to_old, src, dst, device=dev)
    g = ct.from_edgelist(src, dst, num_vertices=v, device=dev)

    calls = {
        "betweenness": lambda: ct.betweenness_centrality(g),
        "edge_betweenness": lambda: ct.edge_betweenness_centrality(g),
    }
    out = {"tree": args.tree or ".", "scale": args.scale, "vertices": v, "edges": g.num_edges,
           "card": smi}
    results = {}
    for name, fn in calls.items():
        spmv_sum.launches = spmm_rows.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        results[name] = fn()
        torch.cuda.synchronize()
        first = time.perf_counter() - t
        launches = {"spmv_sum": spmv_sum.launches, "spmm_rows": spmm_rows.launches}
        warm = []
        for _ in range(args.repeats):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t)
        out[name] = {"first_s": first, "warm_s": min(warm) if warm else None,
                     "launches": launches}
    if args.save:
        torch.save({k: r.cpu() for k, r in results.items()}, args.save)
    if args.against:
        ref = torch.load(args.against)
        for name, r in results.items():
            want = ref[name].double()
            err = (r.cpu().double() - want).abs().max() / want.abs().max().clamp(min=1e-300)
            out[name]["rel_diff_against"] = err.item()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
