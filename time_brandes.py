"""Betweenness and spmm_rows of the PyTorch port on an NVIDIA card, on the
R-MAT graph of chip_smoke.py (edgefactor 16, scrambled, renumbered by
descending degree), for comparing two trees of the repo on one card:

    python3 time_brandes.py --scale 14 --save build/bc_a.pt
    python3 time_brandes.py --tree build/other --scale 14 --against build/bc_a.pt
    python3 time_brandes.py --scale 21 --phases spmm,sampled,sage

``--tree DIR`` imports cugraph_tpu_torch from DIR, a checkout of another
commit, in place of this one; the graphs, timers and checks are this
checkout's chip_smoke.py's. ``--phases`` runs, in its order:

- ``exact``: betweenness and edge betweenness with k=None (every vertex a
  source) on the unweighted graph, each ``--repeats`` times after a first
  call, the launches of spmv_sum and spmm_rows counted over the first;
  ``--save`` keeps the results, ``--against`` gives each result's largest
  difference from the saved one over its largest magnitude.
- ``spmm``: spmm_rows on the unweighted CSC at SPMM_SHAPES, each held
  against float64 and relaunched bit-equal (chip_smoke.check_spmm_rows),
  then the median single-call ms, back-to-back ms, and CSR ``@`` X's ms;
  spmv_sum on the same CSC beside them.
- ``sampled``: betweenness and edge betweenness at k = SAMPLED_K on the
  weighted graph (weights in (0, 1]), then their MG versions on a 1 x 1
  NCCL mesh: the warm seconds of 3 calls after a first, then one call
  under torch.profiler for its spmm_rows launches, its ``spmm_*`` kernels'
  device ms and its idle share.
- ``sage``: the GraphSAGE forward (128 -> 128 -> 64, bf16 aggregation) on
  the unweighted graph, warm seconds of 5 calls after a first.

Prints the card's name and power limit, then one JSON line. Needs CUDA.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# imported before --tree joins sys.path, so from this checkout
import chip_smoke as cs

# (F, precision) of the spmm phase: Brandes' f32 blocks of 8, 16 and 32
# sources and of 10 (two floats a load), F = 128 in both modes, 8 in bf16
SPMM_SHAPES = ((8, "f32"), (16, "f32"), (32, "f32"), (10, "f32"), (128, "f32"), (8, "bf16"),
               (128, "bf16"))
SAMPLED_K = 8
SEED = 0  # the graphs', weights' and GraphSAGE weights' seed


def warm_seconds(fn, reps: int) -> list:
    """Wall seconds of ``reps`` calls of ``fn``, each synchronised."""
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        cs.sync()
        out.append(time.perf_counter() - t)
    return out


def exact(g, args) -> dict:
    import torch

    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.prims.cuda import spmm_rows, spmv_sum

    calls = {
        "betweenness": lambda: ct.betweenness_centrality(g),
        "edge_betweenness": lambda: ct.edge_betweenness_centrality(g),
    }
    out, results = {}, {}
    for name, fn in calls.items():
        spmv_sum.launches = spmm_rows.launches = 0
        cs.sync()
        t = time.perf_counter()
        results[name] = fn()
        cs.sync()
        first = time.perf_counter() - t
        launches = {"spmv_sum": spmv_sum.launches, "spmm_rows": spmm_rows.launches}
        warm = warm_seconds(fn, args.repeats)
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
    return out


def spmm(g, args) -> dict:
    import torch

    from cugraph_tpu_torch.prims.cuda import spmm_rows, spmv_sum

    adj = g.csc()
    lib_a = cs.sparse_csr(adj)
    gen = torch.Generator(device=cs.DEV).manual_seed(1)
    xs = torch.rand(g.num_vertices, generator=gen, device=cs.DEV)
    out = {"spmv_sum": {"ms": cs.median_ms(lambda: spmv_sum(adj, xs), 20),
                        "b2b_ms": cs.back_to_back_ms(lambda: spmv_sum(adj, xs), 20)}}
    for f, mode in SPMM_SHAPES:
        x = torch.randn(g.num_vertices, f, generator=gen, device=cs.DEV)
        call = lambda: spmm_rows(adj, x, precision=mode)  # noqa: E731
        out[f"f{f}_{mode}"] = {
            "max_abs_err": cs.check_spmm_rows(adj, x, mode), "ms": cs.median_ms(call, 20),
            "b2b_ms": cs.back_to_back_ms(call, 20),
            "library_ms": cs.median_ms(lambda: lib_a @ x, 20),
        }
    return out


def sampled(g, args) -> dict:
    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.dist import mg_centrality
    from cugraph_tpu_torch.prims.cuda import spmm_rows

    gw = cs.rmat_graph(args.scale, SEED, weighted=True)

    def timed(fn):
        fn()
        warm = warm_seconds(fn, 3)
        spmm_rows.launches = 0
        wall, device, busy = cs.profiled(fn)
        spmm_us = sum(us for key, (_, us) in device.items() if "spmm_" in key)
        return {"warm_s": warm, "best_s": min(warm), "spmm_rows_launches": spmm_rows.launches,
                "spmm_device_ms": spmm_us / 1e3, "idle_share": 1 - busy / wall}

    k, seed = SAMPLED_K, SEED
    out = {
        "betweenness": timed(lambda: ct.betweenness_centrality(gw, k=k, seed=seed)),
        "edge_betweenness": timed(lambda: ct.edge_betweenness_centrality(gw, k=k, seed=seed)),
    }
    with cs.one_rank_mesh() as mesh:
        out["mg_betweenness"] = timed(
            lambda: mg_centrality.mg_betweenness_centrality(mesh, gw, k=k, seed=seed))
        out["mg_edge_betweenness"] = timed(
            lambda: mg_centrality.mg_edge_betweenness_centrality(mesh, gw, k=k, seed=seed))
    return out


def sage(g, args) -> dict:
    import torch

    model = cs.seeded_graphsage(SEED)
    feats = torch.randn(g.num_vertices, 128, device=cs.DEV,
                        generator=torch.Generator(device=cs.DEV).manual_seed(2))

    def forward():
        with torch.no_grad():
            return model(g, feats)

    forward()
    warm = warm_seconds(forward, 5)
    return {"warm_s": warm, "median_s": statistics.median(warm)}


PHASES = {"exact": exact, "spmm": spmm, "sampled": sampled, "sage": sage}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None, help="import cugraph_tpu_torch from this checkout")
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--phases", default="exact", help=f"comma-separated, of {sorted(PHASES)}")
    ap.add_argument("--repeats", type=int, default=2, help="warm calls of the exact phase")
    ap.add_argument("--save", default=None, help="torch.save the exact results here")
    ap.add_argument("--against", default=None, help="compare with results saved by --save")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"--phases takes {sorted(PHASES)}, got {args.phases!r}")
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    if not torch.cuda.is_available():
        print("time_brandes.py: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    g = cs.rmat_graph(args.scale, SEED)
    out = {"tree": args.tree or ".", "scale": args.scale, "vertices": g.num_vertices,
           "edges": g.num_edges, "card": smi}
    for name in phases:
        out[name] = PHASES[name](g, args)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
