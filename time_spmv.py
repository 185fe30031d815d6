"""spmv_sum and spmv_minplus of the PyTorch port on an NVIDIA card, on the
benchmark's scale-24 GAP graphs (port_bench/configs/), at forced counts K of
column segments and forms of the segments, for choosing the segment rule's
constants and for comparing two trees of the repo on one card:

    python3 time_spmv.py --save build/spmv_k1.pt
    python3 time_spmv.py --tree build/parent --ks 1 --against build/spmv_k1.pt

``--tree DIR`` imports cugraph_tpu_torch from DIR, a checkout of another
commit that builds its sweeps by ``sweep_plan``, in place of this one; the
graphs and checks are this checkout's. Each measurement sweeps a plan of
``sweep_plan`` (``prims/cuda/spmv.py:sweep``), the form's ranges at K.
Phases:

- the sweep: each graph of ``--graphs`` from ``SEED``, made and stored as
  the benchmark does (generator, symmetrize); then for each K of ``--ks``
  (ranges of ceil(V / K) minors) and, above K = 1, each form of
  ``--forms`` (``dense``: every range over all the rows; ``hypersparse``:
  every range after the first (which stays dense) over its rows with an
  edge; ``rule``: the rule's forms) the plan's one-time
  build, spmv_sum on a PageRank-like x held within chip_smoke.TOL_SUM_REL
  of float64 and spmv_minplus on a BFS-shaped x (10% of the ids, +inf
  elsewhere) bit-equal to its plain version and to the K = 1 sweep, each
  relaunched bit-equal, then the median of single calls and the
  back-to-back time, edges a second, and the rows the ranges walk;
  ``--save`` keeps the K = 1 results, ``--against`` reports whether they
  are bit-equal to saved ones.
- ``--weighted``: the graphs carry weights in (0, 1], which both SpMVs
  read (spmv_minplus then takes the random x).
- ``--degrees``: Urand graphs of 2^24 vertices and d x 2^24 tuples (one
  direction, no symmetrizing), spmv_sum back to back at each K and form,
  for the degree below which segments do not pay and, with a range's
  share of rows with an edge 1 - exp(-d / K), the share below which a
  hypersparse range beats a dense one.
- ``--block``: one card's block of ``kron27-mg.pagerank`` (GAP's Kron at
  scale 27 on a 2 x 2 mesh): the edges of ``gap-kron-s27``, both
  directions, whose destination lies in the ranges of mesh row 0 and
  whose source lies in column span 0 (2^26 rows, 2^26 minors), each pair
  once, as ``dist.mg_graph`` stores them; spmv_sum at the rule's K in
  each form, checked and timed as above, with the bytes the segments
  keep on the card.

- ``--bfs``: in place of the sweep, BFS's pull level on each graph: a
  root drawn from ``SEED`` among the vertices with an edge, and for each
  dense level of ``bfs`` from it the min-plus level (``spmv_minplus``,
  then the unvisited rows, as the port ran a dense level before
  ``bfs_pull_level``) against ``bfs_pull_level``, each level's calls
  timed singly on a fresh copy of its state, the pull bit-equal to the
  min-plus level, with the minors it scanned of the level's stored edges;
  then the whole query, ``bfs`` from the root. Times this checkout only.

Prints the card's name and power limit, then one JSON line, also written
to ``--out``. Needs CUDA.
"""

import argparse
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
# the forms of the ranges, by the share of the rows a later range must
# have an edge in to stay dense (None: the rule's)
FORMS = {"dense": 0.0, "hypersparse": 2.0, "rule": None}


def plan_of(adj, k: int, form: str):
    """The plan of ``adj`` in ranges of ceil(minors / k) in ``form``, at the
    wrapper's items a thread."""
    from cugraph_tpu_torch.prims.cuda import _partition

    share = FORMS[form]
    if share is None:
        share = _partition.SEGMENT_HYPERSPARSE_SHARE
    return _partition.sweep_plan(adj, -(-adj.num_minors // k), share,
                                 _partition.SUM_ITEMS_PER_THREAD)


def rows_walked(plan) -> int:
    return sum(r.num_rows for r in plan.ranges)


def kept_bytes(plan) -> int:
    """The bytes of the ranges' offsets and row ids (their minors and
    weights are the adjacency's, cut; one range is the adjacency)."""
    if len(plan.ranges) == 1:
        return 0
    return sum(4 * r.offsets.numel() + (0 if r.row_ids is None else 4 * r.row_ids.numel())
               for r in plan.ranges)


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
    from cugraph_tpu_torch.microbench import back_to_back_ms, median_ms

    return dict(ms=median_ms(fn, REPS, cs.DEV), back_to_back_ms=back_to_back_ms(fn, REPS, cs.DEV))


def sweep(g, ks, forms, saved, name) -> dict:
    import torch

    from cugraph_tpu_torch.prims.cuda import spmv_minplus_reference, spmv_sum_reference
    from cugraph_tpu_torch.prims.cuda._partition import plan_for
    from cugraph_tpu_torch.prims.cuda.spmv import sweep as run

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
    out = {"vertices": v, "edges": e, "rule_k": len(plan_for(adj).ranges)}
    for k in ks:
        for form in forms if k > 1 else ["dense"]:
            cs.sync()
            t = time.perf_counter()
            plan = plan_of(adj, k, form)

            def sum_call():
                return run("spmv_sum", plan, x, True)

            def min_call():
                return run("spmv_minplus", plan, xb, weighted)

            y = sum_call()
            cs.sync()
            first_s = time.perf_counter() - t
            cs.check_relaunch("spmv_sum", y, sum_call)
            _, rel = cs.sum_error(adj, y, x, spmv_sum_reference, ref_size=ref_size)
            cs.require(rel <= cs.TOL_SUM_REL, f"{name} K={k} {form}: spmv_sum error {rel}")
            yb = min_call()
            cs.sync()
            cs.require(torch.equal(yb, min_ref), f"{name} K={k} {form}: spmv_minplus not bit-exact")
            cs.check_relaunch("spmv_minplus", yb, min_call)
            row = dict(k=len(plan.ranges), form=form, rows=rows_walked(plan),
                       segment_bytes=kept_bytes(plan), first_call_s=first_s, sum_rel_err=rel,
                       sum=timings(sum_call), minplus=timings(min_call))
            for op in ("sum", "minplus"):
                row[op]["gedges_per_s"] = e / row[op]["back_to_back_ms"] / 1e6
            if k == 1:
                key = (name, "sum"), (name, "minplus")
                if saved is not None and key[0] in saved:
                    row["bits_equal_against"] = bool(torch.equal(y.cpu(), saved[key[0]])
                                                     and torch.equal(yb.cpu(), saved[key[1]]))
                out["k1"] = {key[0]: y.cpu(), key[1]: yb.cpu()}
            label = f"K={k}" if k == 1 else f"K={k}.{form}"
            out[label] = row
            cs.log(f"{name} {label}: {json.dumps(row)}")
            del y, yb, plan
    return out


def bfs_levels(g) -> dict:
    """The ``--bfs`` phase on graph ``g``."""
    import torch

    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.microbench import median_ms

    adj = g.csc()
    has_edge = (adj.degrees() > 0).nonzero().flatten()
    pick = torch.randint(0, has_edge.numel(), (1,),
                         generator=torch.Generator(device=cs.DEV).manual_seed(SEED), device=cs.DEV)
    root = int(has_edge[pick])
    out = {"root": root, "vertices": g.num_vertices, "edges": adj.num_edges,
           "levels": cs.bfs_level_times(g, root, REPS)}
    for row in out["levels"]:
        cs.log(f"bfs level {row['depth']}: {json.dumps(row)}")
    out["dense_levels_ms"] = {k: sum(r[k] for r in out["levels"]) for k in ("ms", "minplus_ms")}
    out["scanned_share"] = (sum(r["scanned"] for r in out["levels"])
                            / max(sum(r["edges"] for r in out["levels"]), 1))
    out["query_ms"] = median_ms(lambda: ct.bfs(g, root), REPS, cs.DEV)
    cs.log(f"bfs from {root}: dense levels ms {json.dumps(out['dense_levels_ms'])}, "
           f"{out['scanned_share']:.4f} of their edges scanned; query {out['query_ms']:.3f} ms")
    return out


def degrees(ds, ks, forms) -> dict:
    import torch

    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.microbench import back_to_back_ms
    from cugraph_tpu_torch.prims.cuda._partition import plan_for
    from cugraph_tpu_torch.prims.cuda.spmv import sweep as run

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
            for form in forms if k > 1 else ["dense"]:
                plan = plan_of(adj, k, form)
                ms = back_to_back_ms(lambda: run("spmv_sum", plan, x, True), REPS, cs.DEV)
                row[f"K={k}" if k == 1 else f"K={k}.{form}"] = dict(ms=ms, rows=rows_walked(plan))
                del plan
        row["rule_k"] = len(plan_for(adj).ranges)
        out[f"d={d}"] = row
        cs.log(f"urand 2^24 degree {d}: back-to-back ms {json.dumps(row)}")
        del adj, x
        torch.cuda.empty_cache()
    return out


def card_block(cfg: dict, seed: int):
    """Card (0, 0)'s in-block of the Kron configuration ``cfg`` on a 2 x 2
    mesh (dist/partition.py), V = 2^scale: destinations in vertex ranges 0
    and 2 of V / 4, sources in [0, V / 2); rows b * V / 4 + (dst - range
    start), both directions of each tuple, each ordered pair once, sorted."""
    import torch

    from cugraph_tpu_torch.core.csr import CompressedAdj
    from port_bench.gen import kronecker

    half, vp = 1 << (int(cfg["scale"]) - 1), 1 << (int(cfg["scale"]) - 2)
    keys = []
    for src, dst in kronecker.edge_chunks(cfg, seed, cs.DEV):
        for a, b in ((src, dst), (dst, src)):  # minor a (source), major b (destination)
            q = b.div(vp, rounding_mode="floor")
            keep = (a < half) & (q % 2 == 0)
            row = (q[keep] // 2).to(torch.int64) * vp + (b[keep] % vp)
            keys.append(row * half + a[keep].to(torch.int64))
        del src, dst
    key = torch.unique(torch.cat(keys))
    del keys
    majors = (key // half).to(torch.int32)
    minors = (key % half).to(torch.int32)
    del key
    counts = torch.bincount(majors.to(torch.int64), minlength=half)
    offsets = torch.zeros(half + 1, dtype=torch.int32, device=cs.DEV)
    offsets[1:] = torch.cumsum(counts, 0)
    torch.cuda.empty_cache()
    return CompressedAdj(offsets, minors, majors, None, half, half, minors.numel())


def block(forms) -> dict:
    """spmv_sum on card_block at the rule's K, in each form."""
    import torch

    from cugraph_tpu_torch.prims.cuda import spmv_sum_reference
    from cugraph_tpu_torch.prims.cuda._partition import plan_for
    from cugraph_tpu_torch.prims.cuda.spmv import sweep as run

    with open("port_bench/configs/gap-kron-s27.json") as f:
        cfg = json.load(f)
    t = time.perf_counter()
    adj = card_block(cfg, SEED)
    cs.sync()
    out = {"build_s": time.perf_counter() - t, "majors": adj.num_majors,
           "minors": adj.num_minors, "edges": adj.num_edges}
    k = len(plan_for(adj).ranges)
    x = torch.rand(adj.num_minors, generator=torch.Generator(device=cs.DEV).manual_seed(SEED),
                   device=cs.DEV) / adj.num_minors
    ref_size = cs.sum_reference(adj, x, spmv_sum_reference)
    for form in forms:
        plan = plan_of(adj, k, form)

        def call():
            return run("spmv_sum", plan, x, True)

        y = call()
        cs.sync()
        cs.check_relaunch("spmv_sum", y, call)
        _, rel = cs.sum_error(adj, y, x, spmv_sum_reference, ref_size=ref_size)
        cs.require(rel <= cs.TOL_SUM_REL, f"s27 block K={k} {form}: spmv_sum error {rel}")
        row = dict(rows=rows_walked(plan), segment_bytes=kept_bytes(plan), sum_rel_err=rel,
                   sum=timings(call))
        del y, plan
        row["sum"]["gedges_per_s"] = adj.num_edges / row["sum"]["back_to_back_ms"] / 1e6
        out[f"K={k}.{form}"] = row
        cs.log(f"s27 block K={k} {form}: {json.dumps(row)}")
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=None, help="import cugraph_tpu_torch from this checkout")
    ap.add_argument("--graphs", default="gap-urand-s24,gap-kron-s24")
    ap.add_argument("--ks", default="1,2,4,8,16")
    ap.add_argument("--forms", default=",".join(FORMS), help="forms of the ranges above K = 1")
    ap.add_argument("--degrees", default="", help="average degrees of the Urand phase")
    ap.add_argument("--block", action="store_true", help="time one card's block of s27")
    ap.add_argument("--weighted", action="store_true")
    ap.add_argument("--bfs", action="store_true", help="time BFS's dense levels, not the sweep")
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
    from cugraph_tpu_torch.prims.cuda import _partition, build

    if not hasattr(_partition, "sweep_plan"):
        sys.exit(f"time_spmv: {args.tree} has no _partition.sweep_plan to time")
    cs.log(f"cugraph_tpu_torch from {os.path.dirname(ct.__file__)}; "
           f"L2 {torch.cuda.get_device_properties(0).L2_cache_size} bytes")
    libs = ["spmv", "bfs"] if args.bfs else ["spmv"]
    build.build(libs)
    for lib in libs:
        for line in build.compiler_report(lib).splitlines():
            if "registers" in line or "spill" in line:
                cs.log(f"  {lib}: {line.strip()}")
    result = {"tree": args.tree or ".", "card": smi,
              "l2_bytes": torch.cuda.get_device_properties(0).L2_cache_size}
    saved = torch.load(args.against) if args.against else None
    ks = [int(k) for k in args.ks.split(",")]
    forms = args.forms.split(",")
    keep = {}
    for name in filter(None, args.graphs.split(",")):
        g = card_graph(name, SEED, args.weighted)
        if args.bfs:
            result[name] = {"bfs": bfs_levels(g)}
            del g
            torch.cuda.empty_cache()
            continue
        res = sweep(g, ks, forms, saved, name)
        keep.update(res.pop("k1", {}))
        result[name] = res
        del g
        torch.cuda.empty_cache()
    if args.save:
        torch.save(keep, args.save)
    if args.degrees:
        result["degrees"] = degrees([int(d) for d in args.degrees.split(",")], ks, forms)
    if args.block:
        result["block"] = block(forms)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
