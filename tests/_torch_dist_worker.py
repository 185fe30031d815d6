"""Rank bodies for the multi-process tests of cugraph_tpu_torch.dist.

``spawn`` starts one process per rank with ``torch.multiprocessing``
(spawn method); each joins a gloo group on the CPU through a file
rendezvous in a fresh temporary directory (no port to collide with other
test workers), runs a rank body, and saves what it returns there. The
spawn has a deadline: at its end, or when any rank fails, every rank
still alive is killed and the test fails. This module imports no JAX, so
the ranks run the port alone; the tests hold their results against the
JAX package in the parent process.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SPAWN_TIMEOUT_S = 120.0


def _entry(rank, fn, world_size, workdir, args):
    torch.set_num_threads(1)
    from cugraph_tpu_torch.dist import initialize_distributed

    initialize_distributed("gloo", device="cpu", init_method=f"file://{workdir}/rendezvous",
                           world_size=world_size, rank=rank)
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():  # a body may end the group itself
            dist.destroy_process_group()


def spawn(fn, world_size: int, *args, timeout: float = SPAWN_TIMEOUT_S) -> list:
    """Run ``fn(rank, *args)`` on ``world_size`` ranks; their results, in
    rank order. Raises if a rank fails or the deadline passes."""
    with tempfile.TemporaryDirectory() as workdir:
        ctx = mp.start_processes(_entry, args=(fn, world_size, workdir, args),
                                 nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"ranks still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]


def _np(t):
    return t.detach().cpu().numpy()


def _launches():
    from cugraph_tpu_torch.prims.cuda import spmm_rows, spmv_minplus, spmv_sum

    return [spmv_sum.launches, spmv_minplus.launches, spmm_rows.launches]


def run_mesh(rank: int, shape, cases: dict) -> dict:
    """Everything the parity tests read, for every case, on one mesh: the
    rank's graph share, and each MG entry point's local result and (for
    the vertex arrays) the unsharded global one."""
    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.dist import (
        distribute_edgelist,
        distribute_graph,
        make_mesh,
        mg_algos,
        mg_gnn,
        mg_prims,
    )
    from cugraph_tpu_torch.dist.mg_graph import (
        distribute_edgelist_chunks,
        shard_vertex_values,
        unshard_vertex_values,
    )

    mesh = make_mesh(tuple(shape), device="cpu")
    out = {"coords": (mesh.i, mesh.j), "launches_before": _launches()}
    for name, c in cases.items():
        v = c["num_vertices"]
        if c["symmetrize"]:
            mgg = distribute_edgelist(mesh, c["src"], c["dst"], c["w"], num_vertices=v,
                                      symmetrize=True)
        else:
            g = ct.from_edgelist(c["src"], c["dst"], c["w"], num_vertices=v, device="cpu")
            mgg = distribute_graph(mesh, g)
        r = {"vp": mgg.vp, "num_edges": mgg.num_edges, "is_symmetric": mgg.is_symmetric,
             "block_counts": _np(mgg.block_counts)}
        for blk in ("in_block", "out_block"):
            adj = getattr(mgg, blk)
            r[blk] = {"offsets": _np(adj.offsets), "minors": _np(adj.minors),
                      "majors": _np(adj.majors),
                      "weights": None if adj.weights is None else _np(adj.weights)}

        def both(key, local):
            r[key] = _np(local)
            r[key + "_global"] = _np(unshard_vertex_values(mgg, local))

        values = np.arange(v, dtype=np.float32) * 0.5
        both("values", shard_vertex_values(mesh, mgg, values))
        both("out_weight_sums", mg_algos.mg_out_weight_sums(mesh, mgg))
        both("in_degrees", mg_algos.mg_in_degrees(mesh, mgg))
        both("outgoing_weights", mg_prims.per_v_transform_reduce_outgoing_e(
            mesh, mgg, lambda s, d, sv, dv, w: torch.ones_like(s, dtype=torch.float32)
            if w is None else w))
        for variant, kw in (("default", {}),
                            ("personalization", {"personalization": c["personalization"]}),
                            ("nstart", {"nstart": c["nstart"]})):
            pr, _ = mg_algos.mg_pagerank(mesh, mgg, **kw)
            both(f"pagerank_{variant}", pr)
        try:
            mg_algos.mg_pagerank(mesh, mgg, max_iterations=2, fail_on_nonconvergence=True)
            r["pagerank_unconverged_raised"] = False
        except ct.utils.error.GraphError:
            r["pagerank_unconverged_raised"] = True
        dense_max = mg_algos.MAX_VERTICES
        for branch, gate in (("dense", dense_max), ("push", 0)):
            mg_algos.MAX_VERTICES = gate
            try:
                dist_, pred = mg_algos.mg_bfs(mesh, mgg, c["sources"])
            finally:
                mg_algos.MAX_VERTICES = dense_max
            both(f"bfs_{branch}_dist", dist_)
            both(f"bfs_{branch}_pred", pred)
        dist_, _ = mg_algos.mg_bfs(mesh, mgg, c["sources"], depth_limit=1)
        both("bfs_depth1_dist", dist_)
        feats = shard_vertex_values(mesh, mgg, c["feats"])
        for op in ("sum", "mean", "max"):
            both(f"spmm_{op}", mg_algos.mg_spmm_aggregate(mesh, mgg, feats, op=op))
        params = mg_gnn.sage_params_from_jax(c["params"], device="cpu")
        both("sage", mg_gnn.mg_sage_forward(mesh, mgg, params, feats))
        for kind in ("int", "float"):  # dX of the aggregation for dY = r
            x = feats.clone().requires_grad_()
            dy = shard_vertex_values(mesh, mgg, c[f"dy_{kind}"])
            (mg_prims.per_v_incoming_sorted_spmm(mesh, mgg, x) * dy).sum().backward()
            both(f"dx_{kind}", x.grad)
        step = mg_gnn.make_sage_train_step(mesh, mgg, lr=1e-2)
        targets = shard_vertex_values(mesh, mgg, c["targets"])
        r["train"] = []
        for _ in range(2):
            params, loss = step(params, feats, targets)
            r["train"].append((float(loss), {k: _np(p) for k, p in params.items()}))
        dist_, pred = mg_algos.mg_sssp(mesh, mgg, c["sources"][0])
        both("sssp_dist", dist_)
        both("sssp_pred", pred)
        both("katz", mg_algos.mg_katz_centrality(mesh, mgg, c["katz_alpha"]))
        both("eigenvector", mg_algos.mg_eigenvector_centrality(mesh, mgg))
        hubs, auths = mg_algos.mg_hits(mesh, mgg)
        both("hits_hubs", hubs)
        both("hits_authorities", auths)
        for sym in (False, True) if c.get("chunks") is not None else ():
            mgc, new_to_old = distribute_edgelist_chunks(
                mesh, c["chunks"], num_vertices=v, renumber=True, symmetrize=sym)
            r[f"chunks_{sym}"] = {"new_to_old": _np(new_to_old), "vp": mgc.vp,
                                  "num_edges": mgc.num_edges, "is_symmetric": mgc.is_symmetric,
                                  "in_block": {"minors": _np(mgc.in_block.minors),
                                               "majors": _np(mgc.in_block.majors),
                                               "weights": None}}
        out[name] = r
    out["launches_after"] = _launches()
    return out


def run_launch_counts(rank: int) -> dict:
    """The MG entry points on a small graph: the kernels' launch counts
    before and after (CPU tensors take the plain versions)."""
    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.dist import (
        distribute_edgelist,
        make_mesh,
        mg_algos,
        mg_centrality,
        mg_community,
        mg_gnn,
        mg_sampling,
        mg_similarity,
    )
    from cugraph_tpu_torch.dist.mg_graph import shard_vertex_values

    mesh = make_mesh(device="cpu")
    rng = np.random.default_rng(5)
    src, dst = rng.integers(0, 40, 200), rng.integers(0, 40, 200)
    before = _launches()
    mgg = distribute_edgelist(mesh, src, dst, num_vertices=40)
    mg_algos.mg_pagerank(mesh, mgg, max_iterations=3)
    mg_algos.mg_bfs(mesh, mgg, 0)
    feats = shard_vertex_values(mesh, mgg, rng.random((40, 8)).astype(np.float32))
    for op in ("sum", "mean", "max"):
        mg_algos.mg_spmm_aggregate(mesh, mgg, feats, op=op)
    params = mg_gnn.init_sage_params(torch.Generator().manual_seed(0), 8, 8, 4, device="cpu")
    mg_gnn.mg_sage_forward(mesh, mgg, params, feats)
    mg_gnn.make_sage_train_step(mesh, mgg)(params, feats, feats[:, :4])
    mgw = distribute_edgelist(mesh, src, dst, rng.random(200), num_vertices=40)
    mg_algos.mg_sssp(mesh, mgw, 0)
    mg_algos.mg_katz_centrality(mesh, mgw, 0.05, max_iterations=3)
    mg_algos.mg_eigenvector_centrality(mesh, mgw, max_iterations=3)
    mg_algos.mg_hits(mesh, mgw, max_iterations=3)
    mg_algos.mg_pagerank(mesh, mgw, max_iterations=3, gather_mode="ring")
    mg_algos.mg_wcc(mesh, mgg)
    mg_algos.mg_core_number(mesh, mgg)
    dist_, pred = mg_algos.mg_bfs(mesh, mgg, 0)
    mg_algos.mg_extract_bfs_paths(mesh, mgg, dist_, pred, [1, 2])
    mgs = distribute_edgelist(mesh, src, dst, num_vertices=40, symmetrize=True)
    mg_community.mg_louvain(mesh, mgs)
    mg_community.mg_leiden(mesh, mgs, cluster_state="hypersparse")
    mgsw = distribute_edgelist(mesh, src, dst, rng.random(200), num_vertices=40, symmetrize=True)
    mg_similarity.mg_jaccard(mesh, mgsw, ([0, 1], [2, 3]), use_weight=True)
    mg_similarity.mg_triangle_count(mesh, mgs)
    mg_sampling.mg_uniform_neighbor_sample(mesh, mgsw, [0, 1], [3, 2])
    mg_sampling.mg_uniform_neighbor_sample(mesh, mgsw, [0, 1], [3, 2], method="shuffle")
    mg_sampling.mg_random_walks(mesh, mgs, [0, 1], 3)
    g = ct.from_edgelist(src, dst, num_vertices=40, device="cpu")
    mg_centrality.mg_betweenness_centrality(mesh, g, k=4)
    mg_centrality.mg_edge_betweenness_centrality(mesh, g, k=4)
    return {"before": before, "after": _launches(), "shape": mesh.shape}


def run_rmat_shards(rank: int, shape, scale: int, num_edges: int, seed: int) -> dict:
    """mg_rmat_edgelist -> rmat_chunk_source -> distribute_edgelist_chunks:
    every shard as this rank drew it, and the rank's in_block."""
    from cugraph_tpu_torch import mg_rmat_edgelist, rmat_chunk_source
    from cugraph_tpu_torch.dist import make_mesh
    from cugraph_tpu_torch.dist.mg_graph import distribute_edgelist_chunks

    mesh = make_mesh(shape, device="cpu")
    shards = mg_rmat_edgelist(mesh, scale, num_edges, seed=seed, scramble=True)
    source = rmat_chunk_source(shards)
    mgg = distribute_edgelist_chunks(mesh, source, num_vertices=1 << scale)
    blk = mgg.in_block
    return {"i": mesh.i, "j": mesh.j, "vp": mgg.vp, "shape": shards.shape,
            "shards": [(_np(s), _np(d)) for s, d in source()],
            "in_block": {"offsets": _np(blk.offsets), "minors": _np(blk.minors),
                         "majors": _np(blk.majors)}}


def run_broadcast_graph(rank: int) -> dict:
    """A graph through serialize -> deserialize -> broadcast_graph against
    distribute_graph of the graph itself: the rank's blocks, array by
    array."""
    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.core.serialize import broadcast_graph, deserialize_graph, serialize_graph
    from cugraph_tpu_torch.dist import make_mesh
    from cugraph_tpu_torch.dist.mg_graph import distribute_graph

    mesh = make_mesh(device="cpu")
    rng = np.random.default_rng(9)
    src, dst = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    g = ct.from_edgelist(src, dst, rng.random(300), num_vertices=50, device="cpu")
    got = broadcast_graph(mesh, deserialize_graph(serialize_graph(g), device="cpu"))
    want = distribute_graph(mesh, g)
    same = all(
        torch.equal(getattr(getattr(got, blk), k), getattr(getattr(want, blk), k))
        for blk in ("in_block", "out_block") for k in ("offsets", "majors", "minors", "weights"))
    return {"shape": mesh.shape, "same": same, "edges": got.in_block.num_edges}


def run_mg_spmm_gradient(rank: int) -> dict:
    """dX of the MG aggregation on a 1 x 1 mesh, and of the single-device
    one (``SpmmRowsFunction``) on the same graph, for one dY."""
    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.dist import distribute_graph, make_mesh, mg_prims
    from cugraph_tpu_torch.prims.cuda import SpmmRowsFunction

    mesh = make_mesh((1, 1), device="cpu")
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, 30, 150), rng.integers(0, 30, 150)
    g = ct.from_edgelist(src, dst, num_vertices=30, device="cpu")
    mgg = distribute_graph(mesh, g)
    feats = torch.from_numpy(rng.random((30, 6)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(30, 6)).astype(np.float32))
    out = {}
    for name, fn in (("mg", lambda x: mg_prims.per_v_incoming_sorted_spmm(mesh, mgg, x)),
                     ("sg", lambda x: SpmmRowsFunction.apply(x, g.csc(), g.csr(), "bf16", False))):
        x = feats.clone().requires_grad_()
        y = fn(x)
        (y * dy).sum().backward()
        out[name] = (_np(y), _np(x.grad))
    return out


def run_bad_personalization(rank: int, shape) -> dict:
    """mg_pagerank with a personalization id out of range on every rank:
    whether it raised GraphError, and the sum of an in-range run."""
    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.dist import distribute_edgelist, make_mesh, mg_algos
    from cugraph_tpu_torch.testing import karate_edgelist

    mesh = make_mesh(tuple(shape), device="cpu")
    s, d, _ = karate_edgelist()
    mgg = distribute_edgelist(mesh, s, d, num_vertices=34, symmetrize=True)
    out = {}
    for bad in (34, -1):
        try:
            mg_algos.mg_pagerank(mesh, mgg, personalization=([0, bad], [1.0, 1.0]))
            out[str(bad)] = False
        except ct.utils.error.GraphError:
            out[str(bad)] = True
    pr, _ = mg_algos.mg_pagerank(mesh, mgg, personalization=([0, 33], [1.0, 1.0]))
    out["in_range_sum"] = float(mg_algos.mg_prims.transform_reduce_v(mesh, pr))
    return out


def run_slice(rank: int, shape, cases: dict, exchange: dict) -> dict:
    """The MG entry points of WCC, core number, path extraction, the ring
    PageRank and the sorted-min prims on ``cases``; the keyed exchanges on
    ``exchange``'s per-rank keys."""
    from cugraph_tpu_torch.dist import distribute_edgelist, make_mesh, mg_algos, mg_prims
    from cugraph_tpu_torch.dist.mg_graph import shard_vertex_values, unshard_vertex_values
    from cugraph_tpu_torch.prims.reduce_ops import MINIMUM

    mesh = make_mesh(tuple(shape), device="cpu")
    out = {"coords": (mesh.i, mesh.j), "launches_before": _launches()}

    def glob(mgg, local):
        return _np(unshard_vertex_values(mgg, local))

    for name, c in cases.items():
        v = c["num_vertices"]
        mgg = distribute_edgelist(mesh, c["src"], c["dst"], c["w"], num_vertices=v,
                                  symmetrize=c["symmetrize"])
        r = {}
        dense_max = mg_algos.MAX_VERTICES
        for branch, gate in (("f32", dense_max), ("int32", 0)):
            mg_algos.MAX_VERTICES = gate
            try:
                r[f"wcc_{branch}"] = glob(mgg, mg_algos.mg_wcc(mesh, mgg))
            finally:
                mg_algos.MAX_VERTICES = dense_max
        for dt in ("incoming", "outgoing", "incoming_outgoing"):
            r[f"core_{dt}"] = glob(mgg, mg_algos.mg_core_number(mesh, mgg, dt))
        dist_l, pred_l = mg_algos.mg_bfs(mesh, mgg, c["sources"])
        r["paths"] = tuple(
            _np(x) if torch.is_tensor(x) else x
            for x in mg_algos.mg_extract_bfs_paths(mesh, mgg, dist_l, pred_l, c["destinations"]))
        sd_l, sp_l = mg_algos.mg_sssp(mesh, mgg, c["sources"][0])
        r["sssp_paths"] = _np(mg_algos.mg_extract_bfs_paths(
            mesh, mgg, sd_l, sp_l, c["destinations"])[0])

        # the ring never all-gathers over row_group; all_gather mode does
        calls = {"ring": 0, "all_gather": 0}
        real = mg_prims.all_gather_rows
        for mode in calls:
            def counting(t, group=None, _mode=mode):
                calls[_mode] += group is mesh.row_group
                return real(t, group)

            mg_prims.all_gather_rows = counting
            try:
                r[f"pagerank_{mode}"] = glob(mgg, mg_algos.mg_pagerank(
                    mesh, mgg, tol=1e-9, gather_mode=mode)[0])
            finally:
                mg_prims.all_gather_rows = real
        r["row_all_gathers"] = calls
        try:
            mg_algos.mg_pagerank(mesh, mgg, gather_mode="rings")
            r["bad_mode_raised"] = False
        except ValueError:
            r["bad_mode_raised"] = True

        frontier = shard_vertex_values(mesh, mgg, c["frontier"])
        vals = shard_vertex_values(mesh, mgg, c["frontier_values"])
        touched, reduced = mg_prims.frontier_push_by_dst_sorted(
            mesh, mgg, frontier, vals, use_weights=mgg.weighted)
        g_touched, g_reduced = mg_prims.frontier_push_by_dst(
            mesh, mgg, frontier, lambda s, d, sv, dv, w: (torch.ones_like(sv, dtype=torch.bool),
                                                          sv if w is None else sv + w),
            reduce_op=MINIMUM, src_values=vals)
        r["push"] = [glob(mgg, t) for t in (touched, reduced, g_touched, g_reduced)]
        up = mg_prims.per_v_outgoing_sorted_min(mesh, mgg, vals)
        g_up = mg_prims.per_v_transform_reduce_outgoing_e(
            mesh, mgg, lambda s, d, sv, dv, w: dv, reduce_op=MINIMUM, dst_values=vals)
        r["outgoing_min"] = [glob(mgg, up), glob(mgg, g_up)]
        out[name] = r

    # the keyed exchanges: this rank's keys, the values of the vertex ranges
    ex = exchange
    me = (mesh.i, mesh.j)
    mgg = distribute_edgelist(mesh, ex["src"], ex["dst"], num_vertices=ex["num_vertices"])
    vals = shard_vertex_values(mesh, mgg, ex["values"])
    keys = torch.from_numpy(ex["keys"][me])
    valid = torch.from_numpy(ex["valid"][me])
    res = {}
    res["collect"] = mg_prims.collect_values_for_keys(mesh, keys, valid, vals, mgg.vp, ex["capacity"])
    res["collect_unique"] = mg_prims.collect_values_for_unique_keys(
        mesh, keys, valid, vals, mgg.vp, ex["capacity"])
    k2, items, v2, ov = mg_prims.shuffle_to_vertex_owners(
        mesh, keys, {"x": keys.to(torch.float32) * 0.5}, valid, mgg.vp, ex["capacity"])
    res["shuffle"] = (k2, items["x"], v2, ov)
    hot = torch.zeros(8, dtype=torch.int32)  # every rank sends 8 items to vertex 0's owner
    k2, items, v2, ov = mg_prims.shuffle_to_vertex_owners(
        mesh, hot, {"x": torch.arange(8, dtype=torch.float32)}, torch.ones(8, dtype=torch.bool),
        mgg.vp, 2)
    res["overflow"] = (k2, items["x"], v2, ov)
    labels = shard_vertex_values(mesh, mgg, ex["labels"])
    _, vmask = mg_algos._local_ids(mesh, mgg)
    k_local = shard_vertex_values(mesh, mgg, ex["weights"])
    res["sigma"] = mg_prims.cluster_weight_sums(mesh, labels, k_local, vmask, mgg.vp, ex["capacity"])
    out["exchange"] = {n: tuple(_np(x) if torch.is_tensor(x) else x for x in t)
                       for n, t in res.items()}
    out["launches_after"] = _launches()
    return out


def run_community(rank: int, shape, community: dict) -> dict:
    """mg_modularity, mg_louvain and mg_leiden in both cluster states, one
    local-moving level and mg_decompress_to_edgelist on ``community``'s
    graphs, symmetrized."""
    from cugraph_tpu_torch.dist import distribute_edgelist, make_mesh, mg_community
    from cugraph_tpu_torch.dist.mg_graph import shard_vertex_values, unshard_vertex_values

    mesh = make_mesh(tuple(shape), device="cpu")
    out = {"coords": (mesh.i, mesh.j), "launches_before": _launches()}
    comm = {}
    for name, c in community.items():
        mgg = distribute_edgelist(mesh, c["src"], c["dst"], c["w"], num_vertices=c["num_vertices"],
                                  symmetrize=True)
        r = {"modularity": {}}
        for lname, lab in c["labels"].items():
            r["modularity"][lname] = mg_community.mg_modularity(
                mesh, mgg, shard_vertex_values(mesh, mgg, lab))
        for state in ("dense", "hypersparse"):
            for algo in ("louvain", "leiden"):
                fn = getattr(mg_community, f"mg_{algo}")
                lab, q = fn(mesh, mgg, cluster_state=state)
                r[f"{algo}_{state}"] = (_np(lab), q, str(lab.device), fn.levels)
            lab, moves, ovf = mg_community._one_level(mesh, mgg, 1.0, 16, cluster_state=state)
            r[f"level_{state}"] = (_np(unshard_vertex_values(mgg, lab)), moves, ovf)
        s, d, w = mg_community.mg_decompress_to_edgelist(mesh, mgg)
        r["edges"] = (_np(s), _np(d), None if w is None else _np(w))
        comm[name] = r
    out["community"] = comm
    out["launches_after"] = _launches()
    return out


def run_service(rank: int, shape, csv_path: str) -> dict:
    """The service handler on every rank of the group, each rank making
    the same calls: the single-device results, then distribute_graph on
    ``shape`` and the MG-routed results (the sampler's too); a shape that
    does not cover the world must raise."""
    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.service import CugraphHandler

    h = CugraphHandler(device="cpu")
    h.load_csv_as_edge_data(csv_path, vertex_col_names=["src", "dst"])
    calls = {
        "pagerank": lambda: h.pagerank(tol=1e-8),
        "bfs": lambda: h.bfs(0),
        "sssp": lambda: h.sssp(0),
        "wcc": lambda: h.wcc(),
        "katz": lambda: h.katz_centrality(alpha=0.05, tol=1e-8),
    }
    out = {"sg": {k: fn() for k, fn in calls.items()}}
    out["sg_sample"] = h.uniform_neighbor_sample([0, 5, 33], [4, 2])
    world = dist.get_world_size()
    try:
        h.distribute_graph(mesh_shape=[world + 1, 1])
        out["bad_shape_raised"] = False
    except ct.utils.error.GraphError:
        out["bad_shape_raised"] = True
    out["info"] = h.distribute_graph(mesh_shape=list(shape))
    out["mg"] = {k: fn() for k, fn in calls.items()}
    out["sample"] = h.uniform_neighbor_sample([0, 5, 33], [4, 2])
    out["own_group"] = h._own_group
    return out


def run_service_own_group(rank: int, csv_path: str) -> dict:
    """With no process group up, distribute_graph starts a one-rank gloo
    group on localhost; CugraphTpuServer.stop ends it."""
    from cugraph_tpu_torch.service import CugraphTpuServer

    dist.destroy_process_group()
    server = CugraphTpuServer(port=0, device="cpu")
    h = server.handler
    h.load_csv_as_edge_data(csv_path, vertex_col_names=["src", "dst"])
    sg = h.pagerank(tol=1e-8)
    info = h.distribute_graph()
    out = {"info": info, "backend": dist.get_backend(), "world": dist.get_world_size(),
           "sg": sg, "mg": h.pagerank(tol=1e-8), "own_group": h._own_group}
    server.start()
    server.stop()
    out["up_after_stop"] = dist.is_initialized()
    return out


def _symmetric_graph(mesh, c):
    from cugraph_tpu_torch.dist import distribute_edgelist

    return distribute_edgelist(mesh, c["src"], c["dst"], c["w"], num_vertices=c["num_vertices"],
                               symmetrize=True)


def _sg_symmetric(c):
    import cugraph_tpu_torch as ct

    return ct.from_edgelist(c["src"], c["dst"], c["w"], num_vertices=c["num_vertices"],
                            symmetrize=True, device="cpu")


def run_similarity(rank: int, shape, cases: dict, tri_edges=None) -> dict:
    """The DCSR arrays, ``dcsr_lookup``, the three coefficients (plain and
    weighted) beside the port's single-device ones, the members, and the
    triangle counts beside ``triangle_count`` on each of ``cases``'
    symmetrized graphs; with ``tri_edges`` ((src, dst, V) of a symmetric
    edge list), its triangle count and seconds."""
    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.dist import distribute_edgelist, make_mesh, mg_prims, mg_similarity
    from cugraph_tpu_torch.dist.mg_graph import src_dcsr

    mesh = make_mesh(tuple(shape), device="cpu")
    out = {"coords": (mesh.i, mesh.j), "launches_before": _launches()}
    for name, c in cases.items():
        mgg = _symmetric_graph(mesh, c)
        g = _sg_symmetric(c)
        adj = src_dcsr(mesh, mgg)
        r = {"dcsr": {k: None if a is None else _np(a) for k, a in adj._asdict().items()},
             "d_pad": mgg.d_pad}
        ids = torch.arange(mgg.rows * mgg.vp)
        r["lookup"] = tuple(_np(a) for a in mg_prims.dcsr_lookup(
            adj.src_nzd, adj.src_nzd_offsets, ids))
        pairs = (torch.from_numpy(c["v1"]), torch.from_numpy(c["v2"]))
        for kind in ("jaccard", "sorensen", "overlap"):
            for w in (False, True):
                r[f"{kind}_{w}"] = _np(mg_similarity.mg_similarity(mesh, mgg, pairs, kind, w))
                r[f"sg_{kind}_{w}"] = _np(getattr(ct, kind)(g, pairs, use_weight=w)[2])
        inter, members = mg_similarity._mg_intersection_members(mesh, mgg, *pairs)
        r["members"] = (_np(inter), _np(members), mg_similarity._max_local_degree(mesh, mgg))
        r["triangles"] = _np(mg_similarity.mg_triangle_count(mesh, mgg))
        r["triangles_small_batch"] = _np(mg_similarity.mg_triangle_count(mesh, mgg, batch_size=7))
        r["sg_triangles"] = _np(ct.triangle_count(g))
        out[name] = r
    if tri_edges is not None:
        src, dst, v = tri_edges
        mgg = distribute_edgelist(mesh, src, dst, num_vertices=v, is_symmetric=True)
        t = time.perf_counter()
        counts = mg_similarity.mg_triangle_count(mesh, mgg)
        out["tri_edges"] = (int(counts.sum()) // 3, time.perf_counter() - t)
    out["launches_after"] = _launches()
    return out


def run_sampling(rank: int, shape, cases: dict) -> dict:
    """``mg_sampling`` on each of ``cases``' symmetrized graphs, fed the
    uniforms in ``cases[name]["us"]`` and ``["walk_us"]``: every method x
    replacement, a shuffle capacity of 1, and the walks; then the public
    entry points drawing from a generator seeded 7."""
    from cugraph_tpu_torch.dist import make_mesh, mg_sampling

    mesh = make_mesh(tuple(shape), device="cpu")
    out = {"coords": (mesh.i, mesh.j), "launches_before": _launches()}

    def host(res):
        return {k: None if v is None else _np(v) for k, v in res.items()}

    for name, c in cases.items():
        mgg = _symmetric_graph(mesh, c)
        seeds = torch.from_numpy(c["seeds"])
        r = {}
        for repl in (False, True):
            us = [torch.from_numpy(u) for u in c["us"][repl]]
            for method in ("replicate", "shuffle"):
                r[(method, repl)] = host(mg_sampling._sample_with_uniforms(
                    mesh, mgg, seeds, us, with_replacement=repl, method=method))
            r[("shuffle_cap1", repl)] = host(mg_sampling._sample_with_uniforms(
                mesh, mgg, seeds, us, with_replacement=repl, method="shuffle",
                shuffle_capacity=1))
        r["walks"] = _np(mg_sampling._walk_with_uniforms(
            mesh, mgg, seeds, [torch.from_numpy(u) for u in c["walk_us"]]))
        for repl in (False, True):
            r[("generator", repl)] = host(mg_sampling.mg_uniform_neighbor_sample(
                mesh, mgg, seeds, c["fanouts"], with_replacement=repl,
                generator=torch.Generator().manual_seed(7)))
        r["generator_walks"] = _np(mg_sampling.mg_random_walks(
            mesh, mgg, seeds, len(c["walk_us"]), generator=torch.Generator().manual_seed(7)))
        out[name] = r
    out["launches_after"] = _launches()
    return out


def run_centrality(rank: int, shape, cases: dict) -> dict:
    """``mg_centrality`` on each of ``cases``' single-device graphs, every
    rank holding it: exact betweenness under every normalized x endpoints,
    exact edge betweenness, and both sampled (k = 8, seed 3) beside the
    port's single-device results."""
    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.dist import make_mesh, mg_centrality

    mesh = make_mesh(tuple(shape), device="cpu")
    out = {"coords": (mesh.i, mesh.j)}
    for name, c in cases.items():
        g = ct.from_edgelist(c["src"], c["dst"], num_vertices=c["num_vertices"],
                             symmetrize=c["symmetrize"], device="cpu")
        r = {}
        before = _launches()
        for norm in (False, True):
            for ends in (False, True):
                r[("bc", norm, ends)] = _np(mg_centrality.mg_betweenness_centrality(
                    mesh, g, normalized=norm, endpoints=ends))
        r["ebc"] = _np(mg_centrality.mg_edge_betweenness_centrality(mesh, g))
        r["bc_k8"] = _np(mg_centrality.mg_betweenness_centrality(mesh, g, k=8, seed=3))
        r["ebc_k8"] = _np(mg_centrality.mg_edge_betweenness_centrality(mesh, g, k=8, seed=3))
        r["launches"] = [a - b for a, b in zip(_launches(), before)]
        r["sg_bc_k8"] = _np(ct.betweenness_centrality(g, k=8, seed=3))
        r["sg_ebc_k8"] = _np(ct.edge_betweenness_centrality(g, k=8, seed=3))
        out[name] = r
    return out


def run_mg_store(rank: int, shape, frame, seeds, us: dict) -> dict:
    """A GraphStore over an MGPropertyGraph of ``frame``'s (src, dst)
    edges: ``sample_neighbors`` (fanout 3, 2 hops) in both edge
    directions, once from a generator seeded 3 and once with the mesh
    sampler fed ``us[edge_dir]`` (``mg_sampling._sample_with_uniforms`` in
    place of ``mg_uniform_neighbor_sample``); then fanout -1."""
    from cugraph_tpu_torch.dist import make_mesh, mg_sampling
    from cugraph_tpu_torch.dist.mg_property_graph import MGPropertyGraph
    from cugraph_tpu_torch.gnn import GraphStore

    mesh = make_mesh(tuple(shape), device="cpu")
    pg = MGPropertyGraph(mesh, chunk_edges=50)
    store = GraphStore(pg, device="cpu")
    store.add_edge_data(frame, ("src", "dst"))
    out = {"is_mg": store.is_mg}

    def frame_of(df):
        return {k: df[k].to_numpy() for k in df.columns}

    drawn = mg_sampling.mg_uniform_neighbor_sample
    for edge_dir in ("in", "out"):
        out[edge_dir] = frame_of(store.sample_neighbors(
            seeds, fanout=3, num_hops=2, edge_dir=edge_dir,
            generator=torch.Generator().manual_seed(3)))

        def fed(mesh_, mgg, starts, fanouts, *, with_replacement, generator, **_):
            return mg_sampling._sample_with_uniforms(
                mesh_, mgg, torch.as_tensor(starts), [torch.from_numpy(u) for u in us[edge_dir]],
                with_replacement=with_replacement, method="replicate")

        mg_sampling.mg_uniform_neighbor_sample = fed
        try:
            out[edge_dir + "_uniforms"] = frame_of(store.sample_neighbors(
                seeds, fanout=3, num_hops=2, edge_dir=edge_dir))
        finally:
            mg_sampling.mg_uniform_neighbor_sample = drawn
        out[edge_dir + "_edge_data"] = len(store._mgg[edge_dir].edge_data)
    try:
        store.sample_neighbors(seeds, fanout=-1)
        out["fanout_-1"] = "returned"
    except Exception as exc:  # the JAX rule: MG sampling needs fanout > 0
        out["fanout_-1"] = f"{type(exc).__name__}: {exc}"
    return out
