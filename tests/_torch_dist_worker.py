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
    from cugraph_tpu_torch.dist import distribute_edgelist, make_mesh, mg_algos, mg_gnn
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
