"""One rank of a run across cards on the CPU, for the tests: ``run.py``'s
rank (``run.rank_main``) over gloo, with a fault planted in this rank's
port where asked; or, with ``--split``, the split reference against the
one-card reference.

    python pb_rank.py [--fault NAME --fault-rank R] [--pid-dir DIR] [--chunk-tuples N] \\
        -- <run.py's arguments>
    python pb_rank.py --split CONFIG_FILE --seed N [--chunk-tuples N]

It runs from a copy of the benchmark (``pb_helpers.make_root``): the
copy comes first on ``sys.path``, so its generators and data are the
ones found; the port comes from ``PYTHONPATH``. The launcher
(``launch.run_ranks``) gives it ``RANK``, ``WORLD_SIZE`` and the rest.
"""

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

CALLS = {"n": 0}


def plant(fault: str) -> None:
    """Break this rank's port: ``drop_edge``, one stored edge left out of
    its ``in_block``; ``perturb_score``, one score of each query times
    1.01; ``raise``, the third PageRank call raises; ``hang``, the third
    call never returns."""
    from cugraph_tpu_torch.core.csr import CompressedAdj
    from cugraph_tpu_torch.dist import mg_algos, mg_graph

    if fault == "drop_edge":
        ingest = mg_graph.distribute_edgelist_chunks

        def dropping(*args, **kw):
            mgg = ingest(*args, **kw)
            blk = mgg.in_block
            offsets = blk.offsets.clone()
            offsets[int(blk.majors[0]) + 1:] -= 1
            adj = CompressedAdj(offsets=offsets, minors=blk.minors[1:].clone(),
                                majors=blk.majors[1:].clone(), weights=None,
                                num_majors=blk.num_majors, num_minors=blk.num_minors,
                                num_edges=blk.num_edges - 1)
            return dataclasses.replace(mgg, in_block=adj)

        mg_graph.distribute_edgelist_chunks = dropping
        return
    pagerank = mg_algos.mg_pagerank

    def broken(*args, **kw):
        CALLS["n"] += 1
        if fault == "perturb_score":
            scores, iterations = pagerank(*args, **kw)
            scores = scores.clone()
            scores[0] *= 1.01
            return scores, iterations
        if CALLS["n"] == 3:
            if fault == "raise":
                raise RuntimeError("a fault planted in this rank")
            time.sleep(3600)
        return pagerank(*args, **kw)

    mg_algos.mg_pagerank = broken


def split_check(config_file: str, seed: int) -> int:
    """Rank 0 prints {"keys_equal", "edges", "sum_edges", "max_rel"}: each
    shard equals the one-card reference's pairs of its owner, the shards
    add up to it, and the split PageRank's largest relative gap to the
    one-card one."""
    import torch.distributed as dist

    from port_bench.gen import kronecker
    from port_bench.reference import graph as refgraph
    from port_bench.reference import pagerank, split

    dist.init_process_group("gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    config = json.loads(Path(config_file).read_text())
    v = 1 << int(config["scale"])
    chunks = list(kronecker.edge_chunks(config, seed, torch.device("cpu")))
    shard = split.build_shard(chunks, v, True, rank, world)
    whole = refgraph.build(torch.cat([s for s, _ in chunks]), torch.cat([d for _, d in chunks]),
                           v)
    mine = whole.keys[split.owner(whole.keys, world) == rank]
    equal = split.all_sum(int(not torch.equal(shard.keys, mine)), "cpu") == 0
    total = split.all_sum(shard.num_edges, "cpu")
    want = pagerank.scores(whole, 0.85, 20)
    got = pagerank.scores_split(shard, 0.85, 20)
    rel = float(((got - want).abs() / want).max())
    rel = split.all_max(rel, "cpu")
    if rank == 0:
        print(json.dumps(dict(keys_equal=equal, edges=whole.num_edges, sum_edges=total,
                              max_rel=rel)), flush=True)
    dist.destroy_process_group()
    return 0


def main(argv) -> int:
    cut = argv.index("--") if "--" in argv else len(argv)
    own, rest = argv[:cut], argv[cut + 1:]
    p = argparse.ArgumentParser()
    p.add_argument("--fault", default=None)
    p.add_argument("--fault-rank", type=int, default=0)
    p.add_argument("--pid-dir", default=None)
    p.add_argument("--split", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk-tuples", type=int, default=None)
    a = p.parse_args(own)
    torch.set_num_threads(1)
    if a.chunk_tuples:
        import port_bench.gen

        port_bench.gen.CHUNK_TUPLES = a.chunk_tuples
    rank = int(os.environ["RANK"])
    if a.pid_dir:
        (Path(a.pid_dir) / f"rank{rank}.pid").write_text(str(os.getpid()))
    if a.split:
        return split_check(a.split, a.seed)
    if a.fault and rank == a.fault_rank:
        plant(a.fault)
    from port_bench import run

    return run.rank_main(ROOT, run.parse(rest), torch.device("cpu"))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
