"""A cell across cards on the CPU: four gloo ranks at scale 10, each a
process started by the launcher (``launch.run_ranks``) as ``run.py``
starts them on the cards, running ``run.py``'s rank (``tests/pb_rank.py``).

The cells are added to a copy of the benchmark from files alone, as in
``test_pb_new_cell.py``: a test-only generator, ``distinct``, whose tuples
hold each unordered pair of distinct vertices at most once, so that its
symmetrized stream has no parallel edge; and GAP's Kron, whose stream
repeats pairs within and across chunks, which the port's streamed ingest
coalesces (each ordered pair stored once), so that ``graph_mismatch``
reads 0 there too."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from pb_helpers import BENCH, REPO, SEED

from port_bench import harness, launch

WORLD = 4
CHUNK_TUPLES = 4096  # a few chunks a stream at scale 10
DEADLINE_S = 240.0
HANG_DEADLINE_S = 25.0
ONE_CARD_INGEST = {"ingest.symmetrize_s", "ingest.compress_s"}

DISTINCT = '''"""Test-only: each unordered pair of distinct vertices at most once, in
chunks, from the seed."""

import torch

from . import chunk_sizes


def edge_chunks(config, seed, device):
    n = 1 << int(config["scale"])
    gen = torch.Generator(device=device).manual_seed(seed)
    keys = torch.randperm(n * n, generator=gen, device=device)
    u, v = keys // n, keys % n
    keep = u < v
    u, v = u[keep][: int(config["edge_factor"]) * n], v[keep][: int(config["edge_factor"]) * n]
    lo = 0
    for m in chunk_sizes(u.numel()):
        yield u[lo:lo + m].to(torch.int32), v[lo:lo + m].to(torch.int32)
        lo += m
'''


def add_cells(root):
    """The two cells across cards: ``distinct10-mg.pagerank`` and
    ``kron10-mg.pagerank``, each reporting PageRank's metrics."""
    bench = root / BENCH.name
    (bench / "gen" / "distinct.py").write_text(DISTINCT)
    config = json.loads((bench / "configs" / "gap-kron-s24.json").read_text())
    config.update(name="distinct-s10", generator="distinct", params={}, edge_factor=4)
    (bench / "configs" / "distinct-s10.json").write_text(json.dumps(config))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="distinct-s10",
                                file=f"{BENCH.name}/configs/distinct-s10.json"))
    for name, cfg in (("distinct10-mg.pagerank", "distinct-s10"),
                      ("kron10-mg.pagerank", "gap-kron-s24")):
        spec["workloads"].append({"name": name, "config": cfg, "traffic": "pagerank",
                                  "chips": WORLD, "why": "a test cell across cards"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            # the set-up spans of from_edgelist's ingest are not the streamed ingest's
            if "kron24.pagerank" in m.get("workloads", []) and m["name"] not in ONE_CARD_INGEST:
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def ranks(root, world, args, deadline=DEADLINE_S):
    """(exit code, rank 0's last line as JSON or None) of ``pb_rank.py
    args`` on ``world`` ranks, from the copy ``root``. The test sets
    PYTHONPATH to the repository, for the port."""
    script = root / BENCH.name / "tests" / "pb_rank.py"
    code, out = launch.run_ranks(lambda rank: [sys.executable, str(script), *args], world,
                                 deadline, log=lambda msg: None, cwd=root)
    lines = out.strip().splitlines()
    return code, json.loads(lines[-1]) if lines else None


def run_cell(root, tmp_path, workload, *extra, trace=0, deadline=DEADLINE_S):
    """(exit code, rank 0's result or None, the ranks' pids) of one run of
    ``workload`` on four gloo ranks."""
    pids = tmp_path / "pids"
    pids.mkdir()
    args = ["--workload", workload, "--seed", str(SEED), "--seconds", "0.5",
            "--trace", str(trace), "--launched-at", repr(time.perf_counter())]
    code, line = ranks(root, WORLD, ["--pid-dir", str(pids), "--chunk-tuples",
                                     str(CHUNK_TUPLES), *extra, "--", *args], deadline)
    return code, line, [int(p.read_text()) for p in pids.glob("rank*.pid")]


def alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def parallel_edges(root) -> int:
    """The parallel edges of the tiny Kron cell's symmetrized stream,
    counted apart from the harness and the reference: numpy over the
    generator's chunks."""
    import port_bench.gen
    from port_bench.gen import kronecker

    config = json.loads((root / BENCH.name / "configs" / "gap-kron-s24.json").read_text())
    keep, port_bench.gen.CHUNK_TUPLES = port_bench.gen.CHUNK_TUPLES, CHUNK_TUPLES
    try:
        chunks = list(kronecker.edge_chunks(config, harness.derive_seed(SEED, "edges"),
                                            torch.device("cpu")))
    finally:
        port_bench.gen.CHUNK_TUPLES = keep
    assert len(chunks) > 1
    s = np.concatenate([c[0].numpy() for c in chunks]).astype(np.int64)
    d = np.concatenate([c[1].numpy() for c in chunks]).astype(np.int64)
    n = 1 << int(config["scale"])
    pairs = np.concatenate([s * n + d, d * n + s])
    return int(pairs.size - np.unique(pairs).size)


CASES = ["sound", "sound_traced", "kron_parallel_edges_coalesced", "dropped_edge",
         "perturbed_score",
         "rank_raises", "rank_hangs"]


@pytest.fixture
def port_path(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", str(REPO))


@pytest.mark.parametrize("case", CASES)
def test_four_ranks(tiny_root, tmp_path, port_path, case):
    add_cells(tiny_root)
    cell, extra, kw = "distinct10-mg.pagerank", [], {}
    if case == "sound_traced":
        kw = dict(trace=1)
    elif case == "kron_parallel_edges_coalesced":
        cell = "kron10-mg.pagerank"
    elif case != "sound":
        fault = {"dropped_edge": "drop_edge", "perturbed_score": "perturb_score",
                 "rank_raises": "raise", "rank_hangs": "hang"}[case]
        extra = ["--fault", fault, "--fault-rank", "2"]
        if case == "rank_hangs":
            kw = dict(deadline=HANG_DEADLINE_S)
    code, line, pids = run_cell(tiny_root, tmp_path, cell, *extra, **kw)
    assert len(pids) == WORLD and not any(alive(p) for p in pids)
    if case in ("rank_raises", "rank_hangs"):
        assert code == (124 if case == "rank_hangs" else 1) and line is None
        return
    assert code == 0
    checks = {k: c["value"] for k, c in line["checks"].items()}
    assert line["device"]["count"] == WORLD and line["attempted"] > 0
    if case == "sound":
        assert line["correct"] is True, checks
        assert set(line["metrics"]) == {"gteps.pagerank", "query_p95_ms.pagerank", "setup_s"}
        assert all(m["value"] > 0 for m in line["metrics"].values())
        assert checks["graph_mismatch"] == 0
    elif case == "sound_traced":
        assert line["correct"] is True, checks
        # the CPU launches nothing: the device's readers find nothing and stay out
        assert set(line["metrics"]) == {
            "ingest.build_s", "algorithms.launches_per_query.pagerank",
            "algorithms.host_reads_per_query.pagerank", "setup.port_import_s"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    elif case == "kron_parallel_edges_coalesced":
        assert parallel_edges(tiny_root) > 0  # the stream repeats pairs
        assert checks["graph_mismatch"] == 0
        assert line["correct"] is True, checks
    elif case == "dropped_edge":
        assert checks["graph_mismatch"] == 1 and line["correct"] is False
    else:
        assert checks["pagerank_rel_err"] > line["checks"]["pagerank_rel_err"]["limit"]
        assert checks["graph_mismatch"] == 0 and line["correct"] is False


def test_launcher_ended_by_sigterm_stops_every_rank(tiny_root, tmp_path, port_path):
    """A launcher ended from outside (a caller's time limit) stops its
    ranks first: here four ranks that hang in their first timed query."""
    add_cells(tiny_root)
    pids = tmp_path / "pids"
    pids.mkdir()
    command = [sys.executable, str(tiny_root / BENCH.name / "tests" / "pb_rank.py"),
               "--pid-dir", str(pids), "--fault", "hang", "--fault-rank", "1", "--",
               "--workload", "distinct10-mg.pagerank", "--seed", str(SEED), "--seconds", "30",
               "--trace", "0", "--launched-at", "0"]
    code = ("import json, sys\n"
            f"sys.path.insert(0, {str(tiny_root)!r})\n"
            "from port_bench import launch\n"
            "sys.exit(launch.run_ranks(lambda r: json.loads(sys.argv[1]), 4, 600, print)[0])\n")
    launcher = subprocess.Popen([sys.executable, "-c", code, json.dumps(command)],
                                cwd=tiny_root, stdout=subprocess.DEVNULL)
    try:
        end = time.monotonic() + 120
        while len(list(pids.glob("rank*.pid"))) < WORLD and time.monotonic() < end:
            time.sleep(0.2)
        time.sleep(3)
        launcher.send_signal(signal.SIGTERM)
        assert launcher.wait(timeout=60) == 128 + signal.SIGTERM
    finally:
        launcher.kill()
        launcher.wait()
    ranks_pids = [int(p.read_text()) for p in pids.glob("rank*.pid")]
    assert len(ranks_pids) == WORLD and not any(alive(p) for p in ranks_pids)


def test_cli_across_cards_refuses_without_card(tiny_root):
    """``run.py`` launches a cell across cards without importing torch; its
    ranks find no card and exit 2, and the launcher, at the first of them,
    stops the rest and exits 2 itself, printing no result. How many ranks
    reach their own look for a card before that stop is a race."""
    add_cells(tiny_root)
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "distinct10-mg.pagerank", "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=tiny_root, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode == 2 and proc.stdout.strip() == ""
    assert "exited with 2: stopping every rank" in proc.stderr
    assert 1 <= proc.stderr.count("no CUDA card") <= WORLD


@pytest.mark.parametrize("world", [1, 2, 4])
def test_split_reference_equals_one_card(tiny_root, port_path, world):
    config = tiny_root / BENCH.name / "configs" / "gap-kron-s24.json"
    code, line = ranks(tiny_root, world, ["--split", str(config), "--seed", str(SEED),
                                          "--chunk-tuples", str(CHUNK_TUPLES)])
    assert code == 0
    assert line["keys_equal"] is True and line["sum_edges"] == line["edges"] > 0
    assert line["max_rel"] < 1e-12
