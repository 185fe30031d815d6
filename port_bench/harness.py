"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell is made of is found by name from ``BENCHMARK.json``: its
configuration file (the generator in ``gen/<generator>.py`` and its
sizes), its traffic file ``traffic/<traffic>.json`` (the analytic, whose
call and counts are ``queries/<analytic>.py`` and whose reference and
comparison are ``reference/<analytic>.py``), and each metric's reader,
``metrics/<metric>.py`` or the general reader of its quantity
(``reader_path``). A cell is added by adding such files and entries.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import importlib
import importlib.util
import json
import random
import re
import time
import traceback
from pathlib import Path

import torch

from . import timing
from .reference import graph as refgraph

BENCH_DIR = Path(__file__).resolve().parent
GRAPH_MISMATCH_LIMIT = 0  # the stored graph is compared exactly


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    bench_dir: Path


def derive_seed(seed: int, purpose: str) -> int:
    """A seed for one use of the run's seed, in [0, 2^63): the edges, the
    roots and the check's sample draw from unrelated streams."""
    digest = hashlib.sha256(f"{seed}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` and the files it
    names, with the metrics it reports: an end-to-end metric unless its
    ``workloads`` leave the cell out; a per-layer metric where its
    ``workloads`` name the cell, or, without that key, where the cell
    reports the metric it moves."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise ValueError(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    config_file = next(c["file"] for c in spec["configs"] if c["name"] == w["config"])
    bench_dir = root / BENCH_DIR.name
    config = json.loads((root / config_file).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [
        m for m in spec["per_layer"]
        if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)
    ]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer, bench_dir)


def reader_path(bench_dir: Path, name: str, analytic: str) -> Path:
    """The reader of metric ``name`` in a cell of ``analytic``: its own
    ``metrics/<name>.py`` where there is one, else the general reader, named
    as the metric with the analytic's word taken out (``gteps.bfs`` ->
    ``metrics/gteps.py``, ``kernels.bfs_roofline`` ->
    ``metrics/kernels.roofline.py``)."""
    own = bench_dir / "metrics" / f"{name}.py"
    if own.exists():
        return own
    a = re.escape(analytic)
    general = re.sub(rf"\.{a}(?=\.|$)|(?<=\.){a}_", "", name, count=1)
    return bench_dir / "metrics" / f"{general}.py"


def metric_reader(bench_dir: Path, name: str, analytic: str):
    """``read(record)`` of the file that ``reader_path`` names."""
    path = reader_path(bench_dir, name, analytic)
    module_name = "port_bench_metric_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def draw_args(traffic: dict, src, dst, num_vertices: int, seed: int):
    """(args of the window's queries, args of the warm-up queries). With a
    ``roots`` entry: roots drawn uniformly, with repeats, among the
    vertices with a tuple to another vertex; else every query's arg is
    None."""
    warm = int(traffic["warmup_queries"])
    spec = traffic.get("roots")
    if spec is None:
        return [None], [None] * warm
    keep = src != dst
    deg = torch.bincount(src[keep], minlength=num_vertices)
    deg += torch.bincount(dst[keep], minlength=num_vertices)
    cand = torch.nonzero(deg).squeeze(1)
    gen = torch.Generator(device=src.device).manual_seed(derive_seed(seed, "roots"))
    count = int(spec["count"])
    pick = torch.randint(0, cand.numel(), (count + warm,), generator=gen, device=src.device)
    roots = cand[pick].tolist()
    return roots[:count], roots[count:]


def card_lines() -> list:
    """nvidia-smi's reading of the card: name, power limit and draw, clocks."""
    import subprocess

    query = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return [f"nvidia-smi: not read ({err})"]
    return [f"nvidia-smi {query}: {line}" for line in out.splitlines()]


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, log=print) -> dict:
    """One run of the cell; returns the result line's object. ``t_start``
    is the process's start on the ``time.perf_counter`` clock."""
    import cugraph_tpu_torch as port

    cell = load_cell(root, workload)
    config, traffic = cell.config, cell.traffic
    if traffic["loop"] != {"kind": "closed", "clients": 1}:
        raise ValueError(f"{workload}: only a closed loop with one client is driven")
    query = importlib.import_module(f"{__package__}.queries.{traffic['analytic']}")
    reference = importlib.import_module(f"{__package__}.reference.{traffic['analytic']}")
    gen = importlib.import_module(f"{__package__}.gen.{config['generator']}")
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    params = traffic["params"]
    v = 1 << int(config["scale"])

    # ---- set-up: the edges and roots from the seed, ingest, warm-up
    marks = [("imports", time.perf_counter())]
    src, dst = gen.edges(config, derive_seed(seed, "edges"), device)
    args, warm = draw_args(traffic, src, dst, v, seed)
    sync()
    t = time.perf_counter()
    marks.append(("edges and roots", t))
    g = port.from_edgelist(src, dst, num_vertices=v, symmetrize=bool(config["symmetrize"]),
                           device=device)
    sync()
    ingest_s = time.perf_counter() - t
    marks.append(("ingest", time.perf_counter()))
    for a in warm:
        query.run(port, g, a, params)
        sync()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start

    # ---- the window: a closed loop, one client
    window = min(seconds, float(traffic["trace_seconds"])) if trace else seconds
    sample_rng = random.Random(derive_seed(seed, "sample"))
    k = int(traffic["check_sample"])
    samples, latencies, done, notes = [], [], [], []
    attempted = failed = 0
    prof = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
    with prof:
        t_win = t_end = time.perf_counter()
        while t_end - t_win < window:
            arg = args[attempted % len(args)]
            attempted += 1
            t = time.perf_counter()
            try:
                result, note = query.run(port, g, arg, params)
                sync()
            except Exception:  # a failed query ends the window and the run's correctness
                log(traceback.format_exc())
                failed += 1
                break
            t_end = time.perf_counter()
            latencies.append(t_end - t)
            done.append(arg)
            notes.append(note)
            i = len(latencies) - 1
            slot = i if i < k else sample_rng.randrange(i + 1)
            if slot < k:
                if slot == len(samples):
                    samples.append((arg, result))
                else:
                    samples[slot] = (arg, result)
            del result
    window_s = t_end - t_win
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    profile_rec = timing.read_profile(prof, window_s) if trace else None

    # ---- the check, after the window: the reference from the same edges
    t_check = time.perf_counter()
    ref = refgraph.build(src, dst, v)
    checks = {"graph_mismatch": (refgraph.graph_mismatch(g, ref), GRAPH_MISMATCH_LIMIT)}
    stored = g.num_edges
    del g, dst
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks.update(reference.check(ref, samples, notes, params, traffic["limits"]))
    facts = refgraph.Facts(ref, src)
    nominal = query.nominal_edges(facts, done, params)
    if trace:
        profile_rec["queries"] = len(done)
        profile_rec["bytes"] = sum(query.compulsory_bytes(facts, done, params))
    del samples, facts, ref, src
    check_s = time.perf_counter() - t_check

    rec = dict(
        cell=workload, analytic=traffic["analytic"], setup_s=setup_s, ingest_build_s=ingest_s,
        window_s=window_s, latencies_s=latencies, nominal_edges=nominal, profile=profile_rec,
    )
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = metric_reader(cell.bench_dir, m["name"], traffic["analytic"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    lat = sorted(latencies)
    log(f"{workload} seed {seed}: {len(done)} queries completed, {failed} failed, "
        f"{attempted} attempted in {window_s:.3f} s; p50 "
        f"{lat[len(lat) // 2] * 1e3 if lat else float('nan'):.3f} ms; stored edges {stored}; "
        f"peak device memory {peak} B; check {check_s:.3f} s")
    last = t_start
    parts = []
    for name, at in marks:
        parts.append(f"{name} {at - last:.3f}")
        last = at
    log(f"set-up {setup_s:.3f} s: " + ", ".join(parts))
    if cuda:
        for line in card_lines():
            log(line)
    correct = failed == 0 and bool(done) and all(val <= lim for val, lim in checks.values())
    dev = dict(
        platform="gpu" if cuda else device.type,
        kind=torch.cuda.get_device_name(device) if cuda else device.type,
        count=cell.chips,
        memory_peak_bytes=peak,
    )
    out = dict(correct=correct, attempted=attempted, failed=failed, metrics=metrics, device=dev)
    if trace:
        dev["busy_s"] = profile_rec["busy_s"]
        dev["window_s"] = profile_rec["wall_s"]
        out["breakdown"] = dict(device_ops=profile_rec["device_ops"],
                                idle_gaps=profile_rec["idle_gaps"])
    out["checks"] = {name: {"value": val, "limit": lim} for name, (val, lim) in checks.items()}
    return out
