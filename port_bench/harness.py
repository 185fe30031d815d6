"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell is made of is found by name from ``BENCHMARK.json``: its
configuration file (the generator in ``gen/<generator>.py`` and its
sizes), its traffic file ``traffic/<traffic>.json`` (the analytic, whose
call and counts are ``queries/<analytic>.py`` and whose reference and
comparison are ``reference/<analytic>.py``), and each metric's reader,
``metrics/<metric>.py`` or the general reader of its quantity
(``reader_path``). A cell is added by adding such files and entries.

A cell on one card runs in one process (``run_cell``); a cell across
cards runs one process a card, each of them ``run_rank``, through the
port's multi-card layer (``cugraph_tpu_torch.dist``) and the reference
split over the ranks (``reference/split.py``).
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

from . import spans, timing
from .gen import weights as weight_gen
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


def cell_edges(gen, config: dict, seed: int, device: torch.device):
    """(src, dst, weight) of a cell on one card: the generator's tuples from
    the seed's ``edges`` stream, and one weight a tuple from its
    ``weights`` stream where the configuration names weights (else None),
    so that a weighted configuration stores the graph of its unweighted
    twin."""
    src, dst = gen.edges(config, derive_seed(seed, "edges"), device)
    weight = weight_gen.draw(config, src.numel(), derive_seed(seed, "weights"), device)
    return src, dst, weight


def draw_args(traffic: dict, chunks, num_vertices: int, seed: int, device: torch.device):
    """(args of the window's queries, args of the warm-up queries). With a
    ``roots`` entry: roots drawn uniformly, with repeats, among the
    vertices with a tuple to another vertex (``chunks``: the (src, dst)
    tuples, in one piece or in several); else every query's arg is
    None."""
    warm = int(traffic["warmup_queries"])
    spec = traffic.get("roots")
    if spec is None:
        return [None], [None] * warm
    deg = torch.zeros(num_vertices, dtype=torch.int64, device=device)
    for src, dst in chunks:
        keep = src != dst
        deg += torch.bincount(src[keep], minlength=num_vertices)
        deg += torch.bincount(dst[keep], minlength=num_vertices)
    cand = torch.nonzero(deg).squeeze(1)
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "roots"))
    count = int(spec["count"])
    pick = torch.randint(0, cand.numel(), (count + warm,), generator=gen, device=device)
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


def cell_modules(cell: Cell):
    """(queries, reference, generator) modules of ``cell``."""
    if cell.traffic["loop"] != {"kind": "closed", "clients": 1}:
        raise ValueError(f"{cell.name}: only a closed loop with one client is driven")
    analytic = cell.traffic["analytic"]
    return (importlib.import_module(f"{__package__}.queries.{analytic}"),
            importlib.import_module(f"{__package__}.reference.{analytic}"),
            importlib.import_module(f"{__package__}.gen.{cell.config['generator']}"))


@dataclasses.dataclass
class Window:
    """What the measured window did: queries attempted and failed, each
    completed query's arg, latency and note, the check's sample of
    (arg, result), its seconds, and the profiler (with ``--trace 1``)."""

    attempted: int
    failed: int
    done: list
    latencies: list
    notes: list
    samples: list
    window_s: float
    prof: object


def drive(call, ready, args: list, seconds: float, k: int, sample_rng: random.Random,
          prof, log, go=bool, catch: bool = True) -> Window:
    """A closed loop with one client for ``seconds``: ``call(arg)`` then
    ``ready()`` a query, latency from the call to ``ready`` returning. The
    check's sample is a reservoir of ``k`` queries drawn by
    ``sample_rng``. ``go(more)`` decides whether the next query runs
    (across cards, rank 0's ``more`` for every rank), outside the latency.
    A query that raises ends the window and counts as failed, or, without
    ``catch``, ends the run."""
    samples, latencies, done, notes = [], [], [], []
    attempted = failed = 0
    with prof:
        t_win = t_end = time.perf_counter()
        while go(t_end - t_win < seconds):
            arg = args[attempted % len(args)]
            attempted += 1
            t = time.perf_counter()
            try:
                result, note = call(arg)
                ready()
            except Exception:  # a failed query ends the window and the run's correctness
                if not catch:
                    raise
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
    return Window(attempted, failed, done, latencies, notes, samples, t_end - t_win, prof)


def profiler(trace: bool, cuda: bool):
    """A torch.profiler of the host and, on a card, the device; a no-op
    context untraced."""
    if not trace:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))


def read_trace(win: Window, log) -> dict:
    """The record's readings of a traced window: ``profile``
    (``timing.read_profile``), ``spans`` (the program's spans in it,
    ``spans.read_spans``) and ``setup_spans`` (the program's set-up spans
    in this process); the spans are logged as one ``spans:`` line."""
    out = dict(profile=timing.read_profile(win.prof, win.window_s),
               spans=spans.read_spans(win.prof), setup_spans=spans.program_setup_spans())
    log("spans: " + json.dumps(dict(out["spans"], setup_spans=out["setup_spans"])))
    return out


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, log=print) -> dict:
    """One run of a cell on one card; returns the result line's object.
    ``t_start`` is the process's start on the ``time.perf_counter``
    clock."""
    import cugraph_tpu_torch as port

    cell = load_cell(root, workload)
    config, traffic = cell.config, cell.traffic
    query, reference, gen = cell_modules(cell)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    params = traffic["params"]
    v = 1 << int(config["scale"])

    # ---- set-up: the edges and roots from the seed, ingest, warm-up
    marks = [("imports", time.perf_counter())]
    src, dst, weight = cell_edges(gen, config, seed, device)
    args, warm = draw_args(traffic, [(src, dst)], v, seed, device)
    sync()
    t = time.perf_counter()
    marks.append(("edges and roots", t))
    g = port.from_edgelist(src, dst, weight, num_vertices=v,
                           symmetrize=bool(config["symmetrize"]), device=device)
    sync()
    ingest_s = time.perf_counter() - t
    marks.append(("ingest", time.perf_counter()))
    for a in warm:
        query.run(port, g, a, params)
        sync()
    marks.append(("warm-up", time.perf_counter()))

    # ---- the window: a closed loop, one client
    window = min(seconds, float(traffic["trace_seconds"])) if trace else seconds
    win = drive(lambda a: query.run(port, g, a, params), sync, args, window,
                int(traffic["check_sample"]), random.Random(derive_seed(seed, "sample")),
                profiler(trace, cuda), log)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    traced = read_trace(win, log) if trace else {}

    # ---- the check, after the window: the reference from the same edges
    t_check = time.perf_counter()
    ref = refgraph.build(src, dst, v, weight)
    checks = {"graph_mismatch": (refgraph.graph_mismatch(g, ref), GRAPH_MISMATCH_LIMIT)}
    stored = g.num_edges
    del g, dst, weight
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks.update(reference.check(ref, win.samples, win.notes, params, traffic["limits"]))
    facts = refgraph.Facts(ref, src)
    nominal = query.nominal_edges(facts, win.done, params)
    if trace:
        traced["profile"]["queries"] = len(win.done)
        traced["profile"]["bytes"] = sum(query.compulsory_bytes(facts, win.done, params))
    del facts, ref, src
    win.samples.clear()
    return finish(cell, seed, win, traced, checks, nominal, marks, t_start, ingest_s, stored,
                  peak, time.perf_counter() - t_check, device, log)


def run_rank(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, log=print):
    """One rank's part of a run of a cell across cards, in a process of its
    own beside one a card (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` in its environment, ``device`` its card). Returns rank
    0's result line's object, and None on the others. Rank 0 drives the
    loop, broadcasting each go or stop, and is the one traced; a query's
    latency ends when every rank has synchronized and met at one barrier,
    on rank 0's clock (both on a gloo group of the host, so that the
    trace holds the port's work alone). ``t_start`` is the launcher's start,
    on the ``time.perf_counter`` clock (the host's, in every process)."""
    import torch.distributed as dist

    import cugraph_tpu_torch as port
    import cugraph_tpu_torch.dist  # noqa: F401 (the multi-card layer is imported on its own)

    from .reference import split

    cell = load_cell(root, workload)
    config, traffic = cell.config, cell.traffic
    if "weights" in config:
        raise ValueError(f"{workload} runs across cards on a weighted configuration: the "
                         "harness draws and checks weights on one card only")
    query, reference, gen = cell_modules(cell)
    for module, name in ((query, "run_mg"), (reference, "check_split"), (gen, "edge_chunks")):
        if not hasattr(module, name):
            raise ValueError(f"{workload} runs across cards: {module.__name__} has no {name}")
    cuda = device.type == "cuda"
    params = traffic["params"]
    v = 1 << int(config["scale"])
    symmetrize = bool(config["symmetrize"])

    marks = [("imports", time.perf_counter())]
    dev = port.dist.initialize_distributed(device=device)
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != cell.chips:
        raise ValueError(f"{workload} asks for {cell.chips} ranks, {world} joined")
    mesh = port.dist.make_mesh(port.dist.mesh_shape_for(world), device=dev)
    # the harness's own barrier and go/stop on the host (gloo): no launch,
    # no device read in the traced window
    control = dist.new_group(backend="gloo")

    def meet():
        """Every rank's queued work done, then one barrier."""
        if cuda:
            torch.cuda.synchronize(dev)
        dist.barrier(group=control)

    def chunks():
        return gen.edge_chunks(config, derive_seed(seed, "edges"), dev)

    args, warm = draw_args(traffic, chunks(), v, seed, dev)
    meet()
    marks.append(("mesh and roots", time.perf_counter()))
    t = time.perf_counter()
    g = port.dist.mg_graph.distribute_edgelist_chunks(mesh, chunks, num_vertices=v,
                                                      symmetrize=symmetrize)
    meet()
    ingest_s = split.all_max(time.perf_counter() - t, dev)
    marks.append(("ingest", time.perf_counter()))
    for a in warm:
        query.run_mg(port, mesh, g, a, params)
    meet()
    marks.append(("warm-up", time.perf_counter()))

    def go(more: bool) -> bool:
        flag = torch.tensor([int(more)], dtype=torch.int32)
        dist.broadcast(flag, 0, group=control)
        return bool(flag.numpy()[0])

    window = min(seconds, float(traffic["trace_seconds"])) if trace else seconds
    win = drive(lambda a: query.run_mg(port, mesh, g, a, params), meet, args, window,
                int(traffic["check_sample"]), random.Random(derive_seed(seed, "sample")),
                profiler(trace and rank == 0, cuda), log, go=go, catch=False)
    mine = torch.cuda.max_memory_allocated(dev) if cuda else 0
    log(f"rank {rank}: peak device memory {mine} B")
    peak = int(split.all_max(mine, dev))
    traced = read_trace(win, log) if trace and rank == 0 else {}

    # ---- the check, split over the ranks
    t_check = time.perf_counter()
    keys, bad = split.exchange_stored(g, v, symmetrize, rank, world, dev)
    stored = split.all_sum(g.in_block.num_edges, dev)
    del g
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    received = split.received(keys, bad)
    del keys
    shard = split.build_shard(chunks(), v, symmetrize, rank, world)
    checks = {"graph_mismatch": (split.graph_mismatch(received, shard, dev),
                                 GRAPH_MISMATCH_LIMIT)}
    del received
    checks.update(reference.check_split(shard, win.samples, win.notes, params,
                                        traffic["limits"]))
    facts = split.Facts(shard)
    del shard
    win.samples.clear()
    nominal = query.nominal_edges(facts, win.done, params)
    if rank:
        dist.destroy_process_group()
        return None
    if trace:
        # an even share of the query's compulsory bytes a card
        traced["profile"]["queries"] = len(win.done)
        traced["profile"]["bytes"] = sum(query.compulsory_bytes(facts, win.done, params)) / world
    dist.destroy_process_group()
    return finish(cell, seed, win, traced, checks, nominal, marks, t_start, ingest_s, stored,
                  peak, time.perf_counter() - t_check, device, log)


def finish(cell: Cell, seed: int, win: Window, traced: dict, checks: dict, nominal: list,
           marks: list, t_start: float, ingest_s: float, stored: int, peak: int,
           check_s: float, device: torch.device, log) -> dict:
    """The result line's object: each metric of the cell read from the run
    record; and the run's summary logged. ``marks`` are the set-up's
    phases, (name, end), the last the end of set-up; ``traced`` is
    ``read_trace``'s readings, empty untraced."""
    cuda = device.type == "cuda"
    rec = dict(cell=cell.name, analytic=cell.traffic["analytic"], setup_s=marks[-1][1] - t_start,
               ingest_build_s=ingest_s, window_s=win.window_s, latencies_s=win.latencies,
               nominal_edges=nominal, profile=traced.get("profile"), spans=traced.get("spans"),
               setup_spans=traced.get("setup_spans"))
    metrics = {}
    for m in cell.per_layer if rec["profile"] is not None else cell.end_to_end:
        value = metric_reader(cell.bench_dir, m["name"], rec["analytic"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    lat = sorted(win.latencies)
    log(f"{cell.name} seed {seed}: {len(win.done)} queries completed, {win.failed} failed, "
        f"{win.attempted} attempted in {win.window_s:.3f} s; p50 "
        f"{lat[len(lat) // 2] * 1e3 if lat else float('nan'):.3f} ms; stored edges {stored}; "
        f"peak device memory {peak} B; check {check_s:.3f} s")
    last = t_start
    parts = []
    for name, at in marks:
        parts.append(f"{name} {at - last:.3f}")
        last = at
    log(f"set-up {rec['setup_s']:.3f} s: " + ", ".join(parts))
    if cuda:
        for line in card_lines():
            log(line)
    correct = (win.failed == 0 and bool(win.done)
               and all(val <= lim for val, lim in checks.values()))
    dev = dict(
        platform="gpu" if cuda else device.type,
        kind=torch.cuda.get_device_name(device) if cuda else device.type,
        count=cell.chips,
        memory_peak_bytes=peak,
    )
    out = dict(correct=correct, attempted=win.attempted, failed=win.failed, metrics=metrics,
               device=dev)
    if rec["profile"] is not None:
        dev["busy_s"] = rec["profile"]["busy_s"]
        dev["window_s"] = rec["profile"]["wall_s"]
        out["breakdown"] = dict(device_ops=rec["profile"]["device_ops"],
                                idle_gaps=rec["profile"]["idle_gaps"])
    out["checks"] = {name: {"value": val, "limit": lim} for name, (val, lim) in checks.items()}
    return out
