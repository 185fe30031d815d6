"""Run one cell of the benchmark of cugraph_tpu_torch on the card.

    python3 port_bench/run.py --workload kron24.pagerank --seed 7 --seconds 40 --trace 0

from the root of a checkout. The last line of standard output is the
result's JSON object; the last lines of standard error are the numbers the
check compared, each beside its limit. Exits non-zero, printing no result,
without a CUDA card (or fewer than the cell asks for), or where the JAX
package or JAX itself was loaded into the process.

A cell on one card runs in this process. A cell across cards starts one
process a card (this script again, as one rank of the run), waits for
them under a deadline of ``--seconds`` + ``SETUP_ALLOWANCE_S``, stops
every one on the first failure or at the deadline, and prints rank 0's
result line.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "cugraph_tpu"}  # top-level module names, whole
# A run across cards may take --seconds plus this before its ranks are
# stopped: a first run's kernel build (~10 s), imports and the NCCL groups
# (~15 s), the edges streamed twice (into the port and into the
# reference), the port's ingest, the check split over the cards and the
# reading of a trace; 300 s keeps a run of --seconds 50 inside the 360 s
# that a run has.
SETUP_ALLOWANCE_S = 300.0


def log(msg: str) -> None:
    """One line on standard error, in one write: the ranks of a run across
    cards share the stream."""
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by the launcher of a cell across cards: this process is one rank,
    # and the run started at this time.perf_counter() reading
    p.add_argument("--launched-at", type=float, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def emit(result: dict) -> int:
    """Print the result line, after the checks on standard error; 3, and
    nothing printed, where a forbidden module was loaded."""
    found = forbidden_modules()
    if found:
        log(f"modules that the benchmark must not load were loaded: {found}")
        return 3
    for name, check in result["checks"].items():
        log(f"check {name}: {check['value']!r} (limit {check['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


def rank_main(root: Path, args, device) -> int:
    """One rank of a run across cards (``harness.run_rank``); rank 0
    prints the result."""
    from port_bench import harness

    result = harness.run_rank(root, args.workload, args.seed, args.seconds, bool(args.trace),
                              device, args.launched_at, log=log)
    if result is None:
        found = forbidden_modules()
        return 3 if found else 0
    return emit(result)


def launch_main(args, chips: int) -> int:
    """Run the cell on ``chips`` ranks and print rank 0's result line."""
    from port_bench import launch

    command = [sys.executable, str(Path(__file__).resolve()), "--workload", args.workload,
               "--seed", str(args.seed), "--seconds", repr(args.seconds),
               "--trace", str(args.trace), "--launched-at", repr(T_START)]
    code, out = launch.run_ranks(lambda rank: command, chips, args.seconds + SETUP_ALLOWANCE_S,
                                 log)
    lines = out.strip().splitlines()
    if code or not lines:
        log(f"the ranks ended with {code}" + ("" if lines else " and no result from rank 0"))
        return code or 1
    return emit(json.loads(lines[-1]))


def cell_chips(workload: str) -> int:
    """The cards the cell asks for, read from BENCHMARK.json before torch
    is imported: a launcher of ranks leaves the import, and the look for
    the cards, to its ranks."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return next((int(w["chips"]) for w in spec["workloads"] if w["name"] == workload), 1)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    chips = cell_chips(args.workload)
    if args.launched_at is None and chips > 1:
        return launch_main(args, chips)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: the benchmark measures the card and does not fall back to the CPU")
        return 2
    from port_bench import harness

    cell = harness.load_cell(ROOT, args.workload)
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} asks for {cell.chips} cards, {torch.cuda.device_count()} found")
        return 2
    if args.launched_at is not None:
        return rank_main(ROOT, args, torch.device("cuda", int(os.environ["LOCAL_RANK"])))
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START, log=log)
    return emit(result)


if __name__ == "__main__":
    sys.exit(main())
