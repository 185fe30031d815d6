"""Run one cell of the benchmark of cugraph_tpu_torch on the card.

    python3 port_bench/run.py --workload kron24.pagerank --seed 7 --seconds 40 --trace 0

from the root of a checkout. The last line of standard output is the
result's JSON object; the last lines of standard error are the numbers the
check compared, each beside its limit. Exits non-zero, printing no result,
without a CUDA card (or fewer than the cell asks for), or where the JAX
package or JAX itself was loaded into the process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "cugraph_tpu"}  # top-level module names, whole


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: the benchmark measures the card and does not fall back to the CPU")
        return 2
    sys.path.insert(0, str(ROOT))
    from port_bench import harness

    cell = harness.load_cell(ROOT, args.workload)
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} asks for {cell.chips} cards, {torch.cuda.device_count()} found")
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START, log=log)
    found = forbidden_modules()
    if found:
        log(f"modules that the benchmark must not load were loaded: {found}")
        return 3
    for name, check in result["checks"].items():
        log(f"check {name}: {check['value']!r} (limit {check['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
