"""The readings that a cell's limits are set from, in one process on the card.

    python3 port_bench/calibrate.py --workload kron24.pagerank --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 3

For each of ``--seeds``, a short run of the cell (``harness.run_cell``,
window ``--seconds``) and the numbers its check compared: the lower
readings. For each of ``--control-seeds``, the control in the program's
place (``reference/<analytic>.py:control``, the reference one precision
below the configuration's) on the first ``check_sample`` queries of the
seed's draw, judged by the same comparison: the upper readings. One JSON
line a seed. The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_readings(cell, seed: int, device) -> dict:
    """{name: reading} of the control of ``cell`` (a ``harness.Cell``) on
    the first ``check_sample`` queries of ``seed``'s draw."""
    import importlib

    import torch

    from port_bench import harness
    from port_bench.reference import graph as refgraph

    config, traffic = cell.config, cell.traffic
    gen = importlib.import_module(f"port_bench.gen.{config['generator']}")
    reference = importlib.import_module(f"port_bench.reference.{traffic['analytic']}")
    v = 1 << int(config["scale"])
    src, dst = gen.edges(config, harness.derive_seed(seed, "edges"), device)
    args, _ = harness.draw_args(traffic, src, dst, v, seed)
    ref = refgraph.build(src, dst, v)
    del src, dst
    args = [args[i % len(args)] for i in range(int(traffic["check_sample"]))]
    results = reference.control(ref, args, traffic["params"])
    samples = [(a, r) for a, (r, _) in zip(args, results)]
    notes = [n for _, n in results]
    checks = reference.check(ref, samples, notes, traffic["params"], traffic["limits"])
    del ref, samples, results
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {name: value for name, (value, _) in checks.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the limits are set from readings on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from port_bench import harness

    cell = harness.load_cell(ROOT, a.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} asks for {cell.chips} cards, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    for seed in seeds:
        out = harness.run_cell(ROOT, a.workload, seed, a.seconds, False, device,
                               time.perf_counter(), log=lambda m: print(m, file=sys.stderr))
        print(json.dumps(dict(workload=a.workload, seed=seed, side="program",
                              correct=out["correct"], attempted=out["attempted"],
                              readings={k: c["value"] for k, c in out["checks"].items()})),
              flush=True)
        torch.cuda.empty_cache()
    for seed in [int(s) for s in a.control_seeds.split(",") if s]:
        readings = control_readings(cell, seed, device)
        print(json.dumps(dict(workload=a.workload, seed=seed, side="control", readings=readings)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
