"""A cell is added by adding files and entries: a new traffic mix and a
new configuration, named in new BENCHMARK.json entries, run without a
change to any file that was there."""

import hashlib
import json

from pb_helpers import BENCH, run_tiny


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / BENCH.name).rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_from_files_alone(tiny_root):
    before = digests(tiny_root)
    bench = tiny_root / BENCH.name
    traffic = json.loads((bench / "traffic" / "pagerank.json").read_text())
    traffic["params"]["max_iterations"] = 5
    (bench / "traffic" / "pagerank5.json").write_text(json.dumps(traffic))
    config = json.loads((bench / "configs" / "gap-urand-s24.json").read_text())
    config.update(name="gap-urand-ef8", edge_factor=8, scale=9)
    (bench / "configs" / "gap-urand-ef8.json").write_text(json.dumps(config))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][1], name="gap-urand-ef8",
                                file=f"{BENCH.name}/configs/gap-urand-ef8.json"))
    spec["workloads"].append({"name": "urand9.pagerank5", "config": "gap-urand-ef8",
                              "traffic": "pagerank5", "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "kron24.pagerank" in m.get("workloads", []):
            m["workloads"].append("urand9.pagerank5")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    out = run_tiny(tiny_root, "urand9.pagerank5")
    assert out["correct"] is True
    assert set(out["metrics"]) == {"gteps.pagerank", "query_p95_ms.pagerank", "setup_s"}
    traced = run_tiny(tiny_root, "urand9.pagerank5", trace=True)
    assert traced["metrics"]["algorithms.host_reads_per_query.pagerank"]["value"] == 5.0
    after = digests(tiny_root)
    assert {k: v for k, v in after.items() if k in before} == before
