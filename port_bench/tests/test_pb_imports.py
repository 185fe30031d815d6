"""What the benchmark may load: no module of the top-level name jax,
jaxlib, flax or cugraph_tpu (names compared whole: cugraph_tpu_torch is
the code under test), nothing of the JAX package's benchmarks, and in the
reference nothing of cugraph_tpu_torch."""

import ast
import subprocess
import sys

import pytest
from pb_helpers import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "cugraph_tpu"}
JAX_BENCH_FILES = ("bench" + "marks/", "bench" + ".py")  # the JAX package's, never read
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path):
    """Top-level names of every module that ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN
    text = path.read_text()
    assert not any(name in text for name in JAX_BENCH_FILES)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_port(path):
    assert "cugraph_tpu_torch" not in imported(path)


def test_reference_loads_no_port():
    """Imported alone, the reference, the generators and the timing load
    neither the port nor JAX."""
    code = (
        "import sys\n"
        "import port_bench.reference.graph, port_bench.reference.pagerank\n"
        "import port_bench.reference.bfs, port_bench.gen.kronecker, port_bench.gen.uniform\n"
        "import port_bench.timing\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"cugraph_tpu_torch"})


def test_whole_names():
    """cugraph_tpu_torch is not cugraph_tpu: the check compares whole names."""
    src = "import cugraph_tpu_torch\nfrom cugraph_tpu_torch.algos import bfs\n"
    tmp = ast.parse(src)
    names = {a.name.split(".")[0] for n in ast.walk(tmp) if isinstance(n, ast.Import)
             for a in n.names}
    assert names == {"cugraph_tpu_torch"} and not names & FORBIDDEN
