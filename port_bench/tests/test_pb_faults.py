"""A run with the timed path broken underneath it reads ``correct``
false: everything of a run but the look for a card, on the CPU at a tiny
scale, with one fault planted in the port's SpMV plain versions (the path
the CPU takes), in its ingest, or, for SSSP, in the answer its sweeps
produce. One chip, so there is no exchange between chips to leave out.

SSSP's cell takes the min-plus sweeps at 2^24 vertices; at the tests'
tiny scale its graph is below their gate (``SSSP_SWEEP_MIN_EDGES``), which
the tests lower so that the same path runs."""

import pytest
import torch
from pb_helpers import run_tiny

from cugraph_tpu_torch.algos import traversal
from cugraph_tpu_torch.core import csr
from cugraph_tpu_torch.prims.cuda import spmv

SUM, MIN = spmv.spmv_sum_reference, spmv.spmv_minplus_reference


def unchanged(adj, x, **kw):
    """The step hands back its state: y = x."""
    return x.clone()


def half_rows(plain):
    def f(adj, x, **kw):
        y = plain(adj, x, **kw)
        y[y.numel() // 2:] = 0.0 if plain is SUM else float("inf")
        return y
    return f


def altered_sum(adj, x, **kw):
    y = SUM(adj, x, **kw)
    y[y.numel() // 3] *= 1.01
    return y


def altered_min(adj, x, **kw):
    """One vertex reached this level names itself as its predecessor."""
    y = MIN(adj, x, **kw)
    hit = torch.nonzero(torch.isfinite(y) & torch.isinf(x)).squeeze(1)
    if hit.numel():
        y[hit[0]] = float(hit[0])
    return y


def half_ingest(src, dst, weight=None, **kw):
    """Half of the tuples left out of the stored graph."""
    n = src.numel() // 2
    return csr_symmetrize(src[:n], dst[:n], None if weight is None else weight[:n], **kw)


def weights_dropped(src, dst, weight=None, **kw):
    """The ingest stores the tuples without their weights."""
    return csr_symmetrize(src, dst, None, **kw)


csr_symmetrize = csr.symmetrize_edgelist
SWEEPS = traversal._sssp_sweeps


def distance_off_by_one(g, src_mask, cutoff):
    """One reached vertex, not a source, one further than its distance."""
    dist, pred = SWEEPS(g, src_mask, cutoff)
    hit = torch.nonzero(torch.isfinite(dist) & ~src_mask).squeeze(1)
    dist[hit[0]] += 1.0
    return dist, pred


def predecessor_off_path(g, src_mask, cutoff):
    """One reached vertex names as predecessor an in-neighbour that is on
    no shortest path to it."""
    dist, pred = SWEEPS(g, src_mask, cutoff)
    csc = g.csc()
    u, v = csc.minors.long(), csc.majors.long()
    off = (torch.isfinite(dist[v]) & ~src_mask[v] & (u != v)
           & (dist[u] + csc.weights != dist[v]))
    e = torch.nonzero(off).squeeze(1)[0]
    pred[v[e]] = u[e].to(pred.dtype)
    return dist, pred

FAULTS = {
    "state_unchanged": [("spmv_sum_reference", unchanged), ("spmv_minplus_reference", unchanged)],
    "half_rows_left_out": [("spmv_sum_reference", half_rows(SUM)),
                           ("spmv_minplus_reference", half_rows(MIN))],
    "answer_altered": [("spmv_sum_reference", altered_sum),
                       ("spmv_minplus_reference", altered_min)],
    "half_tuples_left_out": [],
}
# faults that only a weighted SSSP cell can have: (module, name, stand-in)
SSSP_FAULTS = {
    "distance_off_by_one": (traversal, "_sssp_sweeps", distance_off_by_one),
    "predecessor_off_path": (traversal, "_sssp_sweeps", predecessor_off_path),
    "weights_dropped": (csr, "symmetrize_edgelist", weights_dropped),
}
SSSP = "kron24w.sssp"
CASES = [(w, f) for w in ["kron24.pagerank", "urand24.pagerank", "kron24.bfs", SSSP]
         for f in sorted(FAULTS)] + [(SSSP, f) for f in sorted(SSSP_FAULTS)]


@pytest.fixture
def sweeps_gate(monkeypatch):
    """SSSP's tiny graph takes the sweeps, as the cell's does."""
    monkeypatch.setattr(traversal, "SSSP_SWEEP_MIN_EDGES", 0)


@pytest.mark.parametrize("workload", ["kron24.pagerank", "urand24.bfs", SSSP])
def test_sound_run_is_correct(tiny_root, sweeps_gate, workload):
    out = run_tiny(tiny_root, workload)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("workload,fault", CASES, ids=[f"{w}-{f}" for w, f in CASES])
def test_fault_is_caught(tiny_root, monkeypatch, sweeps_gate, workload, fault):
    for name, fn in FAULTS.get(fault, []):
        monkeypatch.setattr(spmv, name, fn)
    if fault == "half_tuples_left_out":
        monkeypatch.setattr(csr, "symmetrize_edgelist", half_ingest)
    if fault in SSSP_FAULTS:
        monkeypatch.setattr(*SSSP_FAULTS[fault])
    out = run_tiny(tiny_root, workload)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
