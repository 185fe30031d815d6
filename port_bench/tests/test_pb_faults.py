"""A run with the timed path broken underneath it reads ``correct``
false: everything of a run but the look for a card, on the CPU at a tiny
scale, with one fault planted in the port's SpMV plain versions (the path
the CPU takes) or in its ingest. One chip, so there is no exchange
between chips to leave out."""

import pytest
import torch
from pb_helpers import run_tiny

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


csr_symmetrize = csr.symmetrize_edgelist

FAULTS = {
    "state_unchanged": [("spmv_sum_reference", unchanged), ("spmv_minplus_reference", unchanged)],
    "half_rows_left_out": [("spmv_sum_reference", half_rows(SUM)),
                           ("spmv_minplus_reference", half_rows(MIN))],
    "answer_altered": [("spmv_sum_reference", altered_sum),
                       ("spmv_minplus_reference", altered_min)],
    "half_tuples_left_out": [],
}


@pytest.mark.parametrize("workload", ["kron24.pagerank", "urand24.bfs"])
def test_sound_run_is_correct(tiny_root, workload):
    assert run_tiny(tiny_root, workload)["correct"] is True


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ["kron24.pagerank", "urand24.pagerank", "kron24.bfs"])
def test_fault_is_caught(tiny_root, monkeypatch, workload, fault):
    for name, fn in FAULTS[fault]:
        monkeypatch.setattr(spmv, name, fn)
    if fault == "half_tuples_left_out":
        monkeypatch.setattr(csr, "symmetrize_edgelist", half_ingest)
    out = run_tiny(tiny_root, workload)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
