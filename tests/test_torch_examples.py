"""The port's example scripts, run through their ``main`` on the CPU.

- ``train_graphsage`` at ``--scale 8`` (256 vertices: one batch of 512
  holds every vertex, so each step trains on the same seeds) for 10
  steps: every loss finite, the last below the first, the mean of the
  last three below that of the first three.
- ``community_detection`` on karate (no dataset directory): its printed
  lines equal those of the JAX package's ``examples/community_detection.py``
  (the same Q for Louvain, Leiden and ECG to 4 decimals, and the same
  triangle total), and the returned numbers equal the port's own calls.
"""

import importlib.util
import math
from pathlib import Path

import pytest

import cugraph_tpu_torch as ct
from cugraph_tpu_torch.examples import community_detection, train_graphsage

ROOT = Path(__file__).resolve().parents[1]


def test_train_graphsage_loss_falls(capsys):
    out = train_graphsage.main(["--scale", "8", "--steps", "10", "--device", "cpu"])
    losses = out["losses"]
    assert len(losses) == 10 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    assert sum(losses[-3:]) < sum(losses[:3])
    printed = capsys.readouterr().out
    assert "step 10: loss" in printed and "seeds/s" in printed
    assert out["steps_per_s"] > 0


def test_train_graphsage_default_device_needs_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_graphsage.main(["--scale", "4", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        community_detection.main([])


def test_community_detection_matches_the_jax_script(capsys, monkeypatch):
    monkeypatch.setattr(ct.testing.datasets, "DATASET_DIR", None)
    out = community_detection.main(["--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()
    spec = importlib.util.spec_from_file_location("jax_community_detection",
                                                  ROOT / "examples" / "community_detection.py")
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    import cugraph_tpu.testing.datasets as jax_datasets

    monkeypatch.setattr(jax_datasets, "DATASET_DIR", None)
    jax_script.main()
    jax_lines = capsys.readouterr().out.splitlines()
    assert port_lines == jax_lines
    assert port_lines[0] == "karate: V=34 E=156" and out["graph"] == "karate"
    g = ct.from_edgelist(*ct.testing.karate_edgelist(), symmetrize=True, device="cpu")
    assert out["louvain"] == ct.louvain(g)[1] and out["triangles"] == 45
