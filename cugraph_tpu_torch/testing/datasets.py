"""Test datasets.

Counterpart of ``cugraph_tpu/testing/datasets.py``. The reference bundles
small classic graphs (karate, dolphins, netscience, email-Eu-core; ref:
datasets/). They load from the directory that ``CUGRAPH_TPU_DATASET_DIR``
names, when it is set and holds them; karate falls back to networkx's
bundled copy, the others skip the calling test. Nothing is downloaded.
The loaders return host arrays (int32 ids, float32 weights or None).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

DATASET_DIR = os.environ.get("CUGRAPH_TPU_DATASET_DIR") or None


def load_csv_edgelist(
    path: str, delimiter: str = " "
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    data = np.loadtxt(path, delimiter=delimiter)
    if data.ndim == 1:
        data = data[None, :]
    src = data[:, 0].astype(np.int32)
    dst = data[:, 1].astype(np.int32)
    w = data[:, 2].astype(np.float32) if data.shape[1] > 2 else None
    return src, dst, w


def _load_or_none(name: str):
    if DATASET_DIR is None:
        return None
    path = os.path.join(DATASET_DIR, name)
    if not os.path.exists(path):
        return None
    return load_csv_edgelist(path)


def karate_edgelist() -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Zachary's karate club (directed single-direction edges, as the
    reference's karate.csv stores them)."""
    got = _load_or_none("karate.csv")
    if got is not None:
        return got
    import networkx as nx

    G = nx.karate_club_graph()
    e = np.array(G.edges(), dtype=np.int32)
    return e[:, 0], e[:, 1], np.ones(len(e), dtype=np.float32)


def _skip_if_missing(name: str):
    got = _load_or_none(name)
    if got is None:
        import pytest

        pytest.skip(f"{name} not available")
    return got


def dolphins_edgelist():
    return _skip_if_missing("dolphins.csv")


def email_eu_core_edgelist():
    return _skip_if_missing("email-Eu-core.csv")


def netscience_edgelist():
    return _skip_if_missing("netscience.csv")
