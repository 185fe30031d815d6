"""Community detection walkthrough: Louvain, Leiden, ECG and triangles on
netscience, or on karate where netscience is not there.

    python -m cugraph_tpu_torch.examples.community_detection [--device cpu]

Counterpart of ``examples/community_detection.py``. netscience.csv is read
from ``CUGRAPH_TPU_DATASET_DIR`` if it is there, else karate comes from
networkx; nothing is downloaded.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.testing import datasets, karate_edgelist

    got = datasets._load_or_none("netscience.csv")
    name = "netscience" if got is not None else "karate"
    src, dst, w = got if got is not None else karate_edgelist()
    g = ct.from_edgelist(src, dst, w, symmetrize=True, device=args.device)
    print(f"{name}: V={g.num_vertices} E={g.num_edges}")

    out = {"graph": name}
    labels, q = ct.louvain(g)
    out["louvain"] = q
    print(f"louvain: Q={q:.4f} communities={int(torch.unique(labels).numel())}")
    _, out["leiden"] = ct.leiden(g)
    print(f"leiden:  Q={out['leiden']:.4f}")
    _, out["ecg"] = ct.ecg(g, ensemble_size=8)
    print(f"ecg:     Q={out['ecg']:.4f}")
    out["triangles"] = int(ct.triangle_count(g).sum()) // 3
    print(f"triangles total: {out['triangles']}")
    return out


if __name__ == "__main__":
    main()
