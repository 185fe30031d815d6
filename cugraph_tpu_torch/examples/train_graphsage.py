"""End-to-end GraphSAGE training with neighbor sampling.

    python -m cugraph_tpu_torch.examples.train_graphsage --scale 14 --steps 20 [--device cpu]

Counterpart of ``examples/train_graphsage.py``, with its arguments and
its loop: an R-MAT graph at ``--scale`` (standing in for
ogbn-products), a shuffled ``NeighborLoader`` over every vertex, the
port's 2-layer mean-aggregating ``GraphSAGE`` (hidden 128), cross-entropy
over each block's seeds, backward, ``torch.optim.Adam`` (lr 1e-3).
Features are N(0, 1) from numpy's generator seeded 0, as in the JAX
script. Its labels are drawn apart from the features, so a model can
only memorize them and the loss on fresh batches stays near log(classes);
here each label is the argmax of the vertex's features under a fixed
random projection (the same generator), a task the loss shows the model
learning. The weights and draws come from torch generators seeded 0.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--fanout", type=int, nargs="+", default=[10, 10])
    ap.add_argument("--features", type=int, default=64)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import cugraph_tpu_torch as ct
    from cugraph_tpu_torch.gnn import GraphSAGE, NeighborLoader
    from cugraph_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    v = 1 << args.scale
    src, dst = ct.rmat_edgelist(args.scale, v * args.edgefactor, scramble=True,
                                generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    g = ct.from_edgelist(src, dst, num_vertices=v, device=dev)
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.normal(size=(v, args.features)).astype(np.float32)).to(dev)
    projection = rng.normal(size=(args.features, args.classes)).astype(np.float32)
    labels = torch.from_numpy(projection).to(dev)
    labels = (feats @ labels).argmax(1)

    torch.manual_seed(0)
    model = GraphSAGE(args.features, hidden_features=128, out_features=args.classes,
                      num_layers=2, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loader = NeighborLoader(g, torch.arange(v, device=dev), args.fanout,
                            batch_size=args.batch_size, shuffle=True,
                            generator=torch.Generator(device=dev).manual_seed(0))

    losses = []
    t0 = time.perf_counter()
    while len(losses) < args.steps:
        for block in loader:
            ids = block.n_ids.long()
            out = model(block.graph, feats[ids])
            # the seeds hold compact ids [0, num_seeds)
            n = block.num_seeds
            loss = torch.nn.functional.cross_entropy(out[:n], labels[ids][:n])
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.item())
            if len(losses) % 5 == 0:
                print(f"step {len(losses)}: loss {losses[-1]:.4f}")
            if len(losses) >= args.steps:
                break
    dt = time.perf_counter() - t0
    seeds_per_s = len(losses) * args.batch_size / dt
    print(f"done: {len(losses)} steps in {dt:.1f}s ({seeds_per_s:.0f} seeds/s)")
    return {"losses": losses, "seconds": dt, "steps_per_s": len(losses) / dt,
            "seeds_per_s": seeds_per_s}


if __name__ == "__main__":
    main()
