"""Force Atlas 2 layout.

Counterpart of ``cugraph_tpu/algos/layout.py`` (ref:
cpp/src/layout/legacy/, API algorithms.hpp:197), in plain torch on the
graph's device. As in the JAX package the repulsion is exact (all pairs),
not Barnes-Hut, with the reference's knobs: gravity (and strong gravity),
scaling ratio, jitter tolerance, lin-log mode, edge-weight influence,
outbound attraction distribution and the intermediate-position callback
(ref: python/cugraph/cugraph/internals/ GraphBasedDimRedCallback).

The JAX step builds (V, V) pairwise temporaries, about 20 V^2 bytes (5.4 GB
at V = 2^14). Here the repulsion runs in blocks of rows, each block's
temporaries REPULSION_BLOCK entries of (rows, V), and each row's sum over
its V columns stays one reduction. The per-edge terms that do not move
(sources, destinations, weights, the masses) are computed once before the
loop; the loop reads nothing on the host, only a ``callback`` copies the
positions out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.csr import Graph
from ..utils.device import as_tensor
from ..utils.dtypes import WEIGHT_DTYPE

# entries of one (rows, V) temporary of the blocked repulsion: 2^24 float32
# entries, 64 MiB, so a block's four temporaries stay near 256 MiB
REPULSION_BLOCK = 1 << 24


@dataclasses.dataclass(frozen=True)
class _Fa2Graph:
    """What a step needs of the graph, computed once."""

    deg: torch.Tensor  # (V,) out-degree + 1 (the mass), float32
    src: torch.Tensor  # (E,) int64, the CSR's sources
    dst: torch.Tensor  # (E,) int64
    ew: torch.Tensor  # (E,) edge weight ** edge_weight_influence (1 unweighted)


def _fa2_graph(g: Graph, edge_weight_influence: float) -> _Fa2Graph:
    adj = g.csr()
    w = adj.weights
    if w is None:
        w = torch.ones(adj.num_edges, dtype=WEIGHT_DTYPE, device=g.device)
    if edge_weight_influence != 1.0:
        w = torch.pow(torch.clamp(w, min=1e-9), edge_weight_influence)
    return _Fa2Graph(
        deg=(g.out_degrees() + 1).to(WEIGHT_DTYPE),
        src=adj.majors.long(),
        dst=adj.minors.long(),
        ew=w,
    )


def _repulsion(pos: torch.Tensor, deg: torch.Tensor, scaling_ratio: float) -> torch.Tensor:
    """sum_j scaling_ratio deg_i deg_j / (|p_i - p_j|^2 + 1e-9) (p_i - p_j)
    over j != i, a block of rows at a time, each step of the JAX
    expression in its order; four (rows, V) temporaries a block."""
    v = pos.shape[0]
    rows = max(1, REPULSION_BLOCK // max(v, 1))
    px, py = pos[:, 0], pos[:, 1]
    out = torch.empty_like(pos)
    for r0 in range(0, v, rows):
        r1 = min(v, r0 + rows)
        dx = px[r0:r1, None] - px[None, :]
        dy = py[r0:r1, None] - py[None, :]
        dist2 = (dx * dx).addcmul_(dy, dy).add_(1e-9)
        rep = torch.outer(deg[r0:r1], deg).mul_(scaling_ratio).div_(dist2)
        # no force of a vertex on itself
        ar = torch.arange(r1 - r0, device=pos.device)
        rep[ar, ar + r0] = 0.0
        out[r0:r1, 0] = dx.mul_(rep).sum(1)
        out[r0:r1, 1] = dy.mul_(rep).sum(1)
    return out


def _fa2_step(
    fg: _Fa2Graph,
    pos: torch.Tensor,
    old_forces: torch.Tensor,
    speed: torch.Tensor,
    jitter_tolerance: float,
    gravity: float,
    scaling_ratio: float,
    lin_log_mode: bool,
    outbound_attraction_distribution: bool,
    strong_gravity_mode: bool,
):
    """One FA2 iteration, the JAX package's ``_fa2_step``. Returns
    (pos, forces, speed), speed a 0-d tensor."""
    deg = fg.deg
    f_rep = _repulsion(pos, deg, scaling_ratio)

    # gravity
    dist_c = torch.sqrt((pos * pos).sum(-1)) + 1e-9
    if strong_gravity_mode:
        f_grav = -gravity * deg[:, None] * pos
    else:
        f_grav = -gravity * deg[:, None] * pos / dist_c[:, None]

    # attraction along edges: the force on each source toward its destination
    ediff = pos[fg.dst] - pos[fg.src]
    edist = torch.sqrt((ediff * ediff).sum(-1)) + 1e-9
    attr = fg.ew * (torch.log1p(edist) if lin_log_mode else edist)
    if outbound_attraction_distribution:
        attr = attr / deg[fg.src]
    coef = attr / edist
    f_attr = torch.zeros_like(pos).index_add_(0, fg.src, coef[:, None] * ediff)

    forces = f_rep + f_grav + f_attr

    # adaptive speed (ref fa2 swing / traction heuristics)
    swing = torch.sqrt(((old_forces - forces) ** 2).sum(-1))
    traction = 0.5 * torch.sqrt(((old_forces + forces) ** 2).sum(-1))
    g_swing = (deg * swing).sum() + 1e-9
    g_traction = (deg * traction).sum()
    target = jitter_tolerance * jitter_tolerance * g_traction / g_swing
    new_speed = speed * torch.clamp(target / torch.clamp(speed, min=1e-9), 0.5, 1.5)
    factor = new_speed / (1.0 + torch.sqrt(new_speed * swing))
    return pos + forces * factor[:, None], forces, new_speed


def force_atlas2(
    g: Graph,
    max_iter: int = 500,
    pos_list=None,
    outbound_attraction_distribution: bool = True,
    lin_log_mode: bool = False,
    edge_weight_influence: float = 1.0,
    jitter_tolerance: float = 1.0,
    scaling_ratio: float = 2.0,
    strong_gravity_mode: bool = False,
    gravity: float = 1.0,
    seed: int = 0,
    callback=None,
) -> torch.Tensor:
    """2D FA2 layout: positions (V, 2) float32 on the graph's device. The
    API mirrors cugraph.force_atlas2
    (python/cugraph/cugraph/layout/force_atlas2.py). Without ``pos_list``
    the start is ``np.random.default_rng(seed).uniform(-100, 100)``, the
    JAX package's. A ``callback`` gets numpy (V, 2) float32 positions:
    ``on_preprocess_end`` once, ``on_epoch_end`` after each iteration and
    ``on_train_end`` once."""
    v = g.num_vertices
    dev = g.device
    if pos_list is not None:
        pos = as_tensor(pos_list, WEIGHT_DTYPE, dev)
    else:
        rng = np.random.default_rng(seed)
        pos = torch.from_numpy(rng.uniform(-100, 100, size=(v, 2)).astype(np.float32)).to(dev)
    fg = _fa2_graph(g, float(edge_weight_influence))
    forces = torch.zeros((v, 2), dtype=WEIGHT_DTYPE, device=dev)
    speed = torch.ones((), dtype=WEIGHT_DTYPE, device=dev)
    if callback is not None:
        callback.on_preprocess_end(pos.cpu().numpy())
    for _ in range(max_iter):
        pos, forces, speed = _fa2_step(
            fg, pos, forces, speed, float(jitter_tolerance), float(gravity),
            float(scaling_ratio), lin_log_mode, outbound_attraction_distribution,
            strong_gravity_mode,
        )
        if callback is not None:
            callback.on_epoch_end(pos.cpu().numpy())
    if callback is not None:
        callback.on_train_end(pos.cpu().numpy())
    return pos
