"""Graph serialization and broadcast-style reconstruction.

Counterpart of ``cugraph_tpu/core/serialize.py`` (ref:
cpp/include/cugraph/serialization/serializer.hpp:33-136 and
cpp/src/utilities/graph_bcast.hpp). The wire format is the JAX package's,
one compressed ``.npz`` with the same ``MAGIC``, so a blob written by
either package loads in the other. A graph is rebuilt with
``from_edgelist`` on the device the caller names (default: the card).
"""

from __future__ import annotations

import io
from typing import Union

import numpy as np

from ..utils.device import DeviceLike, resolve_device
from ..utils.error import expects
from .convert import decompress_to_edgelist
from .csr import Graph, from_edgelist

MAGIC = "cugraph_tpu_graph_v1"


def serialize_graph(g: Graph) -> bytes:
    """The graph's edge list (CSR order), copied to the host, as npz bytes."""
    src, dst, w = decompress_to_edgelist(g)
    buf = io.BytesIO()
    arrays = {
        "magic": np.frombuffer(MAGIC.encode(), dtype=np.uint8),
        "src": src.cpu().numpy(),
        "dst": dst.cpu().numpy(),
        "meta": np.array(
            [g.num_vertices, g.num_edges, int(g.is_symmetric)], dtype=np.int64
        ),
    }
    if w is not None:
        arrays["weight"] = w.cpu().numpy()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def deserialize_graph(
    data: Union[bytes, io.BytesIO], *, device: DeviceLike = None
) -> Graph:
    dev = resolve_device(device)
    buf = io.BytesIO(data) if isinstance(data, bytes) else data
    with np.load(buf) as z:
        expects(
            bytes(z["magic"]).decode() == MAGIC, "not a cugraph_tpu graph blob"
        )
        meta = z["meta"]
        w = z["weight"] if "weight" in z.files else None
        return from_edgelist(
            z["src"],
            z["dst"],
            w,
            num_vertices=int(meta[0]),
            is_symmetric=bool(meta[2]),
            device=dev,
        )


def save_graph(g: Graph, path: str) -> None:
    with open(path, "wb") as f:
        f.write(serialize_graph(g))


def load_graph(path: str, *, device: DeviceLike = None) -> Graph:
    dev = resolve_device(device)
    with open(path, "rb") as f:
        return deserialize_graph(f.read(), device=dev)


def broadcast_graph(mesh, g: Graph):
    """Graph -> this rank's MGGraph share on the mesh (the graph_bcast
    analog; every rank holds ``g``, see dist.mg_graph.distribute_graph)."""
    from ..dist.mg_graph import distribute_graph

    return distribute_graph(mesh, g)
