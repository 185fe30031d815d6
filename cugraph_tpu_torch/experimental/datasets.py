"""Metadata-driven datasets (ref: experimental/datasets/ +
datasets_config.yaml: dataset objects with lazy loading into Graphs).

Counterpart of ``cugraph_tpu/experimental/datasets.py``; a dataset's
graph is built once for each device it is asked for.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from .. import testing
from ..api.graph import Graph
from ..utils.device import DeviceLike, resolve_device


@dataclasses.dataclass
class Dataset:
    name: str
    loader: Callable
    directed: bool = False
    description: str = ""
    _graphs: dict = dataclasses.field(default_factory=dict, repr=False)

    def get_edgelist(self):
        return self.loader()

    def get_graph(self, download: bool = False, device: DeviceLike = None) -> Graph:
        """The dataset as an api.Graph on ``device`` (default: the card).
        ``download`` is the reference's signature; nothing is downloaded."""
        dev = resolve_device(device)
        if dev not in self._graphs:
            src, dst, w = self.loader()
            g = Graph(directed=self.directed, device=dev)
            g.from_numpy_edgelist(src, dst, w)
            self._graphs[dev] = g
        return self._graphs[dev]


karate = Dataset(
    "karate", testing.karate_edgelist, description="Zachary's karate club"
)
dolphins = Dataset("dolphins", testing.dolphins_edgelist)
email_eu_core = Dataset(
    "email-Eu-core", testing.email_eu_core_edgelist, directed=True
)
netscience = Dataset("netscience", testing.netscience_edgelist)
