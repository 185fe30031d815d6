"""Service client: one method per RPC, plus a generic ``call``.

Counterpart of ``cugraph_tpu/service/client.py`` (ref:
python/cugraph_service/cugraph_service_client/client.py), urllib only. It
holds no torch: a client of either package talks to a server of either.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any

from .exceptions import CugraphServiceError


class CugraphTpuClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 9090):
        self.url = f"http://{host}:{port}/"

    def call(self, method: str, *args: Any, **kwargs: Any) -> Any:
        payload = json.dumps({"method": method, "args": list(args), "kwargs": kwargs}).encode()
        req = urllib.request.Request(
            self.url, data=payload, headers={"Content-Type": "application/json"}
        )
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                body = json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            body = json.loads(exc.read())
        if "error" in body:
            raise CugraphServiceError(body["error"])
        return body["result"]

    # ---- typed wrappers (the IDL surface) --------------------------------
    def get_server_info(self):
        return self.call("get_server_info")

    def uptime(self):
        return self.call("uptime")

    def create_graph(self):
        return self.call("create_graph")

    def delete_graph(self, graph_id):
        return self.call("delete_graph", graph_id)

    def get_graph_ids(self):
        return self.call("get_graph_ids")

    def get_graph_info(self, graph_id=0):
        return self.call("get_graph_info", graph_id)

    def load_csv_as_vertex_data(self, csv_file_name, **kwargs):
        return self.call("load_csv_as_vertex_data", csv_file_name, **kwargs)

    def load_csv_as_edge_data(self, csv_file_name, **kwargs):
        return self.call("load_csv_as_edge_data", csv_file_name, **kwargs)

    def get_graph_vertex_data(self, graph_id=0, **kwargs):
        return self.call("get_graph_vertex_data", graph_id, **kwargs)

    def get_graph_edge_data(self, graph_id=0, **kwargs):
        return self.call("get_graph_edge_data", graph_id, **kwargs)

    def extract_subgraph(self, graph_id=0, **kwargs):
        return self.call("extract_subgraph", graph_id, **kwargs)

    def uniform_neighbor_sample(self, start_list, fanout_vals, **kwargs):
        return self.call("uniform_neighbor_sample", start_list, fanout_vals, **kwargs)

    def node2vec(self, start_vertices, max_depth, **kwargs):
        return self.call("node2vec", start_vertices, max_depth, **kwargs)

    def batched_ego_graphs(self, seeds, radius=1, **kwargs):
        return self.call("batched_ego_graphs", seeds, radius, **kwargs)

    def pagerank(self, graph_id=0, **kwargs):
        return self.call("pagerank", graph_id, **kwargs)

    def load_graph_creation_extensions(self, extension_dir_path):
        return self.call("load_graph_creation_extensions", extension_dir_path)

    def call_graph_creation_extension(self, func_name, *args, **kwargs):
        return self.call("call_graph_creation_extension", func_name, *args, **kwargs)
