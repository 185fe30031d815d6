"""Graph service: remote graphs and algorithm calls.

Counterpart of ``cugraph_tpu/service/server.py`` (ref:
python/cugraph_service, the Thrift IDL cugraph_service_thrift.py:41-199 and
its handler cugraph_handler.py:107, extension loading :161). The Thrift
layer is a JSON-RPC over the standard library's ``http.server``; the
handler keeps the JAX package's methods, one by one, and its wire format.

The handler runs every algorithm on ``device`` (default: the card, which
raises without CUDA; ``device="cpu"`` runs on the CPU), through
``cugraph_tpu_torch.api``. ``distribute_graph`` backs a graph with a 2D
mesh over the process group that is up, or over a one-rank group that it
starts on the handler's device (NCCL on a card, gloo on the CPU, on a
free localhost port; ``CugraphTpuServer.stop`` ends it). Calls on such a
graph go to ``mg_pagerank``, ``mg_bfs``, ``mg_sssp``, ``mg_wcc`` and
``mg_katz_centrality``, and its neighbor sampler to
``mg_uniform_neighbor_sample``; every rank of the group must make the
same calls.
"""

from __future__ import annotations

import importlib.util
import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import pandas as pd
import torch

from .. import __version__
from ..api.graph import Graph, _host
from ..api.property_graph import PropertyGraph
from ..utils.device import DeviceLike, resolve_device
from .exceptions import CugraphServiceError

DEFAULT_GRAPH_ID = 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class CugraphHandler:
    """The RPC methods (ref CugraphHandler, cugraph_handler.py:107), also
    usable in-process without a server."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._start_time = time.time()
        self._graphs: Dict[int, PropertyGraph] = {DEFAULT_GRAPH_ID: PropertyGraph()}
        self._next_id = 1
        self._extensions: Dict[str, Any] = {}
        # graph_id -> (mesh, MGGraph, api Graph) for mesh-backed graphs
        self._dist: Dict[int, Any] = {}
        self._own_group = False  # whether distribute_graph started the process group

    # ---- server info -----------------------------------------------------
    def get_server_info(self) -> Dict[str, Any]:
        cuda = self.device.type == "cuda"
        return {
            "num_gpus": torch.cuda.device_count() if cuda else 0,
            "num_devices": torch.cuda.device_count() if cuda else 1,
            "device_platform": "gpu" if cuda else "cpu",
            "cugraph_tpu_version": __version__,
        }

    def uptime(self) -> float:
        return time.time() - self._start_time

    # ---- graph lifecycle -------------------------------------------------
    def create_graph(self) -> int:
        gid = self._next_id
        self._next_id += 1
        self._graphs[gid] = PropertyGraph()
        return gid

    def delete_graph(self, graph_id: int) -> None:
        self._pg(graph_id)
        self._dist.pop(graph_id, None)
        if graph_id == DEFAULT_GRAPH_ID:
            self._graphs[DEFAULT_GRAPH_ID] = PropertyGraph()
        else:
            del self._graphs[graph_id]

    def get_graph_ids(self) -> List[int]:
        return sorted(self._graphs)

    def get_graph_info(self, graph_id: int = DEFAULT_GRAPH_ID) -> Dict[str, Any]:
        pg = self._pg(graph_id)
        return {
            "num_vertices": pg.get_num_vertices(),
            "num_edges": pg.get_num_edges(),
            "num_vertex_properties": 0 if pg._vertex_df is None else len(pg._vertex_df.columns) - 2,
            "num_edge_properties": 0 if pg._edge_df is None else len(pg._edge_df.columns) - 4,
        }

    # ---- data loading ----------------------------------------------------
    def load_csv_as_vertex_data(
        self,
        csv_file_name: str,
        *,
        vertex_col_name: str,
        delimiter: str = ",",
        dtypes: Optional[List[str]] = None,
        header: Optional[int] = 0,
        names: Optional[List[str]] = None,
        type_name: str = "",
        graph_id: int = DEFAULT_GRAPH_ID,
    ) -> None:
        df = pd.read_csv(csv_file_name, sep=delimiter, header=header, names=names)
        self._pg(graph_id).add_vertex_data(df, vertex_col_name, type_name=type_name)
        self._dist.pop(graph_id, None)  # the mesh backing is stale after a load

    def load_csv_as_edge_data(
        self,
        csv_file_name: str,
        *,
        vertex_col_names,
        delimiter: str = ",",
        dtypes: Optional[List[str]] = None,
        header: Optional[int] = 0,
        names: Optional[List[str]] = None,
        type_name: str = "",
        graph_id: int = DEFAULT_GRAPH_ID,
    ) -> None:
        df = pd.read_csv(csv_file_name, sep=delimiter, header=header, names=names)
        self._pg(graph_id).add_edge_data(df, tuple(vertex_col_names), type_name=type_name)
        self._dist.pop(graph_id, None)  # the mesh backing is stale after a load

    def get_graph_vertex_data(self, graph_id: int = DEFAULT_GRAPH_ID, vertex_ids=None, types=None):
        df = self._pg(graph_id).get_vertex_data(vertex_ids=vertex_ids, types=types)
        return json.loads(df.to_json(orient="split"))

    def get_graph_edge_data(self, graph_id: int = DEFAULT_GRAPH_ID, edge_ids=None, types=None):
        df = self._pg(graph_id).get_edge_data(edge_ids=edge_ids, types=types)
        return json.loads(df.to_json(orient="split"))

    # ---- graph ops -------------------------------------------------------
    def extract_subgraph(
        self,
        graph_id: int = DEFAULT_GRAPH_ID,
        *,
        edge_types=None,
        edge_weight_property: Optional[str] = None,
        selection: Optional[str] = None,
    ) -> int:
        pg = self._pg(graph_id)
        sel = pg.select_edges(selection) if selection else None
        g = pg.extract_subgraph(
            create_using=Graph(directed=True, device=self.device),
            edge_types=edge_types,
            edge_weight_property=edge_weight_property,
            selection=sel,
        )
        # the extracted graph becomes a property graph of its own
        gid = self.create_graph()
        edges = g.edges()
        cols = {"_SRC": edges["src"], "_DST": edges["dst"]}
        if "weight" in edges:
            cols["weight"] = edges["weight"]
        self._graphs[gid].add_edge_data(pd.DataFrame(cols), ("_SRC", "_DST"))
        return gid

    def uniform_neighbor_sample(
        self,
        start_list,
        fanout_vals,
        with_replacement: bool = False,
        graph_id: int = DEFAULT_GRAPH_ID,
    ) -> Dict[str, List]:
        if graph_id in self._dist:
            # mesh-backed: the distributed sampler (ref cugraph_handler.py:246
            # is_multi_gpu sampling path), its ids mapped back to external
            from ..dist.mg_sampling import mg_uniform_neighbor_sample

            mesh, mgg, g = self._dist[graph_id]
            res = mg_uniform_neighbor_sample(mesh, mgg, g.to_internal(np.asarray(start_list)),
                                             fanout_vals, with_replacement=with_replacement)
            return {
                "sources": np.asarray(g.to_external(res["sources"])).tolist(),
                "destinations": np.asarray(g.to_external(res["destinations"])).tolist(),
                "indices": None if res["weights"] is None else _host(res["weights"]).tolist(),
            }
        g = self._algo_graph(graph_id)
        from ..api import algorithms as capi

        df = capi.uniform_neighbor_sample(
            g, start_list, fanout_vals, with_replacement=with_replacement)
        return {
            "sources": df["sources"].tolist(),
            "destinations": df["destinations"].tolist(),
            "indices": df["indices"].tolist() if "indices" in df else None,
        }

    def node2vec(
        self,
        start_vertices,
        max_depth: int,
        p: float = 1.0,
        q: float = 1.0,
        graph_id: int = DEFAULT_GRAPH_ID,
    ) -> Dict[str, List]:
        g = self._algo_graph(graph_id)
        from ..api import algorithms as capi

        walks, weights = capi.node2vec(g, start_vertices, max_depth, p=p, q=q)
        return {
            "vertex_paths": np.asarray(walks).ravel().tolist(),
            "edge_weights": np.asarray(weights).ravel().tolist(),
            "path_sizes": [int(max_depth) + 1] * len(np.atleast_1d(start_vertices)),
        }

    def batched_ego_graphs(
        self, seeds, radius: int = 1, graph_id: int = DEFAULT_GRAPH_ID
    ) -> Dict[str, List]:
        g = self._algo_graph(graph_id)
        from ..api import algorithms as capi

        srcs, dsts, offsets = [], [], [0]
        for s in np.atleast_1d(seeds):
            e = capi.ego_graph(g, int(s), radius=radius).edges()
            srcs.extend(e["src"].tolist())
            dsts.extend(e["dst"].tolist())
            offsets.append(len(srcs))
        return {"srcs": srcs, "dsts": dsts, "seed_offsets": offsets}

    def distribute_graph(
        self,
        graph_id: int = DEFAULT_GRAPH_ID,
        mesh_shape: Optional[List[int]] = None,
    ) -> Dict[str, Any]:
        """Back graph_id with a 2D mesh: later algorithm calls on it run the
        distributed implementations (ref cugraph_handler.py is_multi_gpu
        paths). The mesh covers the process group that is up (default
        shape ``mesh_shape_for(world size)``; a shape that does not cover
        it raises), or a one-rank group started here."""
        import torch.distributed as dist

        from ..dist import initialize_distributed, make_mesh, mesh_shape_for
        from ..dist.mg_graph import distribute_graph as _distribute

        g = self._algo_graph(graph_id)
        if not dist.is_initialized():
            initialize_distributed(device=self.device, world_size=1, rank=0,
                                   init_method=f"tcp://127.0.0.1:{_free_port()}")
            self._own_group = True
        shape = (tuple(mesh_shape) if mesh_shape is not None
                 else mesh_shape_for(dist.get_world_size()))
        mesh = make_mesh(shape, device=self.device)
        self._dist[graph_id] = (mesh, _distribute(mesh, g.core), g)
        return {"mesh_shape": list(shape), "num_devices": int(np.prod(shape))}

    def _mg_vertex_values(self, graph_id: int, local) -> np.ndarray:
        from ..dist.mg_graph import unshard_vertex_values

        return _host(unshard_vertex_values(self._dist[graph_id][1], local))

    def _mg_start(self, graph_id: int, start) -> int:
        return int(self._dist[graph_id][2].to_internal(np.asarray([start]))[0])

    def _mg_path_result(self, graph_id: int, dist_l, pred_l) -> Dict[str, List]:
        ext = np.asarray(self._dist[graph_id][2].vertex_ids_external())
        pred_i = self._mg_vertex_values(graph_id, pred_l)
        return {
            "vertex": ext.tolist(),
            "distance": self._mg_vertex_values(graph_id, dist_l).tolist(),
            "predecessor": np.where(pred_i >= 0, ext[np.maximum(pred_i, 0)], -1).tolist(),
        }

    def pagerank(self, graph_id: int = DEFAULT_GRAPH_ID, **kwargs) -> Dict[str, List]:
        if graph_id in self._dist:
            from ..dist.mg_algos import mg_pagerank

            mesh, mgg, g = self._dist[graph_id]
            kwargs.setdefault("tol", 1.0e-5)
            if "max_iter" in kwargs:
                kwargs["max_iterations"] = kwargs.pop("max_iter")
            scores, _ = mg_pagerank(mesh, mgg, **kwargs)
            return {"vertex": np.asarray(g.vertex_ids_external()).tolist(),
                    "pagerank": self._mg_vertex_values(graph_id, scores).tolist()}
        from ..api import algorithms as capi

        df = capi.pagerank(self._algo_graph(graph_id), **kwargs)
        return {"vertex": df["vertex"].tolist(), "pagerank": df["pagerank"].tolist()}

    def bfs(self, start, graph_id: int = DEFAULT_GRAPH_ID, **kwargs) -> Dict[str, List]:
        if graph_id in self._dist:
            from ..dist.mg_algos import mg_bfs

            mesh, mgg, _ = self._dist[graph_id]
            dist_l, pred_l = mg_bfs(mesh, mgg, self._mg_start(graph_id, start), **kwargs)
            return self._mg_path_result(graph_id, dist_l, pred_l)
        from ..api import algorithms as capi

        df = capi.bfs(self._algo_graph(graph_id), start, **kwargs)
        return {"vertex": df["vertex"].tolist(), "distance": df["distance"].tolist(),
                "predecessor": df["predecessor"].tolist()}

    def sssp(self, start, graph_id: int = DEFAULT_GRAPH_ID, **kwargs) -> Dict[str, List]:
        if graph_id in self._dist:
            from ..dist.mg_algos import mg_sssp

            mesh, mgg, _ = self._dist[graph_id]
            dist_l, pred_l = mg_sssp(mesh, mgg, self._mg_start(graph_id, start), **kwargs)
            return self._mg_path_result(graph_id, dist_l, pred_l)
        from ..api import algorithms as capi

        df = capi.sssp(self._algo_graph(graph_id), start, **kwargs)
        return {"vertex": df["vertex"].tolist(), "distance": df["distance"].tolist(),
                "predecessor": df["predecessor"].tolist()}

    def wcc(self, graph_id: int = DEFAULT_GRAPH_ID, **kwargs) -> Dict[str, List]:
        if graph_id in self._dist:
            from ..dist.mg_algos import mg_wcc

            mesh, mgg, g = self._dist[graph_id]
            labels = mg_wcc(mesh, mgg, **kwargs)
            return {"vertex": np.asarray(g.vertex_ids_external()).tolist(),
                    "labels": self._mg_vertex_values(graph_id, labels).tolist()}
        from ..api import algorithms as capi

        df = capi.weakly_connected_components(self._algo_graph(graph_id), **kwargs)
        return {"vertex": df["vertex"].tolist(), "labels": df["labels"].tolist()}

    def katz_centrality(self, graph_id: int = DEFAULT_GRAPH_ID, **kwargs) -> Dict[str, List]:
        if graph_id in self._dist:
            from ..dist.mg_algos import mg_katz_centrality

            mesh, mgg, g = self._dist[graph_id]
            scores = mg_katz_centrality(mesh, mgg, **kwargs)
            return {"vertex": np.asarray(g.vertex_ids_external()).tolist(),
                    "katz_centrality": self._mg_vertex_values(graph_id, scores).tolist()}
        from ..api import algorithms as capi

        df = capi.katz_centrality(self._algo_graph(graph_id), **kwargs)
        return {"vertex": df["vertex"].tolist(),
                "katz_centrality": df["katz_centrality"].tolist()}

    # ---- extensions (ref cugraph_handler.py:161) -------------------------
    def load_graph_creation_extensions(self, extension_dir_path: str) -> int:
        count = 0
        for fname in sorted(os.listdir(extension_dir_path)):
            if not fname.endswith(".py"):
                continue
            spec = importlib.util.spec_from_file_location(
                fname[:-3], os.path.join(extension_dir_path, fname))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            for name in dir(mod):
                if name.startswith("create_") or name.endswith("_extension"):
                    self._extensions[name] = getattr(mod, name)
                    count += 1
        return count

    def unload_graph_creation_extensions(self) -> None:
        self._extensions.clear()

    def call_graph_creation_extension(self, func_name: str, *args, **kwargs) -> int:
        if func_name not in self._extensions:
            raise CugraphServiceError(f"unknown extension {func_name!r}")
        result = self._extensions[func_name](*args, **kwargs)
        gid = self.create_graph()
        if isinstance(result, pd.DataFrame):
            cols = list(result.columns)
            self._graphs[gid].add_edge_data(result, (cols[0], cols[1]))
        elif isinstance(result, PropertyGraph):
            self._graphs[gid] = result
        else:
            raise CugraphServiceError(f"extension returned unsupported type {type(result)!r}")
        return gid

    # ---- internals -------------------------------------------------------
    def _pg(self, graph_id: int) -> PropertyGraph:
        if graph_id not in self._graphs:
            raise CugraphServiceError(f"invalid graph id {graph_id}")
        return self._graphs[graph_id]

    def _algo_graph(self, graph_id: int) -> Graph:
        pg = self._pg(graph_id)
        if pg.get_num_edges() == 0:
            raise CugraphServiceError(f"graph {graph_id} has no edges")
        return pg.extract_subgraph(create_using=Graph(directed=True, device=self.device))

    def _release_group(self) -> None:
        """End the process group that ``distribute_graph`` started, if any."""
        if self._own_group:
            import torch.distributed as dist

            self._dist.clear()
            dist.destroy_process_group()
            self._own_group = False


class CugraphTpuServer:
    """JSON-RPC over HTTP around a CugraphHandler on ``device``.

    POST / with {"method": name, "args": [...], "kwargs": {...}} ->
    {"result": ...} or, with status 400, {"error": "..."}."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9090, device: DeviceLike = None):
        self.handler = CugraphHandler(device=device)
        handler = self.handler

        class _Req(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    method = payload["method"]
                    if method.startswith("_"):
                        raise CugraphServiceError("forbidden method")
                    fn = getattr(handler, method, None)
                    if fn is None:
                        raise CugraphServiceError(f"unknown method {method!r}")
                    result = fn(*payload.get("args", []), **payload.get("kwargs", {}))
                    body = json.dumps({"result": result}).encode()
                    self.send_response(200)
                except Exception as exc:  # noqa: BLE001 -- every error goes back to the client
                    body = json.dumps({"error": f"{type(exc).__name__}: {exc}"}).encode()
                    self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._httpd = ThreadingHTTPServer((host, port), _Req)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop serving, close the socket and end a process group that the
        handler started."""
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        self.handler._release_group()

    def serve_forever(self) -> None:
        self._httpd.serve_forever()
