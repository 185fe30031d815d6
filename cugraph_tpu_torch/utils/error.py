"""Error handling: plain Python exceptions, after the reference's
CUGRAPH_EXPECTS / CUGRAPH_FAIL macros (cpp/include/cugraph/utilities/error.hpp).
"""


class GraphError(RuntimeError):
    """Framework logic error (analog of cugraph::logic_error)."""


def expects(cond: bool, msg: str) -> None:
    if not cond:
        raise GraphError(msg)


def expects_vertex_ids(ids, num_vertices: int, name: str) -> None:
    """Raise GraphError unless every id of the tensor ``ids`` lies in
    [0, num_vertices): the one rule for vertex ids from a caller, checked
    before any device gather or ``index_add_`` reads them (on a card an
    id out of range there trips a device-side assert, and the process
    loses its CUDA context). One host read a call."""
    if ids.numel():
        ok = bool(((ids >= 0) & (ids < num_vertices)).all())
        expects(ok, f"{name}: vertex id out of range [0, {num_vertices})")
