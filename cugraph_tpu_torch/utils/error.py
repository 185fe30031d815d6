"""Error handling: plain Python exceptions, after the reference's
CUGRAPH_EXPECTS / CUGRAPH_FAIL macros (cpp/include/cugraph/utilities/error.hpp).
"""


class GraphError(RuntimeError):
    """Framework logic error (analog of cugraph::logic_error)."""


def expects(cond: bool, msg: str) -> None:
    if not cond:
        raise GraphError(msg)
