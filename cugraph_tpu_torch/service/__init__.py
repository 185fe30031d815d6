"""Graph service: remote graphs and algorithm calls over JSON-RPC on HTTP.

Counterpart of ``cugraph_tpu/service/`` (imported on its own), with the
same method names and wire format, so that a client of either package
talks to a server of either.
"""

from .server import CugraphHandler, CugraphTpuServer
from .client import CugraphTpuClient
from .exceptions import CugraphServiceError
