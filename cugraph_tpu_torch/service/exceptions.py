"""Service error type.

Counterpart of ``cugraph_tpu/service/exceptions.py`` (ref:
cugraph_service_client exceptions): errors on the server are caught and
wrapped, so a client gets one typed failure.
"""


class CugraphServiceError(RuntimeError):
    pass
