from .device import resolve_device
from .error import GraphError, expects
