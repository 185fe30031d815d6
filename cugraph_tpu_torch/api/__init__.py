from .graph import Graph, DiGraph, MultiGraph
from .property_graph import PropertyGraph, PropertySelection
from . import algorithms
from .nx_compat import from_networkx, to_networkx
