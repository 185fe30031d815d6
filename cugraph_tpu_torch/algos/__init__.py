from .link_analysis import pagerank
from .traversal import bfs
