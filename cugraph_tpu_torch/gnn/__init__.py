from .aggregators import gcn_aggregate, sage_aggregate, spmm_aggregate
from .models import GCN, GraphSAGE, SAGEConv, gcn_from_flax, graphsage_from_flax
from .graph_store import FeatureStorage, GraphStore
from .loader import LinkNeighborLoader, NeighborLoader, SampledBlock
from .pyg_store import EdgeAttr, EdgeLayout, PyGStore, TensorAttr, to_pyg
