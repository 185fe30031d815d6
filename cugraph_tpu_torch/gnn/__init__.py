from .aggregators import gcn_aggregate, sage_aggregate, spmm_aggregate
from .models import GCN, GraphSAGE, SAGEConv, gcn_from_flax, graphsage_from_flax
