from .frontier import transform_reduce_v_frontier_outgoing_e_by_dst
from .per_v import (
    per_v_transform_reduce_incoming_e,
    per_v_transform_reduce_outgoing_e,
)
from .reduce_ops import ANY, MAXIMUM, MINIMUM, PLUS, ReduceOp
