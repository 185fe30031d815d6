from .per_v import (
    per_v_transform_reduce_incoming_e,
    per_v_transform_reduce_outgoing_e,
)
from .reduce_ops import MAXIMUM, MINIMUM, PLUS, ReduceOp
