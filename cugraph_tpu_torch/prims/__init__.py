from .frontier import transform_reduce_v_frontier_outgoing_e_by_dst, update_v_frontier
from .intersection import per_v_pair_dst_nbr_intersection, triangle_counts_per_vertex
from .keyed import (
    aggregate_outgoing_e_by_dst_key,
    per_v_transform_reduce_dst_key_aggregated_outgoing_e,
    transform_reduce_e_by_dst_key,
    transform_reduce_e_by_src_key,
)
from .random_select import per_v_random_select_outgoing_e
from .per_v import (
    per_v_transform_reduce_incoming_e,
    per_v_transform_reduce_outgoing_e,
)
from .reduce_ops import ANY, LOGICAL_OR, MAXIMUM, MINIMUM, PLUS, ReduceOp
from .transform_e import count_if_e, extract_if_e, transform_e, transform_reduce_e
from .vertex import count_if_v, reduce_v, transform_reduce_v
