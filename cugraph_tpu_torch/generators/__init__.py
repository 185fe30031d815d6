from . import simple
from .rmat import (
    RmatShards,
    mg_rmat_edgelist,
    rmat_chunk_source,
    rmat_edgelist,
    scramble_vertex_ids,
)
