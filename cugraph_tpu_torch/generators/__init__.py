from .rmat import rmat_edgelist, scramble_vertex_ids
