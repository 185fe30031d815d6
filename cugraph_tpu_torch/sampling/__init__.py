from .random_walks import node2vec, random_walks
from .uniform_neighbor_sample import uniform_neighbor_sample
