"""Canonical dtypes of the PyTorch port.

Vertex ids and edge offsets are int32 and weights float32, as in the JAX
package (``cugraph_tpu/utils/dtypes.py``). The JAX package pads edge arrays
to 128 lanes for XLA's static shapes; the port keeps exact lengths.
"""

import torch

VERTEX_DTYPE = torch.int32
EDGE_DTYPE = torch.int32
WEIGHT_DTYPE = torch.float32

INT32_MAX = torch.iinfo(torch.int32).max
