"""cumsum_flat: the single-pass prefix-sum kernel (csrc/scan.cu, decoupled
look-back) and its plain version, and segment_sums_from_cumsum.

Counterpart of ``cugraph_tpu/prims/pallas/scan.py`` (``cumsum_flat`` 59,
``segment_sums_from_cumsum`` 89). No algorithm path of the JAX package
calls either; they are entry points of their own. A CUDA tensor launches
the kernel (and counts the launch in ``cumsum_flat.launches``); a CPU
tensor takes the plain version. There is no fallback from one to the
other. Either way the call is a ``cgt/kernel.cumsum_flat`` span
(``utils/timer.py``).
"""

from __future__ import annotations

import torch

from ...utils.timer import spanned
from . import build
from ._launch import on_device, raise_on_error, stream_of

THREADS = 128  # threads a block (csrc/scan.cu kThreads)
ITEMS_PER_THREAD = 32  # eight float4 chunks a thread (csrc/scan.cu kChunks)
TILE = THREADS * ITEMS_PER_THREAD  # elements a tile (csrc/scan.cu kTile)


def _flat_f32(x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 1:
        raise ValueError(f"cumsum_flat: x must be 1-D, got shape {tuple(x.shape)}")
    return x.to(torch.float32).contiguous()


def cumsum_flat_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of cumsum_flat, on any device."""
    return torch.cumsum(_flat_f32(x), 0)


@spanned("cgt/kernel.cumsum_flat")
def cumsum_flat(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a flat array cast to f32, any length (0
    included). One pass: f32 sums in a fixed tree within 4096-element
    tiles, carries from tile to tile in f64, each entry rounded once from
    them; element i is within ~16 x 2^-24 of the prefix of |x| up to i."""
    x = _flat_f32(x)
    if x.device.type == "cpu":
        return cumsum_flat_reference(x)
    if x.device.type != "cuda":
        raise RuntimeError(f"cumsum_flat: x must be a CUDA or CPU tensor, got {x.device}")
    n = x.numel()
    if n == 0:
        return torch.empty_like(x)
    # one allocation: the status words (a 16-byte ticket, then 16 bytes a
    # tile; the kernel's call clears them), then y, 16-byte aligned
    words = 4 * (-(-n // TILE) + 1)
    buf = torch.empty(words + n, dtype=torch.float32, device=x.device)
    y = buf[words:]
    with on_device(x.device):
        rc = build.load("scan").cgt_cumsum_flat(
            x.data_ptr(), y.data_ptr(), buf.data_ptr(), n, stream_of(x.device)
        )
    raise_on_error("cumsum_flat", rc)
    cumsum_flat.launches += 1
    return y


cumsum_flat.launches = 0


def segment_sums_from_cumsum(
    cum: torch.Tensor, offsets: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Per-segment sums of contiguous sorted segments, as differences of the
    inclusive cumsum at ``offsets`` (with a leading 0). Plain torch, as in
    the JAX package. A difference of two f32 prefixes carries the prefixes'
    rounding: its absolute error scales with the largest prefix, not with
    the segment."""
    z = torch.cat([cum.new_zeros(1), cum])
    offsets = offsets.to(torch.int64)
    return z[offsets[1 : num_segments + 1]] - z[offsets[:num_segments]]
