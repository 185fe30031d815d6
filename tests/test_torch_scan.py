"""cumsum_flat and segment_sums_from_cumsum of cugraph_tpu_torch against
cugraph_tpu's two-level Pallas scan in interpret mode on the CPU.

Tolerance: each entry within 1e-5 of the float64 prefix of |x| at that
entry. Both packages sum in f32 in different orders (the TPU kernel adds
log-step partials and a sequential carry; torch.cumsum on the CPU keeps
a wider accumulator), so entries agree to the prefix's rounding, not bit
for bit. Lengths cross the TPU's 196,608-element tile and include 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugraph_tpu.prims.pallas import scan as jscan
from cugraph_tpu_torch.prims.cuda import (
    cumsum_flat,
    cumsum_flat_reference,
    segment_sums_from_cumsum,
)

TOL = 1e-5


def _prefix_abs(x):
    return np.cumsum(np.abs(x.astype(np.float64)))


@pytest.mark.parametrize("n", [0, 1, 100, 65536, 3 * 65536 + 77])
def test_cumsum_flat_matches_jax(n):
    x = np.random.default_rng(n).uniform(-1, 1, n).astype(np.float32)
    want = np.asarray(jscan.cumsum_flat(jnp.asarray(x), interpret=True))
    got = cumsum_flat(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (n,)
    bound = TOL * _prefix_abs(x)
    assert (np.abs(got.numpy().astype(np.float64) - want) <= bound).all()
    exact = np.cumsum(x.astype(np.float64))
    assert (np.abs(got.numpy() - exact) <= bound).all()


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64, torch.bfloat16])
def test_cumsum_flat_casts_to_f32(dtype):
    x = torch.arange(1000).to(dtype)
    got = cumsum_flat(x)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.cumsum(x.float().numpy()))
    assert torch.equal(cumsum_flat_reference(x), got)


def test_cumsum_flat_rejects_2d():
    with pytest.raises(ValueError, match="1-D"):
        cumsum_flat(torch.zeros(4, 4))


@pytest.mark.parametrize("v,e", [(50, 4000), (300, 20000)])
def test_segment_sums_from_cumsum_matches_jax(v, e):
    rng = np.random.default_rng(v)
    seg = np.sort(rng.integers(0, v, e))
    vals = rng.uniform(-1, 1, e).astype(np.float32)
    offsets = np.zeros(v + 1, np.int32)
    np.cumsum(np.bincount(seg, minlength=v), out=offsets[1:])
    jcum = jscan.cumsum_flat(jnp.asarray(vals), interpret=True)
    want = np.asarray(jscan.segment_sums_from_cumsum(jcum, jnp.asarray(offsets), v))
    got = segment_sums_from_cumsum(cumsum_flat(torch.from_numpy(vals)), torch.from_numpy(offsets), v)
    assert got.shape == (v,)
    # a difference of two prefixes carries their rounding: relative to the
    # largest prefix of |x|, not to the segment
    scale = TOL * _prefix_abs(vals)[-1]
    assert np.abs(got.numpy().astype(np.float64) - want).max() <= 2 * scale
    exact = np.zeros(v)
    np.add.at(exact, seg, vals.astype(np.float64))
    assert np.abs(got.numpy() - exact).max() <= 2 * scale
