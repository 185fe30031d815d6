"""The probe kernels' plain versions (cugraph_tpu_torch/prims/cuda/probes.py)
and their entry point (cugraph_tpu_torch/microbench.py) against the TPU
probes of benchmarks/, run in interpret mode on the CPU on the same
numpy-made inputs.

benchmarks/ has no __init__.py: each probe file is loaded by path.
microbench_tpu.py's k1, k6 and k8 and microbench3_tpu.py's bodies take
``interpret``; the row-gather probes (microbench4/5/6) do not, so
``jax.experimental.pallas.pallas_call`` is patched to interpret mode (they
import ``pl`` inside each function) and their sizes are cut to N_TILES =
16 tiles of 128 edges into a TR = 256-row table.

Tolerances: bit-equal for the copy (a = 2.0 and 1.000001), the gathers
(f32 and bf16) and microbench5's 3-step chain (its fold is one fused
multiply-add, as XLA compiles it). The window sum, the window reduce and
the segmented scan add the same terms in another order (the MXU's one-hot
dot, lane sums and a log-step scan against ``index_add_`` and a walk down
the rows): each output within 1e-5 of the sum of its terms' magnitudes.

The CUDA kernels (csrc/probes.cu) run only on a card: chip_smoke.py's
probes path holds each against these plain versions there.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cugraph_tpu_torch import microbench
from cugraph_tpu_torch.prims.cuda import (
    gather_rows,
    gather_rows_reference,
    gather_window_sum,
    gather_window_sum_reference,
    multiwin_reduce,
    multiwin_reduce_reference,
    seg_scan_rows,
    seg_scan_rows_reference,
    stream_scale,
    stream_scale_reference,
)
from cugraph_tpu_torch.utils.error import GraphError

ROOT = Path(__file__).resolve().parents[1]
TOL_SUM = 1e-5  # of the sum of the terms' magnitudes: the summation order differs
TILES, TR = 16, 256  # the row-gather probes' sizes, cut


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mb():
    return _load("microbench_tpu")


@pytest.fixture(scope="module")
def mb3():
    return _load("microbench3_tpu")


@pytest.fixture
def gather_probe(monkeypatch):
    """A row-gather probe module, loaded fresh, cut to TILES x 128 edges
    into a TR-row table, its pallas_call in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))

    def load(name):
        mod = _load(name)
        monkeypatch.setattr(mod, "N_TILES", TILES)
        monkeypatch.setattr(mod, "TR", TR)
        return mod

    return load


def _gather_inputs(seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((TR, 128)).astype(np.float32)
    srcs = rng.integers(0, TR, (TILES, 128)).astype(np.int32)
    return table, srcs


def _within_sum_tol(got, want, abs_sum):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= TOL_SUM * np.asarray(abs_sum, np.float64)).all()


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int16)


# ------------------------------------------------------------ stream_scale


@pytest.mark.parametrize("probe, a", [("k1_copy", 2.0), ("b0_copy", 1.000001)])
def test_stream_scale_matches_copy_probes(mb, mb3, probe, a):
    x = np.random.default_rng(1).random((2048, 128)).astype(np.float32) * 3 - 1
    if probe == "k1_copy":
        run, _ = mb.k1_copy(2048, True)
        want = np.asarray(run(jnp.asarray(x)))
    else:
        b0 = next(b for b in mb3.build_benches(2048, True) if b.name == "b0_copy")
        want = np.asarray(b0.step(jnp.asarray(x), ()))
    got = stream_scale(torch.from_numpy(x), a)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_stream_scale_specials_and_shapes():
    x = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1e-40, 3.4e38])
    for a in (2.0, 1.000001, -0.5):
        got = stream_scale(x, a)
        want = (x.double() * np.float32(a)).float()  # one rounding of the f32 operands' product
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(_bits(got[~nan]), _bits(want[~nan]))
    assert stream_scale(torch.zeros(3, 5, 7), 2.0).shape == (3, 5, 7)
    assert torch.equal(stream_scale_reference(torch.ones(0), 2.0), torch.ones(0))
    with pytest.raises(ValueError, match="float32"):
        stream_scale(torch.ones(4, dtype=torch.float64), 2.0)


# ------------------------------------------------------------- gather_rows


@pytest.mark.parametrize("probe, dtype", [("microbench4_rowgather", torch.float32),
                                          ("microbench5_rowgather", torch.float32),
                                          ("microbench6_bf16row", torch.bfloat16)])
def test_gather_rows_matches_row_gather_probes(gather_probe, probe, dtype):
    mod = gather_probe(probe)
    table, srcs = _gather_inputs(4)
    tb = torch.from_numpy(table).to(dtype)
    if probe == "microbench6_bf16row":
        want = mod.gather_call(jnp.asarray(table).astype(jnp.bfloat16), jnp.asarray(srcs),
                               jnp.bfloat16)
    else:
        want = mod.gather_only_call(jnp.asarray(table), jnp.asarray(srcs))
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(dtype)
    got = gather_rows(tb, torch.from_numpy(srcs))
    assert got.dtype == dtype and got.shape == (TILES * 128, 128)
    assert torch.equal(_bits(got), _bits(want))


def test_gather_chain_matches_microbench5(gather_probe):
    mod = gather_probe("microbench5_rowgather")
    table, srcs = _gather_inputs(5)
    js = jnp.asarray(srcs)

    @jax.jit
    def chain3(tb):  # microbench5's chain body, returning the table
        return jax.lax.fori_loop(0, 3, lambda _, t: t + mod.gather_only_call(t, js)[:TR] * 1e-3,
                                 tb)

    want = np.asarray(chain3(jnp.asarray(table)))
    got = microbench.gather_chain(torch.from_numpy(table), torch.from_numpy(srcs), 3)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    total = float(mod.chain(3, jnp.asarray(table), js))  # the probe's own checksum
    assert abs(total - got.double().sum().item()) <= TOL_SUM * got.double().abs().sum().item()


@pytest.mark.parametrize("width, dtype, n_ids", [(1, torch.float32, 1), (3, torch.bfloat16, 9),
                                                 (200, torch.float32, 13), (128, torch.bfloat16, 0)])
def test_gather_rows_shapes_and_ids(width, dtype, n_ids):
    rng = np.random.default_rng(width)
    table = torch.from_numpy(rng.standard_normal((37, width)).astype(np.float32)).to(dtype)
    ids = torch.from_numpy(rng.integers(0, 37, n_ids))  # int64 ids
    got = gather_rows(table, ids)
    assert got.shape == (n_ids, width) and got.dtype == dtype
    assert torch.equal(_bits(got), _bits(table[ids]))
    assert torch.equal(gather_rows_reference(table, ids.int()), got)


@pytest.mark.parametrize("bad", [-1, 37])
def test_gather_rows_raises_on_an_id_out_of_range(bad):
    with pytest.raises(GraphError, match="ids out of range"):
        gather_rows(torch.zeros(37, 4), torch.tensor([0, bad, 3]))


# ------------------------------------------------------- gather_window_sum


def test_gather_window_sum_matches_gather_matmul(gather_probe):
    mod = gather_probe("microbench4_rowgather")
    table, srcs = _gather_inputs(6)
    dstl = np.random.default_rng(7).integers(0, 512, (TILES, 128)).astype(np.int32)
    dstl[:4] = 17  # a window whose 512 edges all land on one row
    winof = (np.arange(TILES) // 4).astype(np.int32)
    want = np.asarray(mod.gather_matmul_call(jnp.asarray(table), jnp.asarray(srcs),
                                             jnp.asarray(dstl), jnp.asarray(winof)))
    t, s, d = torch.from_numpy(table), torch.from_numpy(srcs), torch.from_numpy(dstl)
    got = gather_window_sum(t, s, d)
    assert got.shape == (TILES // 4 * 512, 128)
    _within_sum_tol(got.numpy(), want, gather_window_sum_reference(t.abs(), s, d).numpy())
    # the plain version: bf16-rounded rows summed in float64
    rows = t.to(torch.bfloat16).double()[s.reshape(-1).long()]
    keys = (torch.arange(TILES) // 4 * 512).repeat_interleave(128) + d.reshape(-1).long()
    exact = torch.zeros(got.shape, dtype=torch.float64).index_add_(0, keys, rows)
    _within_sum_tol(got.numpy(), exact.numpy(), gather_window_sum_reference(t.abs(), s, d).numpy())
    landed = torch.zeros(got.shape[0], dtype=torch.bool)
    landed[keys] = True
    assert not got[~landed].any()  # every row is written, zeros where no edge lands


def test_gather_window_sum_checks():
    t = torch.zeros(10, 32)
    s, d = torch.zeros(4, 3, dtype=torch.int32), torch.zeros(4, 3, dtype=torch.int32)
    assert gather_window_sum(t, s, d).shape == (512, 32)
    for bad_s, bad_d, arg in ((10, 0, "srcs"), (0, 512, "dstl"), (-1, 0, "srcs"), (0, -1, "dstl")):
        s2, d2 = s.clone(), d.clone()
        s2[2, 1], d2[3, 2] = bad_s, bad_d
        with pytest.raises(GraphError, match=f"{arg} out of range"):
            gather_window_sum(t, s2, d2)
    with pytest.raises(ValueError, match="multiple of 4"):
        gather_window_sum(t, s[:3], d[:3])
    with pytest.raises(ValueError, match="multiple of 32"):
        gather_window_sum(torch.zeros(10, 48), s, d)


# --------------------------------------------------------- multiwin_reduce


def _multiwin_inputs(rows, out_rows, seed):
    rng = np.random.default_rng(seed)
    vals = rng.random((rows, 128)).astype(np.float32)
    gdl = rng.integers(0, 256, (rows, 128)).astype(np.int32)
    wstart = (rng.integers(0, (out_rows - 2) // 2, rows // 8) * 256).astype(np.int32)
    return wstart, vals, gdl


def test_multiwin_reduce_matches_k6(mb):
    wstart, vals, gdl = _multiwin_inputs(1024, 66, 8)
    wstart[:16] = 0  # sixteen windows on one start
    run, _ = mb.k6_multiwin_reduce(1024, 66, True)
    want = np.asarray(run(jnp.asarray(wstart), jnp.asarray(vals), jnp.asarray(gdl)))
    args = (torch.from_numpy(wstart), torch.from_numpy(vals), torch.from_numpy(gdl))
    got = multiwin_reduce(*args, 66)
    assert got.shape == (66, 128)
    _within_sum_tol(got.numpy(), want, got.numpy())  # vals >= 0: the sum of |terms|
    assert torch.equal(multiwin_reduce_reference(*args, 66), got)
    assert not got[-2:].any()  # no window reaches k6's last two rows


def test_multiwin_reduce_checks():
    wstart, vals, gdl = (torch.from_numpy(a) for a in _multiwin_inputs(16, 6, 9))
    assert multiwin_reduce(wstart.long(), vals, gdl.long(), 6).shape == (6, 128)
    for bad_w, bad_g, arg in ((6 * 128 - 255, 0, "wstart"), (-1, 0, "wstart"),
                              (0, 256, "gdl"), (0, -1, "gdl")):
        w2, g2 = wstart.clone(), gdl.clone()
        w2[1], g2[3, 5] = bad_w, bad_g
        with pytest.raises(GraphError, match=f"{arg} out of range"):
            multiwin_reduce(w2, vals, g2, 6)
    with pytest.raises(ValueError, match="one start a window"):
        multiwin_reduce(wstart[:1], vals, gdl, 6)


# ----------------------------------------------------------- seg_scan_rows


def _seg_model(v, flags):
    """A serial numpy model in float64: per lane, the rows of each 512-row
    tile in order."""
    out = np.zeros(v.shape)
    for r in range(v.shape[0]):
        restart = (r % 512 == 0) | (flags[r] != 0)
        out[r] = np.where(restart, v[r], out[r - 1] + v[r])
    return out


def _seg_abs(v, flags):
    return _seg_model(np.abs(v.astype(np.float64)), flags)


@pytest.mark.parametrize("probe", ["k8", "b7"])
def test_seg_scan_rows_matches_seg_scan_probes(mb, mb3, probe):
    rng = np.random.default_rng(10)
    v = rng.random((1024, 128)).astype(np.float32)
    flags = (rng.random((1024, 128)) < 0.1).astype(np.float32)
    flags[:, 5] = 0  # a lane with no flag: one segment a tile
    if probe == "k8":
        run, _ = mb.k8_seg_scan_reduce(1024, True)
        want = np.asarray(run(jnp.asarray(v), jnp.asarray(flags)))
    else:
        b7 = next(b for b in mb3.build_benches(1024, True) if b.name == "b7_seg_scan")
        want = np.asarray(b7.step(jnp.asarray(v), (jnp.asarray(flags),)))
    got = seg_scan_rows(torch.from_numpy(v), torch.from_numpy(flags)).numpy()
    _within_sum_tol(got, want, _seg_abs(v, flags))
    _within_sum_tol(got, _seg_model(v.astype(np.float64), flags), _seg_abs(v, flags))


@pytest.mark.parametrize("rows, width", [(1, 1), (511, 3), (513, 7), (1537, 5)])
def test_seg_scan_rows_short_last_tile(rows, width):
    rng = np.random.default_rng(rows)
    v = rng.standard_normal((rows, width)).astype(np.float32)
    flags = np.where(rng.random((rows, width)) < 0.05, np.nan,
                     (rng.random((rows, width)) < 0.1)).astype(np.float32)  # NaN starts one too
    got = seg_scan_rows(torch.from_numpy(v), torch.from_numpy(flags))
    _within_sum_tol(got.numpy(), _seg_model(v.astype(np.float64), flags), _seg_abs(v, flags))
    # the plain version adds in the kernel's order: each row is one f32 add
    prev = np.where(np.arange(rows)[:, None] % 512 == 0, 0, np.roll(got.numpy(), 1, 0))
    step = np.where((np.arange(rows)[:, None] % 512 == 0) | (flags != 0), v,
                    (prev + v).astype(np.float32))
    np.testing.assert_array_equal(got.numpy(), step)
    assert torch.equal(seg_scan_rows_reference(torch.from_numpy(v), torch.from_numpy(flags)), got)


# ------------------------------------------------------------ entry point


def test_microbench_runs_every_probe_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(microbench, "N_TILES", 16)
    monkeypatch.setattr(microbench, "REPS", 1)
    assert microbench.main(["--device", "cpu", "--rows", "1024", "--table-rows", "256"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device=cpu")
    assert [ln.split()[0] for ln in lines[1:]] == list(microbench.PROBES)
    assert all("Gelem/s" in ln and "chk=" in ln for ln in lines[1:])


def test_microbench_checksums_are_the_plain_versions(monkeypatch):
    monkeypatch.setattr(microbench, "N_TILES", 8)
    monkeypatch.setattr(microbench, "REPS", 1)
    res = {r["name"]: r for r in microbench.run(rows=512, table_rows=64, device="cpu")}
    inp = microbench.probe_inputs(["x", "table", "srcs", "dstl", "wstart", "vals", "gdl", "v",
                                   "flags"], rows=512, table_rows=64, device="cpu")
    table, srcs = inp["table"], inp["srcs"]
    want = {
        "k1_copy": stream_scale_reference(inp["x"], 2.0),
        "gather_bf16": gather_rows_reference(table.to(torch.bfloat16), srcs),
        "gather_f32_chain": microbench.gather_chain(table, srcs, 3),
        "gather_window_sum": gather_window_sum_reference(table, srcs, inp["dstl"]),
        "k6_multiwin_reduce": multiwin_reduce_reference(inp["wstart"], inp["vals"], inp["gdl"],
                                                        microbench.MWR_OUT_ROWS),
        "k8_seg_scan_reduce": seg_scan_rows_reference(inp["v"], inp["flags"]),
    }
    for name, out in want.items():
        assert res[name]["chk"] == float(out.double().sum()), name
    assert res["gather_f32"]["elements"] == 8 * 128 and res["k1_copy"]["elements"] == 512 * 128
    # every probe is timed; a chain by its slope alone
    for name, r in res.items():
        timed = [r[k] is not None for k in ("ms", "back_to_back_ms")]
        assert timed == [not name.endswith("chain")] * 2 and r["kernel_b2b_ms"] is not None, name
    # the inputs are the probes' draws: windows of 8 rows at multiples of CAP_V
    assert (inp["wstart"] % 256 == 0).all() and inp["wstart"].numel() == 512 // 8
    assert set(inp["flags"].unique().tolist()) <= {0.0, 1.0}


def test_microbench_rejects_unknown_probes():
    with pytest.raises(ValueError, match="unknown probes"):
        microbench.run(names=("k9",), device="cpu")
