"""The readers of the cell across cards' own per-layer metrics,
``dist.collective_ms_per_step.<analytic>`` and ``ingest.coalesce_s``, on
the record of a traced run of ``kron27-mg.pagerank``: rank 0's ``spans:``
line and result line as one run on four H100 80GB HBM3 (700 W) logged
them, the set-up spans cut to the ingest's. The expected readings are
worked from the recorded numbers by hand."""

import pytest
from pb_helpers import BENCH

from port_bench import harness

# the ``spans:`` line, without its set-up spans
SPANS = {'counts': {'cgt/algorithms.pagerank': 17,
                    'cgt/collective.reduce_scatter': 357,
                    'cgt/step.pagerank.iteration': 340,
                    'cgt/collective.all_gather': 340,
                    'cgt/kernel.spmv_sum': 340,
                    'cgt/collective.all_reduce': 680,
                    'cgt/sync.pagerank.diff': 340},
         'host_s': {'cgt/algorithms.pagerank': 5.970170866999998,
                    'cgt/collective.reduce_scatter': 0.11858233700000609,
                    'cgt/step.pagerank.iteration': 5.935649314999994,
                    'cgt/collective.all_gather': 0.15684024899999904,
                    'cgt/kernel.spmv_sum': 0.12603199099999607,
                    'cgt/collective.all_reduce': 0.1801726469999978,
                    'cgt/sync.pagerank.diff': 5.120247142999997},
         'idle_s': {'in_steps': 0.154562665999992,
                    'in_calls': 0.013351595000007899,
                    'outside_calls': 0.044770930000000334},
         'idle_by_span': [['cgt/collective.all_gather', 0.07574951700000132],
                          ['none', 0.044770930000000334],
                          ['cgt/sync.pagerank.diff', 0.041878745999989836],
                          ['cgt/step.pagerank.iteration', 0.03502839399999963],
                          ['cgt/algorithms.pagerank', 0.013293356000005486],
                          ['cgt/kernel.spmv_sum', 0.001265769000004768],
                          ['cgt/collective.all_reduce', 0.0003595809999944014],
                          ['cgt/collective.reduce_scatter', 0.00033889799999872316]],
         'syncs_with_host_read': 340,
         'outside_syncs': {'aten::_local_scalar_dense': 0,
                           'aten::nonzero': 0,
                           'cudaStreamSynchronize': 0},
         'idle_edges_s': [0.003965412999999999, 0.0025044700000006704]}
# its set-up spans: the ingest's (the streamed ingest's coalescing and
# compression, with their counters)
SETUP_SPANS = [{'name': 'cgt/ingest.coalesce',
                'parent': None,
                'start_s': 124.898881122,
                'end_s': 124.996964116,
                'host_s': 0.09808299399999498,
                'device_s': 0.12410269165039063,
                'counters': {'dropped_pairs': 17985016}},
               {'name': 'cgt/ingest.compress',
                'parent': None,
                'start_s': 124.997161754,
                'end_s': 125.110554057,
                'host_s': 0.1133923029999977,
                'device_s': 0.11627926635742188,
                'counters': {'peak_bytes': 34698236928}}]
# the result line's device operations (the breakdown's ten) and times
DEVICE_OPS = [['void (anonymous namespace)::spmv_tiles_kernel<(anonymous '
               'namespace)::SumOp>(int const*, int const*, float const*, float ',
               4.8741396540000075],
              ['ncclDevKernel_ReduceScatter_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)',
               0.2103310929999988],
              ['ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)',
               0.19118524999999148],
              ['void at::native::vectorized_elementwise_kernel<4, '
               'at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, at::',
               0.13552860000000536],
              ['void at::native::elementwise_kernel<128, 2, '
               'at::native::gpu_kernel_impl_nocast<at::native::(anonymous namespace)::where_',
               0.1133130810000049],
              ['void at::native::vectorized_elementwise_kernel<4, '
               'at::native::AUnaryFunctor<float, float, float, at::native::binary_inte',
               0.06281784599999651],
              ['void at::native::vectorized_elementwise_kernel<4, '
               'at::native::BinaryFunctor<float, float, float, at::native::binary_inte',
               0.04346108000000246],
              ['void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, '
               'at::native::func_wrapper_t<float, at::native::sum_fun',
               0.03814941500000719],
              ['void (anonymous namespace)::spmv_fixup_kernel<(anonymous '
               'namespace)::SumOp>(int const*, int const*, int const*, float co',
               0.03682288299998108],
              ['void at::native::elementwise_kernel<128, 2, '
               'at::native::gpu_kernel_impl_nocast<at::native::BinaryFunctor<float, float, f',
               0.036019308999996676]]
BUSY_S, WINDOW_S = 5.799626296000088, 6.018016179
RECORD = dict(cell="kron27-mg.pagerank", analytic="pagerank", spans=SPANS,
              setup_spans=SETUP_SPANS,
              profile=dict(wall_s=WINDOW_S, busy_s=BUSY_S, device_ops=DEVICE_OPS))


def read(name, rec=RECORD):
    return harness.metric_reader(BENCH, name, rec["analytic"])(rec)


def test_the_readers_are_found_by_name():
    assert (harness.reader_path(BENCH, "dist.collective_ms_per_step.pagerank", "pagerank")
            == BENCH / "metrics" / "dist.collective_ms_per_step.py")
    assert (harness.reader_path(BENCH, "ingest.coalesce_s", "pagerank")
            == BENCH / "metrics" / "ingest.coalesce_s.py")


def test_collective_ms_per_step_on_the_recorded_line():
    # NCCL's reduce-scatter and all-gather among the ten (the all-reduces'
    # kernels took less than the tenth), over 17 queries of 20 iterations
    nccl_s = 0.2103310929999988 + 0.19118524999999148
    assert SPANS["counts"]["cgt/step.pagerank.iteration"] == 340
    assert read("dist.collective_ms_per_step.pagerank") == pytest.approx(1e3 * nccl_s / 340)


def test_collective_ms_per_step_reads_nothing_without_its_spans():
    untraced = dict(RECORD, spans=None, profile=None)
    assert read("dist.collective_ms_per_step.pagerank", untraced) is None
    # the CPU: no device time
    idle = dict(RECORD, profile=dict(RECORD["profile"], busy_s=0.0))
    assert read("dist.collective_ms_per_step.pagerank", idle) is None
    # a program that marks no collective (older, or a cell on one card)
    counts = {k: n for k, n in SPANS["counts"].items() if not k.startswith("cgt/collective.")}
    older = dict(RECORD, spans=dict(SPANS, counts=counts))
    assert read("dist.collective_ms_per_step.pagerank", older) is None
    # another analytic's steps are not this one's
    reader = harness.metric_reader(BENCH, "dist.collective_ms_per_step.pagerank", "pagerank")
    assert reader(dict(RECORD, analytic="bfs")) is None


def test_coalesce_s_on_the_recorded_line():
    assert read("ingest.coalesce_s") == 0.12410269165039063
    # the newest graph's, where a process built several
    again = dict(SETUP_SPANS[0], device_s=0.5)
    assert read("ingest.coalesce_s", dict(RECORD, setup_spans=SETUP_SPANS + [again])) == 0.5


def test_coalesce_s_reads_nothing_without_its_span():
    assert read("ingest.coalesce_s", dict(RECORD, setup_spans=None)) is None
    # a program whose streamed ingest keeps parallel edges: no such span
    without = [s for s in SETUP_SPANS if s["name"] != "cgt/ingest.coalesce"]
    assert read("ingest.coalesce_s", dict(RECORD, setup_spans=without)) is None
    on_cpu = [dict(s, device_s=None) for s in SETUP_SPANS]
    assert read("ingest.coalesce_s", dict(RECORD, setup_spans=on_cpu)) is None
