"""The metric arithmetic: the window rate, the 95th percentile over every
batch, the idle share and the kernel sums of a synthetic trace with
overlapping operations, and the rooflines' byte counts."""

import math

import pytest

from portbench import roofline, trace
from portbench.harness import Run, metric_reader


def _trace():
    # window [0, 1000) ns; kernels overlap at [100, 300) and [250, 400);
    # a copy at [600, 700); one kernel straddles the window's end
    dev = [
        ("void at::native::vectorized_elementwise_kernel<4>", "kernel", 100, 300),
        ("mono2_probe_kernel(Args)", "kernel", 250, 400),
        ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 600, 700),
        ("void other_kernel<true>(Args)", "kernel", 900, 1100),
    ]
    host = [("window", 0, 1000), ("batch", 0, 1000), ("pack", 0, 90), ("pass", 420, 580)]
    return trace.Trace(dev, host, (0, 1000), 2)


def test_idle_share_takes_the_union_of_overlapping_operations():
    tr = _trace()
    assert trace.merged([(s, t) for _, _, s, t in tr.device], 0, 1000) == [[100, 400], [600, 700],
                                                                           [900, 1000]]
    assert trace.busy_s(tr) == pytest.approx(500e-9)
    assert trace.window_s(tr) == pytest.approx(1000e-9)
    assert trace.idle_pct(tr) == pytest.approx(50.0)


def test_idle_share_is_busy_time_a_traced_batch_over_an_untraced_batch():
    tr = _trace()  # 500 ns busy over 2 traced batches
    run = Run(trace=tr, window_s=4000e-9, batches=4)  # 1000 ns a batch untraced
    assert metric_reader("device_idle_pct.queries")(run) == pytest.approx(75.0)
    assert metric_reader("device_idle_pct.reads")(run) == pytest.approx(75.0)
    assert metric_reader("device_idle_pct.reads")(Run(trace=tr)) is None


def test_idle_gaps_are_named_by_the_open_host_span():
    gaps = dict(trace.idle_by_host(_trace()))
    # gaps [0,100) -> pack, [400,600) -> pass, [700,900) -> between
    assert gaps == pytest.approx({"pack": 100e-9, "pass": 200e-9, "between": 200e-9})


def test_kernel_sums_leave_out_the_probe_kernels_and_the_window_edges():
    tr = _trace()
    assert trace.kernel_ns(tr, exclude="_probe_kernel") == (200, 1)
    assert trace.kernel_ns(tr, part="mono2_probe_kernel") == (150, 1)
    assert trace.kernel_ns(tr, part="other_kernel") == (0, 0)
    assert metric_reader("torch_ops_ms.queries")(Run(trace=tr)) == pytest.approx(200e-6 / 2)
    names = [n for n, _ in trace.top_ops(tr)]
    assert names[0].startswith("void at::native") and len(names) == 4


def test_window_rate_and_p95_over_every_batch():
    run = Run(window_s=2.0, work=3_000_000, latencies_ms=[float(i) for i in range(1, 101)])
    assert metric_reader("kmer_queries_per_s")(run) == 1_500_000
    assert metric_reader("reads_per_s")(run) == 1_500_000
    assert metric_reader("batch_p95_ms")(run) == 95.0
    assert metric_reader("batch_p95_ms")(Run(latencies_ms=[7.0, 3.0])) == 7.0
    assert metric_reader("batch_p95_ms")(Run()) is None
    assert metric_reader("host_pack_ms.reads")(Run(pack_s=[0.008, 0.010])) == pytest.approx(9.0)


def test_roofline_byte_counts():
    assert roofline.K1_LANE_BYTES == 115  # key 8, two 7-word slots 56, outputs 51
    assert roofline.k1_bytes(1 << 20) == 115 * (1 << 20)
    # chip_smoke.py's K1 bound at 2^20 lanes: 0.0360 ms
    assert roofline.k1_bytes(1 << 20) / roofline.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.036, abs=5e-4)
    tr = _trace()
    share = metric_reader("k1_roofline.queries")(Run(trace=tr, probe_lanes=1000))
    assert share == pytest.approx(100 * 115_000 / 3.35e12 / 150e-9)


def test_readers_give_nothing_where_there_is_nothing_to_read():
    for name in ("torch_ops_ms.reads", "k1_roofline.reads", "device_idle_pct.reads"):
        assert metric_reader(name)(Run()) is None
    empty = trace.Trace([], [("window", 0, 10)], (0, 10), 1)
    assert metric_reader("k1_roofline.reads")(Run(trace=empty, probe_lanes=5)) is None
    assert math.isclose(trace.idle_pct(empty), 100.0)
