"""The metric readers' arithmetic on a canned trace and canned counters."""

import pytest

from tdbench import run
from tdbench.byname import load
from tdbench.trace import HBM_BYTES_PER_S, SLICE, read_slice


def ev(cat, name, ts, dur, **kw):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1, tid=1,
                **kw)


EVENTS = [
    ev("kernel", "too_early", 0, 50),
    ev("user_annotation", SLICE, 100, 1000),
    ev("kernel", "piece_starts_cp_kernel(int const*)", 150, 100),
    ev("kernel", "probe_kernel", 200, 100),       # overlaps the one above
    ev("gpu_memcpy", "Memcpy DtoH", 500, 50),
    ev("kernel", "compact_kernel", 1050, 100),    # clipped at the end
    ev("cpu_op", "aten::copy_", 300, 200),
    ev("cuda_runtime", "cudaMemcpyAsync", 310, 20),
]


def reader(name):
    return load("metrics", name.split(".")[0]).read


def canned_run():
    r = run.Run(setup_s=12.5, window_s=2.0, calls=4, bytes=8_000_000,
                latencies_s=[i / 1000 for i in range(1, 101)])
    r.stats = dict(safe_cut_s=0.1, device_s=0.4, drain_s=0.3, host_s=0.0,
                   grid_s=0.2, windows=40, spliced_pieces=2000)
    r.slice = read_slice(EVENTS)
    r.slice.bytes, r.slice.chars, r.slice.ids = 3_000_000, 2_000_000, 500_000
    return r


def test_slice_arithmetic():
    sl = canned_run().slice
    assert (sl.start_us, sl.end_us, sl.window_us) == (100, 1100, 1000)
    # [150, 300] + [500, 550] + [1050, 1100]: the union, clipped
    assert sl.busy_us() == pytest.approx(150 + 50 + 50)
    assert sl.kernel_us() == pytest.approx(100 + 100 + 50)
    assert sl.kernel_us(r"\bpiece_starts") == pytest.approx(100)
    names = [n for n, _ in sl.device_ops()]
    assert names[0] in ("piece_starts_cp_kernel", "probe_kernel")
    assert "Memcpy DtoH" in names
    gaps = dict(sl.idle_gaps())
    # [100,150] and [550,1050] untraced; [300,500] under aten::copy_'s
    # middle (400), which cudaMemcpyAsync does not cover
    assert gaps["aten::copy_"] == pytest.approx(200e-6)
    assert gaps["host: untraced"] == pytest.approx((50 + 500) * 1e-6)


def test_no_slice_range_reads_nothing():
    assert read_slice([ev("kernel", "k", 0, 10)]) is None


@pytest.mark.parametrize("name,want", [
    ("setup_s", 12.5),
    ("doc_mbps", 4.0),
    ("doc_mbps.code", 4.0),
    # 3 MB over the 250 us the card was busy
    ("card_mbps", 12000.0),
    ("request_p95_ms", 95.05),
    ("glue_share.doc", 50.0),
    ("splice_share.doc", 15.0),
    ("spliced_per_mb.doc", 250.0),
    ("window_ms.request", 10.0),
    ("idle_share.request", 75.0),
    ("kernel_roofline.doc",
     100 * (3_000_000 + 4 * 500_000) / HBM_BYTES_PER_S / 250e-6),
    ("starts_roofline.doc",
     100 * (3_000_000 + 2_000_000 / 8) / HBM_BYTES_PER_S / 100e-6),
])
def test_readers(name, want):
    assert reader(name)(canned_run()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["idle_share.doc", "kernel_roofline.doc",
                                  "starts_roofline.doc", "card_mbps"])
def test_trace_readers_without_a_trace_read_nothing(name):
    r = run.Run(window_s=1.0, bytes=1)
    assert reader(name)(r) is None
    r.slice = read_slice([ev("user_annotation", SLICE, 0, 10)])
    assert reader(name)(r) is None


@pytest.mark.parametrize("name", ["glue_share.doc", "splice_share.doc",
                                  "spliced_per_mb.doc",
                                  "window_ms.request"])
def test_counter_readers_without_counters_fail_the_run(name):
    r = run.Run(window_s=1.0, bytes=1, stats={})
    with pytest.raises(KeyError):
        reader(name)(r)


def test_window_ms_reads_nothing_where_no_window_ran():
    r = canned_run()
    r.stats["windows"] = 0
    assert reader("window_ms.request")(r) is None


def test_a_port_without_engine_stats_fails_the_run():
    class Tok:
        _device = None
    with pytest.raises(RuntimeError):
        run.engine_stats(Tok())
