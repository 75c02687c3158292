"""The trace arithmetic on hand-made Chrome traces."""

import json

import pytest

from lz4bench import layers, trace
from lz4bench.run import Request, Run


def chrome(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.load(path)


def x(cat, name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid,
            "tid": tid, "args": args}


@pytest.fixture
def tr(tmp_path):
    return chrome(tmp_path, [
        x("user_annotation", trace.WINDOW, 1000, 1000),
        x("user_annotation", "lz4bench.decompress", 1000, 500),
        x("cpu_op", "aten::copy_", 1100, 100),
        x("cuda_runtime", "cudaMemcpyAsync", 1120, 10),
        x("user_annotation", "lz4bench.decompress", 1500, 500),
        x("cpu_op", "join", 1600, 300),
        # device: two streams overlapping, one copy before the window
        x("kernel", "decode128", 1100, 200, pid=0, tid=7),
        x("kernel", "gather", 1250, 100, pid=0, tid=9),
        x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1400, 50, pid=0, tid=13, bytes=500_000),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 1950, 100, pid=0, tid=7, bytes=1_000_000),
        x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 1960, 10, pid=0, tid=7, bytes=9),
        x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 500, 10, pid=0, tid=13, bytes=7),
        x("cpu_op", "other thread", 1000, 1000, tid=2),
    ])


def test_union_counts_overlap_once_and_clips_to_the_window(tr):
    # [1100, 1350] + [1400, 1450] + [1950, 2000] (clipped) = 250 + 50 + 50
    assert tr.busy_s() == pytest.approx(350e-6)
    assert tr.window_s == pytest.approx(1000e-6)
    assert tr.gaps() == [(1000, 1100), (1350, 1400), (1450, 1950)]


def test_idle_gaps_named_by_innermost_host_event(tr):
    gaps = dict(tr.idle_gaps())
    assert gaps["lz4bench.decompress"] == pytest.approx((100 + 50) * 1e-6)  # 1050, 1375
    assert gaps["join"] == pytest.approx(500e-6)  # 1700 lies in join
    assert "other thread" not in gaps


def test_device_ops_summed_by_name(tr):
    ops = dict(tr.device_ops())
    assert ops["decode128"] == pytest.approx(200e-6)
    assert list(dict(tr.device_ops(top=1))) == ["decode128"]


def run(tr, side="decompress", n_in=1_000_000, n_out=2_000_000):
    reqs = [Request(0, 0.0, 0.0005, n_in, n_out), Request(1, 0.0005, 0.001, n_in, n_out)]
    return Run(side, reqs, 0.001, 1.0, trace=tr)


def test_layer_arithmetic(tr):
    r = run(tr)
    assert layers.launches_per_req(r, "decompress") == 1.0
    # HtoD and DtoH only, the DtoH cut to its half in the window: 1,000,000 B
    # in 100 us
    assert layers.link_gbps(r, "decompress") == pytest.approx(1e6 / 100e-6 / 1e9)
    # 6 MB at 3.35 TB/s over 300 us of kernels
    assert layers.kernel_roofline(r, "decompress") == pytest.approx(
        100 * 6e6 / 3.35e12 / 300e-6)
    assert layers.device_idle(r, "decompress") == pytest.approx(65.0)


def test_readers_of_another_side_or_no_trace_return_nothing(tr):
    assert layers.device_idle(run(tr), "compress") is None
    assert layers.kernel_roofline(run(None), "decompress") is None


def test_roofline_never_above_100_when_the_bytes_fit(tr):
    # the least time the bytes need is below the kernels' time
    assert layers.kernel_roofline(run(tr, n_in=10**8, n_out=10**8), "decompress") < 100
