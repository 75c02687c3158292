"""The self time of the program's spans on hand-made Chrome traces."""

import json

import pytest

from lz4bench import catalog, spans, trace
from lz4bench.run import Request, Run


def chrome(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.load(path)


def x(cat, name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid,
            "tid": tid, "args": args}


def span(name, ts, dur, **kw):
    return x("user_annotation", name, ts, dur, **kw)


@pytest.fixture
def tr(tmp_path):
    return chrome(tmp_path, [
        span(trace.WINDOW, 1000, 1000),
        # a request cut by the window's start: [1000, 1300] of it counts
        span("lz4bench.decompress", 900, 400),
        span("lz4t.decompress_frame", 900, 400),
        span("lz4t.scan", 950, 100),  # [1000, 1050] in the window
        span("lz4t.upload", 1100, 100),
        x("cpu_op", "aten::copy_", 1120, 50),  # the upload's own work
        span("lz4t.pin", 1150, 20),
        # a whole request
        span("lz4bench.decompress", 1400, 500),
        span("lz4t.decompress_frame", 1400, 500),
        span("lz4t.launch", 1450, 50),
        span("lz4t.fetch", 1500, 100),
        span("lz4t.wait.fetch", 1550, 40),
        x("cuda_runtime", "cudaEventSynchronize", 1555, 30),
        span("lz4t.join", 1600, 200),
        span("lz4t.wait.launch", 1810, 30),
        # a span outside any entry span, and another thread's
        span("lz4t.checksum", 1950, 40),
        span("lz4t.join", 1400, 500, tid=2),
        span("lz4t.decompress_frame", 1400, 500, tid=2),
    ])


def run(tr, side="decompress", n=2):
    return Run(side, [Request(k, 0.0, 0.001, 1, 1) for k in range(n)], 0.001, 1.0, trace=tr)


def test_self_time_subtracts_child_spans_but_not_operators(tr):
    t = {name: round(s * 1e6, 6) for name, s in spans.self_times(tr).items()}
    assert t == {
        # 300 in the window, less scan 50 and upload 100; then 500 less
        # launch 50, fetch 100, join 200 and wait.launch 30
        "lz4t.decompress_frame": 150 + 120,
        "lz4t.scan": 50,  # clipped to the window
        "lz4t.upload": 80,  # its aten::copy_ stays in it; pin does not
        "lz4t.pin": 20,
        "lz4t.launch": 50,
        "lz4t.fetch": 60,
        "lz4t.wait.fetch": 40,  # the runtime call inside it stays in it
        "lz4t.join": 200,  # another thread's join is not this thread's
        "lz4t.wait.launch": 30,
    }


def test_readers_split_the_entry_spans_by_layer(tr):
    r = run(tr)
    assert spans.frame_host_ms_per_req(r, "decompress") == pytest.approx((270 + 50 + 200) / 2e3)
    assert spans.dispatch_ms_per_req(r, "decompress") == pytest.approx((80 + 20 + 50 + 60) / 2e3)
    assert spans.host_wait_ms_per_req(r, "decompress") == pytest.approx((40 + 30) / 2e3)


def test_the_three_readers_add_up_to_the_entry_spans(tr):
    r = run(tr)
    total = sum(f(r, "decompress") for f in (spans.frame_host_ms_per_req,
                                             spans.dispatch_ms_per_req,
                                             spans.host_wait_ms_per_req))
    entry_us = (1300 - 1000) + 500  # the entry spans, clipped to the window
    assert total == pytest.approx(entry_us / 1e3 / 2)


def test_readers_of_another_side_no_trace_or_no_spans_return_nothing(tr, tmp_path):
    readers = (spans.frame_host_ms_per_req, spans.dispatch_ms_per_req,
               spans.host_wait_ms_per_req)
    bare = chrome(tmp_path, [span(trace.WINDOW, 0, 100), span("lz4bench.compress", 0, 90),
                             x("kernel", "compress", 10, 50, pid=0, tid=7)])
    for read in readers:
        assert read(run(tr), "compress") is None
        assert read(run(None), "decompress") is None
        assert read(run(bare, "compress"), "compress") is None
        assert read(run(tr, n=0), "decompress") is None


def test_every_new_metric_has_a_reader_for_its_cells():
    bench = catalog.load()
    names = [m["name"] for m in bench["per_layer"] if m["unit"] == "ms/req"]
    assert len(names) == 9
    cells = {w["name"]: w for w in bench["workloads"]}
    for m in bench["per_layer"]:
        if m["unit"] != "ms/req":
            continue
        twin = {x["name"]: x for x in bench["per_layer"]}[
            "launches_per_req." + m["name"].split(".", 1)[1]]
        assert (m["workloads"], m["moves"]) == (twin["workloads"], twin["moves"])
        for w in m["workloads"]:
            cell = catalog.cell(w)
            assert hasattr(cell.reader(catalog.Metric(m["name"], m["unit"], False)), "read")
            assert w in cells
