"""The batched read op (``ops/readbatch.py``), its probes, and the two
readers of the linked waves on hand-made Chrome traces."""

import json

import numpy as np
import pytest

import lz4tpu_torch
from lz4bench import catalog, plain_lz4f, reference, spans, trace
from lz4bench.corpora import silesia as corpus
from lz4bench.run import Job, Request, Run

CELL = "silesia-64k-readbatch"


@pytest.fixture(scope="module")
def cell():
    return catalog.cell(CELL)


@pytest.fixture(scope="module")
def tiny(cell):
    """The cell's objects and inputs at a tiny scale."""
    members = corpus.members(2**31 + 3, 0.002)
    objects = [d for _, d in cell.objects().make(members, cell.traffic, 2**31 + 3)]
    return objects, cell.op().prepare(objects, cell.config)


def job(cell, send, seed=5):
    return Job(cell.config, cell.traffic, np.random.default_rng(seed), send,
               lz4tpu_torch.LZ4Error)


def send_cpu(frames):
    return lz4tpu_torch.decompress_frames_parallel(frames, device="cpu")


def test_prepare_sizes_and_check(cell, tiny):
    op = cell.op()
    objects, inputs = tiny
    assert len(objects) == 768 and [len(b) for b in inputs] == [64] * 12
    assert [plain_lz4f.decompress(f) for f in inputs[3]] == objects[192:256]
    out = op.call(lz4tpu_torch, inputs[3], cell.config, "cpu", {})
    assert op.sizes(inputs[3], out) == (sum(map(len, inputs[3])), sum(map(len, objects[192:256])))
    assert op.sizes(inputs[3], b"") == (sum(map(len, inputs[3])), 0)  # a failed request
    kept = [(3, out), (5, op.call(lz4tpu_torch, inputs[5], cell.config, "cpu", {}))]
    checks = op.check(kept, objects, inputs, job(cell, send_cpu))
    assert checks == {"wrong_contents": (0, 0), "objects_unchecked": (640, 0),
                      "corrupt_accepted": (0, 0), "wrong_refusal": (0, 0)}
    # a wrong buffer and a missing one each count
    bad = list(out)
    bad[7] = bad[7][:-1]
    checks = op.check([(3, bad), (5, kept[1][1][:-1])], objects, inputs, job(cell, send_cpu))
    assert checks["wrong_contents"] == (2, 0)


def test_probes_are_built_as_described(tiny):
    from lz4bench.ops import readbatch

    _, inputs = tiny
    frames = inputs[0]
    rng = np.random.default_rng(11)
    cut = readbatch.probe("truncated", frames, rng)
    (j,) = [k for k in range(len(frames)) if cut[k] != frames[k]]
    at, length, _ = reference.blocks(frames[j])[-1]
    assert at <= len(cut[j]) < at + length and frames[j].startswith(cut[j])
    bad = readbatch.probe("offset", frames, rng)
    (j,) = [k for k in range(len(frames)) if bad[k] != frames[k]]
    at = readbatch.first_match(frames[j])
    assert bad[j][at : at + 2] == b"\xff\xff" and len(bad[j]) == len(frames[j])
    assert sum(a != b for a, b in zip(bad[j], frames[j])) <= 2
    # the first match's offset, just after the first sequence's literals
    offset, length, stored = reference.blocks(frames[j])[0]
    assert not stored and offset < at < offset + length
    for kind, broken in (("truncated", cut), ("offset", bad)):
        with pytest.raises(plain_lz4f.FrameError):
            [plain_lz4f.decompress(f) for f in broken]


def test_probes_count_wrong_refusals_and_acceptance(cell, tiny):
    objects, inputs = tiny
    op = cell.op()

    def wrong_class(frames):
        raise RuntimeError("not the program's refusal")

    checks = op.check([], objects, inputs, job(cell, wrong_class))
    assert checks["wrong_refusal"] == (2, 0) and checks["corrupt_accepted"] == (0, 0)
    checks = op.check([], objects, inputs, job(cell, lambda frames: [b""] * len(frames)))
    assert checks["corrupt_accepted"] == (2, 0) and checks["objects_unchecked"] == (768, 0)


def test_the_control_accepts_a_match_before_the_frame(cell, tiny):
    """The mix's control hands every frame 64 KiB of zeros as its
    dictionary: the kept batches still equal their objects, the cut frame
    is still refused, and the frame whose first match reaches before its
    first byte is accepted."""
    objects, inputs = tiny
    op = cell.op()
    control = cell.traffic["control"]
    assert control == {"zero_dictionary": 65536}

    def send(frames):
        return op.call(lz4tpu_torch, frames, cell.config, "cpu", control)

    checks = op.check([(2, send(inputs[2]))], objects, inputs, job(cell, send))
    assert checks["wrong_contents"] == (0, 0) and checks["wrong_refusal"] == (0, 0)
    assert checks["corrupt_accepted"] == (1, 0)


def chrome(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.load(path)


def span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": {}}


@pytest.fixture
def tr(tmp_path):
    return chrome(tmp_path, [
        span(trace.WINDOW, 1000, 1000),
        span("lz4bench.decompress", 1000, 900),
        span("lz4t.decompress_frames", 1000, 900),
        span("lz4t.scan", 1000, 50),
        span("lz4t.upload", 1060, 20),  # the windows' upload
        span("lz4t.plan", 1090, 30),
        span("lz4t.wave", 1130, 200),
        span("lz4t.upload", 1140, 60),
        span("lz4t.launch", 1210, 100),
        span("lz4t.push", 1250, 40),
        span("lz4t.upload", 1340, 10),  # a stored block's push
        span("lz4t.push", 1350, 30),
        span("lz4t.wave", 1400, 100),
        span("lz4t.launch", 1420, 50),
        span("lz4t.push", 1430, 20),
        span("lz4t.wait.launch", 1510, 40),
        span("lz4t.fetch", 1560, 30),
        span("lz4t.join", 1600, 250),
        # outside any entry span, and another thread's
        span("lz4t.wave", 1950, 20),
        span("lz4t.wave", 1400, 100, tid=2),
    ])


def readers(cell):
    return {name: cell.reader(catalog.Metric(name, "", False)).read
            for name in ("wave_ms_per_req.decompress", "waves_per_req.decompress")}


def run(tr, side="decompress", n=2):
    return Run(side, [Request(k, 0.0, 0.001, 1, 1) for k in range(n)], 0.001, 1.0, trace=tr)


def test_wave_readers_on_a_hand_made_trace(cell, tr):
    read = readers(cell)
    # plan 30; waves 200 - 60 - 100 and 100 - 50; pushes 40, 30, 20
    assert read["wave_ms_per_req.decompress"](run(tr)) == pytest.approx(
        (30 + 40 + 50 + 40 + 30 + 20) / 2e3)
    assert read["waves_per_req.decompress"](run(tr)) == 1.0
    # with the other three readers, the entry span's duration
    total = read["wave_ms_per_req.decompress"](run(tr)) + sum(
        f(run(tr), "decompress") for f in (spans.frame_host_ms_per_req,
                                           spans.dispatch_ms_per_req,
                                           spans.host_wait_ms_per_req))
    assert total == pytest.approx(900 / 1e3 / 2)


def test_wave_readers_return_nothing_without_their_spans(cell, tr, tmp_path):
    bare = chrome(tmp_path, [span(trace.WINDOW, 0, 100), span("lz4t.decompress_frame", 0, 90),
                             span("lz4t.scan", 10, 20)])
    for read in readers(cell).values():
        assert read(run(bare)) is None  # a program without these spans
        assert read(run(tr, "compress")) is None
        assert read(run(None)) is None
        assert read(run(tr, n=0)) is None
