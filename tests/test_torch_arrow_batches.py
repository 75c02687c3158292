"""Arrow IPC / Feather V2 record batches through the port, on the CPU.

Arrow C++ writes each buffer of a record batch as one LZ4 frame of the
C library's frame API with zeroed preferences: 64 KiB linked blocks, no
checksums, no content size.  A reader decodes one batch's frames in one
``decompress_frames_parallel`` call, in waves.

* ``lz4bench.plain_lz4f`` (the benchmark's plain reader) decodes the C
  library's linked frames to their content.
* The port's waves give the plain reader's bytes on seeded batches.
* A frame cut inside its last block, and one whose first match reaches
  before the frame's first byte, are refused by both; the port raises an
  ``LZ4Error``, the serial reader's ``CodecError`` of the same kind.
* Under ``torch.profiler`` the waves open ``lz4t.plan``, ``lz4t.wave``
  and ``lz4t.push``, and ``stats()`` counts the waves worked out from the
  frames; without a profiler no span is entered.
"""

import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import lz4tpu  # noqa: E402
import lz4tpu_torch as lt  # noqa: E402
from torch.autograd.profiler import record_function  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from lz4tpu_torch import runtime  # noqa: E402
from lz4tpu_torch.frame.errors import CodecError  # noqa: E402
from lz4tpu_torch.parallel import waves  # noqa: E402

from conftest import make_corpus_sample  # noqa: E402
from lz4bench import plain_lz4f, reference, spans, trace  # noqa: E402
from lz4bench.ops import readbatch  # noqa: E402

CONFIG = json.loads(open(os.path.join(os.path.dirname(HERE), "lz4bench", "configs",
                                      "arrow-ipc-lz4f.json")).read())
BLOCK = 1 << 16


def arrow_frame(data: bytes) -> bytes:
    """``data`` as Arrow C++ writes a buffer: the C library's frame API at
    the configuration's settings."""
    return reference.stored(data, CONFIG)


@pytest.fixture(scope="module")
def sample():
    return make_corpus_sample(2020, 1_200_000)


def batch(sample, n: int, seed: int) -> list[bytes]:
    """``n`` pieces of ``sample``, 2 KiB to 256 KiB, log-uniform, from ``seed``."""
    rng = np.random.default_rng(seed)
    sizes = np.exp(rng.uniform(np.log(2048), np.log(1 << 18), n)).astype(int)
    return [sample[a : a + s] for s in sizes.tolist()
            for a in [int(rng.integers(0, len(sample) - s))]]


# ---------------------------------------------------------------------------
# the plain reader
# ---------------------------------------------------------------------------

CASES = {
    "stored_block": lambda: bytes(np.random.default_rng(7).integers(0, 256, 30_000, np.uint8)),
    "one_block": lambda: make_corpus_sample(31, 40_000),
    "empty": lambda: b"",
    "multiple_of_64k": lambda: make_corpus_sample(32, 3 * BLOCK),
    "one_mib_less_one": lambda: make_corpus_sample(33, (1 << 20) - 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_reader_decodes_the_c_librarys_linked_frames(case):
    data = CASES[case]()
    frame = arrow_frame(data)
    blocks = reference.blocks(frame)
    assert len(blocks) == -(-len(data) // BLOCK)
    assert frame[4] & 0x20 == 0 and frame[4] & 0x1C == 0  # linked, no checksums, no size
    if case == "stored_block":
        assert blocks[0][2]
    assert plain_lz4f.decompress(frame) == data
    assert lt.decompress_frames_parallel([frame], device="cpu") == [data]


# ---------------------------------------------------------------------------
# the port's waves against the plain reader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 64])
def test_waves_give_the_plain_readers_bytes(sample, n):
    datas = batch(sample, n, seed=100 + n)
    frames = [arrow_frame(d) for d in datas]
    want = [plain_lz4f.decompress(f) for f in frames]
    assert want == datas
    assert lt.decompress_frames_parallel(frames, device="cpu") == want


# ---------------------------------------------------------------------------
# the two probes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", readbatch.KINDS)
def test_both_readers_refuse_the_probes(sample, kind):
    frames = [arrow_frame(d) for d in batch(sample, 7, seed=300)]
    broken = readbatch.probe(kind, frames, np.random.default_rng(301))
    (j,) = [k for k in range(len(frames)) if broken[k] != frames[k]]
    with pytest.raises(plain_lz4f.FrameError):
        plain_lz4f.decompress(broken[j])
    with pytest.raises(lt.LZ4Error) as got:
        lt.decompress_frames_parallel(broken, device="cpu")
    with pytest.raises(lt.LZ4Error) as serial:
        lt.LZ4FrameReader(broken[j], engine="cpu").read_all()
    # the JAX package's serial reader (on its spec) refuses the frame as
    # the port's serial reader does
    with pytest.raises(lz4tpu.LZ4Error) as reference_serial:
        lz4tpu.LZ4FrameReader(broken[j], engine="spec").read_all()
    assert type(reference_serial.value).__name__ == type(serial.value).__name__
    assert getattr(reference_serial.value, "kind", None) == getattr(serial.value, "kind", None)
    if kind == "truncated":
        assert type(got.value) is type(serial.value) is lt.frame.errors.InputTruncated
    else:
        # the serial reader's CodecError, of the same kind
        assert isinstance(got.value, CodecError) and type(serial.value) is CodecError
        assert got.value.kind == serial.value.kind == reference_serial.value.kind \
            == "invalid_deduplication_offset"


@pytest.mark.parametrize("entry", ["decompress_frame_parallel", "decompress_frames_parallel"])
def test_independent_frames_refuse_as_the_jax_package(sample, entry):
    """A frame of independent blocks with its first match's offset set to
    0xFFFF: the port's batched decode raises the JAX package's error class
    name (the block decoder's ``DecodeError``) and kind, and is besides the
    port's ``LZ4Error``."""
    from lz4tpu.parallel.pipeline import decompress_frame_parallel as jax_frame_parallel

    frame = reference.stored(sample[: 3 * BLOCK], {**CONFIG, "independent_blocks": True})
    at = readbatch.first_match(frame)
    broken = frame[:at] + b"\xff\xff" + frame[at + 2 :]
    with pytest.raises(lz4tpu.DecodeError) as want:  # the block decoder's, as it was
        jax_frame_parallel(broken, lane_kernel=False)
    with pytest.raises(lt.LZ4Error) as got:
        if entry == "decompress_frame_parallel":
            lt.decompress_frame_parallel(broken, device="cpu")
        else:
            lt.decompress_frames_parallel([frame, broken], device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__ == "DecodeError"
    assert got.value.kind == want.value.kind == "invalid_deduplication_offset"


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------


def test_wave_spans_and_counters(sample, tmp_path):
    datas = batch(sample, 7, seed=400)
    datas[3] = bytes(np.random.default_rng(401).integers(0, 256, 3 * BLOCK + 500, np.uint8))
    frames = [arrow_frame(d) for d in datas]
    chains = [reference.blocks(f) for f in frames]
    depth = max(map(len, chains))
    compressed = [any(w < len(c) and not c[w][2] for c in chains) for w in range(depth)]
    stored = [any(w < len(c) and c[w][2] for c in chains) for w in range(depth)]
    assert any(stored) and sum(compressed) >= 3
    # a slide a wave for its decoded rows and one for its stored rows, where
    # one of their frames has a next block
    slides = sum(any(w + 1 < len(c) and c[w][2] == kind for c in chains)
                 for w in range(depth) for kind in (False, True))
    lt.reset_stats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            assert lt.decompress_frames_parallel(frames, device="cpu") == datas
    s = lt.stats()
    # one budget group a wave at this size
    assert s["linked_frames"] == 7
    assert s["waves"] == s["wave_launches"] == sum(compressed)
    assert s["window_pushes"] == slides < sum(compressed) + sum(stored)
    assert s["uploads"] == 1  # the waves' blocks, all in one chunk at this size

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    tr = trace.load(path)
    names = [n for _, _, n in tr.host if n.startswith("lz4t.")]
    assert names.count("lz4t.plan") == 1
    assert names.count("lz4t.wave") == s["waves"]
    assert names.count("lz4t.push") == s["window_pushes"]
    waves = [(a, b) for a, b, n in tr.host if n == "lz4t.wave"]
    inside = {child: [a for a, b, n in tr.host if n == child and any(w0 <= a and b <= w1
                                                                    for w0, w1 in waves)]
              for child in ("lz4t.launch", "lz4t.push", "lz4t.upload")}
    assert len(inside["lz4t.launch"]) == len(waves)
    assert 0 < len(inside["lz4t.push"]) < s["window_pushes"]  # stored rows slide outside
    assert inside["lz4t.upload"] == []
    # every span of the call is read by one of the four layers' readers, so
    # their self times add up to the entry span's duration
    wave_names = ("lz4t.plan", "lz4t.wave", "lz4t.push")
    groups = spans.FRAME_HOST + spans.DISPATCH + spans.HOST_WAIT + wave_names
    assert set(names) <= set(groups)
    times = spans.self_times(tr)
    (entry,) = [b - a for a, b, n in tr.host if n == "lz4t.decompress_frames"]
    assert sum(times.get(n, 0.0) for n in groups) == pytest.approx(entry * 1e-6, rel=1e-9)
    assert all(times.get(n, 0.0) > 0 for n in wave_names)


def test_push_is_one_span_a_slide_not_a_block():
    """``_push_windows`` counts one slide for a group of frames, and each
    frame's window moves to its row of the next wave."""
    import torch

    lt.reset_stats()
    windows = torch.zeros(5, BLOCK, dtype=torch.uint8)
    windows[:, -3:] = 7
    wlen = torch.full((5,), 3, dtype=torch.int32)
    data = torch.arange(5 * 100, dtype=torch.int64).remainder(251).to(torch.uint8).view(5, 100)
    new = torch.zeros(3, BLOCK, dtype=torch.uint8)
    new_len = torch.zeros(3, dtype=torch.int32)
    dest = torch.tensor([2, -1, 0, -1, 1], dtype=torch.int32)
    waves._push_windows(windows, wlen, data, torch.full((5,), 100, dtype=torch.int32), dest,
                           new, new_len)
    assert lt.stats()["window_pushes"] == 1
    assert new_len.tolist() == [103] * 3
    for row, frame in ((0, 2), (1, 4), (2, 0)):
        assert bytes(new[row, -103:].tolist()) == bytes([7] * 3) + bytes(data[frame].tolist())


@pytest.mark.parametrize("width", [16, 4096, BLOCK + 16])
def test_the_window_slide_keeps_the_last_64_kib(width):
    """``kernels.window``'s plain version (the CUDA kernel's contract):
    each row with a next block gets the last 64 KiB of its window and its
    new bytes, at the frame's row of the next wave; other rows are left."""
    import torch

    from lz4tpu_torch.kernels import window

    rng = np.random.default_rng(width)
    n, m = 9, 6
    old = torch.from_numpy(rng.integers(0, 256, (n, BLOCK), dtype=np.uint8))
    old_len = torch.from_numpy(rng.integers(0, BLOCK + 1, n).astype(np.int32))
    old_len[:2] = torch.tensor([0, BLOCK], dtype=torch.int32)
    data = torch.from_numpy(rng.integers(0, 256, (n, width), dtype=np.uint8))
    lens = torch.from_numpy(rng.integers(0, width + 1, n).astype(np.int32))
    lens[2:4] = torch.tensor([0, width], dtype=torch.int32)
    dest = torch.tensor([3, -1, 0, 5, 1, -1, 4, 2, -1], dtype=torch.int32)
    new = torch.full((m, BLOCK), 0xEE, dtype=torch.uint8)
    new_len = torch.full((m,), -7, dtype=torch.int32)
    window.push_windows(old, old_len, data, lens, dest, new, new_len)
    for r in range(n):
        d = int(dest[r])
        if d < 0:
            continue
        k = int(lens[r])
        stream = bytes(old[r].numpy()) + bytes(data[r, :k].numpy())
        assert bytes(new[d].numpy()) == stream[-BLOCK:]
        assert int(new_len[d]) == min(int(old_len[r]) + k, BLOCK)
    with pytest.raises(ValueError):  # the next wave's rows are 64 KiB rows too
        window.push_windows(old, old_len, data, lens, dest, new[:, :-16], new_len)


@pytest.mark.parametrize("decoder", ["decode128", "decode_big"])
def test_decoders_write_into_the_tensors_given(sample, decoder):
    """``into=``: the launch's rows, lengths and statuses in the caller's
    tensors (here views of one tensor, as the waves give them), equal to
    a launch's own outputs up to each length."""
    import torch

    from lz4tpu_torch.kernels import decode128, decodebig

    fn = decode128.decode128 if decoder == "decode128" else decodebig.decode_big
    frame = arrow_frame(sample[: 3 * BLOCK])
    blocks = [frame[a : a + n] for a, n, stored in reference.blocks(frame) if not stored]
    comp, comp_len, prefix, prefix_len = lt.hostpack.upload_batch("cpu", blocks)
    want = fn(comp, comp_len, prefix, prefix_len, BLOCK)
    cap = want[0].shape[1]
    meta = torch.zeros(2 * len(blocks) + 4, dtype=torch.int32)
    into = (torch.empty(len(blocks), cap, dtype=torch.uint8), meta[4 : 4 + len(blocks)],
            meta[4 + len(blocks) :])
    got = fn(comp, comp_len, prefix, prefix_len, BLOCK, cap, into=into)
    assert all(g is i for g, i in zip(got, into))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert [bytes(got[0][i, :n].numpy()) for i, n in enumerate(want[1].tolist())] == \
        [bytes(want[0][i, :n].numpy()) for i, n in enumerate(want[1].tolist())]
    with pytest.raises(ValueError):
        fn(comp, comp_len, prefix, prefix_len, BLOCK, cap, into=(into[0][:, :-16], *into[1:]))


def test_no_wave_span_is_entered_without_a_profiler(sample, monkeypatch):
    entered = []

    def spy(name):
        entered.append(name)
        return runtime._OFF

    monkeypatch.setattr(runtime, "record_function", spy)
    datas = batch(sample, 3, seed=500)
    assert lt.decompress_frames_parallel([arrow_frame(d) for d in datas], device="cpu") == datas
    assert entered == []
