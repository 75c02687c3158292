"""The port's instrumentation (``lz4tpu_torch/runtime.py``), on the CPU at
small sizes with the kernels' plain versions.

* Under ``torch.profiler`` the frame entry points open the ``lz4t.*``
  spans of their phases, nested under the entry's span, in the order the
  work runs; a frame of 1,000 blocks opens no more spans than one of 4,
  but for the extra pipelined units.
* With no profiler running, ``record_function`` is never entered.
* ``stats()`` counts calls, launches and the bytes through staging
  exactly, and ``reset_stats()`` zeroes them.
* ``decompress_frames_parallel`` checks block checksums after a frame's
  scan, and still raises the first fault of a broken frame, the one the
  JAX package's check during its scan raises.
"""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import lz4tpu_torch as lt  # noqa: E402
from lz4tpu.parallel.mesh import make_mesh  # noqa: E402
from lz4tpu.parallel.pipeline import decompress_frames_parallel as jax_frames_parallel  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from lz4tpu_torch import runtime  # noqa: E402
from lz4tpu_torch.frame.format import frame_header, scan_frame  # noqa: E402
from lz4tpu_torch.frame.header import BlockDescriptor, Flags  # noqa: E402
from lz4tpu_torch.kernels import compress, pack  # noqa: E402
from lz4tpu_torch.spec.xxhash32 import xxh32  # noqa: E402

from conftest import make_corpus_sample  # noqa: E402

BLOCK = 1 << 16
DATA = make_corpus_sample(18, 3 * BLOCK + 12_345)  # four blocks, the last short


@pytest.fixture(scope="module")
def frame():
    return lt.compress_frame_parallel(DATA, BLOCK, device="cpu")


def traced(tmp_path, fn):
    """``fn()``'s result and its ``lz4t.*`` spans, ``(start, end, name)``
    in order of start, from the Chrome trace of a CPU profile."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in events
                   if e.get("ph") == "X" and e.get("name", "").startswith("lz4t."))
    return out, spans


def names(spans):
    return [name for _, _, name in spans]


def first(spans, name):
    return names(spans).index(name)


def last(spans, name):
    return len(spans) - 1 - names(spans)[::-1].index(name)


def check_nested(spans, entry):
    """One entry span, first, and every other span inside it."""
    assert names(spans).count(entry) == 1
    a, b, name = spans[0]
    assert name == entry
    for start, end, name in spans[1:]:
        assert a <= start and end <= b, name


def test_compress_spans_nest_under_the_entry_in_order(tmp_path):
    frame, spans = traced(tmp_path, lambda: lt.compress_frame_parallel(DATA, BLOCK, device="cpu"))
    check_nested(spans, "lz4t.compress_frame")
    assert {"lz4t.upload", "lz4t.launch", "lz4t.fetch", "lz4t.assemble",
            "lz4t.checksum"} <= set(names(spans))
    assert first(spans, "lz4t.upload") < first(spans, "lz4t.launch") < first(spans, "lz4t.fetch")
    assert last(spans, "lz4t.fetch") < first(spans, "lz4t.checksum")
    assert last(spans, "lz4t.fetch") < first(spans, "lz4t.assemble")
    assert lt.decompress_frame(frame, engine="cpu") == DATA


def test_decompress_spans_nest_under_the_entry_in_order(tmp_path, frame):
    out, spans = traced(tmp_path, lambda: lt.decompress_frame_parallel(frame, device="cpu"))
    assert out == DATA
    check_nested(spans, "lz4t.decompress_frame")
    assert {"lz4t.scan", "lz4t.upload", "lz4t.launch", "lz4t.fetch", "lz4t.join",
            "lz4t.checksum"} <= set(names(spans))
    for phase in ("lz4t.upload", "lz4t.launch", "lz4t.fetch"):
        assert last(spans, "lz4t.scan") < first(spans, phase)
        assert last(spans, phase) < first(spans, "lz4t.join") < first(spans, "lz4t.checksum")


def test_decompress_frames_spans_nest_under_the_entry(tmp_path, frame):
    frames = [frame, lt.compress_frame_parallel(DATA, BLOCK, device="cpu", parallel_linked=True)]
    out, spans = traced(tmp_path, lambda: lt.decompress_frames_parallel(frames, device="cpu"))
    assert out == [DATA, DATA]
    check_nested(spans, "lz4t.decompress_frames")
    # the independent frame's decode, then the linked frame's waves
    assert {"lz4t.scan", "lz4t.upload", "lz4t.launch", "lz4t.fetch", "lz4t.join",
            "lz4t.checksum"} <= set(names(spans))
    assert names(spans).count("lz4t.scan") == 2


def small_blocks_frame(n_blocks: int) -> tuple[bytes, bytes]:
    """A frame of ``n_blocks`` compressed blocks of 10 literals each, with
    its content."""
    content = bytes((7 * i) & 0xFF for i in range(10 * n_blocks))
    flags = Flags(independent_blocks=True, block_checksums=False, content_checksum=True,
                  content_size=False, dictionary_id=False)
    parts = [frame_header(flags, BlockDescriptor.for_block_maxsize(BLOCK), None, None)]
    for i in range(n_blocks):
        block = bytes([10 << 4]) + content[10 * i : 10 * i + 10]  # one token, literals only
        parts += [len(block).to_bytes(4, "little"), block]
    parts += [bytes(4), xxh32(content).to_bytes(4, "little")]
    return b"".join(parts), content


def span_count(tmp_path, frame, content):
    lt.decompress_frame_parallel(frame, device="cpu")  # staging buffers taken once before
    out, spans = traced(tmp_path, lambda: lt.decompress_frame_parallel(frame, device="cpu"))
    assert out == content
    return spans


def test_spans_are_per_phase_not_per_block(tmp_path, monkeypatch):
    four = span_count(tmp_path, *small_blocks_frame(4))
    many = span_count(tmp_path, *small_blocks_frame(1000))
    # both are one decode unit
    assert names(four).count("lz4t.launch") == names(many).count("lz4t.launch") == 1
    assert len(many) == len(four)
    # the budget cut 1,000 blocks into 4 units: 3 more units' spans at most
    per_unit = sum(n not in ("lz4t.decompress_frame", "lz4t.scan", "lz4t.join", "lz4t.checksum")
                   for n in names(four))
    out_capacity = runtime.round_up(BLOCK + 16, 16)
    monkeypatch.setattr(pack, "DECODE_BUDGET", 250 * (out_capacity + 16))
    cut = span_count(tmp_path, *small_blocks_frame(1000))
    assert names(cut).count("lz4t.launch") == 4
    assert len(cut) <= len(four) + 3 * per_unit


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []

    def spy(name):
        entered.append(name)
        return runtime._OFF

    monkeypatch.setattr(runtime, "record_function", spy)
    frame = lt.compress_frame_parallel(DATA, BLOCK, device="cpu")
    assert lt.decompress_frame_parallel(frame, device="cpu") == DATA
    assert lt.decompress_frames_parallel([frame], device="cpu") == [DATA]
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        lt.decompress_frame_parallel(frame, device="cpu")
    assert entered[0] == "lz4t.decompress_frame" and "lz4t.join" in entered


def units(n: int) -> int:
    return -(-n // 16) * 16


def test_stats_count_a_known_frame_exactly():
    lt.reset_stats()
    frame = lt.compress_frame_parallel(DATA, BLOCK, device="cpu")
    blocks, _ = scan_frame(lt.LZ4FrameReader(frame, engine="cpu"))
    payloads = [p for compressed, p, _ in blocks if compressed]
    assert len(blocks) == 4 and payloads
    s = lt.stats()
    assert s["calls"] == {"compress_frame": 1, "decompress_frame": 0, "decompress_frames": 0}
    # one upload: the input, then the (6, blocks) int32 parameters
    assert (s["uploads"], s["upload_bytes"]) == (1, units(units(len(DATA)) + 6 * 4 * 4))
    # one fetch: the compressed payloads, each in whole 16-byte units
    assert (s["fetches"], s["fetch_bytes"]) == (1, sum(units(len(p)) for p in payloads))

    lt.reset_stats()
    assert lt.decompress_frame_parallel(frame, device="cpu") == DATA
    s = lt.stats()
    assert s["calls"] == {"compress_frame": 0, "decompress_frame": 1, "decompress_frames": 0}
    # one upload: the payloads in whole units, then their int32 lengths
    assert (s["uploads"], s["upload_bytes"]) == (
        1, units(sum(units(len(p)) for p in payloads) + 4 * len(payloads)))
    sizes = [min(BLOCK, len(DATA) - i * BLOCK) for i, (c, _, _) in enumerate(blocks) if c]
    assert (s["fetches"], s["fetch_bytes"]) == (1, sum(units(n) for n in sizes))
    # the plain versions launch no CUDA kernel and hold no device memory
    assert s["launches"] == dict.fromkeys(
        ("compress", "compress128", "decode128", "decode_big", "decode_v4", "decode_v3",
         "push_windows"), 0)
    assert s["device_bytes_peak"] == 0


def test_reset_stats_zeroes_every_counter(frame):
    kernel = compress.KERNEL  # its one launch counter only goes up
    lt.reset_stats()
    before = kernel.launches
    kernel.begin()
    kernel.begin()
    lt.decompress_frames_parallel([frame], device="cpu")
    s = lt.stats()
    assert s["launches"]["compress"] == 2 and kernel.launches == before + 2
    assert s["calls"]["decompress_frames"] == 1 and s["uploads"] == 1 and s["fetch_bytes"] > 0
    launches = kernel.launches
    lt.reset_stats()
    s = lt.stats()
    assert s["launches"]["compress"] == 0 and kernel.launches == launches  # its own count stays
    kernel.reset()
    assert kernel.launches == launches and lt.stats()["launches"]["compress"] == 0
    assert all(v == 0 for v in s["calls"].values())
    assert all(s[k] == 0 for k in runtime.COUNTERS)


def broken_frame(flip: int, oversize: int | None) -> bytes:
    """A frame of three blocks with block checksums, ``flip``'s checksum
    wrong, and then block ``oversize``'s length past the block maxsize, or,
    when that is None, the frame cut short inside its last block."""
    data = make_corpus_sample(5, 3 * BLOCK)
    frame = bytearray(lt.CompressionSettings().engine("cpu").block_size(BLOCK)
                      .block_checksums(True).compress_bytes(data))
    blocks, _ = scan_frame(lt.LZ4FrameReader(bytes(frame), engine="cpu"))
    assert len(blocks) == 3
    at = [frame.index(payload) for _, payload, _ in blocks]
    frame[at[flip] + len(blocks[flip][1])] ^= 1  # a byte of the block's checksum
    if oversize is None:
        return bytes(frame[: at[2] + 10])
    frame[at[oversize] - 4 : at[oversize]] = (BLOCK + 1).to_bytes(4, "little")
    return bytes(frame)


@pytest.mark.parametrize("flip, oversize, error", [
    (0, None, "BlockChecksumFail"),  # a bad checksum, then a truncation
    (0, 1, "BlockChecksumFail"),  # a bad checksum, then a block too large
    (1, 0, "BlockSizeOverflow"),  # a block too large before the bad checksum
])
def test_frames_raise_the_first_fault_as_the_jax_package_does(flip, oversize, error):
    broken = broken_frame(flip, oversize)
    with pytest.raises(Exception) as want:
        jax_frames_parallel([broken], mesh=make_mesh(1))
    with pytest.raises(Exception) as got:
        lt.decompress_frames_parallel([broken], device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__ == error
