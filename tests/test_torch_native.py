"""The port's host engine (``lz4tpu_torch.native``) on the CPU, against the
JAX package's (``lz4tpu.native``) and the port's plain versions: the greedy
block compressor on U32 and U16 tables (tables compared after every call,
also after ``Incompressible``), the HC parse, the decoder with prefixes,
output limits and seeded mutations, xxHash32, frames on ``"native"`` in
every mode (and ``threads(n)``), and the threaded ``read_all`` against the
serial reader.  Inputs come from the Silesia stand-in, numpy noise and zero
runs, made from seeds.  A byte codec has no tolerance: every comparison is
byte equality, or the same error type and kind."""

import functools
import io
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import lz4tpu
import lz4tpu.native as jax_native
from lz4tpu.frame.decompress import LZ4FrameReader as JaxFrameReader
from lz4tpu.spec.block import DecodeError as JaxDecodeError
from lz4tpu.spec.block import Incompressible as JaxIncompressible
from lz4tpu.spec.table import U16Table as JaxU16Table
from lz4tpu.spec.table import U32Table as JaxU32Table

import lz4tpu_torch as lt
from lz4tpu_torch import native
from lz4tpu_torch.frame import decompress as port_decompress
from lz4tpu_torch.kernels.compress import compress_block_cuda
from lz4tpu_torch.native import build as native_build
from lz4tpu_torch.spec.block import DecodeError, Incompressible
from lz4tpu_torch.spec.hc import compress_block_hc as spec_compress_block_hc
from lz4tpu_torch.spec.table import U16Table, U32Table
from lz4tpu_torch.spec.xxhash32 import XXHash32 as SpecXXHash32
from lz4tpu_torch.utils import silesia

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAIN_BLOCK = functools.partial(compress_block_cuda, device="cpu")


def _noise(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


@functools.lru_cache(maxsize=None)
def _source(name: str) -> bytes:
    """About 100 KB of input: a stand-in member, or noise between zero runs."""
    if name == "zero_runs":
        return (b"\0" * 7000 + _noise(81, 5000) + b"\0" * 30_000 + _noise(82, 900)
                + bytes(20_000) + _noise(83, 40_000))
    if name == "noise":
        return _noise(84, 100_000)
    return silesia.member(name, 0.01 if name == "dickens" else 0.002, cache=False)[:100_000]


# ---------------------------------------------------------------------------
# the greedy block compressor
# ---------------------------------------------------------------------------


def _case(kind: str, source: str, cursor: int):
    """(data, tables): 24,000 bytes behind ``cursor`` bytes of prefix, and
    the same encoder table for the port's native engine, the JAX package's
    and the port's plain version.  At cursor 0 the table is fresh; else it
    is what a linked frame's writer leaves: the parse of the 7,000 bytes
    before the prefix and of the prefix, then slid by 7,000 as the window
    forgets them (slots behind the offset saturate to 0)."""
    src = _source(source)
    port = U32Table() if kind == "u32" else U16Table()
    if cursor:
        native.compress_block(src[: 7000 + cursor], 0, port)
        port.slide(7000)
        src = src[7000:]
    twin = JaxU32Table() if kind == "u32" else JaxU16Table()
    twin.dict[:] = port.dict
    twin.offset = port.offset
    return src[: cursor + 24_000], (port, twin, port.copy())


def _compress_outcome(fn, data, cursor, table, accel, cap):
    try:
        return bytes(fn(data, cursor=cursor, table=table, acceleration=accel, cap=cap))
    except (Incompressible, JaxIncompressible):
        return "Incompressible"


@pytest.mark.parametrize("cap", ["none", "last_group", "early"])
@pytest.mark.parametrize("source", ["dickens", "mozilla", "zero_runs"])
@pytest.mark.parametrize("accel", [1, 4, 17])
@pytest.mark.parametrize("cursor", [0, 5000])
@pytest.mark.parametrize("kind", ["u32", "u16"])
def test_compress_block_equals_jax_native_and_plain_version(kind, cursor, accel, source, cap):
    data, (port, _, _) = _case(kind, source, cursor)
    uncapped = native.compress_block(data, cursor, port, acceleration=accel)
    cap = {"none": None, "last_group": len(uncapped) - 1, "early": len(uncapped) // 3}[cap]
    _, (port, twin, plain) = _case(kind, source, cursor)
    got = _compress_outcome(native.compress_block, data, cursor, port, accel, cap)
    assert got == _compress_outcome(jax_native.compress_block, data, cursor, twin, accel, cap)
    assert got == _compress_outcome(PLAIN_BLOCK, data, cursor, plain, accel, cap)
    assert (got == "Incompressible") == (cap is not None)
    for other in (twin, plain):
        assert other.dict.dtype == port.dict.dtype
        np.testing.assert_array_equal(other.dict, port.dict)
        assert other.offset == port.offset


def test_compress_block_contract_edges():
    """A default table by size, ``out`` extended in place, a payload over
    the U16 table's limit refused, an empty block."""
    data = _source("dickens")[:30_000]
    out = bytearray(b"head")
    assert native.compress_block(data, out=out) is out
    assert bytes(out) == b"head" + jax_native.compress_block(data)
    assert native.compress_block(b"") == jax_native.compress_block(b"")
    with pytest.raises(lt.BlockTooBig):
        native.compress_block(bytes(70_000), table=U16Table())
    assert native.compress_bound(1000) == 1000 + 1000 // 255 + 16


# ---------------------------------------------------------------------------
# the HC parse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap", ["none", "exact", "short"])
@pytest.mark.parametrize("source", ["dickens", "zero_runs"])
@pytest.mark.parametrize("level", [2, 3, 9, 12])
def test_compress_block_hc_equals_jax_native_and_spec(level, source, cap):
    # zero runs: from the end of the first run (noise then zeros behind a
    # prefix of both), where the Python parse's chains stay short
    data = _source(source)[6000 if source == "zero_runs" else 0 :][:12_000]
    uncapped = native.compress_block_hc(data, cursor=3000, level=level)
    cap = {"none": None, "exact": len(uncapped), "short": len(uncapped) - 1}[cap]
    outcomes = []
    for fn in (native.compress_block_hc, jax_native.compress_block_hc, spec_compress_block_hc):
        try:
            outcomes.append(bytes(fn(data, cursor=3000, level=level, cap=cap)))
        except (Incompressible, JaxIncompressible):
            outcomes.append("Incompressible")
    assert outcomes[0] == outcomes[1] == outcomes[2]
    assert (outcomes[0] == "Incompressible") == (cap is not None and cap < len(uncapped))
    if cap is None:
        assert native.decompress_block(uncapped, data[:3000]) == data[3000:]


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------


def _decode_outcome(fn, *args, **kw):
    try:
        res = fn(*args, **kw)
    except (DecodeError, JaxDecodeError) as e:
        return "DecodeError", e.kind
    return bytes(res) if not isinstance(res, int) else res


def _streams():
    """(stream, prefix, content) of valid blocks, with and without prefixes."""
    out = []
    for source in ("dickens", "mozilla", "zero_runs"):
        data = _source(source)[:40_000]
        out.append((native.compress_block(data), b"", data))
        prefix = _source("dickens")[-20_000:]
        out.append((native.compress_block(prefix + data, len(prefix), U32Table()), prefix, data))
        out.append((native.compress_block_hc(prefix + data, len(prefix)), prefix, data))
    return out


@pytest.mark.parametrize("limit", ["none", "exact", "one_short", "small"])
def test_decompress_block_equals_jax_native(limit):
    for stream, prefix, data in _streams():
        output_limit = {"none": None, "exact": len(data), "one_short": len(data) - 1,
                        "small": 1000}[limit]
        got = _decode_outcome(native.decompress_block, stream, prefix, output_limit=output_limit)
        assert got == _decode_outcome(jax_native.decompress_block, stream, prefix,
                                      output_limit=output_limit)
        if limit in ("none", "exact"):
            assert got == data
        for size in (len(data), len(data) + 100, len(data) - 1):
            into = np.zeros(size, np.uint8)
            twin = np.zeros(size, np.uint8)
            got = _decode_outcome(native.decompress_block_into, stream, into, prefix,
                                  output_limit)
            assert got == _decode_outcome(jax_native.decompress_block_into, stream, twin,
                                          prefix, output_limit)
            np.testing.assert_array_equal(into, twin)


def _mutate(r: random.Random, stream: bytes) -> bytes:
    b = bytearray(stream)
    action = r.choice(["flip", "byte", "truncate", "insert", "zero_offset", "splice"])
    if action == "flip":
        for _ in range(r.randint(1, 4)):
            b[r.randrange(len(b))] ^= 1 << r.randrange(8)
    elif action == "byte":
        b[r.randrange(len(b))] = r.choice([0x00, 0x0F, 0xF0, 0xFF, r.randrange(256)])
    elif action == "truncate":
        del b[r.randrange(len(b)):]
    elif action == "insert":
        b[r.randrange(len(b)):0] = bytes(r.randrange(256) for _ in range(r.randint(1, 5)))
    elif action == "zero_offset":
        b[: 0] = bytes([0x14]) + b"x" + b"\0\0"
    else:
        k = r.randrange(len(b))
        b[k:k] = b[r.randrange(len(b)):][: r.randint(1, 300)]
    return bytes(b)


@pytest.mark.parametrize("seed", range(8))
def test_decompress_block_mutations_equal_jax_native(seed):
    """200 seeded mutations and truncations (25 a case) behind prefixes and
    under output limits: the same bytes, or the same error kind."""
    r = random.Random(9100 + seed)
    streams = _streams()
    for _ in range(25):
        stream, prefix, data = r.choice(streams)
        bad = _mutate(r, stream)
        prefix = prefix[-r.choice([len(prefix), 300, 0]):] if prefix else b""
        limit = r.choice([None, len(data), 70_000, 4096])
        got = _decode_outcome(native.decompress_block, bad, prefix, output_limit=limit)
        assert got == _decode_outcome(jax_native.decompress_block, bad, prefix,
                                      output_limit=limit)


# ---------------------------------------------------------------------------
# xxHash32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 0x9747B28C])
def test_xxh32_equals_jax_native_and_spec(seed):
    data = _source("mozilla")[:5000]
    for n in [*range(0, 70), 1000, 4999]:
        want = jax_native.xxh32(data[:n], seed)
        assert native.xxh32(data[:n], seed) == want
        assert native.xxh32(memoryview(bytearray(data[:n])), seed) == want
        assert SpecXXHash32(seed).update(data[:n]).digest() == want


@pytest.mark.parametrize("seed", [0, 17])
def test_streaming_xxhash32_equals_one_shot(seed):
    r = random.Random(seed)
    data = _source("dickens")[:50_000]
    for _ in range(20):
        h = native.XXHash32(seed)
        pos = 0
        while pos < len(data):
            step = r.choice([0, 1, 3, 15, 16, 17, 1000, 30_000])
            assert h.update(data[pos : pos + step]) is h
            pos += step
        assert h.digest() == jax_native.xxh32(data, seed) == lt.xxh32(data, seed)


# ---------------------------------------------------------------------------
# frames on "native"
# ---------------------------------------------------------------------------


def _settings(lib, mode, threads=None):
    s = lib.CompressionSettings().engine("native" if threads is not None else "cpu")
    s.block_size(1 << 16)
    if threads is not None:
        s.threads(threads)
    if mode == "linked":
        s.independent_blocks(False)
    elif mode == "dictionary":
        s.dictionary(7, _source("mozilla")[-30_000:])
    elif mode == "block_checksums":
        s.block_checksums(True).content_checksum(False)
    elif mode == "level":
        s.level(9)
    elif mode == "acceleration":
        s.acceleration(6).block_size(1 << 18)
    return s


def _frame_input(mode):
    if mode == "level":
        return _source("dickens")[:40_000]
    return _source("dickens") + _source("zero_runs") + _source("noise")[:30_000]


MODES = ["independent", "linked", "dictionary", "block_checksums", "level", "acceleration"]


@pytest.mark.parametrize("mode", MODES)
def test_native_frames_equal_jax_native_and_cpu_engine(mode):
    data = _frame_input(mode)
    got = _settings(lt, mode, threads=1).compress_bytes(data)
    assert got == _settings(lz4tpu, mode, threads=1).compress_bytes(data)
    assert got == _settings(lt, mode).compress_bytes(data)
    for threads in (4, 0):
        assert _settings(lt, mode, threads=threads).compress_bytes(data) == got
    dictionary = _source("mozilla")[-30_000:] if mode == "dictionary" else b""
    assert lt.decompress_frame(got, dictionary, engine="native") == data
    assert lz4tpu.decompress_frame(got, dictionary=dictionary) == data


@pytest.mark.parametrize("size", [0, 1, 1 << 16, (1 << 16) + 1, 3 << 16])
def test_native_frames_of_edge_sizes(size):
    """No block, one byte, exactly one block, one byte past it, three
    blocks: the same frames as ``lz4tpu``'s native engine on any thread
    count."""
    data = (_source("dickens") * 2)[:size]
    want = _settings(lz4tpu, "independent", threads=1).compress_bytes(data)
    for threads in (1, 4):
        frame = _settings(lt, "independent", threads=threads).compress_bytes(data)
        assert frame == want
        assert lt.decompress_frame(frame, engine="native") == data


def test_threaded_writer_streams_in_frame_order():
    """More blocks than the writer keeps in flight, from a reader that
    returns short reads: the threaded frame equals the serial one."""

    class Trickle:
        def __init__(self, data):
            self.data, self.pos = data, 0

        def read(self, n):
            n = min(n, 5000)
            chunk = self.data[self.pos : self.pos + n]
            self.pos += len(chunk)
            return chunk

    data = b"".join(_source(s)[:60_000] for s in ("dickens", "noise", "zero_runs", "mozilla")) * 3
    out = {}
    for threads in (1, 3):
        sink = io.BytesIO()
        lt.CompressionSettings().engine("native").block_size(1 << 16).threads(
            threads).compress(Trickle(data), sink)
        out[threads] = sink.getvalue()
    assert out[1] == out[3]
    assert lt.decompress_frame(out[3], engine="native") == data


def test_level_takes_the_native_parse_on_every_engine_but_cpu(monkeypatch):
    """``level()`` runs the native HC parse on ``"native"`` and a callable
    engine, ``spec.hc`` on ``"cpu"``; the frames are equal."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    from lz4tpu_torch.frame import compress as port_compress

    monkeypatch.setattr(native, "compress_block_hc", spy("native", native.compress_block_hc))
    monkeypatch.setattr(port_compress, "spec_compress_block_hc",
                        spy("spec", spec_compress_block_hc))
    data = _source("dickens")[:20_000]
    frames = {}
    for engine in ("native", "cpu", PLAIN_BLOCK):
        del calls[:]
        frames[engine] = lt.CompressionSettings().engine(engine).level(9).block_size(
            1 << 16).compress_bytes(data)
        assert set(calls) == {"spec" if engine == "cpu" else "native"}
    assert len(set(frames.values())) == 1


def test_native_engine_needs_no_card(monkeypatch, tmp_path):
    """Without a card the default engine raises, and ``"native"`` runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _source("dickens")[:50_000]
    with pytest.raises(RuntimeError, match="device=None means 'cuda'"):
        lt.CompressionSettings().compress_bytes(data)
    frame = lt.CompressionSettings().engine("native").level(5).compress_bytes(data)
    assert lt.decompress_frame(frame, engine="native") == data
    assert lt.LZ4FrameReader(frame, engine="native").read_all() == data


# ---------------------------------------------------------------------------
# read_all on "native": threaded against the serial reader
# ---------------------------------------------------------------------------


def _blocks(frame: bytes):
    """[(offset of the length field, payload length)] of an LZ4 frame."""
    flg = frame[4]
    pos = 7 + (8 if flg & 0x08 else 0) + (4 if flg & 0x01 else 0)
    out = []
    while (ln := int.from_bytes(frame[pos : pos + 4], "little")) != 0:
        out.append((pos, ln & 0x7FFFFFFF))
        pos += 4 + (ln & 0x7FFFFFFF) + (4 if flg & 0x10 else 0)
    return out


def _replace_block(frame: bytearray, k: int, payload: bytes) -> None:
    """Block ``k`` becomes the compressed ``payload`` (checksum made valid)."""
    pos, ln = _blocks(bytes(frame))[k]
    checked = bool(frame[4] & 0x10)
    tail = frame[pos + 4 + ln + (4 if checked else 0):]
    frame[pos:] = len(payload).to_bytes(4, "little") + payload
    if checked:
        frame.extend(native.xxh32(payload).to_bytes(4, "little"))
    frame.extend(tail)


def _outcome(fn):
    try:
        return fn()
    except lt.LZ4Error as e:
        return type(e).__name__, getattr(e, "kind", None)


def _serial(frame, dictionary=b""):
    """The port's serial reader: the per-block loop on the native engine."""
    def loop():
        reader = lt.LZ4FrameReader(frame, engine="native")
        parts = []
        while (block := reader.decode_block(dictionary)) is not None:
            parts.append(block)
        return b"".join(parts)
    return _outcome(loop)


def _threaded(frame, monkeypatch, dictionary=b""):
    monkeypatch.setenv("LZ4TPU_HOST_THREADS", "4")
    return _outcome(lambda: lt.decompress_frame(frame, dictionary, engine="native"))


def _jax_serial(frame, dictionary=b""):
    def loop():
        reader = JaxFrameReader(frame, engine="native")
        parts = []
        while (block := reader.decode_block(dictionary)) is not None:
            parts.append(block)
        return b"".join(parts)
    try:
        return loop()
    except lz4tpu.LZ4Error as e:
        return type(e).__name__, getattr(e, "kind", None)


def _seq(lit: bytes = b"", offset: int = 0, ml: int = 0) -> bytes:
    """One sequence: ``lit`` then a match of ``ml`` bytes at ``offset``
    (``offset`` 0: a last, literal-only sequence)."""
    def lsic(v):
        return b"\xff" * ((v - 15) // 255) + bytes([(v - 15) % 255]) if v >= 15 else b""
    ml_code = ml - 4 if offset else 0
    token = (min(len(lit), 15) << 4) | min(ml_code, 15)
    out = bytes([token]) + lsic(len(lit)) + lit
    if offset:
        out += offset.to_bytes(2, "little") + lsic(ml_code)
    return out


# a block of a 64 KiB frame: 65,530 bytes from a run, then what follows
OVERFLOW = _seq(b"0123456789", 1, 65_520)
HOSTILE = {
    # literals past block_maxsize: the serial reader decodes, then refuses
    "literals_past_maxsize": (OVERFLOW + _seq(b"L" * 100), "BlockSizeOverflow", None),
    # past its slot, then a match: the decoder's memory limit
    "literals_past_maxsize_then_match": (OVERFLOW + _seq(b"L" * 100, 3, 20),
                                         "CodecError", "memory_limit_exceeded"),
    # past its slot, then cut inside a match length
    "literals_past_maxsize_then_truncated": (OVERFLOW + _seq(b"L" * 100, 3, 20)[:-1],
                                             "CodecError", "unexpected_end"),
    "match_past_maxsize": (_seq(b"ab", 1, 70_000), "CodecError", "memory_limit_exceeded"),
    "offset_before_start": (_seq(b"abc", 9, 40), "CodecError", "invalid_deduplication_offset"),
    "zero_offset": (_seq(b"abc", 0xFFFF, 40)[:-3] + b"\0\0\0", "CodecError",
                    "zero_deduplication_offset"),
}


@pytest.mark.parametrize("checked", [False, True], ids=["plain", "block_checksums"])
@pytest.mark.parametrize("name", sorted(HOSTILE))
def test_threaded_read_all_hostile_block_follows_the_serial_reader(name, checked, monkeypatch):
    """A hostile block among valid ones raises the serial reader's error
    type and kind (``lz4tpu``'s threaded reader maps a block past its
    output slot to ``BlockSizeOverflow`` whatever follows; the port's does
    not)."""
    payload, kind, sub = HOSTILE[name]
    s = lt.CompressionSettings().engine("native").block_size(1 << 16).block_checksums(checked)
    frame = bytearray(s.compress_bytes(_frame_input("independent")))
    _replace_block(frame, 2, payload)
    frame = bytes(frame)
    want = _serial(frame)
    assert want == (kind, sub)
    assert _threaded(frame, monkeypatch) == want
    assert _jax_serial(frame) == want


@pytest.mark.parametrize("seed", range(12))
def test_threaded_read_all_mutations_follow_the_serial_reader(seed, monkeypatch):
    """Seeded mutations and truncations of independent frames (with block
    checksums for odd seeds): the same bytes, or the same error type and
    kind as the serial reader."""
    r = random.Random(9300 + seed)
    s = lt.CompressionSettings().engine("native").block_size(1 << 16).block_checksums(seed % 2)
    frame = bytearray(s.compress_bytes(_frame_input("independent")[seed * 1000 :]))
    for _ in range(r.randint(1, 3)):
        blocks = _blocks(bytes(frame))
        if not blocks:
            break
        pos, ln = r.choice(blocks)
        action = r.choice(["payload", "length", "flip", "truncate", "store"])
        if action == "payload":
            for _ in range(6):
                frame[pos + 4 + r.randrange(ln // 2, ln)] = r.randrange(256)
        elif action == "length":
            frame[pos : pos + 4] = (ln + r.choice([-3, 1, 1 << 16])).to_bytes(4, "little")
        elif action == "flip":
            frame[r.randrange(len(frame))] ^= 1 << r.randrange(8)
        elif action == "store":
            frame[pos + 3] |= 0x80
        else:
            del frame[r.randrange(len(frame) - 1):]
            break
    frame = bytes(frame)
    assert _threaded(frame, monkeypatch) == _serial(frame) == _jax_serial(frame)


@pytest.mark.parametrize("mode", ["independent", "dictionary", "block_checksums", "linked"])
def test_threaded_read_all_equals_serial(mode, monkeypatch):
    """Valid frames: the thread pool's content is the serial reader's; a
    linked frame and a single thread take the serial loop."""
    data = _frame_input(mode)
    dictionary = _source("mozilla")[-30_000:] if mode == "dictionary" else b""
    frame = _settings(lt, mode, threads=1).compress_bytes(data)
    pools = []
    real = port_decompress._decode_native

    def spy(blocks, block_maxsize, dic, nthreads):
        pools.append(nthreads)
        return real(blocks, block_maxsize, dic, nthreads)

    monkeypatch.setattr(port_decompress, "_decode_native", spy)
    assert _threaded(frame, monkeypatch, dictionary) == data == _serial(frame, dictionary)
    assert pools == ([] if mode == "linked" else [4])
    monkeypatch.setenv("LZ4TPU_HOST_THREADS", "1")
    assert lt.decompress_frame(frame, dictionary, engine="native") == data
    assert len(pools) == (0 if mode == "linked" else 1)


def test_threaded_read_all_slots_reuse_and_cap(monkeypatch):
    """Frames decoded one after another on one thread reuse its warm slots
    (stale bytes of a larger frame never leak into a smaller one's
    content); past ``POOLED_BYTES`` a frame gets slots of its own."""
    monkeypatch.setenv("LZ4TPU_HOST_THREADS", "3")
    s = lt.CompressionSettings().engine("native").block_size(1 << 16)
    inputs = [_frame_input("independent"), _source("zero_runs")[:70_000], b"tail" * 9,
              _source("noise")[:200_000]]
    for data in inputs:
        assert lt.decompress_frame(s.compress_bytes(data), engine="native") == data
    monkeypatch.setattr(port_decompress, "POOLED_BYTES", 1 << 16)
    for data in inputs:
        assert lt.decompress_frame(s.compress_bytes(data), engine="native") == data


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------


def test_build_is_cached_and_a_failed_build_raises(monkeypatch, tmp_path):
    lib = native_build.build()
    assert lib.parent.name == "_build" and lib.parent.parent.name == "lz4tpu_torch"
    assert native_build.build() == lib
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "_SRC", broken)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="the build failed"):
        native_build.build()
    assert not list((tmp_path / "_build").glob("*.so"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native_build.build()


def test_concurrent_builds_leave_one_library(tmp_path):
    """Processes that build at once into an empty directory each load a
    library (the temporary file is moved into place)."""
    code = (
        "import sys, pathlib\n"
        "from lz4tpu_torch.native import build\n"
        "build.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "import ctypes\n"
        "print(ctypes.CDLL(str(build.build())).lz4t_xxh32_state_size())\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len(list(tmp_path.glob("liblz4t_native-*.so"))) == 1
    assert not list(tmp_path.glob("tmp-*"))
