"""The reference's own streaming API in the port, on the CPU (the kernels'
plain versions), against the JAX package: the batched independent-block
writer and ``level()`` byte-equal to ``lz4tpu``'s native serial writer, the
port's HC parse byte-equal to ``lz4tpu.spec.hc``, the batched ``read_all``
raising the serial reader's error type and kind on corrupted frames,
``into_read`` piece for piece, and the writer against the C library.  A byte
codec has no tolerance: every comparison is byte equality or the same error
type and kind."""

import functools
import random

import pytest

import lz4tpu
from lz4tpu.frame.decompress import LZ4FrameReader as JaxFrameReader
from lz4tpu.spec.block import compress_block
from lz4tpu.spec.hc import compress_block_hc as jax_compress_block_hc
from lz4tpu.spec.table import U32Table

import lz4tpu_torch as lt
from lz4tpu_torch import interop
from lz4tpu_torch.frame import compress as port_compress
from lz4tpu_torch.frame import decompress as port_decompress
from lz4tpu_torch.kernels.compress import compress_block_cuda
from lz4tpu_torch.spec.block import Incompressible

CPU_BLOCK = functools.partial(compress_block_cuda, device="cpu")


def _noise(seed: int, n: int) -> bytes:
    return random.Random(seed).randbytes(n)


def _settings(lib, block_size, dictionary=None, block_checksums=False, content_checksum=True,
              acceleration=1, level=None, linked=False):
    s = (lib.CompressionSettings().block_size(block_size).block_checksums(block_checksums)
         .content_checksum(content_checksum).acceleration(acceleration).level(level)
         .independent_blocks(not linked))
    if dictionary is not None:
        s.dictionary(5, dictionary)
    return s


def _native(**kw):
    return _settings(lz4tpu, **kw).engine("native").threads(1)


# ---------------------------------------------------------------------------
# the batched independent-block writer
# ---------------------------------------------------------------------------

WRITER_CASES = {
    "default": {},
    "dictionary_12k": {"dictionary": 12 * 1024},
    "dictionary_90k": {"dictionary": 90 * 1024},
    "block_checksums": {"block_checksums": True},
    "no_content_checksum": {"content_checksum": False},
    "acceleration_5": {"acceleration": 5},
}


@pytest.mark.parametrize("block_size", [1 << 16, 1 << 18])
@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_batched_writer_equals_native_serial_writer(case, block_size, corpus_sample):
    kw = dict(WRITER_CASES[case], block_size=block_size)
    if "dictionary" in kw:
        kw["dictionary"] = corpus_sample(4001, kw["dictionary"])
    data = corpus_sample(4000, 330_000) + _noise(4002, 70_000)
    want = _native(**kw).compress_bytes(data)
    got = _settings(lt, **kw).engine("cpu").compress_bytes(data)
    assert got == want
    # the port's own per-block loop, through a callable engine
    assert _settings(lt, **kw).engine(CPU_BLOCK).compress_bytes(data) == want
    assert lt.decompress_frame(got, dictionary=kw.get("dictionary") or b"", engine="cpu") == data


@pytest.mark.parametrize("payload", ["incompressible", "empty", "one_byte"])
def test_batched_writer_edge_inputs(payload, corpus_sample):
    data = {"incompressible": _noise(4100, 150_000), "empty": b"", "one_byte": b"x"}[payload]
    for with_size in (True, False):
        want = _native(block_size=1 << 16).compress_bytes(data, with_size=with_size)
        got = _settings(lt, block_size=1 << 16).engine("cpu").compress_bytes(data,
                                                                             with_size=with_size)
        assert got == want
        assert lt.decompress_frame(got, engine="cpu") == data


def test_batched_writer_streams_in_batches(monkeypatch, corpus_sample):
    """An input over the batch budget goes through several launches, one a
    batch, and the frame does not change."""
    data = corpus_sample(4200, 300_000) + _noise(4201, 40_000)
    dic = corpus_sample(4202, 20_000)
    want = _native(block_size=1 << 16, dictionary=dic, block_checksums=True).compress_bytes(data)
    batches = []
    real = port_compress.scalar_dispatch

    def spy(src, *args):
        batches.append(src.numel())
        return real(src, *args)

    monkeypatch.setattr(port_compress, "BATCH_BYTES", 2 << 16)
    monkeypatch.setattr(port_compress, "scalar_dispatch", spy)
    s = _settings(lt, block_size=1 << 16, dictionary=dic, block_checksums=True).engine("cpu")
    assert s.compress_bytes(data) == want
    assert batches == [2 << 16] * 2 + [len(data) - (4 << 16)]


def test_linked_frames_keep_the_per_block_loop(monkeypatch, corpus_sample):
    data = corpus_sample(4300, 200_000)
    monkeypatch.setattr(port_compress, "scalar_dispatch", None)  # never reached
    got = _settings(lt, block_size=1 << 16, linked=True).engine("cpu").compress_bytes(data)
    assert got == _native(block_size=1 << 16, linked=True).compress_bytes(data)


# ---------------------------------------------------------------------------
# level(): the host HC parse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", [2, 3, 9, 12])
def test_level_frames_equal_native(level, corpus_sample):
    data = corpus_sample(4400 + level, 45_000) + _noise(4399, 2000) + corpus_sample(4398, 25_000)
    dic = corpus_sample(4397, 10_000)
    for kw in ({"dictionary": dic, "block_checksums": True}, {"linked": True}):
        want = _native(block_size=1 << 16, level=level, **kw).compress_bytes(data)
        got = _settings(lt, block_size=1 << 16, level=level, **kw).engine("cpu").compress_bytes(data)
        assert got == want, kw
        assert lt.decompress_frame(got, dictionary=kw.get("dictionary", b""), engine="cpu") == data
    assert len(got) <= len(_settings(lt, block_size=1 << 16, linked=True).engine("cpu")
                           .compress_bytes(data))


@pytest.mark.parametrize("level", [2, 3, 9, 12])
@pytest.mark.parametrize("prefix", [0, 5000, 70_000])
def test_compress_block_hc_equals_jax_package(level, prefix, corpus_sample):
    data = corpus_sample(4500 + prefix, prefix) + corpus_sample(4501, 8_000) + _noise(4502, 500)
    want = bytes(jax_compress_block_hc(data, cursor=prefix, level=level))
    assert bytes(lt.compress_block_hc(data, cursor=prefix, level=level)) == want
    # the same caps: one byte short of the output raises, the exact size does not
    with pytest.raises(Incompressible):
        lt.compress_block_hc(data, cursor=prefix, level=level, cap=len(want) - 1)
    assert bytes(lt.compress_block_hc(data, cursor=prefix, level=level, cap=len(want))) == want
    assert lt.decompress_block(want, prefix=data[:prefix], device="cpu") == data[prefix:]


# ---------------------------------------------------------------------------
# the batched read_all
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block_size,kw", [
    (1 << 16, {}),
    (1 << 16, {"block_checksums": True, "dictionary": "dict"}),
    (1 << 18, {"block_checksums": True}),
    (1 << 22, {"content_checksum": False}),
], ids=["64k", "64k-dict-checksums", "256k-checksums", "4m-no-content-checksum"])
def test_batched_read_all_decodes_jax_frames_in_one_launch(block_size, kw, monkeypatch,
                                                           corpus_sample):
    data = corpus_sample(4600, 280_000) + _noise(4601, 70_000) + corpus_sample(4602, 30_000)
    dic = corpus_sample(4603, 70_000)
    kw = dict(kw)
    if kw.pop("dictionary", None):
        kw["dictionary"] = dic
    frame = _native(block_size=block_size, **kw).compress_bytes(data)
    launches = []
    real = port_decompress.decode_payloads

    def spy(payloads, *args):
        launches.append(len(payloads))
        return real(payloads, *args)

    monkeypatch.setattr(port_decompress, "decode_payloads", spy)
    got = lt.LZ4FrameReader(frame, engine="cpu").read_all(kw.get("dictionary", b""))
    assert got == data
    assert len(launches) == 1 and launches[0] >= 1


def _blocks(frame: bytes):
    """[(offset of the length field, payload length)] of an LZ4 frame."""
    flg = frame[4]
    pos = 7 + (8 if flg & 0x08 else 0) + (4 if flg & 0x01 else 0)
    out = []
    while True:
        ln = int.from_bytes(frame[pos:pos + 4], "little")
        if ln == 0:
            return out
        out.append((pos, ln & 0x7FFFFFFF))
        pos += 4 + (ln & 0x7FFFFFFF) + (4 if flg & 0x10 else 0)


def _fix_checksum(frame: bytearray, k: int) -> None:
    pos, ln = _blocks(bytes(frame))[k]
    payload = bytes(frame[pos + 4:pos + 4 + ln])
    frame[pos + 4 + ln:pos + 8 + ln] = lz4tpu.xxh32(payload).to_bytes(4, "little")


def _corrupt(frame: bytearray, k: int, r: random.Random, fix=True) -> None:
    """Scramble the tail of block ``k``'s payload (a decode error, with its
    block checksum made valid again unless ``fix`` is false)."""
    pos, ln = _blocks(bytes(frame))[k]
    for _ in range(8):
        frame[pos + 4 + r.randrange(ln // 2, ln)] = r.randrange(256)
    if fix:
        _fix_checksum(frame, k)


def _serial_outcome(frame, dictionary=b""):
    """The JAX package's SERIAL reader: an explicit decode_block loop."""
    try:
        reader = JaxFrameReader(frame, engine="native")
        parts = []
        while (block := reader.decode_block(dictionary)) is not None:
            parts.append(block)
    except lz4tpu.LZ4Error as e:
        return type(e).__name__, getattr(e, "kind", None)
    return b"".join(parts)


def _port_outcome(frame, dictionary=b""):
    try:
        return lt.LZ4FrameReader(frame, engine="cpu").read_all(dictionary)
    except lt.LZ4Error as e:
        return type(e).__name__, getattr(e, "kind", None)


def _checked_frame(corpus_sample, seed=4700):
    data = corpus_sample(seed, 250_000) + _noise(seed + 1, 20_000) + corpus_sample(seed + 2, 60_000)
    return bytearray(_native(block_size=1 << 16, block_checksums=True).compress_bytes(data)), data


def _named_case(name, corpus_sample):
    frame, _ = _checked_frame(corpus_sample)
    r = random.Random(len(name))
    if name == "corrupt_block0_truncated_later":
        _corrupt(frame, 0, r)
        pos, _ = _blocks(bytes(frame))[3]
        return bytes(frame[:pos + 100])
    if name == "bad_checksum_block2_corrupt_block3":
        _corrupt(frame, 3, r)
        pos, ln = _blocks(bytes(frame))[2]
        frame[pos + 4 + ln] ^= 0x5A
        return bytes(frame)
    if name == "block_needs_more_than_maxsize":
        # block 1 replaced by a match that runs past 64 KiB of output
        big = bytes(compress_block(b"z" * 70_000, 0, U32Table()))
        pos, ln = _blocks(bytes(frame))[1]
        tail = frame[pos + 8 + ln:]
        frame[pos:] = len(big).to_bytes(4, "little") + big + b"\0\0\0\0" + tail
        _fix_checksum(frame, 1)
        return bytes(frame)
    raise KeyError(name)


NAMED = {
    "corrupt_block0_truncated_later": "CodecError",
    "bad_checksum_block2_corrupt_block3": "BlockChecksumFail",
    "block_needs_more_than_maxsize": "CodecError",
}


@pytest.mark.parametrize("name", sorted(NAMED))
def test_batched_read_all_named_errors_follow_the_serial_reader(name, corpus_sample):
    frame = _named_case(name, corpus_sample)
    want = _serial_outcome(frame)
    assert isinstance(want, tuple) and want[0] == NAMED[name]
    if name == "block_needs_more_than_maxsize":
        assert want == ("CodecError", "memory_limit_exceeded")
    assert _port_outcome(frame) == want


@pytest.mark.parametrize("seed", range(16))
def test_batched_read_all_mutations_follow_the_serial_reader(seed, corpus_sample):
    """Seeded mutations and truncations of an independent frame with block
    checksums: the same bytes, or the same error type and kind."""
    r = random.Random(5000 + seed)
    frame, _ = _checked_frame(corpus_sample, 4800 + seed % 4)
    n = len(_blocks(bytes(frame)))
    for _ in range(r.randint(1, 3)):
        action = r.choice(["corrupt", "corrupt_raw", "length", "flip", "truncate", "store"])
        blocks = _blocks(bytes(frame))
        k = r.randrange(min(n, len(blocks)))
        pos, ln = blocks[k]
        if action == "corrupt":
            _corrupt(frame, k, r)
        elif action == "corrupt_raw":
            _corrupt(frame, k, r, fix=False)
        elif action == "length":
            frame[pos:pos + 4] = (ln + r.choice([-3, 1, 1 << 16, 70_000])).to_bytes(4, "little")
        elif action == "flip":
            frame[r.randrange(len(frame))] ^= 1 << r.randrange(8)
        elif action == "store":  # the compressed payload declared stored
            frame[pos + 3] |= 0x80
            _fix_checksum(frame, k)
        else:
            del frame[r.randrange(len(frame) - 1):]
            break
    frame = bytes(frame)
    assert _port_outcome(frame) == _serial_outcome(frame)


# ---------------------------------------------------------------------------
# into_read and the crate-root names
# ---------------------------------------------------------------------------


def test_into_read_equals_jax_io_reader_piece_for_piece(corpus_sample):
    data = corpus_sample(4900, 200_000)
    dic = corpus_sample(4901, 30_000)
    for linked in (False, True):
        frame = _native(block_size=1 << 16, dictionary=dic, linked=linked).compress_bytes(data)
        ours = lt.LZ4FrameReader(frame, engine="cpu").into_read(dic)
        theirs = JaxFrameReader(frame, engine="native").into_read(dic)
        assert isinstance(ours, lt.LZ4FrameIoReader) and ours.readable()
        r = random.Random(4902)
        while True:
            n = r.choice([1, 7, 4093, 65537, 100_003])
            a, b = ours.read(n), theirs.read(n)
            assert a == b
            if not a:
                break
            if r.random() < 0.1:
                assert ours.read(-1) == theirs.read(-1)
                assert ours.read(5) == theirs.read(5) == b""
                break


def test_crate_root_names():
    for name in ("LZ4FrameIoReader", "XXHash32", "xxh32", "compress_block_hc", "compress_block",
                 "decompress_block"):
        assert name in lt.__all__
    data = b"the crate root's block codec " * 200
    want = bytes(compress_block(data))
    assert lt.compress_block(data, device="cpu") == want
    assert lt.decompress_block(want, output_limit=len(data), device="cpu") == data
    assert lt.xxh32(data) == lz4tpu.xxh32(data)
    assert lt.XXHash32(7).update(data[:33]).update(data[33:]).digest() == lz4tpu.xxh32(data, 7)


# ---------------------------------------------------------------------------
# against the C library
# ---------------------------------------------------------------------------

LIBLZ4_CELLS = {
    "linked_64k": dict(block_size=1 << 16, linked=True),
    "linked_256k": dict(block_size=1 << 18, linked=True),
    "linked_4m_content_size": dict(block_size=1 << 22, linked=True, content_size=True),
    "independent_4m": dict(block_size=1 << 22),
    "independent_4m_no_content_checksum": dict(block_size=1 << 22, content_checksum=False),
    "dictionary_independent": dict(block_size=1 << 22, dictionary=True),
    "dictionary_linked": dict(block_size=1 << 22, dictionary=True, linked=True),
    "block_checksums": dict(block_size=1 << 22, block_checksums=True),
}


# linked 64 KiB blocks: the lineage's frames (``lz4tpu``'s and so the port's)
# differ from liblz4 1.9.4 on this input from block 1 on, though
# ``tests/test_interop.py`` finds them equal on its own input; both stay
# valid LZ4 in both directions
KNOWN_DIFFERENT = {"linked_64k"}


@pytest.mark.parametrize("cell", sorted(LIBLZ4_CELLS))
def test_cpu_writer_equals_liblz4(cell, corpus_sample):
    if not interop.available():
        pytest.skip("liblz4 is not installed")
    kw = dict(LIBLZ4_CELLS[cell])
    data = corpus_sample(5100, 250_000) + _noise(5101, 20_000) + corpus_sample(5102, 50_000)
    dic = corpus_sample(5103, 65_536) if kw.pop("dictionary", False) else None
    linked = kw.pop("linked", False)
    content_size = kw.pop("content_size", False)
    theirs = interop.lz4f_compress_frame_streaming(
        data, independent_blocks=not linked, content_size=content_size, dictionary=dic,
        dictionary_id=5 if dic is not None else None, **kw)
    ours = _settings(lt, dictionary=dic, linked=linked, **kw).engine("cpu").compress_bytes(
        data, with_size=content_size)
    if cell in KNOWN_DIFFERENT:
        assert ours == _native(dictionary=dic, linked=linked, **kw).compress_bytes(
            data, with_size=content_size)
        assert ours != theirs  # if this starts failing, move the cell out of KNOWN_DIFFERENT
    else:
        assert ours == theirs
    assert interop.lz4f_decompress_frame(ours, dictionary=dic) == data
    assert lt.decompress_frame(theirs, dictionary=dic or b"", engine="cpu") == data
