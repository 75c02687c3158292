"""Linked frames through the port (plain versions on the CPU) against the
JAX package: wave decode of many frames (``decompress_frames_parallel``)
on the frames of ``tests/test_frames_parallel.py``, and ``parallel_linked``
compression against the JAX package's scalar linked path.  Everything is
byte-exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

import lz4tpu_torch as lt
from lz4tpu import CompressionSettings, decompress_frame
from lz4tpu.frame.errors import FrameChecksumFail as JaxFrameChecksumFail
from lz4tpu.parallel.mesh import make_mesh
from lz4tpu.parallel.pipeline import _compress_sharded, _pad_blocks
from lz4tpu.parallel.pipeline import decompress_frames_parallel as jax_frames_parallel
from lz4tpu_torch.frame.errors import BlockSizeOverflow, FrameChecksumFail
from lz4tpu_torch.frame.format import scan_frame
from lz4tpu_torch.parallel import blocks

from conftest import make_corpus_sample


def _settings(block_size=1 << 16, linked=True):
    return (CompressionSettings().engine("native").block_size(block_size)
            .independent_blocks(not linked))


def _two_block_data(seed, tail):
    """Just over 64 KiB: a first block that is cheap for the JAX package's
    interpreted lockstep decoder (a 3,000-byte period, so few sequences)
    and ``tail`` bytes of mixed data across the block boundary, whose
    second part matches into the carry-over window."""
    return (make_corpus_sample(seed, 3000) * 20)[:60_000] + make_corpus_sample(seed + 50, tail)


def _wave_frames():
    """The frame kinds of ``tests/test_frames_parallel.py`` at 64 KiB
    blocks, by name: (frames, data, dictionaries)."""
    cases = {}
    datas = [_two_block_data(1103 + s, 12_000 + s * 3000) for s in range(2)]
    cases["linked"] = ([_settings().compress_bytes(d) for d in datas], datas, [None, None])
    frames, datas, dicts = [], [], []
    for s in range(2):
        dic = make_corpus_sample(1300 + s, 6000)
        data = dic[:2000] + make_corpus_sample(1400 + s, 25_000) + dic[1000:4000]
        frames.append(_settings().dictionary(s + 1, dic).compress_bytes(data))
        datas.append(data)
        dicts.append(dic)
    cases["linked_with_dictionaries"] = (frames, datas, dicts)
    frames, datas = [], []
    for s in range(4):
        data = make_corpus_sample(1500 + s, 20_000)
        frames.append(_settings(linked=s % 2 == 1).block_checksums(s == 1).compress_bytes(data))
        datas.append(data)
    cases["mixed_with_checksums"] = (frames, datas, [None] * 4)
    # a stored block opens the chain: its bytes enter the window, and the
    # block after it matches into them
    r = random.Random(77)
    noise = bytes(r.getrandbits(8) for _ in range(65536))
    data = noise + noise[-30_000:] + make_corpus_sample(1601, 3000)
    cases["stored_block"] = ([_settings().compress_bytes(data)], [data], [None])
    return cases


@pytest.fixture(scope="module")
def waves():
    """Every 64 KiB-block case decoded in one call of each package (a wave
    costs the JAX package's interpreted decoder the same whatever the
    number of frames in it)."""
    cases = _wave_frames()
    frames = [f for c in cases.values() for f in c[0]]
    dicts = [d for c in cases.values() for d in c[2]]
    want = jax_frames_parallel(frames, mesh=make_mesh(1), dictionaries=dicts)
    got = lt.decompress_frames_parallel(frames, device="cpu", dictionaries=dicts)
    spans, pos = {}, 0
    for name, c in cases.items():
        spans[name] = slice(pos, pos + len(c[0]))
        pos += len(c[0])
    return cases, spans, want, got


@pytest.mark.parametrize("name", ["linked", "linked_with_dictionaries", "mixed_with_checksums",
                                  "stored_block"])
def test_wave_decode_matches_jax_frames_parallel(name, waves):
    cases, spans, want, got = waves
    assert got[spans[name]] == want[spans[name]] == cases[name][1]


def test_stored_block_case_holds_a_stored_block(waves):
    frame = waves[0]["stored_block"][0][0]
    reader = lt.LZ4FrameReader(frame, engine="cpu")
    kinds = [compressed for compressed, _, _ in scan_frame(reader)[0]]
    assert kinds == [False, True]
    assert lt.decompress_frame(frame, engine="cpu") == waves[0]["stored_block"][1][0]


def test_big_linked_blocks_match_jax_frames_parallel(corpus_sample):
    datas = [corpus_sample(2200 + s, 600_000 + s * 120_000) for s in range(3)]
    frames = [_settings(1 << 18).compress_bytes(d) for d in datas]
    want = jax_frames_parallel(frames, mesh=make_mesh(1))
    assert lt.decompress_frames_parallel(frames, device="cpu") == want == datas


def test_corrupted_content_checksum_raises_as_in_jax(corpus_sample):
    frame = bytearray(_settings().compress_bytes(corpus_sample(1501, 20_000)))
    frame[-1] ^= 0xFF
    with pytest.raises(JaxFrameChecksumFail):
        jax_frames_parallel([bytes(frame)], mesh=make_mesh(1))
    with pytest.raises(FrameChecksumFail):
        lt.decompress_frames_parallel([bytes(frame)], device="cpu")
    assert len(lt.decompress_frames_parallel([bytes(frame)], device="cpu",
                                             verify_checksums=False)[0]) == 20_000


def test_waves_route_by_block_size_and_skip_the_serial_reader(corpus_sample, monkeypatch):
    calls = []
    for name in ("decode128", "decode_big", "decode_v4"):
        orig = getattr(blocks, name)

        def spy(comp, *a, _orig=orig, _name=name, **k):
            calls.append((_name, comp.shape[0]))
            return _orig(comp, *a, **k)

        monkeypatch.setattr(blocks, name, spy)

    def no_serial(*a, **k):
        raise AssertionError("a linked frame reached the serial reader")

    monkeypatch.setattr(lt.LZ4FrameReader, "decode_block", no_serial)
    small = [corpus_sample(1700 + s, 70_000 + 66_000 * s) for s in range(2)]  # 2 and 3 blocks
    frames = [_settings().compress_bytes(d) for d in small]
    assert lt.decompress_frames_parallel(frames, device="cpu") == small
    assert calls == [("decode128", 2), ("decode128", 2), ("decode128", 1)]
    calls.clear()
    big = corpus_sample(1710, 300_000)
    frames.append(_settings(1 << 18).compress_bytes(big))
    assert lt.decompress_frames_parallel(frames, device="cpu") == small + [big]
    assert calls == [("decode_big", 3), ("decode_big", 3), ("decode128", 1)]


def test_block_past_its_own_frames_maxsize_overflows(corpus_sample):
    """In a wave the memory limit is the largest block_maxsize of the wave;
    each block is still held to its own frame's."""
    raw = corpus_sample(1800, 100_000)
    block = bytes(lt.compress_block_cuda(raw, device="cpu"))
    head = _settings().content_checksum(False).compress_bytes(b"", with_size=False)[:-4]
    small = head + len(block).to_bytes(4, "little") + block + b"\x00" * 4
    big = _settings(1 << 18).compress_bytes(corpus_sample(1801, 50_000))
    with pytest.raises(BlockSizeOverflow):
        lt.decompress_frames_parallel([small, big], device="cpu")
    with pytest.raises(lt.DecodeError):  # alone, the limit is its own 64 KiB
        lt.decompress_frames_parallel([small], device="cpu")


def test_dictionaries_must_pair_with_frames():
    with pytest.raises(ValueError, match="dictionaries"):
        lt.decompress_frames_parallel([b""], device="cpu", dictionaries=[])


# ---------------------------------------------------------------------------
# parallel_linked compression
# ---------------------------------------------------------------------------


def jax_linked_payloads(data, dictionary):
    """Per-block output of the JAX package's scalar linked path at 64 KiB
    blocks and a 64 KiB window, on a one-device mesh in interpret mode
    (``None`` where the block is stored)."""
    arr, lens, n_blocks = _pad_blocks(data, 65536)
    out, out_len, status = _compress_sharded(
        jnp.asarray(arr), jnp.asarray(lens), jnp.asarray(np.zeros((n_blocks, 4096), np.int32)),
        jnp.asarray(np.frombuffer(dictionary or b"\x00", np.uint8)),
        jnp.asarray(np.array([len(dictionary or b"")], np.int32)),
        mesh=make_mesh(1), block_size=65536, window=65536, acceleration=1, u16_table=False,
        has_dict=bool(dictionary),
    )
    out, out_len, status = np.asarray(out), np.asarray(out_len), np.asarray(status)
    return [None if status[i] else out[i, : out_len[i]].tobytes() for i in range(n_blocks)]


def frame_payloads(frame):
    reader = lt.LZ4FrameReader(frame, engine="cpu")
    return reader, [p if c else None for c, p, _ in scan_frame(reader)[0]]


@pytest.mark.parametrize("dict_len", [0, 65536, 10_000], ids=["no_dict", "dict_64k", "dict_10000"])
def test_parallel_linked_matches_jax_scalar_linked_path(dict_len, corpus_sample):
    r = random.Random(3)
    # blocks 0 and 1 compress, block 2 is noise (stored), block 3 is short
    data = (corpus_sample(4100, 131_072) + bytes(r.getrandbits(8) for _ in range(65536))
            + corpus_sample(4103, 20_000))
    dic = corpus_sample(4101, dict_len) if dict_len else None
    frame = lt.compress_frame_parallel(data, 65536, device="cpu", parallel_linked=True,
                                       dictionary=dic, dictionary_id=9 if dic else None)
    reader, got = frame_payloads(frame)
    want = jax_linked_payloads(data, dic)
    assert got == want
    assert None in want and sum(p is not None for p in want) >= 3
    assert not reader.flags.independent_blocks
    assert decompress_frame(frame, dictionary=dic or b"", engine="native") == data
    assert lt.decompress_frames_parallel([frame], device="cpu", dictionaries=[dic]) == [data]
    if not dic:
        independent = lt.compress_frame_parallel(data, 65536, device="cpu")
        assert len(frame) <= len(independent)


def test_parallel_linked_big_blocks_and_options(corpus_sample):
    data = corpus_sample(4200, 700_000)
    frame = lt.compress_frame_parallel(data, 1 << 18, device="cpu", parallel_linked=True,
                                       block_checksums=True, acceleration=4,
                                       with_content_size=False)
    reader = lt.LZ4FrameReader(frame, engine="cpu")
    assert (reader.block_maxsize, reader.content_size) == (1 << 18, None)
    assert reader.flags.block_checksums and not reader.flags.independent_blocks
    assert decompress_frame(frame, engine="native") == data
    assert lt.decompress_frame_parallel(frame, device="cpu") == data
    assert len(frame) <= len(lt.compress_frame_parallel(data, 1 << 18, device="cpu",
                                                        block_checksums=True, acceleration=4,
                                                        with_content_size=False))


@pytest.mark.parametrize("data", [b"", b"x", b"abc" * 100], ids=["empty", "one_byte", "short"])
def test_parallel_linked_small_inputs(data):
    frame = lt.compress_frame_parallel(data, device="cpu", parallel_linked=True)
    assert decompress_frame(frame, engine="native") == data
    assert lt.decompress_frames_parallel([frame], device="cpu") == [data]


def test_lane_kernel_still_raises():
    """Its name is from the slice that raised here: ``lane_kernel=True`` now
    round-trips a linked frame, and only a block size LZ4 lacks raises."""
    data = b"abc" * 100 + make_corpus_sample(1900, 70_000)
    frame = lt.compress_frame_parallel(data, device="cpu", parallel_linked=True,
                                       lane_kernel=True)
    assert decompress_frame(frame, engine="native") == data
    assert lt.decompress_frames_parallel([frame], device="cpu") == [data]
    with pytest.raises(lt.CompressionError):
        lt.compress_frame_parallel(data, block_size=1000, device="cpu", parallel_linked=True,
                                   lane_kernel=True)
