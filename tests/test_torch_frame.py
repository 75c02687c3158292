"""Whole frames through the port (plain versions on the CPU) against the
JAX package: byte-identical independent frames, round trips, and the
typed errors of the serial reader on corrupted frames."""

import random

import pytest

import jax

import lz4tpu_torch as lt
from lz4tpu import CompressionSettings, decompress_frame
from lz4tpu.frame.decompress import LZ4FrameReader as JaxFrameReader
from lz4tpu.parallel.mesh import make_mesh
from lz4tpu.parallel.pipeline import compress_frame_parallel as jax_compress_frame_parallel
from lz4tpu.parallel.pipeline import decompress_frame_parallel as jax_decompress_frame_parallel
from lz4tpu.spec.block import compress_block
from lz4tpu.spec.table import U32Table


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(min(len(jax.devices()), 8))


def test_matches_jax_compress_frame_parallel_on_the_mesh(mesh8, corpus_sample):
    data = corpus_sample(3100, 260_000)
    dic = corpus_sample(3101, 9000)
    want = jax_compress_frame_parallel(data, block_size=1 << 16, mesh=mesh8,
                                       dictionary=dic, block_checksums=True)
    got = lt.compress_frame_parallel(data, 1 << 16, device="cpu", dictionary=dic,
                                     block_checksums=True)
    assert got == want
    assert lt.decompress_frame_parallel(got, device="cpu", dictionary=dic) == data


@pytest.mark.parametrize("kw", [
    dict(),
    dict(block_checksums=True),
    dict(content_checksum=False),
    dict(with_content_size=False),
    dict(acceleration=5),
    dict(dictionary="dict"),
    dict(dictionary="dict", dictionary_id=77, block_checksums=True),
    dict(dictionary="long_dict"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_matches_native_writer(kw, corpus_sample):
    data = corpus_sample(3200, 200_000)
    dicts = {"dict": corpus_sample(3201, 12_000), "long_dict": corpus_sample(3202, 90_000)}
    kw = dict(kw)
    dic = dicts.get(kw.pop("dictionary", None))
    s = (CompressionSettings().engine("native").threads(1).block_size(1 << 16)
         .block_checksums(kw.get("block_checksums", False))
         .content_checksum(kw.get("content_checksum", True))
         .acceleration(kw.get("acceleration", 1)))
    if dic is not None:
        s.dictionary(kw.get("dictionary_id", 0), dic)
        if "dictionary_id" not in kw:
            s.dictionary_id_nonsense_override(None)
    want = s.compress_bytes(data, with_size=kw.get("with_content_size", True))
    got = lt.compress_frame_parallel(data, 1 << 16, device="cpu", dictionary=dic, **kw)
    assert got == want
    assert lt.decompress_frame_parallel(got, device="cpu", dictionary=dic) == data


def test_incompressible_and_empty_inputs(corpus_sample):
    r = random.Random(5)
    data = bytes(r.getrandbits(8) for _ in range(70_000)) + corpus_sample(3300, 70_000)
    for payload in (data, b"", b"x", data[:65536]):
        want = CompressionSettings().engine("native").block_size(1 << 16).compress_bytes(payload)
        got = lt.compress_frame_parallel(payload, 1 << 16, device="cpu")
        assert got == want
        assert lt.decompress_frame_parallel(got, device="cpu") == payload


@pytest.mark.parametrize("block_size,independent", [
    (1 << 16, True), (1 << 18, True), (1 << 22, True), (1 << 16, False), (1 << 18, False),
])
def test_decodes_jax_made_frames(block_size, independent, corpus_sample):
    data = corpus_sample(3400 + block_size % 7, 300_000)
    frame = (CompressionSettings().engine("native").block_size(block_size)
             .independent_blocks(independent).block_checksums(True).compress_bytes(data))
    assert lt.decompress_frame_parallel(frame, device="cpu") == data
    assert lt.decompress_frame(frame, engine="cpu") == data


def test_linked_frame_with_dictionary_goes_to_serial_reader(corpus_sample):
    data = corpus_sample(3500, 150_000)
    dic = corpus_sample(3501, 30_000)
    frame = (CompressionSettings().engine("native").block_size(1 << 16)
             .independent_blocks(False).dictionary(1, dic).compress_bytes(data))
    assert lt.decompress_frame_parallel(frame, device="cpu", dictionary=dic) == data
    assert decompress_frame(frame, dictionary=dic, engine="spec") == data


def test_lane_kernel_false_and_jax_parallel_decoder_agree(corpus_sample):
    data = corpus_sample(3600, 140_000)
    frame = lt.compress_frame_parallel(data, 1 << 16, device="cpu")
    assert lt.decompress_frame_parallel(frame, device="cpu", lane_kernel=False) == data
    assert jax_decompress_frame_parallel(frame, mesh=make_mesh(1), lane_kernel=False) == data


def test_later_slices_raise_not_implemented():
    linked = lt.compress_frame_parallel(b"abc" * 100, device="cpu", parallel_linked=True)
    assert decompress_frame(linked, engine="native") == b"abc" * 100
    lane = lt.compress_frame_parallel(b"abc" * 100, device="cpu", lane_kernel=True)
    assert decompress_frame(lane, engine="native") == b"abc" * 100
    assert lt.decompress_frame_parallel(lane, device="cpu") == b"abc" * 100
    with pytest.raises(lt.CompressionError):
        lt.compress_frame_parallel(b"abc", block_size=1000, device="cpu")


# ---------------------------------------------------------------------------
# corrupted frames: typed errors equal to the JAX package's serial reader
# ---------------------------------------------------------------------------


def _frame_of(raw_block: bytes, content_checksum=False) -> bytes:
    """A 64 KiB-block independent frame holding one raw block as is."""
    empty = (CompressionSettings().engine("spec").block_size(1 << 16)
             .content_checksum(content_checksum).compress_bytes(b"", with_size=False))
    header = empty[:-4 - (4 if content_checksum else 0)]
    return header + len(raw_block).to_bytes(4, "little") + raw_block + b"\x00" * 4


def _jax_serial_error(frame):
    """Outcome of the JAX package's serial reader: the error's class name
    and kind (a CodecError carries the block decoder's kind)."""
    try:
        JaxFrameReader(frame, engine="spec").read_all()
    except Exception as e:  # noqa: BLE001 — the class is what is compared
        return type(e).__name__, getattr(e, "kind", None)
    return None


def _port_error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return type(e).__name__, getattr(e, "kind", None)
    return None


def _corrupted_frames(corpus_sample):
    data = corpus_sample(3700, 140_000)
    good = (CompressionSettings().engine("native").block_size(1 << 16)
            .block_checksums(True).compress_bytes(data))
    bad_block_sum = bytearray(good)
    bad_block_sum[30] ^= 0x40  # inside block 0's payload
    bad_frame_sum = bytearray(good)
    bad_frame_sum[-1] ^= 1
    r = random.Random(9)
    overflow_raw = corpus_sample(3701, 65_000) + bytes(r.getrandbits(8) for _ in range(1000))
    overflow = bytes(compress_block(overflow_raw, 0, U32Table()))  # literals past 64 KiB
    truncated = good[: len(good) // 2]
    return {
        "block_checksum": bytes(bad_block_sum),
        "frame_checksum": bytes(bad_frame_sum),
        "decoded_past_maxsize": _frame_of(overflow),
        "stored_block_too_big": _frame_of(b"") [:-8] + ((1 << 16) + 1 | 1 << 31).to_bytes(4, "little"),
        "unexpected_end": _frame_of(b"\x40ab"),
        "zero_offset": _frame_of(b"\x10A\x00\x00"),
        "invalid_offset": _frame_of(b"\x10A\x05\x00"),
        "memory_limit": _frame_of(b"\x1fA\x01\x00" + b"\xff" * 300 + b"\x00"),
        "truncated": truncated,
        "bad_magic": b"\x00" + good[1:],
    }


CASES = ["block_checksum", "frame_checksum", "decoded_past_maxsize", "stored_block_too_big",
         "unexpected_end", "zero_offset", "invalid_offset", "memory_limit", "truncated",
         "bad_magic"]


@pytest.mark.parametrize("case", CASES)
def test_typed_errors_match_the_serial_reader(case, corpus_sample):
    frame = _corrupted_frames(corpus_sample)[case]
    want = _jax_serial_error(frame)
    assert want is not None
    # the port's serial reader: the same class and kind
    assert _port_error(lambda: lt.LZ4FrameReader(frame, engine="cpu").read_all()) == want
    # the parallel reader: the same class, except that (like the JAX
    # package's) it raises the block decoder's DecodeError unwrapped
    got = _port_error(lambda: lt.decompress_frame_parallel(frame, device="cpu"))
    if want[0] == "CodecError":
        assert got == ("DecodeError", want[1])
    else:
        assert got == want
