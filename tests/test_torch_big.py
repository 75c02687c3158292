"""The port's big-block decoder and its v3 decoder (plain versions of
``csrc/decode_big.cu`` and ``csrc/decode_v3.cu``) against the JAX package:
its native engine and spec on 256 KiB blocks with and without prefixes and
on hostile blocks, and its v3 kernel in interpret mode.  Bytes and error
kinds must be equal (a byte codec has no tolerance)."""

import random

import numpy as np
import pytest
import torch

import lz4tpu_torch as lt
from lz4tpu.kernels.decompress_v3 import decompress_blocks_v3 as jax_decode_v3
from lz4tpu.native import compress_block as native_compress_block
from lz4tpu.native import decompress_block as native_decompress_block
from lz4tpu.spec.block import DecodeError as SpecDecodeError
from lz4tpu.spec.block import compress_block, decompress_block
from lz4tpu.spec.table import U16Table, U32Table, prime_u32_table
from lz4tpu_torch.kernels import decodebig as dbig
from lz4tpu_torch.kernels import decompress_v3 as dv3
from lz4tpu_torch.kernels.pack import pack_rows
from lz4tpu_torch.kernels.status import OK, STATUS_TO_KIND

BIG = 1 << 18

ZERO_OFFSET = b"\x10A\x00\x00"
OFFSET_PAST_PREFIX = b"\x10A\x05\x00"
PAST_LIMIT = b"\x1fA\x01\x00" + b"\xff" * 1100 + b"\x00"  # a 280,519-byte match
STRAY_CLEAN = b"\x30abc\x00"
STRAY_TRUNCATED = b"\x30abc\x20"
LITERALS_CUT = b"\x40ab"


def native_outcome(block, prefix, limit):
    try:
        return bytes(native_decompress_block(block, prefix, output_limit=limit))
    except SpecDecodeError as e:
        return e.kind


def port_outcomes(decoder, blocks, prefixes, limit, out_capacity=None):
    comp, comp_len = pack_rows(blocks, "cpu")
    prefix, prefix_len = pack_rows(prefixes, "cpu", align_right=True)
    out, out_len, status = decoder(comp, comp_len, prefix, prefix_len, limit, out_capacity)
    res = []
    for i in range(len(blocks)):
        s = int(status[i])
        res.append(out[i, : out_len[i]].numpy().tobytes() if s == OK else STATUS_TO_KIND[s])
    return res


def big_blocks(corpus_sample, window=b""):
    """Three 256 KiB blocks compressed behind ``window`` (greedy parse of
    the JAX package's native engine)."""
    raws = [corpus_sample(5100 + k, BIG) for k in range(3)]
    comp = [bytes(native_compress_block(window + r, len(window), U32Table())) for r in raws]
    return raws, comp


@pytest.mark.parametrize("decoder", [dbig.decode_big, dv3.decode_v3],
                         ids=["decode_big", "decode_v3"])
@pytest.mark.parametrize("plen", [0, 65536, 300], ids=["no_prefix", "prefix_64k", "prefix_300"])
def test_256k_blocks_match_native(decoder, plen, corpus_sample):
    window = corpus_sample(5000, 100_000)[-plen:] if plen else b""
    raws, comp = big_blocks(corpus_sample, window)
    got = port_outcomes(decoder, comp, [window] * len(comp), BIG)
    want = [native_outcome(c, window, BIG) for c in comp]
    assert got == want == raws
    assert bytes(decompress_block(comp[0], window, output_limit=BIG)) == raws[0]


def test_blocks_big_takes_the_trailing_64k_of_a_prefix(corpus_sample):
    window = corpus_sample(5001, 90_000)
    raws, comp = big_blocks(corpus_sample, window[-65536:])
    assert lt.decompress_blocks_big(comp, BIG, [window] * 3, device="cpu") == raws
    assert lt.decompress_blocks(comp, [window] * 3, BIG, device="cpu") == raws


def hostile_batch(corpus_sample):
    r = random.Random(0xB16)
    _, comp = big_blocks(corpus_sample)
    seed = comp[0]
    blocks = [seed, ZERO_OFFSET, OFFSET_PAST_PREFIX, PAST_LIMIT, STRAY_CLEAN, STRAY_TRUNCATED,
              LITERALS_CUT, b"\xf0", seed + b"\x00", seed + b"\x10", seed[: len(seed) // 2]]
    for _ in range(6):
        b = bytearray(seed)
        for _ in range(3):
            b[r.randrange(len(b))] = r.getrandbits(8)
        blocks.append(bytes(b))
    prefixes = [r.choice([b"", b"xyz" * 100]) for _ in blocks]
    prefixes[2] = b""  # the offset of 5 reaches before the output
    return blocks, prefixes


@pytest.mark.parametrize("decoder", [dbig.decode_big, dv3.decode_v3],
                         ids=["decode_big", "decode_v3"])
def test_hostile_blocks_same_kind_as_native(decoder, corpus_sample):
    blocks, prefixes = hostile_batch(corpus_sample)
    got = port_outcomes(decoder, blocks, prefixes, BIG)
    want = [native_outcome(b, p, BIG) for b, p in zip(blocks, prefixes)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"block {i}"
    kinds = {w for w in want if isinstance(w, str)}
    assert kinds == set(STATUS_TO_KIND.values())  # every error kind reached


@pytest.mark.parametrize("entry", ["decompress_blocks_big", "decompress_blocks_v3"])
def test_first_failing_block_wins(entry, corpus_sample):
    blocks, prefixes = hostile_batch(corpus_sample)
    first = next(w for w in (native_outcome(b, p, BIG) for b, p in zip(blocks, prefixes))
                 if isinstance(w, str))
    with pytest.raises(lt.DecodeError) as e:
        if entry == "decompress_blocks_big":
            lt.decompress_blocks_big(blocks, BIG, prefixes, device="cpu")
        else:
            lt.decompress_blocks_v3(blocks, prefixes, BIG, device="cpu")
    assert e.value.kind == first == SpecDecodeError.KIND_ZERO_OFFSET


def test_literals_may_pass_the_limit():
    """The memory limit is checked at matches only: literals run past it
    (``out_capacity`` holds limit + compressed width, which they fit in)."""
    r = random.Random(7)
    raw = bytes(r.getrandbits(8) for _ in range(5000))
    block = bytes(compress_block(raw, 0, U16Table()))  # one literal run
    limit = 4096
    assert port_outcomes(dbig.decode_big, [block], [b""], limit) == [raw]
    assert port_outcomes(dv3.decode_v3, [block], [b""], limit) == [raw]
    assert bytes(decompress_block(block, output_limit=limit)) == raw
    comp, comp_len = pack_rows([block], "cpu")
    out, out_len, _ = dbig.decode_big(comp, comp_len, torch.zeros((1, 0), dtype=torch.uint8),
                                      torch.zeros(1, dtype=torch.int32), limit)
    assert out.shape == (1, limit + comp.shape[1]) and int(out_len[0]) == 5000


@pytest.mark.parametrize("decoder", [dbig.decode_big, dv3.decode_v3],
                         ids=["decode_big", "decode_v3"])
def test_wrapper_checks(decoder):
    comp = torch.zeros((2, 16), dtype=torch.uint8)
    i32 = torch.zeros(2, dtype=torch.int32)
    no_prefix = torch.zeros((1, 0), dtype=torch.uint8)
    with pytest.raises(ValueError, match="multiple of 16"):
        decoder(comp, i32, no_prefix, i32, 1024, out_capacity=1041)
    with pytest.raises(ValueError, match="hold limit"):
        decoder(comp, i32, no_prefix, i32, 1024, out_capacity=1024)
    with pytest.raises(ValueError, match="comp_len"):
        decoder(comp, torch.zeros(3, dtype=torch.int32), no_prefix, i32, 1024)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decoder(comp.to(meta), i32.to(meta), no_prefix.to(meta), i32.to(meta), 1024)


# ---------------------------------------------------------------------------
# decode_v3 against the JAX package's v3 kernel (interpret mode)
# ---------------------------------------------------------------------------


def test_v3_matches_jax_v3_interpret_roundtrip():
    payloads = [
        b"to live or not to live, to live or not to live! " * 8,
        b"\x00" * 300,
        bytes(range(256)),
        b"ab" * 150,
        b"",
    ]
    comp = [bytes(compress_block(p, 0, U16Table())) for p in payloads]
    want = jax_decode_v3(comp, block_maxsize=4096)
    assert lt.decompress_blocks_v3(comp, None, 4096, device="cpu") == want == payloads


def test_v3_matches_jax_v3_interpret_prefix():
    dictionary = b"hello world, this dictionary has words in it" * 3
    data = b"this dictionary has words: hello world!"
    table = U32Table()
    prime_u32_table(table, dictionary)
    blocks = [bytes(compress_block(dictionary + data, len(dictionary), table)),
              bytes([0x12, ord("Q"), 2, 0])]
    prefixes = [dictionary, b"ab"]
    want = jax_decode_v3(blocks, prefixes, block_maxsize=4096)
    assert lt.decompress_blocks_v3(blocks, prefixes, 4096, device="cpu") == want
    assert want == [data, b"QbQbQbQ"]


@pytest.mark.parametrize("bad", [
    bytes([0x10, ord("a"), 2, 0]),
    ZERO_OFFSET,
    bytes([0x50, ord("a")]),
    bytes([0x1F, ord("a"), 1, 0, 0xFF, 0xFF, 0xFF, 0x10]),
], ids=["invalid_offset", "zero_offset", "unexpected_end", "memory_limit"])
def test_v3_error_kinds_match_jax_v3_interpret(bad):
    with pytest.raises(SpecDecodeError) as jax_err:
        jax_decode_v3([bad], block_maxsize=512)
    with pytest.raises(lt.DecodeError) as port_err:
        lt.decompress_blocks_v3([bad], None, 512, device="cpu")
    assert port_err.value.kind == jax_err.value.kind


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def decoder_spy(monkeypatch):
    """The names of the decoders the frame path launches, in order."""
    from lz4tpu_torch.parallel import pipeline

    calls = []
    for name in ("decode128", "decode_big", "decode_v4"):
        orig = getattr(pipeline, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(pipeline, name, spy)
    return calls


def dictionary_frame(corpus_sample, block_size=BIG):
    """(frame, content, dictionary): 700,000 B of corpus behind a 70,000-byte
    dictionary, in independent blocks of ``block_size`` (the JAX
    package's native writer)."""
    from lz4tpu import CompressionSettings

    data = corpus_sample(5200, 700_000)
    dic = corpus_sample(5201, 70_000)
    frame = (CompressionSettings().engine("native").block_size(block_size).dictionary(3, dic)
             .compress_bytes(data))
    return frame, data, dic


def test_frame_of_big_blocks_decodes_on_decode_big(corpus_sample, monkeypatch):
    """``lane_kernel=True`` keeps blocks over 64 KiB on the lane decoder,
    ``decode_big``; ``lane_kernel=False`` takes ``decode_v4``."""
    calls = decoder_spy(monkeypatch)
    frame, data, dic = dictionary_frame(corpus_sample)
    assert lt.decompress_frame_parallel(frame, device="cpu", dictionary=dic,
                                        lane_kernel=True) == data
    assert lt.decompress_frame_parallel(frame, device="cpu", dictionary=dic,
                                        lane_kernel=False) == data
    assert calls == ["decode_big", "decode_v4"]


@pytest.mark.parametrize("lane_kernel, decoder", [
    (None, "decode_v4"),  # the default route: a group of few big blocks
    (True, "decode_big"),
    (False, "decode_v4"),
])
def test_frame_of_big_blocks_routes_by_lane_kernel(lane_kernel, decoder, corpus_sample,
                                                   monkeypatch):
    """One group of three 256 KiB blocks: its decoder, and ``big_blocks_v4``
    counting its blocks only where the default route took ``decode_v4``."""
    calls = decoder_spy(monkeypatch)
    frame, data, dic = dictionary_frame(corpus_sample)
    lt.reset_stats()
    assert lt.decompress_frame_parallel(frame, device="cpu", dictionary=dic,
                                        lane_kernel=lane_kernel) == data
    assert calls == [decoder]
    assert lt.stats()["big_blocks_v4"] == (3 if lane_kernel is None else 0)


def one_byte_frame(n_blocks: int, bd: int) -> tuple[bytes, bytes]:
    """(frame, content): an independent frame whose block i is the 2-byte
    stream ``10 b_i`` (one literal), under the block maxsize of ``bd``."""
    from lz4tpu_torch.spec.xxhash32 import xxh32

    content = bytes((7 * i + 1) & 0xFF for i in range(n_blocks))
    out = bytearray(b"\x04\x22\x4d\x18" + bytes([0x60, bd]))
    out.append((xxh32(bytes([0x60, bd])) >> 8) & 0xFF)
    for b in content:
        out += (2).to_bytes(4, "little") + bytes([0x10, b])
    return bytes(out + b"\0\0\0\0"), content


def test_every_group_of_big_blocks_goes_to_decode_v4(monkeypatch):
    """The default route takes every budget group of a frame of big blocks
    to ``decode_v4``, whatever its rows, and ``lane_kernel=True`` every
    one to ``decode_big``: 10 blocks under a 256 KiB maxsize in groups of
    4, 4 and 2 on one device, and of 5 on each entry of a mesh of two."""
    from lz4tpu_torch.kernels import pack
    from lz4tpu_torch.parallel import pipeline

    calls = decoder_spy(monkeypatch)
    frame, content = one_byte_frame(10, 0x50)
    row = pipeline.round_up(pipeline.round_up(BIG + 16, 16) + 16, 16)
    monkeypatch.setattr(pack, "DECODE_BUDGET", 4 * row)
    lt.reset_stats()
    assert lt.decompress_frame_parallel(frame, device="cpu") == content
    assert calls == ["decode_v4"] * 3
    assert lt.stats()["big_blocks_v4"] == 10
    calls.clear()
    assert lt.decompress_frame_parallel(frame, device="cpu", lane_kernel=True) == content
    assert calls == ["decode_big"] * 3
    calls.clear()
    monkeypatch.setattr(pack, "DECODE_BUDGET", 5 * row)
    mesh = lt.make_mesh(devices=["cpu"] * 2)
    assert lt.decompress_frame_parallel(frame, mesh=mesh) == content
    assert calls == ["decode_v4"] * 2
    assert lt.stats()["big_blocks_v4"] == 20


def test_frame_of_64k_blocks_stays_on_decode128(corpus_sample, monkeypatch):
    """The default route leaves frames of 64 KiB blocks on ``decode128``
    and counts none of their blocks in ``big_blocks_v4``."""
    calls = decoder_spy(monkeypatch)
    frame, data, dic = dictionary_frame(corpus_sample, 1 << 16)
    lt.reset_stats()
    assert lt.decompress_frame_parallel(frame, device="cpu", dictionary=dic) == data
    assert calls == ["decode128"]
    assert lt.stats()["big_blocks_v4"] == 0


def test_single_block_adapter_retry_goes_through_decode_big(monkeypatch):
    from lz4tpu_torch.kernels import decompress as kdec

    limits = []
    orig = dbig.decode_big

    def spy(comp, comp_len, prefix, prefix_len, limit, out_capacity=None):
        limits.append(limit)
        return orig(comp, comp_len, prefix, prefix_len, limit, out_capacity)

    monkeypatch.setattr(dbig, "decode_big", spy)
    block = b"\x1fA\x01\x00" + b"\xff" * 20000 + b"\x00"  # decodes to ~5.1 MB
    want = bytes(decompress_block(block))
    assert kdec.decompress_block_cuda(block, device="cpu") == want
    assert limits == [1 << 22, 255 * len(block) + 64 + 1]  # doubled, capped at the bound


@pytest.mark.slow
def test_decode_big_matches_jax_decodebig_interpret():
    """The JAX package's banded kernel with shrunken bands (as its own slow
    tests run it) against the port's plain version."""
    import lz4tpu.kernels.decodebig as jax_dbig

    r = random.Random(1000)

    def local_data(size):
        out = bytearray()
        while len(out) < size:
            pat = bytes(r.getrandbits(8) for _ in range(r.randint(20, 180)))
            out.extend(pat * r.randint(2, 8))
            out.extend(bytes(r.getrandbits(8) for _ in range(r.randint(5, 120))))
        return bytes(out[:size])

    payloads = [local_data(60_000) for _ in range(3)]
    comp = [bytes(compress_block(p, 0, U32Table())) for p in payloads]
    want = jax_dbig.decompress_blocks_big(comp, block_maxsize=1 << 16, _window_bound=8192,
                                          _oband=6144, _cband=2048)
    assert lt.decompress_blocks_big(comp, 1 << 16, device="cpu") == want == payloads
    assert np.frombuffer(want[0], np.uint8).size == 60_000
