"""The lane compressor of the port (plain versions on the CPU) against the
JAX package: the stream splice and the window priming byte-equal, STRICT
mode byte-equal to the native greedy parse and to the JAX lane kernel in
interpret mode, default and window mode valid LZ4 of about the JAX lane
kernel's size, and ``lane_kernel=True`` frames of every mode read back by
the JAX package's reader."""

import os
import sys

import numpy as np
import pytest
import torch

import lz4tpu
import lz4tpu.kernels.compress128 as jax_c128
import lz4tpu_torch as lt
from lz4tpu import native
from lz4tpu.spec.block import decompress_block
from lz4tpu.spec.table import U32Table, prime_u32_table
from lz4tpu_torch.kernels import compress128 as c128
from lz4tpu_torch.kernels.splice import splice_streams, tail_split
from lz4tpu_torch.utils import silesia

from conftest import make_corpus_sample

# Aggregate size of the port's default/window parse over the JAX lane
# kernel's on the same rows at the same hashlog.  The two parses differ (the
# port finds every position's candidates before its walk and keeps four a
# bucket; lz4tpu probes serially with a skip schedule), but land within this
# of each other on these rows.
SIZE_TOLERANCE = 0.02


def _rand(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _decode(stream, prefix=b"", limit=1 << 22):
    return bytes(decompress_block(stream, prefix=prefix, output_limit=limit))


# ---------------------------------------------------------------------------
# splice
# ---------------------------------------------------------------------------


def _windowed_native_streams():
    data = make_corpus_sample(55, 50_000)
    chunk, window = 4096, 16384
    payloads = []
    for i in range(len(data) // chunk):
        pfx = data[max(0, i * chunk - window) : i * chunk]
        t = U32Table()
        prime_u32_table(t, pfx)
        payloads.append(bytes(native.compress_block(pfx + data[i * chunk : (i + 1) * chunk],
                                                    len(pfx), t)))
    return payloads, data[: len(data) // chunk * chunk]


def _splice_cases():
    rnd = bytes(range(256)) * 8
    lane, _, _, = zip(*(c128.lane_parse_plain(make_corpus_sample(70 + i, 1500 + 300 * i))
                        for i in range(5)))
    return {
        "windowed_chunks": _windowed_native_streams()[0],
        "all_literal": [b"\xf0" + bytes([256 - 15]) + rnd[:256], b"\x50" + rnd[256:261]],
        "three_literal_runs": [b"\x30abc", b"\xf0\x00" + rnd[:15], b"\x10z"],
        "empty_chunks_between": [b"\x00", c128.lane_parse_plain(b"ab" * 300)[0], b"\x00", b"\x00",
                                 c128.lane_parse_plain(b"cd" * 300)[0]],
        "empty_last": [c128.lane_parse_plain(b"ab" * 300)[0], b"\x00"],
        "long_literal_header": [b"\xf0" + b"\xff" * 3 + b"\x05" + _rand(3, 15 + 765 + 5),
                                c128.lane_parse_plain(_rand(4, 40) + b"q" * 90)[0]],
        "lane_streams": list(lane),
        "single": [c128.lane_parse_plain(make_corpus_sample(90, 2000))[0]],
    }


@pytest.mark.parametrize("case", sorted(_splice_cases()))
def test_splice_streams_equal_to_jax(case):
    payloads = _splice_cases()[case]
    want = native.splice_streams(payloads)
    assert splice_streams(payloads) == want
    tails = [tail_split(p) for p in payloads]
    assert tails == [native.tail_split(p) for p in payloads]
    assert splice_streams(payloads, tails) == want
    if case != "windowed_chunks":  # those need their windows to decode alone
        assert _decode(want) == b"".join(_decode(p) for p in payloads)


def test_splice_streams_decodes_to_the_windowed_chunks_input():
    payloads, data = _windowed_native_streams()
    assert bytes(native.decompress_block(lt.splice_streams(payloads), b"",
                                         output_limit=2 * len(data))) == data


@pytest.mark.parametrize("stream", [b"\xf0", b"\x40ab", b"\x10a\x01", b"\x1fa\x01\x00\xff",
                                    b"\x10a\x01\x00"],
                         ids=["lsic_cut", "literals_cut", "offset_cut", "match_lsic_cut",
                              "ends_in_a_match"])
def test_tail_split_refuses_streams_without_a_literal_tail(stream):
    with pytest.raises(lt.DecodeError):
        tail_split(stream)


# ---------------------------------------------------------------------------
# priming and the table state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hashlog", [6, 12])
def test_priming_equal_to_jax_through_lane_tables_from_jax(hashlog):
    win = make_corpus_sample(700, 70_000)
    prefixes = [win[:65536], win[100:3100], win[:16], win[:15], b"", None, _rand(5, 40_000),
                b"\x00" * 5000]
    got = c128.prime_tables_packed(prefixes, hashlog)
    assert got.shape == (len(prefixes), 1 << hashlog) and got.dtype == torch.int32
    theirs = jax_c128.prime_tables_packed(prefixes, hashlog)
    assert torch.equal(got, lt.lane_tables_from_jax(theirs, len(prefixes)))
    assert np.array_equal(lt.lane_tables_to_jax(got), theirs)
    # the native engine primes from sliding windows of one buffer
    data = b"".join(p or b"" for p in prefixes)
    wlens = np.array([len(p or b"") for p in prefixes], np.int64)
    starts = np.cumsum(wlens)
    native_tables = native.prime_tables_native(data, starts, wlens, np.zeros(len(prefixes)),
                                               hashlog)
    assert torch.equal(got, lt.lane_tables_from_jax(native_tables, len(prefixes)))


def test_lane_tables_state_checks_its_input():
    with pytest.raises(ValueError, match="int32"):
        lt.lane_tables_from_jax(np.zeros((64, 128), np.int64), 4)
    with pytest.raises(ValueError, match="int32"):
        lt.lane_tables_from_jax(np.zeros((64, 100), np.int32), 4)
    with pytest.raises(ValueError, match="at most 128"):
        lt.lane_tables_from_jax(np.zeros((64, 128), np.int32), 129)
    with pytest.raises(ValueError, match="int32"):
        lt.lane_tables_to_jax(torch.zeros((129, 64), dtype=torch.int32))


# ---------------------------------------------------------------------------
# STRICT mode
# ---------------------------------------------------------------------------


def _strict_payloads():
    """The payloads of tests/test_compress128_strict.py."""
    binary = "/usr/bin/g++" if os.path.exists("/usr/bin/g++") else sys.executable
    with open(binary, "rb") as f:
        head = f.read(2000)
    return {
        "corpus_2500": make_corpus_sample(5000, 2500),
        "corpus_1800": make_corpus_sample(5001, 1800),
        "random_1500": _rand(9, 1500),
        "zeros_then_corpus": b"\x00" * 1200 + make_corpus_sample(5002, 600),
        "binary_head": head,
        "abcd_700": b"abcd" * 700,
        "corpus_8000": make_corpus_sample(5003, 8000),
        "hello": b"hello",
        "empty": b"",
    }


@pytest.mark.parametrize("name", sorted(_strict_payloads()))
def test_strict_equal_to_native_greedy_parse(name):
    p = _strict_payloads()[name]
    (got,) = lt.compress_blocks_128([p], strict=True, device="cpu")
    if not p:
        assert got == b"\x00"
        return
    assert got == bytes(native.compress_block(p, 0, U32Table()))
    scalar, _ = lt.compress_blocks([p], device="cpu")
    assert got == scalar[0]


def test_strict_equal_to_jax_lane_kernel_in_interpret_mode(monkeypatch):
    """The JAX lane kernel's STRICT mode needs its full 4096-row table, which
    interpret mode sweeps every round (about 70 s, nearly all of it the
    compile): the payloads are as small as still reach matches, literal
    runs, a backward extension and the tail rules."""
    payloads = [make_corpus_sample(5000, 260), b"abcd" * 30 + _rand(6, 50) + b"abcd" * 10,
                b"hello", b""]
    monkeypatch.setattr(jax_c128, "STRICT", True)
    jax_c128._compress128_jit.clear_cache()
    try:
        theirs = jax_c128.compress_blocks_128(payloads, hashlog=12)
    finally:
        jax_c128._compress128_jit.clear_cache()
    assert lt.compress_blocks_128(payloads, strict=True, device="cpu") == theirs


def test_strict_refuses_windows_and_other_table_sizes():
    with pytest.raises(ValueError, match="without a window"):
        lt.compress_blocks_128([b"abc" * 50], prefixes=[b"abc" * 50], strict=True, device="cpu")
    with pytest.raises(ValueError, match="hashlog 12"):
        lt.compress_blocks_128([b"abc" * 50], hashlog=8, strict=True, device="cpu")


# ---------------------------------------------------------------------------
# default and window mode against the JAX lane kernel (interpret mode)
# ---------------------------------------------------------------------------

LANE_HASHLOG = 8  # a small table keeps the interpreted one-hot sweep cheap


@pytest.fixture(scope="module")
def lane_rows():
    """Rows with a full-size relation to their window, a windowless row in
    the same batch, and both packages' streams for them (one interpreted
    launch of the JAX kernel)."""
    win = make_corpus_sample(700, 3000)
    blocks, prefixes = [], []
    for s in range(4):
        blocks.append(win[s * 200 : s * 200 + 900] + make_corpus_sample(710 + s, 1200)
                      + win[1000:1600])
        prefixes.append(win)
    blocks += [make_corpus_sample(720, 1500), make_corpus_sample(320, 3000),
               b"\x00" * 2500 + _rand(8, 300), make_corpus_sample(721, 2000)]
    prefixes += [b"", b"", b"", win[:10]]  # under 16 bytes: a window that is not primed
    theirs = jax_c128.compress_blocks_128(blocks, hashlog=LANE_HASHLOG, prefixes=prefixes)
    ours = lt.compress_blocks_128(blocks, hashlog=LANE_HASHLOG, prefixes=prefixes, device="cpu")
    return blocks, prefixes, theirs, ours


@pytest.mark.parametrize("which", ["jax", "port"])
def test_lane_streams_decode_to_their_blocks(lane_rows, which):
    blocks, prefixes, theirs, ours = lane_rows
    for b, p, c in zip(blocks, prefixes, theirs if which == "jax" else ours):
        assert _decode(c, prefix=p, limit=1 << 20) == b


def test_lane_window_helps(lane_rows):
    blocks, _, theirs, ours = lane_rows
    (solo,) = lt.compress_blocks_128(blocks[:1], hashlog=LANE_HASHLOG, device="cpu")
    assert len(ours[0]) < len(solo)
    assert len(theirs[0]) < len(solo)


def test_lane_sizes_agree_with_jax(lane_rows):
    _, _, theirs, ours = lane_rows
    a, b = sum(map(len, ours)), sum(map(len, theirs))
    assert abs(a - b) <= SIZE_TOLERANCE * b, (a, b, a / b)


def _edge_payloads():
    """The edge payloads of tests/test_compress128.py."""
    v1 = bytes([99, 116, 232, 245])
    v2 = bytes([180, 163, 115, 4])  # same bucket and tag as v1 at hashlog 10
    collide = _rand(1, 40) + v1 + _rand(2, 40) + v2 + _rand(3, 40)
    return {
        "text": b"to live or not to live, to be or not to be! " * 12,
        "all_bytes": bytes(range(256)),
        "zeros_600": b"\x00" * 600,
        "random_500": _rand(7, 500),
        "ab_200": b"ab" * 200,
        "hello": b"hello",
        "empty": b"",
        "x_13": b"x" * 13,
        "ramp": bytes(range(64)) * 8,
        "random_3000": _rand(8, 3000),
        "zeros_12000": b"\x00" * 12000,
        "run_then_random": b"Q" * 9000 + _rand(8, 2200),
        "tag_collision": collide,
        "tag_collision_then_match": collide + collide[:60],
        "corpus_32k": make_corpus_sample(300, 32768),
    }


@pytest.mark.parametrize("name", sorted(_edge_payloads()))
def test_lane_edge_payloads_round_trip(name):
    p = _edge_payloads()[name]
    for hashlog in (6, 10, 12):
        (c,) = lt.compress_blocks_128([p], hashlog=hashlog, device="cpu")
        assert _decode(c) == p
        assert len(c) <= len(p) + len(p) // 255 + 16
    if not p:
        assert c == b"\x00"


def test_tag_collision_is_a_false_hit_the_compare_rejects():
    """At hashlog 10 the second word's bucket holds the first one, with the
    same tag: it is the second word's candidate, the compare rejects it, and
    the row goes out as one literal run."""
    p = _edge_payloads()["tag_collision"]
    bucket, tag = c128._hash_words(p, 10)
    assert bucket[40] == bucket[84] and tag[40] == tag[84] and p[40:44] != p[84:88]
    assert 40 // c128.GROUP < 84 // c128.GROUP  # a candidate before the group
    length, _ = c128.lane_records_plain(p, 0, 10)
    assert not length.any()
    stream, tail_pos, tail_lit = c128.lane_parse_plain(p, 0, 10)
    assert (tail_pos, tail_lit) == (0, len(p))  # random bytes: one literal run


def test_lane_total_no_larger_than_greedy_on_32k_blocks():
    """The size contract at the default table: over real 32 KiB blocks the
    lane parse's total is no larger than the greedy parse's."""
    lane = greedy = 0
    for data in silesia.corpus(0.004, cache=False).values():
        blocks = [data[i : i + c128.MAX_B] for i in range(0, len(data), c128.MAX_B)]
        lane += sum(map(len, lt.compress_blocks_128(blocks, device="cpu")))
        greedy += sum(len(c) for c in lt.compress_blocks(blocks, device="cpu")[0])
    assert lane <= greedy, (lane, greedy)


# ---------------------------------------------------------------------------
# the tensor-level wrapper
# ---------------------------------------------------------------------------


def _tensors(blocks, prefixes=None):
    flat, base, n, cur0 = c128.pack_lane_rows(blocks, prefixes)
    return (torch.from_numpy(flat.copy()), torch.from_numpy(base), torch.from_numpy(n),
            torch.from_numpy(cur0))


@pytest.mark.parametrize("mode", ["default", "window", "strict"])
def test_compress128_reports_the_tail_a_splice_needs(mode):
    blocks = [make_corpus_sample(40 + i, 900 * (i + 1)) for i in range(4)] + [b"", b"tiny"]
    prefixes = [make_corpus_sample(40, 5000)] * 3 + [b""] * 3 if mode == "window" else None
    out, out_len, tail_pos, tail_lit = c128.compress128(*_tensors(blocks, prefixes),
                                                        strict=mode == "strict")
    assert out.shape[1] == 3632  # worst case of the longest block, on the 16-byte grid
    for i, b in enumerate(blocks):
        stream = out[i, : out_len[i]].numpy().tobytes()
        assert not out[i, out_len[i] :].any()
        assert _decode(stream, prefix=prefixes[i] if prefixes else b"") == b
        assert (int(tail_pos[i]), int(tail_lit[i])) == tail_split(stream)


def test_compress128_checks_its_tensors():
    src, base, n, cur0 = _tensors([b"abc" * 100, b"xyz" * 50])
    with pytest.raises(ValueError, match="uint8"):
        c128.compress128(src.to(torch.int32), base, n, cur0)
    with pytest.raises(ValueError, match="base"):
        c128.compress128(src, base.to(torch.int32), n, cur0)
    with pytest.raises(ValueError, match="cur0"):
        c128.compress128(src, base, n, cur0[:1])
    with pytest.raises(ValueError, match="hashlog"):
        c128.compress128(src, base, n, cur0, hashlog=13)
    with pytest.raises(ValueError, match="unsupported device"):
        c128.compress128(*(t.to("meta") for t in (src, base, n, cur0)))


@pytest.mark.parametrize("what", ["row_past_src", "negative_base", "block_over_32k",
                                  "window_over_64k", "cur0_past_n", "strict_with_window"])
def test_compress128_refuses_rows_out_of_range(what):
    src = torch.zeros(200_000, dtype=torch.uint8)
    base, n, cur0, strict = [0, 1000], [3000, 3000], [0, 100], False
    if what == "row_past_src":
        base[1] = 198_000
    elif what == "negative_base":
        base[0] = -1
    elif what == "block_over_32k":
        n[0] = c128.MAX_B + 1
    elif what == "window_over_64k":
        n[1], cur0[1] = 70_000, 65537
    elif what == "cur0_past_n":
        cur0[1] = 3001
    else:
        strict = True
    with pytest.raises(ValueError, match="rows out of range"):
        c128.compress128(src, torch.tensor(base), torch.tensor(n, dtype=torch.int32),
                         torch.tensor(cur0, dtype=torch.int32), strict=strict)


def test_compress_blocks_128_takes_any_number_of_blocks_and_refuses_big_ones():
    blocks = [make_corpus_sample(2000 + i, 150 + i) for i in range(150)]  # over 128 lanes
    out = lt.compress_blocks_128(blocks, hashlog=6, device="cpu")
    assert [_decode(c) for c in out] == blocks
    assert lt.compress_blocks_128([], device="cpu") == []
    with pytest.raises(ValueError, match="over 32768"):
        lt.compress_blocks_128([bytes(c128.MAX_B + 1)], device="cpu")
    with pytest.raises(ValueError, match="prefixes"):
        lt.compress_blocks_128([b"a", b"b"], prefixes=[b"a"], device="cpu")


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def _frame_sizes(frame):
    from lz4tpu.frame.decompress import LZ4FrameReader, _read_exact
    from lz4tpu.frame.header import INCOMPRESSIBLE

    r = LZ4FrameReader(frame, engine="native")
    sizes = []
    while True:
        bl = int.from_bytes(_read_exact(r.reader, 4), "little")
        if bl == 0:
            return sizes, r
        stored = bool(bl & INCOMPRESSIBLE)
        bl &= ~INCOMPRESSIBLE & 0xFFFFFFFF
        _read_exact(r.reader, bl + (4 if r.flags.block_checksums else 0))
        sizes.append((bl, stored))


_DIC = make_corpus_sample(801, 80_000)
_DATA = make_corpus_sample(800, 150_000)
_DICT_DATA = _DIC[:3000] + _DATA[:120_000] + _DIC[70_000:76_000]


@pytest.mark.parametrize("mode,kw", [
    ("independent", dict()),
    ("independent_standalone_chunks", dict(chunk_windows=False)),
    ("linked", dict(parallel_linked=True)),
    ("dictionary", dict(dictionary=_DIC, dictionary_id=7)),
    ("dictionary_standalone_flag", dict(dictionary=_DIC, chunk_windows=False)),
    ("dictionary_linked", dict(dictionary=_DIC, parallel_linked=True, block_checksums=True)),
    ("short_dictionary_linked", dict(dictionary=_DIC[:5000], parallel_linked=True)),
])
def test_lane_frames_read_back_by_jax_and_by_the_port(mode, kw):
    data = _DICT_DATA if "dictionary" in kw else _DATA
    dic = kw.get("dictionary")
    frame = lt.compress_frame_parallel(data, 1 << 16, device="cpu", lane_kernel=True, **kw)
    assert lz4tpu.decompress_frame(frame, engine="native", dictionary=dic or b"") == data
    assert lt.decompress_frames_parallel([frame], device="cpu", dictionaries=[dic]) == [data]
    sizes, reader = _frame_sizes(frame)
    assert len(sizes) == -(-len(data) // 65536)  # whole blocks, not chunks
    assert reader.flags.independent_blocks == (not kw.get("parallel_linked", False))
    if not kw.get("parallel_linked"):
        assert lt.decompress_frame_parallel(frame, device="cpu", dictionary=dic) == data


def test_lane_frame_windows_pay_and_linked_is_no_larger():
    def size(data=_DATA, **kw):
        return len(lt.compress_frame_parallel(data, 1 << 16, device="cpu", lane_kernel=True, **kw))

    assert size(parallel_linked=True) <= size() < size(chunk_windows=False)
    assert size(_DICT_DATA, dictionary=_DIC) < size(_DICT_DATA)
    assert size(_DICT_DATA, dictionary=_DIC, parallel_linked=True) <= size(_DICT_DATA,
                                                                          dictionary=_DIC)


def test_lane_big_block_merged_frame_has_true_256k_blocks():
    """Blocks larger than a chunk come out as ONE block of the declared size
    each (the block count of tests/test_compress128_window.py:181-208)."""
    data = make_corpus_sample(60, 500_000)
    frame = lt.compress_frame_parallel(data, 1 << 18, device="cpu", lane_kernel=True)
    assert lz4tpu.decompress_frame(frame, engine="native") == data
    assert lt.decompress_frame_parallel(frame, device="cpu") == data
    sizes, reader = _frame_sizes(frame)
    assert len(sizes) == 2 and reader.block_maxsize == 1 << 18
    assert not any(stored for _, stored in sizes)


def test_lane_frame_stores_blocks_that_do_not_shrink():
    data = make_corpus_sample(330, 65536) + _rand(42, 65536) + make_corpus_sample(331, 2000)
    frame = lt.compress_frame_parallel(data, 1 << 16, device="cpu", lane_kernel=True)
    assert lz4tpu.decompress_frame(frame, engine="native") == data
    sizes, _ = _frame_sizes(frame)
    assert [stored for _, stored in sizes] == [False, True, False]
    assert sizes[1][0] == 65536


def test_lane_frame_independent_windows_stop_at_the_block():
    """Block 1 opens with the last 20,000 bytes of block 0 and is random
    otherwise: behind a linked window it is one long match and the rest; an
    independent block must not see across the boundary and is stored."""
    first = _rand(77, 65536)
    data = first + first[-20_000:] + _rand(78, 45_536)
    frame = lt.compress_frame_parallel(data, 1 << 16, device="cpu", lane_kernel=True)
    sizes, _ = _frame_sizes(frame)
    assert sizes == [(65536, True), (65536, True)]
    assert lz4tpu.decompress_frame(frame, engine="native") == data
    linked = lt.compress_frame_parallel(data, 1 << 16, device="cpu", lane_kernel=True,
                                        parallel_linked=True)
    sizes, _ = _frame_sizes(linked)
    assert sizes[0] == (65536, True) and not sizes[1][1] and sizes[1][0] < 46_500
    assert lz4tpu.decompress_frame(linked, engine="native") == data


@pytest.mark.parametrize("data", [b"", b"x", b"abc" * 100], ids=["empty", "one_byte", "short"])
def test_lane_frame_small_inputs(data):
    for linked in (False, True):
        frame = lt.compress_frame_parallel(data, device="cpu", lane_kernel=True,
                                           parallel_linked=linked)
        assert lz4tpu.decompress_frame(frame, engine="native") == data
        assert lt.decompress_frames_parallel([frame], device="cpu") == [data]
