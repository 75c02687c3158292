"""The two kernels redesigned for Hopper in the port's fifth slice, on the CPU.

decode128.cu now runs decode_big.cu's batch walk (one thread block a block,
32 sequences a batch behind a prefix sum, first failure by ballot) over an
8 KiB window, with the block's output staged whole: its model,
``decode128_batched_plain``, must equal ``decode_plain``, the
specification, byte for byte (bytes, lengths and statuses) on the streams
``chip_smoke.py`` gives the kernel on the card.

compress128.cu's default and window mode now parse by a definition whose
candidates are found off the walk's chain (``lane_records_plain``); the
records are held against a brute-force reading of that definition, and the
parse (``lane_parse_plain``) against the LZ4 block rules, the port's
decoder and the JAX package's spec decoder.  The JAX lane kernel's sizes and
the size contract are held in ``tests/test_torch_lane.py``.
"""

import random

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
import lz4tpu_torch as lt
from lz4tpu.spec.block import decompress_block as spec_decompress_block
from lz4tpu_torch.kernels import compress128 as c128
from lz4tpu_torch.kernels import decode128 as d128
from lz4tpu_torch.kernels import decodebig as dbig
from lz4tpu_torch.kernels.decode128 import decode_plain
from lz4tpu_torch.kernels.pack import pack_rows
from lz4tpu_torch.kernels.splice import tail_split
from lz4tpu_torch.kernels.status import ERR_MEMORY_LIMIT, OK
from lz4tpu_torch.spec.block import compress_bound
from lz4tpu_torch.spec.table import U32Table

from conftest import make_corpus_sample

# ---------------------------------------------------------------------------
# decode128
# ---------------------------------------------------------------------------

LIMIT = 1 << 16


def decode128_models(blocks, prefixes, limit=LIMIT):
    """``decode_plain`` against decode128's model; returns the plain
    version's (out, out_len, status).  The batch edges, the first failing
    sequence and a sweep run at decode128's geometry in
    ``tests/test_torch_redesign.py``."""
    comp, comp_len = pack_rows(blocks, "cpu")
    prefix, prefix_len = pack_rows(prefixes, "cpu", align_right=True)
    cap = -(-(limit + comp.shape[1]) // 16) * 16
    want = decode_plain(comp, comp_len, prefix, prefix_len, limit, cap)
    got = dbig.decode128_batched_plain(comp, comp_len, prefix, prefix_len, limit, cap)
    for label, g, w in zip(("out", "out_len", "status"), got, want):
        assert torch.equal(g, w), label
    return want


def test_decode128_model_on_the_edge_streams_of_the_card():
    """The hand-made streams ``chip_smoke.py`` runs on the card: batches of
    31, 32 and 33 sequences, every stream ending, every error kind at the
    entries around a batch boundary."""
    blocks, prefixes = chip_smoke.decoder_edge_streams()
    want = decode128_models(blocks, prefixes, 2048)
    assert len(set(want[2].tolist())) == 5


def test_decode128_model_literals_run_past_the_limit_matches_do_not():
    """Literals may pass the limit (the kernel writes those past its staged
    64 KiB to device memory); a match that would is refused."""
    noise = random.Random(3).randbytes(70_000)
    ok = decode128_models([chip_smoke.seq(b"abcd", 4, 4) + chip_smoke.seq(noise)], [b""])
    assert int(ok[2][0]) == OK and int(ok[1][0]) == 8 + len(noise)
    bad = decode128_models([chip_smoke.seq(noise[:65530], 4, 8) + chip_smoke.seq(b"z")], [b""])
    assert int(bad[2][0]) == ERR_MEMORY_LIMIT and int(bad[1][0]) == 0


@pytest.mark.parametrize("seed", range(3))
def test_decode128_model_window_streams(seed):
    """The card's literal-heavy streams into 64 KiB: many windows long,
    length runs all along, sequences over a 1 KiB batch."""
    blocks, largest = chip_smoke.decoder_window_streams(random.Random(seed), 10, LIMIT)
    assert max(map(len, blocks)) > dbig.DECODE128.window and largest <= LIMIT
    want = decode128_models(blocks, [b""] * len(blocks))
    assert not want[2].any()


@pytest.mark.parametrize("seed", range(2))
def test_decode128_model_real_and_hostile_blocks(seed):
    """Compressed 64 KiB blocks, one behind the 64 KiB before it, and the
    card's hostile variants of them."""
    r = random.Random(seed)
    data = make_corpus_sample(900 + seed, 4 * 65536)
    raw = [data[i : i + 65536] for i in range(0, len(data), 65536)]
    comp, _ = lt.compress_blocks(raw, device="cpu")
    blocks = [c for c in comp if c is not None]
    prefixes = [b""] * len(blocks)
    linked, _ = lt.compress_blocks([data[65536 : 3 * 65536]], cursors=[65536],
                                   tables=[U32Table()], prime_prefix=True, device="cpu")
    blocks.append(linked[0])
    prefixes.append(data[65536 : 2 * 65536])
    bad = chip_smoke.hostile_blocks(blocks, r)
    want = decode128_models(blocks + bad, prefixes + [r.choice([b"", data[:300]]) for _ in bad])
    assert want[1][: len(raw)].tolist() == [65536] * len(raw)
    assert len(set(want[2].tolist())) >= 4


def test_decode128_refuses_a_capacity_off_the_16_byte_grid():
    comp = torch.zeros((2, 16), dtype=torch.uint8)
    i32 = torch.zeros(2, dtype=torch.int32)
    no_prefix = torch.zeros((1, 0), dtype=torch.uint8)
    with pytest.raises(ValueError, match="multiple of 16"):
        d128.decode128(comp, i32, no_prefix, i32, 1024, out_capacity=1041)
    out, out_len, status = d128.decode128(comp, i32, no_prefix, i32, 1024)
    assert out.shape == (2, 1040) and not out_len.any() and not status.any()


# ---------------------------------------------------------------------------
# compress128: the candidate pass and the parse
# ---------------------------------------------------------------------------


def brute_records(row: bytes, cur0: int, hashlog: int):
    """``lane_records_plain`` read literally: for each position, the latest
    earlier position of its bucket inside its group and the WAYS latest
    before its group, each verified by a byte compare."""
    n = len(row)
    shift = 32 - hashlog

    def bucket(r):
        word = int.from_bytes(row[r : r + 4], "little")
        return ((word * c128.HASH_MUL) & 0xFFFFFFFF) >> shift

    buckets = [bucket(r) for r in range(n - 3)]
    lengths, offsets = [], []
    for p in range(cur0, n - 11):
        g = p // c128.GROUP * c128.GROUP
        same = [r for r in range(p) if buckets[r] == buckets[p]]
        inside = [r for r in same if r >= g][-1:]
        before = [r for r in same if r < g][::-1][: c128.WAYS]
        best = best_off = 0
        for r in inside + before:
            if p - r > 0xFFFF:
                continue
            span = min(c128.CAP, n - 5 - p)
            m = 0
            while m < span and row[p + m] == row[r + m]:
                m += 1
            if m > best:
                best, best_off = m, p - r
        lengths.append(best if best >= 4 else 0)
        offsets.append(best_off if best >= 4 else 0)
    return lengths, offsets


def _record_rows():
    r = random.Random(11)
    motif = b"the cat sat on the mat. "
    return {
        "corpus": (make_corpus_sample(61, 1500), 0),
        "window": (make_corpus_sample(62, 900) + make_corpus_sample(62, 700), 900),
        "window_off_grid": (make_corpus_sample(63, 1300), 301),
        "zeros": (bytes(700), 0),
        "period3": (b"abc" * 300, 0),
        "motif_every_group": (b"".join(motif + r.randbytes(r.randrange(0, 40)) for _ in range(30)), 0),
        "noise": (r.randbytes(800), 0),
        "short": (b"abcdabcdabcdabcd", 0),
        "too_short": (b"abcdefghijk", 0),
    }


@pytest.mark.parametrize("hashlog", [4, 8, 12])
@pytest.mark.parametrize("name", sorted(_record_rows()))
def test_lane_records_equal_brute_force(name, hashlog):
    row, cur0 = _record_rows()[name]
    length, offset = c128.lane_records_plain(row, cur0, hashlog)
    want_len, want_off = brute_records(row, cur0, hashlog)
    assert length.tolist() == want_len
    assert offset.tolist() == want_off


def test_lane_records_take_candidates_inside_a_group_and_four_ways_back():
    """A word seen six times: at 330 the longest match is the oldest of the
    four ways before its group; at 400 it is the sighting at 386, earlier
    in the same group of 32."""
    r = random.Random(5)
    key, long_tail, short_tail = b"KEY!", r.randbytes(20), r.randbytes(8)
    row = bytearray(r.randbytes(480))
    for at, tail in ((10, long_tail), (70, b"x" * 20), (140, b"y" * 20), (200, b"z" * 20),
                     (330, long_tail), (386, short_tail), (400, short_tail)):
        row[at : at + 4 + len(tail)] = key + tail
    length, offset = c128.lane_records_plain(bytes(row), 0, 12)
    assert (offset[330], length[330]) == (320, 24)
    assert (offset[400], length[400]) == (14, 12)


def lz4_sequences(stream: bytes):
    """(literal count, match length, offset) of each sequence of a valid
    stream; the last has match length 0."""
    pos, out = 0, []
    while True:
        token = stream[pos]
        pos += 1
        lit = token >> 4
        if lit == 15:
            while True:
                pos += 1
                lit += stream[pos - 1]
                if stream[pos - 1] != 255:
                    break
        pos += lit
        if pos == len(stream):
            out.append((lit, 0, 0))
            return out
        off = stream[pos] | stream[pos + 1] << 8
        pos += 2
        ml = token & 15
        if ml == 15:
            while True:
                pos += 1
                ml += stream[pos - 1]
                if stream[pos - 1] != 255:
                    break
        out.append((lit, ml + 4, off))


def check_lane_stream(row: bytes, cur0: int, stream: bytes, tail_pos: int, tail_lit: int):
    """The contract of default and window mode for one row."""
    n = len(row)
    block, prefix = row[cur0:], row[:cur0]
    assert bytes(spec_decompress_block(stream, prefix=prefix, output_limit=1 << 20)) == block
    (port,) = lt.decompress_blocks_128([stream], 1 << 16, prefixes=[prefix], device="cpu")
    assert port == block
    assert (tail_pos, tail_lit) == tail_split(stream)
    assert len(stream) <= compress_bound(len(block))
    at = cur0
    for lit, ml, off in lz4_sequences(stream):
        at += lit
        if ml:
            assert at + 12 <= n and at + ml <= n - 5  # no match in the last 12 / 5 bytes
            assert 0 < off <= min(at, 0xFFFF)
        at += ml
    assert at == n


def _parse_rows():
    win = make_corpus_sample(70, 20_000)
    return {
        "corpus_32k": (make_corpus_sample(71, 32768), 0),
        "window_64k_behind": (make_corpus_sample(72, 65536) + make_corpus_sample(72, 20_000), 65536),
        "window_short": (win[:3000] + win[1000:9000], 3000),
        "window_unaligned": (win[:777] + win[:5000], 777),
        "zeros": (bytes(10_000), 0),
        "period2": (b"ab" * 3000, 0),
        "noise_then_copy": (random.Random(9).randbytes(2000) * 3, 0),
        "empty": (b"", 0),
        "twelve": (b"aaaaaaaaaaaa", 0),
        "thirteen": (b"aaaaaaaaaaaaa", 0),
        "block_empty_behind_window": (win[:5000], 5000),
    }


@pytest.mark.parametrize("hashlog", [6, 12])
@pytest.mark.parametrize("name", sorted(_parse_rows()))
def test_lane_parse_keeps_the_contract(name, hashlog):
    row, cur0 = _parse_rows()[name]
    stream, tail_pos, tail_lit = c128.lane_parse_plain(row, cur0, hashlog)
    check_lane_stream(row, cur0, stream, tail_pos, tail_lit)


def test_lane_parse_takes_the_best_of_four_from_the_first_hit():
    """At 200 a 5-byte match, at 201 a 21-byte one: 21 less its distance 1
    beats 5, so the walk leaves 'Q' as a literal and matches from 201."""
    r = random.Random(8)
    row = bytearray(r.randbytes(300))
    row[10:15] = b"Qabcd"
    row[60:81] = b"abcdefghijklmnopqrstu"
    row[59] = ord("#")
    row[200:222] = b"Qabcdefghijklmnopqrstu"
    row = bytes(row)
    length, offset = c128.lane_records_plain(row, 0, 12)
    assert (length[200], length[201], offset[201]) == (5, 21, 141)
    stream, _, _ = c128.lane_parse_plain(row, 0, 12)
    check_lane_stream(row, 0, stream, *tail_split(stream))
    starts, at = {}, 0
    for lit, ml, off in lz4_sequences(stream):
        at += lit
        starts[at] = (ml, off)
        at += ml
    assert 200 not in starts and starts[201] == (21, 141)


@settings(max_examples=60, deadline=None, suppress_health_check=list(HealthCheck))
@given(data=st.lists(st.one_of(
           st.binary(min_size=1, max_size=50),
           st.builds(lambda b, k: bytes([b]) * k, st.integers(0, 255), st.integers(1, 200)),
           st.builds(lambda w, k: w * k, st.binary(min_size=2, max_size=9), st.integers(1, 60))),
           max_size=40).map(b"".join),
       window=st.integers(0, 3000), hashlog=st.sampled_from([4, 9, 12]))
def test_lane_parse_sweep(data, window, hashlog):
    window = min(window, len(data))
    row = data + data[: len(data) // 3]
    stream, tail_pos, tail_lit = c128.lane_parse_plain(row, window, hashlog)
    check_lane_stream(row, window, stream, tail_pos, tail_lit)


def test_compress128_plain_agrees_with_lane_parse_rows():
    """The tensor-level plain version is the row parse, row by row, on rows
    cut from one flat source at any base."""
    rows = [_parse_rows()[k] for k in ("window_short", "corpus_32k", "zeros", "empty")]
    flat = b"".join(r for r, _ in rows)
    n = np.array([len(r) for r, _ in rows], np.int32)
    base = np.cumsum(n, dtype=np.int64) - n
    cur0 = np.array([c for _, c in rows], np.int32)
    out, out_len, tail_pos, tail_lit = c128.compress128(
        torch.frombuffer(bytearray(flat), dtype=torch.uint8), torch.from_numpy(base),
        torch.from_numpy(n), torch.from_numpy(cur0))
    for i, (row, c0) in enumerate(rows):
        stream, tp, tl = c128.lane_parse_plain(row, c0)
        assert out[i, : out_len[i]].numpy().tobytes() == stream
        assert (int(tail_pos[i]), int(tail_lit[i])) == (tp, tl)
        assert not out[i, out_len[i] :].any()


@pytest.mark.parametrize("hashlog", [4, 12])
@pytest.mark.parametrize("name", sorted(_record_rows()) + ["corpus_9000_window_2000"])
def test_lane_kernel_model_equals_the_parse(name, hashlog):
    """The model of the kernel's steps (window rounds, groups taking turns at
    the ways, 32 records a walk step, the cursor kept across tiles) gives
    the parse's bytes."""
    row, cur0 = (make_corpus_sample(64, 9000), 2000) if name.startswith("corpus_9000") \
        else _record_rows()[name]
    assert c128.lane_parse_tiled_plain(row, cur0, hashlog) == c128.lane_parse_plain(row, cur0,
                                                                                   hashlog)


@settings(max_examples=40, deadline=None, suppress_health_check=list(HealthCheck))
@given(data=st.lists(st.one_of(
           st.binary(min_size=1, max_size=50),
           st.builds(lambda b, k: bytes([b]) * k, st.integers(0, 255), st.integers(1, 200)),
           st.builds(lambda w, k: w * k, st.binary(min_size=2, max_size=9), st.integers(1, 60))),
           max_size=30).map(b"".join),
       window=st.integers(0, 1500), hashlog=st.sampled_from([4, 9, 12]))
def test_lane_kernel_model_sweep(data, window, hashlog):
    row = data + data[: len(data) // 2]
    window = min(window, len(row))
    assert c128.lane_parse_tiled_plain(row, window, hashlog) == c128.lane_parse_plain(row, window,
                                                                                     hashlog)
