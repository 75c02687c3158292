"""Models of the two redesigned CUDA kernels, step by step on the CPU.

``compress_batched_plain`` follows ``csrc/compress.cu`` (batches of 32 probe
positions from the skip schedule, in-batch collisions forwarded through the
slot type, first hit or tail lane decides, table writes up to it) and
``decode_big_batched_plain`` follows ``csrc/decode_big.cu`` (the walk over
whole sequences inside the window, per-entry decode behind a prefix sum,
first failure, independent and dependent copy rounds), and at
``decodebig.DECODE128`` ``csrc/decode128.cu``, which runs the same walk.  Both must equal the
plain versions, which are the specification, byte for byte: bytes, lengths,
statuses and tables.  The compressor's model is also held against the JAX
package's spec and its scalar kernel in interpret mode.
"""

import random

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from lz4tpu.kernels.compress import compress_blocks as jax_compress_blocks
from lz4tpu.spec.block import Incompressible as SpecIncompressible
from lz4tpu.spec.block import compress_block as spec_compress_block
from lz4tpu.spec.table import U16Table, U32Table
from lz4tpu_torch.kernels import compress as kc
from lz4tpu_torch.kernels import decodebig as dbig
from lz4tpu_torch.kernels.decode128 import decode_plain
from lz4tpu_torch.kernels.pack import pack_rows
from lz4tpu_torch.kernels.status import (
    ERR_INVALID_OFFSET,
    ERR_MEMORY_LIMIT,
    ERR_UNEXPECTED_END,
    ERR_ZERO_OFFSET,
    OK,
    STATUS_INCOMPRESSIBLE,
)
from lz4tpu_torch.spec.block import compress_bound
from lz4tpu_torch.spec.table import U16_SLOTS, U32_SLOTS

# ---------------------------------------------------------------------------
# the compressor
# ---------------------------------------------------------------------------


def both_compressors(rows, cursors=None, caps=None, accel=1, toffs=None, prime=None, u16=False,
                     tables=None):
    """The same batch through ``compress_plain`` and ``compress_batched_plain``;
    asserts that out, out_len, status and tables are equal and returns them."""
    n = len(rows)
    width = max(max(map(len, rows)), 16)
    arr = np.zeros((n, width), np.uint8)
    for i, r in enumerate(rows):
        arr[i, : len(r)] = np.frombuffer(r, np.uint8)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32)

    slots = U16_SLOTS if u16 else U32_SLOTS
    if tables is None:
        tables = np.zeros((n, slots), np.int32)
    args = (torch.from_numpy(arr), i32([len(r) for r in rows]), i32(cursors or [0] * n),
            i32(caps or [-1] * n), i32([accel] * n), i32(toffs or [0] * n),
            i32(prime or [0] * n), torch.from_numpy(tables), compress_bound(width) + 16)
    want = kc.compress_plain(*args)
    got = kc.compress_batched_plain(*args)
    for label, g, w in zip(("out", "out_len", "status", "tables"), got, want):
        assert torch.equal(g, w), label
    return want


def far_copy_shifted(r: random.Random, size: int) -> bytes:
    """Random bytes, then a far copy of them shifted by one: a literal run as
    long as the first part, then a match that backtracks a long way."""
    noise = r.randbytes(size)
    return noise + b"#" + noise


EDGE_ROWS = {
    "zeros": (bytes(5000), {}),
    "period2": (b"ab" * 2500, {}),
    "period3": (b"abc" * 1700, {}),
    "word5": (b"hello" * 1000, {}),  # every fifth position shares a hash
    "incompressible_accel8": (random.Random(1).randbytes(65536), dict(accel=8)),
    "far_copy_shifted": (far_copy_shifted(random.Random(2), 20000), {}),
    "far_copy_shifted_accel8": (far_copy_shifted(random.Random(3), 30000), dict(accel=8)),
    "empty": (b"", {}),
    "five": (b"abcde", {}),
    "twelve": (b"aaaaaaaaaaaa", {}),
    "thirteen": (b"aaaaaaaaaaaaa", {}),
    "cursor_at_end": (b"abcdabcdabcdabcdabcd", dict(cursors=[20])),
    "cursor_past_first_probe": (b"xyzxyzxyz" * 40, dict(cursors=[9])),
}


@pytest.mark.parametrize("u16", [False, True], ids=["u32", "u16"])
@pytest.mark.parametrize("name", list(EDGE_ROWS))
def test_compress_model_equals_plain_on_edge_rows(name, u16):
    row, kw = EDGE_ROWS[name]
    if u16 and len(row) > 0xFFFF:
        row = row[:0xFFFF]
    both_compressors([row], u16=u16, **kw)


@pytest.mark.parametrize("toff", [1, 7, 40000, 65535, 70000])
@pytest.mark.parametrize("u16", [False, True], ids=["u32", "u16"])
def test_compress_model_forwards_candidates_through_slot_type_and_offset(toff, u16, corpus_sample):
    """A table offset, slots full of stale values, rows that collide inside a
    batch: the forwarded candidate must take the slot's trip (truncation to
    the slot type, minus the offset, saturating at 0)."""
    r = random.Random(toff)
    slots = U16_SLOTS if u16 else U32_SLOTS
    top = 1 << (16 if u16 else 32)
    rows = [bytes(3000), b"ab" * 1500, b"abc" * 1000, b"hello" * 600, corpus_sample(toff, 6000)]
    tables = np.array([[r.randrange(top) if r.random() < 0.5 else 0 for _ in range(slots)]
                       for _ in rows], dtype=np.uint32).view(np.int32)
    both_compressors(rows, toffs=[toff] * len(rows), u16=u16, tables=tables)
    both_compressors(rows, toffs=[toff] * len(rows), u16=u16, tables=tables, cursors=[100] * 5,
                     prime=[1] * 5)


@pytest.mark.parametrize("u16", [False, True], ids=["u32", "u16"])
def test_compress_model_aborts_with_the_table_mutated_like_plain(u16, corpus_sample):
    """Every cap from 0 up: each group boundary is hit once, the ones right
    after a ``cursor - 2`` re-insert included; bytes before the abort, zeros
    after, and the table as the serial parse left it."""
    row = corpus_sample(33, 700) + bytes(40) + random.Random(5).randbytes(60)
    full = both_compressors([row], u16=u16)
    size = int(full[1][0])
    caps = list(range(0, size + 2))
    want = both_compressors([row] * len(caps), caps=caps, u16=u16)
    statuses = want[2].tolist()
    assert statuses[size:] == [0, 0] and set(statuses[:size]) == {STATUS_INCOMPRESSIBLE}
    assert len({int(x) for x in want[1][:size]}) >= 10  # many different abort points


def test_compress_model_primes_like_plain(corpus_sample):
    window = corpus_sample(50, 65536)
    block = corpus_sample(51, 9000)
    rows = [window + block, window[-3000:] + block, window[:10] + block, block]
    both_compressors(rows, cursors=[65536, 3000, 10, 0], prime=[1, 1, 1, 1],
                     caps=[len(block)] * 4)


def _rows():
    """Hypothesis rows: random bytes, runs, short periods and self-copies."""
    piece = st.one_of(
        st.binary(min_size=1, max_size=40),
        st.builds(lambda b, k: bytes([b]) * k, st.integers(0, 255), st.integers(1, 300)),
        st.builds(lambda w, k: w * k, st.binary(min_size=2, max_size=6), st.integers(1, 80)),
    )
    return st.lists(piece, min_size=0, max_size=30).map(b"".join).flatmap(
        lambda d: st.builds(lambda a, b: d + d[a : a + b], st.integers(0, max(len(d), 1)),
                            st.integers(0, 400)))


@settings(max_examples=120, deadline=None, suppress_health_check=list(HealthCheck))
@given(row=_rows(), u16=st.booleans(), accel=st.sampled_from([1, 1, 2, 8, 33]),
       toff=st.sampled_from([0, 0, 3, 65530]), cursor_frac=st.sampled_from([0.0, 0.0, 0.3, 1.0]),
       prime=st.booleans(), cap=st.sampled_from([-1, -1, 0.5, 0.9]))
def test_compress_model_equals_plain_sweep(row, u16, accel, toff, cursor_frac, prime, cap):
    cursor = int(len(row) * cursor_frac)
    both_compressors([row], cursors=[cursor], accel=accel, toffs=[toff], prime=[int(prime)],
                     caps=[-1 if cap < 0 else int(len(row) * cap)], u16=u16)


def model_blocks(datas, tables, caps=None, accel=1):
    """``compress_blocks`` on the model: (payload or None per block), tables
    written back."""
    u16 = isinstance(tables[0], U16Table)
    packed = np.stack([t.dict.astype(np.uint32) for t in tables]).view(np.int32)
    width = max(max(map(len, datas)), 16)
    arr = np.zeros((len(datas), width), np.uint8)
    for i, d in enumerate(datas):
        arr[i, : len(d)] = np.frombuffer(d, np.uint8)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32)

    n = len(datas)
    out, out_len, status, table_out = kc.compress_batched_plain(
        torch.from_numpy(arr), i32([len(d) for d in datas]), i32([0] * n),
        i32([-1 if c is None else c for c in (caps or [None] * n)]), i32([accel] * n),
        i32([0] * n), i32([0] * n), torch.from_numpy(packed), compress_bound(width) + 16)
    assert table_out.shape[1] == (U16_SLOTS if u16 else U32_SLOTS)
    for t, row in zip(tables, table_out.numpy().view(np.uint32)):
        t.dict[:] = row.astype(t.dict.dtype)
    return [None if s else out[i, : out_len[i]].numpy().tobytes()
            for i, s in enumerate(status.tolist())]


def test_compress_model_matches_jax_scalar_kernel_interpret(corpus_sample):
    rng = random.Random(7)
    datas = [corpus_sample(700, 3000), corpus_sample(701, 2500),
             bytes(rng.getrandbits(8) for _ in range(1500))]
    caps = [None, 100, 1500]
    t_jax = [U32Table() for _ in datas]
    t_model = [t.copy() for t in t_jax]
    want, _ = jax_compress_blocks(datas, tables=t_jax, caps=caps)
    assert model_blocks(datas, t_model, caps) == want
    assert want[1] is None and want[2] is None
    for a, b in zip(t_jax, t_model):
        assert np.array_equal(a.dict, b.dict)


@pytest.mark.parametrize("table", [U16Table, U32Table], ids=["u16", "u32"])
@pytest.mark.parametrize("name", ["zeros", "period2", "period3", "word5", "far_copy_shifted",
                                  "incompressible_accel8", "five", "twelve", "thirteen"])
def test_compress_model_matches_spec_on_edge_rows(name, table):
    row, kw = EDGE_ROWS[name]
    if table is U16Table:
        row = row[:0xFFFF]
    accel = kw.get("accel", 1)
    t_spec, t_model = table(), table()
    try:
        want = bytes(spec_compress_block(row, 0, t_spec, acceleration=accel))
    except SpecIncompressible:
        want = None
    assert model_blocks([row], [t_model], accel=accel) == [want]
    assert np.array_equal(t_spec.dict, t_model.dict)


# ---------------------------------------------------------------------------
# the big-block decoder
# ---------------------------------------------------------------------------

SMALL_GEOMETRIES = [
    dbig.Geometry(),
    # a window of a few hundred bytes that moves all the time, 64-byte batches
    dbig.Geometry(batch_bytes=64, small=64, piece=128, window=480, refill_margin=400),
    dbig.Geometry(batch_bytes=256, small=200, piece=512, window=4096, refill_margin=2800),
    # decode128.cu's walk, which reads a long sequence's literals where they lie
    dbig.DECODE128,
    dbig.Geometry(batch_bytes=64, small=64, piece=128, window=480, refill_margin=400,
                  stage_long=False),
]


def lsic(v: int) -> bytes:
    return b"" if v < 15 else b"\xff" * ((v - 15) // 255) + bytes([(v - 15) % 255])


def seq(lit: bytes = b"", offset: int = 0, ml: int = 0) -> bytes:
    """One sequence; ``ml == 0``: literals only (a block's last sequence)."""
    if not ml:
        return bytes([min(len(lit), 15) << 4]) + lsic(len(lit)) + lit
    return (bytes([(min(len(lit), 15) << 4) | min(ml - 4, 15)]) + lsic(len(lit)) + lit
            + offset.to_bytes(2, "little") + lsic(ml - 4))


def both_decoders(blocks, prefixes, limit, geometries=SMALL_GEOMETRIES):
    comp, comp_len = pack_rows(blocks, "cpu")
    prefix, prefix_len = pack_rows(prefixes, "cpu", align_right=True)
    cap = -(-(limit + comp.shape[1]) // 16) * 16
    want = decode_plain(comp, comp_len, prefix, prefix_len, limit, cap)
    for geo in geometries:
        got = dbig.decode_big_batched_plain(comp, comp_len, prefix, prefix_len, limit, cap, geo)
        for label, g, w in zip(("out", "out_len", "status"), got, want):
            assert torch.equal(g, w), (label, geo)
    return want


MINIMAL = seq(b"", 4, 4)  # three bytes: copies the four bytes before it


@pytest.mark.parametrize("count", [1, 31, 32, 33, 64, 65])
@pytest.mark.parametrize("ending", ["literals", "match", "stray_clean", "stray_truncated"])
def test_decode_model_minimal_sequences_and_stream_ends(count, ending):
    """Batches that fill exactly, by one more and by one less, each match
    reading the one before it, and every way a stream may end at the batch
    boundary."""
    body = seq(b"abcd", 4, 4) + MINIMAL * (count - 1)
    tail = {"literals": seq(b"xyz"), "match": b"", "stray_clean": b"\x00",
            "stray_truncated": b"\x10"}[ending]
    want = both_decoders([body + tail], [b""], 1 << 16)
    expected = ERR_UNEXPECTED_END if ending == "stray_truncated" else OK
    assert int(want[2][0]) == expected
    assert int(want[1][0]) == 4 + 4 * count + (3 if ending == "literals" else 0)


BAD = {
    ERR_ZERO_OFFSET: seq(b"", 0, 4),
    ERR_INVALID_OFFSET: seq(b"", 0xFFFF, 4),
    ERR_MEMORY_LIMIT: seq(b"", 4, 4000),
    ERR_UNEXPECTED_END: b"\xf0\xff\xff\xff",  # more literals than the stream has left
}


@pytest.mark.parametrize("entry", [0, 1, 31, 32])
@pytest.mark.parametrize("kind", list(BAD))
def test_decode_model_first_failing_sequence_wins(kind, entry):
    """Each error kind at entry 0, 1 and 31 of a batch (and 0 of the next):
    the sequences before it are decoded, a later error does not matter."""
    block = MINIMAL * entry + BAD[kind] + BAD[ERR_ZERO_OFFSET] + seq(b"zz")
    want = both_decoders([block], [b"wxyz"], 2048)
    assert int(want[2][0]) == kind
    assert int(want[1][0]) == 4 * entry
    assert want[0][0, : 4 * entry].numpy().tobytes() == b"wxyz" * entry


def test_decode_model_memory_limit_is_checked_at_matches_only():
    block = seq(b"abcd", 4, 4) + seq(b"q" * 300)
    want = both_decoders([block], [b""], 100)  # literals pass the limit
    assert int(want[2][0]) == OK and int(want[1][0]) == 308
    block = seq(b"abcd", 4, 4) + seq(b"q" * 300, 2, 4)
    assert int(both_decoders([block], [b""], 100)[2][0]) == ERR_MEMORY_LIMIT


@pytest.mark.parametrize("run", [15, 269, 270, 400, 1000])
@pytest.mark.parametrize("lead", range(440, 486, 5))  # bytes before the run
def test_decode_model_length_run_straddles_the_window_end(run, lead):
    """A literal or match length run (and the literals behind it) across the
    end of a 480-byte window, at every phase."""
    r = random.Random(run * 1000 + lead)
    head = seq(r.randbytes(8 + lead % 6), 8, 4)
    filler = b"".join(seq(r.randbytes(3), 5, 5) for _ in range(lead // 6))  # 6 bytes each
    blocks = []
    for straddler in (seq(r.randbytes(run), 7, 4), seq(b"ab", 2, run + 4)):
        blocks.append(head + filler + straddler + seq(b"end"))
    want = both_decoders(blocks, [b"", b""], 1 << 16)
    assert want[2].tolist() == [OK, OK]


def test_decode_model_long_sequences_are_batches_of_their_own():
    r = random.Random(9)
    noise = r.randbytes(700)
    block = (seq(b"abcd", 4, 4) + seq(noise, 3, 900) + MINIMAL * 3 + seq(b"", 1, 5000)
             + seq(noise[:300]))
    want = both_decoders([block], [b""], 1 << 16)
    assert int(want[2][0]) == OK and int(want[1][0]) == 8 + 1600 + 12 + 5000 + 300


def test_decode_model_dependent_and_independent_matches_in_one_batch():
    """Matches that read older output, their own literals, the sequence
    before them, and an overlap that repeats a pattern across all three."""
    prefix = bytes(range(200))
    block = (seq(b"AB", 150, 20)       # older output only
             + seq(b"CDEF", 4, 12)     # its own literals, overlapping itself
             + seq(b"", 30, 25)        # the two sequences before it
             + seq(b"G", 60, 59)       # older output up to its own literal
             + seq(b"HI", 3, 40)       # one byte of the sequence before, then its literals
             + seq(b"tail"))
    want = both_decoders([block], [prefix], 4096)
    assert int(want[2][0]) == OK


def _streams():
    """Hypothesis streams: sequences of every shape, sometimes broken."""
    one = st.builds(
        lambda lit, off, ml: (lit, off, ml),
        st.binary(min_size=0, max_size=40) | st.binary(min_size=200, max_size=600),
        st.integers(0, 70) | st.integers(250, 700),
        st.sampled_from([4, 5, 18, 19, 20, 60, 274, 700, 3000]))
    return st.lists(one, min_size=0, max_size=80)


@settings(max_examples=150, deadline=None, suppress_health_check=list(HealthCheck))
@given(ops=_streams(), prefix_len=st.sampled_from([0, 0, 8, 300]),
       last=st.binary(min_size=0, max_size=20), limit=st.sampled_from([1 << 16, 1 << 16, 3000]),
       damage=st.lists(st.tuples(st.integers(0, 10**6), st.integers(0, 255)), max_size=2),
       cut=st.none() | st.integers(0, 10**6))
def test_decode_model_equals_plain_sweep(ops, prefix_len, last, limit, damage, cut):
    prefix = bytes(range(256)) * 2
    prefix = prefix[len(prefix) - prefix_len :] if prefix_len else b""
    block = bytearray()
    written = prefix_len
    for lit, off, ml in ops:
        written += len(lit)
        off = min(off, written) if off else 0  # mostly valid; 0 stays a zero offset
        block += seq(lit, off, ml)
        written += ml
    block += seq(last)
    for where, value in damage:
        block[where % len(block)] = value
    if cut is not None:
        del block[cut % (len(block) + 1) :]
    both_decoders([bytes(block)], [prefix], limit)
