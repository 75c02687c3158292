"""The two kernels redesigned for Hopper in the port's sixth slice, on the CPU.

decode_v4.cu now spreads one LZ4 block over the card: speculative walks from
segment starts, rounds that bring the walks into step with the true chain
and a serial finish behind them, placement by a scan, the first failure by
a minimum, literals, and match sources resolved by pointer doubling.  Its
model, ``decode_v4_segmented_plain``, must equal ``decode_plain``, the
specification, byte for byte (bytes, lengths and statuses) at segments of
16, 64 and 1024 bytes, so that short segments force walks out of step; the
desync streams must reach the serial finish.

decode_v3.cu now runs the shared 32-sequence walk with two read-ahead
windows: its model is ``decode_big_batched_plain`` at ``DECODE_V3``.
"""

import pathlib
import random
import re

import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
import lz4tpu_torch as lt
from lz4tpu.kernels.decompress_v4 import decompress_blocks_v4 as jax_decode_v4
from lz4tpu.spec.block import DecodeError as SpecDecodeError
from lz4tpu.spec.block import compress_block
from lz4tpu.spec.table import U16Table, U32Table
from lz4tpu_torch.kernels import decodebig as dbig
from lz4tpu_torch.kernels import decompress_v4 as dv4
from lz4tpu_torch.kernels.decode128 import decode_plain
from lz4tpu_torch.kernels.pack import pack_rows
from lz4tpu_torch.kernels.status import (
    ERR_INVALID_OFFSET,
    ERR_MEMORY_LIMIT,
    ERR_UNEXPECTED_END,
    OK,
)

from conftest import make_corpus_sample

SEGMENTS = [16, 64, 1024]


def v4_models(blocks, prefixes, limit, segment, v3=True):
    """``decode_plain`` against v4's model at ``segment`` (and v3's at its
    geometry); returns the plain version's (out, out_len, status) and the
    model's per-block info."""
    comp, comp_len = pack_rows(blocks, "cpu")
    prefix, prefix_len = pack_rows(prefixes, "cpu", align_right=True)
    cap = -(-(limit + comp.shape[1]) // 16) * 16
    want = decode_plain(comp, comp_len, prefix, prefix_len, limit, cap)
    *got, infos = dv4.decode_v4_segmented_plain(comp, comp_len, prefix, prefix_len, limit, cap,
                                                segment=segment)
    for label, g, w in zip(("out", "out_len", "status"), got, want):
        assert torch.equal(g, w), (label, segment)
    if v3:
        got = dbig.decode_big_batched_plain(comp, comp_len, prefix, prefix_len, limit, cap,
                                            dbig.DECODE_V3)
        for label, g, w in zip(("out", "out_len", "status"), got, want):
            assert torch.equal(g, w), (label, "v3")
    return want, infos


@pytest.mark.parametrize("segment", SEGMENTS)
def test_v4_model_on_the_edge_streams_of_the_card(segment):
    """Batches of 31, 32 and 33 sequences, every stream ending, every error
    kind around a batch boundary with a later error behind it."""
    blocks, prefixes = chip_smoke.decoder_edge_streams()
    want, _ = v4_models(blocks, prefixes, 2048, segment)
    assert len(set(want[2].tolist())) == 5


@pytest.mark.parametrize("segment", SEGMENTS)
@pytest.mark.parametrize("seed", range(2))
def test_v4_model_real_and_hostile_blocks(segment, seed):
    """Compressed 16 KiB blocks, one behind the 16 KiB before it, and the
    card's hostile variants of them (truncations, flips, stray bytes)."""
    r = random.Random(seed)
    data = make_corpus_sample(600 + seed, 4 * 16384)
    raw = [data[i : i + 16384] for i in range(0, len(data), 16384)]
    comp, _ = lt.compress_blocks(raw, device="cpu")
    blocks = [c for c in comp if c is not None]
    prefixes = [b""] * len(blocks)
    linked, _ = lt.compress_blocks([data[16384 : 3 * 16384]], cursors=[16384],
                                   tables=[U32Table()], prime_prefix=True, device="cpu")
    blocks.append(linked[0])
    prefixes.append(data[16384 : 2 * 16384])
    bad = chip_smoke.hostile_blocks(blocks, r)
    want, infos = v4_models(blocks + bad, prefixes + [r.choice([b"", data[:300]]) for _ in bad],
                            1 << 16, segment)
    assert want[1][: len(raw)].tolist() == [16384] * len(raw)
    assert len(set(want[2].tolist())) >= 4
    if segment == 16:  # short segments start walks out of step, rounds bring them back
        assert sum(info["rounds"] for info in infos) > len(infos)


@pytest.mark.parametrize("segment", SEGMENTS)
def test_v4_model_mutated_blocks(segment):
    """Seeded mutations of compressed blocks and random strings, half behind
    a prefix they may reach into (limit 8 KiB), as the card's fuzz batch."""
    fuzz = random.Random(0x70C4 + segment)
    data = make_corpus_sample(77, 20000)
    seeds = [bytes(compress_block(data[k * 1500 :][: 1024 + 256 * k], 0, U16Table()))
             for k in range(8)]
    blocks = [chip_smoke.mutate(fuzz, fuzz.choice(seeds)) for _ in range(150)]
    blocks += [fuzz.randbytes(fuzz.randrange(0, 300)) for _ in range(40)]
    prefixes = [fuzz.choice([b"", b"", data[:3000], data[:7]]) for _ in blocks]
    want, _ = v4_models(blocks, prefixes, 8192, segment)
    assert (want[2] == OK).sum() > 10 and (want[2] != OK).sum() > 10


@pytest.mark.parametrize("segment", SEGMENTS)
def test_v4_model_window_streams(segment):
    """Length runs, long literal runs and long matches all along: walks
    that start inside literals and inside LSIC runs."""
    blocks, largest = chip_smoke.decoder_window_streams(random.Random(segment), 2, 1 << 16)
    want, _ = v4_models(blocks, [b""] * len(blocks), 1 << 16, segment)
    assert not want[2].any()


@pytest.mark.parametrize("valid", [True, False])
@pytest.mark.parametrize("phase", [1, 3])
@pytest.mark.parametrize("segment", SEGMENTS)
def test_v4_model_desync_streams_reach_the_serial_finish(valid, phase, segment):
    """Streams whose walks from segment starts never fall into step: every
    round fixes one segment, so a stream of more than ROUNDS + 1 segments
    needs the serial finish, and its result is still the specification's."""
    r = random.Random(phase * 10 + valid)
    repeats = (dv4.ROUNDS + 3) * segment // 4
    block = chip_smoke.desync_stream(r, repeats, valid, phase)
    want, (info,) = v4_models([block], [b""], 1 << 16, segment)
    assert info["serial"] and info["rounds"] == dv4.ROUNDS
    assert info["serial_changed"] >= info["segments"] - dv4.ROUNDS - 2
    assert int(want[2][0]) == (OK if valid else ERR_INVALID_OFFSET)
    assert int(want[1][0]) == {1: 12, 3: 14}[phase] + 4 + 5 * repeats + (3 if valid else 0)


def test_v4_model_desync_streams_of_the_card():
    """The desync streams chip_smoke.py runs on the card, at the kernel's
    segment: each reaches the serial finish."""
    blocks = chip_smoke.desync_streams()
    want, infos = v4_models(blocks, [b""] * len(blocks), 1 << 16, dv4.SEGMENT, v3=False)
    assert all(info["serial"] for info in infos)
    assert set(want[2].tolist()) == {OK, ERR_INVALID_OFFSET}


@pytest.mark.parametrize("segment", SEGMENTS)
def test_v4_model_lsic_runs_and_stream_ends(segment):
    """Walks that land inside long runs of 0xFF length bytes, runs that end
    the stream, a chain that ends exactly at a segment's start, and the stray
    trailing byte."""
    seq = chip_smoke.seq
    r = random.Random(segment)
    noise = r.randbytes(3000)
    # a first sequence of exactly one segment: the chain meets the next
    # segment at its first byte
    lead = next(lit for lit in range(segment) if len(seq(noise[:lit], 4, 4)) == segment)
    blocks = [
        seq(b"abcd", 4, 4) + seq(b"", 1, 4 + 15 + 255 * 40) + seq(b"end"),  # a long match run
        seq(noise[:1500], 7, 4) + seq(b"x"),  # a long literal run
        seq(b"abcd", 4, 4) + b"\x0f\x01\x00" + b"\xff" * 700,  # the run ends the stream
        b"\xf0" + b"\xff" * 900,  # a literal run that ends the stream
        seq(noise[:lead], 4, 4) + seq(b"abcd", 4, 4) + seq(b"tail"),
        seq(b"abcd", 4, 4) + b"\x00",  # stray byte, clean
        seq(b"abcd", 4, 4) + b"\x10",  # stray byte, truncated
    ]
    want, _ = v4_models(blocks, [b""] * len(blocks), 16384, segment)
    st_ = want[2].tolist()
    assert st_[0] == OK and st_[1] == OK and st_[2] == ERR_UNEXPECTED_END
    assert st_[3] == ERR_UNEXPECTED_END and st_[4] == OK
    assert st_[5] == OK and st_[6] == ERR_UNEXPECTED_END


@pytest.mark.parametrize("segment", SEGMENTS)
def test_v4_model_deep_match_chains_take_doubling_rounds(segment):
    """Each match copies the one before it (offset = its length), so a
    byte's source chain runs back through every match: doubling takes
    about log2 of their count, and a match past the limit still fails."""
    seq = chip_smoke.seq
    body = seq(b"0123456789abcdef", 16, 16) + seq(b"", 16, 16) * 300 + seq(b"end")
    want, (info,) = v4_models([body], [b""], 1 << 16, segment)
    assert int(want[2][0]) == OK and int(want[1][0]) == 16 + 16 * 301 + 3
    assert info["doubling"] >= 3  # a chain of 301 matches, 8 times deeper each round
    want, _ = v4_models([body], [b""], 2000, segment)
    assert int(want[2][0]) == ERR_MEMORY_LIMIT


def test_v4_plain_and_model_match_jax_decode_v4_interpret():
    """A small seeded batch through the JAX package's v4 kernel (interpret
    mode), the port's plain version and the model at two segments."""
    raws = [make_corpus_sample(30 + k, 1400 + 150 * k) for k in range(3)]
    blocks = [bytes(compress_block(raw, 0, U16Table())) for raw in raws]
    want = jax_decode_v4(blocks, block_maxsize=1 << 11)
    assert lt.decompress_blocks_v4(blocks, None, 1 << 11, device="cpu") == want == raws
    for segment in (16, 64):
        got, _ = v4_models(blocks, [b""] * 3, 1 << 11, segment)
        assert [got[0][i, : len(raw)].numpy().tobytes() for i, raw in enumerate(raws)] == raws
    for bad in (b"\x10A\x00\x00", b"\x10A\x05\x00", b"\x40ab"):
        with pytest.raises(SpecDecodeError) as jax_err:
            jax_decode_v4([bad], block_maxsize=1 << 11)
        with pytest.raises(lt.DecodeError) as port_err:
            lt.decompress_blocks_v4([bad], None, 1 << 11, device="cpu")
        assert port_err.value.kind == jax_err.value.kind


def test_v4_refuses_sizes_past_32_bits():
    comp = torch.zeros((1, 16), dtype=torch.uint8)
    i32 = torch.zeros(1, dtype=torch.int32)
    no_prefix = torch.zeros((1, 0), dtype=torch.uint8)
    with pytest.raises(ValueError, match="2 GiB"):
        dv4.decode_v4(comp, i32, no_prefix, i32, 1 << 31)


@pytest.mark.parametrize("name, const", [("SEGMENT", "SEG"), ("ROUNDS", "ROUNDS"),
                                         ("HEAD", "HEAD"), ("HOPS", "HOPS")])
def test_v4_model_constants_match_the_kernel_source(name, const):
    """The model and chip_smoke's desync streams are sized from these; the
    kernel's own values are its source's constexprs."""
    src = (pathlib.Path(dv4.__file__).parents[1] / "csrc" / "decode_v4.cu").read_text()
    found = re.findall(rf"^constexpr int {const} = (\d+);", src, re.M)
    assert found == [str(getattr(dv4, name))]


def _streams():
    one = st.builds(
        lambda lit, off, ml: (lit, off, ml),
        st.binary(min_size=0, max_size=40) | st.binary(min_size=100, max_size=300),
        st.integers(0, 70) | st.integers(250, 700),
        st.sampled_from([4, 5, 18, 19, 20, 60, 274, 700]))
    return st.lists(one, min_size=0, max_size=60)


@settings(max_examples=120, deadline=None, suppress_health_check=list(HealthCheck))
@given(ops=_streams(), prefix_len=st.sampled_from([0, 0, 8, 300]),
       last=st.binary(min_size=0, max_size=20), limit=st.sampled_from([1 << 16, 3000]),
       damage=st.lists(st.tuples(st.integers(0, 10**6), st.integers(0, 255)), max_size=2),
       cut=st.none() | st.integers(0, 10**6), segment=st.sampled_from(SEGMENTS))
def test_v4_model_equals_plain_sweep(ops, prefix_len, last, limit, damage, cut, segment):
    prefix = bytes(range(256)) * 2
    prefix = prefix[len(prefix) - prefix_len :] if prefix_len else b""
    seq = chip_smoke.seq
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
    v4_models([bytes(block)], [prefix], limit, segment)
