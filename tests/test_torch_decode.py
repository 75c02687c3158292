"""The port's decoders (plain versions of ``csrc/decode128.cu``,
``csrc/decode_v4.cu``, ``csrc/decode_big.cu`` and ``csrc/decode_v3.cu``) against the JAX package's decode128 and v4 kernels
(interpret mode), its spec and its native engine, on a seeded generative
batch.  Bytes and error kinds must be equal."""

import random

import numpy as np
import pytest

import lz4tpu_torch as lt
from lz4tpu.kernels.decode128 import decompress_blocks_128 as jax_decode128
from lz4tpu.kernels.decompress_v4 import decompress_blocks_v4 as jax_decode_v4
from lz4tpu.native import decompress_block as native_decompress_block
from lz4tpu.spec.block import DecodeError as SpecDecodeError
from lz4tpu.spec.block import compress_block, decompress_block
from lz4tpu.spec.table import U16Table, U32Table
from lz4tpu_torch.kernels import decode128 as d128
from lz4tpu_torch.kernels import decodebig as dbig
from lz4tpu_torch.kernels import decompress as kdec
from lz4tpu_torch.kernels import decompress_v3 as dv3
from lz4tpu_torch.kernels import decompress_v4 as dv4
from lz4tpu_torch.kernels.pack import pack_rows
from lz4tpu_torch.kernels.status import OK, STATUS_TO_KIND

# ---------------------------------------------------------------------------
# seeded generator (modelled on tests/test_fuzz_generative.py)
# ---------------------------------------------------------------------------


def mutate(r: random.Random, buf: bytes, depth: int = 0) -> bytes:
    b = bytearray(buf)
    if not b:
        return bytes(r.getrandbits(8) for _ in range(r.randrange(1, 8)))
    op = r.randrange(8)
    if op == 0:  # single bit flip
        p = r.randrange(len(b))
        b[p] ^= 1 << r.randrange(8)
    elif op == 1:  # byte substitution
        b[r.randrange(len(b))] = r.getrandbits(8)
    elif op == 2:  # truncation
        del b[r.randrange(len(b)) :]
    elif op == 3:  # length-field corruption: extreme LE value at any spot
        p = r.randrange(len(b))
        w = r.choice((1, 2, 4))
        val = r.choice((0, 1, 0xFE, 0xFFFF, 0x00FFFFFF, 0x7FFFFFFF, 1 << 31, 0xFFFFFFFF))
        b[p : p + w] = val.to_bytes(4, "little")[:w]
    elif op == 4:  # insert junk
        p = r.randrange(len(b) + 1)
        b[p:p] = bytes(r.getrandbits(8) for _ in range(r.randrange(1, 6)))
    elif op == 5:  # duplicate an internal slice elsewhere
        p = r.randrange(len(b))
        ln = r.randrange(1, min(64, len(b) - p) + 1)
        q = r.randrange(len(b) + 1)
        b[q:q] = b[p : p + ln]
    elif op == 6:  # delete a slice
        p = r.randrange(len(b))
        del b[p : p + r.randrange(1, min(32, len(b) - p) + 1)]
    elif depth < 3:  # stacked mutations
        return mutate(r, mutate(r, bytes(b), depth + 1), depth + 1)
    return bytes(b)


def mixed_payload(r: random.Random, size: int) -> bytes:
    out = bytearray()
    motifs = [b"lz4 frames are end-delimited ", b"\x00" * 9, bytes(range(48)), b"ab"]
    while len(out) < size:
        c = r.random()
        if c < 0.4:
            out.extend(r.choice(motifs) * r.randint(1, 9))
        elif c < 0.6 and out:
            s = r.randrange(len(out))
            out.extend(out[s : s + r.randint(1, 120)])
        else:
            out.extend(bytes(r.getrandbits(8) for _ in range(r.randint(1, 50))))
    return bytes(out[:size])


# hand-made blocks that reach each outcome
ZERO_OFFSET = b"\x10A\x00\x00"
OFFSET_PAST_PREFIX = b"\x10A\x05\x00"
PAST_LIMIT = b"\x1fA\x01\x00" + b"\xff" * 40 + b"\x00"  # a 10,219-byte match
STRAY_CLEAN = b"\x30abc\x00"  # one stray byte after literals, nibble 0: clean end
STRAY_TRUNCATED = b"\x30abc\x20"  # stray token asks for 2 literals: unexpected end


def spec_outcome(block, prefix, limit):
    try:
        return bytes(decompress_block(block, prefix, output_limit=limit))
    except SpecDecodeError as e:
        return e.kind


def native_outcome(block, prefix, limit):
    try:
        return bytes(native_decompress_block(block, prefix, output_limit=limit))
    except SpecDecodeError as e:
        return e.kind


def port_outcomes(decoder, blocks, prefixes, limit):
    comp, comp_len = pack_rows(blocks, "cpu")
    prefix, prefix_len = pack_rows(prefixes, "cpu", align_right=True)
    out, out_len, status = decoder(comp, comp_len, prefix, prefix_len, limit)
    res = []
    for i in range(len(blocks)):
        s = int(status[i])
        res.append(out[i, : out_len[i]].numpy().tobytes() if s == OK else STATUS_TO_KIND[s])
    return res


@pytest.fixture(scope="module")
def generative_batch():
    r = random.Random(0x70C4)
    seeds = [bytes(compress_block(mixed_payload(r, 2048 + 512 * k), 0, U16Table()))
             for k in range(6)]
    blocks = [mutate(r, r.choice(seeds)) for _ in range(900)]
    blocks += [bytes(r.getrandbits(8) for _ in range(r.randrange(0, 300))) for _ in range(200)]
    blocks += seeds + [ZERO_OFFSET, OFFSET_PAST_PREFIX, PAST_LIMIT, STRAY_CLEAN, STRAY_TRUNCATED]
    blocks += [s + b"\x00" for s in seeds] + [s + b"\x50" for s in seeds]
    window = mixed_payload(r, 3000)
    prefixes = [r.choice([b"", b"", window, window[-7:]]) for _ in blocks]
    return blocks, prefixes


@pytest.mark.parametrize("decoder",
                         [d128.decode128, dv4.decode_v4, dbig.decode_big, dv3.decode_v3],
                         ids=["decode128", "decode_v4", "decode_big", "decode_v3"])
def test_generative_batch_matches_spec(decoder, generative_batch):
    blocks, prefixes = generative_batch
    limit = 8192
    got = port_outcomes(decoder, blocks, prefixes, limit)
    want = [spec_outcome(b, p, limit) for b, p in zip(blocks, prefixes)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"case {i}: {blocks[i].hex()}"
    kinds = {w for w in want if isinstance(w, str)}
    assert kinds == set(STATUS_TO_KIND.values())  # every error kind reached
    assert sum(isinstance(w, bytes) for w in want) > 50


def test_generative_batch_matches_native(generative_batch):
    blocks, prefixes = generative_batch
    limit = 8192
    got = port_outcomes(d128.decode128, blocks, prefixes, limit)
    want = [native_outcome(b, p, limit) for b, p in zip(blocks, prefixes)]
    assert got == want


def test_plain_matches_jax_decode128_interpret():
    r = random.Random(0xD128)
    window = mixed_payload(r, 1500)
    raws = [mixed_payload(r, 1200 + 200 * k) for k in range(4)]
    blocks = [bytes(compress_block(window + raw, len(window), U32Table())) for raw in raws]
    prefixes = [window] * len(blocks)
    want = jax_decode128(blocks, block_maxsize=1 << 11, prefixes=prefixes)
    got = lt.decompress_blocks_128(blocks, 1 << 11, prefixes, device="cpu")
    assert got == want == raws


def test_plain_matches_jax_decode_v4_interpret():
    r = random.Random(0xD4)
    raws = [mixed_payload(r, 1500 + 100 * k) for k in range(3)]
    blocks = [bytes(compress_block(raw, 0, U16Table())) for raw in raws]
    want = jax_decode_v4(blocks, block_maxsize=1 << 11)
    assert lt.decompress_blocks_v4(blocks, None, 1 << 11, device="cpu") == want == raws
    for bad in (ZERO_OFFSET, OFFSET_PAST_PREFIX, b"\x40ab"):
        with pytest.raises(SpecDecodeError) as jax_err:
            jax_decode_v4([bad], block_maxsize=1 << 11)
        with pytest.raises(lt.DecodeError) as port_err:
            lt.decompress_blocks_v4([bad], None, 1 << 11, device="cpu")
        assert port_err.value.kind == jax_err.value.kind


def test_first_failing_block_wins():
    blocks = [STRAY_CLEAN, b"\x40ab", ZERO_OFFSET]
    with pytest.raises(lt.DecodeError) as e:
        lt.decompress_blocks_v4(blocks, None, 1 << 11, device="cpu")
    assert e.value.kind == SpecDecodeError.KIND_UNEXPECTED_END


def test_big_blocks_on_v4(corpus_sample):
    """No V4_MAX_COMP/V4_MAX_OUT: a 1 MiB block decodes in the v4 path."""
    raw = corpus_sample(2100, 1 << 20)
    block = bytes(compress_block(raw, 0, U32Table()))
    assert lt.decompress_blocks_v4([block], None, 1 << 20, device="cpu") == [raw]
    assert lt.decompress_blocks([block], None, 1 << 20, device="cpu") == [raw]


@pytest.mark.parametrize("n_blocks,maxsize,route", [
    (24, 1 << 16, "decode128"),
    (23, 1 << 16, "decode_v4"),
    (30, 1 << 18, "decode_big"),
    (1, 1 << 22, "decode_big"),
])
def test_decompress_blocks_routing(n_blocks, maxsize, route, monkeypatch):
    calls = []
    for mod, name in ((d128, "decode128"), (dv4, "decode_v4"), (dbig, "decode_big")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    raw = b"routing test " * 20
    block = bytes(compress_block(raw, 0, U16Table()))
    assert kdec.decompress_blocks([block] * n_blocks, None, maxsize, device="cpu") == (
        [raw] * n_blocks)
    assert calls == [route]


def test_single_block_adapter_retries_past_4_mib():
    block = b"\x1fA\x01\x00" + b"\xff" * 20000 + b"\x00"  # decodes to ~5.1 MB
    want = bytes(decompress_block(block))
    assert len(want) > 1 << 22
    assert kdec.decompress_block_cuda(block, device="cpu") == want
    with pytest.raises(lt.DecodeError) as e:
        kdec.decompress_block_cuda(block, output_limit=1 << 16, device="cpu")
    assert e.value.kind == SpecDecodeError.KIND_MEMORY_LIMIT


def test_prefix_only_trailing_64k_addressable(corpus_sample):
    window = corpus_sample(2200, 100_000)
    raw = corpus_sample(2201, 5000)
    block = bytes(compress_block(window[-65536:] + raw, 65536, U32Table()))
    got = lt.decompress_blocks_128([block], 1 << 16, [window], device="cpu")
    assert got == [raw] == [bytes(decompress_block(block, window[-65536:]))]
    assert np.frombuffer(got[0], np.uint8).size == len(raw)
