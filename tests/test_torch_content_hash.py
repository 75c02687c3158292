"""The content hash beside the call (``lz4tpu_torch.utils.hashing``), on
the CPU.

* ``native.XXHash32.update_table`` feeds many pieces (their
  ``native.buffer_table``) in one native call: its digest equals the one-shot native hash, the pure-Python one and the
  JAX package's over the pieces joined, at lengths and cuts across the
  16-byte stripes, for bytes, ``memoryview`` and numpy pieces.
* ``content_hash`` on the native backend (``cuda`` and ``"native"``;
  here the CPU's plain versions with the backend's test patched to say
  native) hashes content of ``BESIDE_MIN`` bytes or more on a helper
  thread: frames stay byte-identical to the JAX package's streaming
  writer's below, at and above the constant, a bad content checksum is
  still refused as the JAX package refuses it, an error inside the hash
  reaches the caller, the pieces outlive a caller that raises until the
  hash has ended, and the counters ``content_hashes_beside`` and ``content_hash_waits`` count
  what happened.
"""

import gc
import sys
import threading
import time
import weakref

import numpy as np
import pytest

import lz4tpu_torch as lt
from lz4tpu import CompressionSettings as JaxSettings
from lz4tpu import decompress_frame as jax_decompress_frame
from lz4tpu.spec.xxhash32 import xxh32 as jax_xxh32
from lz4tpu_torch import native
from lz4tpu_torch.spec.xxhash32 import xxh32 as spec_xxh32
from lz4tpu_torch.parallel import pipeline
from lz4tpu_torch.utils import hashing

from conftest import make_corpus_sample

BLOCK = 1 << 16
LENGTHS = (0, 1, 15, 16, 17, 31, 33, (64 << 10) + 3)
KINDS = ("bytes", "memoryview", "numpy")
SEEDS = (0, 1, 0x9E3779B1, 0xFFFFFFFF)


def cut(data: bytes, kind: str):
    """``data`` in pieces of ``kind`` cut at points that fall inside and
    across 16-byte stripes (empty pieces included), read-only and writable
    buffers in turn."""
    points = sorted({0, len(data)} | {p for p in (1, 1, 7, 15, 16, 23, 40, 4099, 65_000)
                                       if p < len(data)})
    points = [0, 0] + points  # an empty piece first
    pieces = [data[a:b] for a, b in zip(points, points[1:])]
    if kind == "memoryview":
        return [memoryview(bytearray(p) if i % 2 else p) for i, p in enumerate(pieces)]
    if kind == "numpy":
        return [np.frombuffer(bytearray(p) if i % 2 else p, np.uint8) for i, p in enumerate(pieces)]
    return pieces


@pytest.mark.parametrize("n, kind, seed", [(n, kind, SEEDS[i % len(SEEDS)])
                                           for i, (n, kind) in enumerate(
                                               (n, k) for n in LENGTHS for k in KINDS)])
def test_update_many_equals_the_hash_of_the_joined_pieces(n, kind, seed):
    data = make_corpus_sample(n + seed % 97, n)
    pieces = cut(data, kind)
    assert b"".join(bytes(p) for p in pieces) == data
    got = native.XXHash32(seed).update_table(*native.buffer_table(pieces)).digest()
    assert got == native.xxh32(data, seed) == spec_xxh32(data, seed) == jax_xxh32(data, seed)
    # the same stream state as ``update``: half the pieces in one call, the
    # rest one by one
    k = len(pieces) // 2
    mixed = native.XXHash32(seed).update_table(*native.buffer_table(pieces[:k]))
    for p in pieces[k:]:
        mixed.update(p)
    assert mixed.digest() == got


@pytest.fixture
def beside(monkeypatch):
    """The CPU's plain versions with the native hasher, as on a card."""
    monkeypatch.setattr(hashing, "native_backend", lambda device: True)
    lt.reset_stats()
    yield
    lt.reset_stats()


def counts():
    s = lt.stats()
    return s["content_hashes_beside"], s["content_hash_waits"]


SIZES = {"below": hashing.BESIDE_MIN - 1, "at": hashing.BESIDE_MIN,
         "above": hashing.BESIDE_MIN + 3 * BLOCK + 12_345}


@pytest.mark.parametrize("where", sorted(SIZES))
def test_frames_equal_the_streaming_writer_below_at_and_above_the_constant(beside, where):
    data = make_corpus_sample(31, SIZES[where])
    frame = lt.compress_frame_parallel(data, BLOCK, device="cpu")
    assert frame == JaxSettings().engine("native").block_size(BLOCK).compress_bytes(data)
    assert frame == lt.CompressionSettings().engine("native").block_size(BLOCK).compress_bytes(data)
    assert counts()[0] == (where != "below")
    assert jax_decompress_frame(frame) == data
    assert lt.decompress_frame_parallel(frame, device="cpu") == data
    assert lt.decompress_frames_parallel([frame, frame], device="cpu") == [data, data]
    beside_n, waits = counts()
    assert beside_n == (4 if where != "below" else 0)
    assert waits <= beside_n


def flipped(frame: bytes) -> bytes:
    """``frame`` with one bit of its content checksum flipped."""
    frame = bytearray(frame)
    frame[-2] ^= 0x10
    return bytes(frame)


@pytest.mark.parametrize("path", ["frame", "frames", "frames_linked"])
def test_a_bad_content_checksum_is_refused_as_the_jax_package_does(beside, path):
    data = make_corpus_sample(47, hashing.BESIDE_MIN + BLOCK + 999)
    good = JaxSettings().engine("native").block_size(BLOCK).compress_bytes(data)
    if path == "frames_linked":
        bad = flipped(JaxSettings().engine("native").block_size(BLOCK)
                      .independent_blocks(False).compress_bytes(data))
    else:
        bad = flipped(good)
    assert jax_decompress_frame(good) == data
    with pytest.raises(Exception) as want:
        jax_decompress_frame(bad)
    with pytest.raises(Exception) as got:
        if path == "frame":
            lt.decompress_frame_parallel(bad, device="cpu")
        else:
            lt.decompress_frames_parallel([good, bad], device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__ == "FrameChecksumFail"
    assert counts()[0] == (1 if path == "frame" else 2)


@pytest.mark.parametrize("side", ["write", "read"])
def test_an_error_inside_the_hash_reaches_the_caller(beside, monkeypatch, side):
    data = make_corpus_sample(53, hashing.BESIDE_MIN + 1)
    frame = lt.compress_frame_parallel(data, BLOCK, device="cpu")

    def broken(hasher, table):
        raise RuntimeError("the hash failed")

    monkeypatch.setattr(hashing, "_hash_table", broken)
    with pytest.raises(RuntimeError, match="the hash failed"):
        if side == "write":
            lt.compress_frame_parallel(data, BLOCK, device="cpu")
        else:
            lt.decompress_frame_parallel(frame, device="cpu")


@pytest.mark.parametrize("side", ["write", "frames_linked"])
def test_the_pieces_outlive_a_caller_that_raises_until_the_hash_ends(beside, monkeypatch, side):
    """A caller that raises after handing a hash over drops its handle;
    the memory the helper reads (the caller's input, a decoded row) stays
    alive until the hash has ended, and is let go then."""
    data = make_corpus_sample(59, hashing.BESIDE_MIN + BLOCK + 7)
    tables, refs = [], []
    buffer_table, hash_table = native.buffer_table, hashing._hash_table
    release, ended = threading.Event(), threading.Event()
    hold = 0 if side == "write" else 1  # the hash held back: the last one handed over

    def recorded(pieces):
        tables.append(buffer_table(pieces))
        refs.append([weakref.ref(p) for p in pieces if type(p) is not bytes])
        return tables[-1]

    def held(hasher, table):
        if len(tables) > hold and table is tables[hold]:
            release.wait(10)
            ended.set()
        return hash_table(hasher, table)

    monkeypatch.setattr(native, "buffer_table", recorded)
    monkeypatch.setattr(hashing, "_hash_table", held)
    if side == "write":
        arr = np.frombuffer(bytearray(data), np.uint8)
        watched = [weakref.ref(arr)]

        def broken(*args):
            raise RuntimeError("the card failed")

        monkeypatch.setattr(pipeline, "_scalar_blocks", broken)
        try:
            lt.compress_frame_parallel(arr, BLOCK, device="cpu")
        except RuntimeError as e:
            assert str(e) == "the card failed"
        del arr
    else:
        # the first frame's checksum is bad, the second's hash still runs
        linked = JaxSettings().engine("native").block_size(BLOCK).independent_blocks(False)
        frames = [flipped(linked.compress_bytes(data)),
                  linked.compress_bytes(make_corpus_sample(60, len(data)))]
        try:
            lt.decompress_frames_parallel(frames, device="cpu")
        except Exception as e:
            assert type(e).__name__ == "FrameChecksumFail"
        watched = refs[-1]
    assert watched and not ended.is_set()
    gc.collect()
    assert all(r() is not None for r in watched)
    release.set()
    assert ended.wait(10)
    deadline = time.monotonic() + 10
    while any(r() is not None for r in watched) and time.monotonic() < deadline:
        time.sleep(0.01)
        gc.collect()
    assert all(r() is None for r in watched)


def test_counters_count_hashes_beside_and_waits(beside, monkeypatch):
    small = make_corpus_sample(61, hashing.BESIDE_MIN // 2)
    large = make_corpus_sample(62, hashing.BESIDE_MIN + 5)
    for data in (small, large, small):
        lt.compress_frame_parallel(data, BLOCK, device="cpu")
    beside_n, waits = counts()
    assert beside_n == 1 and waits <= 1

    # a hash held back until the caller asks for its digest is one wait
    asked = threading.Event()
    hash_table = hashing._hash_table

    def slow(hasher, table):
        asked.wait(5)
        return hash_table(hasher, table)

    monkeypatch.setattr(hashing, "_hash_table", slow)
    waits = counts()[1]
    handle = hashing.content_hash([large], "cuda")
    time.sleep(0.01)
    assert not handle._future.done()
    threading.Timer(0.05, asked.set).start()
    assert handle.digest() == native.xxh32(large)
    assert counts() == (2, waits + 1)

    # a digest that is ready when asked for is no wait
    monkeypatch.setattr(hashing, "_hash_table", hash_table)
    handle = hashing.content_hash([large], "cuda")
    handle._future.result()
    assert handle.digest() == native.xxh32(large)
    assert counts() == (3, waits + 1)

    lt.reset_stats()
    assert counts() == (0, 0)


def test_the_pure_python_hasher_and_short_content_stay_inline(monkeypatch):
    def no_pool():
        raise AssertionError("handed to the helper")

    monkeypatch.setattr(hashing, "_pool", no_pool)
    lt.reset_stats()
    large = make_corpus_sample(71, hashing.BESIDE_MIN + 1)
    # the CPU backend is the pure-Python hasher, which holds the interpreter lock
    assert hashing.content_hash([large], "cpu").digest() == native.xxh32(large)
    short = large[: hashing.BESIDE_MIN - 1]
    assert hashing.content_hash([short], "native").digest() == native.xxh32(short)
    assert counts() == (0, 0)


def test_many_callers_at_once_get_their_own_digests_and_every_count(beside):
    """More callers than cores, the interpreter switching threads as often
    as it can: each digest is its own content's, and no count is lost."""
    datas = [make_corpus_sample(80 + k, hashing.BESIDE_MIN + 977 * k) for k in range(16)]
    want = [native.xxh32(d) for d in datas]
    rounds = 5
    bad = []

    def caller(k):
        for _ in range(rounds):
            if hashing.content_hash([memoryview(datas[k])], "native").digest() != want[k]:
                bad.append(k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller, args=(k,)) for k in range(len(datas))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
    beside_n, waits = counts()
    assert beside_n == rounds * len(datas) and waits <= beside_n
