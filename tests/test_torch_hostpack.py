"""The port's transport (``lz4tpu_torch/hostpack.py``) and the pipelined
units of ``parallel/pipeline.py``, on the CPU at small sizes.

* Upload and fetch give what the row-by-row packing gave before them
  (``pack_rows`` / ``pack_prefixes`` / ``fetch_rows``, kept here as the
  reference): empty batches, zero-length items, keep masks, left and right
  alignment, one shared prefix.
* Decodes with ``DECODE_BUDGET`` shrunk to many groups, at depth 1 and at
  ``PIPELINE_DEPTH``, on meshes of 1, 2 and 3 CPU entries, give the JAX
  package's serial reader's bytes, or its first error with a failing block
  in the first, a middle or the last group.
* Compression at both depths and on those meshes stays byte-equal to the
  JAX package's writer where it promises byte identity, and to the port's
  one-launch frame elsewhere.
* A staging buffer is not taken again while a result points into it.
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import lz4tpu  # noqa: E402
import lz4tpu_torch as lt  # noqa: E402
import torch  # noqa: E402
from lz4tpu.frame.decompress import LZ4FrameReader as JaxFrameReader  # noqa: E402
from lz4tpu_torch import hostpack  # noqa: E402
from lz4tpu_torch.frame import compress as port_compress  # noqa: E402
from lz4tpu_torch.kernels import pack  # noqa: E402
from lz4tpu_torch.parallel import pipeline  # noqa: E402
from lz4tpu_torch.runtime import round_up  # noqa: E402
from lz4tpu_torch.spec.block import WINDOW_SIZE, DecodeError  # noqa: E402

from conftest import make_corpus_sample  # noqa: E402


# ---------------------------------------------------------------------------
# the row-by-row packing the transport replaced: the reference
# ---------------------------------------------------------------------------


def ref_pack_rows(items, align_right=False):
    lens = np.array([len(b) for b in items], dtype=np.int32)
    width = round_up(int(lens.max(initial=0)), 16)
    arr = np.zeros((len(items), width), np.uint8)
    for i, b in enumerate(items):
        if len(b):
            if align_right:
                arr[i, width - len(b):] = np.frombuffer(b, np.uint8)
            else:
                arr[i, : len(b)] = np.frombuffer(b, np.uint8)
    return torch.from_numpy(arr), torch.from_numpy(lens)


def ref_pack_prefixes(prefixes, n_blocks):
    if prefixes is None:
        return torch.zeros((1, 0), dtype=torch.uint8), torch.zeros(n_blocks, dtype=torch.int32)
    prefixes = [bytes(p)[-WINDOW_SIZE:] for p in prefixes]
    first = prefixes[0]
    if all(p == first for p in prefixes):
        rows, _ = ref_pack_rows([first], align_right=True)
        return rows, torch.full((n_blocks,), len(first), dtype=torch.int32)
    return ref_pack_rows(prefixes, align_right=True)


def ref_fetch_rows(out, out_len, keep):
    return [out[i, : out_len[i]].numpy().tobytes() if keep[i] else None
            for i in range(len(out_len))]


def items_of(seed, n, longest):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, longest + 1, n)
    lens[rng.random(n) < 0.2] = 0  # zero-length items among them
    return [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes() for k in lens]


ITEMS = {"empty batch": (0, 0), "one item": (1, 40), "all empty": (5, 0),
         "small": (37, 300), "rows of 64 KiB": (6, 1 << 16)}


@pytest.mark.parametrize("split", [hostpack.COPY_SPLIT, 64])
@pytest.mark.parametrize("align_right", [False, True])
@pytest.mark.parametrize("case", sorted(ITEMS))
def test_upload_rows_equal_the_row_by_row_packing(case, align_right, split, monkeypatch):
    monkeypatch.setattr(hostpack, "COPY_SPLIT", split)  # one thread writes staging, or four
    monkeypatch.setattr(hostpack, "GATHER_ROWS", 4 if split == 64 else hostpack.GATHER_ROWS)
    items = items_of(sum(map(ord, case)), *ITEMS[case])
    rows, lens = pack.pack_rows(items, "cpu", align_right=align_right)
    want_rows, want_lens = ref_pack_rows(items, align_right)
    assert torch.equal(rows, want_rows) and torch.equal(lens, want_lens)
    # several parts in one upload: rows of both alignments and arrays
    arr = np.arange(11, dtype=np.int64) * 7
    (left, _), (right, right_lens), got_arr, raw = hostpack.upload(
        "cpu", hostpack.Rows(items), hostpack.Rows(items, align_right=True), arr, b"abc")
    assert torch.equal(left, ref_pack_rows(items)[0])
    assert torch.equal(right, ref_pack_rows(items, True)[0])
    assert torch.equal(right_lens, want_lens)
    assert got_arr.dtype == torch.int64 and got_arr.tolist() == arr.tolist()
    assert bytes(raw.numpy()) == b"abc"


@pytest.mark.parametrize("split", [hostpack.COPY_SPLIT, 64])
@pytest.mark.parametrize("case", sorted(ITEMS))
def test_whole_rows_upload_equals_the_row_by_row_packing_up_to_each_length(case, split,
                                                                         monkeypatch):
    """``Rows(..., whole=True)``: the same rows as the scatter, up to each
    item's length, beside other parts of the same upload."""
    monkeypatch.setattr(hostpack, "COPY_SPLIT", split)  # one thread writes staging, or four
    items = items_of(sum(map(ord, case)) + 1, *ITEMS[case])
    want_rows, want_lens = ref_pack_rows(items)
    arr = np.arange(5, dtype=np.int32)
    (rows, lens), got_arr = hostpack.upload("cpu", hostpack.Rows(items, whole=True), arr)
    assert rows.shape == want_rows.shape and torch.equal(lens, want_lens)
    assert [bytes(rows[i, :n].numpy()) for i, n in enumerate(lens.tolist())] == items
    assert got_arr.tolist() == arr.tolist()
    with pytest.raises(ValueError):
        hostpack.Rows(items, align_right=True, whole=True)


@pytest.mark.parametrize("prefixes", ["none", "shared", "shared long", "per block"])
def test_upload_batch_prefixes_equal_the_row_by_row_packing(prefixes):
    blocks = items_of(3, 9, 500)
    dictionary = make_corpus_sample(4, 70_000 if prefixes == "shared long" else 3_000)
    given = {"none": None, "shared": [dictionary[:3_000]] * 9,
             "shared long": [dictionary] * 9, "per block": items_of(5, 9, 2_000)}[prefixes]
    comp, comp_len, prefix, prefix_len = hostpack.upload_batch("cpu", blocks, given)
    want = ref_pack_rows(blocks) + ref_pack_prefixes(given, 9)
    for got, ref in zip((comp, comp_len, prefix, prefix_len), want):
        assert torch.equal(got, ref)
    assert [torch.equal(a, b) for a, b in zip(pack.pack_prefixes(given, 9, "cpu"), want[2:])] \
        == [True, True]
    if prefixes.startswith("shared"):
        assert prefix.shape[0] == 1  # one row, read with stride 0


@pytest.mark.parametrize("gather", [(64, 1 << 12), (1 << 26, 3), (1 << 26, 1 << 12)])
@pytest.mark.parametrize("keep", ["all", "mixed", "none"])
@pytest.mark.parametrize("case", ["small", "rows of 64 KiB", "all empty"])
def test_fetch_equals_the_row_by_row_fetch(case, keep, gather, monkeypatch):
    # rows in chunks of a few bytes, of three rows, or all in one
    monkeypatch.setattr(hostpack, "GATHER", gather[0])
    monkeypatch.setattr(hostpack, "GATHER_ROWS", gather[1])
    items = items_of(7, *ITEMS[case])
    rows, lens = ref_pack_rows(items)
    out = torch.cat([rows, torch.full((len(items), 16), 0xAB, dtype=torch.uint8)], 1)
    rng = np.random.default_rng(8)
    mask = {"all": np.ones(len(items), bool), "mixed": rng.random(len(items)) < 0.5,
            "none": np.zeros(len(items), bool)}[keep]
    fetched = hostpack.fetch(out, lens.numpy(), mask).wait()
    assert [None if r is None else bytes(r) for r in fetched] == \
        ref_fetch_rows(out, lens.numpy(), mask)
    assert b"".join(r for r in fetched if r is not None) == \
        b"".join(b for b, k in zip(items, mask) if k)
    handle = hostpack.Handle(out, lens, lens * 2)
    got_lens, twice = handle.meta()
    assert got_lens.tolist() == lens.tolist() and twice.tolist() == (lens * 2).tolist()
    assert list(map(bytes, handle.collect(got_lens))) == items


# ---------------------------------------------------------------------------
# staging reuse
# ---------------------------------------------------------------------------


def test_a_held_result_keeps_its_bytes_and_a_freed_buffer_is_reused():
    items_a, items_b = items_of(21, 40, 900), items_of(22, 40, 900)
    rows_a, lens_a = pack.pack_rows(items_a, "cpu")
    rows_b, lens_b = pack.pack_rows(items_b, "cpu")

    def address(fetched):
        return np.frombuffer(fetched.buffer, np.uint8).ctypes.data

    first = hostpack.fetch(rows_a, lens_a.numpy()).wait()
    row3 = first[3]
    used = {address(first)}
    for _ in range(3):
        second = hostpack.fetch(rows_b, lens_b.numpy()).wait()
        assert address(second) != address(first)  # held: not taken again
        assert list(map(bytes, second)) == items_b
        used.add(address(second))
    assert list(map(bytes, first)) == items_a
    del first, second
    assert bytes(row3) == items_a[3]  # a row alone still holds its buffer
    del row3
    again = hostpack.fetch(rows_b, lens_b.numpy()).wait()
    assert address(again) in used  # a buffer let go is taken again
    assert list(map(bytes, again)) == items_b


def test_two_decodes_in_a_row_leave_the_first_result_unchanged():
    data_a = make_corpus_sample(31, 300_000)
    data_b = make_corpus_sample(32, 300_000)
    devs = (torch.device("cpu"),)
    payloads = []
    for data in (data_a, data_b):
        frame = lt.compress_frame_parallel(data, 65536, device="cpu")
        reader = lt.LZ4FrameReader(frame, engine="cpu")
        payloads.append([p for c, p, _ in pipeline._scan_frame(reader)[0] if c])
    rows_a = pipeline._decode_payloads(payloads[0], 65536, b"", devs)
    rows_b = pipeline._decode_payloads(payloads[1], 65536, b"", devs)
    assert b"".join(rows_a) == data_a and b"".join(rows_b) == data_b


# ---------------------------------------------------------------------------
# decodes in many groups, at depth 1 and PIPELINE_DEPTH, on meshes
# ---------------------------------------------------------------------------


def seq(lit: bytes = b"", offset: int = 0, ml: int = 0) -> bytes:
    def lsic(v):
        return b"\xff" * ((v - 15) // 255) + bytes([(v - 15) % 255]) if v >= 15 else b""
    ml_code = ml - 4 if offset else 0
    out = bytes([(min(len(lit), 15) << 4) | min(ml_code, 15)]) + lsic(len(lit)) + lit
    if offset:
        out += offset.to_bytes(2, "little") + lsic(ml_code)
    return out


BAD_OFFSET = seq(b"abc", 9, 40)  # invalid_deduplication_offset
DEPTH = pipeline.PIPELINE_DEPTH


def outcome(fn):
    try:
        return fn()
    except (lt.LZ4Error, DecodeError) as e:
        return type(e).__name__, getattr(e, "kind", None)


def jax_serial(frame, dictionary=b""):
    """The JAX package's serial reader: a ``decode_block`` loop on its spec."""
    try:
        reader = JaxFrameReader(frame, engine="spec")
        parts = []
        while (block := reader.decode_block(dictionary)) is not None:
            parts.append(block)
    except lz4tpu.LZ4Error as e:
        return type(e).__name__, getattr(e, "kind", None)
    return b"".join(parts)


def unwrapped(want):
    """The serial reader's outcome as the parallel entry points raise it."""
    if isinstance(want, tuple) and want[0] == "CodecError":
        return "DecodeError", want[1]
    return want


def good_blocks(n_blocks: int, seed: int):
    """(payloads, content): ``n_blocks`` raw blocks of 3,000 bytes each,
    compressed by the JAX package's spec."""
    from lz4tpu.spec.block import compress_block
    from lz4tpu.spec.table import U32Table

    data = make_corpus_sample(seed, n_blocks * 3000)
    cuts = [data[i : i + 3000] for i in range(0, len(data), 3000)]
    return [bytes(compress_block(c, table=U32Table())) for c in cuts], data


def raw_frame(payloads, content):
    """An independent frame of 64 KiB maxsize over the given block payloads,
    with ``content``'s checksum."""
    from lz4tpu_torch.spec.xxhash32 import xxh32

    flg = 0x64
    out = bytearray(b"\x04\x22\x4d\x18" + bytes([flg, 0x40]))
    out.append((xxh32(bytes([flg, 0x40])) >> 8) & 0xFF)
    for p in payloads:
        out += len(p).to_bytes(4, "little") + p
    out += b"\0\0\0\0" + xxh32(content).to_bytes(4, "little")
    return bytes(out)


N_BLOCKS = 40
GROUP_BLOCKS = 4  # the shrunk budget: 10 groups of 4 blocks on one device


def shrink(monkeypatch, depth):
    width = 3072  # the payloads' row, rounded: every payload is under it
    monkeypatch.setattr(pack, "DECODE_BUDGET", GROUP_BLOCKS * (65536 + 2 * width + 32))
    monkeypatch.setattr(pipeline, "PIPELINE_DEPTH", depth)


@pytest.fixture(scope="module")
def blocks_and_content():
    return good_blocks(N_BLOCKS, 41)


@pytest.mark.parametrize("depth", [1, DEPTH])
@pytest.mark.parametrize("mesh", [1, 2, 3])
@pytest.mark.parametrize("where", ["none", "first", "middle", "last"])
def test_grouped_decodes_give_the_serial_readers_bytes_and_first_error(
        where, mesh, depth, blocks_and_content, monkeypatch):
    blocks, content = blocks_and_content
    blocks = list(blocks)
    at = {"none": None, "first": 1, "middle": 21, "last": N_BLOCKS - 2}[where]
    if at is not None:
        blocks[at] = BAD_OFFSET
        blocks[at + 1] = BAD_OFFSET[:-1]  # a later failing block of another kind
    frame = raw_frame(blocks, content)
    want = jax_serial(frame)
    assert (want == content) == (at is None)
    shrink(monkeypatch, depth)
    on = dict(device="cpu") if mesh == 1 else dict(mesh=lt.make_mesh(devices=["cpu"] * mesh))
    assert outcome(lambda: lt.decompress_frame_parallel(frame, **on)) == unwrapped(want)
    assert outcome(lambda: lt.decompress_frames_parallel([frame, frame], **on)) == \
        (unwrapped(want) if at is not None else [content, content])
    if mesh == 1:
        assert outcome(lambda: lt.LZ4FrameReader(frame, engine="cpu").read_all()) == want


@pytest.mark.parametrize("depth", [1, DEPTH])
@pytest.mark.parametrize("where", ["none", "first", "middle", "last"])
def test_linked_waves_in_flight_give_the_serial_readers_bytes(where, depth, monkeypatch):
    settings = lz4tpu.CompressionSettings().engine("native").block_size(64 << 10) \
        .independent_blocks(False)
    datas = [make_corpus_sample(50 + i, 70_000 + 9_000 * i) for i in range(12)]
    frames = [settings.compress_bytes(d) for d in datas]
    bad = {"none": None, "first": 0, "middle": 6, "last": 11}[where]
    if bad is not None:
        f = bytearray(frames[bad])
        f[-40] ^= 0x55  # in its last block
        frames[bad] = bytes(f)
    want = [jax_serial(f) for f in frames]
    monkeypatch.setattr(pipeline, "PIPELINE_DEPTH", depth)
    got = outcome(lambda: lt.decompress_frames_parallel(frames, device="cpu"))
    errors = [w for w in want if isinstance(w, tuple)]
    assert got == (unwrapped(errors[0]) if errors else datas)


# ---------------------------------------------------------------------------
# compression at both depths and on meshes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def compress_data():
    return make_corpus_sample(61, 150_000) + bytes(np.random.default_rng(62).integers(
        0, 256, 20_000, dtype=np.uint8)) + make_corpus_sample(63, 90_000)


@pytest.mark.parametrize("depth", [1, DEPTH])
@pytest.mark.parametrize("mesh", [1, 3])
def test_scalar_independent_frames_equal_the_jax_writer(depth, mesh, compress_data,
                                                        monkeypatch):
    dic = make_corpus_sample(64, 20_000)
    want = lz4tpu.CompressionSettings().engine("native").block_size(64 << 10) \
        .block_checksums(True).dictionary(5, dic).compress_bytes(compress_data)
    monkeypatch.setattr(pipeline, "PIPELINE_DEPTH", depth)
    on = dict(device="cpu") if mesh == 1 else dict(mesh=lt.make_mesh(devices=["cpu"] * mesh))
    got = lt.compress_frame_parallel(compress_data, 65536, block_checksums=True,
                                     dictionary=dic, dictionary_id=5, **on)
    assert got == want


@pytest.mark.parametrize("depth", [1, DEPTH])
def test_batched_writer_in_many_batches_equals_the_jax_writer(depth, compress_data,
                                                              monkeypatch):
    want = lz4tpu.CompressionSettings().engine("native").block_size(64 << 10) \
        .compress_bytes(compress_data)
    monkeypatch.setattr(pipeline, "PIPELINE_DEPTH", depth)
    monkeypatch.setattr(port_compress, "BATCH_BYTES", 1 << 16)  # a batch a block: 5 batches
    got = lt.CompressionSettings().engine("cpu").block_size(64 << 10) \
        .compress_bytes(compress_data)
    assert got == want


@pytest.mark.parametrize("lane", [False, True])
@pytest.mark.parametrize("linked", [False, True])
def test_frames_equal_at_every_depth_and_mesh(lane, linked, compress_data, monkeypatch):
    data = compress_data[: 100_000 if lane else 200_000]
    kw = dict(block_size=65536, parallel_linked=linked, lane_kernel=lane)
    monkeypatch.setattr(pipeline, "PIPELINE_DEPTH", 1)
    base = lt.compress_frame_parallel(data, device="cpu", **kw)
    assert JaxFrameReader(base, engine="spec").read_all() == data
    for depth, mesh in ((DEPTH, 1), (DEPTH, 2), (DEPTH, 3), (1, 3)):
        monkeypatch.setattr(pipeline, "PIPELINE_DEPTH", depth)
        got = lt.compress_frame_parallel(data, mesh=lt.make_mesh(devices=["cpu"] * mesh),
                                         **kw)
        assert got == base, (depth, mesh)


def test_in_flight_units_stay_under_the_budget_of_their_entry(monkeypatch):
    """``_pipelined`` keeps ``PIPELINE_DEPTH`` units in flight, and on one
    mesh entry no more cost than ``DECODE_BUDGET`` (a unit over it alone
    runs alone); units are collected in order."""
    monkeypatch.setattr(pack, "DECODE_BUDGET", 100)
    monkeypatch.setattr(pipeline, "PIPELINE_DEPTH", 3)
    flight, seen, order = [], [], []

    def dispatch(work):
        flight.append(work)
        seen.append(list(flight))
        return work

    def collect(work, handle):
        assert flight[0] == work == handle
        flight.pop(0)
        order.append(work)

    units = [(0, 40, "a"), (1, 40, "b"), (0, 40, "c"), (0, 30, "d"), (1, 500, "e"),
             (1, 10, "f"), (0, 0, "g")]
    pipeline._pipelined(units, dispatch, collect)
    assert order == list("abcdefg")
    cost = {w: (e, c) for e, c, w in units}
    for now in seen:
        assert len(now) <= 3
        for entry in (0, 1):
            mine = [cost[w][1] for w in now if cost[w][0] == entry]
            assert sum(mine) <= 100 or len(mine) == 1, now
    assert ["a", "b", "c"] in seen  # three dispatched before the first was read
