"""Bounded-memory batched decode: every batched decode of the port is cut
into groups of whole blocks, in frame order, each under
``kernels.pack.DECODE_BUDGET``.  The budget is shrunk here so that each
case runs in at least three groups, and the results are held against the
JAX package's serial reader and ``lz4tpu.spec``: the same bytes, or the
serial reader's error type and kind (the parallel entry points raise the
decoder's ``DecodeError`` unwrapped, as ``lz4tpu``'s do).

The frames are those of a streaming writer that flushes often: thousands
of one-byte blocks under a 4 MiB (or 64 KiB) block maxsize, whose memory
would grow with blocks times ``block_maxsize`` if a call were one launch.
A spy on every decoder records each launch's output tensor and each
native slot buffer, and no launch may exceed the budget unless its group
is one block.

Run as a script it prints the peak RSS of decoding the 2,000-block frame
through each entry point, each in a fresh process, at the real budget:

    python tests/test_torch_budget.py [n_blocks]
"""

import functools
import os
import resource
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import lz4tpu_torch as lt  # noqa: E402
from lz4tpu_torch.frame import decompress as port_decompress  # noqa: E402
from lz4tpu_torch.kernels import decode128 as d128  # noqa: E402
from lz4tpu_torch.kernels import decodebig as dbig  # noqa: E402
from lz4tpu_torch.kernels import decompress_v3 as dv3  # noqa: E402
from lz4tpu_torch.kernels import decompress_v4 as dv4  # noqa: E402
from lz4tpu_torch.kernels import pack  # noqa: E402
from lz4tpu_torch.parallel import blocks, waves  # noqa: E402
from lz4tpu_torch.runtime import round_up  # noqa: E402
from lz4tpu_torch.spec.block import DecodeError  # noqa: E402
from lz4tpu_torch.spec.xxhash32 import xxh32  # noqa: E402

BD_4M, BD_64K = 0x70, 0x40
MAXSIZE = {BD_4M: 4 << 20, BD_64K: 64 << 10}
GROUP_ROWS = 24  # blocks a group at the shrunk budget: 200 blocks in 9 groups


def f1_frame(n_blocks: int, bd: int = BD_4M, payloads=None, linked: bool = False):
    """(frame, content): an independent (or linked) frame with a content
    checksum whose block i is the 2-byte stream ``10 b_i`` (one literal,
    ``b_i = (7 i) & 0xFF``), or ``payloads[i]`` where given."""
    flg = 0x44 if linked else 0x64
    content = bytes((7 * i) & 0xFF for i in range(n_blocks))
    payloads = dict(payloads or {})
    out = bytearray(b"\x04\x22\x4d\x18" + bytes([flg, bd]))
    out.append((xxh32(bytes([flg, bd])) >> 8) & 0xFF)
    for i in range(n_blocks):
        p = payloads.get(i, bytes([0x10, content[i]]))
        out += len(p).to_bytes(4, "little") + p
    out += b"\0\0\0\0" + xxh32(content).to_bytes(4, "little")
    return bytes(out), content


def seq(lit: bytes = b"", offset: int = 0, ml: int = 0) -> bytes:
    """One sequence: ``lit`` then a match of ``ml`` bytes at ``offset``
    (``offset`` 0: a last, literal-only sequence)."""
    def lsic(v):
        return b"\xff" * ((v - 15) // 255) + bytes([(v - 15) % 255]) if v >= 15 else b""
    ml_code = ml - 4 if offset else 0
    out = bytes([(min(len(lit), 15) << 4) | min(ml_code, 15)]) + lsic(len(lit)) + lit
    if offset:
        out += offset.to_bytes(2, "little") + lsic(ml_code)
    return out


def overflow_block(maxsize: int) -> bytes:
    """A block that decodes to ``maxsize + 100`` bytes without a decode
    error: matches up to the limit, then 100 literals past it."""
    return seq(b"0123456789", 1, maxsize - 10) + seq(b"L" * 100)


ZERO_OFFSET = seq(b"abc", 0xFFFF, 40)[:-3] + b"\0\0\0"  # zero_deduplication_offset
BAD_OFFSET = seq(b"abc", 9, 40)  # invalid_deduplication_offset


class Spy:
    """Wraps every decoder the grouped paths call and the native reader's
    slot buffer; records (rows, output bytes) of each launch and the bytes
    of each slot buffer."""

    def __init__(self, monkeypatch):
        self.launches = []
        self.slots = []
        for mod, name in ((blocks, "decode128"), (blocks, "decode_big"),
                          (blocks, "decode_v4"), (d128, "decode128"), (dbig, "decode_big"),
                          (dv4, "decode_v4"), (dv3, "decode_v3")):
            monkeypatch.setattr(mod, name, self._wrap(getattr(mod, name)))
        slots = port_decompress._output_slots

        def recorded_slots(n):
            self.slots.append(n)
            return slots(n)

        monkeypatch.setattr(port_decompress, "_output_slots", recorded_slots)

    def _wrap(self, fn):
        def decoder(*args, **kwargs):
            out, out_len, status = fn(*args, **kwargs)
            self.launches.append((out.shape[0], out.numel()))
            return out, out_len, status
        return decoder

    def check(self, min_launches=0, slot_row=None):
        """Every launch and slot buffer under the budget, unless one row
        (of ``slot_row`` bytes for a slot buffer) alone is over it; at
        least ``min_launches`` launches."""
        budget = pack.DECODE_BUDGET
        for rows, nbytes in self.launches:
            assert nbytes <= budget or rows == 1, (rows, nbytes, budget)
        for n in self.slots:
            assert n <= budget or n == slot_row, (n, budget)
        assert len(self.launches) >= min_launches, self.launches


@pytest.fixture
def spy(monkeypatch):
    return Spy(monkeypatch)


def set_budget(monkeypatch, row_bytes: int, rows: int = GROUP_ROWS):
    monkeypatch.setattr(pack, "DECODE_BUDGET", rows * row_bytes)


def outcome(fn):
    try:
        return fn()
    except (lt.LZ4Error, DecodeError) as e:
        return type(e).__name__, getattr(e, "kind", None)


def jax_serial(frame, dictionary=b""):
    """The JAX package's serial reader: a ``decode_block`` loop on its spec."""
    import lz4tpu
    from lz4tpu.frame.decompress import LZ4FrameReader as JaxFrameReader

    try:
        reader = JaxFrameReader(frame, engine="spec")
        parts = []
        while (block := reader.decode_block(dictionary)) is not None:
            parts.append(block)
    except lz4tpu.LZ4Error as e:
        return type(e).__name__, getattr(e, "kind", None)
    return b"".join(parts)


def read_all(frame, engine, threads, monkeypatch):
    monkeypatch.setenv("LZ4TPU_HOST_THREADS", str(threads))
    return outcome(lambda: lt.LZ4FrameReader(frame, engine=engine).read_all())


def unwrapped(want):
    """The serial reader's outcome as the parallel entry points raise it:
    the decoder's ``DecodeError`` unwrapped, with the same kind."""
    if isinstance(want, tuple) and want[0] == "CodecError":
        return "DecodeError", want[1]
    return want


READERS = [("cpu", 4), ("native", 1), ("native", 4)]


# ---------------------------------------------------------------------------
# the F1 frame through every grouped entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bd", [BD_4M, BD_64K])
@pytest.mark.parametrize("engine,threads", READERS)
def test_f1_frame_read_all(bd, engine, threads, monkeypatch, spy):
    frame, content = f1_frame(200, bd)
    assert jax_serial(frame) == content
    set_budget(monkeypatch, MAXSIZE[bd] + 32)
    assert read_all(frame, engine, threads, monkeypatch) == content
    spy.check()
    if engine == "cpu":
        assert len(spy.launches) == 9  # 23 blocks a group
    elif threads > 1:
        assert spy.slots == [GROUP_ROWS * MAXSIZE[bd]]  # 24 blocks a group: 9 groups


@pytest.mark.parametrize("bd", [BD_4M, BD_64K])
@pytest.mark.parametrize("mesh", [1, 3])
@pytest.mark.parametrize("lane_kernel", [None, False, True])
def test_f1_frame_parallel(bd, mesh, lane_kernel, monkeypatch, spy):
    frame, content = f1_frame(200, bd)
    set_budget(monkeypatch, MAXSIZE[bd] + 32)
    where = dict(device="cpu") if mesh == 1 else dict(mesh=lt.make_mesh(devices=["cpu"] * 3))
    assert lt.decompress_frame_parallel(frame, lane_kernel=lane_kernel, **where) == content
    spy.check(min_launches=9)


@pytest.mark.parametrize("mesh", [1, 3])
def test_f1_frames_parallel(mesh, monkeypatch, spy):
    frames = [f1_frame(n, bd) for n, bd in ((200, BD_4M), (150, BD_64K), (90, BD_4M))]
    set_budget(monkeypatch, MAXSIZE[BD_4M] + 32)
    where = dict(device="cpu") if mesh == 1 else dict(mesh=lt.make_mesh(devices=["cpu"] * 3))
    got = lt.decompress_frames_parallel([f for f, _ in frames], **where)
    assert got == [c for _, c in frames]
    spy.check(min_launches=9)


# ---------------------------------------------------------------------------
# linked frames: one wave's rows in several groups
# ---------------------------------------------------------------------------


def wave_row(maxsize: int, width: int) -> int:
    return (round_up(maxsize + width, 16) + width + waves.WINDOW_SIZE
            + waves.PUSH_BYTES)


def test_linked_frames_in_one_wave_span_groups(monkeypatch, spy):
    import lz4tpu
    from conftest import make_corpus_sample

    rng = np.random.default_rng(11)
    settings = lz4tpu.CompressionSettings().engine("native").independent_blocks(False) \
        .block_size(64 << 10)
    datas = []
    for i in range(40):
        data = make_corpus_sample(900 + i, int(rng.integers(66_000, 200_000)))
        if i % 7 == 3:  # a stored block among the rows
            data = data[:70_000] + rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes()
        datas.append(data)
    frames = [settings.compress_bytes(d) for d in datas]
    frames += [f1_frame(30, BD_64K, linked=True)[0] for _ in range(8)]
    want = [jax_serial(f) for f in frames]
    assert want[:40] == datas
    set_budget(monkeypatch, wave_row(64 << 10, 64 << 10), rows=12)
    assert lt.decompress_frames_parallel(frames, device="cpu") == want
    spy.check()
    # the first wave (48 frames, a compressed block each) took four groups
    assert [rows for rows, _ in spy.launches[:4]] == [12, 12, 12, 12]


def test_linked_wave_errors_keep_the_wave_order(monkeypatch):
    """In a wave a decode error anywhere wins over a size overflow, also
    when the overflow is in an earlier group."""
    maxsize = MAXSIZE[BD_64K]
    frames = [f1_frame(3, BD_64K, linked=True)[0] for _ in range(40)]
    frames[2] = f1_frame(3, BD_64K, {1: overflow_block(maxsize)}, linked=True)[0]
    frames[33] = f1_frame(3, BD_64K, {1: BAD_OFFSET}, linked=True)[0]
    whole = outcome(lambda: lt.decompress_frames_parallel(frames, device="cpu"))
    set_budget(monkeypatch, wave_row(maxsize, 512), rows=10)
    assert outcome(lambda: lt.decompress_frames_parallel(frames, device="cpu")) == whole \
        == ("DecodeError", "invalid_deduplication_offset")
    frames[33] = f1_frame(3, BD_64K, linked=True)[0]
    assert outcome(lambda: lt.decompress_frames_parallel(frames, device="cpu")) \
        == ("BlockSizeOverflow", None)


# ---------------------------------------------------------------------------
# the raw-block entry points
# ---------------------------------------------------------------------------


def raw_blocks(n: int = 300, with_prefixes: bool = True):
    """(blocks, prefixes, decoded): ``n`` blocks of 300 B to 2 KB of
    corpus, each compressed behind the 1 KB before it, which is its
    prefix (without prefixes: alone, and ``prefixes`` is None)."""
    blocks, prefixes, decoded = map(list, _raw_blocks(n, with_prefixes))
    return blocks, prefixes if with_prefixes else None, decoded


@functools.lru_cache(maxsize=None)
def _raw_blocks(n: int, with_prefixes: bool):
    from lz4tpu.spec.block import compress_block

    from conftest import make_corpus_sample

    data = make_corpus_sample(77, n * 2100)
    rng = np.random.default_rng(5)
    blocks, prefixes, decoded = [], [], []
    pos = 1024
    for _ in range(n):
        size = int(rng.integers(300, 2048))
        prefix = data[pos - 1024 : pos] if with_prefixes else b""
        blocks.append(bytes(compress_block(prefix + data[pos : pos + size], cursor=len(prefix))))
        prefixes.append(prefix)
        decoded.append(data[pos : pos + size])
        pos += size
    return tuple(blocks), tuple(prefixes), tuple(decoded)


RAW_ROW = (64 + 4) << 10  # a 64 KiB row and 4 KiB of compressed width: 60 rows a group
ENTRIES = {
    "128": lambda b, p, m: lt.decompress_blocks_128(b, m, p, device="cpu"),
    "big": lambda b, p, m: lt.decompress_blocks_big(b, 4 * m, p, device="cpu"),
    "v4": lambda b, p, m: lt.decompress_blocks_v4(b, p, m, device="cpu"),
    "v3": lambda b, p, m: lt.decompress_blocks_v3(b, p, m, device="cpu"),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("with_prefixes", [False, True])
def test_raw_block_entry_points(entry, with_prefixes, monkeypatch, spy):
    from lz4tpu.spec.block import decompress_block as jax_decompress_block

    blocks, prefixes, decoded = raw_blocks(with_prefixes=with_prefixes)
    assert decoded == [bytes(jax_decompress_block(b, p, output_limit=1 << 16))
                       for b, p in zip(blocks, prefixes or [b""] * len(blocks))]
    set_budget(monkeypatch, RAW_ROW)
    assert ENTRIES[entry](blocks, prefixes, 1 << 16) == decoded
    spy.check(min_launches=5)


def test_decompress_blocks_routes_on_the_whole_call(monkeypatch, spy):
    """24 or more blocks of at most 64 KiB go to decode128, also when the
    call is cut into groups of fewer than 24."""
    from lz4tpu_torch.kernels.decompress import MIN_LANE_BATCH, decompress_blocks

    blocks, prefixes, decoded = raw_blocks(30)
    set_budget(monkeypatch, RAW_ROW, rows=8)
    assert len(blocks) >= MIN_LANE_BATCH
    used = []
    monkeypatch.setattr(d128, "decode128", lambda *a, _f=d128.decode128: used.append(1) or _f(*a))
    assert decompress_blocks(blocks, prefixes, 1 << 16, device="cpu") == decoded
    assert len(used) == len(spy.launches) >= 4


def test_raw_block_errors_in_groups_two_and_three(monkeypatch):
    from lz4tpu.spec.block import DecodeError as JaxDecodeError
    from lz4tpu.spec.block import decompress_block as jax_decompress_block

    blocks, _, _ = raw_blocks(with_prefixes=False)
    # groups 2 and 3 at 64 KiB blocks (60 blocks a group; 15 at 256 KiB)
    blocks[70], blocks[130] = ZERO_OFFSET, BAD_OFFSET
    with pytest.raises(JaxDecodeError) as want:
        [jax_decompress_block(b, output_limit=1 << 16) for b in blocks]
    set_budget(monkeypatch, RAW_ROW)
    for entry in sorted(ENTRIES):
        got = outcome(lambda: ENTRIES[entry](blocks, None, 1 << 16))
        assert got == ("DecodeError", want.value.kind) == ("DecodeError",
                                                            "zero_deduplication_offset")


# ---------------------------------------------------------------------------
# errors across groups and mesh ranges: the serial reader's
# ---------------------------------------------------------------------------


def error_frame(bd, bad):
    maxsize = MAXSIZE[bd]
    kinds = {"zero": ZERO_OFFSET, "offset": BAD_OFFSET, "overflow": overflow_block(maxsize)}
    return f1_frame(200, bd, {i: kinds[k] for i, k in bad.items()})[0]


ERROR_CASES = {
    # a decode error in group 2 (blocks 24-47) and another in group 3
    "decode_2_decode_3": ({30: "zero", 60: "offset"}, ("CodecError", "zero_deduplication_offset")),
    # an over-long block before a decode error, and after one
    "overflow_2_decode_3": ({30: "overflow", 60: "offset"}, ("BlockSizeOverflow", None)),
    "decode_2_overflow_3": ({30: "offset", 60: "overflow"},
                            ("CodecError", "invalid_deduplication_offset")),
    # on a mesh of 3 (ranges 0-66, 67-133, 134-199): the first range's last
    # group against the second's first
    "mesh_late_first_range": ({64: "offset", 70: "zero"},
                              ("CodecError", "invalid_deduplication_offset")),
    "mesh_overflow_late_first_range": ({65: "overflow", 68: "zero"}, ("BlockSizeOverflow", None)),
    "mesh_third_range_only": ({150: "zero", 199: "offset"},
                              ("CodecError", "zero_deduplication_offset")),
}


@pytest.mark.parametrize("bd", [BD_4M, BD_64K])
@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_errors_across_groups_and_ranges(case, bd, monkeypatch, spy):
    frame = error_frame(bd, ERROR_CASES[case][0])
    want = jax_serial(frame)
    assert want == ERROR_CASES[case][1]
    set_budget(monkeypatch, MAXSIZE[bd] + 32)
    for engine, threads in READERS:
        assert read_all(frame, engine, threads, monkeypatch) == want, (engine, threads)
    for where in (dict(device="cpu"), dict(mesh=lt.make_mesh(devices=["cpu"] * 3))):
        for lane_kernel in (None, False, True):  # every route: the same outcome
            got = outcome(lambda: lt.decompress_frame_parallel(frame, lane_kernel=lane_kernel,
                                                               **where))
            assert got == unwrapped(want), (where, lane_kernel)
    assert outcome(lambda: lt.decompress_frames_parallel(
        [f1_frame(5, bd)[0], frame], mesh=lt.make_mesh(devices=["cpu"] * 3))) == unwrapped(want)
    spy.check(slot_row=MAXSIZE[bd])


def test_groups_after_the_first_failure_do_not_run(monkeypatch, spy):
    frame = error_frame(BD_64K, {30: "zero"})
    set_budget(monkeypatch, MAXSIZE[BD_64K] + 32)
    assert outcome(lambda: lt.decompress_frame_parallel(frame, device="cpu")) \
        == ("DecodeError", "zero_deduplication_offset")
    assert len(spy.launches) == 2  # groups 1 and 2 of 9


# ---------------------------------------------------------------------------
# the bound itself
# ---------------------------------------------------------------------------


def test_a_row_over_the_budget_is_a_group_alone(monkeypatch, spy):
    """A budget below one row: every group is one block, none is empty."""
    frame, content = f1_frame(40, BD_64K)
    monkeypatch.setattr(pack, "DECODE_BUDGET", 1000)
    assert pack.budget_groups(3, 4000) == [(0, 1), (1, 2), (2, 3)]
    assert pack.budget_groups(0, 4000) == []
    assert lt.decompress_frame_parallel(frame, device="cpu") == content
    assert read_all(frame, "native", 4, monkeypatch) == content
    assert [rows for rows, _ in spy.launches] == [1] * 40
    assert spy.slots == [MAXSIZE[BD_64K]]
    spy.check(slot_row=MAXSIZE[BD_64K])


def test_budget_groups_cover_in_order():
    for n, row in ((0, 5), (1, 1 << 40), (7, 1), (1000, 3 << 20), (5, pack.DECODE_BUDGET)):
        groups = pack.budget_groups(n, row)
        assert [i for lo, hi in groups for i in range(lo, hi)] == list(range(n))
        assert all(hi > lo and ((hi - lo) * row <= pack.DECODE_BUDGET or hi - lo == 1)
                   for lo, hi in groups)


ENTRY_POINTS = ("cpu", "native", "parallel")


def _probe(n_blocks: int, entries) -> None:
    """Decode the ``n_blocks`` F1 frame through each of ``entries`` in this
    process, in turn; print the process's peak RSS in bytes before the
    first and after each."""
    frame, content = f1_frame(n_blocks)
    os.environ["LZ4TPU_HOST_THREADS"] = "4"
    peaks = [resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024]
    for entry in entries:
        if entry == "parallel":
            got = lt.decompress_frame_parallel(frame, device="cpu")
        else:
            got = lt.decompress_frame(frame, engine=entry)
        assert got == content, entry
        peaks.append(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    print(*peaks)


def probe_rss(n_blocks: int, entries, budget=None):
    """Peak RSS before and after each of ``entries`` (``_probe``) in a
    fresh process, at ``budget`` (None: the module's)."""
    patch = f"pack.DECODE_BUDGET = {budget}; " if budget else ""
    code = (f"import sys; sys.path.insert(0, {HERE!r}); import test_torch_budget as t; "
            f"from lz4tpu_torch.kernels import pack; {patch}"
            f"t._probe({n_blocks}, {tuple(entries)!r})")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    return list(map(int, r.stdout.split()[-len(entries) - 1 :]))


def test_f1_frame_of_2000_blocks_in_a_fresh_process():
    """8 GiB of slots or output rows a call unbounded; at a 32 MiB budget
    the three calls add under 200 MB to the process's peak RSS."""
    peaks = probe_rss(2000, ENTRY_POINTS, budget=32 << 20)
    assert peaks[-1] - peaks[0] < 200 << 20, peaks


if __name__ == "__main__":
    blocks = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    print(f"F1 frame of {blocks} blocks, 4 MiB maxsize; DECODE_BUDGET {pack.DECODE_BUDGET:,d} B")
    for name in ENTRY_POINTS:
        before, after = probe_rss(blocks, [name])
        print(f"  {name:9s} peak RSS {after / 1e6:,.0f} MB (before the decode {before / 1e6:,.0f})")
