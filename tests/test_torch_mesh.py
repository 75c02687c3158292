"""The port's device mesh on CPU meshes (``["cpu"] * k``, the plain
versions) against its one-device path and against the JAX package on its
virtual CPU mesh of k devices: frames byte-equal at every mesh size, round
trips, and the first failing block's error in frame order.  A byte codec
has no tolerance: equal means byte-equal."""

import io
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lz4tpu_torch as lt
from conftest import make_corpus_sample
from lz4tpu import decompress_frame as jax_decompress_frame
from lz4tpu.frame.decompress import LZ4FrameReader as JaxFrameReader
from lz4tpu.parallel.mesh import make_mesh as jax_make_mesh
from lz4tpu.parallel.pipeline import _compress_sharded, _pad_blocks
from lz4tpu.parallel.pipeline import compress_frame_parallel as jax_compress_frame_parallel
from lz4tpu.parallel.pipeline import decompress_frame_parallel as jax_decompress_frame_parallel
from lz4tpu_torch.parallel import blocks
from lz4tpu_torch.parallel.mesh import BLOCK_AXIS, Mesh, shard_bounds

KS = (1, 2, 3, 4, 8)
BS = 1 << 16


def cpu_mesh(k):
    return lt.make_mesh(devices=["cpu"] * k)


def noise(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def data():
    """Four 64 KiB blocks, the third stored raw, the last short: k = 3 does
    not divide them and k = 8 has more entries than blocks."""
    return (make_corpus_sample(8100, 2 * BS) + noise(8101, BS)
            + make_corpus_sample(8102, 20_000))


@pytest.fixture(scope="module")
def dictionary():
    return make_corpus_sample(8103, 70_000)


def blocks_of(frame):
    """[(compressed, payload)] of a frame, through the JAX package's reader."""
    from lz4tpu.parallel.pipeline import _scan_frame

    _, blocks, _ = _scan_frame(frame, False)
    return blocks


def jax_linked_payloads(data, k):
    """Per-block output of the JAX package's sharded linked compressor on
    its mesh of ``k`` devices at 64 KiB blocks and a 64 KiB ring halo, the
    block count padded to a multiple of ``k`` (``None`` where the block is
    stored).  Its ``compress_frame_parallel`` shrinks linked blocks to fit
    the v5e's scalar memory, so the frames are compared by payload, as in
    ``tests/test_torch_linked.py``."""
    arr, lens, n_blocks = _pad_blocks(data, BS)
    pad = -n_blocks % k
    arr = np.concatenate([arr, np.zeros((pad, BS), np.uint8)])
    lens = np.concatenate([lens, np.zeros(pad, np.int32)])
    out, out_len, status = _compress_sharded(
        jnp.asarray(arr), jnp.asarray(lens),
        jnp.asarray(np.zeros((n_blocks + pad, 4096), np.int32)),
        jnp.asarray(np.zeros(1, np.uint8)), jnp.asarray(np.zeros(1, np.int32)),
        mesh=jax_make_mesh(k), block_size=BS, window=BS, acceleration=1, u16_table=False,
    )
    out, out_len, status = np.asarray(out), np.asarray(out_len), np.asarray(status)
    return [None if status[i] else out[i, : out_len[i]].tobytes() for i in range(n_blocks)]


MODES = {
    "independent": dict(),
    "dictionary": dict(dictionary=True, dictionary_id=7),
    "parallel_linked": dict(parallel_linked=True),
}


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mode", list(MODES))
def test_compress_equals_one_device_and_jax_mesh(mode, k, data, dictionary):
    kw = dict(MODES[mode])
    if kw.pop("dictionary", False):
        kw["dictionary"] = dictionary
    got = lt.compress_frame_parallel(data, BS, mesh=cpu_mesh(k), **kw)
    assert got == lt.compress_frame_parallel(data, BS, device="cpu", **kw)
    blocks = blocks_of(got)
    if mode == "parallel_linked":
        assert [p if c else None for c, p in blocks] == jax_linked_payloads(data, k)
    else:
        assert got == jax_compress_frame_parallel(data, BS, mesh=jax_make_mesh(k), **kw)
    assert len(blocks) == -(-len(data) // BS)
    assert [c for c, _ in blocks] == [True, True, False, True]


@pytest.mark.parametrize("k", KS)
def test_empty_and_one_byte_inputs(k):
    for payload in (b"", b"x"):
        got = lt.compress_frame_parallel(payload, BS, mesh=cpu_mesh(k))
        assert got == lt.compress_frame_parallel(payload, BS, device="cpu")
        assert got == jax_compress_frame_parallel(payload, BS, mesh=jax_make_mesh(k))
        assert len(blocks_of(got)) == len(payload)
        assert lt.decompress_frame_parallel(got, mesh=cpu_mesh(k)) == payload


FRAME_MODES = {
    "checksums": dict(block_checksums=True),
    "short_dictionary": dict(dictionary="short"),
    "linked_dictionary": dict(parallel_linked=True, dictionary="long"),
    "linked_short_dictionary": dict(parallel_linked=True, dictionary="short"),
    "big_linked": dict(block_size=1 << 18, parallel_linked=True),
    "lane": dict(lane_kernel=True),
    "lane_no_windows": dict(lane_kernel=True, chunk_windows=False),
    "lane_linked": dict(lane_kernel=True, parallel_linked=True),
    "lane_dictionary": dict(lane_kernel=True, dictionary="long", dictionary_id=3),
    "lane_linked_dictionary": dict(lane_kernel=True, parallel_linked=True, dictionary="long"),
}


@pytest.mark.parametrize("mode", list(FRAME_MODES))
def test_frames_equal_at_every_mesh_size(mode, dictionary):
    """Every other frame mode, the lane compressor's included: the same
    frame as on one device on meshes that split its three blocks unevenly,
    evenly and with an entry to spare, one block per ``block_size`` of
    input, and the JAX package's reader gives the input back."""
    kw = dict(FRAME_MODES[mode])
    bs = kw.pop("block_size", BS)
    data = make_corpus_sample(8200, 2 * bs) + noise(8201, 5_000)
    dic = {"long": dictionary, "short": dictionary[:9000], None: None}[kw.pop("dictionary", None)]
    want = lt.compress_frame_parallel(data, bs, device="cpu", dictionary=dic, **kw)
    for k in (2, 3, 4):
        assert lt.compress_frame_parallel(data, bs, mesh=cpu_mesh(k), dictionary=dic,
                                          **kw) == want, k
    assert len(blocks_of(want)) == 3
    assert jax_decompress_frame(want, dictionary=dic or b"", engine="spec") == data


def _spy(monkeypatch, name, calls):
    real = getattr(blocks, name)

    def spy(rows, *a, **k):
        calls.append((rows.device.type, int(a[0].shape[0]) if name == "compress128"
                      else int(rows.shape[0])))
        return real(rows, *a, **k)

    monkeypatch.setattr(blocks, name, spy)


@pytest.mark.parametrize("k", KS)
def test_one_launch_a_mesh_entry_with_blocks(k, monkeypatch, data):
    """A launch on each entry that has blocks and none on the others, in
    ranges of whole blocks that differ by at most one."""
    calls = []
    _spy(monkeypatch, "compress_batch", calls)
    lt.compress_frame_parallel(data, BS, mesh=cpu_mesh(k))
    sizes = [hi - lo for lo, hi in shard_bounds(4, k) if hi > lo]
    assert calls == [("cpu", n) for n in sizes]


@pytest.mark.parametrize("k", (2, 3))
def test_lane_ranges_never_split_a_block(k, monkeypatch):
    """The lane compressor's 256 KiB blocks are 8 chunks of 32 KiB each:
    an entry takes whole blocks, so its launch takes a multiple of 8 chunks
    (the last, short block's chunks excepted)."""
    data = make_corpus_sample(8300, 4 * (1 << 18) + 40_000)  # 5 blocks, the last 2 chunks
    want = lt.compress_frame_parallel(data, 1 << 18, device="cpu", lane_kernel=True)
    calls = []
    _spy(monkeypatch, "compress128", calls)
    assert lt.compress_frame_parallel(data, 1 << 18, mesh=cpu_mesh(k), lane_kernel=True) == want
    blocks = [hi - lo for lo, hi in shard_bounds(5, k)]
    assert calls == [("cpu", 8 * n - (6 if i == k - 1 else 0)) for i, n in enumerate(blocks)]


@pytest.mark.parametrize("k", KS)
def test_decompress_round_trips_at_every_mesh_size(k, data, dictionary):
    mesh = cpu_mesh(k)
    frames = {
        "independent": (lt.compress_frame_parallel(data, BS, device="cpu"), None),
        "dictionary": (lt.compress_frame_parallel(data, BS, device="cpu", dictionary=dictionary,
                                                  dictionary_id=7), dictionary),
        "checksummed": (lt.compress_frame_parallel(data, BS, device="cpu", block_checksums=True,
                                                   content_checksum=True), None),
        "big_blocks": (lt.compress_frame_parallel(data, 1 << 18, device="cpu"), None),
    }
    for name, (frame, dic) in frames.items():
        assert lt.decompress_frame_parallel(frame, mesh=mesh, dictionary=dic) == data, name
        assert lt.decompress_frame_parallel(frame, mesh=mesh, dictionary=dic,
                                            lane_kernel=False) == data, name
    # a mixed list: linked and independent frames, with and without dictionaries
    segments = [data[:100_000], data[50_000:], data[:1000], data]
    made = [
        lt.compress_frame_parallel(segments[0], BS, device="cpu", parallel_linked=True),
        lt.compress_frame_parallel(segments[1], BS, device="cpu", dictionary=dictionary),
        lt.compress_frame_parallel(segments[2], BS, device="cpu", parallel_linked=True,
                                   dictionary=dictionary),
        lt.compress_frame_parallel(segments[3], BS, device="cpu", block_checksums=True),
    ]
    dics = [None, dictionary, dictionary, None]
    assert lt.decompress_frames_parallel(made, mesh=mesh, dictionaries=dics) == segments
    # a linked frame alone goes to the serial reader on the mesh's first device
    assert lt.decompress_frame_parallel(made[0], mesh=mesh) == segments[0]


def _outcome(fn):
    """("ok", output) or (error type name, kind) of ``fn()``."""
    try:
        return "ok", fn()
    except Exception as e:  # the type and kind are what is compared
        return type(e).__name__, getattr(e, "kind", None)


def _assemble(frame, payloads):
    """``frame``'s header with ``payloads`` as its compressed blocks, an
    EndMark and no content checksum."""
    flg = frame[4] & ~0x04  # no content checksum
    header = bytearray(frame[4:6])
    header[0] = flg
    if frame[4] & 0x08:
        header += frame[6:14]
    from lz4tpu.spec.xxhash32 import xxh32

    out = bytearray(frame[:4]) + header + bytes([(xxh32(bytes(header)) >> 8) & 0xFF])
    for p in payloads:
        out += len(p).to_bytes(4, "little") + p
    return bytes(out + b"\0\0\0\0")


def hostile_frames():
    """Seeded mutations and truncations of a frame of four blocks, and
    frames with two bad blocks in different shards (the earlier must win)."""
    frame = lt.compress_frame_parallel(make_corpus_sample(8400, 3 * BS + 30_000), BS,
                                       device="cpu")
    p = [p for _, p in blocks_of(frame)]

    # bad blocks as long as the blocks they replace, so that every frame
    # has the same shape (the JAX package compiles once a shape and mesh):
    # a sequence with offset 0 or one before the output, or a literal
    # length that runs past the end
    def zero_offset(i):
        return (b"\x10a\x00\x00" + bytes(len(p[i])))[: len(p[i])]

    def bad_offset(i):
        return (b"\x10a\x05\x00" + bytes(len(p[i])))[: len(p[i])]

    def cut(i):
        return b"\xf0" + b"\xff" * (len(p[i]) - 1)

    frames = {
        "bad_1_and_3": _assemble(frame, [p[0], zero_offset(1), p[2], cut(3)]),
        "bad_1_and_2": _assemble(frame, [p[0], bad_offset(1), zero_offset(2), p[3]]),
        "bad_0_and_3": _assemble(frame, [cut(0), p[1], p[2], bad_offset(3)]),
        "bad_3_only": _assemble(frame, p[:3] + [zero_offset(3)]),
    }
    r = random.Random(8400)
    for i in range(5):
        b = bytearray(frame)
        for _ in range(r.randint(1, 4)):
            b[r.randrange(20, len(b) - 8)] = r.getrandbits(8)
        frames[f"mutation_{i}"] = bytes(b)
    for i in range(2):
        frames[f"truncation_{i}"] = frame[: r.randrange(10, len(frame))]
    return frames


def test_hostile_frames_raise_alike_at_every_mesh_size():
    """The same outcome (bytes, or error type and kind) at every mesh size
    as on one device and as in the JAX package on its mesh of that size."""
    frames = hostile_frames()
    outcomes = {}
    for name, frame in frames.items():
        want = _outcome(lambda: lt.decompress_frame_parallel(frame, device="cpu"))
        outcomes[name] = want
        for k in KS:
            assert _outcome(lambda: lt.decompress_frame_parallel(frame, mesh=cpu_mesh(k))) == want
            # lane_kernel=None takes the JAX lane decoder on one device,
            # minutes in interpret mode; the error kinds are the same
            lane = None if k > 1 else False
            assert _outcome(lambda: jax_decompress_frame_parallel(
                frame, mesh=jax_make_mesh(k), lane_kernel=lane)) == want, (name, k)
    assert outcomes["bad_1_and_3"] == ("DecodeError", "zero_deduplication_offset")
    assert outcomes["bad_1_and_2"] == ("DecodeError", "invalid_deduplication_offset")
    assert outcomes["bad_0_and_3"] == ("DecodeError", "unexpected_end")
    assert outcomes["bad_3_only"] == ("DecodeError", "zero_deduplication_offset")
    assert {o[0] for o in outcomes.values()} >= {"DecodeError", "InputTruncated"}


def test_lane_frames_round_trip_through_the_jax_reader(dictionary):
    data = make_corpus_sample(8500, 2 * (1 << 18) + 1000)
    for kw in (dict(), dict(parallel_linked=True), dict(dictionary=dictionary)):
        frame = lt.compress_frame_parallel(data, 1 << 18, mesh=cpu_mesh(3), lane_kernel=True,
                                           **kw)
        reader = JaxFrameReader(io.BytesIO(frame), engine="spec")
        assert reader.read_all(kw.get("dictionary", b"")) == data


# ---------------------------------------------------------------------------
# the mesh helpers
# ---------------------------------------------------------------------------


def test_make_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lt.make_mesh, lt.local_mesh, lambda: lt.make_mesh(2),
               lambda: lt.make_mesh(devices=["cuda:0"] * 2)):
        with pytest.raises(RuntimeError, match="device=None means 'cuda'"):
            fn()


def test_mesh_shape_and_repeated_devices():
    mesh = cpu_mesh(4)
    assert isinstance(mesh, Mesh)
    assert mesh.size == 4 and BLOCK_AXIS == "blocks"
    assert mesh.devices == (torch.device("cpu"),) * 4
    with pytest.raises(AttributeError):
        mesh.devices = ()
    with pytest.raises(ValueError):
        lt.make_mesh(devices=[])


def test_mesh_is_all_cards_or_all_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="not both"):
        lt.make_mesh(devices=["cuda:0", "cpu"])


def test_device_and_mesh_together_raise(data):
    mesh = cpu_mesh(2)
    frame = lt.compress_frame_parallel(b"abc" * 100, device="cpu")
    for fn in (lambda: lt.compress_frame_parallel(data, device="cpu", mesh=mesh),
               lambda: lt.decompress_frame_parallel(frame, device="cpu", mesh=mesh),
               lambda: lt.decompress_frames_parallel([frame], device="cpu", mesh=mesh)):
        with pytest.raises(ValueError, match="not both"):
            fn()


@pytest.mark.parametrize("n,k", [(0, 1), (0, 3), (4, 8), (4, 3), (13, 4), (100, 7)])
def test_shard_bounds_are_contiguous_and_even(n, k):
    bounds = shard_bounds(n, k)
    assert len(bounds) == k
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    sizes = [hi - lo for lo, hi in bounds]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)


def test_initialize_distributed_returns_rank_and_world():
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    try:
        assert lt.initialize_distributed(f"localhost:{port}", 1, 0) == (0, 1)
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
