"""Whole-frame codec: every block of a frame in one launch a device
(a decode: one launch a group of blocks under ``DECODE_BUDGET``).

Counterpart of ``lz4tpu/parallel/pipeline.py``.  Independent-block frames
are embarrassingly parallel: the frame's blocks go to the card in one
upload (``hostpack.upload``: pinned staging, one copy on the copy stream,
the padded rows gathered on the device), each kernel runs once over all of
them, the lengths and statuses come back right after it without blocking,
then only the bytes needed, compacted on the device into one staging
buffer (``hostpack.Handle``), and the host assembles the frame in order
from ``memoryview`` rows of it.  The units of a call (a mesh's ranges, a
decode's groups, the waves' groups) run through ``_pipelined``: unit
``k + 1`` is uploaded and launched before unit ``k`` is read, up to
``PIPELINE_DEPTH`` in flight and, on one mesh entry, at most
``DECODE_BUDGET`` of rows in flight together.

Every entry point takes ``device`` (one device) or ``mesh`` (a
``parallel.mesh.Mesh``, this process's cards; not both).  On a mesh the
frame's blocks are cut into one contiguous range per entry
(``mesh.shard_bounds``), whole output blocks for the lane compressor; each
range goes to its card in one upload that also carries what its first
block may look back at (in a linked frame the 64 KiB of input before the
range: the JAX package's ring halo), and its kernel is launched on that
card's stream.  Every range is launched before any range's results are
read (up to ``PIPELINE_DEPTH``), then the results are joined in frame
order, so a frame is byte-identical at every mesh size and a decode raises
the first failing block in frame order.  An entry that gets no block gets no launch.

* ``compress_frame_parallel`` — independent mode is byte-identical to the
  streaming writer (and to the JAX package's ``compress_frame_parallel``)
  with the same settings, preset dictionary included: host-primed template
  table plus a per-block ``[dictionary | block]`` buffer parsed from
  ``cursor = len(dictionary)`` (reference ``framed/compress.rs:202-218``).
  ``parallel_linked`` writes a linked-block frame whose blocks are still
  compressed in one launch: block *i*'s row is ``[the 64 KiB of input
  before it | block]``, parsed from ``cursor = 64 KiB`` with the table
  primed in the kernel.  Its payloads equal the JAX package's scalar
  linked path, not the serial writer's (whose table carries over).
* ``decompress_frame_parallel`` — block scan with the streaming reader's
  hostile-input checks, block checksums, ``decode128`` for frames of 64
  KiB blocks, ``decode_v4`` for frames of larger blocks (``decode_big``
  with ``lane_kernel=True``; ``decode_v4`` for every frame with
  ``lane_kernel=False``), stored blocks passed through, and the content
  checksum.  A frame's compressed blocks are one
  launch unless their output rows and packed payloads pass
  ``kernels.pack.DECODE_BUDGET`` (1 GiB a device): then they are cut into
  groups of whole blocks in frame order, one launch each, so a frame of
  many small blocks under a large ``block_maxsize`` needs about the budget,
  its payloads and its content, not blocks times ``block_maxsize``.  One
  linked frame is a serial chain and goes to the port's serial reader, as
  in the JAX package.
* ``decompress_frames_parallel`` — many frames at once: linked frames are
  decoded in waves, wave ``w`` being block ``w`` of every linked frame in
  one launch (a group of them under the budget), each block with its own
  frame's 64 KiB carry-over window, which stays on the device from wave to
  wave.  The waves' blocks go up in one upload, and their decoded rows
  come back in one fetch, a chunk of waves under the budget (one chunk
  for a batch of Arrow record-batch buffers).

``compress_frame_parallel(lane_kernel=True)`` compresses with the lane
compressor (``kernels/compress128.py``) instead: the input is cut into
chunks of at most 32 KiB, all chunks of the frame are compressed in one
launch, each behind a window of the bytes before it, and the chunk streams
of one output block are spliced into ONE block of the declared size
(``kernels/splice.py``).  That is how a 4 MiB block becomes 128 parallel
parses.  Such a frame is valid LZ4 of about the same size, not the
streaming writer's bytes.

A frame's content checksum depends only on its content, so it is hashed
beside the rest of the call (``utils.hashing.content_hash``: on a helper
thread for content on the native backend from ``BESIDE_MIN`` bytes): a
write's from the input, before its blocks are uploaded; a read's from the
decoded rows and stored payloads, while they are joined.  The call waits
for the digest before it returns, and a read raises ``FrameChecksumFail``
before any content is returned.

Each entry point runs in a span of its own (``lz4t.compress_frame``,
``lz4t.decompress_frame``, ``lz4t.decompress_frames``) that holds one span
a phase: ``lz4t.scan``, ``lz4t.join``, ``lz4t.assemble`` and
``lz4t.checksum`` (block checksums, and the wait for a content hash that
is not ready) here, ``lz4t.launch`` around each launch's host side, and
``hostpack``'s transfers and waits (``runtime.span``).  The linked waves
add ``lz4t.plan`` (the waves' pieces and chunks), ``lz4t.wave`` (one wave
group's launch and the slide after it) and ``lz4t.push`` (a slide of the
carry-over windows), and count ``linked_frames``, ``waves``,
``wave_launches`` and ``window_pushes`` in ``stats()``.  The blocks of a
frame of blocks over 64 KiB that the default route decodes on
``decode_v4`` count in ``big_blocks_v4``.

The streaming API takes the same one-launch paths for independent frames:
``CompressionSettings`` writes its batches through ``_scalar_blocks``, and
``LZ4FrameReader.read_all`` decodes through ``_scan_frame`` and
``_decode_payloads``.
"""

from __future__ import annotations

from collections import Counter, deque
from dataclasses import dataclass

import numpy as np
import torch

from .. import hostpack

from ..frame.errors import (
    BlockChecksumFail,
    BlockSizeOverflow,
    DecodeError as FrameDecodeError,
    FrameChecksumFail,
    InputTruncated,
    InvalidBlockSize,
)
from ..frame.header import INCOMPRESSIBLE, MAGIC, BlockDescriptor, Flags
from ..kernels.compress import compress_batch
from ..kernels.compress128 import MAX_B, compress128
from ..kernels.decode128 import MAX_BLOCK, decode128
from ..kernels.decodebig import decode_big
from ..kernels.decompress_v4 import decode_v4
from ..kernels import pack
from ..kernels.pack import budget_groups, check_decoded
from ..kernels.splice import splice_streams
from ..kernels.window import push_windows
from ..kernels.status import OK, STATUS_INCOMPRESSIBLE, STATUS_TO_KIND
from ..runtime import count, entry, host_u8, resolve_device, round_up, span, traced
from ..spec.block import WINDOW_SIZE, DecodeError
from ..spec.table import U32_SLOTS, U32Table, prime_u32_table
from ..spec.xxhash32 import xxh32
from ..utils.hashing import content_hash
from ..utils.hashing import xxh32 as payload_xxh32
from .mesh import shard_bounds

#: units (decode groups, mesh ranges, waves' groups) dispatched ahead of
#: the oldest one read, as ``lz4tpu``'s ``PIPELINE_DEPTH``; the units of a
#: mesh entry in flight together also stay under ``DECODE_BUDGET``
PIPELINE_DEPTH = 8


def _frame_header(flags: Flags, bd: BlockDescriptor, content_size, dictionary_id) -> bytes:
    header = bytearray(MAGIC.to_bytes(4, "little"))
    header.append(flags.encode())
    header.append(bd.byte)
    if content_size is not None:
        header.extend(int(content_size).to_bytes(8, "little"))
    if dictionary_id is not None:
        header.extend(int(dictionary_id).to_bytes(4, "little"))
    header.append((xxh32(header[4:]) >> 8) & 0xFF)
    return bytes(header)


def _linked_rows(padded, n_blocks: int, block_size: int, full_first: bool):
    """Rows ``[the 64 KiB before block i | block i]`` of a linked range, cut
    on the device with one strided gather from ``padded`` = ``[the 64 KiB
    before the range | the range's blocks, padded whole]``.  A block whose
    window is not full (the frame's block 0 without a dictionary of at
    least 64 KiB) is laid out as an independent block, to be parsed at
    cursor 0 (``_linked_cursors``): an unprimed table's empty slots alias
    buffer position 0, which is only safe to parse from there."""
    w = WINDOW_SIZE
    rows = padded.as_strided((n_blocks, w + block_size), (block_size, 1)).contiguous()
    if not full_first:
        rows[0, :block_size] = padded[w : w + block_size].clone()  # rows may alias padded
        rows[0, block_size:] = 0
    return rows


def _linked_cursors(n_blocks: int, full_first: bool) -> np.ndarray:
    """Each linked row's cursor: 64 KiB, or 0 for a first block without a
    full window (``_linked_rows``)."""
    cursors = np.full(n_blocks, WINDOW_SIZE, np.int32)
    if not full_first:
        cursors[0] = 0
    return cursors


def _block_lens(n: int, block_size: int) -> np.ndarray:
    """Lengths of the frame's blocks; an empty input is one empty block."""
    n_blocks = max(-(-n // block_size), 1)
    lens = np.full(n_blocks, block_size, np.int32)
    lens[-1] = n - (n_blocks - 1) * block_size
    return lens


def _ranges(n_items: int, devs):
    """``(lo, hi, device)`` of each mesh entry that gets items: an entry
    with none gets no launch."""
    return [(lo, hi, dev) for (lo, hi), dev in zip(shard_bounds(n_items, len(devs)), devs)
            if hi > lo]


def _pipelined(units, dispatch, collect, depth=None) -> None:
    """Run ``units`` (``(entry, cost, work)``) in order with up to ``depth``
    (``PIPELINE_DEPTH``) dispatched before the oldest is collected, and at most
    ``DECODE_BUDGET`` of ``cost`` in flight on one mesh entry (a unit over
    it alone runs alone there).  ``dispatch(work)`` uploads and launches
    without waiting and returns a handle, or ``None`` when nothing stays in
    flight; ``collect(work, handle)`` waits for it.  Units are collected in
    the order given; when ``collect`` raises, the units still in flight
    are dropped unread."""
    depth = PIPELINE_DEPTH if depth is None else depth
    flight = deque()
    held = Counter()
    for entry, cost, work in units:
        while flight and (len(flight) >= depth
                          or (held[entry] and held[entry] + cost > pack.DECODE_BUDGET)):
            done_entry, done_cost, done, handle = flight.popleft()
            held[done_entry] -= done_cost
            collect(done, handle)
        handle = dispatch(work)
        if handle is not None:
            flight.append((entry, cost, work, handle))
            held[entry] += cost
    while flight:
        _, _, done, handle = flight.popleft()
        collect(done, handle)


def _scalar_launch(src, lo, hi, lens, block_size, dictionary, parallel_linked, acceleration,
                   dev):
    """Blocks ``lo:hi`` of the frame through the scalar greedy compressor:
    their bytes in one upload, one launch on ``dev``, not waited for: a
    ``hostpack.Handle`` of the output rows, lengths and statuses."""
    w = WINDOW_SIZE
    d = len(dictionary or b"")
    n_blocks = hi - lo
    lens = lens[lo:hi]
    a = lo * block_size
    b = a + int(lens.sum())
    template = U32Table()
    if parallel_linked:
        # the range behind the 64 KiB of input before it (every block is at
        # least 64 KiB, so a range past the first has a full window); the
        # frame's first block is behind the dictionary's tail
        halo = min(a, w)
        head = dictionary[-w:] if lo == 0 and d >= w else b""
        full_first = lo > 0 or d >= w
        cursors = _linked_cursors(n_blocks, full_first)
    else:
        halo = 0
        head = dictionary or b""
        cursors = np.full(n_blocks, d, np.int32)
        if d:
            # every template position sits behind the cursor (buffer
            # coordinates equal dictionary coordinates), so the primed table is
            # shared.  Linked rows hold only the dictionary's tail, in other
            # coordinates: their tables are primed in the kernel instead
            prime_u32_table(template, dictionary)
    prime = (cursors > 0) if parallel_linked else np.zeros(n_blocks, bool)
    params = np.stack([lens + cursors, cursors, lens,  # output capped at input size
                       np.full(n_blocks, max(int(acceleration), 1)), np.zeros(n_blocks),
                       prime]).astype(np.int32)
    parts = [src[a - halo : b], params] + ([head] if head else [])
    if d and not parallel_linked:
        parts.append(template.dict.view(np.int32))
    content, params, *rest = hostpack.upload(dev, *parts)
    with span("lz4t.launch"):
        if parallel_linked:
            padded = torch.zeros(w + n_blocks * block_size, dtype=torch.uint8, device=dev)
            padded[w - halo : w + b - a].copy_(content)
            if head:
                padded[:w].copy_(rest[0])
            rows = _linked_rows(padded, n_blocks, block_size, full_first)
        else:
            # the range padded to whole blocks on the device
            flat = torch.zeros(n_blocks * block_size, dtype=torch.uint8, device=dev)
            flat[: b - a].copy_(content)
            rows = flat.view(n_blocks, block_size)
            if d:
                buf = torch.empty((n_blocks, d + block_size), dtype=torch.uint8, device=dev)
                buf[:, :d] = rest[0]
                buf[:, d:] = rows
                rows = buf
        if d and not parallel_linked:
            tables = rest[1].expand(n_blocks, U32_SLOTS).contiguous()
        else:
            tables = torch.zeros((n_blocks, U32_SLOTS), dtype=torch.int32, device=dev)
        out, out_len, status, _ = compress_batch(
            rows, *params, tables, round_up(block_size + 16, 16))
        return hostpack.Handle(out, out_len, status)


def _scalar_collect(handle, lens):
    """The payloads of a ``_scalar_launch`` over blocks of ``lens``: a
    ``memoryview`` a block, ``None`` where it is stored raw."""
    out_len, status = handle.meta()
    return list(handle.collect(out_len, (status != STATUS_INCOMPRESSIBLE) & (lens > 0)))


def _scalar_dispatch(src, block_size, dictionary, acceleration, dev):
    """An independent batch of whole blocks in one launch, not waited for
    (the batched writer's unit): (lens, handle) for ``_scalar_collect``."""
    lens = _block_lens(src.numel(), block_size)
    return lens, _scalar_launch(src, 0, len(lens), lens, block_size, dictionary, False,
                                acceleration, dev)


def _scalar_blocks(src, block_size, dictionary, parallel_linked, acceleration, devs):
    """The frame's blocks through the scalar greedy compressor, one launch
    on each device of ``devs`` (a mesh's) that gets a range of them, each
    range dispatched before the ranges before it are read: (payloads,
    lens), a payload ``None`` where the block is stored raw."""
    lens = _block_lens(src.numel(), block_size)
    payloads = []
    _pipelined(
        ((r, 0, (lo, hi, dev)) for r, (lo, hi, dev) in enumerate(_ranges(len(lens), devs))),
        lambda work: _scalar_launch(src, *work[:2], lens, block_size, dictionary,
                                    parallel_linked, acceleration, work[2]),
        lambda work, handle: payloads.extend(_scalar_collect(handle, lens[work[0]:work[1]])))
    return payloads, lens


def _lane_launch(src, lo, hi, lens, block_size, dictionary, parallel_linked, chunk_windows,
                 dev):
    """Output blocks ``lo:hi`` of the frame through the lane compressor,
    their bytes in one upload and one launch over all their chunks on
    ``dev``, not waited for: a ``hostpack.Handle`` of the output rows,
    lengths and tails.

    A chunk's row is cut from one flat source on the device by its base
    offset: the 64 KiB before the chunk, stopped at ``floor``, the first
    byte its block may refer to.  Linked frames: the source is ``[dictionary
    tail | input]`` (for a range past the first, the 64 KiB of input before
    it in the same upload) and the floor its start.  Independent frames:
    a window stays inside the chunk's own output block, whose source
    segment is ``[dictionary tail | block]``, so what lies before the
    segment is neither primed nor matched."""
    chunk = min(block_size, MAX_B)
    cpb = block_size // chunk  # chunks per output block
    n_blocks = hi - lo
    a = lo * block_size
    n = int(lens[lo:hi].sum())
    n_chunks = -(-n // chunk)
    idx = np.arange(n_chunks, dtype=np.int64)
    chunk_len = np.minimum(chunk, n - idx * chunk)
    tail = (dictionary or b"")[-WINDOW_SIZE:]
    d = len(tail)
    linked_range = parallel_linked and lo
    if linked_range:
        d = WINDOW_SIZE  # a range past the first starts 64 KiB before it
    if parallel_linked:
        start = d + idx * chunk
        floor = np.zeros(n_chunks, np.int64)
    elif d:
        segment = d + block_size
        floor = (idx // cpb) * segment
        start = floor + d + (idx % cpb) * chunk
    else:
        start = idx * chunk
        floor = (idx // cpb) * block_size
    # a dictionary is only addressable through a gapless window, so with one
    # the in-block windows stay whatever ``chunk_windows`` says
    if parallel_linked or d or (cpb > 1 and chunk_windows):
        base = np.maximum(start - WINDOW_SIZE, floor)
    else:
        base = start
    cur0 = (start - base).astype(np.int32)
    parts = [src[a - d : a + n] if linked_range else src[a : a + n], base,
             cur0 + chunk_len.astype(np.int32), cur0]
    data, base, ends, cur0, *rest = hostpack.upload(
        dev, *parts, *([tail] if d and not linked_range else []))
    with span("lz4t.launch"):
        if linked_range:
            flat = data
        elif parallel_linked:
            flat = torch.cat([rest[0], data]) if d else data
        elif d:
            buf = torch.zeros((n_blocks, segment), dtype=torch.uint8, device=dev)
            buf[:, :d] = rest[0]
            padded = torch.zeros(n_blocks * block_size, dtype=torch.uint8, device=dev)
            padded[:n] = data
            buf[:, d:] = padded.view(n_blocks, block_size)
            flat = buf.view(-1)
        else:
            flat = data
        return hostpack.Handle(*compress128(flat, base, ends, cur0))


def _lane_blocks(src, block_size, dictionary, parallel_linked, chunk_windows, devs):
    """The frame's blocks through the lane compressor, one launch on each
    device of ``devs`` that gets a range of output blocks (never a range of
    chunks: the chunk streams of a block are spliced together), each range
    dispatched before the ranges before it are read: (payloads, lens), a
    payload ``None`` where the block is stored raw."""
    n = src.numel()
    cpb = block_size // min(block_size, MAX_B)
    lens = _block_lens(n, block_size)
    if n == 0:
        return [None], lens
    payloads = []

    def collect(work, handle):
        lo, hi, _ = work
        out_len, tail_pos, tail_lit = handle.meta()
        tails = list(zip(tail_pos.tolist(), tail_lit.tolist()))
        streams = handle.collect(out_len)
        for ob in range(hi - lo):
            c0, c1 = ob * cpb, min((ob + 1) * cpb, len(streams))
            payload = streams[c0] if c1 - c0 == 1 else splice_streams(
                [streams[c] for c in range(c0, c1)], tails[c0:c1])
            # the lane kernel has no output cap: a block that did not shrink
            # is stored raw, as the capped scalar parse would have it
            payloads.append(payload if len(payload) <= lens[lo + ob] else None)

    _pipelined(
        ((r, 0, work) for r, work in enumerate(_ranges(len(lens), devs))),
        lambda work: _lane_launch(src, *work[:2], lens, block_size, dictionary,
                                  parallel_linked, chunk_windows, work[2]),
        collect)
    return payloads, lens


def _devices(device, mesh) -> tuple:
    """The devices a call runs on: the mesh's entries, or ``device``."""
    if mesh is None:
        return (resolve_device(device),)
    if device is not None:
        raise ValueError("lz4tpu_torch: pass device= or mesh=, not both")
    return mesh.devices


@entry("compress_frame")
def compress_frame_parallel(
    data,
    block_size: int = 1 << 16,
    device=None,
    content_checksum: bool = True,
    block_checksums: bool = False,
    with_content_size: bool = True,
    acceleration: int = 1,
    parallel_linked: bool = False,
    dictionary=None,
    dictionary_id: int | None = None,
    lane_kernel: bool = False,
    chunk_windows: bool = True,
    mesh=None,
) -> bytes:
    """Compress one LZ4 frame with all blocks in one kernel launch (one a
    mesh entry with ``mesh``).

    Independent mode is byte-identical to the streaming writer
    (``frame.compress.CompressionSettings``) with the same settings,
    including a preset dictionary.

    ``parallel_linked`` emits a valid linked-block frame: every block past
    the first is parsed behind the 64 KiB of input before it, with the
    table primed from that window in the kernel.  Only full windows are
    primed, so with a dictionary only block 0's window is seeded, from the
    dictionary's last 64 KiB, and a shorter dictionary leaves block 0 an
    independent block.  The blocks stay ``block_size`` long (``lz4tpu``
    shrinks them to fit the v5e's scalar memory; this card has no such
    limit).

    ``lane_kernel=True`` takes the lane compressor in all four modes
    (independent, ``parallel_linked``, dictionary, dictionary and linked):
    chunks of ``min(block_size, 32 KiB)``, each behind a window of up to
    64 KiB (the input before it in a linked frame, from the dictionary's
    tail on; in an independent frame the dictionary's tail and the bytes of
    its own block before it), the chunk streams of a block spliced into one
    block of ``block_size``, stored raw when that is longer than the block.
    ``chunk_windows=False`` compresses each chunk of an independent frame
    without a dictionary standalone (no priming, about 1-2 % more bytes).
    The frame is valid LZ4 for any reader but not the streaming writer's
    bytes, and ``acceleration`` is ignored: leave ``lane_kernel`` off where
    byte parity with the reference encoder matters.

    ``mesh`` (``parallel.mesh.make_mesh``, in place of ``device``) cuts the
    frame's blocks into one contiguous range per entry, each compressed on
    its own card; the frame is byte-identical at every mesh size.
    """
    bd = BlockDescriptor.for_block_maxsize(block_size)
    if bd is None:
        raise InvalidBlockSize(str(block_size))
    devs = _devices(device, mesh)
    dev = devs[0]  # checksums are host work; its kind picks their backend
    src = host_u8(data)
    n = src.numel()
    mv = memoryview(src.numpy())
    # the content hash needs only the input: it runs beside the blocks' work
    content_sum = content_hash([mv], dev) if content_checksum else None
    dictionary = bytes(dictionary) if dictionary is not None else None
    if lane_kernel:
        payloads, lens = _lane_blocks(src, block_size, dictionary, parallel_linked,
                                      chunk_windows, devs)
    else:
        payloads, lens = _scalar_blocks(src, block_size, dictionary, parallel_linked,
                                        acceleration, devs)

    # host-side ordered assembly (frame order): (stored raw, payload) of
    # each block but the zero-length ones (0 is the EndMark)
    with span("lz4t.assemble"):
        blocks = [(p is None, mv[i * block_size : i * block_size + k] if p is None else p)
                  for i, (p, k) in enumerate(zip(payloads, lens.tolist())) if k]
    with span("lz4t.checksum"):
        sums = [payload_xxh32(p, device=dev) for _, p in blocks] if block_checksums else None
        content_sum = content_sum.digest() if content_sum is not None else None
    with span("lz4t.assemble"):
        flags = Flags(
            independent_blocks=not parallel_linked,
            block_checksums=block_checksums,
            content_checksum=content_checksum,
            content_size=with_content_size,
            dictionary_id=dictionary_id is not None,
        )
        parts = [_frame_header(flags, bd, n if with_content_size else None, dictionary_id)]
        for i, (raw, payload) in enumerate(blocks):
            parts.append((len(payload) | (INCOMPRESSIBLE if raw else 0)).to_bytes(4, "little"))
            parts.append(payload)
            if sums is not None:
                parts.append(sums[i].to_bytes(4, "little"))
        parts.append((0).to_bytes(4, "little"))
        if content_sum is not None:
            parts.append(content_sum.to_bytes(4, "little"))
        return b"".join(parts)


def _scan_frame(reader, blocks=None):
    """The frame's block chain without decoding: [(compressed, payload,
    checksum)] and the trailer checksum, with the streaming reader's
    hostile-input checks.  The blocks are appended to ``blocks`` when
    given, so that the caller keeps those read before an error."""
    from ..frame.decompress import _read_exact

    blocks = [] if blocks is None else blocks
    stream = reader.reader
    while True:
        block_length = int.from_bytes(_read_exact(stream, 4), "little")
        if block_length == 0:
            expected = (
                int.from_bytes(_read_exact(stream, 4), "little")
                if reader.flags.content_checksum
                else None
            )
            return blocks, expected
        compressed = (block_length & INCOMPRESSIBLE) == 0
        block_length &= ~INCOMPRESSIBLE & 0xFFFFFFFF
        if block_length > reader.block_maxsize:
            raise BlockSizeOverflow("a block is larger than the frame's block maxsize")
        payload = _read_exact(stream, block_length)
        checksum = (
            int.from_bytes(_read_exact(stream, 4), "little")
            if reader.flags.block_checksums
            else None
        )
        blocks.append((compressed, payload, checksum))


def _block_checksum_check(dev):
    def check(payload, checksum):
        if payload_xxh32(payload, device=dev) != checksum:
            raise BlockChecksumFail("a block checksum was invalid")

    return check


def _check_content(digest, expected_sum):
    """Raise ``FrameChecksumFail`` unless the content hash ``digest`` (a
    ``utils.hashing.content_hash``) comes out as ``expected_sum``."""
    if digest.digest() != expected_sum:
        raise FrameChecksumFail("the frame checksum was invalid")


@entry("decompress_frame")
def decompress_frame_parallel(
    frame,
    device=None,
    verify_checksums: bool = True,
    dictionary=None,
    lane_kernel: bool | None = None,
    mesh=None,
) -> bytes:
    """Decompress one LZ4 frame with all independent blocks in one launch
    (one a mesh entry with ``mesh``), or one a group of blocks under
    ``DECODE_BUDGET`` where they pass it.

    A preset dictionary is shared by every block as its prefix.  Frames of
    64 KiB blocks decode on ``decode128``, frames of larger blocks on
    ``decode_v4`` (each block spread over the card).  ``lane_kernel=True``
    keeps larger blocks on the lane decoder ``decode_big`` (a block a
    thread block), ``lane_kernel=False`` sends every frame to
    ``decode_v4``; the same on one device or a mesh.

    ``mesh`` (in place of ``device``) cuts the compressed blocks into one
    contiguous range per entry, each decoded on its own card; the first
    failing block in frame order raises, at every mesh size.  One
    linked-block frame goes to the serial streaming reader, on the mesh's
    first device (many of them decode in parallel through
    ``decompress_frames_parallel``).
    """
    from ..frame.decompress import LZ4FrameReader

    devs = _devices(device, mesh)
    dev = devs[0]
    frame = bytes(frame)
    dictionary = bytes(dictionary or b"")[-WINDOW_SIZE:]
    with span("lz4t.scan"):
        reader = LZ4FrameReader(frame, engine=dev)
        scanned = _scan_frame(reader) if reader.flags.independent_blocks else None
    if scanned is None:
        return LZ4FrameReader(frame, engine=dev).read_all(dictionary)

    blocks, expected_sum = scanned
    if verify_checksums and reader.flags.block_checksums:
        with span("lz4t.checksum"):
            check = _block_checksum_check(dev)
            for _, payload, checksum in blocks:
                check(payload, checksum)
    return _decode_independent(reader, blocks, expected_sum, dictionary, devs,
                               verify_checksums, lane_kernel)


def _decode_payloads(payloads, block_maxsize, dictionary, devs, lane_kernel=None):
    """The compressed payloads of an independent frame, decoded on each
    device of ``devs`` (a mesh's) that gets a range of them, one launch a
    group of blocks under ``DECODE_BUDGET`` (the budget is per device or
    mesh entry), group ``g + 1`` dispatched before group ``g`` is read
    (``_pipelined``): the decoded blocks as ``memoryview`` rows in frame
    order.  Raises the first failing block's error in frame order (the
    frame layer's ``DecodeError`` of the decoder's kind, or
    ``BlockSizeOverflow`` for a block that decoded past ``block_maxsize``);
    groups in flight after it are dropped."""
    if not payloads:
        return []
    if block_maxsize <= MAX_BLOCK and lane_kernel is not False:
        decoder = decode128
    else:
        decoder = decode_big if lane_kernel else decode_v4
    counted = lane_kernel is None and decoder is decode_v4  # big blocks, default route
    # every group gets the output capacity of one launch over all the
    # payloads, so that a hostile block stops where it would stop there
    width = round_up(max(map(len, payloads)), 16)
    out_capacity = round_up(block_maxsize + width, 16)
    ranges = _ranges(len(payloads), devs)
    groups = [[(lo + a, lo + b) for a, b in budget_groups(hi - lo, out_capacity + width)]
              for lo, hi, _ in ranges]
    # group g of every range before group g + 1 of any, so that the ranges'
    # cards work side by side
    units = [(r, (b - a) * (out_capacity + width), (a, b, ranges[r][2]))
             for g in range(max(map(len, groups)))
             for r, cuts in enumerate(groups) if g < len(cuts) for a, b in cuts[g:g + 1]]
    fetched = {}
    first_bad = None  # (block index, error): no group from there on need run

    def dispatch(work):
        a, b, dev = work
        if first_bad is not None and a >= first_bad[0]:
            return None
        if counted:
            count(big_blocks_v4=b - a)
        return _launch_decode(decoder, payloads[a:b], block_maxsize, dictionary, out_capacity,
                              dev)

    def collect(work, handle):
        nonlocal first_bad
        a = work[0]
        if first_bad is not None and a >= first_bad[0]:
            return
        out_len, status = handle.meta()
        bad = check_decoded(status, out_len, block_maxsize)
        if bad is None:
            fetched[a] = handle.collect(out_len)
        elif first_bad is None or a + bad[0] < first_bad[0]:
            first_bad = (a + bad[0], bad[1])

    _pipelined(units, dispatch, collect)
    if first_bad is not None:
        error = first_bad[1]
        raise FrameDecodeError(error.kind) if isinstance(error, DecodeError) else error
    return [row for a in sorted(fetched) for row in fetched[a]]


def _launch_decode(decoder, payloads, block_maxsize, dictionary, out_capacity, dev):
    """One launch of ``decoder`` over ``payloads`` on ``dev`` (the payloads
    and the dictionary in one upload), not waited for: a
    ``hostpack.Handle`` of the output rows, lengths and statuses."""
    batch = hostpack.upload_batch(dev, payloads,
                                  [dictionary] * len(payloads) if dictionary else None)
    with span("lz4t.launch"):
        return hostpack.Handle(*decoder(*batch, block_maxsize, out_capacity))


def _content_pieces(blocks, outputs) -> list:
    """The pieces of the frame's content in order: decoded ``outputs`` in
    the places of the compressed ``blocks``, stored payloads as they are."""
    outputs = iter(outputs)
    return [next(outputs) if compressed else payload for compressed, payload, _ in blocks]


def _join_blocks(blocks, outputs) -> bytes:
    """The frame's content, joined from ``_content_pieces``."""
    return b"".join(_content_pieces(blocks, outputs))


def _decode_independent(reader, blocks, expected_sum, dictionary, devs, verify_checksums,
                        lane_kernel=None) -> bytes:
    """The scanned blocks of an independent frame, decoded in one launch a
    group of blocks on each device of ``devs`` (``_decode_payloads``)."""
    outputs = _decode_payloads([p for c, p, _ in blocks if c], reader.block_maxsize,
                               dictionary, devs, lane_kernel)
    pieces = _content_pieces(blocks, outputs)
    # the content is hashed from its pieces beside the join
    digest = (content_hash(pieces, devs[0])
              if verify_checksums and reader.flags.content_checksum and expected_sum is not None
              else None)
    with span("lz4t.join"):
        result = b"".join(pieces)
    if digest is not None:
        with span("lz4t.checksum"):
            _check_content(digest, expected_sum)
    return result


@traced("lz4t.push")
def _push_windows(old, old_len, data, lens, dest, new, new_len):
    """Slide the carry-over windows of a wave's rows ``old`` (their
    lengths ``old_len``) over their new bytes ``data[k, :lens[k]]`` into
    the next wave's rows ``new[dest[k]]`` (``dest[k]`` -1: the frame has no
    next block): one launch of ``kernels.window.push_windows``."""
    count(window_pushes=1)
    push_windows(old, old_len, data, lens, dest, new, new_len)


#: device bytes that a wave's row takes beside its output and compressed
#: block, past its own window: the next wave's window row and the plain
#: version's int64 byte positions and copies
PUSH_BYTES = 28 * WINDOW_SIZE


@dataclass
class _Piece:
    """Rows ``a:b`` of wave ``w`` in the wave's order (its compressed
    blocks, then its stored ones): a budget group of compressed blocks,
    decoded in one launch (``decoder`` set), or the wave's stored blocks,
    which only slide their windows.  ``dest`` is each row's row in wave
    ``w + 1`` (-1: none).  A row takes ``cap`` bytes of output (0 for a
    stored block) and ``rest`` bytes besides; ``k`` is the place of the
    decoded rows in their chunk's output."""

    w: int
    a: int
    b: int
    payloads: list
    dest: np.ndarray
    cap: int
    rest: int
    limit: int = 0
    decoder: object = None
    maxsizes: np.ndarray = None
    last: bool = False  # the wave's last launch: raises its size overflow
    closes: bool = False  # the wave's last piece: its windows are let go after it
    k: int = 0


def _wave_plan(linked):
    """The pieces of ``linked``'s waves, in wave order, and the rows of
    each wave (the frames' slots in ``linked``)."""
    chains = [blocks for _, _, blocks, _ in linked]
    order = []
    for w in range(max(map(len, chains), default=0)):
        todo = [s for s, c in enumerate(chains) if w < len(c) and c[w][0]]
        stored = [s for s, c in enumerate(chains) if w < len(c) and not c[w][0]]
        order.append((todo, stored))
    rows = [todo + stored for todo, stored in order]
    pieces = []
    for w, (todo, stored) in enumerate(order):
        at = dict(zip(rows[w + 1], range(len(rows[w + 1])))) if w + 1 < len(rows) else {}
        dest = np.array([at.get(slot, -1) for slot in rows[w]], np.int32)
        if todo:
            count(waves=1)
            maxsizes = np.array([linked[slot][1].block_maxsize for slot in todo])
            limit = int(maxsizes.max())
            payloads = [chains[slot][w][1] for slot in todo]
            width = round_up(max(map(len, payloads)), 16)
            # a launch's rows: output, compressed block, its window, the slide's
            cap, rest = round_up(limit + width, 16), width + WINDOW_SIZE + PUSH_BYTES
            cuts = budget_groups(len(todo), cap + rest)
            for g, (a, b) in enumerate(cuts):
                pieces.append(_Piece(w, a, b, payloads[a:b], dest[a:b], cap, rest, limit,
                                     decode128 if limit <= MAX_BLOCK else decode_big,
                                     maxsizes[a:b], g == len(cuts) - 1))
        n = len(todo)
        for a, b in budget_groups(len(stored), WINDOW_SIZE + PUSH_BYTES):
            pieces.append(_Piece(w, n + a, n + b, [chains[slot][w][1] for slot in stored[a:b]],
                                 dest[n + a : n + b], 0, WINDOW_SIZE + PUSH_BYTES))
        pieces[-1].closes = True
    return pieces, rows


def _chunks(pieces):
    """Consecutive pieces in chunks under ``DECODE_BUDGET`` (a piece over
    it alone): each chunk one upload of its blocks, one output tensor of
    its decoded rows at the widest ``cap`` among them, and one fetch.
    Sets each decoding piece's ``k``; yields ``(cost, pieces, decoded
    rows, cap)``."""
    chunk, rows, cap, rest = [], 0, 0, 0
    for p in pieces + [None]:
        n = 0 if p is None else p.b - p.a
        out = 0 if p is None or p.decoder is None else n
        if chunk and (p is None or (rows + out) * max(cap, p.cap) + rest + n * p.rest
                      > pack.DECODE_BUDGET):
            yield rows * cap + rest, chunk, rows, cap
            chunk, rows, cap, rest = [], 0, 0, 0
        if p is not None:
            chunk.append(p)
            p.k = rows
            rows += out
            cap = max(cap, p.cap)
            rest += n * p.rest


@entry("decompress_frames")
def decompress_frames_parallel(
    frames,
    device=None,
    verify_checksums: bool = True,
    dictionaries=None,
    mesh=None,
) -> list[bytes]:
    """Decode many LZ4 frames at once — the parallel answer to linked-block
    frames, whose blocks form a serial chain within a frame (block ``i``
    needs the last 64 KiB that block ``i-1`` decoded to).  The chains of
    different frames do not depend on each other, so wave ``w`` decodes
    block ``w`` of every linked frame that has one in one launch (a group
    of frames under ``DECODE_BUDGET`` a launch), each block with its own
    frame's carry-over window as its prefix (the dictionary's last 64 KiB
    before the first block).

    The windows are right-aligned 64 KiB rows on the device, one a frame
    of a wave: each wave's rows (its decoded blocks, then its stored ones)
    slide into the next wave's rows in one launch a wave group
    (``kernels/window.py``), a stored block's payload included, so at most
    two waves' windows are held.  The waves run in chunks of whole wave
    groups under ``DECODE_BUDGET``: a chunk's blocks go up in one upload
    of whole rows, each group decodes into the chunk's one output tensor
    and its lengths and statuses (``into=``), and the chunk's rows come
    back in one ``hostpack.Handle`` (its lengths, then one fetch of the
    bytes they hold).  A wave is
    routed by the largest ``block_maxsize`` in it, which is also its
    memory limit: up to 64 KiB to ``decode128``, larger to
    ``decode_big``.  A block that decodes past its own frame's
    ``block_maxsize`` raises ``BlockSizeOverflow``, a block that fails to
    decode the frame layer's ``DecodeError`` (a ``CodecError`` of the
    decoder's kind), which wins over an overflow in the same wave; content
    checksums are checked per frame at the end.  Independent-block frames
    go through the decode of ``decompress_frame_parallel``.

    With ``mesh`` (in place of ``device``) the independent frames decode
    over the mesh, as in ``decompress_frame_parallel``, and the waves run
    on its first device, as the JAX package's run on one.
    """
    from ..frame.decompress import LZ4FrameReader

    devs = _devices(device, mesh)
    dev = devs[0]
    frames = [bytes(f) for f in frames]
    if dictionaries is None:
        dictionaries = [None] * len(frames)
    if len(dictionaries) != len(frames):
        raise ValueError(f"{len(dictionaries)} dictionaries for {len(frames)} frames")
    dictionaries = [bytes(d or b"")[-WINDOW_SIZE:] for d in dictionaries]
    check = _block_checksum_check(dev) if verify_checksums else None

    results = [None] * len(frames)
    linked = []  # (frame index, reader, blocks, expected checksum)
    for fi, frame in enumerate(frames):
        # the block checksums are checked after the scan, and a bad one
        # before the block at which the scan stopped is raised first, as a
        # check of each block as it is read would
        blocks, stop = [], None
        with span("lz4t.scan"):
            reader = LZ4FrameReader(frame, engine=dev)
            try:
                _, expected = _scan_frame(reader, blocks)
            except (BlockSizeOverflow, InputTruncated) as e:
                stop = e
        if check is not None and reader.flags.block_checksums:
            with span("lz4t.checksum"):
                for _, payload, checksum in blocks:
                    check(payload, checksum)
        if stop is not None:
            raise stop
        if reader.flags.independent_blocks:
            results[fi] = _decode_independent(reader, blocks, expected, dictionaries[fi], devs,
                                              verify_checksums)
        else:
            linked.append((fi, reader, blocks, expected))
    if not linked:
        return results

    count(linked_frames=len(linked))
    with span("lz4t.plan"):
        pieces, rows = _wave_plan(linked)
        units = [(0, cost, work) for cost, *work in _chunks(pieces)]
    # per frame, in block order: the payload of a stored block, or (piece,
    # row of its chunk) of a decoded one
    parts = [[] for _ in linked]
    for p in pieces:
        for k, slot in enumerate(rows[p.w][p.a : p.b]):
            parts[slot].append((id(p), p.k + k) if p.decoder is not None else p.payloads[k])
    # the windows of each wave's rows, right-aligned, and their lengths: the
    # dictionaries' tails before the first wave; wave w + 1's are written by
    # wave w's slides, so that one wave's are read while the next's are made
    heads = [dictionaries[linked[slot][0]] for slot in rows[0]] if rows else []
    if any(heads):
        (first, first_len), = hostpack.upload(dev, hostpack.Rows(heads, align_right=True))
        if first.shape[1] < WINDOW_SIZE:
            first = torch.nn.functional.pad(first, (WINDOW_SIZE - first.shape[1], 0))
    else:
        first = torch.zeros((len(heads), WINDOW_SIZE), dtype=torch.uint8, device=dev)
        first_len = torch.zeros(len(heads), dtype=torch.int32, device=dev)
    windows = {0: (first, first_len)}
    decoded = {}
    overflow = False

    def dispatch(work):
        chunk, n_rows, cap = work
        *blocks, dest = hostpack.upload(
            dev, *(hostpack.Rows(p.payloads, whole=True) for p in chunk),
            np.concatenate([p.dest for p in chunk]))
        # the chunk's decoded rows, and their lengths and statuses
        out = torch.empty((n_rows, cap), dtype=torch.uint8, device=dev)
        meta = torch.empty((2, n_rows), dtype=torch.int32, device=dev)
        d = 0
        for p, (comp, comp_len) in zip(chunk, blocks):
            n = p.b - p.a
            if p.w + 1 < len(rows) and p.w + 1 not in windows:
                m = len(rows[p.w + 1])
                windows[p.w + 1] = (torch.empty((m, WINDOW_SIZE), dtype=torch.uint8, device=dev),
                                    torch.empty(m, dtype=torch.int32, device=dev))
            old, old_len = (t[p.a : p.b] for t in windows[p.w])
            slide = (dest[d : d + n], *windows.get(p.w + 1, ())) if (p.dest >= 0).any() else None
            d += n
            if p.decoder is None:
                if slide:
                    _push_windows(old, old_len, comp, comp_len, *slide)
            else:
                with span("lz4t.wave"):
                    count(wave_launches=1)
                    with span("lz4t.launch"):
                        data, data_len, _ = p.decoder(
                            comp, comp_len, old, old_len, p.limit, cap,
                            into=(out[p.k : p.k + n], *meta[:, p.k : p.k + n]))
                    if slide:
                        _push_windows(old, old_len, data, data_len, *slide)
            if p.closes:
                del windows[p.w]
        return hostpack.Handle(out, meta) if n_rows else None

    def collect(work, handle):
        nonlocal overflow
        chunk = work[0]
        (lens, status), = handle.meta()
        for p in chunk:
            if p.decoder is None:
                continue
            st, got = status[p.k : p.k + p.b - p.a], lens[p.k : p.k + p.b - p.a]
            # a decode error anywhere in the wave wins over a size overflow
            if (st != OK).any():
                raise FrameDecodeError(STATUS_TO_KIND[int(st[st != OK][0])])
            overflow |= bool((got > p.maxsizes).any())
            if p.last and overflow:
                raise BlockSizeOverflow("a block decompressed to more data than allowed")
        fetched = handle.collect(lens)
        for p in chunk:
            decoded[id(p)] = fetched

    _pipelined(units, dispatch, collect)
    # each frame's content is hashed from its pieces beside the joins
    digests = []
    with span("lz4t.join"):
        for (fi, reader, _, expected), ps in zip(linked, parts):
            ps = [decoded[p[0]][p[1]] if isinstance(p, tuple) else p for p in ps]
            if verify_checksums and reader.flags.content_checksum and expected is not None:
                digests.append((content_hash(ps, dev), expected))
            results[fi] = b"".join(ps)
    if digests:
        with span("lz4t.checksum"):
            for digest, expected in digests:
                _check_content(digest, expected)
    return results
