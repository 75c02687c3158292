"""Whole-frame codec: every block of a frame in one launch a device
(a decode: one launch a group of blocks under ``DECODE_BUDGET``).

Counterpart of ``lz4tpu/parallel/pipeline.py``: the three entry points.
Their block work (the uploads, the launches and their pipelining, the
decoder rule, the content join) is ``parallel.blocks``, the linked waves
are ``parallel.waves``, and the frame format's steps (header, block words,
the block chain's scan) are ``frame.format``.

Every entry point takes ``device`` (one device) or ``mesh`` (a
``parallel.mesh.Mesh``, this process's cards; not both).  On a mesh the
frame's blocks are cut into one contiguous range per entry, each launched
on its own card before any range's results are read, then joined in frame
order, so a frame is byte-identical at every mesh size and a decode raises
the first failing block in frame order.

``compress_frame_parallel`` writes a frame in independent or linked
blocks on the scalar or the lane compressor, ``decompress_frame_parallel``
reads one independent frame (one linked frame goes to the serial reader,
as in the JAX package), and ``decompress_frames_parallel`` reads many,
linked ones in waves.

A frame's content checksum is hashed beside the rest of the call
(``utils.hashing.content_hash``): a write's from the input, before its
blocks are uploaded; a read's from the decoded rows and stored payloads,
while they are joined.  A read raises ``FrameChecksumFail`` before any
content is returned.

Each entry point runs in a span of its own (``lz4t.compress_frame``,
``lz4t.decompress_frame``, ``lz4t.decompress_frames``) that holds one span
a phase: ``lz4t.scan``, ``lz4t.join``, ``lz4t.assemble`` and
``lz4t.checksum`` (block checksums, and the wait for a content hash that
is not ready) here; ``parallel.blocks``' ``lz4t.launch``, ``hostpack``'s
transfers and waits, and the waves' spans below them.
"""

from __future__ import annotations

from ..frame.decompress import LZ4FrameReader
from ..frame.errors import BlockChecksumFail, BlockSizeOverflow, FrameChecksumFail
from ..frame.errors import InputTruncated, InvalidBlockSize
from ..frame.format import block_word, frame_header, scan_frame
from ..frame.header import BlockDescriptor, Flags
from ..runtime import entry, host_u8, resolve_device, span
from ..spec.block import WINDOW_SIZE
from ..utils.hashing import content_hash
from ..utils.hashing import xxh32 as payload_xxh32
from .blocks import (block_lens, content_pieces, decode_payloads, join_content, lane_collect,
                     lane_launch, pipelined, ranges, scalar_collect, scalar_launch)
from .waves import decode_waves


def _scalar_blocks(src, block_size, dictionary, parallel_linked, acceleration, devs):
    """The frame's blocks through the scalar greedy compressor, one launch
    on each device of ``devs`` (a mesh's) that gets a range of them, each
    range dispatched before the ranges before it are read: (payloads,
    lens), a payload ``None`` where the block is stored raw."""
    lens = block_lens(src.numel(), block_size)
    payloads = []
    pipelined(
        ((r, 0, work) for r, work in enumerate(ranges(len(lens), devs))),
        lambda work: scalar_launch(src, *work[:2], lens, block_size, dictionary,
                                   parallel_linked, acceleration, work[2]),
        lambda work, handle: payloads.extend(scalar_collect(handle, lens[work[0]:work[1]])))
    return payloads, lens


def _lane_blocks(src, block_size, dictionary, parallel_linked, chunk_windows, devs):
    """As ``_scalar_blocks``, through the lane compressor, whose ranges are
    whole output blocks: the chunk streams of a block are spliced together."""
    lens = block_lens(src.numel(), block_size)
    if src.numel() == 0:
        return [None], lens
    payloads = []
    pipelined(
        ((r, 0, work) for r, work in enumerate(ranges(len(lens), devs))),
        lambda work: lane_launch(src, *work[:2], lens, block_size, dictionary,
                                 parallel_linked, chunk_windows, work[2]),
        lambda work, handle: payloads.extend(
            lane_collect(handle, lens[work[0]:work[1]], block_size)))
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
        parts = [frame_header(flags, bd, n if with_content_size else None, dictionary_id)]
        for i, (raw, payload) in enumerate(blocks):
            parts += [block_word(len(payload), raw), payload]
            if sums is not None:
                parts.append(sums[i].to_bytes(4, "little"))
        parts.append((0).to_bytes(4, "little"))
        if content_sum is not None:
            parts.append(content_sum.to_bytes(4, "little"))
        return b"".join(parts)


def _check_block_sums(blocks, dev):
    """Raise ``BlockChecksumFail`` at the first scanned block whose
    checksum is wrong."""
    for _, payload, checksum in blocks:
        if payload_xxh32(payload, device=dev) != checksum:
            raise BlockChecksumFail("a block checksum was invalid")


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
    devs = _devices(device, mesh)
    dev = devs[0]
    frame = bytes(frame)
    dictionary = bytes(dictionary or b"")[-WINDOW_SIZE:]
    with span("lz4t.scan"):
        reader = LZ4FrameReader(frame, engine=dev)
        scanned = scan_frame(reader) if reader.flags.independent_blocks else None
    if scanned is None:
        return LZ4FrameReader(frame, engine=dev).read_all(dictionary)

    blocks, expected_sum = scanned
    if verify_checksums and reader.flags.block_checksums:
        with span("lz4t.checksum"):
            _check_block_sums(blocks, dev)
    return _decode_independent(reader, blocks, expected_sum, dictionary, devs,
                               verify_checksums, lane_kernel)


def _decode_independent(reader, blocks, expected_sum, dictionary, devs, verify_checksums,
                        lane_kernel=None) -> bytes:
    """The scanned blocks of an independent frame, decoded in one launch a
    group of blocks on each device of ``devs`` (``blocks.decode_payloads``),
    joined with the content hash beside the join."""
    outputs = decode_payloads([p for c, p, _ in blocks if c], reader.block_maxsize,
                              dictionary, devs, lane_kernel)
    with span("lz4t.join"):
        result, digest = join_content(
            content_pieces(blocks, outputs),
            verify_checksums and reader.flags.content_checksum and expected_sum is not None,
            devs[0])
    if digest is not None:
        with span("lz4t.checksum"):
            _check_content(digest, expected_sum)
    return result


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

    The windows stay on the device from wave to wave, and the waves run
    in chunks under ``DECODE_BUDGET``, one upload and one fetch a chunk
    (``parallel.waves``).  A wave is routed by the largest
    ``block_maxsize`` in it, which is also its memory limit: up to 64 KiB
    to ``decode128``, larger to ``decode_big``.  A block that decodes past
    its own frame's ``block_maxsize`` raises ``BlockSizeOverflow``, a
    block that fails to decode the frame layer's ``DecodeError`` (a
    ``CodecError`` of the decoder's kind), which wins over an overflow in
    the same wave; content checksums are checked per frame at the end.
    Independent-block frames go through the decode of
    ``decompress_frame_parallel``.

    With ``mesh`` (in place of ``device``) the independent frames decode
    over the mesh, as in ``decompress_frame_parallel``, and the waves run
    on its first device, as the JAX package's run on one.
    """
    devs = _devices(device, mesh)
    dev = devs[0]
    frames = [bytes(f) for f in frames]
    if dictionaries is None:
        dictionaries = [None] * len(frames)
    if len(dictionaries) != len(frames):
        raise ValueError(f"{len(dictionaries)} dictionaries for {len(frames)} frames")
    dictionaries = [bytes(d or b"")[-WINDOW_SIZE:] for d in dictionaries]

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
                _, expected = scan_frame(reader, blocks)
            except (BlockSizeOverflow, InputTruncated) as e:
                stop = e
        if verify_checksums and reader.flags.block_checksums:
            with span("lz4t.checksum"):
                _check_block_sums(blocks, dev)
        if stop is not None:
            raise stop
        if reader.flags.independent_blocks:
            results[fi] = _decode_independent(reader, blocks, expected, dictionaries[fi], devs,
                                              verify_checksums)
        else:
            linked.append((fi, reader, blocks, expected))
    if not linked:
        return results

    pieces = decode_waves(linked, dictionaries, dev)
    digests = []
    with span("lz4t.join"):
        for (fi, reader, _, expected), ps in zip(linked, pieces):
            results[fi], digest = join_content(
                ps, verify_checksums and reader.flags.content_checksum and expected is not None,
                dev)
            if digest is not None:
                digests.append((digest, expected))
    if digests:
        with span("lz4t.checksum"):
            for digest, expected in digests:
                _check_content(digest, expected)
    return results
