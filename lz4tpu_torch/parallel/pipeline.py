"""Whole-frame codec: every block of a frame in one launch a device.

Counterpart of ``lz4tpu/parallel/pipeline.py``.  Independent-block frames
are embarrassingly parallel: the frame's blocks go to the card as one
padded uint8 tensor (one H2D copy), each kernel runs once over all of them,
the lengths and statuses come back first and then only the bytes needed
(one D2H copy), and the host assembles the frame in order.

Every entry point takes ``device`` (one device) or ``mesh`` (a
``parallel.mesh.Mesh``, this process's cards; not both).  On a mesh the
frame's blocks are cut into one contiguous range per entry
(``mesh.shard_bounds``), whole output blocks for the lane compressor; each
range goes to its card in one H2D copy that also carries what its first
block may look back at (in a linked frame the 64 KiB of input before the
range: the JAX package's ring halo), and its kernel is launched on that
card's stream.  Every range is launched before any range's results are
read, then the results are joined in frame order, so a frame is
byte-identical at every mesh size and a decode raises the first failing
block in frame order.  An entry that gets no block gets no launch.

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
  hostile-input checks, block checksums, one ``decode128`` launch for
  frames of 64 KiB blocks, one ``decode_big`` launch for frames of larger
  blocks (``decompress_v4`` when ``lane_kernel=False``), stored blocks
  passed through, and the content checksum.  One linked frame is a serial
  chain and goes to the port's serial reader, as in the JAX package.
* ``decompress_frames_parallel`` — many frames at once: linked frames are
  decoded in waves, wave ``w`` being block ``w`` of every linked frame in
  one launch, each block with its own frame's 64 KiB carry-over window,
  which stays on the device from wave to wave.

``compress_frame_parallel(lane_kernel=True)`` compresses with the lane
compressor (``kernels/compress128.py``) instead: the input is cut into
chunks of at most 32 KiB, all chunks of the frame are compressed in one
launch, each behind a window of the bytes before it, and the chunk streams
of one output block are spliced into ONE block of the declared size
(``kernels/splice.py``).  That is how a 4 MiB block becomes 128 parallel
parses.  Such a frame is valid LZ4 of about the same size, not the
streaming writer's bytes.

The streaming API takes the same one-launch paths for independent frames:
``CompressionSettings`` writes its batches through ``_scalar_blocks``, and
``LZ4FrameReader.read_all`` decodes through ``_scan_frame`` and
``_decode_payloads``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frame.errors import BlockChecksumFail, BlockSizeOverflow, FrameChecksumFail, InvalidBlockSize
from ..frame.header import INCOMPRESSIBLE, MAGIC, BlockDescriptor, Flags
from ..kernels.compress import compress_batch
from ..kernels.compress128 import MAX_B, compress128
from ..kernels.decode128 import MAX_BLOCK, decode128
from ..kernels.decodebig import decode_big
from ..kernels.decompress_v4 import decode_v4
from ..kernels.pack import check_decoded, compact_rows, fetch_rows, pack_prefixes, pack_rows
from ..kernels.splice import splice_streams
from ..kernels.status import OK, STATUS_INCOMPRESSIBLE, STATUS_TO_KIND
from ..runtime import host_u8, resolve_device, round_up
from ..spec.block import WINDOW_SIZE, DecodeError
from ..spec.table import U32_SLOTS, U32Table, prime_u32_table
from ..spec.xxhash32 import xxh32
from ..utils.hashing import make_hasher
from ..utils.hashing import xxh32 as payload_xxh32
from .mesh import shard_bounds


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
    before the range | the range's blocks, padded whole]``, and each row's
    cursor.  A block whose window is not full (the frame's block 0 without
    a dictionary of at least 64 KiB) is laid out and parsed as an
    independent block at cursor 0: an unprimed table's empty slots alias
    buffer position 0, which is only safe to parse from there."""
    w = WINDOW_SIZE
    rows = padded.as_strided((n_blocks, w + block_size), (block_size, 1)).contiguous()
    cursors = np.full(n_blocks, w, np.int32)
    if not full_first:
        rows[0, :block_size] = padded[w : w + block_size].clone()  # rows may alias padded
        rows[0, block_size:] = 0
        cursors[0] = 0
    return rows, cursors


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


def _scalar_launch(src, lo, hi, lens, block_size, dictionary, parallel_linked, acceleration,
                   dev):
    """Blocks ``lo:hi`` of the frame through the scalar greedy compressor,
    one launch on ``dev``, not waited for: the kernel's (out, out_len,
    status)."""
    w = WINDOW_SIZE
    d = len(dictionary or b"")
    n_blocks = hi - lo
    lens = lens[lo:hi]
    a = lo * block_size
    b = a + int(lens.sum())
    cursors = np.zeros(n_blocks, np.int32)
    prime = np.zeros(n_blocks, np.int32)
    if parallel_linked:
        # one H2D copy of the range behind the 64 KiB of input before it
        # (every block is at least 64 KiB, so a range past the first has a
        # full window); the frame's first block is behind the dictionary's tail
        halo = min(a, w)
        padded = torch.zeros(w + n_blocks * block_size, dtype=torch.uint8, device=dev)
        padded[w - halo : w + b - a].copy_(src[a - halo : b])
        if lo == 0 and d >= w:
            padded[:w].copy_(torch.frombuffer(bytearray(dictionary[-w:]), dtype=torch.uint8))
        rows, cursors = _linked_rows(padded, n_blocks, block_size, lo > 0 or d >= w)
        prime = cursors > 0
    else:
        # one H2D copy of the range, padded to whole blocks on the device
        flat = torch.zeros(n_blocks * block_size, dtype=torch.uint8, device=dev)
        flat[: b - a].copy_(src[a:b])
        rows = flat.view(n_blocks, block_size)
        if d:
            cursors[:] = d
            buf = torch.empty((n_blocks, d + block_size), dtype=torch.uint8, device=dev)
            buf[:, :d] = torch.frombuffer(bytearray(dictionary), dtype=torch.uint8).to(dev)
            buf[:, d:] = rows
            rows = buf
    template = U32Table()
    if d and not parallel_linked:
        # every template position sits behind the cursor (buffer coordinates
        # equal dictionary coordinates), so the primed table is shared.  Linked
        # rows hold only the dictionary's tail, in other coordinates: their
        # tables are primed in the kernel instead
        prime_u32_table(template, dictionary)
    tables = (
        torch.from_numpy(template.dict.view(np.int32).copy())
        .to(dev)
        .expand(n_blocks, U32_SLOTS)
        .contiguous()
    )

    def i32(vals):
        return torch.from_numpy(np.ascontiguousarray(vals, dtype=np.int32)).to(dev)

    caps = lens  # output capped at input size: incompressible fallback
    out, out_len, status, _ = compress_batch(
        rows,
        i32(lens + cursors),
        i32(cursors),
        i32(caps),
        i32(np.full(n_blocks, max(int(acceleration), 1))),
        i32(np.zeros(n_blocks)),
        i32(prime),
        tables,
        round_up(block_size + 16, 16),
    )
    return out, out_len, status


def _scalar_blocks(src, block_size, dictionary, parallel_linked, acceleration, devs):
    """The frame's blocks through the scalar greedy compressor, one launch
    on each device of ``devs`` (a mesh's) that gets a range of them:
    (payloads, lens), a payload ``None`` where the block is stored raw."""
    lens = _block_lens(src.numel(), block_size)
    # every range's copy and launch before any range's lengths are read: a
    # read waits for its card, and the cards after it would wait with it
    launched = [(lo, hi, _scalar_launch(src, lo, hi, lens, block_size, dictionary,
                                        parallel_linked, acceleration, dev))
                for lo, hi, dev in _ranges(len(lens), devs)]
    payloads = []
    for lo, hi, (out, out_len, status) in launched:
        out_len = out_len.cpu().numpy()
        stored = status.cpu().numpy() == STATUS_INCOMPRESSIBLE
        payloads += fetch_rows(out, out_len, ~stored & (lens[lo:hi] > 0))
    return payloads, lens


def _lane_launch(src, lo, hi, lens, block_size, dictionary, parallel_linked, chunk_windows,
                 dev):
    """Output blocks ``lo:hi`` of the frame through the lane compressor,
    one launch over all their chunks on ``dev``, not waited for: the
    kernel's (out, out_len, tail_pos, tail_lit).

    A chunk's row is cut from one flat source on the device by its base
    offset: the 64 KiB before the chunk, stopped at ``floor``, the first
    byte its block may refer to.  Linked frames: the source is ``[dictionary
    tail | input]`` (for a range past the first, the 64 KiB of input before
    it in the same H2D copy) and the floor its start.  Independent frames:
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

    if parallel_linked and lo:
        # a range past the first: its one H2D copy starts 64 KiB before it
        d = WINDOW_SIZE
        flat = src[a - d : a + n].to(dev)
    else:
        data = src[a : a + n].to(dev)  # the one H2D copy of the range
        if d:
            tail_dev = torch.frombuffer(bytearray(tail), dtype=torch.uint8).to(dev)
        if parallel_linked:
            flat = torch.cat([tail_dev, data]) if d else data
    if parallel_linked:
        start = d + idx * chunk
        floor = np.zeros(n_chunks, np.int64)
    elif d:
        segment = d + block_size
        buf = torch.zeros((n_blocks, segment), dtype=torch.uint8, device=dev)
        buf[:, :d] = tail_dev
        padded = torch.zeros(n_blocks * block_size, dtype=torch.uint8, device=dev)
        padded[:n] = data
        buf[:, d:] = padded.view(n_blocks, block_size)
        flat = buf.view(-1)
        floor = (idx // cpb) * segment
        start = floor + d + (idx % cpb) * chunk
    else:
        flat = data
        start = idx * chunk
        floor = (idx // cpb) * block_size
    # a dictionary is only addressable through a gapless window, so with one
    # the in-block windows stay whatever ``chunk_windows`` says
    if parallel_linked or d or (cpb > 1 and chunk_windows):
        base = np.maximum(start - WINDOW_SIZE, floor)
    else:
        base = start
    cur0 = (start - base).astype(np.int32)
    return compress128(
        flat,
        torch.from_numpy(base).to(dev),
        torch.from_numpy(cur0 + chunk_len.astype(np.int32)).to(dev),
        torch.from_numpy(cur0).to(dev),
    )


def _lane_blocks(src, block_size, dictionary, parallel_linked, chunk_windows, devs):
    """The frame's blocks through the lane compressor, one launch on each
    device of ``devs`` that gets a range of output blocks (never a range of
    chunks: the chunk streams of a block are spliced together): (payloads,
    lens), a payload ``None`` where the block is stored raw."""
    n = src.numel()
    cpb = block_size // min(block_size, MAX_B)
    lens = _block_lens(n, block_size)
    if n == 0:
        return [None], lens
    launched = [(lo, hi, _lane_launch(src, lo, hi, lens, block_size, dictionary,
                                      parallel_linked, chunk_windows, dev))
                for lo, hi, dev in _ranges(len(lens), devs)]
    payloads = []
    for lo, hi, (out, out_len, tail_pos, tail_lit) in launched:
        out_len, tail_pos, tail_lit = torch.stack([out_len, tail_pos, tail_lit]).cpu().numpy()
        streams = fetch_rows(out, out_len, np.ones(len(out_len), bool))
        tails = list(zip(tail_pos.tolist(), tail_lit.tolist()))
        for ob in range(hi - lo):
            c0, c1 = ob * cpb, min((ob + 1) * cpb, len(streams))
            payload = streams[c0] if c1 - c0 == 1 else splice_streams(streams[c0:c1],
                                                                      tails[c0:c1])
            # the lane kernel has no output cap: a block that did not shrink
            # is stored raw, as the capped scalar parse would have it
            payloads.append(payload if len(payload) <= lens[lo + ob] else None)
    return payloads, lens


def _devices(device, mesh) -> tuple:
    """The devices a call runs on: the mesh's entries, or ``device``."""
    if mesh is None:
        return (resolve_device(device),)
    if device is not None:
        raise ValueError("lz4tpu_torch: pass device= or mesh=, not both")
    return mesh.devices


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
    dictionary = bytes(dictionary) if dictionary is not None else None
    if lane_kernel:
        payloads, lens = _lane_blocks(src, block_size, dictionary, parallel_linked,
                                      chunk_windows, devs)
    else:
        payloads, lens = _scalar_blocks(src, block_size, dictionary, parallel_linked,
                                        acceleration, devs)

    # host-side ordered assembly (frame order)
    flags = Flags(
        independent_blocks=not parallel_linked,
        block_checksums=block_checksums,
        content_checksum=content_checksum,
        content_size=with_content_size,
        dictionary_id=dictionary_id is not None,
    )
    mv = memoryview(src.numpy())
    parts = [_frame_header(flags, bd, n if with_content_size else None, dictionary_id)]
    for i, payload in enumerate(payloads):
        if not lens[i]:
            continue  # no zero-length blocks: 0 is the EndMark
        if payload is None:
            payload = mv[i * block_size : i * block_size + int(lens[i])]
            parts.append((int(lens[i]) | INCOMPRESSIBLE).to_bytes(4, "little"))
        else:
            parts.append(len(payload).to_bytes(4, "little"))
        parts.append(payload)
        if block_checksums:
            parts.append(payload_xxh32(payload, device=dev).to_bytes(4, "little"))
    parts.append((0).to_bytes(4, "little"))
    if content_checksum:
        parts.append(make_hasher(0, dev).update(mv).digest().to_bytes(4, "little"))
    return b"".join(parts)


def _scan_frame(reader, check=None, blocks=None):
    """The frame's block chain without decoding: [(compressed, payload,
    checksum)] and the trailer checksum, with the streaming reader's
    hostile-input checks.  ``check(payload, checksum)``, if given, is called
    for each block as it is read.  The blocks are appended to ``blocks``
    when given, so that the caller keeps those read before an error."""
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
        if check is not None and checksum is not None:
            check(payload, checksum)
        blocks.append((compressed, payload, checksum))


def _block_checksum_check(dev):
    def check(payload, checksum):
        if payload_xxh32(payload, device=dev) != checksum:
            raise BlockChecksumFail("a block checksum was invalid")

    return check


def _check_content(data, expected_sum, dev):
    if make_hasher(0, dev).update(data).digest() != expected_sum:
        raise FrameChecksumFail("the frame checksum was invalid")


def decompress_frame_parallel(
    frame,
    device=None,
    verify_checksums: bool = True,
    dictionary=None,
    lane_kernel: bool | None = None,
    mesh=None,
) -> bytes:
    """Decompress one LZ4 frame with all independent blocks in one launch
    (one a mesh entry with ``mesh``).

    A preset dictionary is shared by every block as its prefix.  Frames of
    64 KiB blocks decode on ``decode128``, frames of larger blocks on
    ``decode_big``.  ``lane_kernel=False`` sends both to ``decompress_v4``.
    ``None`` (auto) and ``True`` are the same here, on one device or a
    mesh: ``lz4tpu`` keeps multi-device meshes off its lane decoders only
    for the speed of its CPU interpret mode.

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
    reader = LZ4FrameReader(frame, engine=dev)
    if not reader.flags.independent_blocks:
        return LZ4FrameReader(frame, engine=dev).read_all(dictionary)

    blocks, expected_sum = _scan_frame(reader)
    if verify_checksums and reader.flags.block_checksums:
        check = _block_checksum_check(dev)
        for _, payload, checksum in blocks:
            check(payload, checksum)
    return _decode_independent(reader, blocks, expected_sum, dictionary, devs,
                               verify_checksums, lane_kernel)


def _decode_payloads(payloads, block_maxsize, dictionary, devs, lane_kernel=None):
    """The compressed payloads of an independent frame, decoded in one
    launch on each device of ``devs`` (a mesh's) that gets a range of them;
    raises the first failing block's error in frame order (the decoder's
    ``DecodeError``, or ``BlockSizeOverflow`` for a block that decoded past
    ``block_maxsize``)."""
    if not payloads:
        return []
    if lane_kernel is False:
        decoder = decode_v4
    else:
        decoder = decode128 if block_maxsize <= MAX_BLOCK else decode_big
    # every range gets the output capacity of one launch over all the
    # payloads, so that a hostile block stops where it would stop there
    out_capacity = round_up(block_maxsize + round_up(max(map(len, payloads)), 16), 16)
    launched = []
    for lo, hi, dev in _ranges(len(payloads), devs):
        comp, comp_len = pack_rows(payloads[lo:hi], dev)
        prefix, prefix_len = pack_prefixes([dictionary] * (hi - lo) if dictionary else None,
                                           hi - lo, dev)
        launched.append(decoder(comp, comp_len, prefix, prefix_len, block_maxsize,
                                out_capacity))
    # every range launched before the first lengths are read
    results = [(out, out_len.cpu().numpy(), status.cpu().numpy())
               for out, out_len, status in launched]
    bad = check_decoded(np.concatenate([status for _, _, status in results]),
                        np.concatenate([out_len for _, out_len, _ in results]), block_maxsize)
    if bad is not None:
        raise bad[1]
    return [row for out, out_len, _ in results
            for row in fetch_rows(out, out_len, np.ones(len(out_len), bool))]


def _join_blocks(blocks, outputs) -> bytes:
    """The frame's content: decoded ``outputs`` in the places of the
    compressed ``blocks``, stored payloads as they are."""
    outputs = iter(outputs)
    return b"".join(next(outputs) if compressed else payload for compressed, payload, _ in blocks)


def _decode_independent(reader, blocks, expected_sum, dictionary, devs, verify_checksums,
                        lane_kernel=None) -> bytes:
    """The scanned blocks of an independent frame, decoded in one launch a
    device of ``devs``."""
    outputs = _decode_payloads([p for c, p, _ in blocks if c], reader.block_maxsize,
                               dictionary, devs, lane_kernel)
    result = _join_blocks(blocks, outputs)
    if verify_checksums and reader.flags.content_checksum and expected_sum is not None:
        _check_content(result, expected_sum, devs[0])
    return result


def _push_windows(windows, wlen, slots, data, lens):
    """Slide the carry-over windows of the frames ``slots`` over their new
    bytes, on the device: ``windows[slots]`` becomes the last 64 KiB of
    ``window | data[k, :lens[k]]`` (right-aligned rows) and ``wlen[slots]``
    grows by ``lens``, up to 64 KiB.  ``windows`` and ``wlen`` are updated
    in place."""
    w = WINDOW_SIZE
    lens = lens.to(torch.int64)
    # byte j of the new window is byte t = lens - w + j of the data, or,
    # where t < 0, byte w + t of the old window
    t = lens[:, None] - w + torch.arange(w, device=data.device)[None, :]
    new = torch.gather(data, 1, t.clamp(min=0))
    old = torch.gather(windows[slots], 1, (t + w).clamp(max=w - 1))
    windows[slots] = torch.where(t >= 0, new, old)
    wlen[slots] = torch.clamp(wlen[slots] + lens.to(torch.int32), max=w)


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
    block ``w`` of every linked frame that has one in one launch, each
    block with its own frame's carry-over window as its prefix (the
    dictionary's last 64 KiB before the first block).

    The windows are one right-aligned ``(frames, 65536)`` tensor that is
    updated on the device after each wave, a stored block's payload
    included; each wave's output stays on the device until the end, and
    only lengths and statuses come back per wave.  A wave is routed by the
    largest ``block_maxsize`` in it, which is also its memory limit: up to
    64 KiB to ``decode128``, larger to ``decode_big``.  A block that
    decodes past its own frame's ``block_maxsize`` raises
    ``BlockSizeOverflow``; content checksums are checked per frame at the
    end.  Independent-block frames go through the one-launch decode of
    ``decompress_frame_parallel``.

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
        reader = LZ4FrameReader(frame, engine=dev)
        blocks, expected = _scan_frame(reader, check)
        if reader.flags.independent_blocks:
            results[fi] = _decode_independent(reader, blocks, expected, dictionaries[fi], devs,
                                              verify_checksums)
        else:
            linked.append((fi, reader, blocks, expected))
    if not linked:
        return results

    windows, wlen = pack_rows([dictionaries[fi] for fi, *_ in linked], dev, align_right=True)
    if windows.shape[1] < WINDOW_SIZE:
        windows = torch.nn.functional.pad(windows, (WINDOW_SIZE - windows.shape[1], 0))
    # per frame, in block order: host bytes of a stored block, or (wave's
    # packed output, start, length) of a decoded one
    pieces = [[] for _ in linked]
    for w in range(max(len(blocks) for _, _, blocks, _ in linked)):
        todo, stored = [], []
        for slot, (_, _, blocks, _) in enumerate(linked):
            if w < len(blocks):
                (todo if blocks[w][0] else stored).append(slot)
        if stored:
            payloads = [linked[slot][2][w][1] for slot in stored]
            for slot, payload in zip(stored, payloads):
                pieces[slot].append(payload)
            data, lens = pack_rows([p[-WINDOW_SIZE:] for p in payloads], dev)
            _push_windows(windows, wlen, torch.tensor(stored, device=dev), data, lens)
        if not todo:
            continue
        maxsizes = np.array([linked[slot][1].block_maxsize for slot in todo])
        limit = int(maxsizes.max())
        decoder = decode128 if limit <= MAX_BLOCK else decode_big
        slots = torch.tensor(todo, device=dev)
        comp, comp_len = pack_rows([linked[slot][2][w][1] for slot in todo], dev)
        out, out_len, status = decoder(comp, comp_len, windows[slots], wlen[slots], limit)
        _push_windows(windows, wlen, slots, out, out_len)
        status = status.cpu().numpy()
        lens = out_len.cpu().numpy()
        if (status != OK).any():
            raise DecodeError(STATUS_TO_KIND[int(status[status != OK][0])])
        if (lens > maxsizes).any():
            raise BlockSizeOverflow("a block decompressed to more data than allowed")
        packed = compact_rows(out, lens)
        ends = np.cumsum(lens)
        for k, slot in enumerate(todo):
            pieces[slot].append((packed, int(ends[k] - lens[k]), int(lens[k])))

    # one D2H copy of everything decoded, in frame and block order
    decoded = []
    for ps in pieces:
        for p in ps:
            if not isinstance(p, bytes) and p[2]:
                packed, start, n = p
                decoded.append(packed[start : start + n])
    flat = torch.cat(decoded).cpu().numpy() if decoded else np.zeros(0, np.uint8)
    pos = 0
    for (fi, reader, _, expected), ps in zip(linked, pieces):
        parts = []
        for p in ps:
            if isinstance(p, bytes):
                parts.append(p)
            else:
                parts.append(flat[pos : pos + p[2]].tobytes())
                pos += p[2]
        data = b"".join(parts)
        if verify_checksums and reader.flags.content_checksum and expected is not None:
            _check_content(data, expected, dev)
        results[fi] = data
    return results
