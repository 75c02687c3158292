"""Whole-frame codec on one device: every block of a frame in one launch.

Counterpart of ``lz4tpu/parallel/pipeline.py`` for one device (``device``
takes the place of ``mesh``).  Independent-block frames are
embarrassingly parallel: the frame's blocks go to the card as one padded
uint8 tensor (one H2D copy), each kernel runs once over all of them, the
lengths and statuses come back first and then only the bytes needed (one
D2H copy), and the host assembles the frame in order.

* ``compress_frame_parallel`` — independent mode, byte-identical to the
  streaming writer (and to the JAX package's ``compress_frame_parallel``)
  with the same settings, preset dictionary included: host-primed template
  table plus a per-block ``[dictionary | block]`` buffer parsed from
  ``cursor = len(dictionary)`` (reference ``framed/compress.rs:202-218``).
* ``decompress_frame_parallel`` — block scan with the streaming reader's
  hostile-input checks, block checksums, one ``decode128`` launch for
  frames of 64 KiB blocks, one ``decompress_v4`` launch for larger blocks,
  stored blocks passed through, and the content checksum.  A linked frame
  goes to the port's serial reader, as in the JAX package.

``parallel_linked`` and ``lane_kernel=True`` compression are later slices
of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frame.errors import BlockChecksumFail, BlockSizeOverflow, FrameChecksumFail, InvalidBlockSize
from ..frame.header import INCOMPRESSIBLE, MAGIC, BlockDescriptor, Flags
from ..kernels.compress import compress_batch
from ..kernels.decode128 import MAX_BLOCK, decode128
from ..kernels.decompress_v4 import decode_v4
from ..kernels.pack import check_decoded, fetch_rows, pack_prefixes, pack_rows
from ..kernels.status import STATUS_INCOMPRESSIBLE
from ..runtime import host_u8, resolve_device, round_up
from ..spec.block import WINDOW_SIZE
from ..spec.table import U32_SLOTS, U32Table, prime_u32_table
from ..spec.xxhash32 import xxh32
from ..utils.hashing import make_hasher
from ..utils.hashing import xxh32 as payload_xxh32


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
) -> bytes:
    """Compress one LZ4 frame with all blocks in one kernel launch.

    Independent mode is byte-identical to the streaming writer
    (``frame.compress.CompressionSettings``) with the same settings,
    including a preset dictionary.
    """
    if parallel_linked:
        raise NotImplementedError(
            "parallel_linked frame compression is a later slice of the port "
            "(ROADMAP.md queue 1: parallel_linked compress)"
        )
    if lane_kernel:
        raise NotImplementedError(
            "lane_kernel=True needs the compress128 counterpart, a later slice "
            "of the port (ROADMAP.md queue 1: compress128 with STRICT/window modes)"
        )
    bd = BlockDescriptor.for_block_maxsize(block_size)
    if bd is None:
        raise InvalidBlockSize(str(block_size))
    dev = resolve_device(device)
    src = host_u8(data)
    n = src.numel()
    dictionary = bytes(dictionary) if dictionary is not None else None
    d = len(dictionary or b"")
    n_blocks = max(-(-n // block_size), 1)
    lens = np.full(n_blocks, block_size, np.int32)
    lens[-1] = n - (n_blocks - 1) * block_size

    # one H2D copy of the content, padded to whole blocks on the device
    flat = torch.zeros(n_blocks * block_size, dtype=torch.uint8, device=dev)
    flat[:n].copy_(src)
    rows = flat.view(n_blocks, block_size)
    if d:
        buf = torch.empty((n_blocks, d + block_size), dtype=torch.uint8, device=dev)
        buf[:, :d] = torch.frombuffer(bytearray(dictionary), dtype=torch.uint8).to(dev)
        buf[:, d:] = rows
        rows = buf
    template = U32Table()
    if d:
        # every template position sits behind the cursor (buffer coordinates
        # equal dictionary coordinates), so the primed table is shared
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
        i32(lens + d),
        i32(np.full(n_blocks, d)),
        i32(caps),
        i32(np.full(n_blocks, max(int(acceleration), 1))),
        i32(np.zeros(n_blocks)),
        i32(np.zeros(n_blocks)),
        tables,
        round_up(block_size + 16, 16),
    )
    out_len = out_len.cpu().numpy()
    status = status.cpu().numpy()
    stored = status == STATUS_INCOMPRESSIBLE
    payloads = fetch_rows(out, out_len, ~stored & (lens > 0))

    # host-side ordered assembly (frame order)
    flags = Flags(
        independent_blocks=True,
        block_checksums=block_checksums,
        content_checksum=content_checksum,
        content_size=with_content_size,
        dictionary_id=dictionary_id is not None,
    )
    mv = memoryview(src.numpy())
    parts = [_frame_header(flags, bd, n if with_content_size else None, dictionary_id)]
    for i in range(n_blocks):
        if not lens[i]:
            continue  # no zero-length blocks: 0 is the EndMark
        if stored[i]:
            payload = mv[i * block_size : i * block_size + int(lens[i])]
            parts.append((int(lens[i]) | INCOMPRESSIBLE).to_bytes(4, "little"))
        else:
            payload = payloads[i]
            parts.append(len(payload).to_bytes(4, "little"))
        parts.append(payload)
        if block_checksums:
            parts.append(payload_xxh32(payload, device=dev).to_bytes(4, "little"))
    parts.append((0).to_bytes(4, "little"))
    if content_checksum:
        parts.append(make_hasher(0, dev).update(mv).digest().to_bytes(4, "little"))
    return b"".join(parts)


def _scan_frame(reader):
    """The frame's block chain without decoding: [(compressed, payload,
    checksum)] and the trailer checksum, with the streaming reader's
    hostile-input checks."""
    from ..frame.decompress import _read_exact

    blocks = []
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


def decompress_frame_parallel(
    frame,
    device=None,
    verify_checksums: bool = True,
    dictionary=None,
    lane_kernel: bool | None = None,
) -> bytes:
    """Decompress one LZ4 frame with all independent blocks in one launch.

    A preset dictionary is shared by every block as its prefix.  Frames of
    64 KiB blocks decode on ``decode128``; larger blocks on
    ``decompress_v4``.  ``lane_kernel=False`` sends 64 KiB blocks to
    ``decompress_v4`` too.  ``None`` (auto) and ``True`` are the same here:
    ``lz4tpu`` resolves ``None`` to the lane decoder on one device, and this
    function always runs on one device.
    Linked-block frames go to the serial streaming reader.
    """
    from ..frame.decompress import LZ4FrameReader

    dev = resolve_device(device)
    frame = bytes(frame)
    dictionary = bytes(dictionary or b"")[-WINDOW_SIZE:]
    reader = LZ4FrameReader(frame, engine=dev)
    if not reader.flags.independent_blocks:
        return LZ4FrameReader(frame, engine=dev).read_all(dictionary)

    blocks, expected_sum = _scan_frame(reader)
    if verify_checksums and reader.flags.block_checksums:
        for _, payload, checksum in blocks:
            if payload_xxh32(payload, device=dev) != checksum:
                raise BlockChecksumFail("a block checksum was invalid")

    to_decode = [p for c, p, _ in blocks if c]
    outputs = []
    if to_decode:
        use_128 = reader.block_maxsize <= MAX_BLOCK and lane_kernel is not False
        decoder = decode128 if use_128 else decode_v4
        comp, comp_len = pack_rows(to_decode, dev)
        prefix, prefix_len = pack_prefixes(
            [dictionary] * len(to_decode) if dictionary else None, len(to_decode), dev
        )
        out, out_len, status = decoder(comp, comp_len, prefix, prefix_len, reader.block_maxsize)
        out_len = out_len.cpu().numpy()
        status = status.cpu().numpy()
        bad = check_decoded(status, out_len, reader.block_maxsize)
        if bad is not None:
            raise bad[1]
        outputs = fetch_rows(out, out_len, np.ones(len(to_decode), bool))

    parts = []
    k = 0
    for compressed, payload, _ in blocks:
        if compressed:
            parts.append(outputs[k])
            k += 1
        else:
            parts.append(payload)
    result = b"".join(parts)

    if verify_checksums and reader.flags.content_checksum and expected_sum is not None:
        if make_hasher(0, dev).update(result).digest() != expected_sum:
            raise FrameChecksumFail("the frame checksum was invalid")
    return result
