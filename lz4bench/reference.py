"""The reference: what the configuration's settings make of an object.

``stored`` is the frame the lz4 CLI writes, the C library's frame API at
the configuration's settings; reads decode these.  ``frame`` is the frame a
write has to return, byte for byte: the CLI's header (``header``), every
block through the C library's greedy parse on its U32 table from a fresh
stream (``liblz4.compress_u32``), stored raw where that is not shorter,
the end mark, and the C library's XXH32 of the content.  The two agree
wherever every block is at least 65,547 B, as every 4 MiB block of the
corpus is.  Below that size the frame API takes its U16 table, and the
program, like the reference crate it follows, does not: the crate's
documented exception at 64 KiB blocks, which ``lz4f-64k-indep`` states as
its guarantee.  A read's answer is the object itself.  The walk of a
frame's blocks is plain Python over the frame format (magic, flags, block
descriptor, header checksum, block sizes with the stored flag, optional
block checksums, end mark, content checksum).  Nothing here imports the
program under test.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from . import liblz4

MAGIC = 0x184D2204


def stored(data: bytes, config: dict) -> bytes:
    """The lz4 CLI's frame of ``data`` at the configuration's settings."""
    return liblz4.compress_frame(
        data,
        block_size=config["block_size"],
        independent=config["independent_blocks"],
        content_checksum=config["content_checksum"],
        block_checksums=config["block_checksums"],
        content_size=config["content_size"],
        level=config["level"],
    )


def header(config: dict) -> bytes:
    """The frame header at the configuration's settings (no content size):
    the C library's frame of no content, less its end mark and checksum."""
    if config["content_size"]:
        raise NotImplementedError("the header of a frame without a content size")
    empty = stored(b"", config)
    return empty[: len(empty) - 4 - 4 * config["content_checksum"]]


def frame(data: bytes, config: dict) -> bytes:
    """The frame a write of ``data`` has to return."""
    if not config["independent_blocks"] or config["block_checksums"]:
        raise NotImplementedError("the reference writes independent blocks without checksums")
    level = config["level"]
    acceleration = 1 - level if level < 0 else 1
    bs = config["block_size"]
    parts = [header(config)]
    for at in range(0, len(data), bs):
        block = data[at : at + bs]
        packed = liblz4.compress_u32(block, acceleration)
        if packed is None:
            parts += [(len(block) | 1 << 31).to_bytes(4, "little"), block]
        else:
            parts += [len(packed).to_bytes(4, "little"), packed]
    parts.append(bytes(4))
    if config["content_checksum"]:
        parts.append(liblz4.xxh32(data).to_bytes(4, "little"))
    return b"".join(parts)


def _each(fn, objects, config, workers=4):
    # the C library releases the interpreter's lock: objects side by side
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(lambda d: fn(d, config), objects))


def stored_frames(objects: list[bytes], config: dict) -> list[bytes]:
    return _each(stored, objects, config)


def frames(objects: list[bytes], config: dict) -> list[bytes]:
    return _each(frame, objects, config)


def blocks(data: bytes) -> list[tuple[int, int, bool]]:
    """``(offset, length, stored)`` of every data block of one frame."""
    if int.from_bytes(data[:4], "little") != MAGIC:
        raise ValueError("not an LZ4 frame")
    flg = data[4]
    pos = 6 + (8 if flg & 0x08 else 0) + (4 if flg & 0x01 else 0) + 1
    out = []
    while True:
        word = int.from_bytes(data[pos : pos + 4], "little")
        pos += 4
        if word == 0:
            end = pos + (4 if flg & 0x04 else 0)
            if end != len(data):
                raise ValueError("bytes after the end mark")
            return out
        ln = word & 0x7FFFFFFF
        out.append((pos, ln, bool(word >> 31)))
        pos += ln + (4 if flg & 0x10 else 0)


def corrupt(data: bytes, rng) -> bytes:
    """The frame with one byte changed where its block still decodes to the
    same length, with other content: a byte of a stored block, or a literal
    of the first sequence of a compressed one (an independent block starts
    with at least one literal; later matches may copy it).  Only the
    content checksum can tell."""
    offset, length, stored = blocks(data)[int(rng.integers(len(blocks(data))))]
    if stored:
        at = offset + int(rng.integers(length))
    else:
        lits, at = data[offset] >> 4, offset + 1
        if lits == 15:
            while data[at] == 255:
                lits += 255
                at += 1
            lits += data[at]
            at += 1
        at += int(rng.integers(lits))
    out = bytearray(data)
    out[at] ^= 0x5A
    return bytes(out)
