"""LZ4 frame decompression — header parsing, block chain, checksum verify.

The port's own copy of the serial reader of ``lz4tpu/frame/decompress.py``
(reference ``src/framed/decompress.rs``): ``LZ4FrameReader`` header parse
and verification, ``decode_block`` with EndMark / stored-block /
block-checksum / carry-over window semantics, and the one-shot
``decompress_frame``.  It is the port's decode path for
linked frames.  The JAX package's threaded native ``read_all`` is not
part of the port, so errors always follow the serial order.

The block engine is ``"cuda"`` (default: ``kernels.decompress
.decompress_block_cuda``), ``"cpu"`` (the same adapter on the plain
version) or a callable with the spec's ``decompress_block`` contract.
"""

from __future__ import annotations

import functools
import io

from ..runtime import resolve_device
from ..spec.block import DecodeError
from ..spec.xxhash32 import xxh32
from ..utils.hashing import make_hasher
from ..utils.hashing import xxh32 as payload_xxh32
from .errors import (
    BlockChecksumFail,
    BlockSizeOverflow,
    CodecError,
    FrameChecksumFail,
    HeaderChecksumFail,
    InputTruncated,
    WrongMagic,
)
from .header import INCOMPRESSIBLE, MAGIC, WINDOW_SIZE, BlockDescriptor, Flags


def _resolve_engine(name):
    """Map an engine name to (``decompress_block`` callable, checksum device)."""
    if callable(name):
        return name, "cpu"
    from ..kernels.decompress import decompress_block_cuda

    dev = resolve_device(name)
    return functools.partial(decompress_block_cuda, device=dev), dev.type


def _read_exact(reader, n: int) -> bytes:
    # read(n) may legally return fewer bytes before EOF, so loop like the
    # reference's read_exact
    parts = []
    got = 0
    while got < n:
        chunk = reader.read(n - got)
        if not chunk:
            raise InputTruncated(f"needed {n} bytes, got {got}")
        parts.append(chunk)
        got += len(chunk)
    return parts[0] if len(parts) == 1 else b"".join(parts)


class LZ4FrameReader:
    """Reads the blocks inside one LZ4 frame, one ``decode_block`` at a time.

    Reading stops at the EndMark, so trailing data (e.g. back-to-back
    frames) is left in the underlying stream.
    """

    def __init__(self, reader, engine="cuda"):
        reader = _as_reader(reader)
        self._decompress_block, self._hash_device = _resolve_engine(engine)

        magic = int.from_bytes(_read_exact(reader, 4), "little")
        if magic != MAGIC:
            raise WrongMagic(f"wrong magic number in file header: {magic:08x}")

        flags_byte = _read_exact(reader, 1)[0]
        self.flags = Flags.parse(flags_byte)
        bd_byte = _read_exact(reader, 1)[0]
        bd = BlockDescriptor.parse(bd_byte)

        hashed = bytearray([flags_byte, bd_byte])

        self.content_size = None
        if self.flags.content_size:
            raw = _read_exact(reader, 8)
            self.content_size = int.from_bytes(raw, "little")
            hashed.extend(raw)

        self.dictionary_id = None
        if self.flags.dictionary_id:
            raw = _read_exact(reader, 4)
            self.dictionary_id = int.from_bytes(raw, "little")
            hashed.extend(raw)

        checksum_desired = _read_exact(reader, 1)[0]
        checksum_actual = (xxh32(hashed) >> 8) & 0xFF
        if checksum_desired != checksum_actual:
            raise HeaderChecksumFail("the header checksum was invalid")

        self.reader = reader
        self.block_maxsize = bd.block_maxsize()
        self._content_hasher = (
            make_hasher(0, self._hash_device) if self.flags.content_checksum else None
        )
        # carry-over window only exists in linked-block mode
        self._carryover_window = None if self.flags.independent_blocks else bytearray()
        self._finished = False

    def block_size(self) -> int:
        return self.block_maxsize

    def frame_size(self):
        return self.content_size

    def decode_block(self, dictionary: bytes = b"") -> bytes | None:
        """Decode the next block; returns ``None`` at the EndMark
        (reference ``decompress.rs:197-279``)."""
        if self._finished:
            return None

        block_length = int.from_bytes(_read_exact(self.reader, 4), "little")
        if block_length == 0:
            if self._content_hasher is not None:
                checksum = int.from_bytes(_read_exact(self.reader, 4), "little")
                if self._content_hasher.digest() != checksum:
                    raise FrameChecksumFail("the frame checksum was invalid")
            self._finished = True
            return None

        is_compressed = (block_length & INCOMPRESSIBLE) == 0
        block_length &= ~INCOMPRESSIBLE & 0xFFFFFFFF

        if block_length > self.block_maxsize:
            raise BlockSizeOverflow("a block is larger than the frame's block maxsize")

        buf = _read_exact(self.reader, block_length)

        if self.flags.block_checksums:
            checksum = int.from_bytes(_read_exact(self.reader, 4), "little")
            if payload_xxh32(buf, device=self._hash_device) != checksum:
                raise BlockChecksumFail("a block checksum was invalid")

        # prefix: carry-over window (seeded with the dictionary on first
        # use) in linked mode, else the dictionary directly
        if self._carryover_window is not None:
            if not self._carryover_window:
                self._carryover_window.extend(dictionary)
            prefix = bytes(self._carryover_window)
        else:
            prefix = bytes(dictionary)

        if is_compressed:
            try:
                output = bytes(
                    self._decompress_block(buf, prefix=prefix, output_limit=self.block_maxsize)
                )
            except DecodeError as e:
                raise CodecError(e.kind) from e
        else:
            output = buf

        # push data back into the window (reference decompress.rs:252-269)
        if self._carryover_window is not None:
            window = self._carryover_window
            outlen = len(output)
            if outlen < WINDOW_SIZE:
                surplus = len(window) + outlen - WINDOW_SIZE
                if surplus > 0:
                    del window[:surplus]
                window.extend(output)
            else:
                window[:] = output[outlen - WINDOW_SIZE :]

        if len(output) > self.block_maxsize:
            raise BlockSizeOverflow("a block decompressed to more data than allowed")

        if self._content_hasher is not None:
            self._content_hasher.update(output)
        return output

    def read_all(self, dictionary: bytes = b"") -> bytes:
        """Decode every block in order and concatenate."""
        parts = []
        while True:
            block = self.decode_block(dictionary)
            if block is None:
                return b"".join(parts)
            parts.append(block)


def decompress_frame(reader, dictionary: bytes = b"", engine="cuda") -> bytes:
    """One-shot frame decode (reference ``decompress.rs:283-288``)."""
    return LZ4FrameReader(reader, engine=engine).read_all(dictionary)


def _as_reader(obj):
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return io.BytesIO(bytes(obj))
    return obj
