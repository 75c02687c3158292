"""LZ4 frame decompression — header parsing, block chain, checksum verify.

The port's own copy of the reader of ``lz4tpu/frame/decompress.py``
(reference ``src/framed/decompress.rs``): ``LZ4FrameReader`` header parse
and verification, ``decode_block`` with EndMark / stored-block /
block-checksum / carry-over window semantics, the ``io.RawIOBase``
adapter ``LZ4FrameIoReader`` (``into_read``), and the one-shot
``decompress_frame``.

The block engine is ``"cuda"`` (default: ``kernels.decompress
.decompress_block_cuda``), ``"cpu"`` (the same adapter on the plain
versions), ``"native"`` (the host's C++ decoder, ``lz4tpu_torch.native``),
a ``torch.device``, or a callable with the spec's ``decompress_block``
contract.  ``read_all`` of a fresh reader of an independent-block frame
reads the whole block chain, then decodes every compressed block at once:
on a device engine in one launch a group of blocks (decode128 for 64 KiB
blocks, decode_v4 for larger ones), on ``"native"`` on a pool of threads
(``host_threads``: ``$LZ4TPU_HOST_THREADS``, or one a CPU, at most 8),
each block straight into its slot.  The groups, and the native slots,
hold at most ``kernels.pack.DECODE_BUDGET`` bytes, so the memory of a
frame of many small blocks grows with its content, not with its blocks
times ``block_maxsize``.  Either way it raises the errors of the
per-block loop in the same order: the first failing block in frame order,
and within a block size, truncation, block checksum, decode.  Linked
frames, partly read readers, callable engines and ``"native"`` with one
thread take the per-block loop.
"""

from __future__ import annotations

import contextlib
import functools
import io
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import native
from ..kernels.pack import budget_groups
from ..parallel.blocks import content_pieces, decode_payloads, join_content
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
from .format import read_block, read_checksum, read_exact, scan_frame
from .header import MAGIC, WINDOW_SIZE, BlockDescriptor, Flags


def _resolve_engine(name):
    """Map an engine to (``decompress_block`` callable, device, checksum
    backend): the device is ``None`` for ``"native"`` and a callable
    engine, which ``read_all`` cannot launch."""
    if callable(name):
        return name, None, "native"
    if name == "native":
        return native.decompress_block, None, "native"
    from ..kernels.decompress import decompress_block_cuda

    dev = resolve_device(name)
    return functools.partial(decompress_block_cuda, device=dev), dev, dev.type


def host_threads() -> int:
    """Threads of the native engine's ``read_all``: ``$LZ4TPU_HOST_THREADS``,
    or for 0 or unset one a CPU, at most 8."""
    return native.host_threads(int(os.environ.get("LZ4TPU_HOST_THREADS", "0")))


#: output slots up to this size come from a warm buffer of the calling thread
POOLED_BYTES = 256 << 20
_warm = threading.local()


def _output_slots(n: int) -> np.ndarray:
    """``n`` bytes for the native ``read_all``'s block slots: this thread's
    buffer, whose pages were faulted in once, when it was allocated, on
    this thread.  Fresh pages would fault inside the parallel decode, where
    page faults serialize on the process's memory map."""
    if n > POOLED_BYTES:
        return np.empty(n, np.uint8)
    buf = getattr(_warm, "buf", None)
    if buf is None or buf.size < n:
        buf = np.empty(min(max(n, 1 << 20, 0 if buf is None else 2 * buf.size), POOLED_BYTES),
                       np.uint8)
        buf.fill(0)
        _warm.buf = buf
    return buf[:n]


def _decode_native(blocks, block_maxsize: int, dictionary: bytes, nthreads: int) -> bytes:
    """The frame's content from its scanned independent ``blocks``, each
    decoded by the native engine on one of ``nthreads`` threads straight
    into its slot of ``block_maxsize`` bytes, in groups of blocks whose
    slots fit ``DECODE_BUDGET``; raises the first failing block's error in
    frame order, as ``parallel.blocks.decode_payloads`` does (the decoder's
    ``DecodeError``, or ``BlockSizeOverflow`` for a block that decoded past
    ``block_maxsize``)."""
    bs = block_maxsize
    groups = budget_groups(len(blocks), bs)
    if not groups:
        return b""
    slots = _output_slots(max(hi - lo for lo, hi in groups) * bs)
    prefix = dictionary[-WINDOW_SIZE:]

    def job(i, lo):
        compressed, payload, _ = blocks[i]
        slot = slots[(i - lo) * bs : (i - lo + 1) * bs]
        if not compressed:
            slot[: len(payload)] = np.frombuffer(payload, np.uint8)
            return len(payload)
        try:
            return native.decompress_block_into(payload, slot, prefix, output_limit=bs)
        except DecodeError as e:
            if e.kind != DecodeError.KIND_MEMORY_LIMIT:
                raise
        # past its slot: the serial reader's outcome is the decoder's error,
        # if the stream has one further on, else the size overflow
        native.decompress_block(payload, prefix, output_limit=bs)
        raise BlockSizeOverflow("a block decompressed to more data than allowed")

    view = memoryview(slots)
    # a lone block would gain nothing from a pool but its threads' start-up
    threads = min(nthreads, len(blocks))
    with ThreadPoolExecutor(threads) if threads > 1 else contextlib.nullcontext() as pool:
        parts = []
        for lo, hi in groups:  # each group's bytes leave the slots before the next's come
            if pool is None:
                lens = [job(i, lo) for i in range(lo, hi)]
            else:
                lens = [f.result() for f in [pool.submit(job, i, lo) for i in range(lo, hi)]]
            parts.append(b"".join(view[k * bs : k * bs + n] for k, n in enumerate(lens)))
    return parts[0] if len(parts) == 1 else b"".join(parts)


class LZ4FrameReader:
    """Reads the blocks inside one LZ4 frame, one ``decode_block`` at a time.

    Reading stops at the EndMark, so trailing data (e.g. back-to-back
    frames) is left in the underlying stream.
    """

    def __init__(self, reader, engine="cuda"):
        reader = _as_reader(reader)
        self._decompress_block, self._device, self._hash_device = _resolve_engine(engine)
        self._engine = engine

        magic = int.from_bytes(read_exact(reader, 4), "little")
        if magic != MAGIC:
            raise WrongMagic(f"wrong magic number in file header: {magic:08x}")

        flags_byte = read_exact(reader, 1)[0]
        self.flags = Flags.parse(flags_byte)
        bd_byte = read_exact(reader, 1)[0]
        bd = BlockDescriptor.parse(bd_byte)

        hashed = bytearray([flags_byte, bd_byte])

        self.content_size = None
        if self.flags.content_size:
            raw = read_exact(reader, 8)
            self.content_size = int.from_bytes(raw, "little")
            hashed.extend(raw)

        self.dictionary_id = None
        if self.flags.dictionary_id:
            raw = read_exact(reader, 4)
            self.dictionary_id = int.from_bytes(raw, "little")
            hashed.extend(raw)

        checksum_desired = read_exact(reader, 1)[0]
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
        self._blocks_read = 0

    def block_size(self) -> int:
        return self.block_maxsize

    def frame_size(self):
        return self.content_size

    def decode_block(self, dictionary: bytes = b"") -> bytes | None:
        """Decode the next block; returns ``None`` at the EndMark
        (reference ``decompress.rs:197-279``)."""
        if self._finished:
            return None

        self._blocks_read += 1
        block = read_block(self.reader, self.flags, self.block_maxsize)
        if block is None:
            checksum = read_checksum(self.reader, self.flags.content_checksum)
            if checksum is not None and self._content_hasher.digest() != checksum:
                raise FrameChecksumFail("the frame checksum was invalid")
            self._finished = True
            return None

        is_compressed, buf, checksum = block
        if checksum is not None and payload_xxh32(buf, device=self._hash_device) != checksum:
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
        """Decode every block in order and concatenate: for a fresh reader
        of an independent frame in one launch a group of blocks on a device
        engine, on a pool of threads on ``"native"``; else block by
        block."""
        if self._carryover_window is None and not self._blocks_read and not self._finished:
            if self._device is not None:
                return self._read_all_batched(dictionary, lambda blocks: join_content(
                    content_pieces(blocks, decode_payloads(
                        [p for c, p, _ in blocks if c], self.block_maxsize,
                        bytes(dictionary)[-WINDOW_SIZE:], (self._device,))),
                    False, self._device)[0])
            if self._engine == "native" and host_threads() > 1:
                return self._read_all_batched(dictionary, lambda blocks: _decode_native(
                    blocks, self.block_maxsize, bytes(dictionary), host_threads()))
        parts = []
        while True:
            block = self.decode_block(dictionary)
            if block is None:
                return b"".join(parts)
            parts.append(block)

    def _read_all_batched(self, dictionary: bytes, decode) -> bytes:
        """``read_all`` as one decode of all blocks (``decode(blocks)``: the
        content of the scanned blocks, or the first failing block's error),
        raising what the per-block loop would raise first: the chain is
        scanned until its end or its first size or truncation error, the
        blocks before that are checked until the first bad block checksum,
        the blocks before that are decoded, and the first error in frame
        order wins."""
        self._finished = True
        blocks = []
        try:
            _, expected = scan_frame(self, blocks=blocks)
            stop = None
        except (BlockSizeOverflow, InputTruncated) as e:
            stop = e
        self._blocks_read = len(blocks)
        good = len(blocks)
        if self.flags.block_checksums:
            good = next((k for k, (_, payload, checksum) in enumerate(blocks)
                         if payload_xxh32(payload, device=self._hash_device) != checksum), good)
        try:
            output = decode(blocks[:good])
        except DecodeError as e:
            raise CodecError(e.kind) from e
        if good < len(blocks):
            raise BlockChecksumFail("a block checksum was invalid")
        if stop is not None:
            raise stop
        if self._content_hasher is not None:
            if self._content_hasher.update(output).digest() != expected:
                raise FrameChecksumFail("the frame checksum was invalid")
        return output

    def into_read(self, dictionary: bytes = b""):
        """An ``io.RawIOBase`` adapter over the block stream
        (``LZ4FrameIoReader``, reference ``decompress.rs:46-77``)."""
        return LZ4FrameIoReader(self, dictionary)


class LZ4FrameIoReader(io.RawIOBase):
    """File-like reader over an ``LZ4FrameReader`` block chain: ``read(n)``
    returns at most ``n`` bytes of the current block, decoding the next
    one when it is used up; ``read(-1)`` returns the rest of the frame."""

    def __init__(self, frame_reader: LZ4FrameReader, dictionary: bytes = b""):
        self._frame_reader = frame_reader
        self._dictionary = dictionary
        self._buffer = b""
        self._taken = 0
        self._eof = False

    def readable(self) -> bool:
        return True

    def _fill(self) -> bytes:
        while not self._eof and self._taken == len(self._buffer):
            block = self._frame_reader.decode_block(self._dictionary)
            if block is None:
                self._eof = True
                break
            self._buffer = block
            self._taken = 0
        return self._buffer[self._taken :]

    def read(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            parts = [self._fill()]
            self._taken = len(self._buffer)
            parts.append(self._frame_reader.read_all(self._dictionary) if not self._eof else b"")
            self._eof = True
            return b"".join(parts)
        avail = self._fill()
        take = min(len(avail), size)
        self._taken += take
        return avail[:take]


def decompress_frame(reader, dictionary: bytes = b"", engine="cuda") -> bytes:
    """One-shot frame decode (reference ``decompress.rs:283-288``)."""
    return LZ4FrameReader(reader, engine=engine).read_all(dictionary)


def _as_reader(obj):
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return io.BytesIO(bytes(obj))
    return obj
