"""LZ4 frame compression — the streaming host-side frame writer.

The port's own copy of ``lz4tpu/frame/compress.py`` (reference
``src/framed/compress.rs``): the ``CompressionSettings`` builder, frame
header emission with the xxh32 header checksum, dictionary priming, the
incompressible fallback capping output at input size, independent-vs-linked
table/window maintenance, and the EndMark + content checksum trailer.

The block engine is one of three, or a callable with the spec's
``compress_block`` contract:

* ``"cuda"`` (the default) or a ``torch.device``: an independent-block
  frame is written in batches, the stream read ``BATCH_BYTES`` at a time
  (whole blocks), every block of a batch through one launch of the greedy
  compressor (``parallel.blocks.scalar_dispatch``), the next batch
  compressing while one is written, so ``compress(reader, writer)`` streams
  an input of any size;
* ``"cpu"``: the same batches on the kernels' plain versions;
* ``"native"``: the host's C++ block codec (``lz4tpu_torch.native``), no
  card and no ``nvcc`` needed; an independent-block frame's blocks run on
  a pool of ``threads(n)`` threads (the codec releases the interpreter
  lock), each from its own copy of the template table.

Every way writes the frame the per-block loop writes, byte for byte.
Linked frames, whose encoder table chains from block to block, and
callable engines take the per-block loop.

``level(v)`` adds the high-compression parse, on the host: the native
engine's on every engine but ``"cpu"``, whose is the plain ``spec.hc``.
Each block's greedy payload caps the HC parse, and the smaller payload
wins.
"""

from __future__ import annotations

import functools
import io
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from .. import native
from ..parallel.blocks import pipelined, scalar_collect, scalar_dispatch
from ..runtime import host_u8, resolve_device
from ..spec.block import Incompressible
from ..spec.hc import compress_block_hc as spec_compress_block_hc
from ..spec.table import U32Table, prime_u32_table
from ..utils.hashing import make_hasher
from ..utils.hashing import xxh32 as payload_xxh32
from .errors import InvalidBlockSize
from .format import block_word, frame_header
from .header import WINDOW_SIZE, BlockDescriptor, Flags


#: input bytes a batch of an independent-block frame holds at most (whole
#: blocks): one launch for any Silesia member, bounded memory for any stream
BATCH_BYTES = 256 << 20


def _resolve_engine(name):
    """Map an engine to (``compress_block`` callable, device, checksum
    backend): the device is ``None`` for ``"native"`` and a callable, which
    the batches cannot take."""
    if callable(name):
        return name, None, "native"
    if name == "native":
        return native.compress_block, None, "native"
    from ..kernels.compress import compress_block_cuda

    dev = resolve_device(name)
    return functools.partial(compress_block_cuda, device=dev), dev, dev.type


class CompressionSettings:
    """Builder-style frame compression configuration
    (mirrors ``CompressionSettings``, reference ``compress.rs:36-134``).

    Defaults match the reference: independent blocks on, block checksums
    off, content checksum on, 4 MiB blocks, no dictionary.
    """

    def __init__(self):
        self._independent_blocks = True
        self._block_checksums = False
        self._content_checksum = True
        self._block_size = 4 * 1024 * 1024
        self._dictionary = None
        self._dictionary_id = None
        self._acceleration = 1
        self._level = None
        self._engine = "cuda"
        self._threads = 0

    # -- builder setters (reference naming) ---------------------------------

    def independent_blocks(self, v: bool) -> "CompressionSettings":
        """Independent blocks (default) never reference previous blocks;
        linked blocks may reach back 64 KiB for better ratio but lose
        seekability."""
        self._independent_blocks = v
        return self

    def block_checksums(self, v: bool) -> "CompressionSettings":
        self._block_checksums = v
        return self

    def content_checksum(self, v: bool) -> "CompressionSettings":
        self._content_checksum = v
        return self

    def block_size(self, v: int) -> "CompressionSettings":
        """Only 4 MiB, 1 MiB, 256 KiB and 64 KiB are valid."""
        self._block_size = v
        return self

    def dictionary(self, dict_id: int, dict_bytes) -> "CompressionSettings":
        """Preset dictionary + application-specific id.  Only the trailing
        64 KiB can ever be referenced."""
        self._dictionary_id = dict_id
        self._dictionary = bytes(dict_bytes)
        return self

    def dictionary_id_nonsense_override(self, dict_id) -> "CompressionSettings":
        """Set/clear the dictionary id independently of the dictionary."""
        self._dictionary_id = dict_id
        return self

    def acceleration(self, v: int) -> "CompressionSettings":
        """Match-search skip acceleration; 1 is the C default.  Higher values
        trade ratio for speed exactly like ``LZ4_compress_fast``."""
        self._acceleration = max(int(v), 1)
        return self

    def level(self, v: int | None) -> "CompressionSettings":
        """High-compression level.  ``None``/``1`` = the reference's greedy
        parse; ``>= 2`` = hash-chain + lazy parse on the host (the native
        engine's; ``spec/hc.py`` on the ``"cpu"`` engine) with search depth
        ``2**(level-1)``.  Every block is compressed with both parses and the
        smaller payload wins, so levelled output is never larger than the
        greedy output."""
        self._level = None if v is None or int(v) <= 1 else int(v)
        return self

    def engine(self, name) -> "CompressionSettings":
        """Block-codec backend: ``"cuda"``, ``"cpu"``, ``"native"``, a
        ``torch.device`` or a callable."""
        self._engine = name
        return self

    def threads(self, n: int) -> "CompressionSettings":
        """Worker threads for independent-block frames on the ``"native"``
        engine (0, the default: one a CPU, at most 8; 1: the serial loop).
        Each block starts from the same template table, so the frame is
        byte-identical to the serial writer's.  Linked frames ignore it
        (the table chains from block to block), and so do the device
        engines, whose batch is one launch."""
        self._threads = max(int(n), 0)
        return self

    # -- compression entry points -------------------------------------------

    def compress(self, reader, writer) -> None:
        """Compress without a content-size header field."""
        self._compress_internal(_as_reader(reader), writer, None)

    def compress_with_size_unchecked(self, reader, writer, content_size: int) -> None:
        self._compress_internal(_as_reader(reader), writer, content_size)

    def compress_with_size(self, reader, writer) -> None:
        """Learn the content size by seeking to the end first."""
        reader = _as_reader(reader)
        start = reader.tell()
        end = reader.seek(0, io.SEEK_END)
        reader.seek(start)
        self._compress_internal(reader, writer, end - start)

    def compress_bytes(self, data, with_size: bool = True) -> bytes:
        """Convenience one-shot: bytes in, frame bytes out."""
        out = io.BytesIO()
        if with_size:
            self.compress_with_size_unchecked(io.BytesIO(bytes(data)), out, len(data))
        else:
            self.compress(io.BytesIO(bytes(data)), out)
        return out.getvalue()

    # -- the frame writer itself (reference compress.rs:159-282) ------------

    def _compress_internal(self, reader, writer, content_size) -> None:
        compress_block, dev, hash_device = _resolve_engine(self._engine)
        hc = None
        if self._level is not None:
            cpu = dev is not None and dev.type == "cpu"
            hc = spec_compress_block_hc if cpu else native.compress_block_hc

        flags = Flags(
            independent_blocks=self._independent_blocks,
            block_checksums=self._block_checksums,
            content_checksum=self._content_checksum,
            content_size=content_size is not None,
            dictionary_id=self._dictionary_id is not None,
        )
        content_hasher = make_hasher(0, hash_device) if self._content_checksum else None

        bd = BlockDescriptor.for_block_maxsize(self._block_size)
        if bd is None:
            raise InvalidBlockSize(f"{self._block_size} is not a valid LZ4 block size")

        writer.write(frame_header(flags, bd, content_size, self._dictionary_id))

        if flags.independent_blocks and dev is not None:
            self._write_batches(reader, writer, flags, content_hasher, dev, hc)
        elif (flags.independent_blocks and self._engine == "native"
              and native.host_threads(self._threads) > 1):
            self._write_threaded(reader, writer, flags, content_hasher, compress_block, hc,
                                 native.host_threads(self._threads))
        else:
            self._write_blocks(reader, writer, flags, content_hasher, compress_block, hc,
                               hash_device)

        writer.write((0).to_bytes(4, "little"))
        if content_hasher is not None:
            writer.write(content_hasher.digest().to_bytes(4, "little"))

    def _write_batches(self, reader, writer, flags, content_hasher, dev, hc) -> None:
        """Independent blocks, ``BATCH_BYTES`` of input at a time: one
        greedy-compressor launch over every block of a batch, each block
        behind the dictionary with the primed template table, output capped
        at the block's size (reference ``compress.rs:202-263``).  Batch
        ``k + 1`` is read and launched before batch ``k`` is written, and the
        blocks are written in order."""
        bs = self._block_size
        initializer = self._dictionary or b""

        def batches():
            while True:
                batch = _read_up_to(reader, max(BATCH_BYTES // bs, 1) * bs)
                if not batch:
                    return
                if content_hasher is not None:
                    content_hasher.update(batch)
                yield 0, 0, batch

        def dispatch(batch):
            return scalar_dispatch(host_u8(batch), bs, self._dictionary, self._acceleration,
                                   dev)

        def write(batch, launched):
            lens, handle = launched
            mv = memoryview(batch)
            for i, greedy in enumerate(scalar_collect(handle, lens)):
                raw = mv[i * bs : i * bs + int(lens[i])]
                data = initializer + raw if initializer else raw
                self._write_block(writer, data, len(initializer), greedy, hc, flags, dev.type)

        # two batches at most in flight: one written while the next compresses
        pipelined(batches(), dispatch, write, depth=2)

    def _template(self):
        """Dictionary priming: the template table and the block initializer."""
        table = U32Table()
        if self._dictionary is None:
            return table, b""
        prime_u32_table(table, self._dictionary)
        return table, self._dictionary

    def _write_threaded(self, reader, writer, flags, content_hasher, compress_block, hc,
                        nthreads) -> None:
        """Independent blocks on the native engine, on ``nthreads`` threads:
        each block is parsed (greedy, then HC with a level) from its own copy
        of the template table behind the initializer, as the per-block loop
        parses it; the stream's reading, the content checksum and the
        blocks' emission stay on this thread, in frame order, at most
        ``2 * nthreads`` blocks ahead (the stream is read one block ahead)."""
        template_table, initializer = self._template()
        cursor = len(initializer)

        def job(data, read_bytes):
            try:
                greedy = bytes(compress_block(data, cursor=cursor, table=template_table.copy(),
                                              acceleration=self._acceleration, cap=read_bytes))
            except Incompressible:
                greedy = None
            return self._payload(data, cursor, greedy, hc)

        pending = deque()
        chunk = _read_up_to(reader, self._block_size)
        with ThreadPoolExecutor(nthreads) as pool:
            while chunk:
                following = _read_up_to(reader, self._block_size)
                if content_hasher is not None:
                    content_hasher.update(chunk)
                data = initializer + chunk if initializer else chunk
                if not following and not pending:
                    # a frame of one block: parsed here, without a thread's start-up
                    self._emit(writer, data, cursor, job(data, len(chunk)), flags, "native")
                    return
                pending.append((pool.submit(job, data, len(chunk)), data))
                while pending and (not following or len(pending) > 2 * nthreads):
                    future, data = pending.popleft()
                    self._emit(writer, data, cursor, future.result(), flags, "native")
                chunk = following

    def _write_blocks(self, reader, writer, flags, content_hasher, compress_block, hc,
                      hash_device) -> None:
        """The per-block loop (reference ``compress.rs:202-275``): linked
        frames, whose table and window carry over, callable engines, and
        the native engine on one thread."""
        template_table, block_initializer = self._template()

        in_buffer = bytearray(block_initializer)
        table = template_table.copy()
        while True:
            window_offset = len(in_buffer)
            in_buffer.extend(_read_up_to(reader, self._block_size))
            read_bytes = len(in_buffer) - window_offset
            if read_bytes == 0:
                break

            if content_hasher is not None:
                content_hasher.update(in_buffer[window_offset:])

            data = bytes(in_buffer)
            # the greedy parse always runs (also with a level) so the table
            # evolves identically across linked blocks; on cap-abort it has
            # still applied all mutations up to the abort point, like the
            # reference's NoPartialWrites
            compressed = None
            try:
                compressed = bytes(
                    compress_block(
                        data,
                        cursor=window_offset,
                        table=table,
                        acceleration=self._acceleration,
                        cap=read_bytes,
                    )
                )
            except Incompressible:
                pass
            self._write_block(writer, data, window_offset, compressed, hc, flags, hash_device)

            if flags.independent_blocks:
                in_buffer = bytearray(block_initializer)
                table = template_table.copy()
            elif len(in_buffer) > WINDOW_SIZE:
                forget = len(in_buffer) - WINDOW_SIZE
                table.slide(forget)
                del in_buffer[:forget]

    def _write_block(self, writer, data, cursor, greedy, hc, flags, hash_device) -> None:
        """Emit the block ``data[cursor:]`` (``data[:cursor]`` is its
        prefix) from its greedy payload (``None``: over the cap)."""
        self._emit(writer, data, cursor, self._payload(data, cursor, greedy, hc), flags,
                   hash_device)

    def _payload(self, data, cursor, greedy, hc):
        """The block's payload: the HC parse ``hc`` (``None`` without a
        level), capped at the greedy payload, competes with it; ``None``
        when neither parse shrank the block."""
        if hc is None:
            return greedy
        cap = len(greedy) if greedy is not None else len(data) - cursor
        try:
            levelled = bytes(hc(data, cursor=cursor, level=self._level, cap=cap))
        except Incompressible:
            return greedy
        return levelled if greedy is None or len(levelled) < len(greedy) else greedy

    def _emit(self, writer, data, cursor, compressed, flags, hash_device) -> None:
        """Write one block: its payload, or ``data[cursor:]`` stored raw."""
        payload = compressed if compressed is not None else bytes(data[cursor:])
        writer.write(block_word(len(payload), compressed is None))
        writer.write(payload)
        if flags.block_checksums:
            writer.write(payload_xxh32(payload, device=hash_device).to_bytes(4, "little"))


def _read_up_to(reader, n: int) -> bytes:
    """``Read::take(n).read_to_end`` semantics: keep reading until n bytes
    or EOF."""
    chunks = []
    remaining = n
    while remaining:
        chunk = reader.read(remaining)
        if not chunk:
            break
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def _as_reader(obj):
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return io.BytesIO(bytes(obj))
    return obj
