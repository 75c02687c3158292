"""The native engine: the host's LZ4 block codec, HC parse and xxHash32.

The port's own copy of ``lz4tpu.native``, with its signatures and
contracts, bound with ctypes to ``src/lz4_native.cpp`` (built by the host
C++ compiler at first use, see ``build.py``):

* ``compress_block(data, cursor, table, out, acceleration, cap)``: the
  greedy parse on the port's ``spec.table`` tables, byte-equal to the
  compressor's plain version; raises ``spec.block.Incompressible`` over the
  cap, the table mutated exactly as far as the parse went;
* ``compress_block_hc(data, cursor, out, level, cap)``: byte-equal to
  ``spec.hc.compress_block_hc``;
* ``decompress_block(data, prefix, out, output_limit)`` and
  ``decompress_block_into``: raise ``spec.block.DecodeError`` with the
  reference decoder's kinds;
* ``xxh32(data, seed)``, the streaming ``XXHash32`` and ``compress_bound``.

Every call releases the interpreter lock for its native work (ctypes does),
so the frame layer runs independent blocks on a thread pool.  This is the
engine ``"native"`` of ``CompressionSettings`` and ``LZ4FrameReader``, and
the HC parse of ``level()`` on every engine but ``"cpu"``.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..spec.block import BlockTooBig, DecodeError, Incompressible
from ..spec.table import U16Table, U32Table

_P = ctypes.c_void_p
_U64 = ctypes.c_uint64
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32

_SIGNATURES = {
    "lz4t_xxh32": (_U32, [_P, _U64, _U32]),
    "lz4t_xxh32_state_size": (ctypes.c_int, []),
    "lz4t_xxh32_init": (None, [_P, _U32]),
    "lz4t_xxh32_update": (None, [_P, _P, _U64]),
    "lz4t_xxh32_digest": (_U32, [_P, _U32]),
    # in, n, cursor, table slots, table offset, cap (-1: none), acceleration,
    # out, out capacity
    "lz4t_compress_block_u32": (_I64, [_P, _U64, _U64, _P, _U64, _I64, _U64, _P, _U64]),
    "lz4t_compress_block_u16": (_I64, [_P, _U64, _U64, _P, _U64, _I64, _U64, _P, _U64]),
    # in, n, cursor, level, cap (-1: none), out, out capacity
    "lz4t_compress_block_hc": (_I64, [_P, _U64, _U64, _U64, _I64, _P, _U64]),
    # in, n, prefix, prefix len, out, out capacity, output limit
    "lz4t_decompress_block": (_I64, [_P, _U64, _P, _U64, _P, _U64, _U64]),
}

# the decoder's negative return codes
_DECODE_ERRORS = {
    -1: DecodeError.KIND_UNEXPECTED_END,
    -2: DecodeError.KIND_MEMORY_LIMIT,
    -3: DecodeError.KIND_ZERO_OFFSET,
    -4: DecodeError.KIND_INVALID_OFFSET,
}
_ERR_CAPACITY = -5  # the output buffer is full

_lock = threading.Lock()
_lib = None


def load():
    """The native library (built on first call), every signature set."""
    global _lib
    with _lock:
        if _lib is None:
            from .build import build

            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
    return _lib


def _pointer(data):
    """(ctypes-passable pointer, length, keep-alive) of bytes-like data,
    without a copy."""
    if isinstance(data, bytes):
        return data, len(data), data
    arr = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    return arr.ctypes.data, arr.size, arr


def xxh32(data, seed: int = 0) -> int:
    ptr, n, _keep = _pointer(data)
    return int(load().lz4t_xxh32(ptr, n, seed))


class XXHash32:
    """Streaming xxHash32 over the native state machine."""

    def __init__(self, seed: int = 0):
        lib = load()
        self._seed = seed
        self._state = ctypes.create_string_buffer(lib.lz4t_xxh32_state_size())
        lib.lz4t_xxh32_init(self._state, seed)

    def update(self, data) -> "XXHash32":
        ptr, n, _keep = _pointer(data)
        load().lz4t_xxh32_update(self._state, ptr, n)
        return self

    def digest(self) -> int:
        return int(load().lz4t_xxh32_digest(self._state, self._seed))


def host_threads(n: int = 0) -> int:
    """Threads for a frame's independent blocks on this engine: ``n``, or
    for 0 one a CPU, at most 8 (``lz4tpu``'s rule)."""
    return n or min(os.cpu_count() or 1, 8)


def compress_bound(n: int) -> int:
    """Worst-case raw block size: all literals and their length bytes."""
    return n + n // 255 + 16


class _BufferPool:
    """Reusable scratch buffers, one per thread: a fresh 4 MiB buffer a
    block costs more in page faults than the codec itself, and the frame
    layer runs native calls on several threads at once."""

    def __init__(self):
        self._local = threading.local()

    def get(self, capacity: int) -> np.ndarray:
        buf = getattr(self._local, "buf", None)
        if buf is None or buf.size < capacity:
            buf = np.empty(max(capacity, 1 << 20, 0 if buf is None else buf.size * 2),
                           dtype=np.uint8)
            self._local.buf = buf
        return buf


_compress_pool = _BufferPool()
_decompress_pool = _BufferPool()


def _result(buf, n: int, out):
    result = buf[:n].tobytes()
    if out is not None:
        out.extend(result)
        return out
    return result


def compress_block(data, cursor: int = 0, table=None, out=None, acceleration: int = 1,
                   cap: int | None = None) -> bytes:
    """The greedy parse of ``data[cursor:]`` behind ``data[:cursor]``;
    ``table`` (a ``U32Table`` or ``U16Table``) is updated in place."""
    data = bytes(data)
    if table is None:
        table = U16Table() if len(data) <= 0xFFFF else U32Table()
    if len(data) > table.payload_size_limit:
        raise BlockTooBig(
            f"input of {len(data)} bytes exceeds table limit {table.payload_size_limit}"
        )
    capacity = compress_bound(len(data)) if cap is None else min(cap, compress_bound(len(data)))
    buf = _compress_pool.get(max(capacity, 1))
    slots = np.ascontiguousarray(table.dict)
    lib = load()
    fn = lib.lz4t_compress_block_u32 if slots.dtype == np.uint32 else lib.lz4t_compress_block_u16
    rc = fn(data, len(data), cursor, slots.ctypes.data, table.offset,
            -1 if cap is None else cap, max(int(acceleration), 1), buf.ctypes.data, capacity)
    if slots is not table.dict:
        table.dict[:] = slots
    if rc < 0:
        raise Incompressible()
    return _result(buf, rc, out)


def compress_block_hc(data, cursor: int = 0, out=None, level: int = 9,
                      cap: int | None = None) -> bytes:
    """The high-compression parse of ``data[cursor:]`` behind
    ``data[:cursor]``; the same contract and output as
    ``spec.hc.compress_block_hc``."""
    data = bytes(data)
    capacity = compress_bound(len(data)) if cap is None else min(cap, compress_bound(len(data)))
    buf = _compress_pool.get(max(capacity, 1))
    rc = load().lz4t_compress_block_hc(data, len(data), cursor, max(int(level), 2),
                                       -1 if cap is None else cap, buf.ctypes.data, capacity)
    if rc < 0:
        raise Incompressible()
    return _result(buf, rc, out)


def _raise_decode(rc: int):
    raise DecodeError(_DECODE_ERRORS.get(rc, DecodeError.KIND_UNEXPECTED_END))


def decompress_block_into(data, out_np, prefix=b"", output_limit=None) -> int:
    """Decode into caller memory (``out_np``: a C-contiguous uint8 numpy
    array) and return the decoded length.  A stream whose output would not
    fit ``out_np`` raises the ``memory_limit_exceeded`` kind."""
    data, prefix = bytes(data), bytes(prefix)
    if out_np.dtype != np.uint8 or not out_np.flags.c_contiguous:
        raise ValueError("out_np must be a C-contiguous uint8 array")
    rc = load().lz4t_decompress_block(data, len(data), prefix, len(prefix), out_np.ctypes.data,
                                      out_np.size,
                                      (1 << 62) if output_limit is None else output_limit)
    if rc == _ERR_CAPACITY:
        raise DecodeError(DecodeError.KIND_MEMORY_LIMIT)
    if rc < 0:
        _raise_decode(rc)
    return int(rc)


def decompress_block(data, prefix=b"", out=None, output_limit: int | None = None) -> bytes:
    """Decode one raw block behind ``prefix``; matches that would pass
    ``output_limit`` raise ``memory_limit_exceeded``, as the reference's
    decoder does (literals are not limited)."""
    data, prefix = bytes(data), bytes(prefix)
    if output_limit is not None:
        # matches are limit-checked; trailing literals add at most len(data)
        capacity, retries = output_limit + len(data), 0
    else:
        # the format's practical expansion first, grown for a pathological stream
        capacity, retries = 256 * len(data) + 64, 3
    soft_limit = (1 << 62) if output_limit is None else output_limit
    lib = load()
    while True:
        buf = _decompress_pool.get(max(capacity, 1))
        rc = lib.lz4t_decompress_block(data, len(data), prefix, len(prefix), buf.ctypes.data,
                                       capacity, soft_limit)
        if rc != _ERR_CAPACITY:
            break
        if retries == 0:
            raise DecodeError(DecodeError.KIND_MEMORY_LIMIT)
        retries -= 1
        capacity *= 16
    if rc < 0:
        _raise_decode(rc)
    return _result(buf, rc, out)
