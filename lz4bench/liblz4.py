"""The C library liblz4 (1.9.x) through ctypes: the benchmark's oracle.

The configurations promise frames of the C library's greedy parse at
the lz4 CLI's settings, so the C library is what a written frame is held
to (its block parse, its frame header and its XXH32), and its frame API
makes the frames that reads decode.  This binding is the benchmark's own;
it shares no code with the program under test.  ``LZ4F_compressUpdate`` is
given the whole object at once: the frame API cuts it into blocks itself,
exactly as the CLI's streaming writes do.
"""

from __future__ import annotations

import ctypes

_VERSION = 100  # LZ4F_VERSION
_BLOCK_ID = {1 << 16: 4, 1 << 18: 5, 1 << 20: 6, 1 << 22: 7}


class _FrameInfo(ctypes.Structure):
    _fields_ = [
        ("blockSizeID", ctypes.c_int),
        ("blockMode", ctypes.c_int),  # 0 linked, 1 independent
        ("contentChecksumFlag", ctypes.c_int),
        ("frameType", ctypes.c_int),
        ("contentSize", ctypes.c_ulonglong),
        ("dictID", ctypes.c_uint),
        ("blockChecksumFlag", ctypes.c_int),
    ]


class _Preferences(ctypes.Structure):
    _fields_ = [
        ("frameInfo", _FrameInfo),
        ("compressionLevel", ctypes.c_int),
        ("autoFlush", ctypes.c_uint),
        ("favorDecSpeed", ctypes.c_uint),
        ("reserved", ctypes.c_uint * 3),
    ]


_lib = None


def load():
    """The library, loaded and declared once; raises ``OSError`` without it."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL("liblz4.so.1")
        sz, p, vp = ctypes.c_size_t, ctypes.c_char_p, ctypes.c_void_p
        pp = ctypes.POINTER(_Preferences)
        lib.LZ4F_isError.restype = ctypes.c_uint
        lib.LZ4F_isError.argtypes = [sz]
        lib.LZ4F_getErrorName.restype = ctypes.c_char_p
        lib.LZ4F_getErrorName.argtypes = [sz]
        lib.LZ4F_compressBound.restype = sz
        lib.LZ4F_compressBound.argtypes = [sz, pp]
        lib.LZ4F_createCompressionContext.restype = sz
        lib.LZ4F_createCompressionContext.argtypes = [ctypes.POINTER(vp), ctypes.c_uint]
        lib.LZ4F_freeCompressionContext.restype = sz
        lib.LZ4F_freeCompressionContext.argtypes = [vp]
        lib.LZ4F_compressBegin.restype = sz
        lib.LZ4F_compressBegin.argtypes = [vp, p, sz, pp]
        lib.LZ4F_compressUpdate.restype = sz
        lib.LZ4F_compressUpdate.argtypes = [vp, p, sz, p, sz, vp]
        lib.LZ4F_compressEnd.restype = sz
        lib.LZ4F_compressEnd.argtypes = [vp, p, sz, vp]
        lib.LZ4_initStream.restype = vp
        lib.LZ4_initStream.argtypes = [vp, sz]
        lib.LZ4_compress_fast_continue.restype = ctypes.c_int
        lib.LZ4_compress_fast_continue.argtypes = [vp, p, vp, ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_int]
        _lib = lib
    return _lib


def _check(code: int, what: str) -> int:
    if _lib.LZ4F_isError(code):
        raise RuntimeError(f"{what}: {_lib.LZ4F_getErrorName(code).decode()}")
    return code


_STREAM_BYTES = 16416  # sizeof(LZ4_stream_t), LZ4_STREAM_MINSIZE in lz4.h 1.9.x


def compress_u32(block: bytes, acceleration: int) -> bytes | None:
    """One block through the C library's greedy parse on its U32 table,
    from a fresh stream (``LZ4_compress_fast_continue``, which takes the
    U32 table at every input size), or ``None`` where the result would not
    be shorter than the block."""
    lib = load()
    state = ctypes.create_string_buffer(_STREAM_BYTES)
    if not lib.LZ4_initStream(state, _STREAM_BYTES):
        raise RuntimeError("LZ4_initStream failed")
    dst = ctypes.create_string_buffer(max(len(block) - 1, 1))
    n = lib.LZ4_compress_fast_continue(state, block, dst, len(block), len(block) - 1,
                                       acceleration)
    return ctypes.string_at(dst, n) if n > 0 else None


def compress_frame(data: bytes, *, block_size: int, independent: bool,
                   content_checksum: bool, block_checksums: bool,
                   content_size: bool, level: int) -> bytes:
    """One LZ4 frame of ``data`` as the lz4 CLI writes it at these settings."""
    lib = load()
    prefs = _Preferences()
    prefs.frameInfo.blockSizeID = _BLOCK_ID[block_size]
    prefs.frameInfo.blockMode = 1 if independent else 0
    prefs.frameInfo.contentChecksumFlag = int(content_checksum)
    prefs.frameInfo.blockChecksumFlag = int(block_checksums)
    prefs.frameInfo.contentSize = len(data) if content_size else 0
    prefs.compressionLevel = level
    ctx = ctypes.c_void_p()
    _check(lib.LZ4F_createCompressionContext(ctypes.byref(ctx), _VERSION), "context")
    try:
        cap = lib.LZ4F_compressBound(len(data), ctypes.byref(prefs)) + 64
        dst = ctypes.create_string_buffer(cap)
        at = ctypes.addressof(dst)
        n = _check(lib.LZ4F_compressBegin(ctx, dst, cap, ctypes.byref(prefs)), "begin")
        n += _check(lib.LZ4F_compressUpdate(
            ctx, ctypes.cast(at + n, ctypes.c_char_p), cap - n, data, len(data), None),
            "update")
        n += _check(lib.LZ4F_compressEnd(
            ctx, ctypes.cast(at + n, ctypes.c_char_p), cap - n, None), "end")
        return ctypes.string_at(dst, n)
    finally:
        lib.LZ4F_freeCompressionContext(ctx)


def xxh32(data: bytes) -> int:
    """The C library's XXH32 of ``data`` (seed 0), the content checksum of
    an LZ4 frame.  The library exports no XXH32 of its own, so this reads
    it from the end of the library's frame of ``data`` at its fastest
    acceleration, where the parse costs little beside the hash."""
    frame = compress_frame(data, block_size=1 << 22, independent=True, content_checksum=True,
                           block_checksums=False, content_size=False, level=-(1 << 16))
    return int.from_bytes(frame[-4:], "little")
