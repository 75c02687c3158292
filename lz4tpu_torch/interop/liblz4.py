"""ctypes bindings for the installed C liblz4 — the bit-exactness oracle.

The port's own copy of ``lz4tpu/interop/liblz4.py`` (ctypes only).  It
mirrors what the reference's interop harness gets from the ``lz4`` CLI
(reference ``tests/output_equivalence.rs:7-18``): raw-block
compression via ``LZ4_compress_default``/``LZ4_compress_fast``, frame
compression via the **streaming** LZ4F API (``compressBegin`` /
``compressUpdate`` / ``compressEnd`` — the one-shot ``LZ4F_compressFrame``
auto-shrinks the block size for small inputs and is NOT what the CLI
emits), and both decompression directions.

All helpers return plain ``bytes`` and raise ``RuntimeError`` on C-side
errors; ``available()`` gates the suite when the library is absent.
"""

from __future__ import annotations

import ctypes
import ctypes.util

_LIB = None
_LOAD_ERR = None


def _load():
    global _LIB, _LOAD_ERR
    if _LIB is not None or _LOAD_ERR is not None:
        return _LIB
    candidates = [
        "liblz4.so.1",
        "liblz4.so",
        ctypes.util.find_library("lz4"),
    ]
    for name in candidates:
        if not name:
            continue
        try:
            _LIB = ctypes.CDLL(name)
            _declare(_LIB)
            return _LIB
        except OSError as e:  # pragma: no cover - depends on image
            _LOAD_ERR = e
    return _LIB


def available() -> bool:
    return _load() is not None


# --------------------------------------------------------------------------
# struct layouts (lz4frame.h, v1.9.4)
# --------------------------------------------------------------------------


class LZ4FFrameInfo(ctypes.Structure):
    _fields_ = [
        ("blockSizeID", ctypes.c_int),  # 0=default, 4..7 = 64K/256K/1M/4M
        ("blockMode", ctypes.c_int),  # 0=linked, 1=independent
        ("contentChecksumFlag", ctypes.c_int),  # 0/1
        ("frameType", ctypes.c_int),  # 0=frame
        ("contentSize", ctypes.c_ulonglong),  # 0 = unknown
        ("dictID", ctypes.c_uint),
        ("blockChecksumFlag", ctypes.c_int),  # 0/1
    ]


class LZ4FPreferences(ctypes.Structure):
    _fields_ = [
        ("frameInfo", LZ4FFrameInfo),
        ("compressionLevel", ctypes.c_int),
        ("autoFlush", ctypes.c_uint),
        ("favorDecSpeed", ctypes.c_uint),
        ("reserved", ctypes.c_uint * 3),
    ]


class LZ4FCompressOptions(ctypes.Structure):
    _fields_ = [("stableSrc", ctypes.c_uint), ("reserved", ctypes.c_uint * 3)]


class LZ4FDecompressOptions(ctypes.Structure):
    _fields_ = [
        ("stableDst", ctypes.c_uint),
        ("skipChecksums", ctypes.c_uint),
        ("reserved1", ctypes.c_uint),
        ("reserved0", ctypes.c_uint),
    ]


_LZ4F_VERSION = 100  # LZ4F_VERSION in lz4frame.h


def _declare(lib):
    sz = ctypes.c_size_t
    p = ctypes.c_char_p
    vp = ctypes.c_void_p

    lib.LZ4_compress_default.restype = ctypes.c_int
    lib.LZ4_compress_default.argtypes = [p, p, ctypes.c_int, ctypes.c_int]
    lib.LZ4_compress_fast.restype = ctypes.c_int
    lib.LZ4_compress_fast.argtypes = [p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.LZ4_compress_HC.restype = ctypes.c_int
    lib.LZ4_compress_HC.argtypes = [p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.LZ4_decompress_safe.restype = ctypes.c_int
    lib.LZ4_decompress_safe.argtypes = [p, p, ctypes.c_int, ctypes.c_int]
    lib.LZ4_decompress_safe_usingDict.restype = ctypes.c_int
    lib.LZ4_decompress_safe_usingDict.argtypes = [
        p, p, ctypes.c_int, ctypes.c_int, p, ctypes.c_int,
    ]
    lib.LZ4_compressBound.restype = ctypes.c_int
    lib.LZ4_compressBound.argtypes = [ctypes.c_int]

    lib.LZ4F_isError.restype = ctypes.c_uint
    lib.LZ4F_isError.argtypes = [sz]
    lib.LZ4F_getErrorName.restype = ctypes.c_char_p
    lib.LZ4F_getErrorName.argtypes = [sz]
    lib.LZ4F_compressBound.restype = sz
    lib.LZ4F_compressBound.argtypes = [sz, ctypes.POINTER(LZ4FPreferences)]

    lib.LZ4F_createCompressionContext.restype = sz
    lib.LZ4F_createCompressionContext.argtypes = [ctypes.POINTER(vp), ctypes.c_uint]
    lib.LZ4F_freeCompressionContext.restype = sz
    lib.LZ4F_freeCompressionContext.argtypes = [vp]
    lib.LZ4F_compressBegin.restype = sz
    lib.LZ4F_compressBegin.argtypes = [vp, p, sz, ctypes.POINTER(LZ4FPreferences)]
    lib.LZ4F_compressBegin_usingCDict.restype = sz
    lib.LZ4F_compressBegin_usingCDict.argtypes = [
        vp, p, sz, vp, ctypes.POINTER(LZ4FPreferences),
    ]
    lib.LZ4F_compressUpdate.restype = sz
    lib.LZ4F_compressUpdate.argtypes = [
        vp, p, sz, p, sz, ctypes.POINTER(LZ4FCompressOptions),
    ]
    lib.LZ4F_compressEnd.restype = sz
    lib.LZ4F_compressEnd.argtypes = [vp, p, sz, ctypes.POINTER(LZ4FCompressOptions)]
    lib.LZ4F_createCDict.restype = vp
    lib.LZ4F_createCDict.argtypes = [p, sz]
    lib.LZ4F_freeCDict.restype = None
    lib.LZ4F_freeCDict.argtypes = [vp]

    lib.LZ4F_createDecompressionContext.restype = sz
    lib.LZ4F_createDecompressionContext.argtypes = [ctypes.POINTER(vp), ctypes.c_uint]
    lib.LZ4F_freeDecompressionContext.restype = sz
    lib.LZ4F_freeDecompressionContext.argtypes = [vp]
    lib.LZ4F_decompress.restype = sz
    lib.LZ4F_decompress.argtypes = [
        vp, p, ctypes.POINTER(sz), p, ctypes.POINTER(sz),
        ctypes.POINTER(LZ4FDecompressOptions),
    ]
    lib.LZ4F_decompress_usingDict.restype = sz
    lib.LZ4F_decompress_usingDict.argtypes = [
        vp, p, ctypes.POINTER(sz), p, ctypes.POINTER(sz), p, sz,
        ctypes.POINTER(LZ4FDecompressOptions),
    ]


def _check(lib, code, what):
    if lib.LZ4F_isError(code):
        raise RuntimeError(f"{what}: {lib.LZ4F_getErrorName(code).decode()}")
    return code


# --------------------------------------------------------------------------
# raw block
# --------------------------------------------------------------------------


def lz4_compress_default(data: bytes) -> bytes:
    lib = _load()
    data = bytes(data)
    cap = lib.LZ4_compressBound(len(data))
    dst = ctypes.create_string_buffer(max(cap, 16))
    n = lib.LZ4_compress_default(data, dst, len(data), cap)
    if n <= 0:
        raise RuntimeError("LZ4_compress_default failed")
    return dst.raw[:n]


def lz4_compress_fast(data: bytes, acceleration: int = 1) -> bytes:
    lib = _load()
    data = bytes(data)
    cap = lib.LZ4_compressBound(len(data))
    dst = ctypes.create_string_buffer(max(cap, 16))
    n = lib.LZ4_compress_fast(data, dst, len(data), cap, acceleration)
    if n <= 0:
        raise RuntimeError("LZ4_compress_fast failed")
    return dst.raw[:n]


def lz4_compress_hc(data: bytes, level: int = 9) -> bytes:
    lib = _load()
    data = bytes(data)
    cap = lib.LZ4_compressBound(len(data))
    dst = ctypes.create_string_buffer(max(cap, 16))
    n = lib.LZ4_compress_HC(data, dst, len(data), cap, level)
    if n <= 0:
        raise RuntimeError("LZ4_compress_HC failed")
    return dst.raw[:n]


def lz4_decompress_safe(data: bytes, out_capacity: int, dictionary: bytes = b"") -> bytes:
    lib = _load()
    data = bytes(data)
    dst = ctypes.create_string_buffer(max(out_capacity, 1))
    if dictionary:
        n = lib.LZ4_decompress_safe_usingDict(
            data, dst, len(data), out_capacity, bytes(dictionary), len(dictionary)
        )
    else:
        n = lib.LZ4_decompress_safe(data, dst, len(data), out_capacity)
    if n < 0:
        raise RuntimeError(f"LZ4_decompress_safe failed: {n}")
    return dst.raw[:n]


# --------------------------------------------------------------------------
# frame (streaming, CLI-equivalent)
# --------------------------------------------------------------------------

_BLOCK_ID = {0: 0, 1 << 16: 4, 1 << 18: 5, 1 << 20: 6, 1 << 22: 7}


def lz4f_compress_frame_streaming(
    data: bytes,
    *,
    block_size: int = 1 << 22,
    independent_blocks: bool = True,
    block_checksums: bool = False,
    content_checksum: bool = True,
    content_size: bool = False,
    dictionary: bytes | None = None,
    dictionary_id: int | None = None,
    level: int = 0,
    chunk: int = 64 << 10,
) -> bytes:
    """Compress one frame exactly like the lz4 CLI: streaming LZ4F with
    explicit preferences (``output_equivalence.rs:58-101`` matrix axes)."""
    lib = _load()
    data = bytes(data)

    prefs = LZ4FPreferences()
    prefs.frameInfo.blockSizeID = _BLOCK_ID[block_size]
    prefs.frameInfo.blockMode = 1 if independent_blocks else 0
    prefs.frameInfo.contentChecksumFlag = 1 if content_checksum else 0
    prefs.frameInfo.blockChecksumFlag = 1 if block_checksums else 0
    prefs.frameInfo.contentSize = len(data) if content_size else 0
    prefs.frameInfo.dictID = dictionary_id or 0
    prefs.compressionLevel = level
    prefs.autoFlush = 0

    ctx = ctypes.c_void_p()
    _check(lib, lib.LZ4F_createCompressionContext(ctypes.byref(ctx), _LZ4F_VERSION),
           "createCompressionContext")
    cdict = None
    try:
        bound = lib.LZ4F_compressBound(max(chunk, block_size), ctypes.byref(prefs))
        buf = ctypes.create_string_buffer(bound + (64 << 10))
        out = bytearray()

        if dictionary is not None:
            cdict = lib.LZ4F_createCDict(bytes(dictionary), len(dictionary))
            if not cdict:
                raise RuntimeError("LZ4F_createCDict failed")
            n = _check(
                lib,
                lib.LZ4F_compressBegin_usingCDict(
                    ctx, buf, len(buf), cdict, ctypes.byref(prefs)
                ),
                "compressBegin_usingCDict",
            )
        else:
            n = _check(
                lib,
                lib.LZ4F_compressBegin(ctx, buf, len(buf), ctypes.byref(prefs)),
                "compressBegin",
            )
        out += buf.raw[:n]

        for off in range(0, len(data), chunk):
            piece = data[off : off + chunk]
            n = _check(
                lib,
                lib.LZ4F_compressUpdate(ctx, buf, len(buf), piece, len(piece), None),
                "compressUpdate",
            )
            out += buf.raw[:n]
        n = _check(lib, lib.LZ4F_compressEnd(ctx, buf, len(buf), None), "compressEnd")
        out += buf.raw[:n]
        return bytes(out)
    finally:
        if cdict:
            lib.LZ4F_freeCDict(cdict)
        lib.LZ4F_freeCompressionContext(ctx)


def lz4f_decompress_frame(frame: bytes, dictionary: bytes | None = None) -> bytes:
    """Decode one LZ4 frame with LZ4F_decompress[_usingDict]."""
    lib = _load()
    frame = bytes(frame)

    ctx = ctypes.c_void_p()
    _check(
        lib,
        lib.LZ4F_createDecompressionContext(ctypes.byref(ctx), _LZ4F_VERSION),
        "createDecompressionContext",
    )
    try:
        out = bytearray()
        dst_cap = 4 << 20
        dst = ctypes.create_string_buffer(dst_cap)
        src_off = 0
        expect = ctypes.c_size_t(1)
        while src_off < len(frame) and expect.value != 0:
            src_sz = ctypes.c_size_t(len(frame) - src_off)
            dst_sz = ctypes.c_size_t(dst_cap)
            piece = frame[src_off:]
            if dictionary is not None:
                code = lib.LZ4F_decompress_usingDict(
                    ctx, dst, ctypes.byref(dst_sz), piece, ctypes.byref(src_sz),
                    bytes(dictionary), len(dictionary), None,
                )
            else:
                code = lib.LZ4F_decompress(
                    ctx, dst, ctypes.byref(dst_sz), piece, ctypes.byref(src_sz), None
                )
            expect = ctypes.c_size_t(_check(lib, code, "LZ4F_decompress"))
            out += dst.raw[: dst_sz.value]
            if src_sz.value == 0 and dst_sz.value == 0:
                raise RuntimeError("LZ4F_decompress made no progress (truncated frame?)")
            src_off += src_sz.value
        return bytes(out)
    finally:
        lib.LZ4F_freeDecompressionContext(ctx)
