"""Interop oracle bindings against the system C lz4 (liblz4.so).

The reference's most important property is byte parity with the C
implementation (reference ``README.md:4,14``, exercised by
``tests/output_equivalence.rs:58-101`` through the lz4 CLI).  These ctypes
bindings reproduce the CLI's behaviour through the library's APIs, so that
the port's frames can be held against C directly; ``available()`` says
whether the library is installed.
"""

from .liblz4 import (  # noqa: F401
    available,
    lz4_compress_default,
    lz4_compress_fast,
    lz4_compress_hc,
    lz4_decompress_safe,
    lz4f_compress_frame_streaming,
    lz4f_decompress_frame,
)
