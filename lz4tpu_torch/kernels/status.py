"""Per-block status codes shared by the CUDA kernels and their plain versions.

Kernels cannot raise, so the typed ``DecodeError`` kinds of the reference
(``raw/decompress.rs:8-17``) travel off the card as a per-block int32
status that the host validates.
"""

from ..spec.block import DecodeError

OK = 0
ERR_UNEXPECTED_END = 1
ERR_MEMORY_LIMIT = 2
ERR_ZERO_OFFSET = 3
ERR_INVALID_OFFSET = 4

# lane needs a re-decode on the per-block decoder (not an error kind).  The
# CUDA decoders have no round cap and never return it; kept so the status
# space matches the JAX package's.
STATUS_FALLBACK = 100

# compressor statuses
STATUS_OK = 0
STATUS_INCOMPRESSIBLE = 1

STATUS_TO_KIND = {
    ERR_UNEXPECTED_END: DecodeError.KIND_UNEXPECTED_END,
    ERR_MEMORY_LIMIT: DecodeError.KIND_MEMORY_LIMIT,
    ERR_ZERO_OFFSET: DecodeError.KIND_ZERO_OFFSET,
    ERR_INVALID_OFFSET: DecodeError.KIND_INVALID_OFFSET,
}
