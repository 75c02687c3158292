"""Host-side entry points of the raw-block decoders (counterpart of
``lz4tpu/kernels/decompress.py``):

* ``decompress_blocks(blocks, prefixes, block_maxsize)`` — batched decode
  with the JAX package's routing: ``block_maxsize`` over 64 KiB goes to
  ``decode_big`` (what ``lz4tpu/parallel/pipeline.py:1151-1196`` does on
  the TPU), a call with at least 24 blocks of at most 64 KiB to
  ``decode128``, everything else to the per-block ``decompress_v4``
  decoder;
* ``decompress_block_cuda`` — the single-block adapter of the streaming
  frame API.

Semantics: reference ``src/raw/decompress.rs:59-138``.
"""

from __future__ import annotations

from ..runtime import round_up
from ..spec.block import DecodeError
from .decode128 import MAX_BLOCK

# below this many blocks a call goes to the per-block decoder
# (lz4tpu/kernels/decompress.py:64)
MIN_LANE_BATCH = 24


def decompress_blocks(blocks, prefixes=None, block_maxsize: int = 1 << 16, device=None):
    """Decode a batch of raw LZ4 blocks; returns a list of byte strings.
    ``prefixes[i]`` is block *i*'s dictionary / carry-over window (only the
    trailing 64 KiB is addressable).  Raises ``DecodeError`` for the first
    failed block."""
    from .decode128 import decompress_blocks_128
    from .decodebig import decompress_blocks_big
    from .decompress_v4 import decompress_blocks_v4

    if block_maxsize > MAX_BLOCK:
        return decompress_blocks_big(blocks, block_maxsize, prefixes, device=device)
    if len(blocks) >= MIN_LANE_BATCH:
        return decompress_blocks_128(blocks, block_maxsize, prefixes, device=device)
    return decompress_blocks_v4(blocks, prefixes, block_maxsize, device=device)


def decompress_block_cuda(data, prefix=b"", out=None, output_limit=None, device=None):
    """Single-block engine adapter.  ``output_limit=None`` means
    "unbounded": decode with a 4 MiB limit and retry with doubled limit on
    ``memory_limit_exceeded`` up to the format's expansion bound (at most
    255 output bytes per input byte), as the JAX package's adapter does."""
    data = bytes(data)
    if output_limit is not None:
        result = decompress_blocks([data], [bytes(prefix)], output_limit, device=device)[0]
    else:
        hard_bound = 255 * max(len(data), 1) + 64
        limit = 1 << 22
        while True:
            try:
                result = decompress_blocks([data], [bytes(prefix)], limit, device=device)[0]
                break
            except DecodeError as e:
                if e.kind != DecodeError.KIND_MEMORY_LIMIT or limit >= hard_bound:
                    raise
                limit = min(limit * 2, round_up(hard_bound, 4))
    if out is not None:
        out.extend(result)
        return out
    return result
