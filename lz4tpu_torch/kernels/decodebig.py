"""Decoder for big blocks (256 KiB-4 MiB; any size in fact): the CUDA kernel
(one thread block per LZ4 block, both streams staged through shared
memory), its plain version, and the bytes-level batch API.

Counterpart of ``lz4tpu/kernels/decodebig.py``.  What carries over is the
contract: output limit = ``block_maxsize``; a per-block prefix of at most
64 KiB, right-aligned, that offsets may reach into; per block the bytes,
the length and a status with the error kinds and precedence of
``kernels/status.py``.  What does not: the transposed ``(rows, 128)``
layout, the window repack of the compressed streams, the 128-block launch
cap, ``round_bound``, the mid mirror and the no-progress backstop were all
ways to run 128 lanes in lockstep through bounded VMEM bands.  A CUDA
thread block decodes its own LZ4 block to the end at its own pace, so there
is no band a lane can stall on and ``STATUS_FALLBACK`` is never returned.

Tensor contract: the same as ``decode128.decode128``, with
``out_capacity`` a multiple of 16 (the kernel flushes its shared-memory
ring with aligned 16-byte stores).
"""

from __future__ import annotations

from ..runtime import KernelStats, round_up
from .decode128 import (
    check_decode_args,
    check_staged_capacity,
    decode_plain,
    decompress_batch,
    launch_decoder,
)

KERNEL = KernelStats("decode_big")
SOURCE = "lz4tpu_torch/csrc/decode_big.cu"
REPLACES = "lz4tpu/kernels/decodebig.py:136"


def decode_big(comp, comp_len, prefix, prefix_len, limit: int, out_capacity=None):
    """Decode a batch of blocks of any size, built for big ones; the CUDA
    kernel for CUDA tensors, the plain version (``decode128.decode_plain``)
    for CPU tensors."""
    if out_capacity is None:
        out_capacity = round_up(limit + comp.shape[1], 16)
    check_decode_args("decode_big", comp, comp_len, prefix, prefix_len, limit, out_capacity)
    check_staged_capacity("decode_big", out_capacity)
    if comp.is_cuda:
        return launch_decoder(KERNEL, "lz4t_decode_big", comp, comp_len, prefix, prefix_len,
                              limit, out_capacity)
    if comp.device.type == "cpu":
        return decode_plain(comp, comp_len, prefix, prefix_len, limit, out_capacity)
    raise ValueError(f"decode_big: unsupported device {comp.device}")


def decompress_blocks_big(blocks, block_maxsize: int, prefixes=None, device=None):
    """Decode raw blocks of up to ``block_maxsize`` (any frame size code,
    the 4 MiB default included) in one launch, any number of them.
    ``prefixes`` (optional, per block): dictionary / carry-over window
    bytes the block's offsets may reach back into (the trailing 64 KiB).
    Raises ``DecodeError`` for the first failing block."""
    return decompress_batch(decode_big, blocks, block_maxsize, prefixes, device)
