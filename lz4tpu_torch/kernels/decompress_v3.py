"""Per-block decoder with the newest output and a read-ahead of the
compressed stream staged in shared memory: the CUDA kernel (one warp per
block, any block size), its plain version, and the bytes-level batch API.

Counterpart of ``lz4tpu/kernels/decompress_v3.py``.  What v3 computes in
its own way carries over: literals and near matches (the source is within
the newest 3 KiB of output) never touch device memory, output leaves in
aligned stores, and only far matches pay a read of the
``[prefix | output]`` buffers.  The TPU version's register accumulator,
its lane/sublane rolls and its one-memory-action-per-iteration switch were
means to that end on the TPU and have no counterpart.  As in ``lz4tpu``
nothing routes here by default: the decoder is reached through
``decompress_blocks_v3`` and measured beside ``decode128`` and
``decode_v4``.  It never returns ``STATUS_FALLBACK``.

Tensor contract: the same as ``decode128.decode128``, with
``out_capacity`` a multiple of 16.
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

KERNEL = KernelStats("decode_v3")
SOURCE = "lz4tpu_torch/csrc/decode_v3.cu"
REPLACES = "lz4tpu/kernels/decompress_v3.py:135"


def decode_v3(comp, comp_len, prefix, prefix_len, limit: int, out_capacity=None):
    """Decode a batch of blocks of any size; the CUDA kernel for CUDA
    tensors, the plain version (``decode128.decode_plain``) for CPU
    tensors."""
    if out_capacity is None:
        out_capacity = round_up(limit + comp.shape[1], 16)
    check_decode_args("decode_v3", comp, comp_len, prefix, prefix_len, limit, out_capacity)
    check_staged_capacity("decode_v3", out_capacity)
    if comp.is_cuda:
        return launch_decoder(KERNEL, "lz4t_decode_v3", comp, comp_len, prefix, prefix_len,
                              limit, out_capacity)
    if comp.device.type == "cpu":
        return decode_plain(comp, comp_len, prefix, prefix_len, limit, out_capacity)
    raise ValueError(f"decode_v3: unsupported device {comp.device}")


def decompress_blocks_v3(blocks, prefixes=None, block_maxsize: int = 1 << 16, device=None):
    """Batch decode in one launch; the same contract as
    ``decompress_blocks_v4``."""
    return decompress_batch(decode_v3, blocks, block_maxsize, prefixes, device)
