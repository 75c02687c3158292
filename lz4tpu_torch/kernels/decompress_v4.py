"""Per-block decoder for blocks of any size: the CUDA kernel (one thread
block per LZ4 block), its plain version, and the bytes-level batch API.

Counterpart of ``lz4tpu/kernels/decompress_v4.py``: the decoder for
batches too small for the lane path and for ``lane_kernel=False``.  Blocks
over 64 KiB go to ``decodebig.decode_big`` by default; this kernel takes
them too when it is asked to.  The TPU version's ``V4_MAX_COMP``/``V4_MAX_OUT``
limits were SMEM/VMEM workarounds and have no counterpart: comp and output
live in device memory.  Tensor contract: the same as ``decode128``.
"""

from __future__ import annotations

from ..runtime import KernelStats, round_up
from .decode128 import check_decode_args, decode_plain, decompress_batch, launch_decoder

KERNEL = KernelStats("decode_v4")
SOURCE = "lz4tpu_torch/csrc/decode_v4.cu"
REPLACES = "lz4tpu/kernels/decompress_v4.py:89"


def decode_v4(comp, comp_len, prefix, prefix_len, limit: int, out_capacity=None):
    """Decode a batch of blocks of any size; the CUDA kernel for CUDA
    tensors, the plain version (``decode128.decode_plain``, the same
    function) for CPU tensors."""
    if out_capacity is None:
        out_capacity = round_up(limit + comp.shape[1], 16)
    check_decode_args("decode_v4", comp, comp_len, prefix, prefix_len, limit, out_capacity)
    if comp.is_cuda:
        return launch_decoder(KERNEL, "lz4t_decode_v4", comp, comp_len, prefix, prefix_len,
                              limit, out_capacity)
    if comp.device.type == "cpu":
        return decode_plain(comp, comp_len, prefix, prefix_len, limit, out_capacity)
    raise ValueError(f"decode_v4: unsupported device {comp.device}")


def decompress_blocks_v4(blocks, prefixes=None, block_maxsize: int = 1 << 16, device=None):
    """Batch decode in one launch; raises ``DecodeError`` for the first
    failing block.  Any comp or output size that fits in device memory."""
    return decompress_batch(decode_v4, blocks, block_maxsize, prefixes, device)
