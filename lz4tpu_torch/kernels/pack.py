"""The decoders' batch bookkeeping: a batched decode is cut into groups of
whole blocks, in order, each under ``DECODE_BUDGET`` (``budget_groups``),
so that its memory grows with what a frame holds, not with its blocks
times ``block_maxsize``; ``check_decoded`` finds a launch's first failing
block.  The transfers are ``lz4tpu_torch/hostpack.py``'s: ``pack_rows``
and ``pack_prefixes`` are calls into it.
"""

from __future__ import annotations

import numpy as np

from .. import hostpack
from .status import OK

#: bytes of output and compressed rows that one decode launch may hold on
#: one device (one mesh entry); a call with more is cut into groups of
#: whole blocks, one launch each, at least one block a group
DECODE_BUDGET = 1 << 30


def budget_groups(n: int, row_bytes: int):
    """``n`` rows of ``row_bytes`` each, cut into contiguous ``(lo, hi)``
    ranges of as many rows as ``DECODE_BUDGET`` holds, at least one."""
    per = max(DECODE_BUDGET // max(row_bytes, 1), 1)
    return [(lo, min(lo + per, n)) for lo in range(0, n, per)]


def pack_rows(items, device, align_right: bool = False):
    """Byte strings -> ((N, W) uint8 tensor on ``device``, (N,) int32
    lengths), ``W`` the longest item rounded up to 16 bytes: one
    ``hostpack.upload``."""
    (rows, lens), = hostpack.upload(device, hostpack.Rows(items, align_right))
    return rows, lens


def pack_prefixes(prefixes, n_blocks: int, device):
    """Per-block prefixes -> ((Np, P) right-aligned rows, (N,) lengths), as
    ``hostpack.upload_batch`` packs them: ``None`` gives an empty (1, 0)
    row; one prefix shared by every block (a dictionary) gives a single row
    that the kernels read with stride 0."""
    if prefixes is not None and len(prefixes) != n_blocks:
        raise ValueError(f"{len(prefixes)} prefixes for {n_blocks} blocks")
    return hostpack.upload_batch(device, [b""] * n_blocks, prefixes)[2:]


def check_decoded(status: np.ndarray, out_len: np.ndarray, block_maxsize=None):
    """Index of the first failing block and its error, or None.  A
    decode error kind wins over a block that decoded past
    ``block_maxsize`` only when it comes first in block order."""
    from ..frame.errors import BlockSizeOverflow
    from ..spec.block import DecodeError
    from .status import STATUS_TO_KIND

    for i in range(len(status)):
        if status[i] != OK:
            return i, DecodeError(STATUS_TO_KIND[int(status[i])])
        if block_maxsize is not None and out_len[i] > block_maxsize:
            return i, BlockSizeOverflow("a block decompressed to more data than allowed")
    return None
