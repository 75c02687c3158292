"""Host-side batch packing for the decoders (the port's counterpart of
``lz4tpu/hostpack.py`` and of the wrappers' packing code).

A batch goes to the card as one padded uint8 tensor (one H2D copy), the
kernel runs once, the per-block lengths and statuses come back first, and
then only the bytes that were asked for: rows are compacted on the card
into one flat tensor and copied back in one D2H copy.  A batched decode is
cut into groups of whole blocks, in order, each under ``DECODE_BUDGET``
(``budget_groups``), so that its memory grows with what a frame holds, not
with its blocks times ``block_maxsize``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime import round_up
from ..spec.block import WINDOW_SIZE
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
    lengths).  ``W`` is the longest item rounded up to 16 bytes."""
    lens = np.array([len(b) for b in items], dtype=np.int32)
    width = round_up(int(lens.max(initial=0)), 16)
    arr = np.zeros((len(items), width), np.uint8)
    for i, b in enumerate(items):
        if len(b):
            if align_right:
                arr[i, width - len(b) :] = np.frombuffer(b, np.uint8)
            else:
                arr[i, : len(b)] = np.frombuffer(b, np.uint8)
    return torch.from_numpy(arr).to(device), torch.from_numpy(lens).to(device)


def pack_prefixes(prefixes, n_blocks: int, device):
    """Per-block prefixes -> ((Np, P) right-aligned rows, (N,) lengths).

    Only a prefix's trailing 64 KiB is addressable.  ``None`` gives an
    empty (1, 0) row; one prefix shared by every block (a dictionary)
    gives a single row that the kernels read with stride 0."""
    if prefixes is None:
        return (
            torch.zeros((1, 0), dtype=torch.uint8, device=device),
            torch.zeros(n_blocks, dtype=torch.int32, device=device),
        )
    prefixes = [bytes(p)[-WINDOW_SIZE:] for p in prefixes]
    if len(prefixes) != n_blocks:
        raise ValueError(f"{len(prefixes)} prefixes for {n_blocks} blocks")
    first = prefixes[0]
    if all(p == first for p in prefixes):
        rows, _ = pack_rows([first], device, align_right=True)
        return rows, torch.full((n_blocks,), len(first), dtype=torch.int32, device=device)
    return pack_rows(prefixes, device, align_right=True)


def fetch_rows(out: torch.Tensor, out_len: np.ndarray, keep: np.ndarray):
    """Rows ``out[i, :out_len[i]]`` for ``keep[i]`` -> list of bytes (None
    where not kept), compacted on the device and copied back at once."""
    lens = np.where(keep, out_len, 0).astype(np.int64)
    if out.is_cuda:
        flat = compact_rows(out, lens).cpu().numpy()
    else:
        flat = np.concatenate([out[i, : lens[i]].numpy() for i in range(len(lens))] or
                              [np.zeros(0, np.uint8)])
    ends = np.cumsum(lens)
    res = []
    for i in range(len(lens)):
        res.append(flat[ends[i] - lens[i] : ends[i]].tobytes() if keep[i] else None)
    return res


def compact_rows(out: torch.Tensor, lens) -> torch.Tensor:
    """``out[i, :lens[i]]`` for every row, concatenated into one flat
    tensor on ``out``'s device."""
    parts = [out[i, : int(n)] for i, n in enumerate(lens) if n]
    return torch.cat(parts) if parts else out.new_zeros(0)


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
