"""Batched decoder for blocks of at most 64 KiB: the CUDA kernel (one warp
per block), its plain version, and the bytes-level batch API.

Counterpart of ``lz4tpu/kernels/decode128.py``.  The TPU kernel's lane
layout, lockstep rounds and round cap have no counterpart: a CUDA warp
addresses memory directly and decodes its block to the end, so there is
no ``STATUS_FALLBACK``.

Tensor contract of ``decode128`` (shared with ``decompress_v4.decode_v4``):

* ``comp`` (N, C) uint8 compressed blocks, ``comp_len`` (N,) int32;
* ``prefix`` (Np, P) uint8, right-aligned rows; Np = N, or Np = 1 for one
  row shared by every block; ``prefix_len`` (N,) int32;
* ``limit``: the memory limit checked at each match (block_maxsize);
* returns ``out`` (N, W) uint8 with W >= limit + C (literals may run past
  the limit by up to the compressed length; zero past ``out_len``),
  ``out_len`` and ``status`` (N,) int32 — ``OK`` or an error kind of
  ``kernels/status.py``; the first failing check of a block wins and
  ``out_len`` is then the output written before the failing sequence.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import build
from ..runtime import KernelStats, resolve_device, round_up, stream_handle
from .pack import check_decoded, fetch_rows, pack_prefixes, pack_rows
from .status import (
    ERR_INVALID_OFFSET,
    ERR_MEMORY_LIMIT,
    ERR_UNEXPECTED_END,
    ERR_ZERO_OFFSET,
    OK,
)

KERNEL = KernelStats("decode128")
SOURCE = "lz4tpu_torch/csrc/decode128.cu"
REPLACES = "lz4tpu/kernels/decode128.py:225"

MAX_BLOCK = 1 << 16


def check_decode_args(name, comp, comp_len, prefix, prefix_len, limit, out_capacity):
    if comp.dtype != torch.uint8 or comp.dim() != 2 or not comp.is_contiguous():
        raise ValueError(f"{name}: comp must be a contiguous (N, C) uint8 tensor")
    n_blocks = comp.shape[0]
    for label, t in (("comp_len", comp_len), ("prefix_len", prefix_len)):
        if t.dtype != torch.int32 or t.shape != (n_blocks,) or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous ({n_blocks},) int32 tensor")
    if (
        prefix.dtype != torch.uint8
        or prefix.dim() != 2
        or prefix.shape[0] not in (1, n_blocks)
        or not prefix.is_contiguous()
    ):
        raise ValueError(f"{name}: prefix must be a contiguous (1 or N, P) uint8 tensor")
    for label, t in (("comp_len", comp_len), ("prefix", prefix), ("prefix_len", prefix_len)):
        if t.device != comp.device:
            raise ValueError(f"{name}: {label} is on {t.device}, comp on {comp.device}")
    if limit < 0:
        raise ValueError(f"{name}: negative limit")
    if out_capacity < limit + comp.shape[1]:
        raise ValueError(f"{name}: out_capacity must hold limit + comp width")


def check_staged_capacity(name, out_capacity):
    """The decoders that stage output in shared memory store it in aligned
    16-byte vectors and keep positions in 32 bits."""
    if out_capacity % 16 or out_capacity >= 1 << 31:
        raise ValueError(f"{name}: out_capacity must be a multiple of 16 below 2 GiB")


def decode128(comp, comp_len, prefix, prefix_len, limit: int, out_capacity=None):
    """Decode a batch of blocks of at most 64 KiB; the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if limit > MAX_BLOCK:
        raise ValueError(f"decode128: limit {limit} > {MAX_BLOCK}; use decompress_v4")
    if out_capacity is None:
        out_capacity = round_up(limit + comp.shape[1], 16)
    check_decode_args("decode128", comp, comp_len, prefix, prefix_len, limit, out_capacity)
    if comp.is_cuda:
        return launch_decoder(KERNEL, "lz4t_decode128", comp, comp_len, prefix, prefix_len,
                              limit, out_capacity)
    if comp.device.type == "cpu":
        return decode_plain(comp, comp_len, prefix, prefix_len, limit, out_capacity)
    raise ValueError(f"decode128: unsupported device {comp.device}")


def launch_decoder(stats, fn_name, comp, comp_len, prefix, prefix_len, limit, out_capacity):
    """Allocate outputs and launch one of the CUDA decoders (they share
    one C signature)."""
    lib = build.load()
    n_blocks = comp.shape[0]
    out = torch.zeros((n_blocks, out_capacity), dtype=torch.uint8, device=comp.device)
    out_len = torch.empty(n_blocks, dtype=torch.int32, device=comp.device)
    status = torch.empty(n_blocks, dtype=torch.int32, device=comp.device)
    prefix_stride = 0 if prefix.shape[0] == 1 else prefix.stride(0)
    with torch.cuda.device(comp.device):
        h = stats.begin()
        rc = getattr(lib, fn_name)(
            comp.data_ptr(), comp.stride(0), comp_len.data_ptr(), prefix.data_ptr(),
            prefix_stride, prefix.shape[1], prefix_len.data_ptr(), limit, out.data_ptr(),
            out_capacity, out_len.data_ptr(), status.data_ptr(), n_blocks, stream_handle(),
        )
        stats.end(h)
    build.check(rc, fn_name)
    return out, out_len, status


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _lsic(comp: bytes, pos: int, value: int):
    """LSIC continuation; returns (value, pos) or (None, pos) at the end."""
    n = len(comp)
    while True:
        if pos >= n:
            return None, pos
        more = comp[pos]
        pos += 1
        value += more
        if more != 0xFF:
            return value, pos


def decode_block_plain(comp: bytes, prefix: bytes, limit: int, out_capacity: int):
    """One block, the kernel's steps in Python: each sequence is parsed
    and validated completely before its bytes are written.  Returns
    (output bytes, status)."""
    out = bytearray()
    plen = len(prefix)
    n = len(comp)
    pos = 0
    while pos < n:
        token = comp[pos]
        pos += 1
        lit = token >> 4
        if lit == 0xF:
            lit, pos = _lsic(comp, pos, lit)
            if lit is None:
                return bytes(out), ERR_UNEXPECTED_END
        if pos + lit > n:
            return bytes(out), ERR_UNEXPECTED_END
        lit_src = pos
        pos += lit
        op = len(out)
        if op + lit > out_capacity:
            return bytes(out), ERR_MEMORY_LIMIT
        if n - pos < 2:  # ends after literals; a stray byte re-reads as a token
            out += comp[lit_src:pos]
            continue
        offset = comp[pos] | (comp[pos + 1] << 8)
        pos += 2
        ml = token & 0xF
        if ml == 0xF:
            ml, pos = _lsic(comp, pos, ml)
            if ml is None:
                return bytes(out), ERR_UNEXPECTED_END
        ml += 4
        mop = op + lit
        if mop + ml > limit:
            return bytes(out), ERR_MEMORY_LIMIT
        if offset == 0:
            return bytes(out), ERR_ZERO_OFFSET
        if offset > mop + plen:
            return bytes(out), ERR_INVALID_OFFSET
        out += comp[lit_src : lit_src + lit]
        # byte j of the match is V[mop - offset + (j mod offset)], V = prefix | out
        if offset > mop:
            pattern = prefix[plen - (offset - mop) :] + out[:mop]
        else:
            pattern = out[mop - offset : mop]
        if offset >= ml:
            out += pattern[:ml]
        else:
            out += (pattern * (ml // offset + 1))[:ml]
    return bytes(out), OK


def decode_plain(comp, comp_len, prefix, prefix_len, limit: int, out_capacity: int):
    """Plain version of every decoder on CPU tensors (same contract)."""
    n_blocks, width = comp.shape
    comp_np = comp.numpy()
    pre_np = prefix.numpy()
    pw = prefix.shape[1]
    lens = comp_len.tolist()
    plens = prefix_len.tolist()
    out = torch.zeros((n_blocks, out_capacity), dtype=torch.uint8)
    out_np = out.numpy()
    out_len = torch.zeros(n_blocks, dtype=torch.int32)
    status = torch.zeros(n_blocks, dtype=torch.int32)
    for i in range(n_blocks):
        row = pre_np[0 if pre_np.shape[0] == 1 else i]
        pfx = row[pw - plens[i] :].tobytes() if plens[i] else b""
        data, st = decode_block_plain(comp_np[i, : lens[i]].tobytes(), pfx, limit, out_capacity)
        out_np[i, : len(data)] = np.frombuffer(data, np.uint8)
        out_len[i] = len(data)
        status[i] = st
    return out, out_len, status


# ---------------------------------------------------------------------------
# bytes-level API
# ---------------------------------------------------------------------------


def decompress_batch(decoder, blocks, block_maxsize: int, prefixes, device):
    """The bytes-level batch API of every decoder: pack, one launch of
    ``decoder`` (``decode128``, ``decode_v4``, ``decode_big`` or
    ``decode_v3``) on ``device``, ``DecodeError`` for the first failing block, else the
    decoded blocks as a list of byte strings."""
    dev = resolve_device(device)
    blocks = [bytes(b) for b in blocks]
    if not blocks:
        return []
    comp, comp_len = pack_rows(blocks, dev)
    prefix, prefix_len = pack_prefixes(prefixes, len(blocks), dev)
    out, out_len, status = decoder(comp, comp_len, prefix, prefix_len, block_maxsize)
    out_len = out_len.cpu().numpy()
    bad = check_decoded(status.cpu().numpy(), out_len)
    if bad is not None:
        raise bad[1]
    return fetch_rows(out, out_len, np.ones(len(blocks), bool))


def decompress_blocks_128(blocks, block_maxsize: int = 1 << 14, prefixes=None, device=None):
    """Decode independent raw blocks of at most 64 KiB in one launch.
    Raises ``DecodeError`` for the first failing block.  ``prefixes``
    (optional, per block): dictionary / carry-over window bytes that match
    offsets may reach back into (only the trailing 64 KiB is
    addressable)."""
    return decompress_batch(decode128, blocks, block_maxsize, prefixes, device)
