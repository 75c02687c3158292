"""Decoder for big blocks (256 KiB-4 MiB; any size in fact): the CUDA kernel
(one thread block per LZ4 block, both streams staged through shared
memory), its plain version, the bytes-level batch API, and a model of the
kernel's steps (``decode_big_batched_plain``) that the tests hold equal to
the plain version.

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

from dataclasses import dataclass

import numpy as np
import torch

from ..runtime import KernelStats, round_up
from .decode128 import (
    check_decode_args,
    check_staged_capacity,
    decode_plain,
    decompress_batch,
    launch_decoder,
    plain_into,
)
from .status import (
    ERR_INVALID_OFFSET,
    ERR_MEMORY_LIMIT,
    ERR_UNEXPECTED_END,
    ERR_ZERO_OFFSET,
    OK,
)

KERNEL = KernelStats("decode_big")
SOURCE = "lz4tpu_torch/csrc/decode_big.cu"
REPLACES = "lz4tpu/kernels/decodebig.py:136"


def decode_big(comp, comp_len, prefix, prefix_len, limit: int, out_capacity=None, into=None):
    """Decode a batch of blocks of any size, built for big ones; the CUDA
    kernel for CUDA tensors, the plain version (``decode128.decode_plain``)
    for CPU tensors."""
    if out_capacity is None:
        out_capacity = round_up(limit + comp.shape[1], 16)
    check_decode_args("decode_big", comp, comp_len, prefix, prefix_len, limit, out_capacity)
    check_staged_capacity("decode_big", out_capacity)
    if comp.is_cuda:
        return launch_decoder(KERNEL, "lz4t_decode_big", comp, comp_len, prefix, prefix_len,
                              limit, out_capacity, into=into)
    if comp.device.type == "cpu":
        return plain_into(decode_plain(comp, comp_len, prefix, prefix_len, limit,
                                       out_capacity), into)
    raise ValueError(f"decode_big: unsupported device {comp.device}")


def decompress_blocks_big(blocks, block_maxsize: int, prefixes=None, device=None):
    """Decode raw blocks of up to ``block_maxsize`` (any frame size code,
    the 4 MiB default included), any number of them, one launch a group
    of blocks under ``DECODE_BUDGET``.
    ``prefixes`` (optional, per block): dictionary / carry-over window
    bytes the block's offsets may reach back into (the trailing 64 KiB).
    Raises ``DecodeError`` for the first failing block."""
    return decompress_batch(decode_big, blocks, block_maxsize, prefixes, device)


# ---------------------------------------------------------------------------
# a model of the kernel's steps, for the tests (``decode_plain`` is the
# specification)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Geometry:
    """The kernel's constants (``csrc/decode_big.cu``); a test may shrink
    them so that small inputs reach the window's end, the batch limits and
    the long-sequence path.  ``DECODE128`` holds ``csrc/decode128.cu``'s,
    which runs the same walk."""

    batch: int = 32  # sequences a batch, one a lane
    batch_bytes: int = 1 << 13  # a batch ends once it holds this much output
    small: int = 1 << 13  # longer sequences are a batch of their own
    piece: int = 1 << 14  # and move in such pieces
    window: int = (1 << 16) - 32  # compressed bytes staged at once
    refill_margin: int = 3 << 13  # window left for the batch being parsed
    stage_long: bool = True  # a long sequence's literals pass through the window piece by piece
    read_ahead: bool = False  # a refill starts at the next batch (the other of two windows)


#: csrc/decode128.cu: an 8 KiB window, batches and long sequences at an
#: eighth of it, a refill margin of five sixteenths; a long sequence's
#: literals are read where they lie (the output is staged whole)
DECODE128 = Geometry(batch_bytes=1 << 10, small=1 << 10, window=(1 << 13) - 32,
                     refill_margin=(1 << 13) // 16 * 5, stage_long=False)
#: csrc/decode_v3.cu: one warp a block on the same walk, two 4 KiB windows
#: (the next loaded from the next batch's first byte while a batch is
#: copied), 2 KiB pieces
DECODE_V3 = Geometry(batch_bytes=1 << 10, small=1 << 10, piece=1 << 11, window=(1 << 12) - 32,
                     refill_margin=(1 << 11) + 32 * (3 + 2 * ((1 << 10) // 255 + 1)),
                     stage_long=False, read_ahead=True)

FLAG_LAST = 1
FLAG_LONG = 2


#: the structural results of ``parse_shape`` (csrc/decode_common.cuh)
SHAPE_OK, SHAPE_END_LITERALS, SHAPE_END_MATCH = 0, 1, 2


def parse_shape(comp: bytes, pos: int):
    """``parse_shape`` of ``csrc/decode_common.cuh``: (code, next_pos,
    lit_src, lit_len, match_len, offset); match_len 0: no match."""
    n = len(comp)
    token = comp[pos]
    pos += 1
    lit = token >> 4
    if lit == 0xF:
        while True:
            if pos >= n:
                return SHAPE_END_LITERALS, 0, 0, 0, 0, 0
            more = comp[pos]
            pos += 1
            lit += more
            if more != 0xFF:
                break
    if pos + lit > n:
        return SHAPE_END_LITERALS, 0, 0, 0, 0, 0
    lit_src = pos
    pos += lit
    if n - pos < 2:  # ends after literals (a stray byte re-reads as a token)
        return SHAPE_OK, pos, lit_src, lit, 0, 0
    offset = comp[pos] | (comp[pos + 1] << 8)
    pos += 2
    ml = token & 0xF
    if ml == 0xF:
        while True:
            if pos >= n:
                return SHAPE_END_MATCH, 0, lit_src, lit, 0, offset
            more = comp[pos]
            pos += 1
            ml += more
            if more != 0xFF:
                break
    return SHAPE_OK, pos, lit_src, lit, ml + 4, offset


def check_seq(code, lit, ml, offset, op, plen, limit, out_cap) -> int:
    """``check_seq`` of ``csrc/decode_common.cuh``: the shape's results and
    the checks that need ``op``, in the shared parser's order."""
    if code == SHAPE_END_LITERALS:
        return ERR_UNEXPECTED_END
    if op + lit > out_cap:
        return ERR_MEMORY_LIMIT
    if code == SHAPE_END_MATCH:
        return ERR_UNEXPECTED_END
    if ml == 0:
        return OK
    mop = op + lit
    if mop + ml > limit:
        return ERR_MEMORY_LIMIT
    if offset == 0:
        return ERR_ZERO_OFFSET
    if offset > mop + plen:
        return ERR_INVALID_OFFSET
    return OK


def _parse_seq(comp: bytes, pos: int, op: int, plen: int, limit: int, out_cap: int):
    """``parse_seq_with`` of ``csrc/decode_common.cuh``, its shape and its
    checks: (status, next_pos, lit_src, lit_len, match_len, offset)."""
    code, next_pos, lit_src, lit, ml, offset = parse_shape(comp, pos)
    st = check_seq(code, lit, ml, offset, op, plen, limit, out_cap)
    return (st, next_pos, lit_src, lit, ml, offset) if st == OK else (st, 0, 0, 0, 0, 0)


def _parse_batch(comp: bytes, w_end: int, pos: int, op: int, plen: int, limit: int,
                 out_cap: int, geo: Geometry) -> dict:
    """The parse warp's batch from (pos, op): the walk over sequences that
    lie whole inside the window, then per entry the offset, the output
    position by a prefix sum, the checks in the shared parser's order, the
    first failure, and which matches wait for an earlier sequence of the
    batch."""
    n = len(comp)
    start_op = op
    lim = w_end
    walked = []  # (lit_src, lit_len, match_len) per lane
    size = 0
    while len(walked) < geo.batch and size < geo.batch_bytes and pos < lim:
        token = comp[pos]
        q = pos + 1
        lit = token >> 4
        whole = True
        if lit == 0xF:
            while True:
                if q >= lim:
                    whole = False
                    break
                more = comp[q]
                q += 1
                lit += more
                if more != 0xFF:
                    break
        src = q
        q += lit
        if not whole or q + 2 > lim:
            break
        q += 2
        ml = token & 0xF
        if ml == 0xF:
            while True:
                if q >= lim:
                    whole = False
                    break
                more = comp[q]
                q += 1
                ml += more
                if more != 0xFF:
                    break
        ml += 4
        if not whole or lit + ml > geo.small:
            break
        walked.append((src, lit, ml))
        size += lit + ml
        pos = q
    if not walked:  # one sequence through the shared parser
        bt = dict(entries=[], next_pos=pos, end_op=op, status=OK, flags=0, dependent=set())
        if pos >= n:
            bt["flags"] = FLAG_LAST
            return bt
        st, next_pos, lit_src, lit, ml, offset = _parse_seq(comp, pos, op, plen, limit, out_cap)
        if st != OK:
            bt["status"] = st
            return bt
        if lit + ml > geo.small:
            bt["flags"] |= FLAG_LONG
        bt["entries"] = [(op, lit_src, lit, ml, offset)]
        bt["next_pos"] = next_pos
        bt["end_op"] = op + lit + ml
        if next_pos >= n:
            bt["flags"] |= FLAG_LAST
        return bt
    # every lane on its own sequence: prefix sum, offset, checks
    ops = np.concatenate(([0], np.cumsum([lit + ml for _, lit, ml in walked]))) + start_op
    lanes = []
    for k, (src, lit, ml) in enumerate(walked):
        my_op = int(ops[k])
        mop = my_op + lit
        offset = comp[src + lit] | (comp[src + lit + 1] << 8)
        st = (ERR_MEMORY_LIMIT if mop > out_cap or mop + ml > limit
              else ERR_ZERO_OFFSET if offset == 0
              else ERR_INVALID_OFFSET if offset > mop + plen else OK)
        lanes.append((st, my_op, src, lit, ml, offset))
    bad = [k for k, lane in enumerate(lanes) if lane[0] != OK]
    status, end_op, count = OK, int(ops[-1]), len(lanes)
    if bad:  # the first failing sequence ends the batch before it
        count = bad[0]
        status = lanes[count][0]
        end_op = lanes[count][1]
    dependent = set()
    for k, (_, my_op, _, lit, ml, offset) in enumerate(lanes[:count]):
        source = my_op + lit - offset
        upper = min(source + min(ml, offset), my_op)
        if source < my_op and upper > start_op:
            dependent.add(k)
    return dict(entries=[lane[1:] for lane in lanes[:count]], next_pos=pos, end_op=end_op,
                status=status, flags=FLAG_LAST if status == OK and pos >= n else 0,
                dependent=dependent)


def decode_block_batched_plain(comp: bytes, prefix: bytes, limit: int, out_capacity: int,
                               geo: Geometry = Geometry()):
    """One block by the kernel's steps: batches parsed one ahead inside a
    moving window of the compressed stream; a batch's literals and
    independent matches copied in one round from the output as it stood
    before the batch, its dependent matches after them in stream order.
    Returns (output bytes, status)."""
    n = len(comp)
    plen = len(prefix)
    out = []  # output bytes; None where a round has not written yet

    def v(s):  # V[s]: output for s >= 0, the right-aligned prefix below
        byte = out[s] if s >= 0 else prefix[plen + s]
        if byte is None:
            raise AssertionError(f"a copy read output byte {s} before it was written")
        return byte

    def window_from(start, want=None):
        return min(start + (geo.window if want is None else want), n)

    w_end = window_from(0)
    cur = _parse_batch(comp, w_end, 0, 0, plen, limit, out_capacity, geo)
    while True:
        entries, next_pos, flags = cur["entries"], cur["next_pos"], cur["flags"]
        done = cur["status"] != OK or bool(flags & FLAG_LAST)
        if not flags & FLAG_LONG and w_end < n and next_pos + geo.refill_margin > w_end:
            w_end = window_from(next_pos if geo.read_ahead or not entries else entries[0][1])
        nxt = None
        if flags & FLAG_LONG:  # every thread copies, piece by piece
            op, lit_src, lit, ml, offset = entries[0]
            for start in range(0, lit if geo.stage_long else 0, geo.piece):
                w_end = window_from(lit_src + start, min(lit - start, geo.piece))
            out.extend(comp[lit_src : lit_src + lit])
            for j in range(ml):
                out.append(v(op + lit - offset + j % offset))
            if not done:
                if w_end < n and next_pos + geo.refill_margin > w_end:
                    w_end = window_from(next_pos)
                nxt = _parse_batch(comp, w_end, next_pos, cur["end_op"], plen, limit,
                                   out_capacity, geo)
        else:
            if not done:
                nxt = _parse_batch(comp, w_end, next_pos, cur["end_op"], plen, limit,
                                   out_capacity, geo)
            start_op = len(out)
            out.extend([None] * (cur["end_op"] - start_op))
            for k, (op, lit_src, lit, ml, offset) in enumerate(entries):  # round one
                out[op : op + lit] = comp[lit_src : lit_src + lit]
            for k, (op, lit_src, lit, ml, offset) in enumerate(entries):
                if k in cur["dependent"]:
                    continue
                mop = op + lit
                for j in range(ml):
                    s = mop - offset + (j if offset >= ml else j % offset)
                    if start_op <= s < op:
                        raise AssertionError(f"independent match {k} reads this batch's output")
                    out[mop + j] = comp[lit_src + s - op] if s >= op else v(s)
            for k in sorted(cur["dependent"]):  # round two, in stream order
                op, lit_src, lit, ml, offset = entries[k]
                mop = op + lit
                for j in range(ml):
                    out[mop + j] = v(mop - offset + (j if offset >= ml else j % offset))
        if done:
            return bytes(out), cur["status"]
        cur = nxt


def decode_big_batched_plain(comp, comp_len, prefix, prefix_len, limit: int, out_capacity: int,
                             geo: Geometry = Geometry()):
    """``decode_plain`` with ``decode_block_batched_plain`` for each block:
    the kernel's design on CPU tensors, used by the tests only (with
    ``geo=DECODE128``: ``decode128_batched_plain``)."""
    n_blocks = comp.shape[0]
    comp_np, pre_np = comp.numpy(), prefix.numpy()
    pw = prefix.shape[1]
    out = torch.zeros((n_blocks, out_capacity), dtype=torch.uint8)
    out_np = out.numpy()
    out_len = torch.zeros(n_blocks, dtype=torch.int32)
    status = torch.zeros(n_blocks, dtype=torch.int32)
    for i in range(n_blocks):
        row = pre_np[0 if pre_np.shape[0] == 1 else i]
        plen = int(prefix_len[i])
        pfx = row[pw - plen :].tobytes() if plen else b""
        data, st = decode_block_batched_plain(comp_np[i, : int(comp_len[i])].tobytes(), pfx,
                                              limit, out_capacity, geo)
        out_np[i, : len(data)] = np.frombuffer(data, np.uint8)
        out_len[i] = len(data)
        status[i] = st
    return out, out_len, status


def decode128_batched_plain(comp, comp_len, prefix, prefix_len, limit: int, out_capacity: int):
    """A model of ``csrc/decode128.cu`` on CPU tensors: the walk of
    ``decode_big_batched_plain`` at decode128's geometry (the output staged
    whole changes where bytes are kept, not which or in what order)."""
    return decode_big_batched_plain(comp, comp_len, prefix, prefix_len, limit, out_capacity,
                                    DECODE128)
